"""LR range test — the reference's find_lr capability (train/find_lr.py).

Counterpart of ``imageretrievalresearch_tpu/train/lr_finder.py``, the same
algorithm: the reference delegates to Lightning's tuner
(``trainer.tuner.lr_find`` -> ``lr_finder.suggestion()``,
train/find_lr.py:435-436), which runs an exponential LR sweep and suggests
the steepest-descent point. Here: sweep lr over ``num_steps`` log-spaced
values, track the smoothed loss, stop on divergence (loss >
early_stop_threshold x best) or a non-finite loss, suggest the lr at the
steepest negative loss gradient. Where JAX threads a PRNG key through the
steps, the port passes one ``torch.Generator`` to every step (its draws
need not follow ``jax.random``).
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch


def lr_find(make_state: Callable[[Callable[[int], float]], object],
            train_step: Callable, batches: Iterable,
            generator: torch.Generator | None = None,
            *, min_lr: float = 1e-8, max_lr: float = 1.0,
            num_steps: int = 100, smooth: float = 0.05,
            early_stop_threshold: float = 4.0) -> dict:
    """Returns {'suggestion', 'lrs', 'losses'}.

    ``make_state(schedule)`` builds a fresh train state whose updates use
    the given step -> lr schedule (the sweep's lrs rounded to float32, as
    the JAX schedule's array holds them); ``train_step(state, batch,
    generator) -> (state, metrics)`` must report ``train_loss``. When
    ``batches`` runs out, the batches seen so far are replayed in turn.
    """
    lrs = np.exp(np.linspace(np.log(min_lr), np.log(max_lr), num_steps))

    def schedule(step: int) -> float:
        return float(np.float32(lrs[min(max(int(step), 0), num_steps - 1)]))

    state = make_state(schedule)
    losses: list[float] = []
    avg, best = None, np.inf
    it = iter(batches)
    seen: list = []
    for i in range(num_steps):
        try:
            batch = next(it)
        except StopIteration:
            if not seen:
                break
            batch = seen[i % len(seen)]
        else:
            seen.append(batch)
        state, metrics = train_step(state, batch, generator)
        loss = float(metrics["train_loss"])
        if not np.isfinite(loss):
            break
        avg = loss if avg is None else smooth * loss + (1 - smooth) * avg
        losses.append(avg)
        best = min(best, avg)
        if avg > early_stop_threshold * best:
            break

    losses_a = np.asarray(losses)
    used_lrs = lrs[:len(losses_a)]
    if len(losses_a) < 3:
        return {"suggestion": None, "lrs": used_lrs, "losses": losses_a}
    # Lightning's suggestion(skip_begin=10, skip_end=1): the first points
    # are pure batch-to-batch noise at useless lrs (~min_lr) and the last
    # recorded point may be the divergence itself — a lucky downward blip
    # there would otherwise win argmin. Short sweeps fall back to the full
    # series (nothing left after skipping).
    skip_begin, skip_end = 10, 1
    if len(losses_a) >= skip_begin + skip_end + 3:
        core = np.gradient(losses_a[skip_begin:-skip_end])
        idx = int(np.argmin(core)) + skip_begin
    else:
        idx = int(np.argmin(np.gradient(losses_a)))
    suggestion = float(used_lrs[idx])
    return {"suggestion": suggestion, "lrs": used_lrs, "losses": losses_a}
