"""Faults planted underneath a run's timed path, for the tests that see
``correct`` come out false: each breaks the program as a later change
could, and leaves the harness as it is."""

from __future__ import annotations

import numpy as np


def altered_answer(emb, answer):
    """Serving: the first query's first returned row replaced by the next
    row of the gallery, where the answer is produced."""
    vals, rows, cls = (np.array(a) for a in answer)
    rows[0, 0] = rows[0, 0] + 1
    return emb, (vals, rows, cls)


def half_batch(prog) -> None:
    """Training: every step's forward takes the whole batch, and its loss
    (so its gradient and its mean) leaves out the second half of the rows:
    the mean is over the rest."""
    from imageretrievalresearch_tpu_torch.train import steps
    step, losses = prog.trainer._train_step, steps._losses_for_mode

    def first_half(cfg, fms, lbls, batch):
        b = len(fms[0]) // 2
        kept = {k: batch[k][:b] for k in ("cat_idx", "prod_idx")}
        return losses(cfg, [f[:b] for f in fms], [lb[:b] for lb in lbls],
                      {**batch, **kept})

    def faulty(*args, **kw):
        steps._losses_for_mode = first_half
        try:
            return step(*args, **kw)
        finally:
            steps._losses_for_mode = losses

    prog.trainer._train_step = faulty


def state_unchanged(prog) -> None:
    """Training: a step that returns its state unchanged (the optimizer's
    update never applied)."""
    prog.state.optimizer.step = lambda *a, **k: None
