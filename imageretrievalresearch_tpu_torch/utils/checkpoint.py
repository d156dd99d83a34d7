"""Best-k checkpointing on a monitored metric, and resume, on
``torch.save``.

Counterpart of ``imageretrievalresearch_tpu/utils/checkpoint.py`` (orbax
there), with the reference's Lightning ``ModelCheckpoint(save_top_k=1,
monitor="cos_sims", mode="max")`` semantics (train/train.py:442-449). Two
retention sets:

- ``best/<step>/``: the top k by the monitored metric. Among exactly tied
  values the earliest save survives (Lightning replaces only on a strict
  improvement): each save's score carries a 1e-12 x save-ordinal penalty,
  far below any metric's resolution, so it decides exact ties only. A
  resumed manager continues above every ordinal still retained.
- ``last/<step>/``: the most recent save, kept unconditionally, so
  ``Trainer.fit(resume=True)`` continues from where training stopped.

In a process group only rank 0 writes (every rank calls ``save``, in
step; the others wait for its write at a barrier) and every rank reads.

Each checkpoint directory holds ``state.pt`` (the state dict) and
``metrics.json`` (the monitored value, the save ordinal and the mode); a
save is written under a temporary name and renamed, so a directory that
exists is complete. :func:`saved_checkpoint` finds the ``state.pt`` that
``restore()`` would load without creating anything.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch

from imageretrievalresearch_tpu_torch.parallel import distributed


def _step_dirs(directory: str) -> list[int]:
    """The saved steps under ``directory`` (none if it does not exist)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit()
                  and os.path.isfile(os.path.join(directory, d, "state.pt")))


def _read_metrics(step_dir: str) -> dict:
    with open(os.path.join(step_dir, "metrics.json")) as f:
        return json.load(f)


def _score(m: dict, monitor: str, mode: str) -> float:
    """The monitored value, less a save-ordinal penalty that decides exact
    ties for the earliest save."""
    sign = 1.0 if mode == "max" else -1.0
    return float(m[monitor]) - sign * 1e-12 * float(m.get("_ord", 0.0))


def _ranked(steps: list[int], metrics, monitor: str, mode: str
            ) -> list[int]:
    """``steps``, best first by ``_score`` of ``metrics(step)``."""
    return sorted(steps, key=lambda s: _score(metrics(s), monitor, mode),
                  reverse=mode == "max")


def saved_checkpoint(directory: str) -> str | None:
    """The ``state.pt`` that ``CheckpointManager(directory).restore()``
    loads: the best step of ``best/`` by the monitor and mode its
    ``metrics.json`` records, else the newest step of ``last/``; None when
    neither holds one. Reads only: creates no directory."""
    directory = os.path.abspath(directory)
    best, last = (os.path.join(directory, k) for k in ("best", "last"))
    steps = _step_dirs(best)
    if steps:
        metrics = {s: _read_metrics(os.path.join(best, str(s)))
                   for s in steps}
        first = metrics[steps[0]]
        monitor = next(k for k in first if not k.startswith("_"))
        step = _ranked(steps, metrics.__getitem__, monitor,
                       first.get("_mode", "max"))[0]
        return os.path.join(best, str(step), "state.pt")
    steps = _step_dirs(last)
    return os.path.join(last, str(steps[-1]), "state.pt") if steps else None


class CheckpointManager:
    def __init__(self, directory: str, *, monitor: str = "cos_sims",
                 mode: str = "max", save_top_k: int = 1):
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        directory = os.path.abspath(directory)
        self._dirs = {kind: os.path.join(directory, kind)
                      for kind in ("best", "last")}
        self._writer = distributed.rank() == 0
        if self._writer:
            for d in self._dirs.values():
                os.makedirs(d, exist_ok=True)
        ords = [self._metrics(s).get("_ord", 0.0)
                for s in self._steps("best")]
        self._ord = int(max(ords)) if ords else 0

    def _steps(self, kind: str) -> list[int]:
        return _step_dirs(self._dirs[kind])

    def _path(self, kind: str, step: int) -> str:
        return os.path.join(self._dirs[kind], str(step))

    def _metrics(self, step: int) -> dict:
        return _read_metrics(self._path("best", step))

    def _write(self, kind: str, step: int, state: Any,
               metrics: dict) -> None:
        final = self._path(kind, step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, "state.pt"))
        with open(os.path.join(tmp, "metrics.json"), "w") as f:
            json.dump(metrics, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)

    def save(self, step: int, state: Any, metrics: dict) -> None:
        """Save ``state`` (a state dict) at ``step`` into both sets, then
        keep the top k in ``best/`` and the newest in ``last/``."""
        self._ord += 1
        if not self._writer:
            distributed.barrier()
            return
        m = {self.monitor: float(metrics[self.monitor]),
             "_ord": float(self._ord), "_mode": self.mode}
        self._write("best", step, state, m)
        ranked = _ranked(self._steps("best"), self._metrics, self.monitor,
                         self.mode)
        for s in ranked[self.save_top_k:]:
            shutil.rmtree(self._path("best", s))
        for s in self._steps("last"):
            shutil.rmtree(self._path("last", s))
        self._write("last", step, state, m)
        distributed.barrier()

    def restore(self, step: int | None = None,
                map_location: str | torch.device = "cpu") -> Any:
        """The best checkpoint (default) or an explicit step, from
        whichever retention set still holds it."""
        step = step if step is not None else self.best_step()
        if step is None:
            raise FileNotFoundError("no checkpoint available")
        kind = "best" if step in self._steps("best") else "last"
        return torch.load(os.path.join(self._path(kind, step), "state.pt"),
                          map_location=map_location, weights_only=True)

    def best_step(self) -> int | None:
        steps = self._steps("best")
        if not steps:
            return None
        return _ranked(steps, self._metrics, self.monitor, self.mode)[0]

    def latest_step(self) -> int | None:
        """The most recent save (``last/`` survives best-k deletion)."""
        steps = self._steps("last") + self._steps("best")
        return max(steps) if steps else None
