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

Each checkpoint directory holds ``state.pt`` (the state dict) and
``metrics.json``; a save is written under a temporary name and renamed, so
a directory that exists is complete.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch


class CheckpointManager:
    def __init__(self, directory: str, *, monitor: str = "cos_sims",
                 mode: str = "max", save_top_k: int = 1):
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self._sign = 1.0 if mode == "max" else -1.0
        directory = os.path.abspath(directory)
        self._dirs = {kind: os.path.join(directory, kind)
                      for kind in ("best", "last")}
        for d in self._dirs.values():
            os.makedirs(d, exist_ok=True)
        ords = [self._metrics(s).get("_ord", 0.0)
                for s in self._steps("best")]
        self._ord = int(max(ords)) if ords else 0

    def _steps(self, kind: str) -> list[int]:
        return sorted(int(d) for d in os.listdir(self._dirs[kind])
                      if d.isdigit())

    def _path(self, kind: str, step: int) -> str:
        return os.path.join(self._dirs[kind], str(step))

    def _metrics(self, step: int) -> dict:
        with open(os.path.join(self._path("best", step),
                               "metrics.json")) as f:
            return json.load(f)

    def _score(self, step: int) -> float:
        m = self._metrics(step)
        return (float(m[self.monitor])
                - self._sign * 1e-12 * float(m.get("_ord", 0.0)))

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
        m = {self.monitor: float(metrics[self.monitor]),
             "_ord": float(self._ord)}
        self._write("best", step, state, m)
        ranked = sorted(self._steps("best"), key=self._score,
                        reverse=self.mode == "max")
        for s in ranked[self.save_top_k:]:
            shutil.rmtree(self._path("best", s))
        for s in self._steps("last"):
            shutil.rmtree(self._path("last", s))
        self._write("last", step, state, m)

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
        pick = max if self.mode == "max" else min
        return pick(steps, key=self._score)

    def latest_step(self) -> int | None:
        """The most recent save (``last/`` survives best-k deletion)."""
        steps = self._steps("last") + self._steps("best")
        return max(steps) if steps else None
