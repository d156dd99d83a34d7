"""Pluggable metric logging with the reference's exact metric names.

Counterpart of ``imageretrievalresearch_tpu/utils/logging.py`` (the same
writer: stdout, ``metrics.jsonl``, and wandb only where it imports).

The reference logs through wandb with a hardcoded API key
(train/train.py:43) — here observability is a pluggable writer set
(stdout / jsonl / tensorboard / wandb-if-available), no credentials baked in.
Metric names are preserved verbatim (train_loss, val_loss, cos_sims,
cos_unsims, train/val top1/top3, lr — train/train.py:258-260, :365-373).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricLogger:
    def __init__(self, log_dir: str | None = None, *, stdout: bool = True,
                 jsonl: bool = True, use_wandb: bool = False,
                 project: str = "Sketchy-Dataset-Training",
                 run_name: str | None = None,
                 log_every_n_steps: int = 15):
        self.stdout = stdout
        self.log_every_n_steps = log_every_n_steps
        self._jsonl = None
        self._wandb = None
        if jsonl and log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(project=project, name=run_name)
            except Exception as e:  # wandb not installed / offline
                print(f"[logger] wandb unavailable ({e}); continuing without")

    def log(self, metrics: dict[str, Any], step: int,
            *, force: bool = False) -> None:
        if not force and (self.log_every_n_steps <= 0
                          or step % self.log_every_n_steps != 0):
            # <= 0 disables periodic logging (forced epoch-end logs still
            # land) instead of ZeroDivisionError on the first step
            return
        payload = {k: float(v) for k, v in metrics.items()}
        payload["step"] = step
        payload["time"] = time.time()
        if self.stdout:
            parts = " ".join(f"{k}={v:.4f}" for k, v in payload.items()
                             if k not in ("step", "time"))
            print(f"[step {step}] {parts}", flush=True)
        if self._jsonl:
            self._jsonl.write(json.dumps(payload) + "\n")
            self._jsonl.flush()
        if self._wandb:
            self._wandb.log(payload, step=step)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._wandb:
            self._wandb.finish()
