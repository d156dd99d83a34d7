"""Optimizer, learning-rate schedule and train state.

Counterpart of ``imageretrievalresearch_tpu/train/train_state.py``: the
reference's AdamW / SGD with lr + weight_decay (train/train.py:160-163) and
``MultiStepLR(milestones, gamma)`` stepped per epoch (:168), here a
step-indexed piecewise-constant schedule whose per-epoch milestones become
step boundaries. The step functions set each update's learning rate from
the schedule before ``optimizer.step()``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Sequence

import numpy as np
import torch


def multistep_lr(lr: float, milestones: Sequence[int], gamma: float,
                 steps_per_epoch: int) -> Callable[[int], float]:
    """torch MultiStepLR: ``lr * gamma^(milestones passed)``, the
    milestones at ``epoch * steps_per_epoch``; a milestone listed twice
    counts once, and the products are rounded to f32 in boundary order,
    as ``optax.piecewise_constant_schedule`` computes them."""
    boundaries = sorted({int(m) * steps_per_epoch: gamma
                         for m in milestones}.items())

    def schedule(step: int) -> float:
        v = np.float32(lr)
        for boundary, scale in boundaries:
            if step >= boundary:
                v = np.float32(np.float32(scale) * v)
        return float(v)

    return schedule


def make_optimizer(optimizer_name: str, params: Iterable[torch.Tensor],
                   lr: float, weight_decay: float) -> torch.optim.Optimizer:
    """The reference's 'Adam' is torch AdamW (decoupled decay on every
    parameter, betas 0.9 / 0.999, eps 1e-8: ``optax.adamw``); its SGD has
    no momentum and adds the decay to the gradient (L2)."""
    params = list(params)
    if optimizer_name == "Adam":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay)
    if optimizer_name == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=0.0,
                               weight_decay=weight_decay)
    raise ValueError(f'Unknown optimizer: "{optimizer_name}"')


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm running statistics), its
    optimizer and the count of updates taken. Steps update it in place."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])
