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

from imageretrievalresearch_tpu_torch.parallel.fsdp import full_tensor


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


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The model inside a ``DistributedDataParallel`` wrapper (FSDP2
    shards a module in place and keeps its names)."""
    return model.module if isinstance(
        model, torch.nn.parallel.DistributedDataParallel) else model


def _like(value, held):
    """``value`` (a whole tensor) placed as ``held`` is: sharded the same
    where ``held`` is a DTensor."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(held, DTensor) and not isinstance(value, DTensor):
        return distribute_tensor(value.to(held.device_mesh.device_type),
                                 held.device_mesh, held.placements)
    return value


def load_model_state_dict(model: torch.nn.Module, sd: dict) -> None:
    """Load a whole (unwrapped) model state dict into ``model``, wrapped
    or not; FSDP's parameters take their shards of it."""
    inner = unwrap(model)
    held = inner.state_dict()
    inner.load_state_dict({k: _like(v, held[k]) for k, v in sd.items()})


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm running statistics), its
    optimizer and the count of updates taken. Steps update it in place.
    ``model`` may be wrapped for a process group (DDP, or sharded by
    FSDP); the state dict is the unwrapped model's, whole, with the
    optimizer's state in its own (index-keyed) form, so a checkpoint of
    any layout loads on one card and the reverse."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        """Whole tensors. Under FSDP every rank must call it (the shards
        are gathered)."""
        model = {k: full_tensor(v) for k, v in unwrap(self.model).state_dict(
            ).items()}
        opt = self.optimizer.state_dict()
        opt = {**opt, "state": {i: {k: full_tensor(v) for k, v in st.items()}
                                for i, st in opt["state"].items()}}
        return {"model": model, "optimizer": opt, "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        """Load a whole state dict; FSDP's parameters and their optimizer
        state take their shards of it."""
        load_model_state_dict(self.model, sd["model"])
        params = [p for g in self.optimizer.param_groups
                  for p in g["params"]]
        opt = sd["optimizer"]
        self.optimizer.load_state_dict({**opt, "state": {
            i: {k: (_like(v, params[int(i)]) if k != "step" else v)
                for k, v in st.items()}
            for i, st in opt["state"].items()}})
        self.step = int(sd["step"])
