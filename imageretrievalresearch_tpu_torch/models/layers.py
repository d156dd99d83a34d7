"""Shared CNN building blocks.

Counterpart of ``imageretrievalresearch_tpu/models/layers.py``, with the
reference's torch arithmetic: ``nn.Conv2d(padding=k//2)`` (symmetric), and
``nn.BatchNorm2d(eps=1e-5, momentum=0.1)``. Tensors are NCHW inside the
modules; the depthwise conv is a grouped ``nn.Conv2d`` (cuDNN on the card),
which is what the JAX package runs by default.
"""

from __future__ import annotations

import torch
from torch import nn


def make_divisible(v: float, divisor: int = 8, min_value: int | None = None,
                   round_limit: float = 0.9) -> int:
    """timm's channel rounding rule (keeps converted shapes identical)."""
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < round_limit * v:
        new_v += divisor
    return new_v


def conv2d(in_chs: int, out_chs: int, kernel_size: int, stride: int = 1,
           groups: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(in_chs, out_chs, kernel_size, stride=stride,
                     padding=kernel_size // 2, groups=groups, bias=bias)


def batch_norm(chs: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(chs, eps=1e-5, momentum=0.1)


class ConvBnAct(nn.Module):
    """Conv2d + BatchNorm + optional activation (timm ``conv`` / ``bn``)."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int = 3,
                 stride: int = 1, groups: int = 1,
                 act: nn.Module | None = None):
        super().__init__()
        self.conv = conv2d(in_chs, out_chs, kernel_size, stride, groups)
        self.bn = batch_norm(out_chs)
        self.act = act if act is not None else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class SqueezeExcite(nn.Module):
    """Global pool -> reduce conv -> act -> expand conv -> sigmoid gate.
    ``rd_chs`` comes from the caller (EfficientNet: the block's input
    channels x 0.25)."""

    def __init__(self, chs: int, rd_chs: int,
                 act: nn.Module | None = None):
        super().__init__()
        self.conv_reduce = nn.Conv2d(chs, rd_chs, 1, bias=True)
        self.act = act if act is not None else nn.ReLU()
        self.conv_expand = nn.Conv2d(rd_chs, chs, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se = x.mean(dim=(2, 3), keepdim=True)
        se = self.conv_expand(self.act(self.conv_reduce(se)))
        return x * torch.sigmoid(se)


class DropPath(nn.Module):
    """Stochastic depth (per-sample residual drop); identity in eval."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1),
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class ConvStem(nn.Module):
    """Optional learned input stem: Conv2d(3, 3, 3x3, s1, p1, no bias) +
    SiLU (the reference's ``conv_input`` option)."""

    def __init__(self):
        super().__init__()
        self.conv = conv2d(3, 3, 3)
        self.act = nn.SiLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.conv(x))
