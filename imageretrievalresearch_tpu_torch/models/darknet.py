"""DarkNet-53 — the other example name of the reference CLI's help
("ex. darknet53, ...").

Counterpart of ``imageretrievalresearch_tpu/models/darknet.py``: a 3x3/32
stem, five stages of (stride-2 3x3 channel doubling + N residual
bottlenecks), BatchNorm + LeakyReLU(0.1) throughout, with modern timm's
cspnet names (``stem.conv1``, ``stages.{s}.conv_down``,
``stages.{s}.blocks.{b}.conv1`` / ``conv2``, each a ``conv`` / ``bn``
pair; ``head.fc``). Tensors are NCHW inside; ``forward_features`` returns
NHWC.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from imageretrievalresearch_tpu_torch.models.layers import (
    ClassifierHead,
    ConvBnAct,
    make_divisible,
)

_LEAKY_SLOPE = 0.1  # the canonical darknet activation


def _leaky() -> nn.Module:
    return nn.LeakyReLU(_LEAKY_SLOPE)


class DarkBlock(nn.Module):
    """Residual bottleneck: 1x1 to chs/2 -> 3x3 to chs, identity add."""

    def __init__(self, chs: int):
        super().__init__()
        self.conv1 = ConvBnAct(chs, chs // 2, 1, act=_leaky())
        self.conv2 = ConvBnAct(chs // 2, chs, 3, act=_leaky())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(self.conv1(x))


class DarkStage(nn.Module):
    def __init__(self, in_chs: int, chs: int, depth: int):
        super().__init__()
        self.conv_down = ConvBnAct(in_chs, chs, 3, 2, act=_leaky())
        self.blocks = nn.Sequential(*[DarkBlock(chs) for _ in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(self.conv_down(x))


class DarkNet(nn.Module):
    """DarkNet-53 (depths (1, 2, 8, 8, 4), channels 64..1024)."""

    def __init__(self, depths: Sequence[int] = (1, 2, 8, 8, 4),
                 width_mult: float = 1.0, num_classes: int = 1000):
        super().__init__()
        self.depths = tuple(depths)

        def chs(base: int) -> int:
            return (base if width_mult == 1.0
                    else make_divisible(base * width_mult))
        self.stem = nn.Module()
        self.stem.conv1 = ConvBnAct(3, chs(32), 3, act=_leaky())
        stages, in_chs = [], chs(32)
        for sidx, depth in enumerate(self.depths):
            stages.append(DarkStage(in_chs, chs(64 * 2 ** sidx), depth))
            in_chs = chs(64 * 2 ** sidx)
        self.stages = nn.Sequential(*stages)
        self.num_features = in_chs
        self.head = ClassifierHead(in_chs, num_classes)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC -> (B, h, w, C) NHWC feature map."""
        x = self.stages(self.stem.conv1(x.permute(0, 3, 1, 2)))
        return x.permute(0, 2, 3, 1)

    def forward_head(self, fm: torch.Tensor) -> torch.Tensor:
        return self.head(fm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_head(self.forward_features(x))


DARKNET_CONFIGS = {
    "darknet53": dict(depths=(1, 2, 8, 8, 4)),
}
