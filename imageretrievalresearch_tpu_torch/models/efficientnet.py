"""EfficientNet — the reference's flagship backbone (efficientnet_b3a).

Counterpart of ``imageretrievalresearch_tpu/models/efficientnet.py``.
Module names follow timm (``conv_stem``, ``bn1``,
``blocks.{s}.{i}.conv_pw`` / ``bn1`` ..., ``conv_head``, ``bn2``,
``classifier``), so a timm state dict loads with
``load_state_dict(strict=True)``. Stage 0 is timm's DepthwiseSeparable
block (``conv_dw``/``bn1``, ``se``, ``conv_pw``/``bn2``); the other stages
are InvertedResidual blocks (``conv_pw``/``bn1``, ``conv_dw``/``bn2``,
``se``, ``conv_pwl``/``bn3``).

Tensors are NCHW inside; ``forward_features`` returns the JAX package's
NHWC layout (a permuted view).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from imageretrievalresearch_tpu_torch.models.layers import (
    DepthwiseConv2d,
    DropPath,
    Dropout,
    SqueezeExcite,
    batch_norm,
    conv2d,
    make_divisible,
)
from imageretrievalresearch_tpu_torch.ops.pooling import get_fm

# (kernel, out_chs, repeats, stride, expand_ratio) per stage, B0 base; the
# last stage has ONE repeat (timm ir_r1_k3_s1_e6_c320)
_B0_STAGES = (
    (3, 16, 1, 1, 1),
    (3, 24, 2, 2, 6),
    (5, 40, 2, 2, 6),
    (3, 80, 3, 2, 6),
    (5, 112, 3, 1, 6),
    (5, 192, 4, 2, 6),
    (3, 320, 1, 1, 6),
)


def _round_repeats(r: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * r))


class MBConv(nn.Module):
    """Mobile inverted bottleneck with SE; DepthwiseSeparable when
    ``expand_ratio == 1``. SE width is ``int(in_chs * 0.25)`` of the
    block's input channels."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int,
                 stride: int, expand_ratio: int, se_ratio: float = 0.25,
                 drop_path: float = 0.0):
        super().__init__()
        mid = make_divisible(in_chs * expand_ratio)
        self.separable = expand_ratio == 1
        rd = max(1, int(in_chs * se_ratio))
        self.act = nn.SiLU()
        if self.separable:
            self.conv_dw = DepthwiseConv2d(mid, kernel_size, stride)
            self.bn1 = batch_norm(mid)
            self.se = SqueezeExcite(mid, rd, act=nn.SiLU())
            self.conv_pw = conv2d(mid, out_chs, 1)
            self.bn2 = batch_norm(out_chs)
        else:
            self.conv_pw = conv2d(in_chs, mid, 1)
            self.bn1 = batch_norm(mid)
            self.conv_dw = DepthwiseConv2d(mid, kernel_size, stride)
            self.bn2 = batch_norm(mid)
            self.se = SqueezeExcite(mid, rd, act=nn.SiLU())
            self.conv_pwl = conv2d(mid, out_chs, 1)
            self.bn3 = batch_norm(out_chs)
        self.has_skip = stride == 1 and in_chs == out_chs
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.separable:
            x = self.act(self.bn1(self.conv_dw(x)))
            x = self.bn2(self.conv_pw(self.se(x)))
        else:
            x = self.act(self.bn1(self.conv_pw(x)))
            x = self.act(self.bn2(self.conv_dw(x)))
            x = self.bn3(self.conv_pwl(self.se(x)))
        if self.has_skip:
            x = self.drop_path(x) + shortcut
        return x


class EfficientNet(nn.Module):
    """forward_features / forward_head split as in timm."""

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 num_classes: int = 1000, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.width_mult, self.depth_mult = width_mult, depth_mult
        w, d = width_mult, depth_mult
        stem = make_divisible(32 * w)
        self.conv_stem = conv2d(3, stem, 3, stride=2)
        self.bn1 = batch_norm(stem)
        self.act = nn.SiLU()
        total = sum(_round_repeats(r, d) for _, _, r, _, _ in _B0_STAGES)
        stages, in_chs, bidx = [], stem, 0
        for k, c, r, s, e in _B0_STAGES:
            out_chs = make_divisible(c * w)
            blocks = []
            for i in range(_round_repeats(r, d)):
                blocks.append(MBConv(in_chs, out_chs, k, s if i == 0 else 1,
                                     e, drop_path=drop_path_rate * bidx
                                     / max(1, total)))
                in_chs = out_chs
                bidx += 1
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.num_features = make_divisible(1280 * w)
        self.conv_head = conv2d(in_chs, self.num_features, 1)
        self.bn2 = batch_norm(self.num_features)
        self.drop = Dropout(drop_rate)
        self.num_classes = num_classes
        self.classifier = (nn.Linear(self.num_features, num_classes)
                           if num_classes > 0 else nn.Identity())

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC -> (B, h, w, C) NHWC feature map."""
        x = x.permute(0, 3, 1, 2)
        x = self.act(self.bn1(self.conv_stem(x)))
        x = self.blocks(x)
        x = self.act(self.bn2(self.conv_head(x)))
        return x.permute(0, 2, 3, 1)

    def forward_head(self, fm: torch.Tensor) -> torch.Tensor:
        """Pool + dropout + Linear; accepts NHWC maps or pooled (B, C)."""
        return self.classifier(self.drop(get_fm(fm)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_head(self.forward_features(x))


# (width, depth, default drop_rate) — timm model zoo coefficients
EFFICIENTNET_CONFIGS = {
    "efficientnet_b0": dict(width_mult=1.0, depth_mult=1.0, drop_rate=0.2),
    "efficientnet_b1": dict(width_mult=1.0, depth_mult=1.1, drop_rate=0.2),
    "efficientnet_b2": dict(width_mult=1.1, depth_mult=1.2, drop_rate=0.3),
    "efficientnet_b3": dict(width_mult=1.2, depth_mult=1.4, drop_rate=0.3),
    # b3a == b3 architecture; alias kept for CLI parity with the reference
    "efficientnet_b3a": dict(width_mult=1.2, depth_mult=1.4, drop_rate=0.3),
    "efficientnet_b4": dict(width_mult=1.4, depth_mult=1.8, drop_rate=0.4),
}
