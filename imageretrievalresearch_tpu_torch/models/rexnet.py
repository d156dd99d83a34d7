"""RexNet — the reference's default backbone (rexnet_150).

Counterpart of ``imageretrievalresearch_tpu/models/rexnet.py``, with
timm's module names (``stem``, ``features.{i}`` LinearBottleneck blocks of
``conv_exp`` / ``conv_dw`` / ``se`` (``fc1``, ``bn``, ``fc2``) /
``conv_pwl``, ``features.{N}`` the final ConvBnAct, ``head.fc``), so a timm
state dict loads with ``load_state_dict(strict=True)``:

  stem: conv3x3 s2 -> round(32*w) chs, BN, SiLU
  16 LinearBottleneck blocks (layers [1,2,2,3,3,5], stage strides
  [1,2,2,2,1,2]); output channels grow linearly before width scaling;
  expand ratio 1 for the first block else 6; SE (with BatchNorm, ratio
  1/12) on stages 3+; ReLU6 after the SE; partial residual onto the first
  ``in_chs`` channels when stride == 1 and in_chs <= out_chs
  final 1x1 conv -> round(1280*w), SiLU  == forward_features output
  head: global pool -> dropout -> Linear

The depthwise convs are ``DepthwiseConv2d`` (through ``ConvBnAct``): the
kernels of ``ops.depthwise`` under ``IRT_FORCE_PALLAS_DW=1``, else the
grouped conv. Tensors are NCHW inside; ``forward_features`` returns NHWC.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from imageretrievalresearch_tpu_torch.models.layers import (
    ClassifierHead,
    ConvBnAct,
    SqueezeExcite,
    make_divisible,
)


def rexnet_block_cfg(width_mult: float = 1.0, depth_mult: float = 1.0,
                     initial_chs: int = 16, final_chs: int = 180,
                     se_ratio: float = 1 / 12, ch_div: int = 1):
    """Per-block (out_chs, exp_ratio, stride, se_ratio) — timm's _block_cfg."""
    layers = [math.ceil(el * depth_mult) for el in [1, 2, 2, 3, 3, 5]]
    strides = sum([[s] + [1] * (n - 1)
                   for s, n in zip([1, 2, 2, 2, 1, 2], layers)], [])
    exp_ratios = [1] * layers[0] + [6] * sum(layers[1:])
    depth = sum(layers)
    base_chs = initial_chs / width_mult if width_mult < 1.0 else initial_chs
    out_chs_list = []
    for _ in range(depth):
        out_chs_list.append(make_divisible(round(base_chs * width_mult),
                                           divisor=ch_div))
        # timm's ramp: += final_chs / depth (not (final - initial) / depth);
        # published checkpoints match only this rule
        base_chs += final_chs / depth
    se_ratios = [0.0] * (layers[0] + layers[1]) + [se_ratio] * sum(layers[2:])
    return list(zip(out_chs_list, exp_ratios, strides, se_ratios))


class LinearBottleneck(nn.Module):
    """timm LinearBottleneck: 1x1 expand (SiLU) -> 3x3 depthwise -> SE ->
    ReLU6 -> 1x1 linear, with the partial channel residual."""

    def __init__(self, in_chs: int, out_chs: int, stride: int,
                 exp_ratio: int, se_ratio: float = 0.0, ch_div: int = 1):
        super().__init__()
        self.in_chs = in_chs
        if exp_ratio != 1:
            mid = make_divisible(round(in_chs * exp_ratio), divisor=ch_div)
            self.conv_exp = ConvBnAct(in_chs, mid, 1, act=nn.SiLU())
        else:
            mid = in_chs
            self.conv_exp = None
        self.conv_dw = ConvBnAct(mid, mid, 3, stride, groups=mid)
        self.se = (SqueezeExcite(mid, make_divisible(int(mid * se_ratio),
                                                     divisor=ch_div),
                                 act=nn.ReLU(), use_norm=True)
                   if se_ratio > 0 else None)
        self.act_dw = nn.ReLU6()
        self.conv_pwl = ConvBnAct(mid, out_chs, 1)
        self.use_shortcut = stride == 1 and in_chs <= out_chs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.conv_exp is not None:
            x = self.conv_exp(x)
        x = self.conv_dw(x)
        if self.se is not None:
            x = self.se(x)
        x = self.conv_pwl(self.act_dw(x))
        if self.use_shortcut:
            c = self.in_chs
            x = torch.cat([x[:, :c] + shortcut, x[:, c:]], dim=1)
        return x


class RexNet(nn.Module):
    """forward_features / forward_head split as in timm."""

    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 num_classes: int = 1000, drop_rate: float = 0.2,
                 ch_div: int = 1):
        super().__init__()
        self.width_mult, self.depth_mult = width_mult, depth_mult
        self.ch_div = ch_div
        stem_chs = 32 / width_mult if width_mult < 1.0 else 32
        stem_chs = make_divisible(round(stem_chs * width_mult),
                                  divisor=ch_div)
        self.stem = ConvBnAct(3, stem_chs, 3, 2, act=nn.SiLU())
        blocks, in_chs = [], stem_chs
        for c, e, s, se in rexnet_block_cfg(width_mult, depth_mult,
                                            ch_div=ch_div):
            blocks.append(LinearBottleneck(in_chs, c, s, e, se, ch_div))
            in_chs = c
        self.num_features = make_divisible(1280 * width_mult,
                                           divisor=ch_div)
        blocks.append(ConvBnAct(in_chs, self.num_features, 1, act=nn.SiLU()))
        self.features = nn.Sequential(*blocks)
        self.head = ClassifierHead(self.num_features, num_classes, drop_rate)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC -> (B, h, w, C) NHWC feature map."""
        x = self.features(self.stem(x.permute(0, 3, 1, 2)))
        return x.permute(0, 2, 3, 1)

    def forward_head(self, fm: torch.Tensor) -> torch.Tensor:
        """Pool + dropout + Linear; accepts NHWC maps or pooled (B, C)."""
        return self.head(fm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_head(self.forward_features(x))


REXNET_CONFIGS = {
    "rexnet_100": dict(width_mult=1.0),
    "rexnet_130": dict(width_mult=1.3),
    "rexnet_150": dict(width_mult=1.5),
    "rexnet_200": dict(width_mult=2.0),
}
