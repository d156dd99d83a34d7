"""ResNet / ResNeXt — the timm names of the reference CLI's help
("ex. ... ig_resnext101_32x32d").

Counterpart of ``imageretrievalresearch_tpu/models/resnet.py``, with
timm's module names: ``conv1`` 7x7 s2 -> ``bn1`` -> ReLU -> max pool 3x3 s2
-> ``layer1..4`` of Bottlenecks (``conv1``/``bn1``, ``conv2``/``bn2``
(stride, groups), ``conv3``/``bn3``, ``downsample.0``/``.1``) -> pool ->
``fc``. ResNeXt's grouped 3x3 has many channels per group: it is not a
depthwise conv and stays a grouped ``nn.Conv2d`` (cuDNN on the card).
Tensors are NCHW inside; ``forward_features`` returns NHWC.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from imageretrievalresearch_tpu_torch.models.layers import batch_norm, conv2d
from imageretrievalresearch_tpu_torch.ops.pooling import get_fm


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_chs: int, planes: int, stride: int = 1,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        out_chs = planes * self.expansion
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = conv2d(in_chs, width, 1)
        self.bn1 = batch_norm(width)
        self.conv2 = conv2d(width, width, 3, stride, groups)
        self.bn2 = batch_norm(width)
        self.conv3 = conv2d(width, out_chs, 1)
        self.bn3 = batch_norm(out_chs)
        self.act = nn.ReLU()
        self.downsample = (
            nn.Sequential(conv2d(in_chs, out_chs, 1, stride),
                          batch_norm(out_chs))
            if stride != 1 or in_chs != out_chs else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.downsample is None else self.downsample(x)
        y = self.act(self.bn1(self.conv1(x)))
        y = self.act(self.bn2(self.conv2(y)))
        return self.act(self.bn3(self.conv3(y)) + shortcut)


class ResNet(nn.Module):
    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), groups: int = 1,
                 base_width: int = 64, num_classes: int = 1000):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1 = conv2d(3, 64, 7, stride=2)
        self.bn1 = batch_norm(64)
        self.act = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_chs = 64
        for sidx, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                    self.layers)):
            stage = []
            for i in range(blocks):
                stride = (1 if sidx == 0 else 2) if i == 0 else 1
                stage.append(Bottleneck(in_chs, planes, stride, groups,
                                        base_width))
                in_chs = planes * Bottleneck.expansion
            setattr(self, f"layer{sidx + 1}", nn.Sequential(*stage))
        self.num_features = in_chs
        self.fc = (nn.Linear(in_chs, num_classes) if num_classes > 0
                   else nn.Identity())

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) NHWC -> (B, h, w, 2048) NHWC feature map."""
        x = self.maxpool(self.act(self.bn1(self.conv1(x.permute(0, 3, 1,
                                                                 2)))))
        for sidx in range(len(self.layers)):
            x = getattr(self, f"layer{sidx + 1}")(x)
        return x.permute(0, 2, 3, 1)

    def forward_head(self, fm: torch.Tensor) -> torch.Tensor:
        return self.fc(get_fm(fm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_head(self.forward_features(x))


RESNET_CONFIGS = {
    "resnet50": dict(layers=(3, 4, 6, 3)),
    "resnet101": dict(layers=(3, 4, 23, 3)),
    "resnet152": dict(layers=(3, 8, 36, 3)),
    "resnext50_32x4d": dict(layers=(3, 4, 6, 3), groups=32, base_width=4),
    "resnext101_32x8d": dict(layers=(3, 4, 23, 3), groups=32, base_width=8),
    "ig_resnext101_32x32d": dict(layers=(3, 4, 23, 3), groups=32,
                                 base_width=32),
}
