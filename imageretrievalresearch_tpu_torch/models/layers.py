"""Shared CNN building blocks.

Counterpart of ``imageretrievalresearch_tpu/models/layers.py``, with the
reference's torch arithmetic: ``nn.Conv2d(padding=k//2)`` (symmetric), and
``nn.BatchNorm2d(eps=1e-5, momentum=0.1)``. Tensors are NCHW inside the
modules (channels-last in memory: the model's input is an NHWC view). The
depthwise conv (``DepthwiseConv2d``, which ``ConvBnAct`` picks for a
grouped conv with one channel per group, as JAX's does) is a grouped
``nn.Conv2d`` (cuDNN on the card), which is what the JAX package runs by
default, or, with ``IRT_FORCE_PALLAS_DW=1``, the hand-written kernels of
``ops.depthwise``. The activations JAX writes out (``relu6``, DarkNet's
leaky ReLU) are torch's ``nn.ReLU6`` and ``nn.LeakyReLU``.

The two random layers, ``DropPath`` and ``Dropout``, draw their masks from
an explicit ``torch.Generator`` (their ``generator`` attribute, which
``Backbone.features_and_logits`` sets for a pass), as JAX draws from the
``dropout`` key; the streams do not follow ``jax.random``. On a rank of a
process group, their ``rows`` attribute names the global rows this rank
holds: the mask is drawn for the global batch and this rank keeps its
rows, so the draws do not depend on how the batch is split.

Every BatchNorm is :class:`GroupBatchNorm2d` (``batch_norm``): in training
inside a process group of more than one rank, its batch statistics cover
the group's global batch (over the ranks that hold distinct rows), as
JAX's do over a sharded batch; otherwise it is ``nn.BatchNorm2d``'s own
forward.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from imageretrievalresearch_tpu_torch.ops.depthwise import (
    depthwise_conv,
    use_depthwise_kernel,
)
from imageretrievalresearch_tpu_torch.ops.pooling import get_fm


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


class DepthwiseConv2d(nn.Conv2d):
    """``Conv2d(C, C, K, stride, padding=K//2, groups=C, bias=False)``:
    the same parameter (``weight`` (C, 1, K, K)), so timm state dicts and
    ``params_from_jax`` load unchanged. With the opt-in set it runs
    ``ops.depthwise.depthwise_conv`` (the kernels on a CUDA tensor, their
    plain versions on a CPU one); otherwise the grouped conv."""

    def __init__(self, chs: int, kernel_size: int, stride: int = 1):
        super().__init__(chs, chs, kernel_size, stride=stride,
                         padding=kernel_size // 2, groups=chs, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if use_depthwise_kernel():
            return depthwise_conv(x, self.weight, self.stride[0])
        return super().forward(x)


class _GroupBatchNorm(torch.autograd.Function):
    """Train-mode batch normalization over the rows of every rank, in f32.
    Forward: each rank's (count, mean, M2) are all-reduced (each rank
    fills its own row of an (R, 2C + 1) buffer) and merged in f64 as
    Chan's parallel variance does; backward: (sum dy, sum dy * x_hat) are
    all-reduced, so each rank's dx is that of the global batch's loss sum
    (DDP then averages the parameters' gradients over the ranks, as
    ``SyncBatchNorm`` does). ``group``: the ranks that hold distinct rows
    (None: the whole process group)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, group):
        c = x.shape[1]
        x32 = x.float()
        n_local = x.numel() // c
        var_l, mean_l = torch.var_mean(x32, dim=(0, 2, 3), correction=0)
        rows = torch.zeros((dist.get_world_size(group), 2 * c + 1),
                           dtype=torch.float64, device=x.device)
        mine = rows[dist.get_rank(group)]
        mine[0] = n_local
        mine[1:c + 1] = mean_l
        mine[c + 1:] = var_l * n_local
        dist.all_reduce(rows, group=group)
        counts, means, m2 = rows[:, :1], rows[:, 1:c + 1], rows[:, c + 1:]
        n = counts.sum()
        mean = (counts * means).sum(0) / n
        var = (m2 + counts * (means - mean) ** 2).sum(0) / n
        invstd = torch.rsqrt(var + eps).float()
        mean = mean.float()
        x_hat = (x32 - mean.view(1, -1, 1, 1)) * invstd.view(1, -1, 1, 1)
        w = weight.float().view(1, -1, 1, 1)
        y = x_hat * w + bias.float().view(1, -1, 1, 1)
        n = n.float()
        ctx.save_for_backward(x_hat, weight, invstd, n)
        ctx.in_dtype = x.dtype
        ctx.group = group
        var = var.float()
        ctx.mark_non_differentiable(mean, var, n)
        return y.to(x.dtype), mean, var, n

    @staticmethod
    def backward(ctx, dy, *_):
        x_hat, weight, invstd, n = ctx.saved_tensors
        dy32 = dy.float()
        c = dy.shape[1]
        sums = torch.cat([dy32.sum((0, 2, 3)),
                          (dy32 * x_hat).sum((0, 2, 3))])
        dw = sums[c:].clone()        # this rank's own: DDP averages it
        db = sums[:c].clone()
        dist.all_reduce(sums, group=ctx.group)
        sum_dy, sum_dy_xhat = sums[:c], sums[c:]
        dx = (dy32 - (sum_dy / n).view(1, -1, 1, 1)
              - x_hat * (sum_dy_xhat / n).view(1, -1, 1, 1))
        dx = dx * (weight.float() * invstd).view(1, -1, 1, 1)
        return (dx.to(ctx.in_dtype), dw.to(weight.dtype),
                db.to(weight.dtype), None, None)


class GroupBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training statistics cover the rows of
    every rank of ``group`` (the same parameters, buffers and state-dict
    keys). ``group`` is None (the whole process group), or, for a pass
    on a mesh of more axes, the mesh's ``batch_group``: the ranks that
    hold distinct rows (``Backbone.features_and_logits`` sets it for the
    pass), so rows that several ranks hold count once. The running
    variance takes torch's unbiased factor from the global row count.
    Outside a group, over one rank and in evaluation it is
    ``nn.BatchNorm2d.forward`` itself."""

    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and dist.is_available()
                and dist.is_initialized()
                and dist.get_world_size(self.group) > 1):
            return super().forward(x)
        y, mean, var, n = _GroupBatchNorm.apply(x, self.weight, self.bias,
                                                self.eps, self.group)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            m = (1.0 / float(self.num_batches_tracked)
                 if self.momentum is None else self.momentum)
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var * (n / (n - 1)), alpha=m)
        return y


def batch_norm(chs: int) -> nn.BatchNorm2d:
    return GroupBatchNorm2d(chs, eps=1e-5, momentum=0.1)


class ConvBnAct(nn.Module):
    """Conv2d + BatchNorm + optional activation (timm ``conv`` / ``bn``).
    A depthwise conv (one channel per group, odd K > 1) is a
    ``DepthwiseConv2d``, so it takes the kernels under the opt-in."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int = 3,
                 stride: int = 1, groups: int = 1,
                 act: nn.Module | None = None):
        super().__init__()
        if (1 < groups == in_chs == out_chs and kernel_size % 2 == 1
                and kernel_size > 1):
            self.conv = DepthwiseConv2d(out_chs, kernel_size, stride)
        else:
            self.conv = conv2d(in_chs, out_chs, kernel_size, stride, groups)
        self.bn = batch_norm(out_chs)
        self.act = act if act is not None else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class SqueezeExcite(nn.Module):
    """Global pool -> reduce conv -> act -> expand conv -> sigmoid gate.
    ``rd_chs`` comes from the caller (EfficientNet: the block's input
    channels x 0.25; RexNet: the mid channels / 12). ``use_norm`` adds the
    BatchNorm of RexNet's SE between the reduce conv (its bias kept) and
    the activation, with timm's SEWithNorm names (``fc1``, ``bn``,
    ``fc2``; EfficientNet's are ``conv_reduce``, ``conv_expand``). In
    training that BatchNorm sees one value per image and channel, so
    torch refuses a batch of one image."""

    def __init__(self, chs: int, rd_chs: int,
                 act: nn.Module | None = None, use_norm: bool = False):
        super().__init__()
        reduce = nn.Conv2d(chs, rd_chs, 1, bias=True)
        expand = nn.Conv2d(rd_chs, chs, 1, bias=True)
        self.use_norm = use_norm
        if use_norm:
            self.fc1, self.bn, self.fc2 = reduce, batch_norm(rd_chs), expand
        else:
            self.conv_reduce, self.conv_expand = reduce, expand
        self.act = act if act is not None else nn.ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se = x.mean(dim=(2, 3), keepdim=True)
        if self.use_norm:
            se = self.fc2(self.act(self.bn(self.fc1(se))))
        else:
            se = self.conv_expand(self.act(self.conv_reduce(se)))
        return x * torch.sigmoid(se)


class _Drop(nn.Module):
    """Keeps an element with probability ``1 - rate`` and scales it by
    ``1 / (1 - rate)`` in training (identity in eval); the mask has
    ``_mask_shape(x)`` and comes from ``generator``."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: torch.Generator | None = None
        # (global rows, index of each local row among them) or None
        self.rows: tuple[int, torch.Tensor] | None = None

    def _mask_shape(self, x: torch.Tensor) -> tuple:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise ValueError(f"{type(self).__name__} in training needs a "
                             "generator (Backbone.features_and_logits)")
        keep = 1.0 - self.rate
        shape = self._mask_shape(x)
        if self.rows is None:
            mask = torch.rand(shape, generator=self.generator,
                              device=x.device) < keep
        else:
            total, index = self.rows
            mask = (torch.rand((total, *shape[1:]), generator=self.generator,
                               device=x.device) < keep)[index]
        return torch.where(mask, x / keep, torch.zeros_like(x))


class DropPath(_Drop):
    """Stochastic depth: one mask value per sample of the residual."""

    def _mask_shape(self, x: torch.Tensor) -> tuple:
        return (x.shape[0],) + (1,) * (x.ndim - 1)


class Dropout(_Drop):
    """Element-wise dropout (flax ``nn.Dropout``); ``F.dropout`` takes no
    generator, so the mask is drawn here."""

    def _mask_shape(self, x: torch.Tensor) -> tuple:
        return tuple(x.shape)


class ClassifierHead(nn.Module):
    """timm's ``head``: global pool -> dropout -> ``fc`` (identity when
    ``num_classes <= 0``); takes an NHWC map or pooled (B, C) features."""

    def __init__(self, chs: int, num_classes: int, drop_rate: float = 0.0):
        super().__init__()
        self.drop = Dropout(drop_rate)
        self.fc = (nn.Linear(chs, num_classes) if num_classes > 0
                   else nn.Identity())

    def forward(self, fm: torch.Tensor) -> torch.Tensor:
        return self.fc(self.drop(get_fm(fm)))


class ConvStem(nn.Module):
    """Optional learned input stem: Conv2d(3, 3, 3x3, s1, p1, no bias) +
    SiLU (the reference's ``conv_input`` option)."""

    def __init__(self):
        super().__init__()
        self.conv = conv2d(3, 3, 3)
        self.act = nn.SiLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.conv(x))
