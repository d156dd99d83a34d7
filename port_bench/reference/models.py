"""Plain PyTorch copies of the two benchmark backbones, in timm's layout.

``efficientnet_b3a`` (timm ``efficientnet_b3a``: channel multiplier 1.2,
depth multiplier 1.4, 1536 features) and ``rexnet_150`` (timm
``rexnet_150``: width multiplier 1.5, 1920 features), written out from
their published block tables with ``nn.Conv2d``, ``nn.BatchNorm2d``,
``nn.Linear`` and the activations, and with timm's module names, so that
one timm-keyed state dict loads into these and into the program alike.
Nothing here imports the program.

Inputs are NHWC float images; the nets run NCHW inside. ``forward`` takes
a ``dropout_mask`` for the head's dropout (the benchmark draws it from the
seed and hands the same draw to the program through its generator) and
returns ``(embedding, logits)``: the embedding is the spatial mean of the
last feature map, the logits the classifier on the dropped embedding.

Every convolution and linear layer is a :class:`QConv2d` / :class:`QLinear`:
plain layers that, inside :func:`fake_fp8`, round their operands to
float8 (per-tensor scales: e4m3 forward, e5m2 for the gradient that
reaches the product). Run under bfloat16 autocast, that is the
benchmark's control for training, the reference one precision below the
program's bfloat16 products, and nothing else uses it.
"""

from __future__ import annotations

import contextlib
import importlib
import math

import torch
import torch.nn.functional as F
from torch import nn

_FP8 = {"on": False}


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under one per-tensor scale
    (its largest magnitude at the format's largest value), and back."""
    scale = x.detach().abs().amax().float().clamp(min=1e-30) \
        / torch.finfo(dtype).max
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Operand(torch.autograd.Function):
    """Forward: an operand rounded to e4m3; backward: passed through."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _OutputGrad(torch.autograd.Function):
    """Forward: identity; backward: the product's incoming gradient
    rounded to e5m2, the operand of both of its backward products."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


@contextlib.contextmanager
def fake_fp8():
    """Every product's operands in float8 while inside: e4m3 for the
    forward's, e5m2 for the gradients (the usual float8 training
    recipe)."""
    _FP8["on"] = True
    try:
        yield
    finally:
        _FP8["on"] = False


def _q(x: torch.Tensor) -> torch.Tensor:
    return _Operand.apply(x) if _FP8["on"] else x


def _qg(y: torch.Tensor) -> torch.Tensor:
    return _OutputGrad.apply(y) if _FP8["on"] else y


class QConv2d(nn.Conv2d):
    def forward(self, x):
        return _qg(F.conv2d(_q(x), _q(self.weight), self.bias, self.stride,
                            self.padding, self.dilation, self.groups))


class QLinear(nn.Linear):
    def forward(self, x):
        return _qg(F.linear(_q(x), _q(self.weight), self.bias))


def make_divisible(v: float, divisor: int = 8, min_value: int | None = None,
                   round_limit: float = 0.9) -> int:
    """timm's channel rounding."""
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < round_limit * v:
        new_v += divisor
    return new_v


def conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
         bias: bool = False) -> QConv2d:
    return QConv2d(cin, cout, k, stride=stride, padding=k // 2,
                   groups=groups, bias=bias)


def bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class SE(nn.Module):
    """Squeeze-excite; with ``norm`` RexNet's (fc1, bn, fc2), else
    EfficientNet's (conv_reduce, conv_expand)."""

    def __init__(self, c: int, rd: int, act: nn.Module, norm: bool):
        super().__init__()
        self.norm = norm
        if norm:
            self.fc1, self.bn, self.fc2 = (conv(c, rd, 1, bias=True), bn(rd),
                                           conv(rd, c, 1, bias=True))
        else:
            self.conv_reduce = conv(c, rd, 1, bias=True)
            self.conv_expand = conv(rd, c, 1, bias=True)
        self.act = act

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        if self.norm:
            s = self.fc2(self.act(self.bn(self.fc1(s))))
        else:
            s = self.conv_expand(self.act(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


# --- EfficientNet-B3a -----------------------------------------------------

# (kernel, channels, repeats, stride, expansion) per stage of B0
B0_STAGES = ((3, 16, 1, 1, 1), (3, 24, 2, 2, 6), (5, 40, 2, 2, 6),
             (3, 80, 3, 2, 6), (5, 112, 3, 1, 6), (5, 192, 4, 2, 6),
             (3, 320, 1, 1, 6))


class MBConv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int, e: int):
        super().__init__()
        mid = make_divisible(cin * e)
        rd = max(1, int(cin * 0.25))
        self.sep = e == 1
        self.act = nn.SiLU()
        if self.sep:
            self.conv_dw = conv(mid, mid, k, stride, groups=mid)
            self.bn1 = bn(mid)
            self.se = SE(mid, rd, nn.SiLU(), False)
            self.conv_pw = conv(mid, cout, 1)
            self.bn2 = bn(cout)
        else:
            self.conv_pw = conv(cin, mid, 1)
            self.bn1 = bn(mid)
            self.conv_dw = conv(mid, mid, k, stride, groups=mid)
            self.bn2 = bn(mid)
            self.se = SE(mid, rd, nn.SiLU(), False)
            self.conv_pwl = conv(mid, cout, 1)
            self.bn3 = bn(cout)
        self.skip = stride == 1 and cin == cout

    def forward(self, x):
        y = x
        if self.sep:
            y = self.act(self.bn1(self.conv_dw(y)))
            y = self.bn2(self.conv_pw(self.se(y)))
        else:
            y = self.act(self.bn1(self.conv_pw(y)))
            y = self.act(self.bn2(self.conv_dw(y)))
            y = self.bn3(self.conv_pwl(self.se(y)))
        return y + x if self.skip else y


class EfficientNet(nn.Module):
    def __init__(self, width_mult: float, depth_mult: float,
                 num_classes: int, head_features: int = 1280):
        super().__init__()
        stem = make_divisible(32 * width_mult)
        self.conv_stem = conv(3, stem, 3, 2)
        self.bn1 = bn(stem)
        self.act = nn.SiLU()
        stages, cin = [], stem
        for k, c, r, s, e in B0_STAGES:
            cout = make_divisible(c * width_mult)
            blocks = []
            for i in range(int(math.ceil(depth_mult * r))):
                blocks.append(MBConv(cin, cout, k, s if i == 0 else 1, e))
                cin = cout
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.num_features = make_divisible(head_features * width_mult)
        self.conv_head = conv(cin, self.num_features, 1)
        self.bn2 = bn(self.num_features)
        self.classifier = QLinear(self.num_features, num_classes)

    def forward_features(self, x):
        x = self.blocks(self.act(self.bn1(self.conv_stem(x))))
        return self.act(self.bn2(self.conv_head(x)))

    def logits(self, emb):
        return self.classifier(emb)


# --- RexNet-150 -----------------------------------------------------------

def rexnet_blocks(width_mult: float, depth_mult: float = 1.0,
                  initial: int = 16, final: int = 180,
                  se_ratio: float = 1 / 12):
    """(out channels, expansion, stride, SE ratio) per block: timm's
    ``_block_cfg`` (the ramp adds ``final / depth`` a block)."""
    layers = [math.ceil(n * depth_mult) for n in (1, 2, 2, 3, 3, 5)]
    strides = sum([[s] + [1] * (n - 1)
                   for s, n in zip((1, 2, 2, 2, 1, 2), layers)], [])
    exps = [1] * layers[0] + [6] * sum(layers[1:])
    depth = sum(layers)
    base = initial / width_mult if width_mult < 1.0 else initial
    outs = []
    for _ in range(depth):
        outs.append(make_divisible(round(base * width_mult), divisor=1))
        base += final / depth
    ses = [0.0] * (layers[0] + layers[1]) + [se_ratio] * sum(layers[2:])
    return list(zip(outs, exps, strides, ses))


class ConvBnAct(nn.Module):
    def __init__(self, cin, cout, k=1, stride=1, groups=1, act=None):
        super().__init__()
        self.conv = conv(cin, cout, k, stride, groups)
        self.bn = bn(cout)
        self.act = act if act is not None else nn.Identity()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class LinearBottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, e: int, se: float):
        super().__init__()
        self.cin = cin
        if e != 1:
            mid = make_divisible(round(cin * e), divisor=1)
            self.conv_exp = ConvBnAct(cin, mid, 1, act=nn.SiLU())
        else:
            mid, self.conv_exp = cin, None
        self.conv_dw = ConvBnAct(mid, mid, 3, stride, groups=mid)
        self.se = (SE(mid, make_divisible(int(mid * se), divisor=1),
                      nn.ReLU(), True) if se > 0 else None)
        self.act_dw = nn.ReLU6()
        self.conv_pwl = ConvBnAct(mid, cout, 1)
        self.skip = stride == 1 and cin <= cout

    def forward(self, x):
        y = x if self.conv_exp is None else self.conv_exp(x)
        y = self.conv_dw(y)
        if self.se is not None:
            y = self.se(y)
        y = self.conv_pwl(self.act_dw(y))
        if self.skip:
            y = torch.cat([y[:, :self.cin] + x, y[:, self.cin:]], dim=1)
        return y


class _Head(nn.Module):
    def __init__(self, c: int, num_classes: int):
        super().__init__()
        self.fc = QLinear(c, num_classes)


class RexNet(nn.Module):
    def __init__(self, width_mult: float, num_classes: int,
                 depth_mult: float = 1.0, head_features: int = 1280):
        super().__init__()
        stem = make_divisible(round((32 / width_mult if width_mult < 1.0
                                     else 32) * width_mult), divisor=1)
        self.stem = ConvBnAct(3, stem, 3, 2, act=nn.SiLU())
        blocks, cin = [], stem
        for c, e, s, se in rexnet_blocks(width_mult, depth_mult):
            blocks.append(LinearBottleneck(cin, c, s, e, se))
            cin = c
        self.num_features = make_divisible(head_features * width_mult,
                                           divisor=1)
        blocks.append(ConvBnAct(cin, self.num_features, 1, act=nn.SiLU()))
        self.features = nn.Sequential(*blocks)
        self.head = _Head(self.num_features, num_classes)

    def forward_features(self, x):
        return self.features(self.stem(x))

    def logits(self, emb):
        return self.head.fc(emb)


class Net(nn.Module):
    """A backbone of the configuration with the benchmark's surface:
    ``forward(x NHWC, dropout_mask=None) -> (embedding, logits)``. Its
    ``net`` holds the timm-named modules (``state_dict`` keys are timm's
    under ``net.``; :meth:`timm_state_dict` strips that)."""

    def __init__(self, cfg: dict):
        super().__init__()
        arch = cfg["architecture"]
        if arch == "efficientnet":
            net = EfficientNet(cfg["width_mult"], cfg["depth_mult"],
                               cfg["num_classes"], cfg["head_features"])
        elif arch == "rexnet":
            net = RexNet(cfg["width_mult"], cfg["num_classes"],
                         cfg["depth_mult"], cfg["head_features"])
        else:
            # another family lives in a module of its own,
            # ``reference/<architecture>.py``, whose ``build_net(cfg)``
            # returns a module with ``forward_features`` (NCHW map),
            # ``logits`` and ``num_features``, and whose ``HEAD_BIAS`` is
            # the timm name of its classifier's bias
            net = importlib.import_module(
                f"port_bench.reference.{arch}").build_net(cfg)
        self.net = net
        self.keep = 1.0 - cfg["drop_rate"]
        if net.num_features != cfg["num_features"]:
            raise ValueError(f"{cfg['name']}: {net.num_features} features "
                             f"built, {cfg['num_features']} in the config")

    def forward(self, x: torch.Tensor, dropout_mask=None):
        fm = self.net.forward_features(x.permute(0, 3, 1, 2))
        emb = fm.mean(dim=(2, 3))
        h = emb
        if dropout_mask is not None:
            h = torch.where(dropout_mask, emb / self.keep,
                            torch.zeros_like(emb))
        return emb, self.net.logits(h)

    def timm_state_dict(self) -> dict:
        return {k[len("net."):]: v for k, v in self.state_dict().items()}

    def load_timm_state_dict(self, sd: dict) -> None:
        self.net.load_state_dict(sd, strict=True)


HEAD_BIAS = {"efficientnet": "classifier.bias", "rexnet": "head.fc.bias"}


def head_bias(cfg: dict) -> str:
    """The timm name of the configuration's classifier bias."""
    arch = cfg["architecture"]
    if arch in HEAD_BIAS:
        return HEAD_BIAS[arch]
    return importlib.import_module(f"port_bench.reference.{arch}").HEAD_BIAS


def build(cfg: dict, device="cpu") -> Net:
    """The configuration's reference net (random init; load the
    benchmark's weights with :meth:`Net.load_timm_state_dict`)."""
    with torch.device(device):
        return Net(cfg)
