"""The work a cell's shapes need, counted from the shapes alone, so that
whatever implements the work, the yardstick stays the same.

- ``forward_flops``: 2 x the multiply-adds of every convolution and
  linear layer of the configuration's reference net in one forward pass
  of one image (BatchNorm, activations and pooling not counted), walked
  on the ``meta`` device.
- ``kernel1``: the exact f32 top-k over a gallery (kernel 1 of the port's
  table, PERF.md §6): bytes = the gallery rows, their norms and the
  queries read once, the (value, index) pairs written once; operations =
  2 Q G D, which the kernel runs as three TF32 passes.
- ``image_kernel``: one launch of an AutoAugment image kernel (kernels
  5-8) over P planes of H x W bytes: the histogram reads the planes and
  writes P x 256 int32 counts; the lookup and the shifts read and write
  the planes (a lookup also reads its P x 256 int32 table).

``bound_s`` is the least time on the device: the larger of bytes over
the memory rate and operations over the rate of the arithmetic used.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def peaks(part: str = "h100_sxm") -> dict:
    return PEAKS[part]


def bound_s(nbytes: float, ops: float, rate: float,
            peak: dict | None = None) -> float:
    peak = peaks() if peak is None else peak
    return max(nbytes / peak["bytes_per_s"], ops / rate)


def forward_flops(cfg: dict, size: int) -> float:
    """FLOPs of one image's forward at ``size`` x ``size``."""
    from port_bench.reference.models import build
    net = build(cfg, device="meta")
    macs = []

    def conv_hook(m, inp, out):
        macs.append(out.numel() * (m.in_channels // m.groups)
                    * m.kernel_size[0] * m.kernel_size[1])

    def linear_hook(m, inp, out):
        macs.append(out.numel() * m.in_features)

    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(conv_hook)
        elif isinstance(m, torch.nn.Linear):
            m.register_forward_hook(linear_hook)
    net.eval()
    with torch.no_grad():
        net(torch.empty((1, size, size, 3), device="meta"))
    return 2.0 * sum(macs)


def kernel1(q: int, g: int, d: int, k: int) -> dict:
    """Bytes, operations and bound of one exact f32 top-k call."""
    nbytes = 4 * (g * d + g + q * d) + 8 * q * k
    ops = 2.0 * q * g * d
    p = peaks()
    b = bound_s(nbytes, 3 * ops, p["tf32_flops"])
    return {"bytes": nbytes, "ops": ops, "bound_s": b,
            "f32_fma_bound_s": bound_s(nbytes, ops, p["float32_flops"])}


IMAGE_KERNELS = {"histogram_kernel": "histogram",
                 "lut_kernel": "lut",
                 "row_shift_kernel": "shift",
                 "column_shift_kernel": "shift",
                 "row_shift_cubic_kernel": "cubic"}


def image_kernel(kind: str, planes: int, h: int, w: int) -> dict:
    """Bytes and bound of one launch over ``planes`` planes of h x w."""
    px = planes * h * w
    ops = 0.0
    if kind == "histogram":
        nbytes = px + planes * 256 * 4
    elif kind == "lut":
        nbytes = 2 * px + planes * 256 * 4
    elif kind in ("shift", "cubic"):
        nbytes = 2 * px
        # the cubic shift: 4 taps x (product, sum), the division, the
        # clip's 2, the rounding and the conversion, per output pixel
        ops = CUBIC_OPS_PER_PIXEL * px if kind == "cubic" else 0.0
    else:
        raise ValueError(f"unknown image kernel {kind!r}")
    return {"bytes": nbytes, "ops": ops,
            "bound_s": bound_s(nbytes, ops, peaks()["float32_flops"])}


CUBIC_OPS_PER_PIXEL = 13
