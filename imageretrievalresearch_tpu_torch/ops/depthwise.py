"""Depthwise convolution with hand-written CUDA kernels for the forward,
the input gradient and the tap gradients.

Counterpart of ``imageretrievalresearch_tpu/ops/pallas_conv.py``: torch
``Conv2d(C, C, K, stride, padding=K//2, groups=C, bias=False)`` semantics
for odd K <= 7 and stride 1 or 2, differentiable through
``_DepthwiseConv`` (JAX's ``jax.custom_vjp``):

- forward: ``depthwise_forward`` (TPU kernel 9, ``_dw_fwd_kernel``);
- dx: ``depthwise_grad_x``, JAX's stride-1 forward of the cotangent with
  the taps flipped, the cotangent first dilated for stride 2 with the high
  padding that restores the rows torch's floor division dropped
  (``_dw_op_bwd``); on the card one kernel computes it from the cotangent
  and the unflipped taps directly, with no dilated copy and no flip;
- dw: ``depthwise_grad_w`` (TPU kernel 10, ``_dw_grad_w_kernel``), f32,
  cast to the taps' type.

Each wrapper launches its kernel (``csrc/depthwise_conv.cu``) for a CUDA
tensor, or raises; for a CPU tensor it runs its plain PyTorch version
(``*_reference``). There is no fallback: JAX falls back to XLA when no VMEM
plan fits, the port's kernels take every shape above.

The kernels read NHWC with channels innermost, the memory order in which
the port's model holds its activations (a channels-last NCHW tensor), so
the layers pass them through as views; a tensor that had to be copied
into that order is counted in the ledger of ``_cuda`` as ``nhwc_copy``,
and a plain version run on a CUDA tensor under its kernel's entry.

The opt-in is JAX's: ``IRT_FORCE_PALLAS_DW=1``, read at call time. Without
it ``models.layers.DepthwiseConv2d`` is the grouped ``nn.Conv2d`` (cuDNN on
the card), as JAX's default is XLA's grouped conv.
"""

from __future__ import annotations

import functools
import os

import torch
import torch.nn.functional as F

from imageretrievalresearch_tpu_torch.ops import _cuda

THREADS = 256
# the band kernels (forward, dx, tap gradients): output pixels of a row per
# thread step, shared memory per block (two blocks per SM, opted in above
# the static 48 KB), and blocks per SM of their one-wave grid (splits x
# channel blocks)
BAND_RUN = 4
BAND_SMEM = 112 * 1024
BAND_BLOCKS_PER_SM = 2

def use_depthwise_kernel() -> bool:
    """The opt-in, read at each call (``IRT_FORCE_PALLAS_DW``)."""
    return bool(os.environ.get("IRT_FORCE_PALLAS_DW"))


def out_len(size: int, k: int, stride: int) -> int:
    return (size + 2 * (k // 2) - k) // stride + 1


def _check_conv(k: int, stride: int) -> None:
    if k < 1 or k > 7 or k % 2 == 0 or stride not in (1, 2):
        raise ValueError(f"depthwise conv takes odd K <= 7 and stride 1 or "
                         f"2, got K={k}, stride={stride}")


def band_geometry(kind: str, th: int, h: int, w: int, k: int,
                  stride: int) -> tuple[int, int, int]:
    """``(rows, columns, offset)`` of one staged item of the forward
    (``kind`` "forward", source x) or of dx ("grad_x", source the
    cotangent), as ``make_band_geom`` in the source: the source rows that
    th output rows read, the buffer's columns (the source's width with its
    padding, at least what the runs of ``BAND_RUN`` pixels read) and the
    buffer column of source column 0. dx at stride 2 reads the cotangent
    at (y - P + i) / 2: (th + K) / 2 rows, ceil(P / 2) columns of
    padding."""
    p = k // 2
    src_w, out_w = ((w, out_len(w, k, stride)) if kind == "forward"
                    else (out_len(w, k, stride), w))
    runs_w = -(-out_w // BAND_RUN) * BAND_RUN
    if kind == "grad_x" and stride == 2:
        pd = (p + 1) // 2
        rx = (BAND_RUN - 1 + p + 2 * pd) // 2 + 1
        return (th + k) // 2, max((runs_w - BAND_RUN) // 2 + rx,
                                  src_w + pd), pd
    ss = stride if kind == "forward" else 1
    return (th - 1) * ss + k, max((runs_w - 1) * ss + k, src_w + 2 * p), p


def band_smem(kind: str, th: int, cb: int, h: int, w: int, k: int,
              stride: int, itemsize: int) -> tuple[int, int]:
    """``(block, buffer)`` bytes of a band kernel's shared memory for a
    layer with input (h, w) and bands of th output rows, cb channels: the
    forward and dx (:func:`band_geometry`) hold two staged items; the tap
    gradients (``make_grad_geom`` in the source) stage per item the x
    rows with their padding columns and the item's th g rows, the widths
    padded to whole runs of ``BAND_RUN`` pixels, two buffers or the
    slots' partial sums if they need more. The launchers compute the same
    and refuse a plan over their cap; CPU tests hold the constants to the
    source's."""
    if kind != "grad_w":
        rows, xw, _ = band_geometry(kind, th, h, w, k, stride)
        buf = rows * xw * cb * itemsize
        return 2 * buf, buf
    wo = out_len(w, k, stride)
    runs_w = -(-wo // BAND_RUN) * BAND_RUN
    xw = max((runs_w - 1) * stride + k, w + 2 * (k // 2))
    buf = (((th - 1) * stride + k) * xw + th * runs_w) * cb * itemsize
    red = THREADS // (cb // 2) * k * k * cb * 4
    return max(2 * buf, red), buf


def _source_rows(kind: str, r0: int, th: int, h: int, k: int,
                 stride: int) -> int:
    """The source rows inside the source that a band of th output rows
    from r0 stages: x rows of the forward and the tap gradients, cotangent
    rows of dx."""
    p = k // 2
    ho = out_len(h, k, stride)
    if kind == "grad_x":
        src_h = ho
        if stride == 2:
            lo, n = (r0 - p + 1) // 2, (th + k) // 2
        else:
            lo, n = r0 - p, th - 1 + k
    else:
        src_h = h
        lo, n = r0 * stride - p, (th - 1) * stride + k
    return min(src_h, lo + n) - max(0, lo)


@functools.lru_cache(maxsize=None)
def band_plan(kind: str, h: int, w: int, c: int, k: int, stride: int,
              itemsize: int) -> tuple[int, int]:
    """``(th, cb)`` of a band kernel (``kind``: "forward", "grad_x" or
    "grad_w") for a layer with input (h, w): items are bands of th output
    rows across the width, blocks take cb channels (a multiple of 8, at
    most 512). For each cb that splits C into equal blocks, the fewest
    bands under ``BAND_SMEM``, of equal height (the last band runs as many
    rows as the others, so a short one would compute on empty rows); of
    those, the plan that reads and writes the fewest bytes per image (halo
    rows read again, phantom channels of a last short block counted) over
    the share of the block's threads that own a channel pair, ties to the
    larger cb. Blocks of at least 64 channels (or all of C) come first: a
    warp's 32 channel pairs then read one pixel's contiguous 128 bytes,
    with no bank conflict. The forward and dx write their output from the
    blocks, so their blocks must also span whole 32-byte sectors (or all
    of C): where two blocks wrote parts of one sector, dx ran at half its
    rate on the card (PERF.md §6); and below 64 channels they take the
    widest block, which the byte count would not pick. Cached: the
    search runs once per layer shape, not at every launch."""
    ho, wo = out_len(h, k, stride), out_len(w, k, stride)
    out_h, out_w, src_w = (h, w, wo) if kind == "grad_x" else (ho, wo, w)
    c8 = -(-c // 8) * 8
    plans = []
    for nb in range(-(-c8 // 512), c8 // 8 + 1):
        cb = 8 * -(-(c8 // 8) // nb)
        th = next((t for t in range(out_h, 0, -1)
                   if band_smem(kind, t, cb, h, w, k, stride, itemsize)[0]
                   <= BAND_SMEM), 0)
        if not th:
            continue
        bands = -(-out_h // th)
        th = -(-out_h // bands)  # as many bands, evened out: no empty rows
        src_rows = sum(_source_rows(kind, b * th, min(th, out_h - b * th),
                                    h, k, stride) for b in range(bands))
        pairs = cb // 2
        used = pairs * (THREADS // pairs)
        # tap gradients: x and g in, K*K taps out; else source in, output out
        moved = (src_rows * src_w + ho * wo if kind == "grad_w"
                 else src_rows * src_w + out_h * out_w)
        cost = -(-c // cb) * cb * moved * THREADS / used
        wide = cb >= min(c8, 64)
        if kind == "grad_w":
            plans.append((not wide, cost, -cb, th))
        else:
            aligned = cb >= c or cb * itemsize % 32 == 0
            plans.append((not aligned, not wide, cost if wide else 0, -cb,
                          th))
    if not plans:
        raise ValueError(f"no {kind} plan fits {BAND_SMEM} bytes for C={c}, "
                         f"H={h}, W={w}, K={k}")
    *_, cb, th = min(plans)
    return th, -cb


def band_splits(n: int, bands: int, c_blocks: int,
                blocks: int) -> tuple[int, int]:
    """``(nsplit, items_per_split)``: a band kernel's split of the n x
    bands (image, band) items of each channel block, so that nsplit x
    c_blocks stays within ``blocks`` (one wave when that is what the card
    holds at once), every item in exactly one split."""
    items = n * bands
    per = -(-items // max(1, blocks // c_blocks))
    return -(-items // per), per


def _windows(x: torch.Tensor, k: int, stride: int, ho: int, wo: int):
    """((i, j), the f32 (N, Ho, Wo, C) window of tap (i, j)) of the
    zero-padded NHWC input, taps in row-major order."""
    p = k // 2
    xp = F.pad(x.float(), (0, 0, p, p, p, p))
    for i in range(k):
        for j in range(k):
            yield (i, j), xp[:, i:i + (ho - 1) * stride + 1:stride,
                             j:j + (wo - 1) * stride + 1:stride, :]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def depthwise_forward_reference(x: torch.Tensor, taps: torch.Tensor,
                                stride: int) -> torch.Tensor:
    """(N, H, W, C) f32/bf16 + (K, K, C) taps -> (N, Ho, Wo, C) in x's
    type: shifted multiply-adds in f32, in the kernel's order (taps row by
    row), each product and sum rounded on its own."""
    _cuda.plain_on_card("dw_conv_forward", x)
    n, h, w, c = x.shape
    k = taps.shape[0]
    ho, wo = out_len(h, k, stride), out_len(w, k, stride)
    acc = torch.zeros((n, ho, wo, c), dtype=torch.float32, device=x.device)
    for (i, j), win in _windows(x, k, stride, ho, wo):
        acc = acc + win * taps[i, j].float()
    return acc.to(x.dtype)


def depthwise_grad_w_reference(x: torch.Tensor, g: torch.Tensor, k: int,
                               stride: int) -> torch.Tensor:
    """Tap gradients: (N, H, W, C) input, (N, Ho, Wo, C) cotangent ->
    (K, K, C) f32, each tap the sum over n, ho, wo of its window times g."""
    _cuda.plain_on_card("dw_conv_grad_w", x)
    ho, wo = g.shape[1], g.shape[2]
    gf = g.float()
    out = torch.empty((k, k, x.shape[3]), dtype=torch.float32,
                      device=x.device)
    for (i, j), win in _windows(x, k, stride, ho, wo):
        out[i, j] = (win * gf).sum(dim=(0, 1, 2))
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_FLOATS = (torch.float32, torch.bfloat16)


def _band_split(kind: str, dev: torch.device, n: int, h: int, w: int,
                c: int, k: int, stride: int,
                itemsize: int) -> tuple[int, int, int, int]:
    """``(th, cb, nsplit, items_per_split)`` of band kernel ``kind``: its
    plan (:func:`band_plan`) and its one-wave split (:func:`band_splits`)
    over ``BAND_BLOCKS_PER_SM`` blocks per SM of the card."""
    th, cb = band_plan(kind, h, w, c, k, stride, itemsize)
    out_h = h if kind == "grad_x" else out_len(h, k, stride)
    return (th, cb, *band_splits(n, -(-out_h // th), -(-c // cb),
                                 BAND_BLOCKS_PER_SM * _cuda.sm_count(dev)))


def depthwise_forward(x: torch.Tensor, taps: torch.Tensor,
                      stride: int) -> torch.Tensor:
    """Depthwise conv: (N, H, W, C) f32/bf16 + (K, K, C) f32 taps ->
    (N, Ho, Wo, C) in x's type, f32 accumulation; replaces ``_pallas_dw``.
    The kernel walks bands of output rows with their input rows staged by
    ``cp.async`` (:func:`band_plan`), bitwise equal to
    :func:`depthwise_forward_reference`."""
    k = taps.shape[0]
    _check_conv(k, stride)
    if _cuda.on_cpu(x):
        return depthwise_forward_reference(x, taps, stride)
    n, h, w, c = x.shape
    _cuda.check_operand("x", x, _FLOATS, (n, h, w, c), x.device)
    _cuda.check_operand("taps", taps, torch.float32, (k, k, c), x.device)
    ho, wo = out_len(h, k, stride), out_len(w, k, stride)
    out = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
    plan = _band_split("forward", x.device, n, h, w, c, k, stride,
                       x.element_size())
    _cuda.launch("depthwise_conv", "dw_conv_forward", x.device, x, taps, out,
                 n, h, w, c, ho, wo, k, stride, *plan,
                 int(x.dtype == torch.bfloat16))
    return out


def depthwise_grad_w(x: torch.Tensor, g: torch.Tensor, k: int,
                     stride: int) -> torch.Tensor:
    """Tap gradients: (N, H, W, C) input + (N, Ho, Wo, C) cotangent of its
    type -> (K, K, C) f32; replaces ``_pallas_dw_grad_w``. Per-block
    partial sums and a fixed-order reduction: repeated runs are bitwise
    equal. The kernel's plan: :func:`band_plan`, :func:`band_splits`."""
    _check_conv(k, stride)
    if _cuda.on_cpu(x):
        return depthwise_grad_w_reference(x, g, k, stride)
    n, h, w, c = x.shape
    ho, wo = out_len(h, k, stride), out_len(w, k, stride)
    _cuda.check_operand("x", x, _FLOATS, (n, h, w, c), x.device)
    _cuda.check_operand("g", g, x.dtype, (n, ho, wo, c), x.device)
    plan = _band_split("grad_w", x.device, n, h, w, c, k, stride,
                       x.element_size())
    partial = torch.empty((plan[2], k * k, c), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((k, k, c), dtype=torch.float32, device=x.device)
    _cuda.launch("depthwise_conv", "dw_conv_grad_w", x.device, x, g,
                 partial, out, n, h, w, c, ho, wo, k, stride, *plan,
                 int(x.dtype == torch.bfloat16))
    return out


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------

def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """An NCHW tensor as NHWC: a view of a channels-last tensor, else a
    copy (counted as ``nhwc_copy``)."""
    v = t.permute(0, 2, 3, 1)
    if not v.is_contiguous():
        _cuda.record("nhwc_copy")
        v = v.contiguous()
    return v


def _taps(w: torch.Tensor) -> torch.Tensor:
    """(C, 1, K, K) weight -> (K, K, C) f32 taps."""
    return w[:, 0].permute(1, 2, 0).float().contiguous()


def dilate(g: torch.Tensor, stride: int, h: int, w: int) -> torch.Tensor:
    """An (N, Ho, Wo, C) cotangent back at input resolution (N, H, W, C):
    interior dilation by ``stride`` and the high padding that restores the
    rows and columns torch's floor division dropped."""
    if stride == 1:
        return g
    n, ho, wo, c = g.shape
    out = torch.zeros((n, h, w, c), dtype=g.dtype, device=g.device)
    out[:, :(ho - 1) * stride + 1:stride, :(wo - 1) * stride + 1:stride] = g
    return out


def depthwise_grad_x_reference(g: torch.Tensor, taps: torch.Tensor,
                               stride: int, h: int, w: int) -> torch.Tensor:
    """Plain version of the input gradient, JAX's ``_dw_op_bwd``: the
    stride-1 forward of the dilated cotangent with the taps flipped."""
    _cuda.plain_on_card("dw_conv_grad_x", g)
    return depthwise_forward_reference(dilate(g, stride, h, w),
                                       taps.flip(0, 1), 1)


def depthwise_grad_x(g: torch.Tensor, taps: torch.Tensor, stride: int,
                     h: int, w: int) -> torch.Tensor:
    """The input gradient, (N, Ho, Wo, C) cotangent of a layer with input
    (h, w) + its (K, K, C) f32 taps -> (N, H, W, C) in the cotangent's
    type (``_dw_op_bwd``). For a CUDA tensor one kernel (``dw_conv_grad_x``)
    reads the cotangent at output resolution and the unflipped taps: for
    each input pixel it sums, in the flipped taps' order, only the terms
    whose source lands on an output pixel (a quarter of them at stride 2),
    with no dilated copy and no flip. The terms it skips are exact zero
    products, so it equals :func:`depthwise_grad_x_reference` under
    ``torch.equal``. It is bound by bytes, the cotangent read and dx
    written once: bands of dx rows with their cotangent rows staged by
    ``cp.async`` (:func:`band_plan`). For a CPU tensor: the plain
    version."""
    k = taps.shape[0]
    _check_conv(k, stride)
    if _cuda.on_cpu(g):
        return depthwise_grad_x_reference(g, taps, stride, h, w)
    n, ho, wo, c = g.shape
    if (ho, wo) != (out_len(h, k, stride), out_len(w, k, stride)):
        raise ValueError(f"cotangent ({ho}, {wo}) is not the output of "
                         f"({h}, {w}) at K={k}, stride={stride}")
    _cuda.check_operand("g", g, _FLOATS, (n, ho, wo, c), g.device)
    _cuda.check_operand("taps", taps, torch.float32, (k, k, c), g.device)
    dx = torch.empty((n, h, w, c), dtype=g.dtype, device=g.device)
    plan = _band_split("grad_x", g.device, n, h, w, c, k, stride,
                       g.element_size())
    _cuda.launch("depthwise_conv", "dw_conv_grad_x", g.device, g, taps, dx,
                 n, h, w, c, ho, wo, k, stride, *plan,
                 int(g.dtype == torch.bfloat16))
    return dx


class _DepthwiseConv(torch.autograd.Function):
    """x (N, C, H, W), weight (C, 1, K, K) -> (N, C, Ho, Wo), in the
    channels-last memory order of x's NHWC view; every pass is a kernel
    (CUDA) or its plain version (CPU)."""

    @staticmethod
    def forward(ctx, x, weight, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, weight)
        return depthwise_forward(_nhwc(x), _taps(weight),
                                 stride).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        stride, k = ctx.stride, weight.shape[-1]
        g = _nhwc(gy)
        dx = depthwise_grad_x(g, _taps(weight), stride, x.shape[2],
                              x.shape[3])
        dw = depthwise_grad_w(_nhwc(x), g, k, stride)
        return (dx.permute(0, 3, 1, 2).to(x.dtype),
                dw.permute(2, 0, 1)[:, None].to(weight.dtype), None)


def depthwise_conv(x: torch.Tensor, weight: torch.Tensor,
                   stride: int = 1) -> torch.Tensor:
    """Differentiable depthwise conv in the module layout: x (N, C, H, W),
    weight (C, 1, K, K). Under autocast x and the weight take the autocast
    type first, as a convolution's inputs do (autocast does not cast a
    custom Function's); the weight's gradient reaches an f32 parameter
    through that cast."""
    c, k = x.shape[1], weight.shape[-1]
    if tuple(weight.shape) != (c, 1, k, k):
        raise ValueError(f"expected a depthwise weight ({c}, 1, K, K), got "
                         f"{tuple(weight.shape)}")
    _check_conv(k, stride)
    dev = x.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_autocast_enabled(dev):
        dt = torch.get_autocast_dtype(dev)
        x, weight = x.to(dt), weight.to(dt)
    return _DepthwiseConv.apply(x, weight, stride)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, *,
                     stride: int = 1) -> torch.Tensor:
    """Depthwise conv in JAX's layout, differentiable: x (N, H, W, C), w
    the HWIO kernel (K, K, 1, C) -> (N, Ho, Wo, C); the counterpart of
    ``pallas_conv._dw_op``."""
    if w.ndim != 4 or w.shape[2] != 1 or w.shape[3] != x.shape[-1]:
        raise ValueError(f"expected a depthwise HWIO kernel (K, K, 1, C), "
                         f"got {tuple(w.shape)} for C={x.shape[-1]}")
    y = depthwise_conv(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride)
    return y.permute(0, 2, 3, 1)
