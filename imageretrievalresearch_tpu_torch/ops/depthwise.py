"""Depthwise convolution with hand-written CUDA kernels for the forward,
the input gradient and the tap gradients.

Counterpart of ``imageretrievalresearch_tpu/ops/pallas_conv.py``: torch
``Conv2d(C, C, K, stride, padding=K//2, groups=C, bias=False)`` semantics
for odd K <= 7 and stride 1 or 2, differentiable through
``_DepthwiseConv`` (JAX's ``jax.custom_vjp``):

- forward: ``depthwise_forward`` (TPU kernel 9, ``_dw_fwd_kernel``);
- dx: the same kernel at stride 1 with the taps flipped, on the cotangent,
  which for stride 2 is first dilated inside, with the high padding that
  restores the rows torch's floor division dropped (``_dw_op_bwd``);
- dw: ``depthwise_grad_w`` (TPU kernel 10, ``_dw_grad_w_kernel``), f32,
  cast to the taps' type.

Each wrapper launches its kernel (``csrc/depthwise_conv.cu``) for a CUDA
tensor, or raises; for a CPU tensor it runs its plain PyTorch version
(``*_reference``). There is no fallback: JAX falls back to XLA when no VMEM
plan fits, the port's kernels take every shape above.

The kernels read NHWC with channels innermost, the memory order in which
the port's model holds its activations (a channels-last NCHW tensor), so
the layers pass them through as views; ``LAYOUT_COPIES`` counts the
tensors that had to be copied into that order.

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
# shared memory a block may use without opting in to more (the forward's
# tile plan stays under it)
MAX_SMEM = 48 * 1024
# the tap-gradient kernel: output pixels of a row per thread step, shared
# memory per block (two blocks per SM, opted in above MAX_SMEM), and blocks
# per SM of its one-wave grid (splits x channel blocks)
GRAD_W_RUN = 4
GRAD_W_SMEM = 112 * 1024
GRAD_W_BLOCKS_PER_SM = 2

KERNEL_LAUNCHES = {"depthwise_conv_forward": 0, "depthwise_conv_grad_w": 0}
PLAIN_ON_CARD = dict.fromkeys(KERNEL_LAUNCHES, 0)
# tensors copied into NHWC order before a launch
LAYOUT_COPIES = {"nhwc": 0}


def reset_launch_counts() -> None:
    for counts in (KERNEL_LAUNCHES, PLAIN_ON_CARD, LAYOUT_COPIES):
        for name in counts:
            counts[name] = 0


def use_depthwise_kernel() -> bool:
    """The opt-in, read at each call (``IRT_FORCE_PALLAS_DW``)."""
    return bool(os.environ.get("IRT_FORCE_PALLAS_DW"))


def out_len(size: int, k: int, stride: int) -> int:
    return (size + 2 * (k // 2) - k) // stride + 1


def _check_conv(k: int, stride: int) -> None:
    if k < 1 or k > 7 or k % 2 == 0 or stride not in (1, 2):
        raise ValueError(f"depthwise conv takes odd K <= 7 and stride 1 or "
                         f"2, got K={k}, stride={stride}")


def _smem(th: int, tw: int, cb: int, k: int, stride: int) -> int:
    tile = ((th - 1) * stride + k) * ((tw - 1) * stride + k) * cb
    return 4 * max(tile, THREADS)


def tile_plan(ho: int, wo: int, c: int, k: int, stride: int
              ) -> tuple[int, int, int]:
    """``(th, tw, cb)``: a block's output tile of th x tw pixels and cb
    channels, its staged input tile under ``MAX_SMEM``. Starts at 8 x 16
    pixels and all channels up to 64 (else 64), then halves the channels
    to 32, the tile's width, its height."""
    th, tw = min(ho, 8), min(wo, 16)
    cb = c if c <= 64 else 64
    while _smem(th, tw, cb, k, stride) > MAX_SMEM:
        if cb > 32:
            cb = 32
        elif tw >= th and tw > 1:
            tw = (tw + 1) // 2
        else:
            th = (th + 1) // 2
    return th, tw, cb


def grad_w_smem(th: int, cb: int, w: int, wo: int, k: int, stride: int,
                itemsize: int) -> tuple[int, int]:
    """``(block, buffer)`` bytes of the tap-gradient kernel's shared memory
    (``make_grad_geom`` in the source): one buffer holds an item's x rows,
    (th - 1)·s + K of them with the padding columns, and its th g rows,
    both across the width padded to whole runs of ``GRAD_W_RUN`` pixels,
    for cb channels; the block holds two, or the slots' partial sums if
    they need more. The launcher computes the same and refuses a plan
    over its cap; a CPU test holds the constants to the source's."""
    runs_w = -(-wo // GRAD_W_RUN) * GRAD_W_RUN
    xw = max((runs_w - 1) * stride + k, w + 2 * (k // 2))
    buf = (((th - 1) * stride + k) * xw + th * runs_w) * cb * itemsize
    red = THREADS // (cb // 2) * k * k * cb * 4
    return max(2 * buf, red), buf


@functools.lru_cache(maxsize=None)
def grad_w_plan(h: int, w: int, c: int, k: int, stride: int,
                itemsize: int) -> tuple[int, int]:
    """``(th, cb)`` of the tap-gradient kernel: items are bands of th
    output rows across the width, blocks take cb channels (a multiple of
    8, at most 512). For each cb that splits C into equal blocks, the
    fewest bands under ``GRAD_W_SMEM``, of equal height (the last band
    runs as many rows as the others, so a short one would compute on
    zero rows); of those, the plan that reads the
    fewest bytes per image (halo rows read again, phantom channels of a
    last short block counted) over the share of the block's threads that
    own a channel pair, ties to the larger cb. Blocks of at least 64
    channels (or all of C) come first: a warp's 32 channel pairs then read
    one pixel's contiguous 128 bytes, with no bank conflict. Cached: the
    search runs once per layer shape, not at every launch."""
    ho, wo = out_len(h, k, stride), out_len(w, k, stride)
    p = k // 2
    c8 = -(-c // 8) * 8
    plans = []
    for nb in range(-(-c8 // 512), c8 // 8 + 1):
        cb = 8 * -(-(c8 // 8) // nb)
        th = next((t for t in range(ho, 0, -1)
                   if grad_w_smem(t, cb, w, wo, k, stride, itemsize)[0]
                   <= GRAD_W_SMEM), 0)
        if not th:
            continue
        bands = -(-ho // th)
        th = -(-ho // bands)  # as many bands, evened out: no empty rows
        x_rows = sum(min(h, (min(ho, (b + 1) * th) - 1) * stride - p + k)
                     - max(0, b * th * stride - p) for b in range(bands))
        pairs = cb // 2
        used = pairs * (THREADS // pairs)
        read = -(-c // cb) * cb * (x_rows * w + ho * wo)
        plans.append((cb < min(c8, 64), read * THREADS / used, -cb, th))
    if not plans:
        raise ValueError(f"no tap-gradient plan fits {GRAD_W_SMEM} bytes "
                         f"for C={c}, H={h}, W={w}, K={k}")
    _, _, cb, th = min(plans)
    return th, -cb


def grad_w_splits(n: int, tiles: int, c_blocks: int,
                  blocks: int) -> tuple[int, int]:
    """``(nsplit, items_per_split)``: the tap-gradient kernel's split of
    the n x tiles (image, band) items of each channel block, so that
    nsplit x c_blocks stays within ``blocks`` (one wave when that is
    what the card holds at once), every item in exactly one split."""
    items = n * tiles
    per = -(-items // max(1, blocks // c_blocks))
    return -(-items // per), per


def _plain(name: str, t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        PLAIN_ON_CARD[name] += 1


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
    _plain("depthwise_conv_forward", x)
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
    _plain("depthwise_conv_grad_w", x)
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

def _launch(name: str, entry: str, dev: torch.device, *args) -> None:
    _cuda.launch("depthwise_conv", entry, dev, *args)
    KERNEL_LAUNCHES[name] += 1


_FLOATS = (torch.float32, torch.bfloat16)


def depthwise_forward(x: torch.Tensor, taps: torch.Tensor,
                      stride: int) -> torch.Tensor:
    """Depthwise conv: (N, H, W, C) f32/bf16 + (K, K, C) f32 taps ->
    (N, Ho, Wo, C) in x's type, f32 accumulation; replaces ``_pallas_dw``."""
    k = taps.shape[0]
    _check_conv(k, stride)
    if _cuda.on_cpu(x):
        return depthwise_forward_reference(x, taps, stride)
    n, h, w, c = x.shape
    _cuda.check_operand("x", x, _FLOATS, (n, h, w, c), x.device)
    _cuda.check_operand("taps", taps, torch.float32, (k, k, c), x.device)
    ho, wo = out_len(h, k, stride), out_len(w, k, stride)
    th, tw, cb = tile_plan(ho, wo, c, k, stride)
    out = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
    _launch("depthwise_conv_forward", "dw_conv_forward", x.device, x, taps,
            out, n, h, w, c, ho, wo, k, stride, th, tw, cb,
            int(x.dtype == torch.bfloat16))
    return out


def depthwise_grad_w(x: torch.Tensor, g: torch.Tensor, k: int,
                     stride: int) -> torch.Tensor:
    """Tap gradients: (N, H, W, C) input + (N, Ho, Wo, C) cotangent of its
    type -> (K, K, C) f32; replaces ``_pallas_dw_grad_w``. Per-block
    partial sums and a fixed-order reduction: repeated runs are bitwise
    equal. The kernel's plan: :func:`grad_w_plan`, :func:`grad_w_splits`
    over ``GRAD_W_BLOCKS_PER_SM`` blocks per SM of the card."""
    _check_conv(k, stride)
    if _cuda.on_cpu(x):
        return depthwise_grad_w_reference(x, g, k, stride)
    n, h, w, c = x.shape
    ho, wo = out_len(h, k, stride), out_len(w, k, stride)
    _cuda.check_operand("x", x, _FLOATS, (n, h, w, c), x.device)
    _cuda.check_operand("g", g, x.dtype, (n, ho, wo, c), x.device)
    th, cb = grad_w_plan(h, w, c, k, stride, x.element_size())
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nsplit, per = grad_w_splits(n, -(-ho // th), -(-c // cb),
                                GRAD_W_BLOCKS_PER_SM * sms)
    partial = torch.empty((nsplit, k * k, c), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((k, k, c), dtype=torch.float32, device=x.device)
    _launch("depthwise_conv_grad_w", "dw_conv_grad_w", x.device, x, g,
            partial, out, n, h, w, c, ho, wo, k, stride, th, cb, nsplit,
            per, int(x.dtype == torch.bfloat16))
    return out


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------

def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """An NCHW tensor as NHWC: a view of a channels-last tensor, else a
    copy (counted)."""
    v = t.permute(0, 2, 3, 1)
    if not v.is_contiguous():
        LAYOUT_COPIES["nhwc"] += 1
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


def depthwise_grad_x(g: torch.Tensor, taps: torch.Tensor, stride: int,
                     h: int, w: int) -> torch.Tensor:
    """The input gradient, (N, Ho, Wo, C) cotangent -> (N, H, W, C) in its
    type: the forward kernel at stride 1 with the taps flipped, on the
    dilated cotangent (``_dw_op_bwd``)."""
    return depthwise_forward(dilate(g, stride, h, w),
                             taps.flip(0, 1).contiguous(), 1)


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
