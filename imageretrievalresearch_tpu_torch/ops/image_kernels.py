"""Image kernels of on-device AutoAugment: per-plane histogram, per-plane
LUT apply, the integer shift of rows or of columns, and the cubic per-row
shift.

Counterpart of ``imageretrievalresearch_tpu/ops/pallas_image.py``. Each
function launches its hand-written CUDA kernel (``csrc/image_ops.cu``) for
a CUDA tensor, or raises; for a CPU tensor it runs its plain PyTorch
version (``*_reference``), which fixes the semantics and which the card's
comparisons use. The TPU kernels needed a static bound on the shifts
(``smax``) to unroll their roll passes; these read any shift directly.

All images are uint8. A plain version that runs on a CUDA tensor is
counted in the ledger of ``_cuda`` under its kernel's entry, so a run can
show that its main path went through the kernels only. The integer shift
has two forms, of rows (:func:`row_shift`) and of the columns of planes
(:func:`column_shift`, the rotate's Sy pass without a transposed copy),
both replacing ``pallas_row_shift``; each launches its own entry
(``image_row_shift``, ``image_column_shift``), and the column form's
plain version runs the row form's.
"""

from __future__ import annotations

import torch

from imageretrievalresearch_tpu_torch.ops import _cuda

FILL = 128


def cubic_weight(t: torch.Tensor) -> torch.Tensor:
    """PIL's *geometry* bicubic kernel (a = -1), the one weight function of
    the shears (``autoaugment``) and of the cubic row shift, op for op as
    JAX's ``autoaugment._cubic_kernel``: ``(a + 2) * s`` is ``s`` and ``* a``
    a negation, both exact."""
    s = t.abs()
    near = (s - 2.0) * s * s + 1.0
    far = -(((s - 5.0) * s + 8.0) * s - 4.0)
    return torch.where(s < 1.0, near,
                       torch.where(s < 2.0, far, torch.zeros_like(s)))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def plane_histogram_reference(planes: torch.Tensor) -> torch.Tensor:
    """(P, H, W) uint8 -> (P, 256) int32 counts, by scatter-add."""
    _cuda.plain_on_card("image_histogram", planes)
    flat = planes.reshape(planes.shape[0], -1).long()
    out = torch.zeros((planes.shape[0], 256), dtype=torch.int32,
                      device=planes.device)
    return out.scatter_add_(1, flat, torch.ones_like(flat,
                                                     dtype=torch.int32))


def lut_apply_reference(planes: torch.Tensor,
                        lut: torch.Tensor) -> torch.Tensor:
    """(P, H, W) uint8 + (P, 256) int32 in [0, 255] -> (P, H, W) uint8,
    ``out[p] = lut[p][planes[p]]``."""
    _cuda.plain_on_card("image_lut_apply", planes)
    p = planes.shape[0]
    rows = torch.arange(p, device=planes.device)[:, None]
    out = lut[rows, planes.reshape(p, -1).long()]
    return out.reshape(planes.shape).to(torch.uint8)


def row_shift_reference(rows: torch.Tensor, shifts: torch.Tensor, *,
                        fill: int = FILL) -> torch.Tensor:
    """(N, W) uint8 + (N,) int -> (N, W) uint8 with
    ``out(n, x) = rows(n, x + shifts(n))``, ``fill`` outside [0, W)."""
    _cuda.plain_on_card("image_row_shift", rows)
    w = rows.shape[1]
    src = (torch.arange(w, device=rows.device)[None, :]
           + shifts.long()[:, None])
    out = torch.gather(rows, 1, src.clamp(0, w - 1))
    return out.masked_fill((src < 0) | (src > w - 1), fill)


def column_shift_reference(planes: torch.Tensor, shifts: torch.Tensor, *,
                           fill: int = FILL) -> torch.Tensor:
    """(P, H, W) uint8 + (P, W) int -> (P, H, W) uint8 with
    ``out(p, y, x) = planes(p, y + shifts(p, x), x)``, ``fill`` outside
    [0, H): :func:`row_shift_reference` on the transposed planes."""
    p, h, w = planes.shape
    rows = planes.transpose(1, 2).reshape(p * w, h)
    out = row_shift_reference(rows, shifts.reshape(p * w), fill=fill)
    return out.reshape(p, w, h).transpose(1, 2).contiguous()


def row_shift_cubic_reference(rows: torch.Tensor, src0: torch.Tensor, *,
                              fill: int = FILL) -> torch.Tensor:
    """(N, W) uint8 + (N,) f32 source offsets -> (N, W) uint8: row n
    resampled at ``x + src0(n)`` with the 4-tap a = -1 cubic, ``fill``
    outside; the TPU kernel's arithmetic (taps summed in the order -1, 0,
    1, 2; division by max(wsum, 1e-8); source positions outside
    [-0.5, W - 0.5] filled; round half to even, clip)."""
    _cuda.plain_on_card("image_row_shift_cubic", rows)
    w = rows.shape[1]
    fl = torch.floor(src0.float())
    frac = (src0.float() - fl)[:, None]
    shift = fl.long()[:, None]
    col = torch.arange(w, device=rows.device)[None, :]
    x = rows.float()
    acc = torch.zeros(rows.shape, dtype=torch.float32, device=rows.device)
    wsum = torch.zeros_like(frac)
    for tap in (-1, 0, 1, 2):
        c = cubic_weight(frac - tap)
        idx = col + shift + tap
        inside = (idx >= 0) & (idx <= w - 1)
        pix = torch.gather(x, 1, idx.clamp(0, w - 1)).masked_fill(
            ~inside, float(fill))
        acc = acc + c * pix
        wsum = wsum + c
    out = acc / torch.clamp(wsum, min=1e-8)
    srcx = (col.float() + fl[:, None]) + frac
    out = out.masked_fill(~((srcx >= -0.5) & (srcx <= w - 0.5)), float(fill))
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def plane_histogram(planes: torch.Tensor) -> torch.Tensor:
    """Per-plane 256-bin histograms: (P, H, W) uint8 -> (P, 256) int32;
    replaces ``pallas_histogram``. One launch: the kernel writes every
    count, so the output is not zeroed first."""
    if _cuda.on_cpu(planes):
        return plane_histogram_reference(planes)
    p, h, w = planes.shape
    _cuda.check_operand("planes", planes, torch.uint8, (p, h, w),
                        planes.device)
    out = torch.empty((p, 256), dtype=torch.int32, device=planes.device)
    _cuda.launch("image_ops", "image_histogram", planes.device, planes, p,
                 h * w, out)
    return out


def lut_apply(planes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Per-plane 256-entry LUTs: (P, H, W) uint8 + (P, 256) int32 ->
    (P, H, W) uint8; replaces ``pallas_lut_apply`` (which returns int32).
    The entries must lie in [0, 255], as the equalize and autocontrast
    LUTs do (both are clipped), so the planes stay uint8."""
    if _cuda.on_cpu(planes):
        return lut_apply_reference(planes, lut)
    p, h, w = planes.shape
    dev = planes.device
    _cuda.check_operand("planes", planes, torch.uint8, (p, h, w), dev)
    _cuda.check_operand("lut", lut, torch.int32, (p, 256), dev)
    out = torch.empty_like(planes)
    _cuda.launch("image_ops", "image_lut_apply", dev, planes, lut, p, h * w,
                 out)
    return out


def row_shift(rows: torch.Tensor, shifts: torch.Tensor, *,
              fill: int = FILL) -> torch.Tensor:
    """Per-row integer shift: (N, W) uint8 + (N,) int32 -> (N, W) uint8,
    ``out(n, x) = rows(n, x + shifts(n))``, ``fill`` outside [0, W);
    replaces ``pallas_row_shift``."""
    if _cuda.on_cpu(rows):
        return row_shift_reference(rows, shifts, fill=fill)
    n, w = rows.shape
    dev = rows.device
    _cuda.check_operand("rows", rows, torch.uint8, (n, w), dev)
    _cuda.check_operand("shifts", shifts, torch.int32, (n,), dev)
    out = torch.empty_like(rows)
    _cuda.launch("image_ops", "image_row_shift", dev, rows, shifts, n, w,
                 fill, out)
    return out


def column_shift(planes: torch.Tensor, shifts: torch.Tensor, *,
                 fill: int = FILL) -> torch.Tensor:
    """Per-column integer shift of planes: (P, H, W) uint8 + (P, W) int32
    -> (P, H, W) uint8, ``out(p, y, x) = planes(p, y + shifts(p, x), x)``,
    ``fill`` outside [0, H); the transpose of :func:`row_shift`, one
    launch of ``image_column_shift``. H is at most 49,152 on the card, as W is for
    :func:`row_shift`."""
    if _cuda.on_cpu(planes):
        return column_shift_reference(planes, shifts, fill=fill)
    p, h, w = planes.shape
    dev = planes.device
    _cuda.check_operand("planes", planes, torch.uint8, (p, h, w), dev)
    _cuda.check_operand("shifts", shifts, torch.int32, (p, w), dev)
    out = torch.empty_like(planes)
    _cuda.launch("image_ops", "image_column_shift", dev, planes, shifts, p,
                 h, w, fill, out)
    return out


def row_shift_cubic(rows: torch.Tensor, src0: torch.Tensor, *,
                    fill: int = FILL) -> torch.Tensor:
    """Per-row fractional shift with PIL-bicubic resampling: (N, W) uint8 +
    (N,) f32 -> (N, W) uint8 (:func:`row_shift_cubic_reference`), bitwise;
    replaces ``pallas_row_shift_cubic``. W is at most 49,152 on the card,
    as for :func:`row_shift`."""
    if _cuda.on_cpu(rows):
        return row_shift_cubic_reference(rows, src0, fill=fill)
    n, w = rows.shape
    dev = rows.device
    _cuda.check_operand("rows", rows, torch.uint8, (n, w), dev)
    _cuda.check_operand("src0", src0, torch.float32, (n,), dev)
    out = torch.empty_like(rows)
    _cuda.launch("image_ops", "image_row_shift_cubic", dev, rows, src0, n,
                 w, fill, out)
    return out
