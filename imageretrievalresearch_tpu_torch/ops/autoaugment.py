"""AutoAugment ImageNetPolicy on the device, batched, drawn from a
``torch.Generator``.

Counterpart of ``imageretrievalresearch_tpu/ops/autoaugment.py``: the 25
public sub-policies of two (op, probability, magnitude) stages, gray fill
(128), PIL semantics (LUT ops integer-exact; enhancement ops blend
``degenerate + f * (img - degenerate)`` in f32; shears a 1-D a = -1
cubic; translate and rotate NEAREST).

Every op takes the whole (B, H, W, 3) uint8 batch and per-image (B,)
magnitudes. A policy stage computes each op it can select batch-wide and
picks each image's result by a chain of selects, as JAX does. The op
table follows the images' device, as JAX's follows its backend:

- a CUDA batch takes JAX's accelerator table: equalize and autocontrast
  through the histogram and LUT kernels, shearX through the cubic row
  shift kernel, rotate as three integer row shifts (the 3-shear rotate);
- a CPU batch takes JAX's CPU table: the same ops with the kernels' plain
  versions, and rotate as the exact gather (:func:`op_rotate`).

The draws (:func:`draw_policy`) are separate from their application
(:func:`apply_policy`), so the same draws can be handed to JAX. They do
not follow the ``jax.random`` stream.
"""

from __future__ import annotations

import numpy as np
import torch

from imageretrievalresearch_tpu_torch.ops.image_kernels import (
    FILL,
    column_shift,
    cubic_weight,
    lut_apply,
    plane_histogram,
    row_shift,
    row_shift_cubic,
)

# op ids
SHEAR_X, SHEAR_Y, TRANSLATE_X, TRANSLATE_Y, ROTATE = 0, 1, 2, 3, 4
COLOR, POSTERIZE, SOLARIZE, CONTRAST, SHARPNESS = 5, 6, 7, 8, 9
BRIGHTNESS, AUTOCONTRAST, EQUALIZE, INVERT = 10, 11, 12, 13
_NUM_OPS = 14

_OP_IDS = {
    "shearX": SHEAR_X, "shearY": SHEAR_Y, "translateX": TRANSLATE_X,
    "translateY": TRANSLATE_Y, "rotate": ROTATE, "color": COLOR,
    "posterize": POSTERIZE, "solarize": SOLARIZE, "contrast": CONTRAST,
    "sharpness": SHARPNESS, "brightness": BRIGHTNESS,
    "autocontrast": AUTOCONTRAST, "equalize": EQUALIZE, "invert": INVERT,
}

# the public ImageNetPolicy sub-policy table:
# ((op1, p1, mag_idx1), (op2, p2, mag_idx2)) x 25
IMAGENET_SUBPOLICIES = [
    (("posterize", 0.4, 8), ("rotate", 0.6, 9)),
    (("solarize", 0.6, 5), ("autocontrast", 0.6, 5)),
    (("equalize", 0.8, 8), ("equalize", 0.6, 3)),
    (("posterize", 0.6, 7), ("posterize", 0.6, 6)),
    (("equalize", 0.4, 7), ("solarize", 0.2, 4)),
    (("equalize", 0.4, 4), ("rotate", 0.8, 8)),
    (("solarize", 0.6, 3), ("equalize", 0.6, 7)),
    (("posterize", 0.8, 5), ("equalize", 1.0, 2)),
    (("rotate", 0.2, 3), ("solarize", 0.6, 8)),
    (("equalize", 0.6, 8), ("posterize", 0.4, 6)),
    (("rotate", 0.8, 8), ("color", 0.4, 0)),
    (("rotate", 0.4, 9), ("equalize", 0.6, 2)),
    (("equalize", 0.0, 7), ("equalize", 0.8, 8)),
    (("invert", 0.6, 4), ("equalize", 1.0, 8)),
    (("color", 0.6, 4), ("contrast", 1.0, 8)),
    (("rotate", 0.8, 8), ("color", 1.0, 2)),
    (("color", 0.8, 8), ("solarize", 0.8, 7)),
    (("sharpness", 0.4, 7), ("invert", 0.6, 8)),
    (("shearX", 0.6, 5), ("equalize", 1.0, 9)),
    (("color", 0.4, 0), ("equalize", 0.6, 3)),
    (("equalize", 0.4, 7), ("solarize", 0.2, 4)),
    (("solarize", 0.6, 5), ("autocontrast", 0.6, 5)),
    (("invert", 0.6, 4), ("equalize", 1.0, 8)),
    (("color", 0.6, 4), ("contrast", 1.0, 8)),
    (("equalize", 0.8, 8), ("equalize", 0.6, 3)),
]


def _magnitude_table() -> np.ndarray:
    """(num_ops, 10) magnitude value per op per magnitude index."""
    t = np.zeros((_NUM_OPS, 10), dtype=np.float32)
    t[SHEAR_X] = t[SHEAR_Y] = np.linspace(0, 0.3, 10)
    t[TRANSLATE_X] = t[TRANSLATE_Y] = np.linspace(0, 150 / 331, 10)
    t[ROTATE] = np.linspace(0, 30, 10)
    for op in (COLOR, CONTRAST, SHARPNESS, BRIGHTNESS):
        t[op] = np.linspace(0.0, 0.9, 10)
    t[POSTERIZE] = np.round(np.linspace(8, 4, 10), 0)
    t[SOLARIZE] = np.linspace(256, 0, 10)
    return t


_MAGS = _magnitude_table()


def _policy_arrays() -> tuple[np.ndarray, ...]:
    ops = np.zeros((25, 2), dtype=np.int32)
    probs = np.zeros((25, 2), dtype=np.float32)
    mags = np.zeros((25, 2), dtype=np.float32)
    for i, (s1, s2) in enumerate(IMAGENET_SUBPOLICIES):
        for j, (name, p, mi) in enumerate((s1, s2)):
            op = _OP_IDS[name]
            ops[i, j] = op
            probs[i, j] = p
            mags[i, j] = _MAGS[op, mi]
    return ops, probs, mags


_POLICY_OPS, _POLICY_PROBS, _POLICY_MAGS = _policy_arrays()


def _per_image(v: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1, 1), to broadcast over a (B, H, W, C) batch."""
    return v.reshape(-1, 1, 1, 1)


# ---------------------------------------------------------------------------
# pointwise / LUT ops (uint8-exact vs PIL)
# ---------------------------------------------------------------------------

def op_invert(img, mag):
    return 255 - img


def op_posterize(img, bits):
    shift = 8 - bits.to(torch.int32)
    mask = torch.bitwise_left_shift(torch.full_like(shift, 255), shift) & 255
    return (img.to(torch.int32) & _per_image(mask)).to(torch.uint8)


def op_solarize(img, threshold):
    v = img.to(torch.int32)
    return torch.where(v < _per_image(threshold), v, 255 - v).to(torch.uint8)


def _planes(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B*C, H, W) contiguous planes."""
    b, h, w, c = images.shape
    return images.permute(0, 3, 1, 2).reshape(b * c, h, w).contiguous()


def _unplanes(planes: torch.Tensor, shape) -> torch.Tensor:
    b, h, w, c = shape
    return planes.reshape(b, c, h, w).permute(0, 2, 3, 1)


def _equalize_lut(hist: torch.Tensor) -> torch.Tensor:
    """(P, 256) histograms -> (P, 256) PIL-equalize LUTs (int algorithm)."""
    p = hist.shape[0]
    nz = (hist > 0).to(torch.int32)
    last_nz = 255 - torch.argmax(nz.flip(1), dim=1)
    h_last = torch.gather(hist, 1, last_nz[:, None])[:, 0]
    total = hist.sum(dim=1, dtype=torch.int32)
    step = torch.div(total - h_last, 255, rounding_mode="floor")
    csum = torch.cat([torch.zeros((p, 1), dtype=hist.dtype,
                                  device=hist.device),
                      torch.cumsum(hist, dim=1, dtype=hist.dtype)[:, :-1]],
                     dim=1)
    ar = torch.arange(256, dtype=torch.int32, device=hist.device)
    stepc = step[:, None]
    lut = torch.clamp(torch.div(torch.div(stepc, 2, rounding_mode="floor")
                                + csum, torch.clamp(stepc, min=1),
                                rounding_mode="floor"), 0, 255)
    return torch.where(stepc > 0, lut, ar).to(torch.int32)


def _autocontrast_lut(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(P,) channel min/max -> (P, 256) PIL-autocontrast LUTs."""
    ar = torch.arange(256, dtype=torch.int32, device=lo.device)
    num = (ar[None] - lo[:, None]) * 255
    den = torch.clamp(hi - lo, min=1)[:, None]
    # JAX's sign-aware integer division: floor for num >= 0, else
    # -((-num) // den), i.e. rounded toward zero
    lut = torch.clamp(torch.where(
        num >= 0, torch.div(num, den, rounding_mode="floor"),
        -torch.div(-num, den, rounding_mode="floor")), 0, 255)
    return torch.where((hi > lo)[:, None], lut, ar).to(torch.int32)


def batched_equalize(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> PIL ImageOps.equalize per channel."""
    planes = _planes(images)
    lut = _equalize_lut(plane_histogram(planes))
    return _unplanes(lut_apply(planes, lut), images.shape)


def batched_autocontrast(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> PIL ImageOps.autocontrast (cutoff 0) per
    channel."""
    planes = _planes(images)
    flat = planes.reshape(planes.shape[0], -1).to(torch.int32)
    lut = _autocontrast_lut(flat.amin(dim=1), flat.amax(dim=1))
    return _unplanes(lut_apply(planes, lut), images.shape)


def op_equalize(img, mag):
    return batched_equalize(img)


def op_autocontrast(img, mag):
    return batched_autocontrast(img)


# ---------------------------------------------------------------------------
# enhancement ops (PIL ImageEnhance.X.enhance(1 + signed_mag))
# ---------------------------------------------------------------------------

def _pil_gray(img: torch.Tensor) -> torch.Tensor:
    """PIL convert('L') fixed-point luma: (R*19595+G*38470+B*7471+0x8000)>>16,
    (B, H, W) int32."""
    v = img.to(torch.int32)
    return (v[..., 0] * 19595 + v[..., 1] * 38470 + v[..., 2] * 7471
            + 0x8000) >> 16


def _blend(degenerate: torch.Tensor, img: torch.Tensor,
           factor: torch.Tensor) -> torch.Tensor:
    """PIL Image.blend/enhance: degenerate + factor*(img - degenerate),
    clipped, in f32."""
    d = degenerate.float()
    out = d + _per_image(factor) * (img.float() - d)
    return torch.clamp(out, 0, 255).to(torch.uint8)


def op_color(img, factor):
    return _blend(_pil_gray(img)[..., None].expand(img.shape), img, factor)


def op_contrast(img, factor):
    # PIL: mean = int(Stat(L).mean + 0.5), solid-gray degenerate
    mean = torch.floor(_pil_gray(img).float().mean(dim=(1, 2)) + 0.5)
    return _blend(_per_image(mean).expand(img.shape), img, factor)


def op_brightness(img, factor):
    return _blend(torch.zeros_like(img), img, factor)


# ImageFilter.SMOOTH, [[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13 in f32
_SMOOTH = (torch.tensor([[1., 1., 1.], [1., 5., 1.], [1., 1., 1.]])
           / 13.0).tolist()


def op_sharpness(img, factor):
    # degenerate = SMOOTH over the interior, the 1 px border unfiltered (PIL
    # filters skip it); the 3x3 sum as nine shifted products, in f32
    v = img.float()
    h, w = img.shape[1], img.shape[2]
    smoothed = None
    for dy in range(3):
        for dx in range(3):
            term = _SMOOTH[dy][dx] * v[:, dy:dy + h - 2, dx:dx + w - 2]
            smoothed = term if smoothed is None else smoothed + term
    smoothed = torch.clamp(smoothed + 0.5, 0, 255).to(torch.int32).float()
    degenerate = v.clone()
    degenerate[:, 1:-1, 1:-1] = smoothed
    return _blend(degenerate, img, factor)


# ---------------------------------------------------------------------------
# geometric ops
# ---------------------------------------------------------------------------

def _shear_x(img: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """PIL AFFINE shearX with BICUBIC resampling, per image slope ``v``:
    src_x = x + v*y (PIL samples at out+0.5, then -0.5); the 1-D cubic
    along x, taps gathered, gray fill outside."""
    b, h, w, _ = img.shape
    dev = img.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    src = ((xs[None, None, :] + 0.5)
           + v[:, None, None] * (ys[None, :, None] + 0.5)) - 0.5  # (B,H,W)
    fl = torch.floor(src)
    base = fl.long()
    frac = src - fl
    vf = img.float()
    out = torch.zeros_like(vf)
    wsum = torch.zeros((b, h, w, 1), dtype=torch.float32, device=dev)
    for tap in (-1, 0, 1, 2):
        idx = base + tap
        inside = ((idx >= 0) & (idx <= w - 1))[..., None]
        wt = cubic_weight(frac - tap)[..., None]
        pix = torch.gather(vf, 2, idx.clamp(0, w - 1)[..., None].expand(
            vf.shape))
        pix = pix.masked_fill(~inside, float(FILL))
        out = out + wt * pix
        wsum = wsum + wt
    valid = ((src >= -0.5) & (src <= w - 0.5))[..., None]
    out = out / torch.clamp(wsum, min=1e-8)
    out = out.masked_fill(~valid, float(FILL))
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def _translate(img: torch.Tensor, pixels: torch.Tensor,
               axis: int) -> torch.Tensor:
    """PIL AFFINE translate with NEAREST: src = out + pixels, gray fill;
    ``axis`` 2 is x, 1 is y of the (B, H, W, C) batch."""
    n = img.shape[axis]
    coords = torch.arange(n, dtype=torch.float32, device=img.device)
    idx = torch.floor(coords[None] + pixels[:, None] + 0.5).long()  # (B, n)
    inside = (idx >= 0) & (idx <= n - 1)
    shape = [img.shape[0], 1, 1, 1]
    shape[axis] = n
    out = torch.gather(img, axis, idx.clamp(0, n - 1).reshape(shape).expand(
        img.shape))
    return out.masked_fill(~inside.reshape(shape), FILL)


def _deg2rad(degrees: torch.Tensor) -> torch.Tensor:
    # jnp.deg2rad: one f32 multiply by f32(pi / 180)
    return degrees.float() * float(np.float32(np.pi / 180))


def op_rotate(img, degrees):
    """PIL Image.rotate(angle) (CCW, NEAREST, about the center) with gray
    fill, as one exact gather per output pixel."""
    b, h, w, c = img.shape
    dev = img.device
    # PIL negates the angle before building the output->input matrix
    theta = -_deg2rad(degrees)
    cos = torch.cos(theta)[:, None, None]
    sin = torch.sin(theta)[:, None, None]
    cx, cy = w / 2.0, h / 2.0
    ys = (torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5
          - cy)
    xs = (torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
          - cx)
    src_x = cos * xs + sin * ys + cx - 0.5
    src_y = -sin * xs + cos * ys + cy - 0.5
    ix = torch.floor(src_x + 0.5).long()
    iy = torch.floor(src_y + 0.5).long()
    inside = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
    flat = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(b, h * w, 1)
    out = torch.gather(img.reshape(b, h * w, c), 1, flat.expand(b, h * w, c))
    return out.reshape(b, h, w, c).masked_fill(~inside[..., None], FILL)


def op_shear_x(img, mag):
    return _shear_x(img, mag)


def op_shear_y(img, mag):
    return _shear_x(img.transpose(1, 2), mag).transpose(1, 2)


def op_translate_x(img, mag):
    return _translate(img, mag * img.shape[2], axis=2)


def op_translate_y(img, mag):
    return _translate(img, mag * img.shape[1], axis=1)


_OP_FNS = [None] * _NUM_OPS
_OP_FNS[SHEAR_X] = op_shear_x
_OP_FNS[SHEAR_Y] = op_shear_y
_OP_FNS[TRANSLATE_X] = op_translate_x
_OP_FNS[TRANSLATE_Y] = op_translate_y
_OP_FNS[ROTATE] = op_rotate
_OP_FNS[COLOR] = op_color
_OP_FNS[POSTERIZE] = op_posterize
_OP_FNS[SOLARIZE] = op_solarize
_OP_FNS[CONTRAST] = op_contrast
_OP_FNS[SHARPNESS] = op_sharpness
_OP_FNS[BRIGHTNESS] = op_brightness
_OP_FNS[AUTOCONTRAST] = op_autocontrast
_OP_FNS[EQUALIZE] = op_equalize
_OP_FNS[INVERT] = op_invert

_GEO_OPS = (SHEAR_X, SHEAR_Y, TRANSLATE_X, TRANSLATE_Y, ROTATE)
_ENH_OPS = (COLOR, CONTRAST, SHARPNESS, BRIGHTNESS)


# ---------------------------------------------------------------------------
# batched shear and rotate on the row-shift kernels
# ---------------------------------------------------------------------------

def batched_shear_x(images: torch.Tensor, vm: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 + (B,) signed slopes -> sheared batch: each row
    of each plane shifted by ``src0 = v * (y + 0.5)`` through the cubic row
    shift (:func:`image_kernels.row_shift_cubic`). Within ±1 of
    :func:`op_shear_x` (rounding ties of another summation grouping)."""
    b, h, w, c = images.shape
    ys = torch.arange(h, dtype=torch.float32, device=images.device)
    src0 = vm.float()[:, None] * (ys[None, :] + 0.5)             # (B, H)
    rows = _planes(images).reshape(b * c * h, w)
    src_rows = src0[:, None, :].expand(b, c, h).reshape(-1).contiguous()
    out = row_shift_cubic(rows, src_rows, fill=FILL)
    return _unplanes(out.reshape(b * c, h, w), images.shape)


def _nearest_row_shift(planes: torch.Tensor, v: torch.Tensor
                       ) -> torch.Tensor:
    """(B, C, H, W) uint8 + (B,) slopes -> per-row NEAREST shift about the
    vertical center: out(y, x) = in(y, x + s(y)), s = ⌊v·(y+½−H/2) + ½⌋,
    through the integer row shift (:func:`image_kernels.row_shift`)."""
    b, c, h, w = planes.shape
    ys = (torch.arange(h, dtype=torch.float32, device=planes.device) + 0.5
          - h / 2.0)
    s_by = torch.floor(v[:, None] * ys[None, :] + 0.5).to(torch.int32)
    rows = planes.reshape(b * c * h, w).contiguous()
    s_rows = s_by[:, None, :].expand(b, c, h).reshape(-1).contiguous()
    return row_shift(rows, s_rows, fill=FILL).reshape(b, c, h, w)


def _nearest_column_shift(planes: torch.Tensor, v: torch.Tensor
                          ) -> torch.Tensor:
    """(B, C, H, W) uint8 + (B,) slopes -> per-column NEAREST shift about
    the horizontal center: out(y, x) = in(y + s(x), x), s = ⌊v·(x+½−W/2) +
    ½⌋, through the column form of the integer shift
    (:func:`image_kernels.column_shift`); :func:`_nearest_row_shift` of the
    transposed planes, transposed back."""
    b, c, h, w = planes.shape
    xs = (torch.arange(w, dtype=torch.float32, device=planes.device) + 0.5
          - w / 2.0)
    s_bx = torch.floor(v[:, None] * xs[None, :] + 0.5).to(torch.int32)
    s_planes = s_bx[:, None, :].expand(b, c, w).reshape(b * c, w).contiguous()
    return column_shift(planes.reshape(b * c, h, w).contiguous(), s_planes,
                        fill=FILL).reshape(b, c, h, w)


def batched_rotate(images: torch.Tensor, degrees: torch.Tensor
                   ) -> torch.Tensor:
    """(B, H, W, 3) uint8 + (B,) signed degrees -> rotated batch, by the
    3-shear decomposition of PIL NEAREST rotate,
    ``R(θ) = Sx(tan θ/2) · Sy(−sin θ) · Sx(tan θ/2)``, each pass one
    integer shift of one contiguous copy of the planes: Sx on rows, Sy on
    columns (JAX runs Sy as a row shift of the transposed planes; the
    numbers are the same). Per-pass rounding drifts ≤ 1 px from the exact
    gather (:func:`op_rotate`): JAX documents 60-80% of pixels identical."""
    theta = -_deg2rad(degrees)
    a = torch.tan(theta / 2.0)
    bb = -torch.sin(theta)
    planes = images.permute(0, 3, 1, 2).contiguous()      # (B, 3, H, W)
    t1 = _nearest_row_shift(planes, a)
    t2 = _nearest_column_shift(t1, bb)
    t3 = _nearest_row_shift(t2, a)
    return t3.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

# where a stage departs from _OP_FNS (equalize and autocontrast are batched
# there already): shearX on the cubic row shift; on the card also the
# 3-shear rotate (JAX's _BATCHED_OPS_TPU)
_BATCHED_OPS = {SHEAR_X: batched_shear_x}
_BATCHED_OPS_CARD = {**_BATCHED_OPS, ROTATE: batched_rotate}

# ops that can be selected at each stage position of the 25 sub-policies
_STAGE_OPS = tuple(
    tuple(sorted({_OP_IDS[sub[stage][0]] for sub in IMAGENET_SUBPOLICIES}))
    for stage in (0, 1))


def _apply_stage(images: torch.Tensor, op: torch.Tensor, mag: torch.Tensor,
                 do: torch.Tensor, sign: torch.Tensor,
                 op_set: tuple[int, ...]) -> torch.Tensor:
    """One policy stage over the whole batch, batched by op: every op of
    ``op_set`` is computed batch-wide with the per-image magnitudes, each
    image's result chosen by a chain of selects."""
    geo = sign * mag
    enh = 1.0 + sign * mag
    opb = _per_image(op.to(torch.int32))
    table = _BATCHED_OPS_CARD if images.device.type == "cuda" else _BATCHED_OPS
    sel = images
    for k in op_set:
        arg = enh if k in _ENH_OPS else (geo if k in _GEO_OPS else mag)
        cand = table.get(k, _OP_FNS[k])(images, arg)
        sel = torch.where(opb == k, cand, sel)
    return torch.where(_per_image(do), sel, images)


def draw_policy(batch: int, generator: torch.Generator):
    """Per image: a sub-policy, whether each stage runs, and each stage's
    magnitude sign, drawn from ``generator`` on its device. Returns
    ``(ops (B, 2) int32, mags (B, 2) f32, do (B, 2) bool, signs (B, 2)
    f32)``."""
    dev = generator.device
    pol = torch.randint(0, len(IMAGENET_SUBPOLICIES), (batch,),
                        generator=generator, device=dev)
    u = torch.rand((batch, 2), generator=generator, device=dev)
    signs = torch.where(torch.rand((batch, 2), generator=generator,
                                   device=dev) < 0.5, 1.0, -1.0)
    ops, probs, mags = (torch.from_numpy(t).to(dev)[pol] for t in
                        (_POLICY_OPS, _POLICY_PROBS, _POLICY_MAGS))
    return ops, mags, u < probs, signs


def apply_policy(images: torch.Tensor, ops: torch.Tensor, mags: torch.Tensor,
                 do: torch.Tensor, signs: torch.Tensor) -> torch.Tensor:
    """Both stages of the drawn sub-policies over a (B, H, W, 3) uint8
    batch."""
    out = _apply_stage(images, ops[:, 0], mags[:, 0], do[:, 0], signs[:, 0],
                       _STAGE_OPS[0])
    return _apply_stage(out, ops[:, 1], mags[:, 1], do[:, 1], signs[:, 1],
                        _STAGE_OPS[1])


def imagenet_policy_batch(images: torch.Tensor,
                          generator: torch.Generator) -> torch.Tensor:
    """(B, H, W, 3) uint8 + generator (on the images' device) -> augmented
    uint8 batch: per image a sub-policy, then its two stages with
    independent random signs."""
    return apply_policy(images, *draw_policy(images.shape[0], generator))


def imagenet_policy(img: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
    """Single-image convenience wrapper around the batched policy."""
    return imagenet_policy_batch(img[None], generator)[0]
