"""Plain PyTorch image transforms of the benchmark's cells.

- ``eval_transform``: the serving path's SquarePad(255) -> bilinear resize
  with antialiasing (``jax.image.resize``'s triangle-kernel weight
  matrices, applied per axis) -> ToTensor -> ImageNet normalisation.
- ``train_transform``: resize -> (optionally) AutoAugment ImageNetPolicy
  on uint8 -> ToTensor, for the three roles of a triplet batch, drawing
  from one ``torch.Generator`` in the order qry, pos, neg.

AutoAugment follows the public ImageNetPolicy (25 sub-policies of two
(op, probability, magnitude) stages, PIL semantics, gray fill 128) as a
batch is augmented on a card: every op a stage can select is computed for
the whole batch and each image takes its own; equalize and autocontrast
through per-plane histograms and lookup tables, shearX as a per-row
4-tap cubic (a = -1) shift, rotate as three integer shears
(``Sx(tan θ/2) Sy(-sin θ) Sx(tan θ/2)``, NEAREST). The draws per role are
``randint(25)``, ``rand(B, 2)`` (whether each stage runs) and
``rand(B, 2) < 0.5`` (each stage's sign). Nothing here imports the
program.
"""

from __future__ import annotations

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
FILL = 128


# --- resize ---------------------------------------------------------------

def weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(in, out) f32 weights of the antialiased triangle kernel,
    normalised per output sample (``jax.image.scale_and_translate``)."""
    f32 = np.float32
    inv = 1.0 / (n_out / n_in)
    kscale = f32(max(inv, 1.0))
    sample = ((np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv)
              - f32(0.0) * f32(inv) - f32(0.5))
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kscale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    tot = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(tot != 0, tot, f32(1)), f32(0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, size, size, C) float32."""
    x = x.float()
    h, w = x.shape[1], x.shape[2]
    if h != size:
        m = torch.from_numpy(weight_matrix(h, size)).to(x.device)
        x = torch.einsum("bhwc,ho->bowc", x, m)
    if w != size:
        m = torch.from_numpy(weight_matrix(w, size)).to(x.device)
        x = torch.einsum("bhwc,wo->bhoc", x, m)
    return x


def square_pad(x: torch.Tensor, fill: int = 255) -> torch.Tensor:
    h, w = x.shape[1], x.shape[2]
    m = max(h, w)
    out = torch.full((x.shape[0], m, m, x.shape[3]), fill, dtype=x.dtype,
                     device=x.device)
    top, left = (m - h) // 2, (m - w) // 2
    out[:, top:top + h, left:left + w] = x
    return out


def eval_transform(images_u8: torch.Tensor, size: int) -> torch.Tensor:
    x = resize(square_pad(images_u8), size) / 255.0
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    return (x - mean) / std


# --- AutoAugment ImageNetPolicy -------------------------------------------

SUBPOLICIES = [
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
OPS = ("shearX", "rotate", "color", "posterize", "solarize", "contrast",
       "sharpness", "autocontrast", "equalize", "invert")
GEOMETRIC = ("shearX", "rotate")
ENHANCE = ("color", "contrast", "sharpness")


def _magnitudes(op: str) -> np.ndarray:
    if op == "shearX":
        return np.linspace(0, 0.3, 10).astype(np.float32)
    if op == "rotate":
        return np.linspace(0, 30, 10).astype(np.float32)
    if op in ENHANCE:
        return np.linspace(0.0, 0.9, 10).astype(np.float32)
    if op == "posterize":
        return np.round(np.linspace(8, 4, 10), 0).astype(np.float32)
    if op == "solarize":
        return np.linspace(256, 0, 10).astype(np.float32)
    return np.zeros(10, np.float32)


def _table():
    ops = np.zeros((25, 2), np.int64)
    probs = np.zeros((25, 2), np.float32)
    mags = np.zeros((25, 2), np.float32)
    for i, stages in enumerate(SUBPOLICIES):
        for j, (name, p, m) in enumerate(stages):
            ops[i, j] = OPS.index(name)
            probs[i, j] = p
            mags[i, j] = _magnitudes(name)[m]
    return ops, probs, mags


def _img(v):
    return v.reshape(-1, 1, 1, 1)


def _planes(x):
    b, h, w, c = x.shape
    return x.permute(0, 3, 1, 2).reshape(b * c, h, w).contiguous()


def _unplanes(p, shape):
    b, h, w, c = shape
    return p.reshape(b, c, h, w).permute(0, 2, 3, 1)


def _lut(planes, lut):
    p = planes.shape[0]
    rows = torch.arange(p, device=planes.device)[:, None]
    return lut[rows, planes.reshape(p, -1).long()].reshape(
        planes.shape).to(torch.uint8)


def equalize(x):
    planes = _planes(x)
    p = planes.shape[0]
    hist = torch.zeros((p, 256), dtype=torch.int32, device=x.device)
    flat = planes.reshape(p, -1).long()
    hist.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    nz = (hist > 0).to(torch.int32)
    last = 255 - torch.argmax(nz.flip(1), dim=1)
    h_last = torch.gather(hist, 1, last[:, None])[:, 0]
    step = torch.div(hist.sum(1, dtype=torch.int32) - h_last, 255,
                     rounding_mode="floor")[:, None]
    csum = torch.cat([torch.zeros((p, 1), dtype=hist.dtype, device=x.device),
                      torch.cumsum(hist, 1, dtype=hist.dtype)[:, :-1]], 1)
    lut = torch.clamp(torch.div(torch.div(step, 2, rounding_mode="floor")
                                + csum, torch.clamp(step, min=1),
                                rounding_mode="floor"), 0, 255)
    ar = torch.arange(256, dtype=torch.int32, device=x.device)
    lut = torch.where(step > 0, lut, ar).to(torch.int32)
    return _unplanes(_lut(planes, lut), x.shape)


def autocontrast(x):
    planes = _planes(x)
    flat = planes.reshape(planes.shape[0], -1).to(torch.int32)
    lo, hi = flat.amin(1), flat.amax(1)
    ar = torch.arange(256, dtype=torch.int32, device=x.device)
    num = (ar[None] - lo[:, None]) * 255
    den = torch.clamp(hi - lo, min=1)[:, None]
    lut = torch.clamp(torch.where(
        num >= 0, torch.div(num, den, rounding_mode="floor"),
        -torch.div(-num, den, rounding_mode="floor")), 0, 255)
    lut = torch.where((hi > lo)[:, None], lut, ar).to(torch.int32)
    return _unplanes(_lut(planes, lut), x.shape)


def _gray(x):
    v = x.to(torch.int32)
    return (v[..., 0] * 19595 + v[..., 1] * 38470 + v[..., 2] * 7471
            + 0x8000) >> 16


def _blend(degenerate, x, factor):
    d = degenerate.float()
    return torch.clamp(d + _img(factor) * (x.float() - d), 0, 255).to(
        torch.uint8)


def color(x, f):
    return _blend(_gray(x)[..., None].expand(x.shape), x, f)


def contrast(x, f):
    mean = torch.floor(_gray(x).float().mean(dim=(1, 2)) + 0.5)
    return _blend(_img(mean).expand(x.shape), x, f)


_SMOOTH = (torch.tensor([[1., 1., 1.], [1., 5., 1.], [1., 1., 1.]])
           / 13.0).tolist()


def sharpness(x, f):
    v = x.float()
    h, w = x.shape[1], x.shape[2]
    acc = None
    for dy in range(3):
        for dx in range(3):
            t = _SMOOTH[dy][dx] * v[:, dy:dy + h - 2, dx:dx + w - 2]
            acc = t if acc is None else acc + t
    acc = torch.clamp(acc + 0.5, 0, 255).to(torch.int32).float()
    d = v.clone()
    d[:, 1:-1, 1:-1] = acc
    return _blend(d, x, f)


def posterize(x, bits):
    shift = 8 - bits.to(torch.int32)
    mask = torch.bitwise_left_shift(torch.full_like(shift, 255), shift) & 255
    return (x.to(torch.int32) & _img(mask)).to(torch.uint8)


def solarize(x, threshold):
    v = x.to(torch.int32)
    return torch.where(v < _img(threshold), v, 255 - v).to(torch.uint8)


def invert(x, _):
    return 255 - x


def cubic(t):
    s = t.abs()
    near = (s - 2.0) * s * s + 1.0
    far = -(((s - 5.0) * s + 8.0) * s - 4.0)
    return torch.where(s < 1.0, near,
                       torch.where(s < 2.0, far, torch.zeros_like(s)))


def _cubic_rows(rows, src0):
    """Row n resampled at ``x + src0[n]``: taps -1..2 summed in that order,
    divided by their weights' sum, fill outside [-0.5, W - 0.5], rounded
    half to even."""
    w = rows.shape[1]
    fl = torch.floor(src0.float())
    frac = (src0.float() - fl)[:, None]
    shift = fl.long()[:, None]
    col = torch.arange(w, device=rows.device)[None, :]
    x = rows.float()
    acc = torch.zeros(rows.shape, dtype=torch.float32, device=rows.device)
    wsum = torch.zeros_like(frac)
    for tap in (-1, 0, 1, 2):
        c = cubic(frac - tap)
        idx = col + shift + tap
        pix = torch.gather(x, 1, idx.clamp(0, w - 1)).masked_fill(
            (idx < 0) | (idx > w - 1), float(FILL))
        acc = acc + c * pix
        wsum = wsum + c
    out = acc / torch.clamp(wsum, min=1e-8)
    srcx = (col.float() + fl[:, None]) + frac
    out = out.masked_fill(~((srcx >= -0.5) & (srcx <= w - 0.5)), float(FILL))
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def shear_x(x, v):
    b, h, w, c = x.shape
    ys = torch.arange(h, dtype=torch.float32, device=x.device)
    src0 = v.float()[:, None] * (ys[None, :] + 0.5)
    rows = _planes(x).reshape(b * c * h, w)
    src = src0[:, None, :].expand(b, c, h).reshape(-1)
    return _unplanes(_cubic_rows(rows, src).reshape(b * c, h, w), x.shape)


def _shift_rows(rows, shifts):
    w = rows.shape[1]
    src = torch.arange(w, device=rows.device)[None, :] + shifts.long()[:, None]
    out = torch.gather(rows, 1, src.clamp(0, w - 1))
    return out.masked_fill((src < 0) | (src > w - 1), FILL)


def _row_pass(planes, v):
    b, c, h, w = planes.shape
    ys = torch.arange(h, dtype=torch.float32, device=planes.device) + 0.5 \
        - h / 2.0
    s = torch.floor(v[:, None] * ys[None, :] + 0.5).to(torch.int32)
    rows = planes.reshape(b * c * h, w)
    return _shift_rows(rows, s[:, None, :].expand(b, c, h).reshape(-1)
                       ).reshape(b, c, h, w)


def _column_pass(planes, v):
    return _row_pass(planes.transpose(2, 3), v).transpose(2, 3)


def rotate(x, degrees):
    theta = -(degrees.float() * float(np.float32(np.pi / 180)))
    a = torch.tan(theta / 2.0)
    s = -torch.sin(theta)
    p = x.permute(0, 3, 1, 2).contiguous()
    p = _row_pass(p, a)
    p = _column_pass(p, s).contiguous()
    p = _row_pass(p, a)
    return p.permute(0, 2, 3, 1)


_FNS = {"shearX": shear_x, "rotate": rotate, "color": color,
        "posterize": posterize, "solarize": solarize, "contrast": contrast,
        "sharpness": sharpness, "autocontrast": lambda x, _: autocontrast(x),
        "equalize": lambda x, _: equalize(x), "invert": invert}
# the ops each stage position of the 25 sub-policies can select
STAGE_OPS = tuple(tuple(sorted({s[j][0] for s in SUBPOLICIES}, key=OPS.index))
                  for j in (0, 1))


def rotate_gather(x, degrees):
    """Rotate as one NEAREST gather per output pixel: what a batch on the
    CPU takes (the card takes the three shears, within a pixel of it)."""
    b, h, w, c = x.shape
    theta = -(degrees.float() * float(np.float32(np.pi / 180)))
    cos = torch.cos(theta)[:, None, None]
    sin = torch.sin(theta)[:, None, None]
    cx, cy = w / 2.0, h / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=x.device)[:, None] \
        + 0.5 - cy
    xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, :] \
        + 0.5 - cx
    ix = torch.floor(cos * xs + sin * ys + cx - 0.5 + 0.5).long()
    iy = torch.floor(-sin * xs + cos * ys + cy - 0.5 + 0.5).long()
    inside = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
    flat = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(b, h * w, 1)
    out = torch.gather(x.reshape(b, h * w, c), 1, flat.expand(b, h * w, c))
    return out.reshape(b, h, w, c).masked_fill(~inside[..., None], FILL)


def _stage(x, op, mag, do, sign, names):
    geo = sign * mag
    enh = 1.0 + sign * mag
    fns = dict(_FNS)
    if x.device.type == "cpu":
        fns["rotate"] = rotate_gather
    sel = x
    for name in names:
        arg = enh if name in ENHANCE else (geo if name in GEOMETRIC else mag)
        sel = torch.where(_img(op) == OPS.index(name), fns[name](x, arg),
                          sel)
    return torch.where(_img(do), sel, x)


def draw(batch: int, generator: torch.Generator):
    """(ops, magnitudes, whether each stage runs, signs), each (B, 2)."""
    dev = generator.device
    pol = torch.randint(0, len(SUBPOLICIES), (batch,), generator=generator,
                        device=dev)
    u = torch.rand((batch, 2), generator=generator, device=dev)
    signs = torch.where(torch.rand((batch, 2), generator=generator,
                                   device=dev) < 0.5, 1.0, -1.0)
    ops, probs, mags = (torch.from_numpy(t).to(dev)[pol] for t in _table())
    return ops, mags, u < probs, signs


def autoaugment(x_u8: torch.Tensor, generator: torch.Generator):
    ops, mags, do, signs = draw(x_u8.shape[0], generator)
    for j in (0, 1):
        x_u8 = _stage(x_u8, ops[:, j], mags[:, j], do[:, j], signs[:, j],
                      STAGE_OPS[j])
    return x_u8


def train_transform(images_u8: torch.Tensor, size: int, augment: bool,
                    generator: torch.Generator | None) -> torch.Tensor:
    """One role of a triplet batch: resize, AutoAugment, to [0, 1]."""
    x = resize(images_u8, size)
    if augment:
        x = autoaugment(torch.clamp(torch.round(x), 0, 255).to(torch.uint8),
                        generator)
    return x.float() / 255.0
