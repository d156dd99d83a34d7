"""Image decoding and host-side resampling on numpy, ``zlib`` and
``struct`` alone.

Counterpart of the decode step of ``imageretrievalresearch_tpu/data/
decode.py`` (``Image.open(..).convert("RGB")``) and of the gallery CLI's
host helpers (``cli/gallery.py``: ``_square_pad_pil`` and
``Image.resize(.., Image.BILINEAR)``), which run on PIL. The card's
machine has no PIL, so the port decodes PNG itself and refuses JPEG:

- :func:`decode_image` — a PNG file or its bytes -> ``(H, W, 3) uint8``,
  equal to ``np.asarray(Image.open(f).convert("RGB"))``: colour types 0
  (gray at 1, 2, 4 or 8 bits, the lower depths scaled to 0-255 as PIL
  scales them), 2 (RGB), 3 (palette at 1, 2, 4 or 8 bits), 4 (gray +
  alpha) and 6 (RGBA), 8 bits apart from those. Gray is copied into the
  three channels, alpha is dropped (not composited), ``tRNS`` is ignored.
  16-bit and Adam7-interlaced PNGs, JPEG and every other format raise
  ``ValueError``, as do truncated files, chunks whose CRC disagrees and,
  as PIL's decompression bomb check refuses them, images of more than
  ``MAX_PIXELS``. The image data is inflated only as far as the header's
  size needs (data that would inflate further is refused), so no input
  allocates more than its image.
- :func:`square_pad_host` — ``_square_pad_pil``: a white square canvas
  with the image pasted at ``((side - w) // 2, (side - h) // 2)``.
- :func:`resize_bilinear_host` — Pillow's bilinear ``Image.resize``
  (``libImaging/Resample.c``) bit for bit: float64 triangle-filter
  coefficients fixed to 22 fractional bits, a horizontal then a vertical
  pass over uint8, a pass whose size is unchanged skipped.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, allowed bit depths); 16 bits is refused apart
_COLOR_TYPES = {0: (1, (1, 2, 4, 8)), 2: (3, (8,)), 3: (1, (1, 2, 4, 8)),
                4: (2, (8,)), 6: (4, (8,))}
# PIL's scaling of gray samples below 8 bits ("1", "L;2", "L;4")
_GRAY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}
# Resample.c's fixed point: coefficients carry 22 fractional bits
_PRECISION_BITS = 22
# PIL's decompression bomb limit: Image.open refuses more than twice
# Image.MAX_IMAGE_PIXELS (1024 ** 3 // 4 // 3) pixels
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def _format_error(data: bytes) -> ValueError:
    if data[:3] == b"\xff\xd8\xff":
        return ValueError("JPEG input: the port has no JPEG decoder yet "
                          "(ROADMAP); only PNG is decoded")
    return ValueError("not a PNG file; only PNG is decoded by the port")


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature, CRC checked,
    through IEND."""
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG: chunk {ctype!r} runs past the "
                             "end of the file")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"corrupt PNG: CRC mismatch in chunk {ctype!r}")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end + 4


def _unfilter(raw: bytes, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth) -> (h,
    rowbytes) uint8.

    Byte x of row y depends on x - bpp of its row, and on x and x - bpp of
    the row above. So all positions on one anti-diagonal of the (h, units)
    grid of bpp-byte units are independent of each other: the loop walks
    the h + units - 1 diagonals in order and computes each as one vector
    over its rows, each row with its own filter. In a zero-padded
    (h + 1, units + 1) layout a diagonal is a strided slice, and so are
    its left, upper and upper-left neighbours."""
    stride = rowbytes + 1
    if len(raw) < h * stride:
        raise ValueError("truncated PNG: image data ends early")
    rows = np.frombuffer(raw, np.uint8, h * stride).reshape(h, stride)
    ftype = rows[:, 0]
    if int(ftype.max()) > 4:
        raise ValueError(f"corrupt PNG: filter type {int(ftype.max())}")
    units = rowbytes // bpp
    pad = np.zeros((h + 1, units + 1, bpp), np.uint8)
    filt = pad.copy()
    filt[1:, 1:] = rows[:, 1:].reshape(h, units, bpp)
    rec, fil = pad.reshape(-1, bpp), filt.reshape(-1, bpp)
    ftype = ftype.astype(np.intp)
    for e in range(h + units - 1):
        y0, y1 = max(0, e - units + 1), min(h - 1, e)
        # flat index of padded (y0 + 1, e - y0 + 1); one row down is one
        # unit left on the diagonal: a step of units
        start = (y0 + 1) * (units + 1) + e - y0 + 1
        stop = start + (y1 - y0) * units + 1
        a = rec[start - 1:stop - 1:units].astype(np.int16)
        b = rec[start - units - 1:stop - units - 1:units].astype(np.int16)
        c = rec[start - units - 2:stop - units - 2:units].astype(np.int16)
        bc, ac = b - c, a - c                  # p - a, p - b for p = a+b-c
        pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.choose(ftype[y0:y1 + 1, None],
                         (np.zeros_like(a), a, b, (a + b) >> 1, paeth))
        rec[start:stop:units] = fil[start:stop:units] + pred.astype(np.uint8)
    return pad[1:, 1:].reshape(h, rowbytes)


def _samples(rows: np.ndarray, width: int, depth: int,
             channels: int) -> np.ndarray:
    """(h, rowbytes) -> (h, width, channels) samples; below 8 bits the
    rows are packed most significant bit first, padded to whole bytes."""
    if depth == 8:
        return rows.reshape(rows.shape[0], width, channels)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :width, None].astype(np.uint8)


def decode_image(src: str | Path | bytes | bytearray | memoryview
                 ) -> np.ndarray:
    """A PNG file (path) or its bytes -> ``(H, W, 3) uint8`` RGB, as
    ``Image.open(..).convert("RGB")`` gives it. Raises ``ValueError`` for
    JPEG and other formats, 16-bit and interlaced PNGs, and truncated or
    corrupt files."""
    data = (bytes(src) if isinstance(src, (bytes, bytearray, memoryview))
            else Path(src).read_bytes())
    if not data.startswith(PNG_SIGNATURE):
        raise _format_error(data)
    header, palette, idat = None, None, []
    for ctype, payload in _chunks(data):
        if ctype == b"IHDR":
            if len(payload) != 13:
                raise ValueError("corrupt PNG: IHDR is not 13 bytes")
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise ValueError("corrupt PNG: no IHDR or no IDAT chunk")
    width, height, depth, ctype, compression, filt, interlace = header
    if ctype not in _COLOR_TYPES:
        raise ValueError(f"corrupt PNG: colour type {ctype}")
    channels, depths = _COLOR_TYPES[ctype]
    if depth == 16:
        raise ValueError("16-bit PNG is not supported (8 bits and, for gray "
                         "and palette images, 1, 2 or 4)")
    if depth not in depths:
        raise ValueError(f"corrupt PNG: bit depth {depth} with colour type "
                         f"{ctype}")
    if interlace:
        raise ValueError("Adam7-interlaced PNG is not supported")
    if compression or filt or not width or not height:
        raise ValueError("corrupt PNG: bad IHDR")
    if ctype == 3 and palette is None:
        raise ValueError("corrupt PNG: palette image without PLTE")
    if width * height > MAX_PIXELS:
        raise ValueError(f"image size ({width * height} pixels) exceeds the "
                         f"limit of {MAX_PIXELS} pixels (decompression bomb)")
    rowbytes = (width * channels * depth + 7) // 8
    need = height * (rowbytes + 1)
    try:
        # inflate at most the bytes the image needs, and one more to see
        # whether the stream holds more than that
        inflate = zlib.decompressobj()
        raw = inflate.decompress(b"".join(idat), need)
        extra = inflate.decompress(inflate.unconsumed_tail, 1)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG: image data does not inflate ({e})")
    if extra:
        raise ValueError("corrupt PNG: image data inflates past the "
                         f"{need} bytes of a {width} x {height} image")
    rows = _unfilter(raw, height, rowbytes, max(1, channels * depth // 8))
    px = _samples(rows, width, depth, channels)
    if ctype == 3:
        # indices past the palette's end read black
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    if ctype in (0, 4):
        gray = px[..., 0] * np.uint8(_GRAY_SCALE[depth])
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def square_pad_host(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (S, S, 3), S = max(H, W): the image on a white
    canvas at ((S - W) // 2, (S - H) // 2), as ``_square_pad_pil``."""
    h, w = img.shape[:2]
    side = max(h, w)
    out = np.full((side, side, img.shape[2]), 255, np.uint8)
    top, left = (side - h) // 2, (side - w) // 2
    out[top:top + h, left:left + w] = img
    return out


@functools.lru_cache(maxsize=64)
def _bilinear_coeffs(in_size: int, out_size: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Resample.c ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bilinear filter: per output position the source indices (out, ksize)
    and their fixed-point weights (zero past the position's taps)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    index = np.zeros((out_size, ksize), np.intp)
    fixed = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            ws.append(1.0 - t if t < 1.0 else 0.0)
        total = 0.0
        for w in ws:          # C's left-to-right sum
            total += w
        for x, w in enumerate(ws):
            k = w / total if total != 0.0 else w
            fixed[xx, x] = int((0.5 if k >= 0 else -0.5)
                               + k * (1 << _PRECISION_BITS))
        index[xx] = np.minimum(xmin + np.arange(ksize), in_size - 1)
    return index, fixed


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass along ``axis`` (1: horizontal, 0: vertical): sums
    from 1 << 21, shifted right by 22, clamped to [0, 255]."""
    index, fixed = _bilinear_coeffs(img.shape[axis], out_size)
    shape = [1, 1, 1]
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    for t in range(index.shape[1]):
        acc += (np.take(img, index[:, t], axis=axis).astype(np.int32)
                * fixed[:, t].reshape(shape))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear_host(img: np.ndarray, size: tuple[int, int]
                         ) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8 for ``size = (h, w)``: Pillow's
    ``Image.resize((w, h), Image.BILINEAR)``. The horizontal pass runs
    first, the vertical pass over its uint8 result; a resize to the same
    size is a copy."""
    h, w = int(size[0]), int(size[1])
    out = img
    if w != img.shape[1]:
        out = _resample_axis(out, w, axis=1)
    if h != img.shape[0]:
        out = _resample_axis(out, h, axis=0)
    return out.copy() if out is img else out
