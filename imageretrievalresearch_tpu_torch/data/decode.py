"""Image decoding and host-side resampling on numpy, ``zlib`` and
``struct`` alone, and the datasets' shared decode cache.

Counterpart of ``imageretrievalresearch_tpu/data/decode.py`` (its decode
step, ``Image.open(..).convert("RGB")``, and its two mixins) and of the
gallery CLI's host helpers (``cli/gallery.py``: ``_square_pad_pil`` and
``Image.resize(.., Image.BILINEAR)``), which run on PIL. The port does not
depend on PIL, so it decodes PNG and JPEG itself:

- :func:`decode_image` — a PNG or JPEG file or its bytes -> ``(H, W, 3)
  uint8``, equal to ``np.asarray(Image.open(f).convert("RGB"))``. JPEG
  (signature ``FF D8 FF``) goes to ``data.jpeg.decode_jpeg``: baseline
  sequential 8-bit, gray or YCbCr / RGB. PNG: colour types 0
  (gray at 1, 2, 4 or 8 bits, the lower depths scaled to 0-255 as PIL
  scales them), 2 (RGB), 3 (palette at 1, 2, 4 or 8 bits), 4 (gray +
  alpha) and 6 (RGBA), 8 bits apart from those. Gray is copied into the
  three channels, alpha is dropped (not composited), ``tRNS`` is ignored.
  Adam7-interlaced PNGs are de-interlaced pass by pass. 16-bit PNGs,
  progressive, lossless, arithmetic-
  coded, 12-bit and CMYK JPEGs and every other format raise
  ``ValueError``, as do truncated files, chunks whose CRC disagrees and,
  as PIL's decompression bomb check refuses them, images of more than
  ``MAX_PIXELS``. PNG image data is inflated only as far as the header's
  size needs (data that would inflate further is refused), so no input
  allocates more than its image.
- :func:`encode_png` — ``(H, W, 3) uint8`` -> an RGB PNG (filter None on
  every row), which decodes to the same array.
- :func:`square_pad_host` — ``_square_pad_pil``: a white square canvas
  with the image pasted at ``((side - w) // 2, (side - h) // 2)``.
- :func:`resize_bilinear_host` — Pillow's bilinear ``Image.resize``
  (``libImaging/Resample.c``) bit for bit: float64 triangle-filter
  coefficients fixed to 22 fractional bits, a horizontal then a vertical
  pass over uint8, a pass whose size is unchanged skipped.
- :class:`DecodeCacheMixin` and :class:`TripletImageMixin` — the
  datasets' decode-once RAM cache (optionally at a host size) and the
  image-level triplet wrapper shared by the sketchy, original and soft
  families.

The decoders run in Python and numpy: zlib and numpy's array operations
release the GIL, the JPEG Huffman walk and the PNG filter loop's Python
steps hold it (PIL releases it for a whole decode), so the loader's
threads overlap decodes only in part.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib
from pathlib import Path

import numpy as np

from imageretrievalresearch_tpu_torch.data.jpeg import decode_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, allowed bit depths); 16 bits is refused apart
_COLOR_TYPES = {0: (1, (1, 2, 4, 8)), 2: (3, (8,)), 3: (1, (1, 2, 4, 8)),
                4: (2, (8,)), 6: (4, (8,))}
# Adam7's seven passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
# PIL's scaling of gray samples below 8 bits ("1", "L;2", "L;4")
_GRAY_SCALE = {1: 255, 2: 85, 4: 17, 8: 1}
# Resample.c's fixed point: coefficients carry 22 fractional bits
_PRECISION_BITS = 22
# PIL's decompression bomb limit: Image.open refuses more than twice
# Image.MAX_IMAGE_PIXELS (1024 ** 3 // 4 // 3) pixels
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


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
    """A PNG or JPEG file (path) or its bytes -> ``(H, W, 3) uint8`` RGB,
    as ``Image.open(..).convert("RGB")`` gives it. Raises ``ValueError``
    for other formats, 16-bit PNGs, JPEGs other than
    baseline 8-bit gray or colour, and truncated or corrupt files."""
    data = (bytes(src) if isinstance(src, (bytes, bytearray, memoryview))
            else Path(src).read_bytes())
    if data[:3] == b"\xff\xd8\xff":
        return decode_jpeg(data, MAX_PIXELS)
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG or JPEG file; the port decodes PNG and "
                         "baseline JPEG")
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
    if compression or filt or interlace > 1 or not width or not height:
        raise ValueError("corrupt PNG: bad IHDR")
    if ctype == 3 and palette is None:
        raise ValueError("corrupt PNG: palette image without PLTE")
    if width * height > MAX_PIXELS:
        raise ValueError(f"image size ({width * height} pixels) exceeds the "
                         f"limit of {MAX_PIXELS} pixels (decompression bomb)")
    # (row step, column step, first row, first column, rows, columns) of
    # each non-empty pass; one pass of the whole image when not interlaced
    passes = [(ys, xs, y0, x0, -(-(height - y0) // ys),
               -(-(width - x0) // xs))
              for y0, x0, ys, xs in (_ADAM7 if interlace else
                                     ((0, 0, 1, 1),))
              if y0 < height and x0 < width]
    rowbytes = [(p[5] * channels * depth + 7) // 8 for p in passes]
    need = sum(p[4] * (rb + 1) for p, rb in zip(passes, rowbytes))
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
    bpp = max(1, channels * depth // 8)
    px = np.empty((height, width, channels), np.uint8)
    off = 0
    for (ys, xs, y0, x0, ph, pw), rb in zip(passes, rowbytes):
        # each pass is a small image of its own, filtered row by row
        rows = _unfilter(raw[off:off + ph * (rb + 1)], ph, rb, bpp)
        px[y0::ys, x0::xs] = _samples(rows, pw, depth, channels)
        off += ph * (rb + 1)
    if ctype == 3:
        # indices past the palette's end read black
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    if ctype in (0, 4):
        gray = px[..., 0] * np.uint8(_GRAY_SCALE[depth])
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG, every row unfiltered."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


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


class DecodeCacheMixin:
    """Mixin for datasets exposing ``image_lst`` / ``sketch_lst`` path
    lists. Call :meth:`_init_decode_cache` from ``__init__``; use
    :meth:`_decode` in ``__getitem__``."""

    def _init_decode_cache(self, load_images: bool,
                           cache_size: int | None,
                           cache_store: dict | None = None) -> None:
        """``cache_store``: an externally shared path -> array dict. Pass
        the SAME dict to sibling datasets over the same tree (the train
        CLI's train / val TripleDataset pair, whose sketch universe is
        the whole tree whatever the split) so each image is decoded and
        held once per process. Share only between datasets with the same
        ``cache_size``."""
        self.load_images = load_images
        self.cache_size = cache_size
        self._cache: dict[str, np.ndarray] = (
            cache_store if cache_store is not None else {})
        if load_images:
            for p in set(self.sketch_lst) | set(self.image_lst):
                if p not in self._cache:
                    self._cache[p] = self._decode(p)

    def _decode(self, path: str) -> np.ndarray:
        if path in self._cache:
            return self._cache[path]
        img = decode_image(path)
        cs = self.cache_size
        if cs is not None and img.shape[:2] != (cs, cs):
            img = resize_bilinear_host(img, (cs, cs))
        return img


class TripletImageMixin(DecodeCacheMixin):
    """Image-level wrapper over a path-level triplet dataset: decodes
    sampled triplets, optionally applies a per-image ``transform_dic``,
    and seeds a default rng (the loader passes a deterministic
    per-(epoch, idx) one instead)."""

    def __init__(self, transform_dic: dict | None = None,
                 pos_return_num: int = 1, neg_return_num: int = 1,
                 load_images: bool = False, cache_size: int | None = None,
                 seed: int = 0, **kwargs):
        if not kwargs.get("random", True):
            # fail at construction: the materialized-json (random=False)
            # image mode is path-level only, and the eager decode cache
            # would otherwise run before __getitem__'s index check fired
            raise ValueError(
                f"{type(self).__name__} requires random=True indexing; the "
                "materialized data_json mode is path-level only")
        super().__init__(**kwargs)
        self.transform_dic = transform_dic
        self.pos_return_num = pos_return_num
        self.neg_return_num = neg_return_num
        self._rng = np.random.default_rng(seed)
        self._init_decode_cache(load_images, cache_size)
        if transform_dic:
            self.qry_trans = transform_dic["qry"]
            self.pos_trans = transform_dic["pos"]
            self.neg_trans = transform_dic["neg"]

    def __getitem__(self, idx: int,
                    rng: np.random.Generator | None = None) -> dict:
        assert self.index is not None
        rng = rng or self._rng
        s = self.index.sample(idx, rng, self.pos_return_num,
                              self.neg_return_num)
        qry = self._decode(s["qry"])
        pos = [self._decode(p) for p in s["pos"]]
        neg = [self._decode(p) for p in s["neg"]]
        if self.transform_dic:
            qry = self.qry_trans(qry)
            pos = [self.pos_trans(i) for i in pos]
            neg = [self.neg_trans(i) for i in neg]
        return {"qry": qry, "pos": pos, "neg": neg,
                "cat_idx": s["cat_idx"], "prod_idx": s["prod_idx"],
                "paths": {"qry": s["qry"], "pos": s["pos"], "neg": s["neg"]}}
