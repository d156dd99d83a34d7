"""Baseline JPEG decoding and encoding on numpy alone, bit for bit
libjpeg-turbo's integer paths.

The JAX package reads and writes JPEG through PIL (``data/decode.py``,
``data/loader.py``, ``data/synthetic.py``), which runs libjpeg-turbo. The
port does not depend on PIL, so it carries its own codec:

- :func:`decode_jpeg` — baseline sequential 8-bit JPEG (SOF0 / SOF1,
  Huffman-coded, interleaved or not, with or without restart intervals)
  -> ``(H, W, 3) uint8``, equal to ``np.asarray(Image.open(f).convert(
  "RGB"))``: table-driven Huffman decoding (a 16-bit peek into a 32-bit
  window per byte position looks up the code and, where they fit in the
  peek, its value bits too), the islow integer IDCT of ``jidctint.c`` on
  every block of a component at once, ``jdsample.c``'s fancy (triangle)
  upsampling for h2v1, h1v2 and h2v2 (box replication where libjpeg uses
  it: a component at most 2 samples wide, other integer factors) and
  ``jdcolor.c``'s integer YCbCr -> RGB tables. A one-component image is
  gray, copied into the three channels. Progressive, lossless,
  hierarchical and arithmetic-coded files, 12-bit samples, 2- and
  4-component (CMYK / YCCK) images and DNL markers raise ``ValueError``,
  as do truncated and corrupt files.
- :func:`encode_jpeg` — ``(H, W, 3) uint8`` -> baseline JFIF bytes at
  PIL's ``save(.., "JPEG")`` defaults: quality 75 (libjpeg's scaled
  standard tables), 4:2:0, the standard Huffman tables, no restarts.
  It follows libjpeg-turbo's integer encoder (``jccolor.c`` RGB -> YCbCr,
  ``jcsample.c``'s h2v2 box average with its alternating bias, the edge
  replication of ``jcprepct.c``, the islow forward DCT of ``jfdctint.c``
  and ``jcdctmgr.c``'s reciprocal quantization), so a decoder reads the
  same coefficients from it as from PIL's file of the same pixels.

The Huffman walk is a Python loop over the symbols, holding the GIL; the
rest is vectorised numpy.
"""

from __future__ import annotations

import array
import functools
import struct

import numpy as np

# zigzag position -> natural (row-major) position, plus 16 entries that
# catch a run past the block's end in corrupt data (libjpeg's
# jpeg_natural_order does the same)
ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
_ZZ_SAFE = ZIGZAG + (63,) * 16

# JPEG Annex K: the luminance and chrominance quantization tables
# (natural order) and the standard Huffman tables (code counts per length
# 1-16, then the symbols)
STD_QUANT = (
    (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99),
    (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99)
    + (99,) * 32)
_AC_LUMA_VALS = bytes.fromhex(
    "01 02 03 00 04 11 05 12 21 31 41 06 13 51 61 07 22 71 14 32 81 91 a1"
    " 08 23 42 b1 c1 15 52 d1 f0 24 33 62 72 82 09 0a 16 17 18 19 1a 25 26"
    " 27 28 29 2a 34 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 54 55 56"
    " 57 58 59 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 7a 83 84 85"
    " 86 87 88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 a6 a7 a8 a9 aa"
    " b2 b3 b4 b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4 d5 d6"
    " d7 d8 d9 da e1 e2 e3 e4 e5 e6 e7 e8 e9 ea f1 f2 f3 f4 f5 f6 f7 f8 f9"
    " fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "00 01 02 03 11 04 05 21 31 06 12 41 51 07 61 71 13 22 32 81 08 14 42"
    " 91 a1 b1 c1 09 23 33 52 f0 15 62 72 d1 0a 16 24 34 e1 25 f1 17 18 19"
    " 1a 26 27 28 29 2a 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 54 55"
    " 56 57 58 59 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 7a 82 83"
    " 84 85 86 87 88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 a6 a7 a8"
    " a9 aa b2 b3 b4 b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 ca d2 d3 d4"
    " d5 d6 d7 d8 d9 da e2 e3 e4 e5 e6 e7 e8 e9 ea f2 f3 f4 f5 f6 f7 f8 f9"
    " fa")
STD_HUFFMAN = {
    # (class, id): (counts per code length, symbols); class 0 DC, 1 AC
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d),
             _AC_LUMA_VALS),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
             _AC_CHROMA_VALS),
}

# jidctint.c / jfdctint.c fixed point: 13 fractional bits, PASS1_BITS 2
_CONST_BITS, _PASS1_BITS = 13, 2
_F = {name: int(v * (1 << _CONST_BITS) + 0.5) for name, v in (
    ("0_298631336", 0.298631336), ("0_390180644", 0.390180644),
    ("0_541196100", 0.541196100), ("0_765366865", 0.765366865),
    ("0_899976223", 0.899976223), ("1_175875602", 1.175875602),
    ("1_501321110", 1.501321110), ("1_847759065", 1.847759065),
    ("1_961570560", 1.961570560), ("2_053119869", 2.053119869),
    ("2_562915447", 2.562915447), ("3_072711026", 3.072711026))}

# jdcolor.c / jccolor.c: 16 fractional bits
_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix16(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


# markers: SOF0/SOF1 are decoded; every other SOF is refused by name
_SOF_REFUSED = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical",
                0xC6: "hierarchical progressive",
                0xC7: "hierarchical lossless", 0xC9: "arithmetic-coded",
                0xCA: "arithmetic-coded progressive",
                0xCB: "arithmetic-coded lossless",
                0xCD: "arithmetic-coded hierarchical",
                0xCE: "arithmetic-coded hierarchical progressive",
                0xCF: "arithmetic-coded hierarchical lossless"}


def _truncated(what: str) -> ValueError:
    return ValueError(f"truncated JPEG: {what}")


def _huffman_codes(counts, symbols) -> list[tuple[int, int, int]]:
    """Canonical (code, length, symbol) triples of a table spec."""
    out, code, k = [], 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            if k >= len(symbols):
                raise ValueError("corrupt JPEG: Huffman table lists more "
                                 "codes than symbols")
            out.append((code, length, symbols[k]))
            code += 1
            k += 1
        if code > (1 << length):
            raise ValueError("corrupt JPEG: Huffman code lengths "
                             "oversubscribed")
        code <<= 1
    return out


# what a lookup entry holds: the bits it consumes above bit 24, its kind
# at bits 20-21, the run (AC) at bits 16-19, and below them either the
# decoded value + 32768 (_VALUE) or the size of the value still to read
# (_READ); _NONE: a symbol without a value (DC 0, AC EOB or ZRL)
_NONE, _VALUE, _READ = 0, 1, 2


@functools.lru_cache(maxsize=64)
def _lookup(counts: tuple, symbols: bytes) -> list[int]:
    """65,536 entries, one per 16-bit peek, for the code the peek starts
    with (0 where none does). Where the code and its value bits both fit
    in the peek, the entry carries the decoded value: one lookup per
    coefficient on the common path."""
    length = np.zeros(1 << 16, np.int64)
    sym = np.zeros(1 << 16, np.int64)
    for code, ln, sy in _huffman_codes(counts, symbols):
        lo = code << (16 - ln)
        length[lo:lo + (1 << (16 - ln))] = ln
        sym[lo:lo + (1 << (16 - ln))] = sy
    peek = np.arange(1 << 16, dtype=np.int64)
    size, run = sym & 15, sym >> 4
    fits = (size > 0) & (length + size <= 16)
    raw = (peek >> np.maximum(16 - length - size, 0)) & ((1 << size) - 1)
    value = np.where(raw < (1 << np.maximum(size - 1, 0)),
                     raw - ((1 << size) - 1), raw)
    kind = np.where(size == 0, _NONE, np.where(fits, _VALUE, _READ))
    consumed = np.where(fits, length + size, length)
    low = np.where(fits, value + 32768, size)
    table = (consumed << 24) | (kind << 20) | (run << 16) | low
    return np.where(length > 0, table, 0).tolist()


# --------------------------------------------------------------- decoding

def _windows(seg: bytes) -> list[int]:
    """The 32-bit big-endian word at every byte of ``seg`` (zero-padded),
    so any 16 bits at bit p are ``w[p >> 3] >> (16 - (p & 7))``."""
    a = np.frombuffer(seg + bytes(260), np.uint8).astype(np.int64)
    return ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8)
            | a[3:]).tolist()


def _entropy_segments(data: bytes, pos: int) -> tuple[list[bytes], int]:
    """The scan's entropy-coded data from ``pos``, split at RSTn markers
    and unstuffed; and the position of the marker that ends the scan."""
    segments, start, cur = [], pos, pos
    while True:
        j = data.find(b"\xff", cur)
        if j < 0 or j + 1 >= len(data):
            raise _truncated("the scan runs past the end of the file")
        nxt = data[j + 1]
        if nxt == 0x00:
            cur = j + 2
        elif nxt == 0xFF:          # fill byte
            cur = j + 1
        elif 0xD0 <= nxt <= 0xD7:
            segments.append(data[start:j].replace(b"\xff\x00", b"\xff"))
            start = cur = j + 2
        else:
            segments.append(data[start:j].replace(b"\xff\x00", b"\xff"))
            return segments, j


def _decode_blocks(segments: list[bytes], plan: list, blocks_per_seg: int,
                   coef: array.array, n_comps: int) -> None:
    """Huffman-decode the scan into ``coef`` (natural order, flat).
    ``plan`` holds one (component, coefficient base, DC table, AC table)
    per block in scan order; the DC predictions restart per segment."""
    nb = len(plan)
    n_segs = -(-nb // blocks_per_seg) if nb else 0
    if len(segments) < n_segs:
        raise _truncated(f"{len(segments)} restart segments, the scan "
                         f"needs {n_segs}")
    zz = _ZZ_SAFE
    for si in range(n_segs):
        seg = segments[si]
        w = _windows(seg)
        nbits = 8 * len(seg)
        p = 0
        pred = [0] * n_comps
        for ci, base, dct, act in plan[si * blocks_per_seg:
                                       (si + 1) * blocks_per_seg]:
            e = dct[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if not e:
                raise ValueError("corrupt JPEG: bad Huffman code")
            p += e >> 24
            kind = (e >> 20) & 3
            if kind == _VALUE:
                pred[ci] += (e & 0xFFFF) - 32768
            elif kind == _READ:
                s = e & 0xFFFF
                v = (w[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                pred[ci] += v
            coef[base] = pred[ci]
            k = 1
            while k < 64:
                e = act[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not e:
                    raise ValueError("corrupt JPEG: bad Huffman code")
                p += e >> 24
                kind = (e >> 20) & 3
                if kind == _VALUE:
                    k += (e >> 16) & 15
                    coef[base + zz[k]] = (e & 0xFFFF) - 32768
                    k += 1
                elif kind == _READ:
                    k += (e >> 16) & 15
                    s = e & 0xFFFF
                    v = (w[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    coef[base + zz[k]] = v
                    k += 1
                elif (e >> 16) & 15 == 15:
                    k += 16
                else:
                    break
            if p > nbits:
                raise _truncated("the entropy-coded data ends inside a "
                                 "block")


def _idct_1d(d: list, shift: int) -> list:
    """jidctint.c's 1-D islow pass on 8 arrays of one axis, descaled by
    ``shift`` bits with rounding."""
    f = _F
    z1 = (d[2] + d[6]) * f["0_541196100"]
    tmp2 = z1 - d[6] * f["1_847759065"]
    tmp3 = z1 + d[2] * f["0_765366865"]
    tmp0 = (d[0] + d[4]) << _CONST_BITS
    tmp1 = (d[0] - d[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1_175875602"]
    t0 = t0 * f["0_298631336"]
    t1 = t1 * f["2_053119869"]
    t2 = t2 * f["3_072711026"]
    t3 = t3 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    out = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
    r = 1 << (shift - 1)
    return [(o + r) >> shift for o in out]


def idct_islow(blocks: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(n, 8, 8) coefficients (natural order) and their (8, 8)
    quantization table -> (n, 8, 8) uint8 samples: columns, then rows,
    then the clamp to [-128, 127] and the level shift."""
    x = blocks.astype(np.int64) * quant.astype(np.int64).reshape(1, 8, 8)
    cols = _idct_1d([x[:, r, :] for r in range(8)],
                    _CONST_BITS - _PASS1_BITS)
    ws = np.stack(cols, axis=1)
    rows = _idct_1d([ws[:, :, c] for c in range(8)],
                    _CONST_BITS + _PASS1_BITS + 3)
    out = np.stack(rows, axis=2)
    return (np.clip(out, -128, 127) + 128).astype(np.uint8)


def _edge(a: np.ndarray, axis: int) -> np.ndarray:
    """``a`` with one edge-replicated sample added at both ends of
    ``axis``."""
    pad = [(0, 0)] * a.ndim
    pad[axis] = (1, 1)
    return np.pad(a, pad, mode="edge")


def _fancy_h(x: np.ndarray, near: int, far: int, r_even: int,
             r_odd: int, shift: int) -> np.ndarray:
    """Horizontal triangle filter: output 2j from (near x[j] + far
    x[j-1] + r_even) >> shift, output 2j+1 from x[j], x[j+1] and r_odd."""
    e = _edge(x, 1)
    c = e[:, 1:-1] * near
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int64)
    out[:, 0::2] = (c + e[:, :-2] * far + r_even) >> shift
    out[:, 1::2] = (c + e[:, 2:] * far + r_odd) >> shift
    return out


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """One component's samples (its real size, uint8) upsampled by (fh,
    fv) as jdsample.c does with do_fancy_upsampling on."""
    x = plane.astype(np.int64)
    w = x.shape[1]
    if (fh, fv) == (2, 1) and w > 2:            # h2v1_fancy_upsample
        return _fancy_h(x, 3, 1, 1, 2, 2)
    if (fh, fv) == (1, 2):                      # h1v2_fancy_upsample
        e = _edge(x, 0)
        out = np.empty((2 * x.shape[0], w), np.int64)
        out[0::2] = (3 * x + e[:-2] + 1) >> 2
        out[1::2] = (3 * x + e[2:] + 2) >> 2
        return out
    if (fh, fv) == (2, 2) and w > 2:            # h2v2_fancy_upsample
        e = _edge(x, 0)
        out = np.empty((2 * x.shape[0], 2 * w), np.int64)
        for v, nb in ((0, e[:-2]), (1, e[2:])):
            colsum = 3 * x + nb
            out[v::2] = _fancy_h(colsum, 3, 1, 8, 7, 4)
        return out
    # h2v1 / h2v2 at most 2 samples wide and the other integer factors:
    # box replication (h2v1_upsample, h2v2_upsample, int_upsample)
    return np.repeat(np.repeat(x, fv, axis=0), fh, axis=1)


@functools.lru_cache(maxsize=1)
def _ycc_tables() -> tuple[np.ndarray, ...]:
    """jdcolor.c build_ycc_rgb_table: Cr->R, Cb->B, and the scaled Cr->G
    and Cb->G terms (the latter with the rounding half)."""
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_fix16(1.40200) * x + _ONE_HALF) >> _SCALEBITS
    cb_b = (_fix16(1.77200) * x + _ONE_HALF) >> _SCALEBITS
    cr_g = -_fix16(0.71414) * x
    cb_g = -_fix16(0.34414) * x + _ONE_HALF
    return cr_r, cb_b, cr_g, cb_g


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray
                ) -> np.ndarray:
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    y = y.astype(np.int64)
    cb = cb.astype(np.intp)
    cr = cr.astype(np.intp)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> _SCALEBITS)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


class _Frame:
    """SOF: size and components (id, h, v, quant table id), and the
    coefficient grid each component's blocks fill."""

    def __init__(self, seg: bytes, max_pixels: int):
        if len(seg) < 6:
            raise ValueError("corrupt JPEG: short SOF segment")
        precision, self.height, self.width, n = struct.unpack(">BHHB",
                                                              seg[:6])
        if precision != 8:
            raise ValueError(f"{precision}-bit JPEG is not supported "
                             "(8-bit baseline only)")
        if self.height == 0:
            raise ValueError("JPEG with a DNL-defined height is not "
                             "supported")
        if self.width == 0:
            raise ValueError("corrupt JPEG: zero width")
        if n in (2, 4):
            raise ValueError(f"{n}-component JPEG (CMYK / YCCK) is not "
                             "supported" if n == 4 else
                             "2-component JPEG is not supported")
        if n not in (1, 3) or len(seg) < 6 + 3 * n:
            raise ValueError(f"corrupt JPEG: {n} components")
        if self.width * self.height > max_pixels:
            raise ValueError(
                f"image size ({self.width * self.height} pixels) exceeds "
                f"the limit of {max_pixels} pixels (decompression bomb)")
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for i in range(n):
            cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                raise ValueError("corrupt JPEG: bad sampling factors or "
                                 "table id")
            self.ids.append(cid)
            self.h.append(h)
            self.v.append(v)
            self.tq.append(tq)
        self.hmax, self.vmax = max(self.h), max(self.v)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        # each component's real size, and its block grid (the interleaved
        # scan's MCUs pad it; a one-component frame has no padding)
        self.cw = [-(-self.width * h // self.hmax) for h in self.h]
        self.ch = [-(-self.height * v // self.vmax) for v in self.v]
        if n == 1:
            self.gw = [-(-self.cw[0] // 8)]
            self.gh = [-(-self.ch[0] // 8)]
        else:
            self.gw = [self.mcux * h for h in self.h]
            self.gh = [self.mcuy * v for v in self.v]
        self.offset = list(np.cumsum([0] + [gw * gh for gw, gh in
                                            zip(self.gw, self.gh)]))
        # int32 coefficients the Huffman walk stores into one by one
        self.coef = array.array("i", bytes(4 * int(self.offset[-1]) * 64))


def _scan_plan(frame: _Frame, seg: bytes, dc: dict, ac: dict) -> list:
    """SOS -> (component, coefficient base, DC table, AC table) per block
    in scan order."""
    if not seg:
        raise ValueError("corrupt JPEG: empty SOS segment")
    ns = seg[0]
    if ns < 1 or len(seg) < 1 + 2 * ns + 3:
        raise ValueError("corrupt JPEG: bad SOS segment")
    comps = []
    for i in range(ns):
        cid, tables = seg[1 + 2 * i:3 + 2 * i]
        if cid not in frame.ids:
            raise ValueError(f"corrupt JPEG: scan names component {cid}")
        ci = frame.ids.index(cid)
        td, ta = tables >> 4, tables & 15
        if td not in dc or ta not in ac:
            raise ValueError("corrupt JPEG: scan uses an undefined Huffman "
                             "table")
        comps.append((ci, dc[td], ac[ta]))
    ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
    if (ss, se, ahal) != (0, 63, 0):
        raise ValueError("corrupt JPEG: a baseline scan must code "
                         "coefficients 0-63 in one pass")
    plan = []
    if ns == 1:
        # non-interleaved: the component's own blocks in raster order
        ci, dct, act = comps[0]
        bw, bh = -(-frame.cw[ci] // 8), -(-frame.ch[ci] // 8)
        base = frame.offset[ci]
        for by in range(bh):
            for bx in range(bw):
                plan.append((ci, int(base + by * frame.gw[ci] + bx) * 64,
                             dct, act))
        return plan
    if ns > 4 or sum(frame.h[c] * frame.v[c] for c, _, _ in comps) > 10:
        raise ValueError("corrupt JPEG: too many blocks per MCU")
    mcu = []                    # (component, block row, column) per MCU
    for ci, dct, act in comps:
        for v in range(frame.v[ci]):
            for h in range(frame.h[ci]):
                mcu.append((ci, v, h, dct, act))
    for my in range(frame.mcuy):
        for mx in range(frame.mcux):
            for ci, v, h, dct, act in mcu:
                row = my * frame.v[ci] + v
                col = mx * frame.h[ci] + h
                plan.append((ci, int(frame.offset[ci] + row * frame.gw[ci]
                                     + col) * 64, dct, act))
    return plan


def _color_space(frame: _Frame, jfif: bool, adobe: int | None) -> str:
    """jdapimin.c default_decompress_parms for 3 components."""
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    return "rgb" if frame.ids == [82, 71, 66] else "ycc"


def decode_jpeg(data: bytes, max_pixels: int) -> np.ndarray:
    """Baseline JPEG bytes -> ``(H, W, 3) uint8`` RGB, as
    ``Image.open(..).convert("RGB")`` gives it (see the module doc)."""
    if data[:3] != b"\xff\xd8\xff":
        raise ValueError("not a JPEG file")
    pos = 2
    quant: dict[int, np.ndarray] = {}
    dc: dict[int, list] = {}
    ac: dict[int, list] = {}
    frame = None
    restart = 0
    jfif, adobe = False, None
    scans = 0
    while True:
        if pos >= len(data):
            raise _truncated("no EOI marker")
        if data[pos] != 0xFF:
            raise ValueError("corrupt JPEG: expected a marker")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise _truncated("no EOI marker")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > len(data):
            raise _truncated("a segment runs past the end of the file")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        if length < 2:
            raise ValueError("corrupt JPEG: bad segment length")
        if pos + length > len(data):
            raise _truncated("a segment runs past the end of the file")
        seg = data[pos + 2:pos + length]
        pos += length
        if marker in _SOF_REFUSED:
            raise ValueError(f"{_SOF_REFUSED[marker]} JPEG is not "
                             "supported (baseline sequential only)")
        if marker in (0xC0, 0xC1):
            if frame is not None:
                raise ValueError("corrupt JPEG: two frames")
            frame = _Frame(seg, max_pixels)
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                if i + 17 > len(seg):
                    raise ValueError("corrupt JPEG: short DHT segment")
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = tuple(seg[i + 1:i + 17])
                n = sum(counts)
                symbols = bytes(seg[i + 17:i + 17 + n])
                if len(symbols) != n or tc > 1 or th > 3:
                    raise ValueError("corrupt JPEG: bad DHT segment")
                (ac if tc else dc)[th] = _lookup(counts, symbols)
                i += 17 + n
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 128 if pq else 64
                if i + 1 + size > len(seg) or tq > 3:
                    raise ValueError("corrupt JPEG: bad DQT segment")
                vals = np.frombuffer(seg[i + 1:i + 1 + size],
                                     ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[list(ZIGZAG)] = vals
                quant[tq] = table.reshape(8, 8)
                i += 1 + size
        elif marker == 0xDD:
            if len(seg) < 2:
                raise ValueError("corrupt JPEG: bad DRI segment")
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("corrupt JPEG: scan before the frame")
            plan = _scan_plan(frame, seg, dc, ac)
            segments, pos = _entropy_segments(data, pos)
            per_mcu = (1 if seg[0] == 1 else
                       sum(frame.h[frame.ids.index(seg[1 + 2 * i])]
                           * frame.v[frame.ids.index(seg[1 + 2 * i])]
                           for i in range(seg[0])))
            per_seg = restart * per_mcu if restart else max(1, len(plan))
            _decode_blocks(segments, plan, per_seg, frame.coef,
                           len(frame.ids))
            scans += 1
        elif marker == 0xDC:
            raise ValueError("JPEG with a DNL marker is not supported")
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
    if frame is None or not scans:
        raise ValueError("corrupt JPEG: no frame or no scan")
    coef = np.frombuffer(frame.coef, np.int32).reshape(-1, 8, 8)
    planes = []
    for ci in range(len(frame.ids)):
        if frame.tq[ci] not in quant:
            raise ValueError("corrupt JPEG: undefined quantization table")
        gw, gh = frame.gw[ci], frame.gh[ci]
        lo = int(frame.offset[ci])
        px = idct_islow(coef[lo:lo + gw * gh], quant[frame.tq[ci]])
        plane = px.reshape(gh, gw, 8, 8).transpose(0, 2, 1, 3).reshape(
            gh * 8, gw * 8)[:frame.ch[ci], :frame.cw[ci]]
        fh, fv = frame.hmax // frame.h[ci], frame.vmax // frame.v[ci]
        if frame.hmax % frame.h[ci] or frame.vmax % frame.v[ci]:
            raise ValueError("JPEG with fractional sampling ratios is not "
                             "supported")
        if (fh, fv) != (1, 1):
            plane = _upsample(plane, fh, fv)
        planes.append(plane[:frame.height, :frame.width])
    if len(planes) == 1:
        gray = planes[0].astype(np.uint8)
        return np.repeat(gray[..., None], 3, axis=2)
    if _color_space(frame, jfif, adobe) == "rgb":
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


# --------------------------------------------------------------- encoding

def quality_tables(quality: int = 75) -> tuple[np.ndarray, np.ndarray]:
    """jcparam.c jpeg_set_quality(quality, force_baseline=TRUE): the
    standard tables scaled, rounded, clamped to [1, 255]; (8, 8) each,
    natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    out = []
    for base in STD_QUANT:
        t = (np.asarray(base, np.int64) * scale + 50) // 100
        out.append(np.clip(t, 1, 255).reshape(8, 8))
    return out[0], out[1]


def _rgb_to_ycc(img: np.ndarray) -> tuple[np.ndarray, ...]:
    """jccolor.c rgb_ycc_convert with its tables (Cb and Cr rounded by
    0.5 - epsilon)."""
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    half = _ONE_HALF
    off = (128 << _SCALEBITS) + half - 1
    y = (_fix16(0.29900) * r + _fix16(0.58700) * g + _fix16(0.11400) * b
         + half) >> _SCALEBITS
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b
          + off) >> _SCALEBITS
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b
          + off) >> _SCALEBITS
    return y, cb, cr


def _pad_to(a: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Edge replication to (rows, cols) (jcprepct.c expand_bottom_edge,
    jcsample.c expand_right_edge)."""
    return np.pad(a, ((0, rows - a.shape[0]), (0, cols - a.shape[1])),
                  mode="edge")


def _fdct_1d(d: list, even_shift: int, odd_shift: int,
             even_left: bool) -> list:
    """jfdctint.c's 1-D islow pass; pass 1 shifts its outputs 0 and 4
    left by PASS1_BITS, pass 2 descales them."""
    f = _F
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    out = [None] * 8
    if even_left:
        out[0] = (tmp10 + tmp11) << _PASS1_BITS
        out[4] = (tmp10 - tmp11) << _PASS1_BITS
    else:
        out[0] = descale(tmp10 + tmp11, even_shift)
        out[4] = descale(tmp10 - tmp11, even_shift)
    z1 = (tmp12 + tmp13) * f["0_541196100"]
    out[2] = descale(z1 + tmp13 * f["0_765366865"], odd_shift)
    out[6] = descale(z1 - tmp12 * f["1_847759065"], odd_shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * f["1_175875602"]
    tmp4 = tmp4 * f["0_298631336"]
    tmp5 = tmp5 * f["2_053119869"]
    tmp6 = tmp6 * f["3_072711026"]
    tmp7 = tmp7 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    out[7] = descale(tmp4 + z1 + z3, odd_shift)
    out[5] = descale(tmp5 + z2 + z4, odd_shift)
    out[3] = descale(tmp6 + z2 + z3, odd_shift)
    out[1] = descale(tmp7 + z1 + z4, odd_shift)
    return out


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(n, 8, 8) uint8 samples -> (n, 8, 8) int64 DCT coefficients scaled
    up by 8, as jfdctint.c leaves them: rows, then columns."""
    x = blocks.astype(np.int64) - 128
    rows = _fdct_1d([x[:, :, c] for c in range(8)], 0,
                    _CONST_BITS - _PASS1_BITS, True)
    ws = np.stack(rows, axis=2)
    cols = _fdct_1d([ws[:, r, :] for r in range(8)], _PASS1_BITS,
                    _CONST_BITS + _PASS1_BITS, False)
    return np.stack(cols, axis=1)


def _reciprocals(divisor: np.ndarray) -> tuple[np.ndarray, ...]:
    """jcdctmgr.c compute_reciprocal for 16-bit DCTELEM (the SIMD
    build): reciprocal, correction and shift per divisor (all > 1)."""
    d = divisor.astype(np.int64).ravel()
    b = np.floor(np.log2(d)).astype(np.int64)
    r = 16 + b
    fq = (np.int64(1) << r) // d
    fr = (np.int64(1) << r) % d
    c = d // 2
    pow2 = fr == 0
    low = ~pow2 & (fr <= d // 2)
    high = ~pow2 & ~low
    fq = np.where(pow2, fq >> 1, fq + high)
    r = np.where(pow2, r - 1, r)
    c = c + low
    return fq.reshape(8, 8), c.reshape(8, 8), r.reshape(8, 8)


def quantize(coefs: np.ndarray, table: np.ndarray) -> np.ndarray:
    """jcdctmgr.c quantize with the reciprocals of ``table << 3``:
    |x| + correction times the reciprocal, shifted, the sign restored."""
    fq, c, r = _reciprocals(table.astype(np.int64) << 3)
    a = np.abs(coefs)
    q = ((a + c) * fq) >> r
    return np.where(coefs < 0, -q, q)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8 gh, 8 gw) -> (gh, gw, 8, 8)."""
    gh, gw = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(gh, 8, gw, 8).transpose(0, 2, 1, 3)


@functools.lru_cache(maxsize=1)
def _encode_tables() -> dict:
    """Per table (class, id): code and length arrays indexed by symbol."""
    out = {}
    for key, (counts, symbols) in STD_HUFFMAN.items():
        code = np.zeros(256, np.int64)
        length = np.zeros(256, np.int64)
        for c, ln, sym in _huffman_codes(counts, symbols):
            code[sym], length[sym] = c, ln
        out[key] = (code, length)
    return out


def _magnitude(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(size category, value bits) of each coefficient or difference."""
    a = np.abs(v)
    size = np.zeros_like(a)
    nz = a > 0
    size[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    bits = np.where(v < 0, v + (np.int64(1) << size) - 1, v)
    return size, bits


def _huffman_encode(zz: np.ndarray, table: np.ndarray) -> bytes:
    """Entropy-code blocks (scan order, zigzag coefficients) with the
    standard tables, ``table`` 0 (luma) or 1 (chroma) per block; the DC
    differences run per table id's component stream, which the caller
    lays out as ``table * 2 + (component is Cr)``."""
    codes = _encode_tables()
    nb = zz.shape[0]
    events_key, events_code, events_len = [], [], []

    def emit(key, cls, tid, sym, size, bits):
        c = np.where(tid == 0, codes[(cls, 0)][0][sym],
                     codes[(cls, 1)][0][sym])
        ln = np.where(tid == 0, codes[(cls, 0)][1][sym],
                      codes[(cls, 1)][1][sym])
        events_key.append(key)
        events_code.append((c << size) | bits)
        events_len.append(ln + size)

    tid = table // 2
    # DC: the difference from the previous block of the same component
    dc = zz[:, 0]
    diff = np.empty(nb, np.int64)
    for comp in np.unique(table):
        idx = np.flatnonzero(table == comp)
        diff[idx] = np.diff(dc[idx], prepend=0)
    size, bits = _magnitude(diff)
    blk = np.arange(nb, dtype=np.int64)
    emit(blk * 256, 0, tid, size, size, bits)
    # AC: a symbol per nonzero coefficient, ZRLs before long runs, EOB
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    prev = np.zeros_like(k)
    same = np.zeros(len(b), bool)
    same[1:] = b[1:] == b[:-1]
    prev[1:] = np.where(same[1:], k[:-1], 0)
    run = k - prev - 1
    size, bits = _magnitude(zz[b, k])
    nzrl = run // 16
    zb = np.repeat(b, nzrl)
    zk = np.repeat(k, nzrl)
    zero = np.zeros(len(zb), np.int64)
    emit(zb * 256 + 2 * zk - 1, 1, tid[zb], np.full(len(zb), 0xF0),
         zero, zero)
    emit(b * 256 + 2 * k, 1, tid[b], ((run % 16) << 4) | size, size, bits)
    last = np.zeros(nb, np.int64)
    np.maximum.at(last, b, k)
    eob = np.flatnonzero(last < 63)
    zero = np.zeros(len(eob), np.int64)
    emit(eob * 256 + 200, 1, tid[eob], zero, zero, zero)

    key = np.concatenate(events_key)
    order = np.argsort(key, kind="stable")
    code = np.concatenate(events_code)[order]
    length = np.concatenate(events_len)[order]
    total = int(length.sum())
    pad = -total % 8
    code = np.append(code, (1 << pad) - 1)       # pad with 1-bits
    length = np.append(length, pad)
    ends = np.cumsum(length)
    sym = np.repeat(np.arange(len(length)), length)
    pos = np.arange(total + pad) - np.repeat(ends - length, length)
    bitarr = ((code[sym] >> (length[sym] - 1 - pos)) & 1).astype(np.uint8)
    return np.packbits(bitarr).tobytes().replace(b"\xff", b"\xff\x00")


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def encode_jpeg(img: np.ndarray, quality: int = 75) -> bytes:
    """``(H, W, 3) uint8`` -> baseline JFIF bytes, 4:2:0, standard
    Huffman tables (see the module doc)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("encode_jpeg takes an (H, W, 3) uint8 array")
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"JPEG sizes are 1-65535, got {w} x {h}")
    qy, qc = quality_tables(quality)
    y, cb, cr = _rgb_to_ycc(img)
    mcux, mcuy = -(-w // 16), -(-h // 16)
    # Y: padded right to whole blocks and down to the MCU rows, then to
    # the MCU grid (blocks past the image hold replicated samples, which
    # only the dummy blocks see)
    y = _pad_to(y, 16 * mcuy, 16 * mcux)
    # chroma: jcsample.c h2v2_downsample over rows padded right to twice
    # the block-padded output width and down to even rows; bias 1, 2, 1,
    # 2, ... along each output row
    cw = -(-w // 2)
    out_cols = 8 * -(-cw // 8)
    ch = -(-h // 2)
    bias = np.tile(np.array([1, 2], np.int64), out_cols // 2)
    planes = []
    for c in (cb, cr):
        c = _pad_to(c, 2 * ch, 2 * out_cols)
        s = c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
        s = (s + bias) >> 2
        planes.append(_pad_to(s, 8 * mcuy, 8 * mcux))
    yb = _blocks(y)                                 # (2 mcuy, 2 mcux, 8, 8)
    # scan order: per MCU the 4 Y blocks (2 x 2), then Cb, then Cr
    ymcu = yb.reshape(mcuy, 2, mcux, 2, 8, 8).transpose(0, 2, 1, 3, 4, 5)
    ymcu = ymcu.reshape(mcuy, mcux, 4, 8, 8)
    cbb, crb = (_blocks(p).reshape(mcuy, mcux, 1, 8, 8) for p in planes)
    samples = np.concatenate([ymcu, cbb, crb], axis=2).reshape(-1, 8, 8)
    table = np.tile(np.array([0, 0, 0, 0, 2, 3]), mcuy * mcux)
    coefs = fdct_islow(samples)
    q = np.where((table == 0)[:, None, None], quantize(coefs, qy),
                 quantize(coefs, qc))
    zz = q.reshape(-1, 64)[:, list(ZIGZAG)]
    scan = _huffman_encode(zz, table)

    parts = [b"\xff\xd8",
             _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tid, t in enumerate((qy, qc)):
        parts.append(_segment(0xDB, bytes([tid]) + bytes(
            t.ravel()[list(ZIGZAG)].astype(np.uint8).tolist())))
    parts.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                          + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for (cls, tid), (counts, symbols) in STD_HUFFMAN.items():
        parts.append(_segment(0xC4, bytes([cls << 4 | tid]) + bytes(counts)
                              + symbols))
    parts.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11,
                                       0, 63, 0])))
    parts += [scan, b"\xff\xd9"]
    return b"".join(parts)
