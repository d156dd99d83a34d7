"""The LUT apply and the integer shifts of ``csrc/image_ops.cu``
(``lut_kernel``, ``row_shift_kernel``, ``column_shift_kernel``) restated
in numpy, block by block and thread by thread, against the plain versions
of ``ops/image_kernels.py``: which bytes each block stages and where, the
vector and scalar paths and where each is taken, the 16-byte windows with
their guards and masks, the lane-replicated table. A CUDA kernel does not
run here; the card's tests (``tests/test_torch_cuda_kernels.py``) hold the
kernels themselves at the same shapes."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu_torch.ops import image_kernels as K

SOURCE = (Path(K.__file__).resolve().parent.parent / "csrc" / "image_ops.cu")
THREADS, LUT_VECS, LUT_WORDS = 256, 4, 64 * 32
LUT_CHUNK = LUT_VECS * THREADS * 16
SHIFT_CHUNK, SHIFT_BAND, GUARD, FULL_BAND_H = 8192, 32, 16, 3072
MAX_W = 48 * 1024


def test_constants_match_the_source():
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert int(consts["THREADS"]) == THREADS
    assert int(consts["LUT_VECS"]) == LUT_VECS
    assert consts["LUT_CHUNK"] == "LUT_VECS * THREADS * 16"
    assert consts["LUT_WORDS"] == "64 * 32"
    assert consts["MAX_W"] == "48 * 1024"
    for name, value in (("SHIFT_CHUNK", SHIFT_CHUNK),
                        ("SHIFT_BAND", SHIFT_BAND), ("GUARD", GUARD),
                        ("FULL_BAND_H", FULL_BAND_H)):
        assert int(consts[name]) == value, name


# ---------------------------------------------------------------------------
# the device intrinsics, on Python ints
# ---------------------------------------------------------------------------

def _byte_perm(x, y, sel):
    """__byte_perm: byte n of the result is byte (sel >> 4n) & 7 of y:x."""
    b = [(x >> 8 * i) & 0xff for i in range(4)] + \
        [(y >> 8 * i) & 0xff for i in range(4)]
    return sum(b[(sel >> 4 * n) & 7] << 8 * n for n in range(4))


def _funnelshift_r(lo, hi, sh):
    return (((hi << 32) | lo) >> (sh & 31)) & 0xffffffff


def _words(buf, at):
    """Four little-endian words of a 16-byte aligned shared-memory load."""
    assert at % 16 == 0 and 0 <= at and at + 16 <= len(buf), at
    return [int.from_bytes(bytes(buf[at + 4 * i:at + 4 * i + 4]), "little")
            for i in range(4)]


def _to_bytes(words):
    return np.frombuffer(b"".join(w.to_bytes(4, "little") for w in words),
                         np.uint8)


# ---------------------------------------------------------------------------
# lut_kernel
# ---------------------------------------------------------------------------

def _lut_table(entries):
    return [sum((int(entries[4 * (i >> 5) + b]) & 0xff) << 8 * b
                for b in range(4)) for i in range(LUT_WORDS)]


def _lut_word(table, pixels, lane):
    out = 0
    for k in range(4):
        e = (pixels >> 8 * k) & 0xff
        word = table[(e >> 2) * 32 + lane]
        # each lane reads only its own copy: bank l
        assert ((e >> 2) * 32 + lane) % 32 == lane
        keep = 0x7654 & ~(0xf << 4 * k)
        out = _byte_perm(word, out, keep | ((e & 3) << 4 * k))
    return out


def _lut_apply_numpy(planes, lut, in_addr, out_addr):
    """``image_lut_apply`` and ``lut_kernel`` with the planes at device
    address ``in_addr`` and the output at ``out_addr``."""
    p, hw = planes.shape[0], planes[0].size
    flat = planes.reshape(-1)
    out = np.full(flat.shape, -1, np.int64)
    blocks = -(-hw // LUT_CHUNK)
    chunk = (-(-hw // blocks) + 15) & ~15
    vec = ((in_addr ^ out_addr) & 15) == 0
    for py in range(p):
        table = _lut_table(lut[py])
        for bx in range(-(-hw // chunk)):
            lo = bx * chunk
            n = min(chunk, hw - lo)
            base = py * hw + lo
            head, nvec = n, 0
            if vec:
                head = min(n, (16 - ((in_addr + base) & 15)) & 15)
                nvec = (n - head) >> 4
                assert (in_addr + base + head) % 16 == 0
                assert (out_addr + base + head) % 16 == 0
            assert nvec <= LUT_VECS * THREADS
            tail = head + 16 * nvec
            for t in range(THREADS):
                lane = t & 31
                for i in range(LUT_VECS):
                    j = t + i * THREADS
                    if j < nvec:
                        at = base + head + 16 * j
                        words = [int.from_bytes(bytes(flat[at + 4 * q:
                                                           at + 4 * q + 4]),
                                                "little") for q in range(4)]
                        res = [_lut_word(table, wd, lane) for wd in words]
                        assert (out[at:at + 16] == -1).all()
                        out[at:at + 16] = _to_bytes(res)
                for i in range(t, head + (n - tail), THREADS):
                    k = i if i < head else tail + (i - head)
                    e = int(flat[base + k])
                    assert out[base + k] == -1
                    out[base + k] = (table[(e >> 2) * 32 + lane]
                                     >> 8 * (e & 3)) & 0xff
    assert (out >= 0).all()
    return out.reshape(planes.shape).astype(np.uint8)


@pytest.mark.parametrize("shape,in_mis,out_mis", [
    ((3, 37, 41), 0, 0), ((2, 130, 129), 0, 0), ((1, 1, 1), 0, 0),
    ((2, 1, 15), 0, 0), ((2, 4, 4), 0, 0), ((1, 128, 129), 3, 3),
    ((3, 16, 16), 1, 0), ((2, 5, 3), 8, 8), ((1, 224, 224), 0, 0)])
def test_lut_kernel_plan_matches_plain_version(shape, in_mis, out_mis):
    rng = np.random.default_rng(sum(shape) + in_mis)
    planes = rng.integers(0, 256, shape, dtype=np.uint8)
    lut = rng.integers(0, 256, (shape[0], 256)).astype(np.int32)
    got = _lut_apply_numpy(planes, lut, 4096 + in_mis, 1 << 20 | out_mis)
    want = K.lut_apply_reference(torch.from_numpy(planes),
                                 torch.from_numpy(lut)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# row_shift_kernel
# ---------------------------------------------------------------------------

def _row_stage_bytes(rpc, w):
    return GUARD + ((rpc * w + 15 + 15) & ~15) + GUARD


def _stage_span(buf, dst, src_addr, data):
    """stage_span: data[k] lands at buf[dst + lead + k]; the aligned body
    goes by 16-byte copies between 16-byte aligned addresses."""
    count = len(data)
    lead = src_addr & 15
    head = min(count, (16 - lead) & 15)
    nvec = (count - head) >> 4
    assert dst % 16 == 0
    if nvec:
        assert (dst + lead + head) % 16 == 0
        assert (src_addr + head) % 16 == 0
    buf[dst + lead:dst + lead + count] = data
    return lead


def _byte_mask(lo, hi):
    lo, hi = min(max(lo, 0), 4), min(max(hi, 0), 4)
    return ((1 << 8 * hi) - 1) & ~((1 << 8 * lo) - 1) & 0xffffffff


def _shifted_vector(buf, row, x, s, w, fill):
    o = x + s
    jlo, jhi = max(-o, 0), min(w - o, 16)
    fill4 = 0x01010101 * fill
    if jhi <= jlo:
        return _to_bytes([fill4] * 4)
    a, d = o & ~15, o - (o & ~15)
    q = _words(buf, row + a) + _words(buf, row + a + 16)
    # the two rounds of selects: words d / 4 .. d / 4 + 4
    two, one = bool(d & 8), bool(d & 4)
    a_ = [q[i + 2] if two else q[i] for i in range(6)]
    b = [a_[i + 1] if one else a_[i] for i in range(5)]
    res = [_funnelshift_r(b[i], b[i + 1], 8 * (d & 3)) for i in range(4)]
    if jlo > 0 or jhi < 16:
        for i in range(4):
            m = _byte_mask(jlo - 4 * i, jhi - 4 * i)
            res[i] = (res[i] & m) | (fill4 & ~m & 0xffffffff)
    return _to_bytes(res)


def _row_shift_numpy(rows, shifts, fill, in_addr, out_addr, grid):
    n, w = rows.shape
    flat = rows.reshape(-1)
    rpc = max(1, min(THREADS, SHIFT_CHUNK // w))
    sb = _row_stage_bytes(rpc, w)
    vec = w % 16 == 0 and in_addr % 16 == 0 and out_addr % 16 == 0
    out = np.full(flat.shape, -1, np.int64)
    rng = np.random.default_rng(0)
    # both stage buffers hold stale bytes: every byte read is staged or
    # masked
    smem = rng.integers(0, 256, 2 * sb, dtype=np.uint8)
    nchunks = -(-n // rpc)
    for block in range(grid):
        for i, c in enumerate(range(block, nchunks, grid)):
            buf0 = (i & 1) * sb
            n0, nr = c * rpc, min(rpc, n - c * rpc)
            lead = _stage_span(smem, buf0 + GUARD, in_addr + n0 * w,
                               flat[n0 * w:(n0 + nr) * w])
            sshift = shifts[n0:n0 + nr]
            if vec:
                assert lead == 0
                vpr = w >> 4
                dr, dv = divmod(THREADS, vpr)
                for t in range(THREADS):
                    r, v = divmod(t, vpr)
                    for _ in range(t, nr * vpr, THREADS):
                        s = min(max(int(sshift[r]), -w), w)
                        at = (n0 + r) * w + 16 * v
                        assert (out_addr + at) % 16 == 0
                        assert (out[at:at + 16] == -1).all()
                        out[at:at + 16] = _shifted_vector(
                            smem, buf0 + GUARD + r * w, 16 * v, s, w, fill)
                        r, v = r + dr, v + dv
                        if v >= vpr:
                            v, r = v - vpr, r + 1
            else:
                dr, dx = divmod(THREADS, w)
                for t in range(THREADS):
                    r, x = divmod(t, w)
                    for k in range(t, nr * w, THREADS):
                        s = min(max(int(sshift[r]), -w), w)
                        assert out[n0 * w + k] == -1
                        out[n0 * w + k] = (
                            smem[buf0 + GUARD + lead + k + s]
                            if 0 <= x + s < w else fill)
                        r, x = r + dr, x + dx
                        if x >= w:
                            x, r = x - w, r + 1
    assert (out >= 0).all()
    return out.reshape(rows.shape).astype(np.uint8)


def _edge_shifts(rng, n, w, smax):
    """Random shifts in ±smax, then 0, ±(W - 1), ±W, ±(W + 3), and the
    int32 extremes."""
    s = rng.integers(-smax, smax + 1, n).astype(np.int64)
    edges = [0, w - 1, -(w - 1), w, -w, w + 3, -(w + 3), 2 ** 31 - 1,
             -2 ** 31, 15, -17]
    s[:min(n, len(edges))] = edges[:n]
    return s.astype(np.int32)


@pytest.mark.parametrize("n,w,in_mis,grid", [
    (100, 224, 0, 2), (77, 41, 0, 3), (1, 1, 0, 1), (40, 16, 0, 1),
    (30, 15, 0, 2), (20, 17, 0, 1), (9, 223, 0, 2), (300, 32, 0, 4),
    (3, 9000, 0, 2), (37, 224, 1, 2), (37, 224, 3, 1), (37, 224, 8, 2)])
def test_row_shift_kernel_plan_matches_plain_version(n, w, in_mis, grid):
    rng = np.random.default_rng(n + w + in_mis)
    rows = rng.integers(0, 256, (n, w), dtype=np.uint8)
    shifts = _edge_shifts(rng, n, w, max(1, w // 2))
    got = _row_shift_numpy(rows, shifts, K.FILL, 4096 + in_mis, 1 << 20,
                           grid)
    want = K.row_shift_reference(torch.from_numpy(rows),
                                 torch.from_numpy(shifts)).numpy()
    np.testing.assert_array_equal(got, want)


def test_shifted_vector_reads_stay_in_the_guards():
    """Every window offset and shift of a 3-row chunk of 48: the aligned
    loads stay inside the buffer (``_words`` asserts it) and the bytes
    equal the plain version."""
    w, nr = 48, 3
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 256, (nr, w), dtype=np.uint8)
    buf = rng.integers(0, 256, _row_stage_bytes(nr, w), dtype=np.uint8)
    buf[GUARD:GUARD + nr * w] = rows.reshape(-1)
    for r in range(nr):
        for s in range(-w - 2, w + 3):
            sc = min(max(s, -w), w)
            want = K.row_shift_reference(
                torch.from_numpy(rows[r:r + 1]),
                torch.tensor([s], dtype=torch.int32)).numpy()[0]
            got = np.concatenate([_shifted_vector(buf, GUARD + r * w, x, sc,
                                                  w, K.FILL)
                                  for x in range(0, w, 16)])
            np.testing.assert_array_equal(got, want, err_msg=str((r, s)))


# ---------------------------------------------------------------------------
# column_shift_kernel
# ---------------------------------------------------------------------------

def _column_shift_numpy(planes, shifts, fill, in_addr, out_addr, grid):
    p, h, w = planes.shape
    assert h <= MAX_W
    # image_column_shift's band: narrower for planes past FULL_BAND_H, so
    # that two staged bands keep to FULL_BAND_H x SHIFT_BAND bytes each
    band = SHIFT_BAND if h <= FULL_BAND_H else FULL_BAND_H * SHIFT_BAND // h
    assert 2 <= band <= SHIFT_BAND and h * band <= FULL_BAND_H * SHIFT_BAND
    vec = (band == SHIFT_BAND and w % 16 == 0 and in_addr % 16 == 0
           and out_addr % 16 == 0)
    nbands = -(-w // band)
    out = np.full(planes.shape, -1, np.int64)
    rng = np.random.default_rng(0)
    stage = rng.integers(0, 256, (2, h, band), dtype=np.uint8)
    for block in range(grid):
        for i, item in enumerate(range(block, p * nbands, grid)):
            b = i & 1
            pp, x0 = item // nbands, (item % nbands) * band
            bw = min(band, w - x0)
            if vec:
                assert bw in (16, 32)
                lg = bw >> 5
                for c in range(h << lg):
                    y, half = c >> lg, (c & lg) * 16
                    assert (in_addr + (pp * h + y) * w + x0 + half) % 16 == 0
                    stage[b, y, half:half + 16] = planes[pp, y, x0 + half:
                                                          x0 + half + 16]
            else:
                stage[b, :, :bw] = planes[pp, :, x0:x0 + bw]
            sshift = shifts[pp, x0:x0 + bw]
            if vec:
                for t in range(THREADS):
                    col = 4 * (t & 7)
                    if col >= bw:
                        continue
                    s = [min(max(int(sshift[col + k]), -h), h)
                         for k in range(4)]
                    for y in range(t >> 3, h, THREADS // 8):
                        at = (pp * h + y) * w + x0 + col
                        assert (out_addr + at) % 4 == 0
                        for k in range(4):
                            src = y + s[k]
                            assert out[pp, y, x0 + col + k] == -1
                            out[pp, y, x0 + col + k] = (
                                stage[b, src, col + k] if 0 <= src < h
                                else fill)
            else:
                for t in range(THREADS):
                    col = t & 31
                    if col >= bw:
                        continue
                    s = min(max(int(sshift[col]), -h), h)
                    for y in range(t >> 5, h, THREADS // 32):
                        src = y + s
                        assert out[pp, y, x0 + col] == -1
                        out[pp, y, x0 + col] = (stage[b, src, col]
                                                if 0 <= src < h else fill)
    assert (out >= 0).all()
    return out.astype(np.uint8)


@pytest.mark.parametrize("shape,in_mis,grid", [
    ((3, 224, 224), 0, 4), ((5, 37, 41), 0, 3), ((1, 1, 1), 0, 1),
    ((2, 19, 48), 0, 2), ((2, 9, 16), 0, 1), ((2, 40, 64), 1, 3),
    ((1, 21, 32), 8, 1),
    # past FULL_BAND_H: bands of 15 columns on the scalar path
    ((1, 6200, 48), 0, 2)])
def test_column_shift_kernel_plan_matches_plain_version(shape, in_mis,
                                                        grid):
    p, h, w = shape
    rng = np.random.default_rng(sum(shape) + in_mis)
    planes = rng.integers(0, 256, shape, dtype=np.uint8)
    shifts = _edge_shifts(rng, p * w, h, max(1, h // 2)).reshape(p, w)
    got = _column_shift_numpy(planes, shifts, K.FILL, 4096 + in_mis,
                              1 << 20, grid)
    want = K.column_shift_reference(torch.from_numpy(planes),
                                    torch.from_numpy(shifts)).numpy()
    np.testing.assert_array_equal(got, want)
