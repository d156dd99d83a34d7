"""The kernels of ``csrc/image_ops.cu`` (``histogram_kernel``,
``lut_kernel``, ``row_shift_kernel``, ``column_shift_kernel``,
``row_shift_cubic_kernel``) restated in numpy, block by block and thread
by thread (vectorised over threads where the restatement would be slow
otherwise), against the plain versions of ``ops/image_kernels.py``: which
bytes each block or cluster rank loads or stages and where, the vector
and scalar paths and where each is taken, the 16-byte windows with their
guards and masks, the lane-replicated tables, the cubic shift's per-row
terms and its exact conversions. A CUDA kernel does not run here; the
card's tests (``tests/test_torch_cuda_kernels.py``) hold the kernels
themselves at the same shapes."""

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
CUBIC_GUARD = 2 * GUARD
MAX_W = 48 * 1024
HIST_VECS, HIST_RANKS, HIST_WORDS = 8, 2, 256 * 32
HIST_CHUNK = HIST_VECS * THREADS * 16


def test_constants_match_the_source():
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", src))
    assert int(consts["THREADS"]) == THREADS
    assert int(consts["LUT_VECS"]) == LUT_VECS
    assert consts["LUT_CHUNK"] == "LUT_VECS * THREADS * 16"
    assert consts["LUT_WORDS"] == "64 * 32"
    assert consts["MAX_W"] == "48 * 1024"
    assert consts["CUBIC_GUARD"] == "2 * GUARD"
    assert int(consts["HIST_VECS"]) == HIST_VECS
    assert int(consts["HIST_RANKS"]) == HIST_RANKS
    assert consts["HIST_CHUNK"] == "HIST_VECS * THREADS * 16"
    assert consts["HIST_WORDS"] == "256 * 32"
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

def _row_stage_bytes(rpc, w, guard):
    return guard + ((rpc * w + 15 + 15) & ~15) + guard


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


def _walk_row_chunks(rows, in_addr, grid, guard):
    """walk_chunks and stage_rows of the row kernels: each block of
    ``grid`` takes chunks blockIdx.x, blockIdx.x + grid, ... of ``rpc``
    rows into its two buffers of ``_row_stage_bytes(rpc, w, guard)``
    stale bytes, in turns. Yields (smem, owner, base, sb, c, n0, nr, lead)
    for each chunk once it is staged: a chunk's row r lies at ``base +
    guard + lead + r * w`` of ``smem``, and ``owner`` names the chunk each
    byte of ``smem`` was staged for (-1: never)."""
    n, w = rows.shape
    flat = rows.reshape(-1)
    rpc = max(1, min(THREADS, SHIFT_CHUNK // w))
    sb = _row_stage_bytes(rpc, w, guard)
    nchunks = -(-n // rpc)
    for block in range(grid):
        smem = np.random.default_rng(block).integers(0, 256, 2 * sb,
                                                     dtype=np.uint8)
        owner = np.full(2 * sb, -1)
        for i, c in enumerate(range(block, nchunks, grid)):
            base = (i & 1) * sb
            n0, nr = c * rpc, min(rpc, n - c * rpc)
            lead = _stage_span(smem, base + guard, in_addr + n0 * w,
                               flat[n0 * w:(n0 + nr) * w])
            owner[base + guard + lead:base + guard + lead + nr * w] = c
            yield smem, owner, base, sb, c, n0, nr, lead


def _steps(t, total, width):
    """The (row, column) pairs thread t visits, stepped as the kernels step
    them (one division per chunk, then additions)."""
    r, x = divmod(t, width)
    dr, dx = divmod(THREADS, width)
    out = []
    for _ in range(t, total, THREADS):
        out.append((r, x))
        r, x = r + dr, x + dx
        if x >= width:
            x, r = x - width, r + 1
    return out


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
    vec = w % 16 == 0 and in_addr % 16 == 0 and out_addr % 16 == 0
    out = np.full(n * w, -1, np.int64)
    # both stage buffers hold stale bytes: every byte read is staged or
    # masked
    for smem, owner, base, _, c, n0, nr, lead in _walk_row_chunks(
            rows, in_addr, grid, GUARD):
        buf0 = base + GUARD
        sshift = shifts[n0:n0 + nr]
        if vec:
            assert lead == 0
            vpr = w >> 4
            for t in range(THREADS):
                for r, v in _steps(t, nr * vpr, vpr):
                    s = min(max(int(sshift[r]), -w), w)
                    at = (n0 + r) * w + 16 * v
                    assert (out_addr + at) % 16 == 0
                    assert (out[at:at + 16] == -1).all()
                    out[at:at + 16] = _shifted_vector(
                        smem, buf0 + r * w, 16 * v, s, w, fill)
        else:
            for t in range(THREADS):
                for r, x in _steps(t, nr * w, w):
                    k = r * w + x
                    s = min(max(int(sshift[r]), -w), w)
                    assert out[n0 * w + k] == -1
                    if 0 <= x + s < w:
                        assert owner[buf0 + lead + k + s] == c
                        out[n0 * w + k] = smem[buf0 + lead + k + s]
                    else:
                        out[n0 * w + k] = fill
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
    buf = rng.integers(0, 256, _row_stage_bytes(nr, w, GUARD),
                       dtype=np.uint8)
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


# ---------------------------------------------------------------------------
# histogram_kernel
# ---------------------------------------------------------------------------

# the shapes of the card's tests (_PLANE_SHAPES of test_torch_cuda_kernels)
# and a plane that takes 16 passes per rank
_PLANE_SHAPES = [(13, 37, 41), (7, 300, 301), (1, 1, 1), (192, 64, 64),
                 (3, 1, 15), (3, 4, 4), (2, 224, 224), (1, 1000, 1000)]
_T = np.arange(THREADS)
# thread `bin` sums its bin's 32 lane copies, copy (l + bin) & 31 at step l
_HIST_READS = _T[:, None] * 32 + ((np.arange(32)[None, :] + _T[:, None]) & 31)


def _histogram_numpy(planes, addr):
    """``image_histogram`` and ``histogram_kernel`` with the planes at
    device address ``addr``: a cluster of ``ranks`` blocks per plane, each
    rank's lane tables, rank 0's sum of the ranks' bins."""
    p, hw = planes.shape[0], planes[0].size
    flat = planes.reshape(p, hw).astype(np.int64)
    ranks = min(HIST_RANKS, -(-hw // HIST_CHUNK))
    out = np.full((p, 256), -1, np.int64)
    for py in range(p):
        src = addr + py * hw
        head = min(hw, (16 - (src & 15)) & 15)
        nvec = (hw - head) >> 4
        tail = head + 16 * nvec
        counted = np.zeros(hw, np.int64)
        hist = np.zeros(256, np.int64)        # rank 0's, zeroed
        for rank in range(ranks):
            vlo, vhi = nvec * rank // ranks, nvec * (rank + 1) // ranks
            table = np.zeros(HIST_WORDS, np.int64)
            # the first pass's loads go out before the table is cleared
            for base in [vlo] + list(range(vlo + HIST_CHUNK // 16, vhi,
                                           HIST_CHUNK // 16)):
                j = base + _T[:, None] + THREADS * np.arange(HIST_VECS)
                ok = j < vhi
                jv = j[ok]
                lanes = np.broadcast_to(_T[:, None] & 31, j.shape)[ok]
                assert ((src + head + 16 * jv) % 16 == 0).all()
                at = head + 16 * jv[:, None] + np.arange(16)
                np.add.at(counted, at, 1)
                # lane l's count of e in word e * 32 + l: bank l
                words = flat[py, at] * 32 + lanes[:, None]
                assert (words % 32 == lanes[:, None]).all()
                np.add.at(table, words, 1)
            if rank == 0:               # the bytes outside the vectors
                i = np.arange(head + (hw - tail))
                k = np.where(i < head, i, tail + (i - head))
                np.add.at(counted, k, 1)
                np.add.at(table, flat[py, k] * 32 + ((i % THREADS) & 31), 1)
            # each thread its bin over the 32 copies, added to rank 0's
            hist += table[_HIST_READS].sum(axis=1)
        assert (counted == 1).all()     # every pixel counted exactly once
        out[py] = hist                  # rank 0 writes all 256 bins
    assert (out >= 0).all()
    return out.astype(np.int32)


def test_histogram_reduction_reads_hit_32_banks():
    """At each step of the reduction a warp's 32 threads (32 bins) read 32
    different banks, and together the 256 threads read every word of the
    lane tables once."""
    for step in range(32):
        banks = _HIST_READS[:, step] % 32
        for warp in range(THREADS // 32):
            assert len(set(banks[32 * warp:32 * warp + 32])) == 32
    assert sorted(_HIST_READS.ravel()) == list(range(HIST_WORDS))


@pytest.mark.parametrize("shape", _PLANE_SHAPES)
@pytest.mark.parametrize("mis", [0, 3, 15])
def test_histogram_kernel_plan_matches_plain_version(shape, mis):
    rng = np.random.default_rng(sum(shape) + mis)
    planes = rng.integers(0, 256, shape, dtype=np.uint8)
    planes[0] = 9                       # one bin: the atomics' worst case
    got = _histogram_numpy(planes, 4096 + mis)
    want = K.plane_histogram_reference(torch.from_numpy(planes)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# row_shift_cubic_kernel
# ---------------------------------------------------------------------------

F32 = np.float32
# the card's _ROW_SHAPES, and the rows of its _PLANE_SHAPES
_CUBIC_SHAPES = [(77, 41), (1, 1), (4097, 224), (3, 9000), (5, 15),
                 (40, 16), (9, 17), (33, 223), (2, 49152), (481, 41),
                 (2100, 301), (12288, 64), (3, 15), (12, 4), (448, 224)]


def _cubic_weight_np(t):
    """cubic_weight in f32, op for op."""
    s = np.abs(t)
    near = ((s - F32(2)) * s) * s + F32(1)
    far = -((((s - F32(5)) * s) + F32(8)) * s - F32(4))
    return np.where(s < F32(1), near,
                    np.where(s < F32(2), far, F32(0))).astype(F32)


def _cubic_rows_np(src0, w):
    """cubic_row of each row: weights (N, 4), clamped weight sum, the
    clamped integer shift, and the pixels [xlo, xhi] whose source position
    lies in the row."""
    with np.errstate(invalid="ignore"):     # inf and NaN offsets
        fl = np.floor(src0)
        frac = src0 - fl
        c = np.stack([_cubic_weight_np(frac - F32(tap))
                      for tap in (-1, 0, 1, 2)], axis=1)
        wsum = np.zeros_like(frac)
        for t in range(4):
            wsum = wsum + c[:, t]
        lim = F32(w + 2)
        s = np.fmin(np.fmax(fl, -lim), lim).astype(np.int64)
        klo = np.where(F32(-1) + frac >= F32(-0.5), -1, 0)
        khi = np.where(F32(w - 1) + frac <= F32(w) - F32(0.5), w - 1, w - 2)
    nan = np.isnan(frac)
    klo, khi = np.where(nan, 1, klo), np.where(nan, 0, khi)
    return c, np.fmax(wsum, F32(1e-8)), s, klo - s, khi - s


def _byte_float_np(word, k):
    """byte_float: __byte_perm(word, 0x4B000000, 0x7440 | k) as f32, less
    2^23."""
    bits = (0x4B000000 | ((word >> (8 * k)) & 0xff)).astype(np.uint32)
    return bits.view(F32) - F32(8388608)


def _round_byte_np(v):
    """round_byte's low byte: clip to [0, 255], add 1.5 * 2^23."""
    t = np.fmin(np.fmax(v, F32(0)), F32(255)) + F32(12582912)
    return (t.view(np.uint32) & 0xff).astype(np.uint8)


def _cubic_masked_np(smem, owner, chunk, base, x, terms, w, fill):
    """cubic_pixel at staged row offsets ``base`` (pixel arrays), before
    rounding; asserts that every byte it reads was staged for ``chunk``."""
    c, wmax, s, xlo, xhi = terms
    base = np.broadcast_to(base, x.shape)
    inside = (x >= xlo) & (x <= xhi)
    acc = np.zeros(x.shape, F32)
    for t in range(4):
        idx = x + s + t - 1
        ok = (idx >= 0) & (idx < w) & inside
        at = base[ok] + idx[ok]
        assert (owner[at] == chunk).all()
        pix = np.full(x.shape, F32(fill))
        pix[ok] = smem[at].astype(F32)
        acc = acc + c[..., t] * pix
    with np.errstate(all="ignore"):
        return np.where(inside, acc / wmax, F32(fill))


def _cubic_numpy(rows, src0, fill, in_addr, out_addr, grid):
    """``image_row_shift_cubic`` and ``row_shift_cubic_kernel``; returns the
    output and how many windows took each vector path."""
    n, w = rows.shape
    vec = w % 16 == 0 and in_addr % 16 == 0 and out_addr % 16 == 0
    out = np.full(n * w, -1, np.int64)
    paths = {"fill": 0, "interior": 0, "edge": 0}
    fillb = _round_byte_np(np.array([fill], F32))[0]
    for smem, owner, buf, sb, c, n0, nr, lead in _walk_row_chunks(
            rows, in_addr, grid, CUBIC_GUARD):
        # one thread per row: the chunk's row terms
        terms = _cubic_rows_np(src0[n0:n0 + nr], w)
        if vec:
            assert lead == 0
            vpr = w >> 4
            for t in (0, 1, THREADS - 1):
                assert _steps(t, nr * vpr, vpr) == [
                    divmod(j, vpr) for j in range(t, nr * vpr, THREADS)]
            r, v = np.divmod(np.arange(nr * vpr), vpr)
            x0 = 16 * v
            rowbase = buf + CUBIC_GUARD + r * w
            tr = tuple(a[r] for a in terms)
            c4, wmax, s, xlo, xhi = tr
            # pixels jlo .. jhi of a window have their source in the row
            jlo, jhi = xlo - x0, xhi - x0
            allfill = (jhi < 0) | (jlo > 15)
            o = x0 + s - 1
            taps_in = (o >= 0) & (o + 18 < w)
            srcs_in = (jlo <= 0) & (jhi >= 15)
            res = np.zeros((nr * vpr, 16), np.uint8)
            res[allfill] = fillb
            # the other windows: 2 or 3 aligned 16-byte loads, inside
            # this buffer and its guards
            ii = np.nonzero(~allfill)[0]
            o_ = o[ii]
            assert ((o_ >= -17) & (o_ <= w - 2)).all()
            a = o_ & ~15
            d = o_ - a
            at = rowbase[ii] + a
            assert (at % 16 == 0).all()
            assert (at >= buf).all()
            third = d >= 14
            assert (at + np.where(third, 48, 32) <= buf + sb).all()
            q = smem[np.minimum(at[:, None] + np.arange(48), 2 * sb - 1)]
            q[~third, 32:] = q[~third, 16:32]   # q2 not loaded: q1
            words = q.copy().view("<u4").astype(np.uint64)  # (m, 12)
            two, one = (d & 8) > 0, (d & 4) > 0
            s1 = np.where(two[:, None], words[:, 2:9], words[:, 0:7])
            s2 = np.where(one[:, None], s1[:, 1:7], s1[:, 0:6])
            sh = (8 * (d & 3)).astype(np.uint64)[:, None]
            b5 = (((s2[:, 1:6] << np.uint64(32)) | s2[:, 0:5]) >> sh
                  ) & np.uint64(0xffffffff)
            # the 19 bytes a window's taps read: bytes o .. o + 18 of
            # its row; those inside the row staged for this chunk
            taps = (rowbase[ii] + o_)[:, None] + np.arange(19)
            tin = ((o_[:, None] + np.arange(19) >= 0)
                   & (o_[:, None] + np.arange(19) < w))
            assert (owner[taps][tin] == c).all()
            got19 = np.stack([(b5[:, m >> 2] >> np.uint64(8 * (m & 3)))
                              & np.uint64(0xff) for m in range(19)], 1)
            np.testing.assert_array_equal(got19, smem[taps])
            px = np.stack([_byte_float_np(b5[:, m >> 2], m & 3)
                           for m in range(19)], 1)
            # taps outside the row read the fill (all inside: no select)
            assert tin[taps_in[ii]].all()
            px[~tin] = F32(fill)
            for j in range(16):
                acc = np.zeros(len(ii), F32)
                for t in range(4):
                    acc = acc + c4[ii, t] * px[:, j + t]
                with np.errstate(all="ignore"):
                    res[ii, j] = _round_byte_np(acc / wmax[ii])
            # pixels whose source lies outside the row are the fill: the
            # four words masked by byte_mask
            fill4 = 0x01010101 * int(fillb)
            for m, k in enumerate(ii):
                if srcs_in[k]:
                    continue
                words4 = [int.from_bytes(bytes(res[k, 4 * q:4 * q + 4]),
                                         "little") for q in range(4)]
                for q in range(4):
                    mk = _byte_mask(int(jlo[k]) - 4 * q,
                                    int(jhi[k]) + 1 - 4 * q)
                    words4[q] = (words4[q] & mk) | (fill4 & ~mk
                                                    & 0xffffffff)
                res[k] = _to_bytes(words4)
            inner = ~allfill & taps_in & srcs_in
            for name, m in (("fill", allfill), ("interior", inner),
                            ("edge", ~allfill & ~inner)):
                paths[name] += int(m.sum())
            dst = (n0 + r) * w + x0
            assert ((out_addr + dst) % 16 == 0).all()
            at = dst[:, None] + np.arange(16)
            assert (out[at] == -1).all()
            out[at] = res
        else:
            for t in (0, 1, THREADS - 1):
                assert _steps(t, nr * w, w) == [
                    divmod(k, w) for k in range(t, nr * w, THREADS)]
            r, x = np.divmod(np.arange(nr * w), w)
            tr = tuple(a[r] for a in terms)
            vals = _cubic_masked_np(smem, owner, c,
                                    buf + CUBIC_GUARD + lead + r * w, x,
                                    tr, w, fill)
            at = n0 * w + np.arange(nr * w)
            assert (out[at] == -1).all()
            out[at] = _round_byte_np(vals)
    assert (out >= 0).all()
    return out.reshape(rows.shape).astype(np.uint8), paths


def _edge_src0(rng, n, w):
    """Offsets in ±W/3; then whole numbers, halves, the ends of the range,
    ±(W - 1), ±W, past the row, huge, infinite and NaN."""
    smax = max(1, w // 3)
    src0 = rng.uniform(-smax, smax, n).astype(F32)
    edges = [-smax, smax - 0.5, w + 3, -w - 3, 2.0 - 2 ** -20, 0.5, 0.0,
             w - 1.0, 1.5 - w, float(w), 0.25 - w, -0.5, w - 0.5, 1e9,
             -1e9, 17.0, -16.75, np.inf, -np.inf, np.nan]
    m = min(n, len(edges))
    src0[:m] = np.array(edges[:m], F32)
    return src0


@pytest.mark.parametrize("n,w", _CUBIC_SHAPES)
def test_cubic_kernel_plan_matches_plain_version(n, w):
    rng = np.random.default_rng(n + w)
    rows = rng.integers(0, 256, (n, w), dtype=np.uint8)
    src0 = _edge_src0(rng, n, w)
    got, paths = _cubic_numpy(rows, src0, K.FILL, 4096, 1 << 20,
                              grid=3 if n > 1 else 1)
    want = K.row_shift_cubic_reference(torch.from_numpy(rows),
                                       torch.from_numpy(src0)).numpy()
    np.testing.assert_array_equal(got, want)
    if w == 224 and n > 1000:
        # the path's rows take all three vector paths, interior most
        assert paths["interior"] > paths["edge"] > 0 and paths["fill"] > 0


@pytest.mark.parametrize("in_mis,out_mis", [(1, 0), (0, 8), (3, 3)])
def test_cubic_kernel_plan_unaligned_takes_the_scalar_path(in_mis, out_mis):
    rng = np.random.default_rng(in_mis + out_mis)
    rows = rng.integers(0, 256, (300, 224), dtype=np.uint8)
    src0 = _edge_src0(rng, 300, 224)
    got, paths = _cubic_numpy(rows, src0, K.FILL, 4096 + in_mis,
                              (1 << 20) + out_mis, grid=2)
    assert sum(paths.values()) == 0
    want = K.row_shift_cubic_reference(torch.from_numpy(rows),
                                       torch.from_numpy(src0)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cubic_kernel_plan_at_the_shears_offsets():
    """The shear's rows (8 images x 3 channels x 224 rows of 224, src0 =
    v * (y + 0.5), slopes in ±0.3) through the plan, bitwise."""
    rng = np.random.default_rng(13)
    b, h = 8, 224
    rows = rng.integers(0, 256, (b * 3 * h, h), dtype=np.uint8)
    v = rng.uniform(-0.3, 0.3, b).astype(F32)
    src0 = np.ascontiguousarray(np.broadcast_to(
        (v[:, None] * (np.arange(h, dtype=F32) + F32(0.5)))[:, None, :],
        (b, 3, h)).reshape(-1))
    got, paths = _cubic_numpy(rows, src0, K.FILL, 0, 1 << 20, grid=5)
    want = K.row_shift_cubic_reference(torch.from_numpy(rows),
                                       torch.from_numpy(src0)).numpy()
    np.testing.assert_array_equal(got, want)
    assert paths["interior"] > paths["edge"] + paths["fill"]


def test_cubic_row_terms_equal_the_per_pixel_weights():
    """The weights and their clamped sum, computed once per row, are the
    plain version's per-pixel ones bit for bit."""
    rng = np.random.default_rng(14)
    src0 = np.concatenate([_edge_src0(rng, 40, 224),
                           rng.uniform(-70, 70, 2000).astype(F32)])
    c, wmax, _, _, _ = _cubic_rows_np(src0, 224)
    t_src = torch.from_numpy(src0)
    t_frac = (t_src - torch.floor(t_src))[:, None]
    wsum = torch.zeros_like(t_frac)
    for i, tap in enumerate((-1, 0, 1, 2)):
        cw = K.cubic_weight(t_frac - tap)
        np.testing.assert_array_equal(c[:, i], cw[:, 0].numpy())
        wsum = wsum + cw
    np.testing.assert_array_equal(
        wmax, torch.clamp(wsum, min=1e-8)[:, 0].numpy())


def test_cubic_row_interval_is_the_per_pixel_mask():
    """[xlo, xhi] of cubic_row holds exactly the pixels whose source
    position (x + fl) + frac the plain version keeps in [-0.5, W - 0.5]:
    every shift past both ends, fractions at and next to the rounding
    boundaries, huge, infinite and NaN offsets."""
    for w in (1, 2, 5, 16, 224):
        fracs = np.array([0.0, 2 ** -24, 0.25, 0.5 - 2 ** -25, 0.5,
                          0.5 + 2 ** -24, 0.75, 1 - 2 ** -24], F32)
        fls = np.arange(-w - 5, w + 6, dtype=F32)
        src0 = (fls[:, None] + fracs[None, :]).ravel()
        src0 = np.concatenate([src0, np.array(
            [1e9, -1e9, 3e38, np.inf, -np.inf, np.nan], F32)])
        _, _, _, xlo, xhi = _cubic_rows_np(src0, w)
        x = np.arange(w, dtype=F32)[None, :]
        fl = np.floor(src0)[:, None]
        with np.errstate(invalid="ignore"):
            srcx = (x + fl) + (src0[:, None] - fl)
            want = (srcx >= F32(-0.5)) & (srcx <= F32(w) - F32(0.5))
        xi = np.arange(w)[None, :]
        got = (xi >= xlo[:, None]) & (xi <= xhi[:, None])
        np.testing.assert_array_equal(got, want, err_msg=str(w))


def test_cubic_conversions_are_exact():
    """byte_float gives every byte's value; round_byte equals round half to
    even, then the clip, on the ties, their neighbours and a dense grid of
    [-2, 258] (and ±inf); pack_low_bytes packs the low bytes."""
    words = np.random.default_rng(15).integers(0, 2 ** 32, 64,
                                               dtype=np.uint64)
    for k in range(4):
        for word in map(int, words):
            assert _byte_perm(word, 0x4B000000, 0x7440 | k) == (
                0x4B000000 | ((word >> 8 * k) & 0xff))
        np.testing.assert_array_equal(
            _byte_float_np(words, k), ((words >> np.uint64(8 * k))
                                       & np.uint64(0xff)).astype(F32))
    ties = np.arange(-3, 259, dtype=F32) + F32(0.5)
    v = np.concatenate([
        ties, np.nextafter(ties, F32(-1e9)), np.nextafter(ties, F32(1e9)),
        np.arange(-2, 258, 1 / 64).astype(F32),
        np.array([-0.0, np.inf, -np.inf, 1e30, -1e30, 255.49998], F32)])
    want = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(_round_byte_np(v), want)
    for a, b, c, d in words.reshape(-1, 4).tolist():
        ab = _byte_perm(a, b, 0x0040)
        cd = _byte_perm(c, d, 0x0040)
        assert _byte_perm(ab, cd, 0x5410) == ((a & 0xff) | (b & 0xff) << 8
                                              | (c & 0xff) << 16
                                              | (d & 0xff) << 24)
