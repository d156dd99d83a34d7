"""The port's CUDA kernels against their plain versions, on the card.

Skipped without a CUDA device. Imports no JAX (the machine with the card
has none); run there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu_torch.models import create_model
from imageretrievalresearch_tpu_torch.models import swin as S
from imageretrievalresearch_tpu_torch.ops import _cuda
from imageretrievalresearch_tpu_torch.ops import attention as A
from imageretrievalresearch_tpu_torch.ops import image_kernels as K
from imageretrievalresearch_tpu_torch.ops import retrieval as T
from imageretrievalresearch_tpu_torch.tools import profile_fused_kernel as P
from imageretrievalresearch_tpu_torch.utils import profiling


@pytest.fixture
def cuda_device():
    # decided here, never at import: every xdist worker collects the same
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pm1_rows(rng, n, d):
    """16 entries of ±1 per row (norm exactly 4): exact scores, many ties."""
    out = np.zeros((n, d), np.float32)
    pos = rng.random((n, d)).argsort(axis=1)[:, :16]
    np.put_along_axis(out, pos, rng.choice([-1.0, 1.0], (n, 16)), axis=1)
    return out


def _launch_and_compare(q, g, k, device, mode="float32"):
    """One launch of the mode's kernel against its plain version on the
    card, on the same (prepared) gallery: vals/inds/ok bitwise."""
    qh = T.l2_normalize(torch.from_numpy(q)).to(device)
    gd, gs = torch.from_numpy(g).to(device), None
    if mode != "float32":
        gd, gs = T._prepare_gallery(gd, mode)
    splits = T.fused_splits(qh.shape[0], gd.shape[0], k, device)
    with _cuda.ledger() as launched:
        kv, ki, kok = T.fused_cosine_topk(qh, gd, k, gallery_scale=gs)
    assert launched == {T._VARIANTS[gd.dtype][1]: 1}
    rv, ri, rok = T.fused_cosine_topk_reference(
        qh, gd, k, matmul_dtype=mode, gallery_scale=gs, splits=splits)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(kv.cpu().numpy(), rv.cpu().numpy())
    np.testing.assert_array_equal(ki.cpu().numpy(), ri.cpu().numpy())
    np.testing.assert_array_equal(kok.cpu().numpy(), rok.cpu().numpy())
    return kok.cpu().numpy()


# G and k set the wrapper's split count (fused_splits): one split below one
# tile; one split per tile (33, 79); capped by the selection merge's
# registers at k=384 (53) or by the SM count at k=150 (132 on an H100 SXM),
# both with a ragged last round of tiles. Kernel 1 copies rows by TMA where
# D % 4 == 0; D = 37 and 30 take the producer warp's masked loads. Q = 1,
# 37, 64 and 130 (three query tiles).
@pytest.mark.cuda
@pytest.mark.parametrize("q,g,d,k", [(40, 60, 32, 20), (33, 2100, 40, 20),
                                     (70, 5000, 96, 150),
                                     (64, 40000, 32, 384),
                                     (64, 30000, 32, 150),
                                     (1, 2100, 40, 20), (37, 5000, 37, 150),
                                     (64, 7777, 30, 256),
                                     (130, 5000, 96, 150)])
def test_fused_kernel_matches_plain_version(cuda_device, q, g, d, k):
    rng = np.random.default_rng(0)
    qa, ga = _pm1_rows(rng, q, d), _pm1_rows(rng, g, d)
    ga[min(64, g - 1)] = ga[3]           # exact duplicates: tied scores
    _launch_and_compare(qa, ga, k, cuda_device)


@pytest.mark.cuda
def test_fused_kernel_certificate_fails_on_bin_overflow(cuda_device):
    rng = np.random.default_rng(1)
    q, g = _pm1_rows(rng, 40, 32), _pm1_rows(rng, 70000, 32)
    # tiles are dealt round-robin to the splits: rows S*BINS apart share
    # bin 0 of split 0
    stride = T.fused_splits(40, 70000, 50, cuda_device) * T.FUSED_BINS
    assert (T.FUSED_T_DEPTH + 1) * stride < 70000
    for j in range(T.FUSED_T_DEPTH + 2):
        g[j * stride] = q[0]
    ok = _launch_and_compare(q, g, 50, cuda_device)
    assert ok[0] == 0 and ok[1:].any()
    vals, inds = T.cosine_topk(torch.from_numpy(q).to(cuda_device),
                               torch.from_numpy(g).to(cuda_device), 50)
    dv, di = T.cosine_topk(torch.from_numpy(q).to(cuda_device),
                           torch.from_numpy(g).to(cuda_device), 50,
                           method="dense")
    np.testing.assert_array_equal(inds.cpu().numpy(), di.cpu().numpy())
    np.testing.assert_array_equal(vals.cpu().numpy(), dv.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("q,g,d", [(64, 5000, 96), (130, 3001, 1536)])
def test_f32_kernels_on_unaligned_operands(cuda_device, q, g, d):
    """Kernels 1 and 4 on q̂ and a gallery that start 4 bytes past a 16-byte
    boundary (contiguous views): TMA refuses them, so the producer warp's
    masked loads run; ±1 rows, bitwise against the plain versions."""
    rng = np.random.default_rng(15)
    qh = T.l2_normalize(torch.from_numpy(_pm1_rows(rng, q, d)))

    def shifted(a):
        flat = torch.zeros(a.numel() + 1)
        flat[1:] = a.reshape(-1)
        out = flat.to(cuda_device)[1:].view(a.shape)
        assert out.is_contiguous() and out.data_ptr() % 16 == 4
        return out

    qd, gd = shifted(qh), shifted(torch.from_numpy(_pm1_rows(rng, g, d)))
    k = 150
    kv, ki, kok = T.fused_cosine_topk(qd, gd, k)
    rv, ri, rok = T.fused_cosine_topk_reference(
        qd, gd, k, splits=T.fused_splits(q, g, k, cuda_device))
    got = T.fused_cosine_scores(qd, gd)
    want = T.cosine_scores_reference(qd, gd)
    torch.cuda.synchronize()
    assert torch.equal(kv, rv) and torch.equal(ki, ri)
    assert torch.equal(kok, rok)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [30000, 30001])
def test_f32_kernels_within_1e6_of_f64(cuda_device, g):
    """Seeded unit rows at D = 1536: kernel 1's values and kernel 4's scores
    within 1e-6 of an f64 matmul (3xTF32 keeps ~21-22 bits a product; a
    single TF32 pass, or 3xTF32 without its cross terms, errs by ~1e-5
    here), and so is the plain true-f32 version."""
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    d, k = 1536, 150
    gal = torch.randn((g, d), generator=gen, device=cuda_device)
    q64 = T.l2_normalize(torch.randn((130, d), generator=gen,
                                     device=cuda_device))
    g64 = gal.double() / torch.clamp(
        torch.linalg.vector_norm(gal.double(), dim=1, keepdim=True),
        min=T.COSINE_SIM_EPS)
    exact = q64.double() @ g64.t()
    for q in (64, 130):
        qh = q64[:q].contiguous()
        scores = T.fused_cosine_scores(qh, gal)
        assert (scores.double() - exact[:q]).abs().max().item() <= 1e-6
        plain = T.cosine_scores_reference(qh, gal)
        assert (plain.double() - exact[:q]).abs().max().item() <= 1e-6
        vals, inds, _ = T.fused_cosine_topk(qh, gal, k)
        at = torch.gather(exact[:q], 1, inds.long())
        assert (vals.double() - at).abs().max().item() <= 1e-6


# the f32 cases' shapes and split counts, for the bf16 and int8 kernels;
# int8 also at widths that are not a multiple of 4 (codes zero-padded)
_F32_SHAPES = [(40, 60, 32, 20), (33, 2100, 40, 20), (70, 5000, 96, 150),
               (64, 40000, 32, 384), (64, 30000, 32, 150)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,q,g,d,k", [
    (mode, *shape) for mode in ("bfloat16", "int8") for shape in _F32_SHAPES
] + [("int8", 40, 3000, 37, 20), ("int8", 64, 5000, 30, 150)])
def test_quantized_kernels_match_plain_version(cuda_device, mode, q, g, d,
                                               k):
    rng = np.random.default_rng(0)
    qa, ga = _pm1_rows(rng, q, d), _pm1_rows(rng, g, d)
    ga[min(64, g - 1)] = ga[3]
    _launch_and_compare(qa, ga, k, cuda_device, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 37])
def test_int8_kernel_bitwise_on_float_data(cuda_device, d):
    # the int8 scores are exact, so float data compares bitwise too
    rng = np.random.default_rng(2)
    qa = rng.normal(size=(64, d)).astype(np.float32)
    ga = rng.normal(size=(20000, d)).astype(np.float32)
    ok = _launch_and_compare(qa, ga, 150, cuda_device, "int8")
    assert ok.any()


# The int8 kernel (kernel 3) on tensor cores: D = 1536 and 1000 copy by TMA
# (rows of whole 16-byte chunks; 1000 is not a multiple of the 128-code
# stage, so its last stage is zero-filled), D = 37 and 30 take the
# producer warp's masked loads; G off the 64-row tile; k = 150 and
# int8_rerank's shortlist 256 (80 splits).
@pytest.mark.cuda
@pytest.mark.parametrize("d,g,k", [(1536, 20001, 150), (1000, 30001, 256),
                                   (37, 5001, 150), (30, 7777, 256)])
def test_int8_kernel_float_data_every_copy_path(cuda_device, d, g, k):
    rng = np.random.default_rng(12)
    qa = rng.normal(size=(64, d)).astype(np.float32)
    ga = rng.normal(size=(g, d)).astype(np.float32)
    ga[100] = ga[7]                      # exact duplicates: tied scores
    ok = _launch_and_compare(qa, ga, k, cuda_device, "int8")
    assert ok.any()


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(64, 1536), (37, 30), (1, 1), (300, 100)])
def test_query_quantization_kernel_bitwise(cuda_device, n, d):
    """The int8 fused top-k's first step, one launch: codes and scales
    equal quantize_rows_int8's bit for bit, a zero row (the 1e-12 clamp)
    and halves that round to even included."""
    rng = np.random.default_rng(13)
    x = (rng.normal(size=(n, d)) * 3).astype(np.float32)
    x[0] = 0.0
    if d > 2:
        x[-1, :3] = [127.0, 0.5, -2.5]   # scale 1: x / s lands on .5 ties
    xd = torch.from_numpy(x).to(cuda_device)
    with _cuda.ledger() as launched:
        codes, scales = T.quantize_queries_int8(xd)
    assert launched == {"quantize_rows_int8_f32": 1}
    want_c, want_s = T.quantize_rows_int8(xd)
    torch.cuda.synchronize()
    assert codes.dtype == torch.int8 and scales.shape == (n, 1)
    assert torch.equal(codes, want_c) and torch.equal(scales, want_s)


@pytest.mark.cuda
def test_int8_kernel_tile_ordinals_limit_raises(cuda_device, monkeypatch):
    """Past 65,536 gallery tiles per split (16-bit tile ordinals) the int8
    wrapper raises before it launches: with one split, 65,537 tiles."""
    monkeypatch.setattr(T._cuda, "sm_count", lambda device: 1)
    g = T.FUSED_BINS * T.MAX_TILE_ORDINALS + 1
    codes = torch.zeros((g, 16), dtype=torch.int8, device=cuda_device)
    scales = torch.ones((g, 1), device=cuda_device)
    qh = T.l2_normalize(torch.ones((64, 16), device=cuda_device))
    with _cuda.ledger() as launched, pytest.raises(
            ValueError, match="16-bit tile ordinals"):
        T.fused_cosine_topk(qh, codes, 150, gallery_scale=scales)
    assert not launched


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bfloat16", "int8"])
def test_quantized_certificate_fails_on_bin_overflow(cuda_device, mode):
    rng = np.random.default_rng(1)
    q, g = _pm1_rows(rng, 40, 32), _pm1_rows(rng, 70000, 32)
    stride = T.fused_splits(40, 70000, 50, cuda_device) * T.FUSED_BINS
    for j in range(T.FUSED_T_DEPTH + 2):
        g[j * stride] = q[0]
    ok = _launch_and_compare(q, g, 50, cuda_device, mode)
    assert ok[0] == 0 and ok[1:].any()
    qd, gd = (torch.from_numpy(a).to(cuda_device) for a in (q, g))
    vals, inds = T.cosine_topk(qd, gd, 50, matmul_dtype=mode)
    dv, di = T.cosine_topk(qd, gd, 50, matmul_dtype=mode, method="dense")
    np.testing.assert_array_equal(inds.cpu().numpy(), di.cpu().numpy())
    np.testing.assert_array_equal(vals.cpu().numpy(), dv.cpu().numpy())


# The bf16 kernel's ring stages 64 words of a row per 16-byte cp.async
# chunk set: D = 37 and 100 are not multiples of 8 (masked loads), D = 1000
# is but not of 64 (a zero-filled chunk); G off the 64-row tile; k up to
# the 384 buffer entries of a row (53 splits); one ragged tile of 100 rows.
@pytest.mark.cuda
@pytest.mark.parametrize("q,g,d,k", [(64, 5001, 37, 150),
                                     (40, 20001, 1000, 384),
                                     (70, 3000, 100, 20),
                                     (64, 100, 1536, 150)])
def test_bf16_kernel_ragged_shapes_match_plain_version(cuda_device, q, g, d,
                                                       k):
    rng = np.random.default_rng(5)
    qa, ga = _pm1_rows(rng, q, d), _pm1_rows(rng, g, d)
    ga[min(64, g - 1)] = ga[3]
    _launch_and_compare(qa, ga, k, cuda_device, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1536, 1000])
def test_bf16_kernel_float_data_differs_only_at_near_ties(cuda_device, d):
    """Float rows: the tensor-core product sums in another order than the
    plain f32 matmul of the widened operands, so values agree within 1e-5
    and index sets may differ only at near-ties of the k-th value."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    qh = T.l2_normalize(torch.randn((64, d), generator=gen,
                                    device=cuda_device))
    gd = T.l2_normalize(torch.randn((30000, d), generator=gen,
                                    device=cuda_device)).to(torch.bfloat16)
    kv, ki, _ = T.fused_cosine_topk(qh, gd, 150)
    rv, ri, _ = T.fused_cosine_topk_reference(
        qh, gd, 150, matmul_dtype="bfloat16",
        splits=T.fused_splits(64, 30000, 150, cuda_device))
    scores = T.dense_scores(qh, gd, "bfloat16")
    torch.cuda.synchronize()
    assert (kv - rv).abs().max().item() <= 1e-5
    for r in range(64):
        diff = set(ki[r].tolist()) ^ set(ri[r].tolist())
        if diff:
            d_idx = torch.tensor(sorted(diff), device=cuda_device)
            assert (scores[r, d_idx] - rv[r, -1]).abs().max() <= 1e-5


# ---------------------------------------------------------------------------
# The scores kernel (kernel 4), the ladder of the tensor-core kernel and
# the stream probe (csrc/fused_topk.cu, csrc/stream_probe.cu) against
# their plain versions. Shapes ragged on every axis: Q, G not multiples of
# the blocks' rows, D not a multiple of the 32-word ring stage.
# ---------------------------------------------------------------------------

# Kernel 4 takes blocks of 64 query rows at Q <= 64, of 128 above; Q =
# 512 is the use_pallas path's query block; G = 70, 1001 and 3001 are not
# multiples of 4 (no 16-byte stores) nor of the 128-row tile; D = 17 is not
# a multiple of 4 (masked loads).
@pytest.mark.cuda
@pytest.mark.parametrize("q,g,d", [(37, 1001, 1000), (64, 2100, 96),
                                   (130, 70, 17), (1, 1, 16),
                                   (512, 3000, 1536), (200, 3001, 36),
                                   (65, 129, 1536)])
def test_scores_kernel_matches_plain_version(cuda_device, q, g, d):
    rng = np.random.default_rng(3)
    # ±1 rows: every norm and partial sum exact, so bitwise
    qh = T.l2_normalize(torch.from_numpy(_pm1_rows(rng, q, d))).to(
        cuda_device)
    gd = torch.from_numpy(_pm1_rows(rng, g, d)).to(cuda_device)
    with _cuda.ledger() as launched:
        got = T.fused_cosine_scores(qh, gd)
    assert launched == {"cosine_scores_f32": 1}
    want = T.cosine_scores_reference(qh, gd)
    torch.cuda.synchronize()
    assert got.shape == (q, g)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    # float rows: the norms summed in another order, the product in
    # 3xTF32, within 1e-5
    qh = T.l2_normalize(torch.randn((q, d), device=cuda_device))
    gd = torch.randn((g, d), device=cuda_device) * 3
    torch.testing.assert_close(T.fused_cosine_scores(qh, gd),
                               T.cosine_scores_reference(qh, gd),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        T.fused_cosine_scores(qh, gd.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("q,g,d,k", [(40, 60, 32, 20), (70, 5000, 96, 150),
                                     (64, 30000, 37, 384),
                                     (130, 5000, 40, 150)])
def test_ladder_rungs_match_plain_versions(cuda_device, mode, q, g, d, k):
    rng = np.random.default_rng(4)
    qa, ga = _pm1_rows(rng, q, d), _pm1_rows(rng, g, d)
    ga[min(64, g - 1)] = ga[3]           # tied scores
    qh = T.l2_normalize(torch.from_numpy(qa)).to(cuda_device)
    gd, gs = torch.from_numpy(ga).to(cuda_device), None
    if mode != "float32":
        gd, gs = T._prepare_gallery(gd, mode)
    splits = T.fused_splits(q, g, k, cuda_device)
    with _cuda.ledger() as launched:
        for name, rung in P.build_variants().items():
            got = rung.kernel(qh, gd, k, gallery_scale=gs)
            want = rung.plain(qh, gd, k, splits=splits, gallery_scale=gs)
            torch.cuda.synchronize()
            # ±1 data: every word, sum and score exact, so bitwise
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                np.testing.assert_array_equal(a.cpu().numpy(),
                                              b.cpu().numpy())
    tag = {"float32": "f32", "bfloat16": "bf16", "int8": "int8"}[mode]
    want = {f"fused_topk_{tag}_{r}": 1 for r in P.RUNGS}
    want[f"fused_topk_{tag}"] = 1       # the full kernel
    if tag == "int8":   # an int8 rung quantizes q̂ by its own launch first
        want["quantize_rows_int8_f32"] = len(P.RUNGS)
    assert launched == want


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,rows", [(2048, 1536, 256), (1024, 37, 512),
                                      (4096, 100, 2048), (7, 5, 7)])
def test_stream_probe_matches_plain_version(cuda_device, n, d, rows):
    rng = np.random.default_rng(5)
    ints = torch.from_numpy(rng.integers(-3, 4, (n, d)).astype(np.float32)
                            ).to(cuda_device)
    got = P.stream_probe(ints, rows)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  P.stream_probe_reference(ints, rows)
                                  .cpu().numpy())
    x = torch.randn((n, d), device=cuda_device)
    err = (P.stream_probe(x, rows) - P.stream_probe_reference(x, rows)).abs()
    scale = P.stream_probe_reference(x.abs(), rows)
    assert (err <= P.stream_probe_rtol(n, d, rows) * scale).all()
    # repeatable bit for bit: fixed summation order, no atomics
    assert torch.equal(P.stream_probe(x, rows), P.stream_probe(x, rows))


# ---------------------------------------------------------------------------
# AutoAugment kernels (csrc/image_ops.cu) against their plain versions:
# bitwise. Shapes that are not multiples of the kernels' blocks (8,192
# pixels of a plane for the histogram, up to 16,384 for the LUT; 8,192
# bytes of rows), planes of 1, 15, 16 and 50,176 pixels, a single pixel,
# row widths around the 16-byte vectors (1, 15, 16, 17, 223, 224) and rows
# wider than one staged chunk (9,000, and 49,152 past the default 48 KB of
# shared memory).
# ---------------------------------------------------------------------------

_PLANE_SHAPES = [(13, 37, 41), (7, 300, 301), (1, 1, 1), (192, 64, 64),
                 (3, 1, 15), (3, 4, 4), (2, 224, 224)]
_ROW_SHAPES = [(77, 41), (1, 1), (4097, 224), (3, 9000), (5, 15), (40, 16),
               (9, 17), (33, 223), (2, 49152)]


def _edge_planes(rng, shape):
    """Random planes, with a constant plane first (equalize's step == 0)
    and, where it fits, one that uses all 256 values."""
    planes = rng.integers(0, 256, shape, dtype=np.uint8)
    planes[0] = 9
    if shape[0] > 1 and shape[1] * shape[2] >= 256:
        planes[1].reshape(-1)[:256] = np.arange(256)
    return planes


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _PLANE_SHAPES)
def test_histogram_and_lut_kernels_match_plain_version(cuda_device, shape):
    rng = np.random.default_rng(3)
    planes = torch.from_numpy(_edge_planes(rng, shape)).to(cuda_device)
    lut = torch.from_numpy(rng.integers(0, 256, (shape[0], 256)).astype(
        np.int32)).to(cuda_device)
    with _cuda.ledger() as launched:
        hist = K.plane_histogram(planes)
        out = K.lut_apply(planes, lut)
    assert launched == {"image_histogram": 1, "image_lut_apply": 1}
    torch.cuda.synchronize()
    assert torch.equal(hist, K.plane_histogram_reference(planes))
    assert int(hist.sum()) == planes.numel()
    assert torch.equal(out, K.lut_apply_reference(planes, lut))


@pytest.mark.cuda
@pytest.mark.parametrize("n,w", _ROW_SHAPES)
def test_row_shift_kernels_match_plain_version(cuda_device, n, w):
    rng = np.random.default_rng(4)
    rows = torch.from_numpy(rng.integers(0, 256, (n, w), dtype=np.uint8)
                            ).to(cuda_device)
    smax = max(1, w // 3)
    shifts = rng.integers(-smax, smax + 1, n).astype(np.int32)
    src0 = rng.uniform(-smax, smax, n).astype(np.float32)
    # the ends of the range, whole numbers, shifts of 0, ±(W - 1), ±W and
    # past the row (the cubic offsets past its clamp to ±(W + 2) too), the
    # int32 extremes, huge, infinite and NaN offsets
    for i, (s, f) in enumerate([(-smax, -smax), (smax, smax - 0.5),
                                (w + 3, 0.0), (-w - 3, 2.0 - 2 ** -20),
                                (0, 0.5), (w - 1, w - 1.0),
                                (1 - w, 1.5 - w), (w, float(w)),
                                (-w, 0.25 - w), (w + 3, w + 3.0),
                                (-w - 3, -w - 3.0), (2 ** 31 - 1, 1e9),
                                (-2 ** 31, -1e9), (w + 1, np.inf),
                                (-w - 1, -np.inf), (2, np.nan)]):
        if i < n:
            shifts[i], src0[i] = s, f
    shifts, src0 = (torch.from_numpy(a).to(cuda_device)
                    for a in (shifts, src0))
    with _cuda.ledger() as launched:
        out = K.row_shift(rows, shifts)
        cubic = K.row_shift_cubic(rows, src0)
    assert launched == {"image_row_shift": 1, "image_row_shift_cubic": 1}
    torch.cuda.synchronize()
    assert torch.equal(out, K.row_shift_reference(rows, shifts))
    assert torch.equal(cubic, K.row_shift_cubic_reference(rows, src0))


_COLUMN_SHAPES = [(7, 224, 224), (5, 37, 41), (1, 1, 1), (3, 19, 48),
                  (2, 1000, 64), (1, 3072, 40), (1, 3073, 48), (2, 6200, 33),
                  (1, 49152, 5)]


def _column_shifts(rng, p, h, w):
    """Shifts in ±(H + 3): past the column both ways, with 0, ±(H - 1) and
    ±H first."""
    s = rng.integers(-h - 3, h + 4, (p, w)).astype(np.int32)
    edges = [0, h - 1, 1 - h, h, -h, h + 3, -h - 3]
    s.reshape(-1)[:min(s.size, len(edges))] = edges[:s.size]
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("p,h,w", _COLUMN_SHAPES)
def test_column_shift_kernel_matches_plain_version(cuda_device, p, h, w):
    """The column form (the rotate's Sy pass): bands of 32 columns, the
    last one 16 wide (W = 48) or ragged (W = 41), planes taller than the
    default 48 KB of shared memory holds twice (H = 1,000) up to 3,072;
    taller ones in narrower bands (31, 15 and 2 columns) up to the row
    shift's widest row (49,152)."""
    rng = np.random.default_rng(6)
    planes = torch.from_numpy(rng.integers(0, 256, (p, h, w), dtype=np.uint8)
                              ).to(cuda_device)
    shifts = torch.from_numpy(_column_shifts(rng, p, h, w)).to(cuda_device)
    with _cuda.ledger() as launched:
        out = K.column_shift(planes, shifts)
    assert launched == {"image_column_shift": 1}
    torch.cuda.synchronize()
    assert torch.equal(out, K.column_shift_reference(planes, shifts))


@pytest.mark.cuda
def test_column_shift_refuses_planes_past_its_limit(cuda_device):
    planes = torch.zeros((1, 49153, 16), dtype=torch.uint8,
                         device=cuda_device)
    shifts = torch.zeros((1, 16), dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="image_column_shift"):
        K.column_shift(planes, shifts)


def _unaligned(t, offset):
    """A contiguous copy of ``t`` that starts ``offset`` bytes past a
    16-byte aligned address (a slice of a larger buffer)."""
    flat = torch.empty(t.numel() * t.element_size() + 16, dtype=torch.uint8,
                       device=t.device)
    assert flat.data_ptr() % 16 == 0
    out = flat[offset:offset + t.numel() * t.element_size()].view(
        t.dtype).view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == offset and out.is_contiguous()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3, 8])
def test_image_kernels_on_unaligned_operands(cuda_device, offset):
    """Rows and planes that start 1, 3 or 8 bytes past an aligned address
    take each kernel's scalar path, in the same launch: bitwise all the
    same."""
    rng = np.random.default_rng(7 + offset)
    planes = _unaligned(torch.from_numpy(_edge_planes(rng, (5, 224, 224))
                                         ).to(cuda_device), offset)
    lut = torch.from_numpy(rng.integers(0, 256, (5, 256)).astype(np.int32)
                           ).to(cuda_device)
    n, w = 300, 224
    rows = _unaligned(torch.from_numpy(rng.integers(0, 256, (n, w),
                                                    dtype=np.uint8)
                                       ).to(cuda_device), offset)
    shifts = torch.from_numpy(rng.integers(-w - 3, w + 4, n).astype(
        np.int32)).to(cuda_device)
    src0 = torch.from_numpy(rng.uniform(-70, 70, n).astype(np.float32)
                            ).to(cuda_device)
    cols = torch.from_numpy(_column_shifts(rng, 5, 224, 224)).to(cuda_device)
    got = {"hist": K.plane_histogram(planes), "lut": K.lut_apply(planes, lut),
           "rows": K.row_shift(rows, shifts),
           "cubic": K.row_shift_cubic(rows, src0),
           "columns": K.column_shift(planes, cols)}
    torch.cuda.synchronize()
    want = {"hist": K.plane_histogram_reference(planes),
            "lut": K.lut_apply_reference(planes, lut),
            "rows": K.row_shift_reference(rows, shifts),
            "cubic": K.row_shift_cubic_reference(rows, src0),
            "columns": K.column_shift_reference(planes, cols)}
    for name in got:
        assert torch.equal(got[name], want[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 3, 8, 15])
@pytest.mark.parametrize("shape", [(192, 224, 224), (7, 37, 41),
                                   (2, 300, 301), (3, 1, 15)])
def test_histogram_and_cubic_shift_on_unaligned_operands(cuda_device,
                                                         shape, offset):
    """The redesigned kernels on operands at any byte: each plane's bytes
    before its first 16-byte aligned pixel and after its last whole vector
    (rank 0 counts them), and rows that take the cubic shift's scalar
    path; bitwise."""
    rng = np.random.default_rng(9 + offset)
    p, h, w = shape
    planes = _unaligned(torch.from_numpy(_edge_planes(rng, shape)).to(
        cuda_device), offset)
    rows = planes.reshape(p * h, w)
    smax = max(1, w // 3)
    src0 = torch.from_numpy(rng.uniform(-smax, smax, p * h).astype(
        np.float32)).to(cuda_device)
    hist = K.plane_histogram(planes)
    cubic = K.row_shift_cubic(rows, src0)
    torch.cuda.synchronize()
    assert torch.equal(hist, K.plane_histogram_reference(planes))
    assert torch.equal(cubic, K.row_shift_cubic_reference(rows, src0))


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["one", "two"])
def test_histogram_on_planes_of_one_or_two_values(cuda_device, values):
    """The atomics' worst cases at the transform's shape: 192 planes each
    of one value (every pixel of a plane in one bin; plane i holds i), and
    of two values (1 and 254 at random)."""
    rng = np.random.default_rng(10)
    if values == "one":
        planes = np.broadcast_to(np.arange(192, dtype=np.uint8)[:, None,
                                                                None],
                                 (192, 224, 224)).copy()
    else:
        planes = np.where(rng.random((192, 224, 224)) < 0.5, 1,
                          254).astype(np.uint8)
    planes = torch.from_numpy(planes).to(cuda_device)
    hist = K.plane_histogram(planes)
    torch.cuda.synchronize()
    assert torch.equal(hist, K.plane_histogram_reference(planes))
    if values == "one":
        assert (hist.max(dim=1).values == 224 * 224).all()


@pytest.mark.cuda
def test_plane_histogram_is_one_launch_without_zero_fill(cuda_device):
    """The kernel writes every count: one device kernel per call (the
    histogram's own), no fill of the output first; on a block the
    allocator hands back with stale bytes in it, the counts are right."""
    planes = torch.from_numpy(np.random.default_rng(11).integers(
        0, 256, (192, 224, 224), dtype=np.uint8)).to(cuda_device)
    want = K.plane_histogram_reference(planes)
    K.plane_histogram(planes)                   # warm: library loaded
    stale = torch.full((192, 256), -7, dtype=torch.int32,
                       device=cuda_device)
    del stale                                   # back to the allocator
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        hist = K.plane_histogram(planes)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert len(kernels) == 1, kernels
    assert "histogram_kernel" in next(iter(kernels)), kernels
    assert sum(kernels.values()) == 1, kernels
    assert torch.equal(hist, want)


@pytest.mark.cuda
def test_cubic_shift_at_the_shears_offsets(cuda_device):
    """The shear's own operands: 43,008 rows of 224 (64 images x 3
    channels x 224 rows) shifted by ``src0 = v * (y + 0.5)``, slopes v in
    ±0.3 by image, |src0| up to 67; bitwise."""
    rng = np.random.default_rng(12)
    b, c, h = 64, 3, 224
    rows = torch.from_numpy(rng.integers(0, 256, (b * c * h, h),
                                         dtype=np.uint8)).to(cuda_device)
    v = rng.uniform(-0.3, 0.3, b).astype(np.float32)
    src0 = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        (v[:, None] * (np.arange(h, dtype=np.float32) + np.float32(0.5)))[
            :, None, :], (b, c, h)).reshape(-1))).to(cuda_device)
    out = K.row_shift_cubic(rows, src0)
    torch.cuda.synchronize()
    assert torch.equal(out, K.row_shift_cubic_reference(rows, src0))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 48, 40), (4, 224, 224)])
def test_batched_rotate_on_the_card_matches_the_cpu(cuda_device, shape):
    """The 3-shear rotate (rows, columns, rows on the card) against the
    CPU's (the plain versions) on the same images and angles: bitwise."""
    from imageretrievalresearch_tpu_torch.ops import autoaugment as A

    rng = np.random.default_rng(8)
    b, h, w = shape
    imgs = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3),
                                         dtype=np.uint8))
    deg = torch.from_numpy(rng.choice([-30.0, -26.666666, -10.0, -3.33, 0.0,
                                       3.33, 10.0, 26.666666, 30.0], b
                                      ).astype(np.float32))
    with _cuda.ledger() as launched:
        card = A.batched_rotate(imgs.to(cuda_device), deg.to(cuda_device))
    # Sx on rows, Sy on columns, Sx on rows
    assert launched == {"image_row_shift": 2, "image_column_shift": 1}
    assert torch.equal(card.cpu(), A.batched_rotate(imgs, deg))


@pytest.mark.cuda
def test_policy_on_the_card_matches_the_cpu_table(cuda_device):
    """The same draws through the card's table (kernels, 3-shear rotate)
    and the CPU table (plain versions, gather rotate): equal on every image
    that no rotate touched."""
    from imageretrievalresearch_tpu_torch.ops import autoaugment as A

    rng = np.random.default_rng(5)
    imgs = torch.from_numpy(rng.integers(0, 256, (32, 48, 40, 3),
                                         dtype=np.uint8))
    draws = A.draw_policy(32, torch.Generator().manual_seed(0))
    with _cuda.ledger() as launched:
        card = A.apply_policy(imgs.to(cuda_device),
                              *(d.to(cuda_device) for d in draws)).cpu()
    # no plain version on the card
    assert launched == {"image_histogram": 2, "image_lut_apply": 3,
                        "image_row_shift_cubic": 1, "image_row_shift": 4,
                        "image_column_shift": 2}
    cpu = A.apply_policy(imgs, *draws)
    ops, _, do, _ = draws
    rotated = ((ops == A.ROTATE) & do).any(dim=1)
    assert torch.equal(card[~rotated], cpu[~rotated])


# ---------------------------------------------------------------------------
# Depthwise conv kernels (csrc/depthwise_conv.cu) against their plain
# versions. The forward (and so dx) is bitwise: the kernel rounds each
# product and sum as the plain version does, in its order. The tap
# gradients sum in another order: each tap within 1e-6 of the sum of the
# absolute products (|x| against |g|); f32 reordering moves a sum by a few
# 1e-8 of it, a dropped pixel by 1/(N Ho Wo) of it. Repeated runs are
# bitwise equal. Shapes: C not a multiple of 32 or of the 64-channel block,
# odd H with stride 2, K = 1 and 7, planes smaller than one tile and wider
# than one; the last two give the tap-gradient kernel several (image, band)
# items per block (grad_w_plan, grad_w_splits), both with a shorter last
# split, as b3a's layers have at a train step's N = 192.
# ---------------------------------------------------------------------------

from imageretrievalresearch_tpu_torch.ops import depthwise as DW  # noqa: E402

_DW_SHAPES = [(2, 16, 16, 8, 3, 1), (4, 14, 14, 40, 3, 2),
              (2, 13, 9, 144, 5, 2), (3, 7, 7, 1392, 5, 1),
              (2, 9, 9, 8, 7, 1), (2, 15, 11, 72, 7, 2),
              (1, 57, 43, 24, 3, 2), (2, 28, 28, 200, 1, 1),
              (5, 112, 112, 40, 3, 1), (43, 112, 112, 40, 3, 1),
              (16, 56, 56, 300, 5, 2)]


def _dw_splits(shape, itemsize=2):
    """The tap-gradient kernel's (nsplit, items_per_split) for ``shape`` in
    bf16 on an H100 SXM (132 SMs)."""
    n, h, w, c, k, s = shape
    th, cb = DW.band_plan("grad_w", h, w, c, k, s, itemsize)
    return DW.band_splits(n, -(-DW.out_len(h, k, s) // th), -(-c // cb),
                          DW.BAND_BLOCKS_PER_SM * 132)


def test_depthwise_shapes_cover_multi_item_splits():
    """Runs without a card: the shapes above reach the kernel's loop over
    several items per block, with and without a shorter last split."""
    assert _dw_splits(_DW_SHAPES[-2]) == (241, 10)   # 43 x 56 = 2408 items
    assert _dw_splits(_DW_SHAPES[-1]) == (50, 9)     # 5 channel blocks
    assert _dw_splits(_DW_SHAPES[0])[1] == 1


def _dw_inputs(rng, shape, dtype, device):
    n, h, w, c, k, s = shape
    ho, wo = DW.out_len(h, k, s), DW.out_len(w, k, s)
    x = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, ho, wo, c)).astype(np.float32))
    taps = torch.from_numpy(rng.normal(size=(k, k, c)).astype(np.float32))
    return (x.to(device, dtype), g.to(device, dtype),
            taps.to(dtype).float().to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _DW_SHAPES)
def test_depthwise_kernels_match_plain_version(cuda_device, shape, dtype):
    rng = np.random.default_rng(6)
    x, g, taps = _dw_inputs(rng, shape, dtype, cuda_device)
    k, s = shape[4], shape[5]
    n, h, w = shape[:3]
    with _cuda.ledger() as launched:
        y = DW.depthwise_forward(x, taps, s)
        dx = DW.depthwise_grad_x(g, taps, s, h, w)
        dw = DW.depthwise_grad_w(x, g, k, s)
        dw_again = DW.depthwise_grad_w(x, g, k, s)
    assert launched == {"dw_conv_forward": 1, "dw_conv_grad_x": 1,
                        "dw_conv_grad_w": 2}
    torch.cuda.synchronize()
    assert y.dtype == dtype and dx.dtype == dtype
    assert torch.equal(y, DW.depthwise_forward_reference(x, taps, s))
    assert torch.equal(dx, DW.depthwise_grad_x_reference(g, taps, s, h, w))
    want = DW.depthwise_grad_w_reference(x, g, k, s)
    scale = DW.depthwise_grad_w_reference(x.abs(), g.abs(), k, s)
    assert ((dw - want).abs() <= 1e-6 * scale).all()
    assert torch.equal(dw, dw_again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 13, 9, 144, 5, 2),
                                   (4, 14, 14, 40, 3, 2),
                                   (2, 9, 9, 8, 7, 1)])
def test_depthwise_function_gradients_through_the_kernels(cuda_device,
                                                          shape):
    """The autograd Function on the card: forward, dx (the cotangent and
    the unflipped taps, no dilated copy) and dw, each against cuDNN's
    grouped conv in true f32 (TF32 off), within f32 rounding."""
    import torch.nn.functional as F

    torch.backends.cudnn.allow_tf32 = False
    n, h, w, c, k, s = shape
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(np.float32)
                         ).to(cuda_device).permute(0, 3, 1, 2)
    x.requires_grad_(True)
    wt = torch.from_numpy(rng.normal(size=(c, 1, k, k)).astype(np.float32)
                          ).to(cuda_device).requires_grad_(True)
    with _cuda.ledger() as launched:
        y = DW.depthwise_conv(x, wt, s)
        ref = F.conv2d(x, wt, stride=s, padding=k // 2, groups=c)
        # a channels-last cotangent, as the model's are: no layout copy
        cot = torch.randn(ref.shape, device=cuda_device).contiguous(
            memory_format=torch.channels_last)
        dx, dw = torch.autograd.grad((y * cot).sum(), (x, wt))
        ex, ew = torch.autograd.grad((ref * cot).sum(), (x, wt))
    # no plain version on the card, no nhwc_copy
    assert launched == {"dw_conv_forward": 1, "dw_conv_grad_x": 1,
                        "dw_conv_grad_w": 1}
    for got, want in ((y, ref), (dx, ex), (dw, ew)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_depthwise_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((1, 8, 8, 16), device=cuda_device)
    with pytest.raises(ValueError):
        DW.depthwise_forward(x, torch.zeros((4, 4, 16), device=cuda_device),
                             1)
    with pytest.raises(ValueError):
        DW.depthwise_forward(x, torch.zeros((3, 3, 16), device=cuda_device),
                             3)
    with pytest.raises(ValueError):
        DW.depthwise_forward(x.half(), torch.zeros((3, 3, 16),
                                                   device=cuda_device), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [36, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,s", [(1, 1), (1, 2), (3, 1), (3, 2), (5, 1),
                                 (5, 2), (7, 1), (7, 2)])
def test_depthwise_grad_w_every_tap_size_and_stride(cuda_device, k, s,
                                                    dtype, c):
    """Kernel 10 at every (K, stride) it takes, on an odd plane whose rows
    end inside a run of pixels; C = 36 is not a multiple of the 16-byte
    chunk in bf16 (masked loads), C = 64 is (cp.async). Within 1e-6 of
    the sum of |x| |g| of its plain version, and bitwise run to run."""
    rng = np.random.default_rng(8)
    x, g, _ = _dw_inputs(rng, (3, 19, 17, c, k, s), dtype, cuda_device)
    with _cuda.ledger() as launched:
        dw = DW.depthwise_grad_w(x, g, k, s)
        again = DW.depthwise_grad_w(x, g, k, s)
    assert launched == {"dw_conv_grad_w": 2}
    want = DW.depthwise_grad_w_reference(x, g, k, s)
    scale = DW.depthwise_grad_w_reference(x.abs(), g.abs(), k, s)
    torch.cuda.synchronize()
    assert dw.shape == (k, k, c) and dw.dtype == torch.float32
    assert ((dw - want).abs() <= 1e-6 * scale).all()
    assert torch.equal(dw, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 13, 9, 36, 3, 2), (2, 14, 10, 20, 5, 2),
                                   (3, 15, 16, 7, 7, 2), (1, 6, 6, 12, 1, 2),
                                   (2, 57, 43, 24, 3, 2),
                                   (4, 11, 12, 13, 5, 1)])
def test_depthwise_forward_and_grad_x_ragged(cuda_device, shape, dtype):
    """Kernel 9's forward and direct dx at stride 2 with odd and even H and
    W (the high-padding rows and columns that torch's floor division
    drops), C not a multiple of 8 (masked loads, single-element stores),
    K = 1 and 7: equal under torch.equal to the plain versions, and no
    dilated copy or flip launches on the card (the dx path's only kernel
    is its own)."""
    rng = np.random.default_rng(14)
    n, h, w, c, k, s = shape
    x, g, taps = _dw_inputs(rng, shape, dtype, cuda_device)
    with _cuda.ledger() as launched:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            dx = DW.depthwise_grad_x(g, taps, s, h, w)
            torch.cuda.synchronize()
        kernels = [e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        y = DW.depthwise_forward(x, taps, s)
    # no plain version on the card
    assert launched == {"dw_conv_forward": 1, "dw_conv_grad_x": 1}
    torch.cuda.synchronize()
    assert torch.equal(y, DW.depthwise_forward_reference(x, taps, s))
    assert torch.equal(dx, DW.depthwise_grad_x_reference(g, taps, s, h, w))
    # profiled device activity of the dx call: the band kernel alone (or
    # nothing, where the profiler cannot trace the card)
    assert all("dw_band_kernel" in name for name in kernels), kernels


# The window attention kernel against its plain version: both f32, the
# sums in other orders (cuBLAS's blocked products against the kernel's
# d-ordered FMAs, another order of the softmax's sum, the division after
# · v), so O(1) scores and outputs part by a few f32 ulps, ~1e-6; a
# wrong bias index or a dropped mask moves them by 0.1 or more.
ATTN_TOL = 1e-5


def _window_case(rng, heads, ws, grid, shift, images, device):
    """A block call's operands at an (grid, grid) token grid: qkv and the
    bias table drawn from numpy (the table a unit normal: the benchmark
    draws it as zeros, so only this comparison holds the kernel's gather
    to the index), the index (for the plain version; the kernel computes
    it) and the block's mask."""
    hp, wp = S._padded(grid, grid, ws)
    m = S._shift_attn_mask(grid, grid, hp, wp, ws, shift)
    windows, n = images * (hp // ws) * (wp // ws), ws * ws
    qkv = torch.from_numpy(rng.standard_normal(
        (windows, n, 3, heads, 32), dtype=np.float32)).to(device)
    table = torch.from_numpy(rng.standard_normal(
        ((2 * ws - 1) ** 2, heads), dtype=np.float32)).to(device)
    index = A.relative_position_index(ws).to(device)
    mask = None if m is None else torch.from_numpy(m).to(device)
    return qkv, table, index, mask


# (heads, window, grid, shift, images): Swin-S3-B and Swin-T at 224 px
# (stage 1 unshifted and shifted, stage 2 shifted, stage 3 global, stage
# 4 global), Swin-S3-B's stage 2 at 288 px (a 36² grid padded to 42²:
# shift and padding regions) and a padded grid at 7-token windows
@pytest.mark.cuda
@pytest.mark.parametrize("heads,ws,grid,shift,images", [
    (3, 7, 56, 0, 4), (3, 7, 56, 3, 4), (6, 14, 28, 7, 16),
    (12, 14, 14, 0, 64), (24, 7, 7, 0, 64), (6, 14, 36, 7, 2),
    (6, 7, 10, 0, 8)])
def test_window_attention_kernel_matches_plain_version(
        cuda_device, heads, ws, grid, shift, images):
    rng = np.random.default_rng(grid + heads)
    qkv, table, index, mask = _window_case(rng, heads, ws, grid, shift,
                                           images, cuda_device)
    assert (mask is not None) == (shift > 0 or grid % ws > 0)
    with _cuda.ledger() as launched, torch.no_grad():
        got = A.window_attention(qkv, table, mask, heads)
    assert launched == {"window_attention_f32": 1}
    want = A.window_attention_reference(qkv, table, index, mask, heads)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    # the comparison sees the bias: a transposed index moves the output
    wrong = A.window_attention_reference(
        qkv, table, index.reshape(ws * ws, -1).T.reshape(-1), mask, heads)
    assert (wrong - want).abs().max() > 100 * ATTN_TOL


@pytest.mark.cuda
def test_window_attention_wrapper_refuses_what_the_kernel_does_not_take(
        cuda_device):
    rng = np.random.default_rng(3)
    qkv, table, index, mask = _window_case(rng, 3, 7, 56, 3, 1, cuda_device)
    with torch.no_grad():
        with pytest.raises(ValueError, match="table"):
            A.window_attention(qkv, table[:-1], mask, 3)
        with pytest.raises(ValueError, match="mask"):
            A.window_attention(qkv, table, mask[:5], 3)
        with pytest.raises(ValueError, match="qkv"):
            A.window_attention(qkv.transpose(1, 2), table, mask, 3)
        with pytest.raises(ValueError, match="at most 208"):
            A.window_attention(qkv.new_zeros((1, 225, 3, 3, 32)),
                               table.new_zeros((841, 3)), None, 3)
    with pytest.raises(ValueError, match="backward"):
        A.window_attention(qkv, table.requires_grad_(), mask, 3)


@pytest.mark.cuda
def test_swin_attention_takes_the_kernel_only_without_autograd(
        cuda_device, monkeypatch):
    """A CUDA f32 block call under no_grad launches the kernel and counts
    ``swin.attn_fused``; the same call under autograd keeps the eager path
    (``swin.attn_eager``, no launch) and its backward runs."""
    monkeypatch.setattr(profiling, "_COUNTS", {})
    torch.manual_seed(0)
    mod = S.WindowAttention(96, 3, 7).to(cuda_device)
    x = torch.randn((8, 49, 96), device=cuda_device)
    with _cuda.ledger() as launched, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            fused = mod(x)
        eager = mod(x)
        eager.sum().backward()
    assert launched == {"window_attention_f32": 1}
    assert profiling.counts() == {"swin.attn_fused": 1, "swin.attn_eager": 1}
    assert mod.qkv.weight.grad is not None
    torch.testing.assert_close(fused, eager.detach(), rtol=ATTN_TOL,
                               atol=ATTN_TOL)


@pytest.mark.cuda
def test_swin_s3_base_embedding_through_the_kernel(cuda_device,
                                                   monkeypatch):
    """swin_s3_base_224's f32 no_grad embedding of 8 images through the
    kernel (36 launches, one per block) within 1e-5 (relative, per row)
    of the eager path's on the card, the bias tables drawn non-zero; the
    MLPs on the linear kernel in both (two launches a block)."""
    model = create_model("swin_s3_base_224", seed=0, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, S.WindowAttention):
                m.relative_position_bias_table.normal_(generator=g)
    x = torch.rand((8, 224, 224, 3), generator=g, device=cuda_device)
    with _cuda.ledger() as launched, torch.no_grad():
        fused = model.embed(x)
    assert launched == {"window_attention_f32": 36, "linear_tf32x3_f32": 72}
    monkeypatch.setattr(A, "takes_kernel", lambda qkv, table: False)
    with _cuda.ledger() as launched, torch.no_grad():
        eager = model.embed(x)
    assert launched == {"linear_tf32x3_f32": 72}
    rel = ((fused - eager).norm(dim=1) / eager.norm(dim=1)).max().item()
    print(f"swin_s3_base_224 embedding, kernel vs eager: emb_rel {rel:.3g}")
    assert rel <= 1e-5, rel
