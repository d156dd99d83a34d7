"""The port's retrieval ops held against the JAX package on the CPU.

Same numpy inputs through both. The JAX fused kernel runs in Pallas
interpret mode, as tests/test_retrieval_ops.py runs it; the port's fused
path on CPU tensors is its plain version. The CUDA kernel itself is held
against that plain version on the card by chip_smoke.py and
tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu.ops import retrieval as J
from imageretrievalresearch_tpu_torch.ops import retrieval as T


def _qg(rng, q=37, g=500, d=64):
    return (rng.normal(size=(q, d)).astype(np.float32),
            rng.normal(size=(g, d)).astype(np.float32))


def _int_qg(rng, q=24, g=2100, d=32):
    """Rows of 16 entries of ±1 (norm exactly 4): scores are exact under
    any accumulation order and quantized to multiples of 1/16, so ties are
    common (the construction of tests/test_retrieval_ops.py)."""
    def rows(n):
        out = np.zeros((n, d), np.float32)
        for r in range(n):
            pos = rng.choice(d, 16, replace=False)
            out[r, pos] = rng.choice([-1.0, 1.0], 16)
        return out
    return rows(q), rows(g)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_fused(q, g, k):
    qh = J.l2_normalize(jnp.asarray(q))
    return [np.asarray(a) for a in
            J.fused_cosine_topk_pallas(qh, jnp.asarray(g), k,
                                       interpret=True)]


def _torch_ref(q, g, k, **kw):
    qh = T.l2_normalize(_t(q))
    return [a.numpy() for a in
            T.fused_cosine_topk_reference(qh, _t(g), k, **kw)]


def test_l2_normalize_and_dense_scores(rng):
    q, g = _qg(rng)
    np.testing.assert_allclose(T.l2_normalize(_t(q)).numpy(),
                               np.asarray(J.l2_normalize(jnp.asarray(q))),
                               rtol=0, atol=1e-6)
    qh = J.l2_normalize(jnp.asarray(q))
    ref = np.asarray(J.dense_scores(qh, jnp.asarray(g), "float32"))
    ours = T.dense_scores(_t(qh), _t(g)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("g,k,chunk", [(5000, 150, 512), (100, 10, 2048),
                                       (7, 150, 2048), (1000, 20, 300)])
def test_chunked_topk_ties_to_lowest_index(rng, g, k, chunk):
    # integer-valued scores: many exact ties
    sims = rng.integers(-20, 20, size=(16, g)).astype(np.float32)
    v, i = T.chunked_topk(_t(sims), k, chunk=chunk)
    rv, ri = jax.lax.top_k(jnp.asarray(sims), min(k, g))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    assert i.dtype == torch.int32


@pytest.mark.parametrize("method", ["dense", "fused", "exact"])
def test_cosine_topk_bitwise_on_pm1_data_with_duplicates(rng, method):
    q, g = _int_qg(rng)
    g[500] = g[3]
    g[1700] = g[3]
    qh = J.l2_normalize(jnp.asarray(q))
    rv, ri = jax.lax.top_k(qh @ J.l2_normalize(jnp.asarray(g)).T, 150)
    v, i = T.cosine_topk(_t(q), _t(g), 150, method=method)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


def test_plain_fused_matches_pallas_bitwise_at_tpu_geometry(rng):
    q, g = _int_qg(rng)
    g[500] = g[3]
    g[1700] = g[3]
    jv, ji, jok = _jax_fused(q, g, 150)
    tv, ti, tok = _torch_ref(q, g, 150, bins=512, t_depth=6, splits=1)
    assert jok.any()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tok, jok)


def test_plain_fused_carries_tied_scores_as_the_pallas_chain(rng):
    # bin 0 fills with six equal scores, then a higher one arrives: the
    # chain swaps it into slot 0 and carries the displaced score past the
    # five equal ones below it, so the FIRST of the six falls out (a
    # stable sort of the bin would drop the last). Kernel, Pallas and
    # plain version must keep the same five.
    q, g = _int_qg(rng, q=8, g=7 * J.FUSED_G_TILE)
    q[:] = 0.0
    q[:, :16] = 1.0
    for t in range(7):
        row = np.zeros((32,), np.float32)
        row[:12 if t == 6 else 8] = 1.0
        row[16:20 if t == 6 else 24] = 1.0
        g[t * J.FUSED_G_TILE] = row
    jv, ji, jok = _jax_fused(q, g, 150)
    tv, ti, tok = _torch_ref(q, g, 150, bins=512, t_depth=6, splits=1)
    assert 0 not in ji and J.FUSED_G_TILE in ji and 6 * J.FUSED_G_TILE in ji
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tok, jok)


def test_bin_overflow_fails_certificate_and_wrapper_stays_exact(rng):
    n_strong = J.FUSED_T_DEPTH + 2
    q, g = _int_qg(rng, q=8, g=max(4096, J.FUSED_G_TILE * n_strong))
    for t in range(n_strong):
        row = np.zeros((32,), np.float32)
        row[:16] = 1.0
        row[16 + t % 16] = 0.0
        row[t] = 2.0 + t
        g[t * J.FUSED_G_TILE] = row
    q[:] = 0.0
    q[:, :16] = 1.0
    jv, ji, jok = _jax_fused(q, g, 150)
    tv, ti, tok = _torch_ref(q, g, 150, bins=512, t_depth=6, splits=1)
    assert not tok.all()
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(ti, ji)
    qh = J.l2_normalize(jnp.asarray(q))
    rv, ri = jax.lax.top_k(qh @ J.l2_normalize(jnp.asarray(g)).T, 150)
    # the port's own geometry overflows too (every strong row is bin 0)
    _, _, ok64 = _torch_ref(q, g, 150)
    assert not ok64.all()
    wv, wi = T.cosine_topk(_t(q), _t(g), 150, method="fused")
    np.testing.assert_array_equal(wi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(wv.numpy(), np.asarray(rv))


def test_partial_certificate_failure_repairs_only_bad_rows(rng):
    q, g = _int_qg(rng, q=16, g=4096)
    for t in range(8):
        row = np.zeros((32,), np.float32)
        row[:16] = 1.0
        row[t] = 2.0 + t
        g[t * 512] = row
    q[:3] = 0.0
    q[:3, :16] = 1.0
    _, _, ok = _torch_ref(q, g, 20)
    assert not ok[:3].all() and ok[3:].all()
    qh = J.l2_normalize(jnp.asarray(q))
    rv, ri = jax.lax.top_k(qh @ J.l2_normalize(jnp.asarray(g)).T, 20)
    wv, wi = T.cosine_topk(_t(q), _t(g), 20, method="fused")
    np.testing.assert_array_equal(wi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(wv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("bins,splits", [(512, 1), (64, 33)])
def test_float_data_diverges_only_on_near_ties(rng, bins, splits):
    # the TPU geometry, and the card's (64 bins, ~one tile per split)
    q, g = _qg(rng, q=16, g=2100, d=64)
    qh = J.l2_normalize(jnp.asarray(q))
    rv, ri = jax.lax.top_k(qh @ J.l2_normalize(jnp.asarray(g)).T, 150)
    rv, ri = np.asarray(rv), np.asarray(ri)
    v, i, ok = _torch_ref(q, g, 150, bins=bins, splits=splits)
    assert ok.all()
    mism = i != ri
    assert mism.mean() < 0.005, mism.mean()
    np.testing.assert_allclose(v, rv, rtol=0, atol=1e-5)


def test_gallery_norms_bit_identical_and_checked(rng):
    g = torch.from_numpy(rng.normal(size=(2300, 64)).astype(np.float32)) * 3
    q = T.l2_normalize(torch.from_numpy(
        rng.normal(size=(64, 64)).astype(np.float32)))
    gn = torch.linalg.vector_norm(g, dim=1)
    a = T.fused_cosine_topk(q, g, 10)
    b = T.fused_cosine_topk(q, g, 10, gallery_norms=gn)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    vc, ic = T.cosine_topk(q, g, 10, method="dense")
    vd, idd = T.cosine_topk(q, g, 10, method="dense", gallery_norms=gn)
    np.testing.assert_array_equal(ic.numpy(), idd.numpy())
    np.testing.assert_array_equal(vc.numpy(), vd.numpy())
    with pytest.raises(ValueError, match="float32 gallery"):
        T.cosine_topk(q, g.to(torch.bfloat16), 10, gallery_norms=gn)


def test_unported_modes_raise(rng):
    q, g = _qg(rng)
    jq, jg = jnp.asarray(q), jnp.asarray(g)
    q, g = _t(q), _t(g)
    for kw in ({"method": "approx"},
               {"method": "approx", "matmul_dtype": "int8"}):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            T.cosine_topk(q, g, 5, **kw)
    # use_pallas raises where JAX does: it scores a raw f32 gallery in
    # float32 mode only
    for gal, jgal, kw, match in (
            (g.to(torch.bfloat16), jg.astype(jnp.bfloat16),
             {"matmul_dtype": "bfloat16"}, "raw f32 gallery"),
            (g, jg, {"matmul_dtype": "bfloat16"}, "f32-only"),
            (g, jg, {"matmul_dtype": "int8"}, "f32-only")):
        with pytest.raises(ValueError, match=match):
            T.cosine_topk(q, gal, 5, use_pallas=True, **kw)
        with pytest.raises(ValueError, match=match):
            J.cosine_topk(jq, jgal, 5, use_pallas=True, **kw)
    # ... and, unlike JAX (which ignores them there), for gallery_norms
    with pytest.raises(ValueError, match="gallery_norms"):
        T.cosine_topk(q, g, 5, use_pallas=True,
                      gallery_norms=torch.linalg.vector_norm(g, dim=1))
    with pytest.raises(ValueError, match="unknown matmul_dtype"):
        T.cosine_topk(q, g, 5, matmul_dtype="float16")
    with pytest.raises(ValueError, match="unknown precision"):
        T.cosine_topk(q, g, 5, precision="tf32")
    with pytest.raises(ValueError, match="float32 gallery"):
        T.cosine_topk(q, g, 5, matmul_dtype="int8",
                      gallery_norms=torch.linalg.vector_norm(g, dim=1))
    # a prepared gallery is scored in its own mode only (JAX's check)
    with pytest.raises(ValueError, match="bfloat16"):
        T.cosine_topk(q, g.to(torch.bfloat16), 5)
    with pytest.raises(ValueError, match="gallery_scale"):
        T.cosine_topk(q, torch.zeros((8, 64), dtype=torch.int8), 5,
                      matmul_dtype="int8")
    v0, i0 = T.cosine_topk(q, g, 10)
    v1, i1 = T.cosine_topk(q, g, 10, precision="highest")
    np.testing.assert_array_equal(v0.numpy(), v1.numpy())
    np.testing.assert_array_equal(i0.numpy(), i1.numpy())


# kernel 4 (the scores kernel): the shape of tests/test_retrieval_ops.py::
# TestPallasScores and a ragged one; JAX pads both to its 128 x 512 tiles
@pytest.mark.parametrize("q,g,d", [(20, 300, 128), (37, 500, 64)])
def test_fused_cosine_scores_matches_pallas(rng, q, g, d):
    qa, ga = _qg(rng, q, g, d)
    qh = np.asarray(J.l2_normalize(jnp.asarray(qa)))
    ref = np.asarray(J.pallas_cosine_scores(qh, ga, interpret=True))
    for precision in ("default", "highest"):
        ours = T.fused_cosine_scores(_t(qh), _t(ga), precision=precision)
        assert ours.dtype == torch.float32 and tuple(ours.shape) == (q, g)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)
        for use_pallas in (True, False):
            ours = T.cosine_scores(_t(qa), _t(ga), use_pallas=use_pallas,
                                   precision=precision)
            theirs = J.cosine_scores(qa, ga, use_pallas=use_pallas,
                                     precision=precision, interpret=True)
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                       rtol=1e-5, atol=1e-5)


def test_fused_cosine_scores_bitwise_on_pm1_and_checked(rng):
    q, g = _int_qg(rng, q=37, g=500)
    qh = np.asarray(J.l2_normalize(jnp.asarray(q)))
    ref = np.asarray(J.pallas_cosine_scores(qh, g, interpret=True))
    np.testing.assert_array_equal(
        T.fused_cosine_scores(_t(qh), _t(g)).numpy(), ref)
    np.testing.assert_array_equal(
        T.cosine_scores(_t(q), _t(g), use_pallas=True).numpy(), ref)
    with pytest.raises(ValueError, match="float32"):
        T.fused_cosine_scores(_t(qh), _t(g).to(torch.bfloat16))
    with pytest.raises(ValueError, match="float32"):
        T.fused_cosine_scores(_t(qh), _t(g)[:, :8])
    with pytest.raises(ValueError, match="unknown precision"):
        T.fused_cosine_scores(_t(qh), _t(g), precision="tf32")


# cosine_topk(use_pallas=True) against JAX's: the shapes of
# tests/test_retrieval_ops.py::test_pallas_topk_pipeline, and ±1 rows with
# duplicated rows (tied scores); several query blocks in the second
@pytest.mark.parametrize("case", ["float", "pm1"])
def test_cosine_topk_use_pallas_matches_jax(rng, case):
    if case == "float":
        q, g = _qg(rng, q=16, g=256, d=64)
        k, block = 5, 512
    else:
        q, g = _int_qg(rng)
        g[500] = g[3]
        g[1700] = g[3]
        k, block = 150, 8
    jv, ji = [np.asarray(a) for a in J.cosine_topk(
        jnp.asarray(q), jnp.asarray(g), k, use_pallas=True, interpret=True)]
    for method in ("exact", "dense"):
        v, i = T.cosine_topk(_t(q), _t(g), k, use_pallas=True,
                             method=method, query_block=block)
        np.testing.assert_array_equal(i.numpy(), ji)
        if case == "pm1":
            np.testing.assert_array_equal(v.numpy(), jv)
        else:
            np.testing.assert_allclose(v.numpy(), jv, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_highest_rejected_for_quantized_modes(rng, dtype):
    q, g = _qg(rng)
    with pytest.raises(ValueError, match="float32 score path"):
        T.cosine_topk(_t(q), _t(g), 5, matmul_dtype=dtype,
                      precision="highest")
    with pytest.raises(ValueError, match="float32 score path"):
        J.cosine_topk(q, g, 5, matmul_dtype=dtype, precision="highest")


@pytest.mark.parametrize("normalized", [False, True])
def test_quantizers_bitwise_against_jax(rng, normalized):
    x = rng.normal(size=(97, 96)).astype(np.float32) * 3
    x[5] = 0.0                                  # the 1e-12 scale clamp
    if normalized:
        x = np.asarray(J.l2_normalize(jnp.asarray(x)))
    jc, js = J.quantize_rows_int8(jnp.asarray(x))
    tc, ts = T.quantize_rows_int8(_t(x))
    assert tc.dtype == torch.int8 and tuple(ts.shape) == (97, 1)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jr = J.quantize_rows_int8_residual(jnp.asarray(x))
    tr = T.quantize_rows_int8_residual(_t(x))
    for ours, ref in zip(tr[:4], jr[:4]):      # codes and scales
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    # the norm bounds: f32 sums in another order, so within one ulp of
    # the value (1.2e-7 for the unit rows' bounds, which lie in [1, 2))
    for ours, ref in zip(tr[4:], jr[4:]):
        assert ours.ndim == 0
        ref = np.float32(ref)
        assert abs(float(ours) - float(ref)) <= np.spacing(abs(ref))


def test_pack_codes_int32_same_bytes_and_round_trip(rng):
    codes = rng.integers(-127, 128, (97, 64), dtype=np.int8)
    ours = T.pack_codes_int32(_t(codes))
    ref = J.pack_codes_int32(jnp.asarray(codes))
    assert ours.dtype == torch.int32 and tuple(ours.shape) == (97, 16)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(T._unpack_codes_int32(ours).numpy(), codes)
    np.testing.assert_array_equal(
        T._unpack_codes_int32(ours[[3, 3, 90]]).numpy(), codes[[3, 3, 90]])
    with pytest.raises(ValueError, match="multiple of 4"):
        T.pack_codes_int32(_t(codes[:, :62]))


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_dense_scores_quantized_modes(rng, dtype):
    # the same q̂ and prepared gallery through both packages (the two
    # packages' l2_normalize may differ by an ulp, which a bf16 rounding
    # or an int8 code can amplify)
    q, g = _qg(rng, q=37, g=700, d=1100)      # D > the exact int8 chunk
    qh = J.l2_normalize(jnp.asarray(q))
    g_prep, g_scale = J._prepare_gallery(jnp.asarray(g), dtype)
    g_t = (_t(g_prep) if dtype == "int8"
           else _t(np.asarray(g_prep).view(np.uint16).view(np.int16)).view(
               torch.bfloat16))
    ref = np.asarray(J.dense_scores(qh, g_prep, dtype, g_scale))
    ours = T.dense_scores(_t(qh), g_t, dtype,
                          None if g_scale is None else _t(g_scale)).numpy()
    if dtype == "int8":      # exact int32 dot, the same rescale: bitwise
        np.testing.assert_array_equal(ours, ref)
    else:                    # exact products, f32 sums in another order
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    # ±1 data: normalization and every partial sum exact -> bitwise, from
    # the raw gallery
    q, g = _int_qg(rng)
    qh = J.l2_normalize(jnp.asarray(q))
    ref = np.asarray(J.dense_scores(qh, jnp.asarray(g), dtype))
    ours = T.dense_scores(_t(qh), _t(g), dtype).numpy()
    np.testing.assert_array_equal(ours, ref)


def _jax_fused_mode(q, g, k, dtype):
    qh = J.l2_normalize(jnp.asarray(q))
    return [np.asarray(a) for a in
            J.fused_cosine_topk_pallas(qh, jnp.asarray(g), k,
                                       matmul_dtype=dtype, interpret=True)]


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_plain_fused_quantized_matches_pallas_bitwise(rng, dtype):
    q, g = _int_qg(rng)
    g[500] = g[3]
    g[1700] = g[3]
    jv, ji, jok = _jax_fused_mode(q, g, 150, dtype)
    tv, ti, tok = _torch_ref(q, g, 150, matmul_dtype=dtype, bins=512,
                             t_depth=6, splits=1)
    assert jok.any()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tok, jok)
    if dtype == "int8":
        # float data: the int8 scores are exact, so bitwise here too
        q, g = _qg(rng, q=24, g=2100, d=64)
        qh = J.l2_normalize(jnp.asarray(q))
        gq, gs = J.quantize_rows_int8(J.l2_normalize(jnp.asarray(g)))
        jv, ji, jok = [np.asarray(a) for a in J.fused_cosine_topk_pallas(
            qh, gq, 150, matmul_dtype="int8", gallery_scale=gs,
            interpret=True)]
        tv, ti, tok = [a.numpy() for a in T.fused_cosine_topk_reference(
            _t(qh), _t(gq), 150, matmul_dtype="int8", gallery_scale=_t(gs),
            bins=512, t_depth=6, splits=1)]
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tok, jok)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("method", ["dense", "fused", "exact"])
def test_cosine_topk_quantized_bitwise_on_pm1(rng, method, dtype):
    q, g = _int_qg(rng)
    g[500] = g[3]
    g[1700] = g[3]
    qh = J.l2_normalize(jnp.asarray(q))
    rv, ri = jax.lax.top_k(J.dense_scores(qh, jnp.asarray(g), dtype), 150)
    jv, ji = J.cosine_topk(jnp.asarray(q), jnp.asarray(g), 150,
                           method=method, matmul_dtype=dtype, interpret=True)
    np.testing.assert_array_equal(np.asarray(ji), np.asarray(ri))
    v, i = T.cosine_topk(_t(q), _t(g), 150, method=method,
                         matmul_dtype=dtype)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    # a prepared gallery ranks the same
    g_prep, g_scale = T._prepare_gallery(_t(g), dtype)
    v2, i2 = T.cosine_topk(_t(q), g_prep, 150, method=method,
                           matmul_dtype=dtype, gallery_scale=g_scale)
    np.testing.assert_array_equal(i2.numpy(), i.numpy())
    np.testing.assert_array_equal(v2.numpy(), v.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_dense_path_tiles_the_gallery(rng, monkeypatch, dtype):
    # gallery tiles of 256 rows: ties that straddle tiles still go to the
    # lowest index, and the repair ranks its rows through the same tiles
    monkeypatch.setattr(T, "_DENSE_GALLERY_TILE", 256)
    q, g = _int_qg(rng)
    for dup in (255, 256, 700, 1900):
        g[dup] = g[3]
    qh = J.l2_normalize(jnp.asarray(q))
    rv, ri = jax.lax.top_k(J.dense_scores(qh, jnp.asarray(g), dtype), 300)
    v, i = T.cosine_topk(_t(q), _t(g), 300, method="dense",
                         matmul_dtype=dtype)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    g_prep, g_scale = T._prepare_gallery(_t(g), dtype)
    ok = torch.ones(q.shape[0], dtype=torch.int32)
    ok[[2, 5]] = 0
    blank = torch.zeros_like(v)
    wv, wi = T.certified_topk_repair(
        T.l2_normalize(_t(q)), g_prep, 300, blank, blank.int(), ok,
        full_fallback=None, matmul_dtype=dtype, gallery_scale=g_scale)
    np.testing.assert_array_equal(wi[[2, 5]].numpy(), np.asarray(ri)[[2, 5]])
    np.testing.assert_array_equal(wv[[2, 5]].numpy(), np.asarray(rv)[[2, 5]])


def test_int8_bin_overflow_fails_certificate_and_wrapper_stays_exact(rng):
    n_strong = J.FUSED_T_DEPTH + 2
    q, g = _int_qg(rng, q=8, g=max(4096, J.FUSED_G_TILE * n_strong))
    for t in range(n_strong):
        row = np.zeros((32,), np.float32)
        row[:16] = 1.0
        row[16 + t % 16] = 0.0
        row[t] = 2.0 + t
        g[t * J.FUSED_G_TILE] = row
    q[:] = 0.0
    q[:, :16] = 1.0
    jv, ji, jok = _jax_fused_mode(q, g, 150, "int8")
    tv, ti, tok = _torch_ref(q, g, 150, matmul_dtype="int8", bins=512,
                             t_depth=6, splits=1)
    assert not tok.all()
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    _, _, ok64 = _torch_ref(q, g, 150, matmul_dtype="int8")
    assert not ok64.all()
    qh = J.l2_normalize(jnp.asarray(q))
    rv, ri = jax.lax.top_k(J.dense_scores(qh, jnp.asarray(g), "int8"), 150)
    wv, wi = T.cosine_topk(_t(q), _t(g), 150, method="fused",
                           matmul_dtype="int8")
    np.testing.assert_array_equal(wi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(wv.numpy(), np.asarray(rv))


def _rerank_inputs(rng, g_rows, d=64):
    g = rng.normal(size=(g_rows, d)).astype(np.float32)
    q = rng.normal(size=(40, d)).astype(np.float32)
    prep = [np.asarray(a) for a in J.quantize_rows_int8_residual(
        J.l2_normalize(jnp.asarray(g)))]
    return q, prep


# the four cases of tests/test_retrieval_ops.py::TestInt8Rerank:
# (gallery rows, k, shortlist, norm bounds, JAX stage 1 fused in interpret
# mode, residual codes packed)
@pytest.mark.parametrize("g_rows,k,shortlist,bounds,interpret,packed", [
    (3000, 10, 64, False, False, False),     # matches f32 exact ranking
    (2100, 10, 256, False, True, True),      # JAX stage 1 fused
    (3000, 10, 32, True, False, True),       # certificate soundness
    (300, 20, 8, False, False, False),       # shortlist below k -> k
    (300, 20, 4096, True, False, True),      # shortlist above G -> G
])
def test_int8_rerank_matches_jax(rng, g_rows, k, shortlist, bounds,
                                 interpret, packed):
    q, (c1, s1, c2, s2, g1m, rm) = _rerank_inputs(rng, g_rows)
    kw = {}
    if bounds:
        kw = {"gallery_norm_bound": g1m, "residual_norm_bound": rm}
    jv, ji, jm = [np.asarray(a) for a in J.int8_rerank_topk(
        jnp.asarray(q), c1, s1, c2, s2, k, shortlist=shortlist,
        interpret=interpret, **kw)]
    tc2 = T.pack_codes_int32(_t(c2)) if packed else _t(c2)
    tv, ti, tm = [a.numpy() for a in T.int8_rerank_topk(
        _t(q), _t(c1), _t(s1), tc2, _t(s2), k, shortlist=shortlist,
        **{n: torch.tensor(v) for n, v in kw.items()})]
    assert tv.shape == ti.shape == (40, min(k, g_rows)) and tm.shape == (40,)
    np.testing.assert_array_equal(ti, ji)
    # stage 2 is true f32 in both, summed in another order
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-5)
    sure = np.abs(jm) > 1e-5
    np.testing.assert_array_equal(np.sign(tm[sure]), np.sign(jm[sure]))
    if bounds and g_rows == 3000:
        assert (tm > 0).any()      # the certificate is useful at this size


def test_fused_eligibility_thresholds():
    e = T._fused_eligible
    assert e(32, 256, 1536, 150, 64, 6)
    assert not e(31, 256, 1536, 150, 64, 6)
    assert not e(64, 255, 1536, 150, 64, 6)
    assert not e(64, 4096, 2049, 150, 64, 6)
    assert not e(64, 4096, 1536, 385, 64, 6)
    assert not e(64, 100000, 1536, 1025, 512, 6)
