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


@pytest.mark.parametrize("method", ["dense", "fused", "exact", "approx"])
def test_cosine_topk_bitwise_on_pm1_data_with_duplicates(rng, method):
    q, g = _int_qg(rng)
    g[500] = g[3]
    g[1700] = g[3]
    qh = J.l2_normalize(jnp.asarray(q))
    rv, ri = jax.lax.top_k(qh @ J.l2_normalize(jnp.asarray(g)).T, 150)
    v, i = T.cosine_topk(_t(q), _t(g), 150, method=method)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    if method == "approx":
        # JAX's approx_max_k off the TPU ranks as the exact top-k
        jv, ji = J.cosine_topk(jnp.asarray(q), jnp.asarray(g), 150,
                               method="approx", recall_target=0.5)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


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
    # approx is ported: the dense path, as JAX's approx_max_k off the TPU
    # (float rows: indices equal, values within f32 sums in other orders)
    for kw in ({"method": "approx"},
               {"method": "approx", "matmul_dtype": "int8"}):
        jv, ji = J.cosine_topk(jq, jg, 5, **kw)
        v, i = T.cosine_topk(q, g, 5, **kw)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0,
                                   atol=1e-6)
        # recall_target outside (0, 1] is refused (XLA's range)
        for bad in (0.0, 1.5):
            with pytest.raises(ValueError, match="recall_target"):
                T.cosine_topk(q, g, 5, recall_target=bad, **kw)
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


def test_quantizer_follows_the_written_division_not_the_jitted_product():
    """The port divides (amax / 127, x / scale), as the source text, eager
    JAX and the index's host twin ``_np_quantize_rows_int8`` (which builds
    the served gallery scales) do: codes and scales bit for bit. Under
    ``jax.jit`` XLA turns the division by 127 into a product with its f32
    reciprocal, so JAX's jitted query path may sit an ulp off in a scale;
    within one ulp of it is all that is asserted there (which rows differ
    depends on XLA)."""
    from imageretrievalresearch_tpu.retrieval.index import (
        _np_quantize_rows_int8,
    )

    raw = np.random.default_rng(11).standard_normal((3000, 96)).astype(
        np.float32)
    x = np.asarray(J.l2_normalize(jnp.asarray(raw)))
    tc, ts = (a.numpy() for a in T.quantize_rows_int8(_t(x)))
    hc, hs = _np_quantize_rows_int8(x)
    ec, es = (np.asarray(a) for a in J.quantize_rows_int8(jnp.asarray(x)))
    for codes, scales in ((hc, hs), (ec, es)):
        np.testing.assert_array_equal(tc, codes)
        np.testing.assert_array_equal(ts, scales)
    _, js = jax.jit(J.quantize_rows_int8)(jnp.asarray(x))
    js = np.asarray(js)
    assert ts.dtype == js.dtype == np.float32 and ts.shape == js.shape
    assert (np.abs(ts - js) <= np.spacing(js)).all()


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
@pytest.mark.parametrize("method", ["dense", "fused", "exact", "approx"])
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


def test_bf16_tile_ordinals_bound_raises():
    """The bf16 kernel packs each buffer entry's tile as a 16-bit ordinal
    within its split: up to 2^16 tiles of 64 rows per split pass, one more
    raises (the card's wrapper checks before it launches; no fallback)."""
    limit = T.MAX_TILE_ORDINALS
    assert limit == 1 << 16
    T.check_tile_ordinals(T.FUSED_BINS * limit, 1)
    T.check_tile_ordinals(132 * T.FUSED_BINS * limit, 132)
    T.check_tile_ordinals(100_000, 132)
    with pytest.raises(ValueError, match="16-bit tile ordinals"):
        T.check_tile_ordinals(T.FUSED_BINS * limit + 1, 1)
    with pytest.raises(ValueError, match="16-bit tile ordinals"):
        T.check_tile_ordinals(132 * T.FUSED_BINS * limit + 1, 132)


def test_query_quantization_wrapper_on_cpu_is_jax_quantizer(rng):
    """The int8 fused top-k's query quantization (one launch on the card)
    runs ``quantize_rows_int8`` on a CPU tensor, JAX's arithmetic bit for
    bit, a zero row included; it takes f32 (N, D) only."""
    x = rng.normal(size=(33, 70)).astype(np.float32) * 2
    x[4] = 0.0
    jc, js = J.quantize_rows_int8(jnp.asarray(x))
    with T._cuda.ledger() as launched:
        tc, ts = T.quantize_queries_int8(_t(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not launched
    with pytest.raises(ValueError, match="float32"):
        T.quantize_queries_int8(_t(x).double())


def test_tensor_core_kernel_constants_match_the_source():
    """csrc/fused_topk.cu's tensor-core kernel (kernels 2 and 3): a ring
    stage holds 128 bytes of each of 64 rows for both score stages (64
    bf16 or 128 int8 codes, the 128-byte swizzle's row), 16-bit tile
    ordinals (the wrapper's bound), and the ring with the 144 KB of
    buffers fits one block per SM; the bins and depth are the wrapper's."""
    import re

    from imageretrievalresearch_tpu_torch.ops import _cuda

    src = _cuda.SOURCES["fused_topk"].read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([0-9x]+)", src)[1],
                   0)

    assert const("KC") * 2 == const("KC_I8") == const("KC_F32") * 4 == 128
    assert const("QT") == const("GT") == T.FUSED_BINS
    assert const("TD") == T.FUSED_T_DEPTH
    assert re.search(r"constexpr int MAX_ORDINALS = 1 << 16;", src)
    assert T.MAX_TILE_ORDINALS == 1 << 16
    assert T.MERGE_MAX == const("MERGE_THREADS") * const("MERGE_PER")
    ring = const("STAGES") * 2 * const("QT") * 128
    buffers = const("TD") * const("QT") * const("GT") * 6
    assert buffers == 144 * 1024
    assert 1024 + ring + buffers + 2 * const("STAGES") * 8 <= 232448
    assert 1024 + ring + 2 * const("QT") * 128 + buffers > 232448  # 5 max
    # the F32 instance (kernel 1): a stage is 32 words = 128 B of a row; the
    # ring's bytes hold its plane buffers (q̂, ĝ's big and small parts) and
    # its raw gallery ring; with their mbarriers and the 144 KB of buffers
    # one block still fits an SM, its 288 + 32 NCONV threads too
    tile = const("QT") * 128
    planes = const("F32_PLANES") * 3 * tile
    assert planes + const("F32_GSTAGES") * tile == ring
    barriers = 2 * (const("F32_GSTAGES") + const("F32_PLANES")) * 8
    assert 1024 + ring + buffers + barriers <= 232448
    assert 288 + 32 * const("NCONV") <= 1024


def test_fused_workspace_words():
    """One allocation per fused top-k call: the outputs first (vals, inds
    (Q, k), ok (Q)), every later block from a 64-word boundary, the int8
    query codes and scales last; sized as ``carve`` in the source sizes
    it (which refuses any other size)."""
    q, d, k, s = 64, 1536, 150, 132
    cand = q * s * k
    words = T._work_words(q, d, k, s, False)
    assert words % 64 == 0 and words >= 2 * q * k + q + 2 * cand + q * s
    assert words - (2 * q * k + q + 2 * cand + q * s) < 4 * 64
    w8 = T._work_words(q, d, k, s, True)
    assert w8 % 64 == 0 and w8 - words >= q + q * d // 4
    assert T._work_words(1, 37, 1, 1, True) == 64 * 4 + 64 + 64


def _cvt_rna_tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 restated in numpy by value, not by bits: the f32
    rounded to 11 significant bits (10 stored; spacing 2^(e - 10) for |x|
    in [2^e, 2^(e + 1)), 2^-136 below 2^-126), to nearest with ties away
    from zero, past the largest TF32 value to inf; inf and nan kept."""
    x64 = np.where(np.isfinite(x), x, 0).astype(np.float64)
    a = np.abs(x64)
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    spacing = np.exp2(np.maximum(e, -126) - 10)
    r = np.floor(a / spacing + 0.5) * spacing
    with np.errstate(over="ignore"):
        out = np.copysign(r, x64).astype(np.float32)
    return np.where(np.isfinite(x), out, x)


def test_tf32_round_matches_cvt_rna(rng):
    """The port's restatement of the kernels' split (ops.retrieval
    tf32_round) against _cvt_rna_tf32 on seeded values of every magnitude
    and on edges: ±0, ties (the 13 dropped bits exactly 0x1000) that round
    away, carries into the exponent, subnormals, the largest f32 (to inf),
    inf and nan."""
    one = np.float32(1.0)
    edges = np.array([
        0.0, -0.0, 1.0, -1.0, 1 + 2.0 ** -11, -(1 + 2.0 ** -11),
        1 + 2.0 ** -11 - 2.0 ** -23, 2 - 2.0 ** -11, 2 - 2.0 ** -12,
        0.0625, -0.25, 2.0 ** -126, 2.0 ** -140, 2.0 ** -149,
        3 * 2.0 ** -137, np.finfo(np.float32).max,
        (2 - 2.0 ** -10) * 2.0 ** 127, np.inf, -np.inf], np.float32)
    edges = np.concatenate([edges, np.nextafter(edges[2:10], one)])
    vals = (rng.normal(size=20000) * np.exp2(rng.integers(-60, 60, 20000))
            ).astype(np.float32)
    for x in (edges, vals):
        got = T.tf32_round(torch.from_numpy(x)).numpy()
        want = _cvt_rna_tf32(x)
        np.testing.assert_array_equal(got.view(np.uint32) & 0x1FFF, 0)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    assert T.tf32_round(torch.tensor([1 + 2.0 ** -11])).item() == 1 + 2.0 ** -10
    assert T.tf32_round(torch.tensor([float("nan")])).isnan().all()


def test_split_3xtf32_exact_on_the_smoke_scales_and_bounded(rng):
    """big + small is x exactly where x has at most 11 significant bits
    (the ±1 rows the kernels are checked bitwise on: ±1/16 and ±1/4), with
    small = 0; on seeded f32 values it is within 2^-21·|x| of x."""
    for scale in (1 / 16, 1 / 4):
        x = torch.tensor([scale, -scale, 0.0])
        big, small = T.split_3xtf32(x)
        assert torch.equal(big, x) and not small.any()
    x = torch.from_numpy((rng.normal(size=50000)
                          * np.exp2(rng.integers(-30, 30, 50000))
                          ).astype(np.float32))
    big, small = T.split_3xtf32(x)
    assert torch.equal(big, T.tf32_round(big))
    assert torch.equal(small, T.tf32_round(small))
    err = (big.double() + small.double() - x.double()).abs()
    assert (err <= 2.0 ** -21 * x.double().abs()).all()


def test_3xtf32_scores_match_jax_highest(rng):
    """The kernels' 3xTF32 arithmetic, emulated (q̂ and ĝ split, small·big
    + big·small + big·big with exact products), on seeded unit rows at D =
    1536 agrees with JAX's dense_scores(..., 'float32', precision='highest')
    on the CPU within 1e-6; big·big alone (one TF32 pass) does not."""
    q = rng.normal(size=(64, 1536)).astype(np.float32)
    g = rng.normal(size=(1000, 1536)).astype(np.float32)
    want = np.asarray(J.dense_scores(J.l2_normalize(jnp.asarray(q)),
                                     jnp.asarray(g), "float32",
                                     precision="highest"))
    qb, qs = T.split_3xtf32(T.l2_normalize(_t(q)))
    gb, gs = T.split_3xtf32(T._normalized_gallery(_t(g), None))

    def dot(a, b):
        return (a.double() @ b.double().t()).numpy()

    three = dot(qs, gb) + dot(qb, gs) + dot(qb, gb)
    assert np.abs(three - want).max() <= 1e-6
    assert np.abs(dot(qb, gb) - want).max() > 1e-6


def test_fused_splits_capped_by_the_selection_merge(monkeypatch):
    """One split per SM, capped so a row's nsplit * k candidates fit the
    selection merge's registers (MERGE_MAX): on an H100 SXM (132 SMs) 132
    at the main path's k = 150, 80 at int8_rerank's shortlist 256, 53 at
    k = 384; never more splits than the gallery has tiles."""
    monkeypatch.setattr(T._cuda, "sm_count", lambda device: 132)
    dev = torch.device("cpu")
    assert T.fused_splits(64, 100_000, 150, dev) == 132
    assert T.fused_splits(64, 100_000, 256, dev) == 80
    assert T.fused_splits(64, 100_000, 384, dev) == 53
    assert T.fused_splits(64, 1000, 150, dev) == 16
    for k in (1, 150, 256, 384):
        assert T.fused_splits(64, 10 ** 7, k, dev) * k <= T.MERGE_MAX


def test_f32_kernel_checks_tile_ordinals_before_it_launches(monkeypatch):
    """The f32 wrapper (kernel 1 is a score stage of the tensor-core
    kernel, with its 16-bit tile ordinals) raises past 65,536 gallery tiles
    per split before it computes norms, allocates or launches; at the limit
    it goes on to the launch, which fails and is not counted. Run on CPU
    tensors with one split, the device lookups replaced and the C entry
    replaced by one that returns a CUDA error."""
    monkeypatch.setattr(T._cuda, "sm_count", lambda device: 1)
    entered = []

    def entry(*args):
        entered.append(args)
        return 700      # cudaErrorIllegalAddress

    monkeypatch.setitem(T._cuda._ENTRIES, ("fused_topk", "fused_topk_f32"),
                        entry)
    monkeypatch.setattr(T._cuda, "device_index", lambda device: 0)
    monkeypatch.setattr(T._cuda, "stream_handle", lambda index: 0)
    monkeypatch.setattr(T._cuda, "error_string", lambda err, name: "stub")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    qh = torch.ones((64, 1))
    limit = T.FUSED_BINS * T.MAX_TILE_ORDINALS
    with T._cuda.ledger() as launched:
        with pytest.raises(ValueError, match="16-bit tile ordinals"):
            T._fused_cosine_topk_cuda(qh, torch.zeros((limit + 1, 1)), 150,
                                      None, None)
        assert not entered
        with pytest.raises(RuntimeError, match="fused_topk_f32 launch "
                           "failed: CUDA error 700"):
            T._fused_cosine_topk_cuda(qh, torch.zeros((limit, 1)), 150,
                                      None, None)
    assert len(entered) == 1
    assert not launched
