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
    q, g = _t(q), _t(g)
    for kw in ({"method": "approx"}, {"use_pallas": True},
               {"matmul_dtype": "bfloat16"}, {"matmul_dtype": "int8"}):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            T.cosine_topk(q, g, 5, **kw)
    with pytest.raises(ValueError, match="unknown precision"):
        T.cosine_topk(q, g, 5, precision="tf32")
    v0, i0 = T.cosine_topk(q, g, 10)
    v1, i1 = T.cosine_topk(q, g, 10, precision="highest")
    np.testing.assert_array_equal(v0.numpy(), v1.numpy())
    np.testing.assert_array_equal(i0.numpy(), i1.numpy())


def test_fused_eligibility_thresholds():
    e = T._fused_eligible
    assert e(32, 256, 1536, 150, 64, 6)
    assert not e(31, 256, 1536, 150, 64, 6)
    assert not e(64, 255, 1536, 150, 64, 6)
    assert not e(64, 4096, 2049, 150, 64, 6)
    assert not e(64, 4096, 1536, 385, 64, 6)
    assert not e(64, 100000, 1536, 1025, 512, 6)
