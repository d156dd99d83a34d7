"""The port's GalleryIndex held against the JAX package's on the CPU:
artifacts cross between the packages, and queries agree bitwise on ±1
data (the port's plain fused path against JAX ``method='fused'`` in
Pallas interpret mode)."""

import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu.retrieval import GalleryIndex as JaxIndex
from imageretrievalresearch_tpu_torch.parallel import Mesh
from imageretrievalresearch_tpu_torch.retrieval import GalleryIndex
from imageretrievalresearch_tpu_torch.retrieval import index as index_mod


def _pm1_rows(rng, n, d=32):
    out = np.zeros((n, d), np.float32)
    for r in range(n):
        pos = rng.choice(d, 16, replace=False)
        out[r, pos] = rng.choice([-1.0, 1.0], 16)
    return out


@pytest.fixture()
def data():
    rng = np.random.default_rng(0)
    g = rng.normal(size=(300, 32)).astype(np.float32) * 2
    c = rng.integers(0, 9, 300).astype(np.int32)
    paths = [f"img_{i}.jpg" for i in range(300)]
    return g, c, paths


def _same(a, b, *, exact=True):
    assert len(a) == len(b) and a.dim == b.dim
    if exact:
        np.testing.assert_array_equal(a.embeddings, b.embeddings)
    else:
        np.testing.assert_allclose(a.embeddings, b.embeddings, atol=1e-6)
    np.testing.assert_array_equal(a.classes, b.classes)
    assert a.paths == b.paths
    assert a.meta == b.meta


@pytest.mark.parametrize("store_dtype", ["float32", "bfloat16", "int8"])
def test_artifacts_cross_between_packages(tmp_path, data, store_dtype):
    g, c, paths = data
    meta = {"model": "efficientnet_b3a"}
    jidx = JaxIndex(32, meta=meta).add(g, c, paths)
    tidx = GalleryIndex(32, meta=meta, device="cpu").add(g, c, paths)
    # host normalization: XLA's and torch's norms may differ by an ulp
    np.testing.assert_allclose(tidx.embeddings, jidx.embeddings, atol=1e-6)

    jidx.save(tmp_path / "j.npz", store_dtype=store_dtype)
    _same(GalleryIndex.load(tmp_path / "j.npz", device="cpu"),
          JaxIndex.load(tmp_path / "j.npz"))
    tidx.save(tmp_path / "t.npz", store_dtype=store_dtype)
    _same(JaxIndex.load(tmp_path / "t.npz"),
          GalleryIndex.load(tmp_path / "t.npz", device="cpu"))
    # the same stored arithmetic either way round (bf16 rounding, int8
    # codes) up to the ulp-level normalization difference above
    _same(GalleryIndex.load(tmp_path / "t.npz", device="cpu"),
          JaxIndex.load(tmp_path / "j.npz"), exact=False)


def test_query_and_dedup_bitwise_against_jax_fused():
    rng = np.random.default_rng(3)
    g = _pm1_rows(rng, 2100)
    g[700] = g[5]          # exact duplicates: tied scores
    g[1900] = g[5]
    c = rng.integers(0, 40, 2100).astype(np.int32)
    q = _pm1_rows(rng, 24)
    jidx = JaxIndex(32).add(g, c)
    tidx = GalleryIndex(32, device="cpu").add(g, c)
    np.testing.assert_array_equal(tidx.embeddings, jidx.embeddings)

    jv, ji, jc = jidx.query(q, k=150, method="fused", interpret=True)
    tv, ti, tc = tidx.query(q, k=150, method="fused")
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)

    jd = jidx.query_class_dedup(q, k=150, method="fused", interpret=True)
    td = tidx.query_class_dedup(q, k=150, method="fused")
    for ours, ref in zip(td, jd):
        np.testing.assert_array_equal(ours, ref)
    # the dense route gives the same ranking
    for ours, ref in zip(tidx.query(q, k=150, method="dense"), (tv, ti, tc)):
        np.testing.assert_array_equal(ours, ref)


def test_dedup_padding_when_classes_run_out():
    g = np.eye(8, dtype=np.float32)
    c = np.array([1, 1, 1, 2, 2, 2, 2, 2], np.int32)
    idx = GalleryIndex(8, device="cpu").add(g, c)
    vals, inds, cls = idx.query_class_dedup(g[:2], k=8, num_unique=3)
    np.testing.assert_array_equal(cls[:, 2], [-1, -1])
    np.testing.assert_array_equal(inds[:, 2], [-1, -1])
    assert np.isneginf(vals[:, 2]).all()
    np.testing.assert_array_equal(cls[:, :2], [[1, 2], [1, 2]])


def test_unported_modes_and_validation(data):
    g, c, _ = data
    idx = GalleryIndex(32, device="cpu")
    with pytest.raises(ValueError, match="empty gallery"):
        idx.query(g[:1])
    with pytest.raises(ValueError):
        idx.add(g[:, :8], c)
    idx.add(g, c)
    # approx is ported: the dense path, which is what JAX's approx_max_k
    # computes off the TPU; bitwise on ±1 rows with duplicates
    rng = np.random.default_rng(6)
    pg = _pm1_rows(rng, 400)
    pg[300] = pg[7]
    pc = rng.integers(0, 9, 400).astype(np.int32)
    pq = _pm1_rows(rng, 6)
    jidx, tidx = _pair(pg, pc)
    mesh = Mesh(["cpu"] * 2)
    for mode in ("float32", "bfloat16", "int8"):
        # mesh sharding is ported: the sharded query is the unsharded one
        for a, b in zip(idx.query(g[:2], k=5, matmul_dtype=mode, mesh=mesh),
                        idx.query(g[:2], k=5, matmul_dtype=mode)):
            np.testing.assert_array_equal(a, b)
        kw = {"k": 150, "method": "approx", "matmul_dtype": mode}
        for ours, ref in zip(tidx.query(pq, **kw), jidx.query(pq, **kw)):
            np.testing.assert_array_equal(ours, ref)
        for ours, ref in zip(tidx.query_class_dedup(pq, **kw),
                             jidx.query_class_dedup(pq, **kw)):
            np.testing.assert_array_equal(ours, ref)
        # JAX's refusal: the sharded path is exact-only
        with pytest.raises(ValueError, match="exact-only"):
            idx.query(g[:2], k=5, matmul_dtype=mode, method="approx",
                      mesh=mesh)
    with pytest.raises(ValueError, match="unknown matmul_dtype"):
        idx.query(g[:2], k=5, matmul_dtype="float16")


def test_int8_rerank_mode_validation(data):
    # JAX's ValueErrors (tests/test_gallery_index.py::test_mode_validation)
    g, c, _ = data
    idx = GalleryIndex(32, device="cpu").add(g, c)
    with pytest.raises(ValueError, match="exact re-rank"):
        idx.query(g[:2], k=5, matmul_dtype="int8_rerank", method="approx")
    with pytest.raises(ValueError, match="HIGHEST"):
        idx.query(g[:2], k=5, matmul_dtype="int8_rerank",
                  precision="highest")
    with pytest.raises(ValueError, match="mesh"):
        idx.query(g[:2], k=5, matmul_dtype="int8_rerank",
                  mesh=Mesh(["cpu"] * 2))


def _pair(g, c):
    """A JAX index and a port index holding the same host embeddings (the
    two packages' host normalization may differ by an ulp, which a bf16
    rounding or an int8 code would amplify)."""
    jidx = JaxIndex(g.shape[1]).add(g, c)
    tidx = GalleryIndex(g.shape[1], device="cpu").add(g, c)
    np.testing.assert_allclose(tidx.embeddings, jidx.embeddings, atol=1e-6)
    tidx._embeds = [jidx.embeddings.copy()]
    return jidx, tidx


def _jax_kw(mode):
    # the JAX fused kernels in Pallas interpret mode (stage 1 of
    # int8_rerank too); the port on CPU tensors ranks with the plain
    # version (method='fused') or densely, with the same results
    return {"matmul_dtype": mode, "interpret": True,
            **({} if mode == "int8_rerank" else {"method": "fused"})}


@pytest.mark.parametrize("mode", ["bfloat16", "int8", "int8_rerank"])
def test_quantized_query_and_dedup_bitwise_on_pm1(mode):
    rng = np.random.default_rng(4)
    g = _pm1_rows(rng, 2100)
    g[700] = g[5]          # exact duplicates: tied scores
    g[1900] = g[5]
    c = rng.integers(0, 40, 2100).astype(np.int32)
    q = _pm1_rows(rng, 40)
    jidx, tidx = _pair(g, c)
    ref = jidx.query(q, k=150, **_jax_kw(mode))
    methods = ["exact"] if mode == "int8_rerank" else ["fused", "dense"]
    for method in methods:
        ours = tidx.query(q, k=150, method=method, matmul_dtype=mode)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    jd = jidx.query_class_dedup(q, k=150, **_jax_kw(mode))
    td = tidx.query_class_dedup(q, k=150, matmul_dtype=mode,
                                **({} if mode == "int8_rerank"
                                   else {"method": "fused"}))
    for a, b in zip(td, jd):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["bfloat16", "int8", "int8_rerank"])
def test_quantized_query_near_ties_on_float_data(mode):
    rng = np.random.default_rng(5)
    g = rng.normal(size=(2100, 32)).astype(np.float32)
    c = rng.integers(0, 40, 2100).astype(np.int32)
    q = rng.normal(size=(40, 32)).astype(np.float32)
    jidx, tidx = _pair(g, c)
    # the near-tie rule: the queries' normalization may differ by an ulp
    # between the packages and f32 sums run in another order
    jv, ji, _ = jidx.query(q, k=150, **_jax_kw(mode))
    tv, ti, tc = tidx.query(q, k=150, matmul_dtype=mode,
                            **({} if mode == "int8_rerank"
                               else {"method": "fused"}))
    mism = ti != ji
    assert mism.mean() < 0.005, mism.mean()
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tc, tidx.classes[ti])
    jd = jidx.query_class_dedup(q, k=150, **_jax_kw(mode))
    td = tidx.query_class_dedup(q, k=150, matmul_dtype=mode)
    assert (td[1] != jd[1]).mean() < 0.02
    np.testing.assert_allclose(td[0], jd[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8",
                                  "int8_rerank"])
def test_resident_forms_match_jax(data, mode):
    g, c, _ = data
    jidx, tidx = _pair(g, c)
    jidx.query(g[:2], k=5, matmul_dtype=mode)
    tidx.query(g[:2], k=5, matmul_dtype=mode)
    ref = jidx._device_gallery[(mode, None)]
    ref = ref if isinstance(ref, tuple) else (ref,)
    ours = tidx._device_gallery[mode]
    assert list(tidx._device_gallery) == [mode]   # only this mode resident
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        if a.dtype == torch.bfloat16:
            assert b.dtype.name == "bfloat16"
            np.testing.assert_array_equal(
                a.view(torch.int16).numpy(), b.view(np.int16))
        elif mode == "float32":    # norms on the device: an ulp apart
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6)
        else:
            assert a.numpy().dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b)
    if mode == "int8_rerank":      # int8 primary codes, packed residual
        assert ours[0].dtype == torch.int8 and ours[2].dtype == torch.int32
        assert tuple(ours[2].shape) == (len(tidx), 32 // 4)
    tidx.add(g[:1], c[:1])
    assert not tidx._device_gallery


@pytest.mark.parametrize("mode", ["bfloat16", "int8", "int8_rerank"])
def test_resident_forms_built_in_blocks(data, monkeypatch, mode):
    # uploaded and converted 64 rows at a time: the same bits as one block
    g, c, _ = data
    ref = GalleryIndex(32, device="cpu").add(g, c)._gallery_on_device(mode)
    monkeypatch.setattr(index_mod, "_UPLOAD_ROWS", 64)
    ours = GalleryIndex(32, device="cpu").add(g, c)._gallery_on_device(mode)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_build_time_norms_live_on_the_device(data):
    g, c, _ = data
    idx = GalleryIndex(32, device="cpu").add(g, c)
    dev_g, norms = idx._gallery_on_device()
    np.testing.assert_array_equal(
        norms.numpy(), torch.linalg.vector_norm(dev_g, dim=1).numpy())
