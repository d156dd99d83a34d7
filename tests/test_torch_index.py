"""The port's GalleryIndex held against the JAX package's on the CPU:
artifacts cross between the packages, and queries agree bitwise on ±1
data (the port's plain fused path against JAX ``method='fused'`` in
Pallas interpret mode)."""

import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu.retrieval import GalleryIndex as JaxIndex
from imageretrievalresearch_tpu_torch.retrieval import GalleryIndex


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
    for kw in ({"matmul_dtype": "bfloat16"}, {"matmul_dtype": "int8"},
               {"matmul_dtype": "int8_rerank"}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            idx.query(g[:2], k=5, **kw)


def test_build_time_norms_live_on_the_device(data):
    g, c, _ = data
    idx = GalleryIndex(32, device="cpu").add(g, c)
    dev_g, norms = idx._gallery_on_device()
    np.testing.assert_array_equal(
        norms.numpy(), torch.linalg.vector_norm(dev_g, dim=1).numpy())
