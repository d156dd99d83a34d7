"""The port's sharded retrieval (``parallel/``, ``GalleryIndex(mesh=)``)
and ``gallery_topk_class_dedup`` held against the JAX package on the CPU,
in one process: the port's mesh is ``Mesh(["cpu"] * R)``, JAX's its eight
virtual CPU devices (``tests/conftest.py``).

Against JAX, values agree within 1e-6 and indices except at near-ties
(where a differing position's JAX score lies within 1e-6 of its
neighbour's). Against the port's own unsharded query they agree bit for
bit, ties across shard boundaries and pad rows included. Queries are rows
of 16 entries of ±1, whose normalization is exact in both packages, so a
bf16 rounding or an int8 code of q̂ cannot differ between them; the
compact galleries JAX ranks are the port's own codes.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu import metrics as JM
from imageretrievalresearch_tpu.parallel.gallery import (
    sharded_cosine_topk as jax_sharded,
)
from imageretrievalresearch_tpu.parallel.mesh import make_mesh as jax_mesh
from imageretrievalresearch_tpu.parallel.mesh import (
    pad_to_multiple as jax_pad,
)
from imageretrievalresearch_tpu.retrieval import GalleryIndex as JaxIndex
from imageretrievalresearch_tpu_torch import metrics as M
from imageretrievalresearch_tpu_torch.ops import retrieval as R
from imageretrievalresearch_tpu_torch.parallel import (
    Mesh,
    RowSharded,
    make_mesh,
    pad_to_multiple,
    put_row_sharded,
    sharded_cosine_topk,
)
from imageretrievalresearch_tpu_torch.retrieval import GalleryIndex

TOL = 1e-6
# G = 296 divides meshes of 1, 2 and 8 (shards of 296, 148 and 37 rows)
G, D, Q = 296, 32, 40
# exact duplicates of one row on both sides of every shard boundary of
# R = 8 and R = 2 (37 | 38, 147 | 148) and in the last shard
TIES = (36, 37, 147, 148, 290)


def _pm1_rows(rng, n, d=D):
    out = np.zeros((n, d), np.float32)
    for r in range(n):
        pos = rng.choice(d, 16, replace=False)
        out[r, pos] = rng.choice([-1.0, 1.0], 16)
    return out


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    g = rng.normal(size=(G, D)).astype(np.float32)
    q = _pm1_rows(rng, Q)
    # the first query close to the tied row, so the ties rank in its top-k
    g[5] = q[0] + 0.05 * rng.normal(size=D).astype(np.float32)
    g[list(TIES)] = g[5]
    return q, g


def _near_tie_equal(v, i, jv, ji, tol=TOL):
    """Values within ``tol``; where an index differs, JAX's score there
    lies within ``tol`` of the score next to it (a near-tie)."""
    v, i, jv, ji = map(np.asarray, (v, i, jv, ji))
    np.testing.assert_allclose(v, jv, rtol=0, atol=tol)
    k = v.shape[1]
    for r, j in zip(*np.nonzero(i != ji)):
        gaps = [abs(jv[r, j] - jv[r, n]) for n in (j - 1, j + 1)
                if 0 <= n < k]
        assert min(gaps) <= tol, (r, j, gaps)


def _prepared(g, mode):
    """The port's compact form of the gallery (torch), and JAX's view of
    the same bits (numpy / ml_dtypes), with the scales where int8."""
    if mode == "bfloat16":
        gb = R.l2_normalize(torch.from_numpy(g)).to(torch.bfloat16)
        bits = gb.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return (gb, None), (bits, None)
    codes, scales = R.quantize_rows_int8(R.l2_normalize(torch.from_numpy(g)))
    return (codes, scales), (codes.numpy(), scales.numpy())


# float32 raw, float32 with build-time norms, bf16 and int8 (prepared)
MODES = ["float32", "float32_norms", "bfloat16", "int8"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("r", [1, 2, 8])
def test_sharded_topk_matches_jax_and_unsharded_bitwise(data, r, mode):
    q, g = data
    k = 60
    dtype = "float32" if mode.startswith("float32") else mode
    if dtype == "float32":
        ours_g, jax_g = (torch.from_numpy(g), None), (g, None)
    else:
        ours_g, jax_g = _prepared(g, dtype)
    norms = (torch.linalg.vector_norm(torch.from_numpy(g), dim=1)
             if mode == "float32_norms" else None)
    kw = dict(matmul_dtype=dtype, gallery_norms=norms,
              gallery_scale=ours_g[1])
    v, i = sharded_cosine_topk(q, ours_g[0], k, Mesh(["cpu"] * r), **kw)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    assert v.shape == i.shape == (Q, k)
    # the port's unsharded query: bitwise, ties across shard boundaries
    # going to the lowest global index
    uv, ui = R.cosine_topk(torch.from_numpy(q), ours_g[0], k, **kw)
    assert torch.equal(v, uv) and torch.equal(i, ui)
    tied = np.isin(i.numpy(), TIES + (5,))
    assert tied.sum(axis=1).max() == len(TIES) + 1
    for row in i.numpy():
        pos = [p for p, x in enumerate(row) if x in TIES + (5,)]
        assert list(row[pos]) == sorted(row[pos])   # lowest index first
    jv, ji = jax_sharded(
        jnp.asarray(q), jnp.asarray(jax_g[0]), k, jax_mesh(8),
        matmul_dtype=dtype,
        gallery_norms=None if norms is None else jnp.asarray(norms.numpy()),
        gallery_scale=None if jax_g[1] is None else jnp.asarray(jax_g[1]))
    _near_tie_equal(v.numpy(), i.numpy(), jv, ji)


# (G, k): k within a shard, k > one shard's rows (G = 64 over 8: shards of
# 8, k = 16), k > G (clamped to G)
CASES = [(64, 5), (64, 16), (16, 99)]


@pytest.mark.parametrize("g_rows,k", CASES)
@pytest.mark.parametrize("use_fused", [None, True])
def test_sharded_fused_and_dense_match_jax(use_fused, g_rows, k):
    """``use_fused=True`` on CPU shards runs the kernels' plain version,
    against JAX's fused kernel in Pallas interpret mode per shard."""
    rng = np.random.default_rng(g_rows + k)
    q = _pm1_rows(rng, 12)
    g = rng.normal(size=(g_rows, D)).astype(np.float32)
    v, i = sharded_cosine_topk(q, g, k, Mesh(["cpu"] * 8),
                               use_fused=use_fused)
    kk = min(k, g_rows)
    assert v.shape == i.shape == (12, kk)
    uv, ui = R.cosine_topk(torch.from_numpy(q), torch.from_numpy(g), k)
    assert torch.equal(v, uv) and torch.equal(i, ui)
    if k > g_rows:
        assert sorted(i[0].tolist()) == list(range(g_rows))
    jv, ji = jax_sharded(jnp.asarray(q), jnp.asarray(g), k, jax_mesh(8),
                         use_fused=use_fused, interpret=bool(use_fused))
    _near_tie_equal(v.numpy(), i.numpy(), jv, ji)


def test_sharded_topk_checks_like_jax(data):
    q, g = data
    mesh = Mesh(["cpu"] * 8)
    norms = torch.linalg.vector_norm(torch.from_numpy(g), dim=1)
    with pytest.raises(ValueError, match="float32 mode only"):
        sharded_cosine_topk(q, g, 5, mesh, matmul_dtype="bfloat16",
                            gallery_norms=norms)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        sharded_cosine_topk(q, g[:290], 5, mesh)
    codes, scales = R.quantize_rows_int8(torch.from_numpy(g))
    with pytest.raises(ValueError, match="requires matmul_dtype='int8'"):
        sharded_cosine_topk(q, codes, 5, mesh, gallery_scale=scales)
    with pytest.raises(ValueError, match="precision='highest'"):
        sharded_cosine_topk(q, g, 5, mesh, matmul_dtype="int8",
                            precision="highest")
    with pytest.raises(ValueError, match="unknown matmul_dtype"):
        sharded_cosine_topk(q, g, 5, mesh, matmul_dtype="float16")


def test_mesh_placement_and_make_mesh(monkeypatch):
    mesh = Mesh(["cpu"] * 4)
    assert mesh.shape == {"data": 4} and mesh.axis_names == ("data",)
    host = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    sh = put_row_sharded(host, mesh)
    assert isinstance(sh, RowSharded) and sh.shape == (8, 3)
    assert sh.dtype == torch.float32 and len(sh.shards) == 4
    # each shard its own allocation: never a view of the host array or of
    # a whole device copy
    ptrs = {s.untyped_storage().data_ptr() for s in sh.shards}
    assert len(ptrs) == 4 and host.ctypes.data not in ptrs
    assert all(s.untyped_storage().nbytes() == 2 * 3 * 4 for s in sh.shards)
    np.testing.assert_array_equal(torch.cat(sh.shards).numpy(), host)
    with pytest.raises(ValueError, match="do not divide"):
        put_row_sharded(host[:7], mesh)
    with pytest.raises(ValueError):
        Mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


@pytest.mark.parametrize("b", [13, 16])
def test_pad_to_multiple_matches_jax(b):
    rng = np.random.default_rng(b)
    batch = {"qry": rng.random((b, 4, 4, 3)).astype(np.float32),
             "pos": [rng.random((b, 4, 4, 3)).astype(np.float32)],
             "neg": [rng.random((b, 4, 4, 3)).astype(np.float32)],
             "cat_idx": rng.integers(0, 4, b).astype(np.int32)}
    ours, n = pad_to_multiple(batch, 8)
    ref, rn = jax_pad(batch, 8)
    assert n == rn == b
    for key in ("qry", "cat_idx"):
        np.testing.assert_array_equal(ours[key], ref[key])
    for key in ("pos", "neg"):
        assert isinstance(ours[key], list)
        np.testing.assert_array_equal(ours[key][0], ref[key][0])
    assert ours["qry"].shape[0] == 16
    with pytest.raises(ValueError, match="ragged"):
        pad_to_multiple({"a": np.zeros(3), "b": np.zeros(4)}, 8)


def _index_pair(g, c):
    """A JAX and a port index over the same host embeddings (the port's
    normalization: the packages' may differ by an ulp)."""
    tidx = GalleryIndex(g.shape[1], device="cpu").add(g, c)
    jidx = JaxIndex(g.shape[1]).add(g, c)
    jidx._embeds = [tidx.embeddings.copy()]
    return jidx, tidx


INDEX_MODES = ["float32", "bfloat16", "int8"]


@pytest.mark.parametrize("mode", INDEX_MODES)
def test_sharded_index_drops_pad_rows(mode):
    """G = 9 over 8 shards (7 zero pad rows, three shards all pad) with
    every true similarity negative: a pad row's 0 would outrank them all."""
    rng = np.random.default_rng(3)
    u = _pm1_rows(rng, 1, 16)
    q = _pm1_rows(rng, 4, 16)
    q[:] = u
    q[1:, :4] = -q[1:, :4]
    g = (-u + 0.01 * rng.normal(size=(9, 16))).astype(np.float32)
    c = np.arange(9, dtype=np.int32)
    jidx, tidx = _index_pair(g, c)
    kw = dict(matmul_dtype=mode)
    ours = tidx.query(q, k=3, mesh=Mesh(["cpu"] * 8), **kw)
    vals, inds, cls = ours
    assert inds.max() < 9 and (vals < 0).all()
    for a, b in zip(ours, tidx.query(q, k=3, **kw)):
        np.testing.assert_array_equal(a, b)
    jv, ji, _ = jidx.query(q, k=3, mesh=jax_mesh(8), **kw)
    _near_tie_equal(vals, inds, jv, ji)
    dedup = tidx.query_class_dedup(q, k=5, num_unique=3,
                                   mesh=Mesh(["cpu"] * 8), **kw)
    for a, b in zip(dedup, tidx.query_class_dedup(q, k=5, num_unique=3,
                                                  **kw)):
        np.testing.assert_array_equal(a, b)
    assert dedup[1].max() < 9


@pytest.mark.parametrize("mode", INDEX_MODES)
@pytest.mark.parametrize("r", [2, 8])
def test_sharded_index_matches_single_device_and_jax(data, r, mode):
    """G = 290 over R shards (pad 0 or 6), each mode against its
    single-device query bitwise and against JAX's sharded index."""
    q, g = data
    g = g[:290]
    c = np.random.default_rng(2).integers(0, 12, 290).astype(np.int32)
    jidx, tidx = _index_pair(g, c)
    mesh = Mesh(["cpu"] * r)
    for k in (10, 150):
        ours = tidx.query(q, k=k, mesh=mesh, matmul_dtype=mode)
        for a, b in zip(ours, tidx.query(q, k=k, matmul_dtype=mode)):
            np.testing.assert_array_equal(a, b)
        assert ours[1].max() < 290
        jv, ji, _ = jidx.query(q, k=k, mesh=jax_mesh(8), matmul_dtype=mode)
        _near_tie_equal(ours[0], ours[1], jv, ji)
    dedup = tidx.query_class_dedup(q, k=150, mesh=mesh, matmul_dtype=mode)
    for a, b in zip(dedup, tidx.query_class_dedup(q, k=150,
                                                  matmul_dtype=mode)):
        np.testing.assert_array_equal(a, b)
    jd = jidx.query_class_dedup(q, k=150, mesh=jax_mesh(8),
                                matmul_dtype=mode)
    np.testing.assert_allclose(dedup[0], jd[0], rtol=0, atol=TOL)
    # each device holds only its padded row shard of the compact form
    form = tidx._gallery_on_device(mode, mesh)
    shard = -(-290 // r)
    assert all(isinstance(t, RowSharded) and len(t.shards) == r
               for t in form)
    assert all(s.shape[0] == shard for t in form for s in t.shards)
    assert form[0].dtype == {"float32": torch.float32,
                             "bfloat16": torch.bfloat16,
                             "int8": torch.int8}[mode]
    if len(form) > 1 and 290 % r:     # pad norms / scales are 1.0
        assert (form[1].shards[-1][290 - (r - 1) * shard:] == 1.0).all()
    assert (tidx._device_gallery.keys()
            >= {(mode, tuple(str(d) for d in mesh.devices))})


@pytest.mark.parametrize("k", [20, 150])
def test_gallery_topk_class_dedup_matches_jax_and_reference(rng, k):
    q = rng.normal(size=(24, 8)).astype(np.float32)
    g = rng.normal(size=(40, 8)).astype(np.float32)
    qcls = rng.integers(0, 6, size=(24,))
    gcls = rng.integers(0, 6, size=(40,))
    sims = np.array(JM.cosine_sim_matrix(q, g))
    ours = M.gallery_topk_class_dedup(torch.from_numpy(sims),
                                      torch.from_numpy(qcls),
                                      torch.from_numpy(gcls), k=k)
    ref = JM.gallery_topk_class_dedup(sims, qcls, gcls, k=k)
    assert set(ours) == set(ref)
    for key in ("topk_inds", "top_vals", "top_r_list"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]))
    # the fractions: means of the same hits, in f32 sums of another order
    for key in ("top1", "top3"):
        assert float(ours[key]) == pytest.approx(float(ref[key]), rel=1e-6)
    # the notebook's loop (tests/test_metrics.py's reference)
    top3 = top1 = 0
    for i in range(24):
        order = np.argsort(-sims[i], kind="stable")[:min(k, 40)]
        top_r = []
        for gi in order:
            if gcls[gi] not in top_r:
                top_r.append(int(gcls[gi]))
            if len(top_r) == 3:
                break
        top3 += int(qcls[i]) in top_r
        top1 += int(qcls[i]) == top_r[0]
    assert float(ours["top3"]) == pytest.approx(top3 / 24)
    assert float(ours["top1"]) == pytest.approx(top1 / 24)
