"""The port's profiling helpers and profiling tool on the CPU.

``utils/profiling.py`` is held against the JAX package's. The tool's
kernels (the ablation ladder of the fused top-k kernel and the row-block
stream probe) run only on the card; here their plain versions, which
define what each kernel computes, are held against restatements of the
kernels' arithmetic in numpy. JAX's ``build_variants``
(``tools/profile_fused_kernel.py:72``) cannot serve as the reference on
the CPU: it is hardwired to TPU memory spaces and has no ``interpret``
flag (``:188-203``), so its kernels cannot run here. Its probe body
(``:275-289``) is plain enough to restate: ``acc += sum(x_block, axis=1)``
over the row blocks. The card's comparisons are in
``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``.
"""

import json
import time

import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu.utils import profiling as JP
from imageretrievalresearch_tpu_torch.ops import retrieval as R
from imageretrievalresearch_tpu_torch.tools import profile_fused_kernel as P
from imageretrievalresearch_tpu_torch.utils import profiling as TP

BINS, DEPTH = R.FUSED_BINS, R.FUSED_T_DEPTH


def test_step_timer_matches_jax(monkeypatch):
    clock = [0.0, 0.010, 0.025, 0.026, 0.050, 0.090, 0.093]
    timers = {}
    for name, module in (("jax", JP), ("port", TP)):
        ticks = iter(clock)
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        timer = module.StepTimer(window=3)
        assert timer.mean_ms == 0.0 and timer.throughput(64) == 0.0
        timers[name] = ([timer.tick() for _ in clock], timer.times,
                        timer.mean_ms, timer.throughput(64))
    assert timers["port"] == timers["jax"]
    dts, times, mean_ms, _ = timers["port"]
    assert dts[0] is None and len(times) == 3
    assert mean_ms == pytest.approx(1000 * (0.024 + 0.040 + 0.003) / 3)


def test_trace_writes_a_chrome_trace(tmp_path):
    with TP.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert json.loads(files[0].read_text())["traceEvents"]
    assert len(prof.key_averages()) > 0


def _pm1_case(rng, q=10, g=700, d=32):
    """Rows of 16 entries of ±1 (norm 4), with duplicated rows: exact
    scores with ties, so tie order matters."""
    def rows(n):
        out = np.zeros((n, d), np.float32)
        for r in range(n):
            out[r, rng.choice(d, 16, replace=False)] = rng.choice([-1, 1], 16)
        return out
    qa, ga = rows(q), rows(g)
    ga[130] = ga[2]
    ga[650] = ga[2]
    return R.l2_normalize(torch.from_numpy(qa)), torch.from_numpy(ga)


def _tiles_of(split, n_split, g):
    return [t for t in range(-(-g // BINS)) if t % n_split == split]


def _insertion_chain(s, n_split):
    """The split kernel's insertion chain, restated: each split walks its
    tiles in index order, and each score sinks below stored values that
    are >= it."""
    q, g = s.shape
    bv = np.full((q, n_split, DEPTH, BINS), -np.inf, np.float32)
    bi = np.zeros((q, n_split, DEPTH, BINS), np.int32)
    for t in range(-(-g // BINS)):
        sp = t % n_split
        for b in range(min(BINS, g - t * BINS)):
            v, vi = s[:, t * BINS + b].copy(), np.full(q, t * BINS + b)
            for d in range(DEPTH):
                ov, oi = bv[:, sp, d, b].copy(), bi[:, sp, d, b].copy()
                take = v > ov
                bv[:, sp, d, b] = np.where(take, v, ov)
                bi[:, sp, d, b] = np.where(take, vi, oi)
                v, vi = np.where(take, ov, v), np.where(take, oi, vi)
    return bv, bi


@pytest.mark.parametrize("splits,k", [(1, 150), (3, 20), (11, 384)])
def test_ladder_insert_only_is_the_insertion_chain(rng, splits, k):
    qh, g = _pm1_case(rng)
    s = R.dense_scores(qh, g).numpy()
    bv, bi = _insertion_chain(s, splits)
    v, i = P.insert_only_reference(qh, g, k, splits=splits)
    assert tuple(v.shape) == tuple(i.shape) == (10, splits, k)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(v.numpy(), bv.reshape(10, splits, -1)[..., :k])
    np.testing.assert_array_equal(i.numpy(), bi.reshape(10, splits, -1)[..., :k])
    # the same buffers as the plain fused top-k's (ops.retrieval)
    rv, ri = R._bin_buffers(R.dense_scores(qh, g), BINS, DEPTH, splits)
    np.testing.assert_array_equal(v.numpy(), rv.reshape(10, splits, -1)[..., :k])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ladder_matmul_only_is_the_split_max(rng, dtype):
    qh, g = _pm1_case(rng)
    g = g * torch.arange(1, 701, dtype=torch.float32)[:, None] / 700
    if dtype == torch.bfloat16:
        g = R.l2_normalize(g).to(dtype)
    s = R.dense_scores(qh, g, "float32" if dtype == torch.float32
                       else "bfloat16").numpy()
    got = P.matmul_only_reference(qh, g, 20, splits=3).numpy()
    for sp in range(3):
        cols = np.concatenate([np.arange(t * BINS, min((t + 1) * BINS, 700))
                               for t in _tiles_of(sp, 3, 700)])
        np.testing.assert_array_equal(got[:, sp], s[:, cols].max(axis=1))


def test_ladder_stream_only_sums_every_loaded_word(rng):
    qh, g = _pm1_case(rng)
    norms = torch.linalg.vector_norm(g, dim=1) * 2     # not the rows' norms
    got = P.stream_only_reference(qh, g, 20, gallery_norms=norms,
                                  splits=3).numpy()
    qa, ga, na = qh.numpy(), g.numpy(), norms.numpy()
    for sp in range(3):
        for r in range(10):
            want = 0.0
            for t in _tiles_of(sp, 3, 700):
                row = t * BINS + r % BINS
                want += qa[r].sum() + (ga[row].sum() + na[row]
                                       if row < 700 else 0.0)
            assert got[r, sp] == np.float32(want)
    # bf16: the words are q̂ rounded to bf16 and the bf16 rows; no norms
    gb = R.l2_normalize(g).to(torch.bfloat16)
    got = P.stream_only_reference(qh, gb, 20, splits=1).numpy()
    qb = qh.to(torch.bfloat16).double().numpy()
    gsum = gb.double().numpy().sum(axis=1)
    want = [11 * qb[r].sum() + gsum[r::BINS].sum() for r in range(10)]
    np.testing.assert_array_equal(got[:, 0], np.float32(want))
    assert 0 < P.stream_only_rtol(100_000, 1536, 132) < 1e-4


def test_ladder_wrappers_on_cpu_run_their_plain_versions(rng):
    qh, g = _pm1_case(rng, q=40, g=2100)
    variants = P.build_variants()
    assert list(variants) == ["stream_only", "matmul_only", "insert_only",
                              "full"]
    for gallery in (g, R.l2_normalize(g).to(torch.bfloat16)):
        for name, rung in variants.items():
            got, want = rung.kernel(qh, gallery, 20), rung.plain(
                qh, gallery, 20, splits=1)
            for a, b in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
    full = variants["full"].kernel(qh, g, 20)
    for a, b in zip(full, R.fused_cosine_topk(qh, g, 20)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not any(P.KERNEL_LAUNCHES.values())
    with pytest.raises(ValueError, match="float32 .* or bfloat16"):
        variants["stream_only"].kernel(qh, g.to(torch.int8), 20)
    with pytest.raises(ValueError, match="k="):
        variants["insert_only"].kernel(qh, g, DEPTH * BINS + 1)


def _jax_probe_body(x, rows):
    """tools/profile_fused_kernel.py:275-289 in numpy: for each grid step
    i, acc += sum(x[i * rows:(i + 1) * rows], axis=1)."""
    acc = np.zeros((rows, 1), np.float32)
    for i in range(x.shape[0] // rows):
        acc += np.sum(x[i * rows:(i + 1) * rows], axis=1, keepdims=True)
    return acc[:, 0]


@pytest.mark.parametrize("n,d,rows", [(2048, 64, 256), (1536, 37, 512),
                                      (2048, 16, 2048)])
def test_stream_probe_plain_matches_the_jax_probe_body(rng, n, d, rows):
    ints = rng.integers(-3, 4, (n, d)).astype(np.float32)
    got = P.stream_probe(torch.from_numpy(ints), rows)
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows,)
    np.testing.assert_array_equal(got.numpy(), _jax_probe_body(ints, rows))
    x = rng.normal(size=(n, d)).astype(np.float32)
    got = P.stream_probe_reference(torch.from_numpy(x), rows).numpy()
    scale = _jax_probe_body(np.abs(x), rows)
    assert (np.abs(got - _jax_probe_body(x, rows))
            <= P.stream_probe_rtol(n, d, rows) * scale).all()
    with pytest.raises(ValueError, match="multiple of"):
        P.stream_probe(torch.from_numpy(x), rows + 1)


def test_tool_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.main([])
    assert P.G_PAD == 100_352 and P.G_PAD % max(P.PROBE_ROWS) == 0
