"""The port's profiling facility and profiling tool on the CPU.

``utils/profiling.py``: spans and counters (off, on, nested, in a trace,
at the engine's, the index's, the top-k's and the train step's
boundaries, and the profile stopped where its block or its sync
fails). The tool's kernels (the
ablation ladder of the fused top-k kernel and the row-block stream probe)
run only on the card; here their plain versions, which define what each
kernel computes, are held against restatements of the kernels' arithmetic
in numpy. JAX's ``build_variants`` (``tools/profile_fused_kernel.py:72``)
cannot serve as the reference on the CPU: it is hardwired to TPU memory
spaces and has no ``interpret`` flag (``:188-203``), so its kernels cannot
run here. Its probe body (``:275-289``) is plain enough to restate:
``acc += sum(x_block, axis=1)`` over the row blocks. The card's
comparisons are in ``tests/test_torch_cuda_kernels.py`` and
``chip_smoke.py``.
"""

import json
import time
import tracemalloc

import numpy as np
import pytest
import torch

from imageretrievalresearch_tpu_torch.models import create_model
from imageretrievalresearch_tpu_torch.ops import _cuda
from imageretrievalresearch_tpu_torch.ops import retrieval as R
from imageretrievalresearch_tpu_torch.ops.preprocess import (
    build_eval_transform,
)
from imageretrievalresearch_tpu_torch.recipes import make_config
from imageretrievalresearch_tpu_torch.retrieval import (
    GalleryIndex,
    RetrievalEngine,
)
from imageretrievalresearch_tpu_torch.tools import profile_fused_kernel as P
from imageretrievalresearch_tpu_torch.train.trainer import Trainer
from imageretrievalresearch_tpu_torch.utils import profiling as TP

BINS, DEPTH = R.FUSED_BINS, R.FUSED_T_DEPTH


@pytest.fixture
def no_counts(monkeypatch):
    """The program's counters, emptied for the test."""
    monkeypatch.setattr(TP, "_COUNTS", {})


def _profiling():
    return torch.autograd.profiler._is_profiler_enabled


def _spans(tmp_path):
    """(name, start µs, end µs) of the program's spans in the one trace
    file under ``tmp_path``, in start order; each is a host operator."""
    path, = tmp_path.glob("**/*.json")
    events = json.loads(path.read_text())["traceEvents"]
    got = [e for e in events if e.get("ph") == "X"
           and e["name"].split(".")[0] in ("a", "b", "t", "engine", "index",
                                           "topk", "train")]
    assert {e["cat"] for e in got} <= {"cpu_op"}
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in got),
                  key=lambda s: (s[1], -s[2]))


def _inside(spans, outer):
    """Names of the spans inside ``outer`` (a span of ``spans``), in start
    order."""
    _, s, e = outer
    return [n for n, a, b in spans if (n, a, b) != outer and s <= a
            and b <= e]


def test_span_off_is_one_shared_no_op(monkeypatch, no_counts):
    assert not _profiling()

    def forbidden(*a, **k):
        raise AssertionError("called with spans off")

    monkeypatch.setattr(TP, "_record", forbidden)
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    assert TP.span("a.b") is TP.span("c.d")
    for _ in range(10):
        with TP.span("a.b"):
            TP.count("a.n", 3)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in range(10_000):
            with TP.span("a.b"):
                TP.count("a.n", 3)
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 2048          # nothing kept per span
    assert TP.counts() == {}


def test_spans_nest_in_a_trace(tmp_path):
    with TP.trace(str(tmp_path)):
        with TP.span("a.outer"):
            with TP.span("a.inner"):
                with TP.span("a.leaf"):
                    time.sleep(0.002)
            with TP.span("a.inner"):
                pass
        with TP.span("b.outer"):
            pass
    got = _spans(tmp_path)
    assert [n for n, _, _ in got] == ["a.outer", "a.inner", "a.leaf",
                                      "a.inner", "b.outer"]
    outer, first, leaf, _, other = got
    assert _inside(got, outer) == ["a.inner", "a.leaf", "a.inner"]
    assert _inside(got, first) == ["a.leaf"]
    assert _inside(got, other) == []
    assert leaf[2] - leaf[1] >= 2000


def test_counters_add_up(no_counts):
    TP.count("x.calls")          # off: not counted
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        TP.count("x.calls")
        TP.count("x.rows", 64)
        TP.count("x.rows", 3)
        TP.count("x.calls")
    TP.count("x.rows", 5)
    assert TP.counts() == {"x.calls": 2, "x.rows": 67}


def test_trace_writes_a_chrome_trace(tmp_path):
    with TP.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert json.loads(files[0].read_text())["traceEvents"]
    assert len(prof.key_averages()) > 0


def test_a_trace_holds_the_spans(tmp_path):
    assert TP.span("t.outer") is TP.span("t.inner")
    with TP.trace(str(tmp_path / "trace")) as prof:
        assert TP.span("t.outer") is not TP.span("t.inner")
        with TP.span("t.outer"):
            with TP.span("t.inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    assert not _profiling()
    path, = (tmp_path / "trace").glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    named = {e["name"]: e for e in events if e.get("ph") == "X"}
    outer, inner = named["t.outer"], named["t.inner"]
    # the benchmark's trace reader keeps host operators only
    assert outer["cat"] == "cpu_op" and inner["cat"] == "cpu_op"
    assert outer["ts"] <= inner["ts"] and (inner["ts"] + inner["dur"]
                                           <= outer["ts"] + outer["dur"])
    assert named["aten::mm"]["ts"] >= inner["ts"]
    assert len(prof.key_averages()) > 0


def test_trace_stops_without_a_sync_when_its_block_fails(monkeypatch,
                                                          tmp_path):
    """A block that failed on the card must not fail again in the sync:
    the profile stops, and spans are off after it."""
    def fails(*a, **k):
        raise RuntimeError("the card failed again")

    with pytest.raises(ValueError, match="the block"):
        with TP.trace(str(tmp_path)):
            monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
            monkeypatch.setattr(torch.cuda, "synchronize", fails)
            raise ValueError("the block")
    assert not _profiling() and TP.span("a.b") is TP.span("c.d")
    assert not list(tmp_path.glob("*.json"))


def test_stop_stops_the_profile_when_the_sync_fails(monkeypatch):
    def fails(*a, **k):
        raise RuntimeError("the sync")

    prof = TP.start()
    assert _profiling()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", fails)
    with pytest.raises(RuntimeError, match="the sync"):
        TP.stop(prof)
    assert not _profiling() and TP.span("a.b") is TP.span("c.d")


def _ok(q, bad):
    ok = torch.ones(q, dtype=torch.int32)
    ok[list(bad)] = 0
    return ok


def test_certificate_counts_repairs_and_fallbacks(rng, no_counts,
                                                  tmp_path):
    qh = R.l2_normalize(torch.from_numpy(
        rng.normal(size=(80, 16)).astype(np.float32)))
    g = torch.from_numpy(rng.normal(size=(300, 16)).astype(np.float32))
    vals, inds = R._dense_topk(qh, g, 5, "float32")
    calls = []

    def full():
        calls.append(1)
        return vals, inds

    with TP.trace(str(tmp_path)):
        v, i = R.certified_topk_repair(qh, g, 5, vals, inds, _ok(80, ()),
                                       full_fallback=full)
        assert v is vals and TP.counts() == {"topk.rows": 80}
        v, i = R.certified_topk_repair(qh, g, 5, vals * 0, inds * 0,
                                       _ok(80, (3, 41)), full_fallback=full)
        torch.testing.assert_close(v[[3, 41]], vals[[3, 41]])
        assert TP.counts() == {"topk.rows": 160, "topk.repaired_rows": 2}
        R.certified_topk_repair(qh, g, 5, vals, inds, _ok(80, range(65)),
                                full_fallback=full)
    assert calls == [1]
    assert TP.counts() == {"topk.rows": 240, "topk.repaired_rows": 2,
                           "topk.fallback_rows": 80}
    assert [n for n, _, _ in _spans(tmp_path)] == ["topk.certificate"] * 3


def test_engine_and_index_spans(rng, no_counts, tmp_path):
    model = create_model("efficientnet_b3a", num_classes=5, width_mult=0.5,
                         depth_mult=0.1, device="cpu", seed=1)
    engine = RetrievalEngine(model, device="cpu", transform=(
        build_eval_transform("squarepad", 32, device="cpu")))
    images = rng.integers(0, 256, (32, 40, 40, 3), dtype=np.uint8)
    index = GalleryIndex(engine.embed_batch(images).shape[1], device="cpu")
    index.add(rng.normal(size=(300, index.dim)).astype(np.float32),
              rng.integers(0, 12, 300))
    with TP.trace(str(tmp_path)):
        emb = engine.embed_batch(images)
        index.query_class_dedup(emb, k=20, num_unique=3, method="fused")
        index.query(emb, k=20)
    got = _spans(tmp_path)
    tops = [s for s in got if s[0] in ("engine.embed", "index.query")]
    assert [n for n, _, _ in tops] == ["engine.embed", "index.query",
                                       "index.query"]
    embed, query, query2 = (_inside(got, s) for s in tops)
    assert embed == ["engine.upload", "engine.transform", "engine.backbone"]
    assert query == ["topk.kernel", "topk.certificate", "index.dedup",
                     "index.fetch"]
    assert query2 == ["index.fetch"]
    assert len(got) == 3 + len(embed) + len(query) + len(query2)
    assert TP.counts() == {"topk.rows": 32}


def test_train_step_spans(rng, tmp_path):
    cfg = make_config("train_efficient_cos_con_ce_loss", batch_size=4,
                      image_size=32, compute_dtype="float32", device="cpu")
    model = create_model("efficientnet_b3a", num_classes=5, width_mult=0.5,
                         depth_mult=0.1, device="cpu", seed=1)
    trainer = Trainer(cfg, model, [None])
    state = trainer.init_state()

    def u8():
        return rng.integers(0, 256, (4, 40, 40, 3), dtype=np.uint8)

    raw = {"qry": u8(), "pos": [u8()], "neg": [u8()],
           "cat_idx": rng.integers(0, 5, 4), "prod_idx": rng.integers(0, 5, 4)}
    gens = trainer._generators(0)
    trainer.train_batch(state, raw, gens)
    with TP.trace(str(tmp_path)):
        trainer.train_batch(state, raw, gens)
    got = _spans(tmp_path)
    assert got[0][0] == "train.step"
    assert _inside(got, got[0]) == [
        "train.transform", "train.forward", "train.optimizer",
        "train.backward", "train.optimizer", "train.metrics"]
    assert len(got) == 7


class _Loader(list):
    def set_epoch(self, epoch):
        pass


def test_trainer_profile_dir_traces_steps_one_to_three(rng, tmp_path):
    cfg = make_config("train_efficient_cos_con_ce_loss", batch_size=4,
                      image_size=32, compute_dtype="float32", device="cpu",
                      profile_dir=str(tmp_path / "profile"))
    model = create_model("efficientnet_b3a", num_classes=5, width_mult=0.5,
                         depth_mult=0.1, device="cpu", seed=1)

    def u8():
        return rng.integers(0, 256, (4, 40, 40, 3), dtype=np.uint8)

    loader = _Loader({"qry": u8(), "pos": [u8()], "neg": [u8()],
                      "cat_idx": rng.integers(0, 5, 4),
                      "prod_idx": rng.integers(0, 5, 4)} for _ in range(5))
    trainer = Trainer(cfg, model, loader)
    trainer.train_epoch(trainer.init_state(), 0)
    assert not _profiling()
    assert (tmp_path / "profile" / "trace.json").exists()
    names = [n for n, _, _ in _spans(tmp_path / "profile")]
    assert names.count("train.step") == 3
    assert names.count("train.optimizer") == 6


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
    codes, scales = R.quantize_rows_int8(R.l2_normalize(g))
    with _cuda.ledger() as launched:
        for gallery, gs in ((g, None),
                            (R.l2_normalize(g).to(torch.bfloat16), None),
                            (codes, scales)):
            for name, rung in variants.items():
                got, want = rung.kernel(qh, gallery, 20, gallery_scale=gs), \
                    rung.plain(qh, gallery, 20, splits=1, gallery_scale=gs)
                for a, b in zip(got if isinstance(got, tuple) else (got,),
                                want if isinstance(want, tuple) else (want,)):
                    np.testing.assert_array_equal(a.numpy(), b.numpy())
        full = variants["full"].kernel(qh, g, 20)
        for a, b in zip(full, R.fused_cosine_topk(qh, g, 20)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not launched
    with pytest.raises(ValueError, match="float32 .* or bfloat16"):
        variants["stream_only"].kernel(qh, g.to(torch.float16), 20)
    with pytest.raises(ValueError, match="gallery_scale"):
        variants["stream_only"].kernel(qh, codes, 20)
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


def _bf16_words(a):
    """bf16 values as f32 numpy (exact)."""
    return a.float().numpy()


def _bf16_stream_kernel_order(qb, gb, n_split):
    """The bf16 split kernel's stream_only rung restated in numpy f32, in
    its order: per split, per tile, per ring stage of 64 words, the thread
    of (tile row r, chunk c) adds (its q chunk's tree sum + its gallery
    chunk's tree sum) to its running sum (8 words a chunk, summed as
    ((w0+w1)+(w2+w3))+((w4+w5)+(w6+w7))); then the 8 threads of a row
    fold by xor 1, 2, 4. Words past D, Q and G are zero."""
    q, d = qb.shape
    g = gb.shape[0]
    nk = -(-d // 64)
    tiles = -(-g // BINS)
    qp = np.zeros((BINS, nk * 64), np.float32)
    qp[:q, :d] = qb
    gp = np.zeros((tiles * BINS, nk * 64), np.float32)
    gp[:g, :d] = gb

    def tree(chunks):                        # (..., 8) -> (...)
        p = chunks[..., 0::2] + chunks[..., 1::2]
        return (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])

    out = np.zeros((q, n_split), np.float32)
    for sp in range(n_split):
        acc = np.zeros((BINS, 8), np.float32)
        for t in _tiles_of(sp, n_split, g):
            for kc in range(nk):
                cols = slice(kc * 64, kc * 64 + 64)
                tq = tree(qp[:, cols].reshape(BINS, 8, 8))
                tg = tree(gp[t * BINS:(t + 1) * BINS, cols].reshape(
                    BINS, 8, 8))
                acc = acc + (tq + tg)
        for off in (1, 2, 4):
            acc = acc + acc[:, np.arange(8) ^ off]
        out[:, sp] = acc[:q, 0]
    return out


def test_ladder_bf16_stream_only_within_its_bound_in_kernel_order(rng):
    """The bf16 stream_only rung's plain version (exact sums) against the
    kernel's f32 order restated: bitwise on ±1 words, and within
    stream_only_rtol(..., bf16) of the sum of |words| on float words, at
    a D that is not a multiple of 8."""
    qh, g = _pm1_case(rng, q=10, g=700, d=40)
    gb = R.l2_normalize(g).to(torch.bfloat16)
    qb = qh.to(torch.bfloat16)
    want = P.stream_only_reference(qh, gb, 20, splits=3).numpy()
    got = _bf16_stream_kernel_order(_bf16_words(qb), _bf16_words(gb), 3)
    np.testing.assert_array_equal(got, want)
    qf = torch.from_numpy(rng.normal(size=(10, 100)).astype(np.float32))
    gf = torch.from_numpy(rng.normal(size=(700, 100)).astype(np.float32))
    gb = gf.to(torch.bfloat16)
    want = P.stream_only_reference(qf, gb, 20, splits=3).numpy()
    scale = P.stream_only_reference(qf.abs(), gb.abs(), 20,
                                    splits=3).numpy()
    got = _bf16_stream_kernel_order(_bf16_words(qf.to(torch.bfloat16)),
                                    _bf16_words(gb), 3)
    rtol = P.stream_only_rtol(700, 100, 3, torch.bfloat16)
    assert (np.abs(got - want) <= rtol * scale).all()
    assert 0 < P.stream_only_rtol(100_000, 1536, 132, torch.bfloat16) < 1e-4


def _tree4(w):                               # (..., 4) -> (...), f32
    return (w[..., 0] + w[..., 1]) + (w[..., 2] + w[..., 3])


def _f32_stream_kernel_order(qa, ga, na, n_split):
    """The f32 stream_only rung (the F32 instance of the tensor-core kernel)
    restated in numpy f32, in its order. Per split, per tile in index
    order, per stage of 32 words (8 chunks of 4, chunk c of row r stored
    at c ^ (r % 8)): the consumer thread of (row r, chunk c) adds the tree
    sum of q̂'s chunk c; the converter thread of (row r, half h) adds, at
    the tile's first stage and for h = 0, the row's norm, then per stage
    the sum of the tree sums of the gallery chunks stored at 2h and 2h + 1.
    The consumers fold by xor 1, 2, 4, the converters by xor 1, 2, and a
    row's sum is q̂'s part + the gallery's. Words past D, Q and G are 0."""
    q, d = qa.shape
    g = ga.shape[0]
    nk = -(-d // 32)
    tiles = -(-g // BINS)
    qp = np.zeros((BINS, nk * 32), np.float32)
    qp[:q, :d] = qa
    gp = np.zeros((tiles * BINS, nk * 32), np.float32)
    gp[:g, :d] = ga
    norms = np.zeros(tiles * BINS, np.float32)
    norms[:g] = na
    rows = np.arange(BINS)
    # the logical chunks the converter halves read, stage by stage
    stored = (np.arange(8)[None, :] ^ (rows[:, None] & 7))  # (row, place)
    out = np.zeros((q, n_split), np.float32)
    for sp in range(n_split):
        qs = np.zeros((BINS, 8), np.float32)
        gs = np.zeros((BINS, 4), np.float32)
        for t in _tiles_of(sp, n_split, g):
            gs[:, 0] = gs[:, 0] + norms[t * BINS:(t + 1) * BINS]
            for kc in range(nk):
                cols = slice(kc * 32, kc * 32 + 32)
                qs = qs + _tree4(qp[:, cols].reshape(BINS, 8, 4))
                chunks = _tree4(gp[t * BINS:(t + 1) * BINS, cols].reshape(
                    BINS, 8, 4))
                by_place = np.take_along_axis(chunks, stored, axis=1)
                gs = gs + (by_place[:, 0::2] + by_place[:, 1::2])
        for off in (1, 2, 4):
            qs = qs + qs[:, np.arange(8) ^ off]
        for off in (1, 2):
            gs = gs + gs[:, np.arange(4) ^ off]
        out[:, sp] = (qs[:, 0] + gs[:, 0])[:q]
    return out


def test_ladder_f32_stream_only_within_its_bound_in_kernel_order(rng):
    """The f32 stream_only rung's plain version (exact sums) against the
    kernel's f32 order restated: bitwise on ±1 words, within
    stream_only_rtol of the sum of |words| on float words (with norms), at
    a D that is not a multiple of 32 and a ragged last tile."""
    qh, g = _pm1_case(rng, q=10, g=700, d=40)
    norms = torch.linalg.vector_norm(g, dim=1)
    want = P.stream_only_reference(qh, g, 20, gallery_norms=norms,
                                   splits=3).numpy()
    got = _f32_stream_kernel_order(qh.numpy(), g.numpy(), norms.numpy(), 3)
    np.testing.assert_array_equal(got, want)
    qf = torch.from_numpy(rng.normal(size=(10, 100)).astype(np.float32))
    gf = torch.from_numpy(rng.normal(size=(700, 100)).astype(np.float32))
    nf = torch.linalg.vector_norm(gf, dim=1)
    want = P.stream_only_reference(qf, gf, 20, gallery_norms=nf,
                                   splits=3).numpy()
    scale = P.stream_only_reference(qf.abs(), gf.abs(), 20,
                                    gallery_norms=nf, splits=3).numpy()
    got = _f32_stream_kernel_order(qf.numpy(), gf.numpy(), nf.numpy(), 3)
    rtol = P.stream_only_rtol(700, 100, 3)
    assert (np.abs(got - want) <= rtol * scale).all()
    assert (np.abs(got - want) > 0).any()     # float data: not exact


@pytest.mark.parametrize("splits,k", [(1, 150), (3, 384)])
def test_ladder_bf16_insert_only_is_the_insertion_chain(rng, splits, k):
    """The bf16 rung's plain version is the chain run on the bf16 scores
    (q̂ rounded to bf16 against the bf16 rows, f32 sums), as the kernel's
    16-bit tile ordinals decode: index = (ordinal x S + split) x BINS +
    bin, empty slots (-inf, 0)."""
    qh, g = _pm1_case(rng)
    gb = R.l2_normalize(g).to(torch.bfloat16)
    s = R.dense_scores(qh, gb, "bfloat16").numpy()
    bv, bi = _insertion_chain(s, splits)
    v, i = P.insert_only_reference(qh, gb, k, splits=splits)
    np.testing.assert_array_equal(v.numpy(),
                                  bv.reshape(10, splits, -1)[..., :k])
    np.testing.assert_array_equal(i.numpy(),
                                  bi.reshape(10, splits, -1)[..., :k])
    filled = np.isfinite(bv)
    ordinal = bi // (BINS * splits)
    assert (ordinal[filled] < R.MAX_TILE_ORDINALS).all()
    for sp in range(splits):
        lanes = bi[:, sp][filled[:, sp]]
        assert ((lanes // BINS) % splits == sp).all()
    assert (bi[~filled] == 0).all()


def test_ladder_int8_rungs_restate_the_tensor_core_kernel(rng):
    """The int8 rungs' plain versions (the port's own ladder; JAX's tool
    has none): stream_only is the exact sum of the codes each tile loads
    (q̂'s codes, the tile row's codes), an integer that the kernel sums in
    int32, so the two are equal; matmul_only is each split's max of the
    dense int8 scores ((float)dot * (qs * gs)); insert_only is the
    insertion chain on them."""
    qh, g = _pm1_case(rng)
    codes, scales = R.quantize_rows_int8(R.l2_normalize(g))
    qc = R.quantize_rows_int8(qh)[0].numpy().astype(np.int64)
    gc = codes.numpy().astype(np.int64)
    got = P.stream_only_reference(qh, codes, 20, splits=3).numpy()
    for sp in range(3):
        for r in range(10):
            want = sum(int(qc[r].sum()) + (int(gc[t * BINS + r].sum())
                                           if t * BINS + r < 700 else 0)
                       for t in _tiles_of(sp, 3, 700))
            assert got[r, sp] == np.float32(want)
    assert P.stream_only_rtol(100_000, 1536, 132, torch.int8) == 0.0
    s = R.dense_scores(qh, codes, "int8", gallery_scale=scales).numpy()
    got = P.matmul_only_reference(qh, codes, 20, splits=3,
                                  gallery_scale=scales).numpy()
    for sp in range(3):
        cols = np.concatenate([np.arange(t * BINS, min((t + 1) * BINS, 700))
                               for t in _tiles_of(sp, 3, 700)])
        np.testing.assert_array_equal(got[:, sp], s[:, cols].max(axis=1))
    bv, bi = _insertion_chain(s, 3)
    v, i = P.insert_only_reference(qh, codes, 150, splits=3,
                                   gallery_scale=scales)
    np.testing.assert_array_equal(v.numpy(), bv.reshape(10, 3, -1)[..., :150])
    np.testing.assert_array_equal(i.numpy(), bi.reshape(10, 3, -1)[..., :150])
