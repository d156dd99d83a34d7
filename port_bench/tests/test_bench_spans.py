"""The readers of the program's spans and counters, on the CPU: a trace
of the program under ``torch.profiler`` holds its spans as host
operators, which name the idle gaps where no operator does; a trace
without spans reads as before; each reader returns None where nothing was
recorded."""

from __future__ import annotations

import os
import tempfile

import numpy as np
import pytest
import torch

from port_bench import harness, spans
from port_bench.trace import Reading, Trace, read_chrome_trace

NEW = ("upload_ms.serve", "repair_share.serve", "index_idle_ms.serve",
       "model_idle_ms.train")


def _trace(host_ops, units=2):
    # device: 0-10, 30-40, 100-110; idle 10-30 and 40-100
    activity = [(0.0, 10.0), (30.0, 40.0), (100.0, 110.0)]
    kernels = [("k", s, e - s) for s, e in activity]
    return Trace(1e-4, units, kernels, activity, host_ops)


def test_a_gap_takes_the_innermost_span_where_no_operator_runs():
    ops = [("aten::mm", 12.0, 28.0)]
    bare = _trace(ops).breakdown()
    assert dict(bare["idle_gaps"]) == pytest.approx(
        {"aten::mm": 20e-6, "no host operator": 60e-6})
    got = _trace(ops + [("train.step", 0.0, 110.0),
                        ("train.forward", 5.0, 80.0),
                        ("train.backward", 80.0, 110.0)]).breakdown()
    assert dict(got["idle_gaps"]) == pytest.approx(
        {"aten::mm": 20e-6, "train.forward": 60e-6})
    assert got["device_ops"] == bare["device_ops"]


def test_idle_inside_spans_children_included():
    t = _trace([("index.query", 20.0, 120.0), ("index.fetch", 60.0, 80.0),
                ("engine.embed", 0.0, 19.0)])
    r = Reading(t)
    # both gaps' midpoints (20, 70) lie in index.query
    assert spans.idle_ms_per_unit(r, ["index.query"]) == pytest.approx(
        0.080 / 2)
    assert spans.idle_ms_per_unit(r, ["index.fetch"]) == pytest.approx(
        0.060 / 2)
    assert spans.idle_ms_per_unit(r, ["engine.embed"]) == 0.0
    assert spans.span_ms_per_unit(r, "index.fetch") == pytest.approx(0.010)


def test_readers_return_none_where_nothing_was_recorded(monkeypatch):
    from imageretrievalresearch_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "_COUNTS", {})
    for r in (Reading(None), Reading(_trace([("aten::mm", 12.0, 28.0)]))):
        for name in NEW:
            assert harness.load_reader(name)(r) is None, name


def test_repair_share_reads_the_program_counters(monkeypatch):
    from imageretrievalresearch_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "_COUNTS", {})
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("topk.rows", 128)
        profiling.count("topk.repaired_rows", 3)
        profiling.count("topk.fallback_rows", 64)
    got = harness.load_reader("repair_share.serve")(Reading(None))
    assert got == pytest.approx(100 * 67 / 128)


def test_the_programs_spans_reach_the_harness_trace(monkeypatch):
    """The engine and the index on the CPU under ``torch.profiler``, read
    back by the harness's own trace reader."""
    from imageretrievalresearch_tpu_torch.models import create_model
    from imageretrievalresearch_tpu_torch.retrieval import (
        GalleryIndex,
        RetrievalEngine,
    )
    from imageretrievalresearch_tpu_torch.utils import profiling
    rng = np.random.default_rng(5)
    engine = RetrievalEngine(create_model(
        "efficientnet_b3a", num_classes=5, width_mult=0.5, depth_mult=0.1,
        device="cpu", seed=1), device="cpu")
    images = rng.random((32, 32, 32, 3), dtype=np.float32)
    index = GalleryIndex(engine.embed_batch(images).shape[1], device="cpu")
    index.add(rng.normal(size=(300, index.dim)).astype(np.float32),
              rng.integers(0, 12, 300))
    monkeypatch.setattr(profiling, "_COUNTS", {})
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            index.query_class_dedup(engine.embed_batch(images), k=20,
                                    method="fused")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        t = read_chrome_trace(path, 1.0, 2)
    names = {n for n, _, _ in t.host_ops}
    assert {"engine.embed", "engine.upload", "engine.backbone",
            "index.query", "index.dedup", "index.fetch", "topk.kernel",
            "topk.certificate"} <= names
    r = Reading(t)
    assert harness.load_reader("upload_ms.serve")(r) > 0
    assert harness.load_reader("index_idle_ms.serve")(r) == 0.0  # no card
    assert harness.load_reader("repair_share.serve")(r) >= 0
    assert profiling.counts()["topk.rows"] == 64
