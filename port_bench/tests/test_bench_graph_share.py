"""The reader of the train step's graph counters, on the CPU: the share of
replayed steps among the traced slice's steps, None where the program
counted no step (a program without the counters reads so too)."""

from __future__ import annotations

import pytest
import torch

from port_bench import harness
from port_bench.trace import Reading


def test_graph_share_reads_the_program_counters(monkeypatch):
    from imageretrievalresearch_tpu_torch.utils import profiling
    read = harness.load_reader("graph_share.train")
    monkeypatch.setattr(profiling, "_COUNTS", {})
    assert read(Reading(None)) is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("train.graph_captures")
        profiling.count("train.eager_steps")
        for _ in range(3):
            profiling.count("train.graph_replays")
    assert read(Reading(None)) == pytest.approx(75.0)
    monkeypatch.setattr(profiling, "_COUNTS", {"train.eager_steps": 5})
    assert read(Reading(None)) == 0.0
