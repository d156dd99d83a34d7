"""The readers of the Swin window attention kernel's metrics, on the CPU:
``attn_fused_share.serve`` from the program's path counters and
``window_attn_roofline.serve`` from the score counter and the kernel's
device time; both None where the program counts nothing (a program
without the kernel or its counters reads so), and the roofline None
where any attention call of the slice was eager. The bound reproduces
the request's 137 GFLOP, 2.05 ms at 64 images of Swin-S3-B."""

from __future__ import annotations

import pytest
import torch

from port_bench import harness
from port_bench.trace import Reading, Trace
from port_bench.work import counts, window_attn

NEW = ("attn_fused_share.serve", "window_attn_roofline.serve")
KERNEL = ("void (anonymous namespace)::window_attn_softmax_kernel<25>("
          "float const*, float const*, int const*, float const*, float*, "
          "(anonymous namespace)::Geom, float)")


def _trace(kernels):
    activity = [(s, s + d) for _, s, d in kernels]
    return Trace(1e-4, 2, kernels, activity, [])


def _count(profiling, **calls):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for name, n in calls.items():
            profiling.count(name.replace("_", ".", 1), n)


@pytest.mark.parametrize("name", NEW)
def test_readers_return_none_where_nothing_was_counted(monkeypatch, name):
    from imageretrievalresearch_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "_COUNTS", {})
    read = harness.load_reader(name)
    bare = _trace([(KERNEL, 0.0, 10.0), ("softmax_warp_forward", 20.0, 5.0)])
    for r in (Reading(None), Reading(bare, peaks=counts.peaks())):
        assert read(r) is None
    # the parent's counters: scores, but no path counters
    monkeypatch.setattr(profiling, "_COUNTS", {"swin.attn_scores": 10 ** 9})
    assert read(Reading(bare, peaks=counts.peaks())) is None


def test_fused_share_reads_the_path_counters(monkeypatch):
    from imageretrievalresearch_tpu_torch.utils import profiling
    read = harness.load_reader("attn_fused_share.serve")
    monkeypatch.setattr(profiling, "_COUNTS", {})
    _count(profiling, swin_attn_fused=36)
    assert read(Reading(None)) == 100.0
    _count(profiling, swin_attn_fused=36, swin_attn_eager=24)
    assert read(Reading(None)) == pytest.approx(100 * 72 / 96)
    monkeypatch.setattr(profiling, "_COUNTS", {"swin.attn_eager": 5})
    assert read(Reading(None)) == 0.0


def test_roofline_reads_the_kernels_time_against_the_scores(monkeypatch):
    from imageretrievalresearch_tpu_torch.utils import profiling
    read = harness.load_reader("window_attn_roofline.serve")
    peaks = counts.peaks()
    t = _trace([(KERNEL, 0.0, 30.0), ("gemm", 40.0, 50.0),
                (KERNEL.replace("<25>", "<7>"), 100.0, 10.0)])
    monkeypatch.setattr(profiling, "_COUNTS", {
        "swin.attn_scores": 10 ** 6, "swin.attn_fused": 4})
    assert read(Reading(t, peaks=peaks)) == pytest.approx(
        100 * 128e6 / peaks["float32_flops"] / 40e-6)
    # an eager call in the slice: its scores are not the kernel's
    monkeypatch.setattr(profiling, "_COUNTS", {
        "swin.attn_scores": 10 ** 6, "swin.attn_fused": 4,
        "swin.attn_eager": 1})
    assert read(Reading(t, peaks=peaks)) is None


def test_bound_of_a_swin_s3_base_request():
    # score entries of one 224 px image: (windows, heads, N) a block call
    # per stage, times its blocks
    per_image = (2 * 64 * 3 * 49 ** 2 + 2 * 4 * 6 * 196 ** 2
                 + 30 * 12 * 196 ** 2 + 2 * 24 * 49 ** 2)
    scores = 64 * per_image
    assert scores == pytest.approx(1.07e9, rel=0.005)
    assert window_attn.flops(scores) == pytest.approx(137e9, rel=0.005)
    assert window_attn.bound_s(scores) == pytest.approx(2.05e-3, rel=0.005)
