"""The readers of the Swin MLP kernel's metrics, on the CPU:
``mlp_fused_share.serve`` from the program's path counters and
``mlp_gemm_roofline.serve`` from the multiply-add counter and the linear
kernel's device time; both None where the program counts nothing (a
program without the kernel or its counters reads so), and the roofline
None where any MLP call of the slice was eager. The bound reproduces the
request's 1.066 TFLOP, 6.46 ms at 64 images of Swin-S3-B."""

from __future__ import annotations

import pytest
import torch

from port_bench import harness
from port_bench.trace import Reading, Trace
from port_bench.work import counts, swin_mlp

NEW = ("mlp_fused_share.serve", "mlp_gemm_roofline.serve")
KERNEL = ("(anonymous namespace)::linear_tf32x3_kernel(CUtensorMap_st, "
          "CUtensorMap_st, CUtensorMap_st, float const*, float*, int, int, "
          "int, int)")
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8_stage3"


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
    bare = _trace([(KERNEL, 0.0, 10.0), (GEMM, 20.0, 5.0)])
    for r in (Reading(None), Reading(bare, peaks=counts.peaks())):
        assert read(r) is None
    # the parent's counters: the attention's, none of the MLP
    monkeypatch.setattr(profiling, "_COUNTS", {"swin.attn_fused": 36,
                                               "swin.attn_scores": 10 ** 9})
    assert read(Reading(bare, peaks=counts.peaks())) is None


def test_fused_share_reads_the_path_counters(monkeypatch):
    from imageretrievalresearch_tpu_torch.utils import profiling
    read = harness.load_reader("mlp_fused_share.serve")
    monkeypatch.setattr(profiling, "_COUNTS", {})
    _count(profiling, swin_mlp_fused=36)
    assert read(Reading(None)) == 100.0
    _count(profiling, swin_mlp_fused=36, swin_mlp_eager=24)
    assert read(Reading(None)) == pytest.approx(100 * 72 / 96)
    monkeypatch.setattr(profiling, "_COUNTS", {"swin.mlp_eager": 5})
    assert read(Reading(None)) == 0.0


def test_roofline_reads_the_kernels_time_against_the_macs(monkeypatch):
    from imageretrievalresearch_tpu_torch.utils import profiling
    read = harness.load_reader("mlp_gemm_roofline.serve")
    peaks = counts.peaks()
    t = _trace([(KERNEL, 0.0, 30.0), (GEMM, 40.0, 50.0),
                (KERNEL, 100.0, 10.0)])
    monkeypatch.setattr(profiling, "_COUNTS", {
        "swin.mlp_macs": 10 ** 9, "swin.mlp_fused": 2})
    assert read(Reading(t, peaks=peaks)) == pytest.approx(
        100 * 2e9 / (peaks["tf32_flops"] / 3) / 40e-6)
    # an eager call in the slice: its multiply-adds are not the kernel's
    monkeypatch.setattr(profiling, "_COUNTS", {
        "swin.mlp_macs": 10 ** 9, "swin.mlp_fused": 2,
        "swin.mlp_eager": 1})
    assert read(Reading(t, peaks=peaks)) is None
    # the kernel counted but not traced
    monkeypatch.setattr(profiling, "_COUNTS", {
        "swin.mlp_macs": 10 ** 9, "swin.mlp_fused": 2})
    assert read(Reading(_trace([(GEMM, 0.0, 5.0)]), peaks=peaks)) is None


def test_bound_of_a_swin_s3_base_request():
    # an MLP call's multiply-adds, 2 x tokens x C x 4C, per stage (tokens
    # an image, C) times its blocks
    per_image = sum(blocks * 2 * tokens * c * 4 * c for blocks, tokens, c in
                    ((2, 3136, 96), (2, 784, 192), (30, 196, 384),
                     (2, 49, 768)))
    assert per_image == pytest.approx(8.33e9, rel=0.001)
    macs = 64 * per_image
    assert swin_mlp.flops(macs) == pytest.approx(1.066e12, rel=0.001)
    assert swin_mlp.bound_s(macs) == pytest.approx(6.46e-3, rel=0.001)
