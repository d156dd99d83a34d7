"""Swin's MLP work, counted from shapes alone: the program counts each
MLP call's multiply-adds (``swin.mlp_macs``: 2 x rows x dim x hidden, fc1
and fc2), 2 FLOPs each, and the linear kernel computes them as the 3xTF32
product, three TF32 passes, so its least time is theirs at a third of the
TF32 rate."""

from __future__ import annotations

from port_bench.work import counts


def flops(macs: int) -> int:
    return 2 * macs


def bound_s(macs: int, peak: dict | None = None) -> float:
    """The least time of the MLPs' products over ``macs`` multiply-adds:
    their FLOPs at a third of the TF32 tensor-core rate. Operations only,
    so a lower bound on the time; stage 1 (Swin-S3-B's 96-wide layer) is
    bound by its bytes a little above its operations."""
    peak = counts.peaks() if peak is None else peak
    return flops(macs) / (peak["tf32_flops"] / 3)
