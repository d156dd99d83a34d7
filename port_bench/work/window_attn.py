"""The window attention kernel's work, counted from shapes alone: the
program counts the score entries of its window attention
(``swin.attn_scores``: batch x windows x heads x tokens² a block call),
and at head width 32 each takes 32 f32 multiply-adds in q kᵀ and 32 in
· v, 4 x 32 FLOPs on the CUDA cores (f32, no tensor cores)."""

from __future__ import annotations

from port_bench.work import counts

HEAD_WIDTH = 32


def flops(scores: int) -> int:
    return 4 * HEAD_WIDTH * scores


def bound_s(scores: int, peak: dict | None = None) -> float:
    """The least time of the attention core over ``scores`` entries: its
    f32 FMA work over the f32 rate (its q, k, v and output bytes, ~0.5 of
    that time at Swin-S3-B's windows, bound it less)."""
    peak = counts.peaks() if peak is None else peak
    return flops(scores) / peak["float32_flops"]
