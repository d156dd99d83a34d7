"""The Swin attention's work, counted from shapes alone: the program
counts the score entries of its window attention (``swin.attn_scores``:
batch x windows x heads x tokens² a block call), and the softmax over
them needs at least one float32 read and one float32 write of each."""

from __future__ import annotations

from port_bench.work import counts


def softmax_bytes(scores: int) -> int:
    return 8 * scores


def softmax_bound_s(scores: int, peak: dict | None = None) -> float:
    """The least time of the softmax over ``scores`` f32 entries: its
    bytes over the memory rate (it does no arithmetic worth a bound)."""
    peak = counts.peaks() if peak is None else peak
    return softmax_bytes(scores) / peak["bytes_per_s"]
