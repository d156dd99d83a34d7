"""The Swin attention softmax's share of its memory bound: the bound of
the slice's score entries (the program's counter ``swin.attn_scores``,
one f32 read and one write each, ``work/swin.py``) over the device
seconds of the kernels whose name holds ``softmax``, in the trace."""

from port_bench import spans
from port_bench.work import swin


def read(r):
    t = r.trace
    scores = spans.program_counts().get("swin.attn_scores")
    if t is None or not scores:
        return None
    seconds, launches = t.kernel_seconds(r"(?i)softmax")
    if not launches or seconds <= 0:
        return None
    return 100.0 * swin.softmax_bound_s(scores, r.peaks) / seconds
