"""The window attention kernel's share of its f32-FMA bound: 4 x 32 FLOPs
for each of the slice's score entries (the program's counter
``swin.attn_scores``, ``work/window_attn.py``) at the f32 rate, over the
device seconds of the kernels whose name holds ``window_attn``. Read only
where every attention call of the slice took the kernel (counter
``swin.attn_fused``, none ``swin.attn_eager``): the entries are then all
the kernel's."""

from port_bench import spans
from port_bench.work import window_attn


def read(r):
    t = r.trace
    c = spans.program_counts()
    scores = c.get("swin.attn_scores")
    if t is None or not scores or not c.get("swin.attn_fused") \
            or c.get("swin.attn_eager"):
        return None
    seconds, launches = t.kernel_seconds(r"window_attn")
    if not launches or seconds <= 0:
        return None
    return 100.0 * window_attn.bound_s(scores, r.peaks) / seconds
