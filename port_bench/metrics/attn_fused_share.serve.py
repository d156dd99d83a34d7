"""Share of the traced slice's Swin attention calls that ran the window
attention kernel: 100 x ``swin.attn_fused`` / (``swin.attn_fused`` +
``swin.attn_eager``), the program's counters (one a block call)."""

from port_bench import spans


def read(r):
    c = spans.program_counts()
    fused = c.get("swin.attn_fused", 0)
    calls = fused + c.get("swin.attn_eager", 0)
    if not calls:
        return None
    return 100.0 * fused / calls
