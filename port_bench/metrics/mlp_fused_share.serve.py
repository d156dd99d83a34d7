"""Share of the traced slice's Swin MLP calls that ran on the linear
kernel: 100 x ``swin.mlp_fused`` / (``swin.mlp_fused`` +
``swin.mlp_eager``), the program's counters (one an MLP call)."""

from port_bench import spans


def read(r):
    c = spans.program_counts()
    fused = c.get("swin.mlp_fused", 0)
    calls = fused + c.get("swin.mlp_eager", 0)
    if not calls:
        return None
    return 100.0 * fused / calls
