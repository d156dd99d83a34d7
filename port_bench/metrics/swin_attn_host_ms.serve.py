"""Host ms a request in the program's span ``swin.attention`` (the Swin
blocks' window attention, qkv through proj), on the trace's clock."""

from port_bench import spans


def read(r):
    return spans.span_ms_per_unit(r, "swin.attention")
