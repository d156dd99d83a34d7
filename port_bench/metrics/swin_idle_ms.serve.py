"""Device-idle ms a request inside the program's Swin spans
(``swin.attention``, ``swin.window``, ``swin.mlp``, ``swin.merge``): the
idle stretches whose midpoint lies in one of them, in the trace."""

from port_bench import spans


def read(r):
    return spans.idle_ms_per_unit(r, ["swin.attention", "swin.window",
                                      "swin.mlp", "swin.merge"])
