"""Ms a request of the engine's host-to-device copy of its images (the
program's span ``engine.upload``), on the trace's clock."""

from port_bench import spans


def read(r):
    return spans.span_ms_per_unit(r, "engine.upload")
