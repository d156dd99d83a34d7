"""Mean ms of a request's embed (the engine and backbone), a span around
the call, synchronised."""

from port_bench import readers


def read(r):
    return readers.span_ms(r, "embed")
