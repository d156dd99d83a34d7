"""Mean ms of a request's ranking (the index, kernel 1, the class dedup), a
span around the call."""

from port_bench import readers


def read(r):
    return readers.span_ms(r, "index")
