"""Share of the traced slice of a serving cell in which no device operation
ran."""

from port_bench import readers


def read(r):
    return readers.idle_share(r)
