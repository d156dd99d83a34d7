"""Kernel 1's share of its roofline: its bound per call over its device
time, in the trace."""

from port_bench import readers


def read(r):
    return readers.kernel1_roofline(r)
