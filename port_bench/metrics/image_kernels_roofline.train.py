"""The AutoAugment image kernels' (5-8) share of their roofline: their
bound over their device time, in the trace."""

from port_bench import readers


def read(r):
    return readers.image_kernels_roofline(r)
