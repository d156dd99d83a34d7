"""The step's share of the bf16 peak (989 TFLOP/s): 3 x the forward FLOPs
of a step's images over the traced slice."""

from port_bench import readers


def read(r):
    return readers.mfu(r, "step_flops", "bfloat16_flops")
