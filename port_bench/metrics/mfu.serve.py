"""The request's share of the f32 peak (67 TFLOP/s, no tensor cores): the
embed's and the scoring product's FLOPs over the traced slice."""

from port_bench import readers


def read(r):
    return readers.mfu(r, "embed_flops+score_flops", "float32_flops")
