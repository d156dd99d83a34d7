"""Device ms a step in BatchNorm kernels (native batch_norm and cuDNN bn),
in the trace."""

from port_bench import readers


def read(r):
    return readers.kernel_ms_per_unit(r, r"batch_norm|cudnn::bn_")
