"""The linear kernel's share of its bound over Swin's MLPs: 2 FLOPs for
each of the slice's multiply-adds (the program's counter
``swin.mlp_macs``, ``work/swin_mlp.py``) at a third of the TF32 rate
(the 3xTF32 product), over the device seconds of the kernels whose name
holds ``linear_tf32x3``. Read only where every MLP call of the slice took
the kernel (counter ``swin.mlp_fused``, none ``swin.mlp_eager``): the
multiply-adds are then all the kernel's. The bound counts operations
only, so it cannot pass 100%; Swin-S3-B's stage 1 (N or K = 96) is bound
by its bytes a little above its operations (~0.46 against ~0.36 ms a
request of 64 images), so the share reads a few points low there."""

from port_bench import spans
from port_bench.work import swin_mlp


def read(r):
    t = r.trace
    c = spans.program_counts()
    macs = c.get("swin.mlp_macs")
    if t is None or not macs or not c.get("swin.mlp_fused") \
            or c.get("swin.mlp_eager"):
        return None
    seconds, launches = t.kernel_seconds(r"linear_tf32x3")
    if not launches or seconds <= 0:
        return None
    return 100.0 * swin_mlp.bound_s(macs, r.peaks) / seconds
