"""Arithmetic the per-layer readers (``metrics/*.py``) share. Each
returns None where the run recorded nothing to read."""

from __future__ import annotations

import re

from port_bench.work import counts


def span_ms(r, name: str):
    values = r.spans.get(name)
    return 1e3 * sum(values) / len(values) if values else None


def idle_share(r):
    t = r.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(r, flops_key: str, peak_key: str):
    """Share of the peak of the chips used: the traced slice's FLOPs
    (``flops_key`` of the work, per unit) over its seconds."""
    t = r.trace
    if t is None or not t.units:
        return None
    flops = sum(r.work[k] for k in flops_key.split("+")) * t.units
    chips = r.work.get("chips", 1)
    return 100.0 * flops / t.window_s / (chips * r.peaks[peak_key])


def kernel_ms_per_unit(r, pattern: str):
    t = r.trace
    if t is None or not t.units:
        return None
    seconds, launches = t.kernel_seconds(pattern)
    return 1e3 * seconds / t.units if launches else None


def image_kernels_roofline(r):
    """The AutoAugment kernels' bound (``work/counts.image_kernel``, per
    launch at the cell's planes) over their device time."""
    t = r.trace
    planes = r.work.get("augment_planes", 0)
    if t is None or not planes:
        return None
    h, w = r.work["augment_hw"]
    bound = busy = 0.0
    for name, kind in counts.IMAGE_KERNELS.items():
        rx = re.compile(r"\b" + name + r"\b")
        hits = [d for n, _, d in t.kernels if rx.search(n)]
        bound += len(hits) * counts.image_kernel(kind, planes, h, w)[
            "bound_s"]
        busy += sum(hits) * 1e-6
    return 100.0 * bound / busy if busy > 0 else None


KERNEL1 = r"fused_topk_tc_kernel|fused_topk_select_merge_kernel"


def kernel1_roofline(r):
    """Kernel 1's bound per call over its device time (its score and
    merge kernels); a call is one merge launch."""
    t = r.trace
    if t is None:
        return None
    seconds, _ = t.kernel_seconds(KERNEL1)
    _, calls = t.kernel_seconds(r"fused_topk_select_merge_kernel")
    if not calls or seconds <= 0:
        return None
    return 100.0 * calls * r.work["kernel1_bound_s"] / seconds
