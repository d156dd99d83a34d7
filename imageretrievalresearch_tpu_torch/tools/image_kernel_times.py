"""Times of the AutoAugment image kernels and of the triplet transform on
one CUDA card, at the transform's shapes (3 x 64 seeded 256 px images
resized to 224: 192 planes of 224 x 224, or 43,008 rows of 224):

    python -m imageretrievalresearch_tpu_torch.tools.image_kernel_times
    PYTHONPATH=<another checkout> python <this file> --label parent

The second form times the package found on ``PYTHONPATH`` (another
version of the port) with this file's code, so two versions are measured
the same way; run them in turns (parent, change, change, parent) in one
process each on one card. For each kernel wrapper (and the histogram on
planes of one value, the rotate's Sy pass, and the whole rotate): the
median single call between CUDA events (``ms``), back-to-back launches
(``burst_ms``, fastest of 5 bursts of 20), the device time per call from
``torch.profiler`` (``device_ms``: all of the call's device work;
``kernel_ms``: the named kernel alone, per launch; both on the same
operands, which the card's L2 keeps between calls) and the host's µs per
call (``host_us``). For each wrapper also
its kernel's time per launch on operands read from HBM
(``kernel_hbm_ms``: the calls cycle through copies of the operands that
together exceed twice the L2), the time the byte bound at the HBM rate
describes, and the host's µs in each step of the wrapper
(``host_steps``). Then the transform: warm wall (median of 5 CUDA-event
calls) and one profiled call's wall and device-busy time. ``--sass
OTHER.so`` compares the SASS of named kernels (``--kernels``) of this
package's ``image_ops`` library with another build's (``cuobjdump
-sass``). One JSON line per measurement.
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import statistics
import subprocess
import time
from typing import Callable

import numpy as np
import torch

from imageretrievalresearch_tpu_torch.ops import _cuda
from imageretrievalresearch_tpu_torch.ops import autoaugment as A
from imageretrievalresearch_tpu_torch.ops import image_kernels as IK
from imageretrievalresearch_tpu_torch.ops.preprocess import (
    TransformSpec,
    build_triplet_transform,
    resize_bilinear,
)
from imageretrievalresearch_tpu_torch.tools.profile_fused_kernel import (
    card,
    pipelined_ms,
)

# the data's seed and the transform's shapes, which chip_smoke.py's phase
# 5 shares: a batch of AUG_BATCH seeded AUG_SRC px uint8 images per role,
# resized to SIZE (the model's input size)
SEED, SIZE, AUG_BATCH, AUG_SRC = 0, 224, 64, 256
# the TPU kernels' static shift bounds at SIZE (JAX's batched_shear_x and
# batched_rotate): shear int(0.3 * H) + 1, rotate passes
# int(tan(15°) * H/2) + 1 and int(sin(30°) * W/2) + 1
SMAX_SHEAR = int(0.3 * SIZE) + 1
SMAX_ROTATE = (int(np.tan(np.deg2rad(30.0) / 2.0) * (SIZE / 2.0)) + 1,
               int(np.sin(np.deg2rad(30.0)) * (SIZE / 2.0)) + 1)
# each wrapper's C entry
ENTRIES = {"plane_histogram": "image_histogram",
           "lut_apply": "image_lut_apply",
           "row_shift_cubic": "image_row_shift_cubic",
           "row_shift": "image_row_shift",
           "column_shift": "image_column_shift"}
# each wrapper's kernel, as torch.profiler names it
CUDA_NAMES = {"plane_histogram": "histogram_kernel",
              "lut_apply": "lut_kernel",
              "row_shift_cubic": "row_shift_cubic_kernel",
              "row_shift": "row_shift_kernel",
              "column_shift": "column_shift_kernel"}


def event_ms(fn: Callable, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` single-call CUDA-event times, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(fn: Callable, reps: int = 100) -> float:
    """Host-clock µs per call of ``fn``: one warm-up call, ``reps`` calls,
    one synchronise outside the clock."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _is_kernel(key: str, name: str) -> bool:
    # "row_shift_kernel" is not a substring of "row_shift_cubic_kernel"
    return CUDA_NAMES[name] in key


def device_ms(fn: Callable, name: str | None = None,
              calls: int = 20) -> tuple[float, float | None]:
    """(all device time per call, the named wrapper's kernel time per
    launch) over ``calls`` calls under ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3 / calls
    if name is None:
        return total, None
    mine = [e for e in events if _is_kernel(e.key, name)]
    count = sum(e.count for e in mine)
    return total, (sum(e.self_device_time_total for e in mine) / 1e3 / count
                   if count else None)


def from_hbm(wrapper: Callable, args: tuple) -> Callable:
    """A call of ``wrapper`` on the next of as many copies of ``args`` as
    make more than twice the card's L2, so that each call reads operands
    the L2 no longer holds."""
    nbytes = sum(a.numel() * a.element_size() for a in args)
    l2 = torch.cuda.get_device_properties(args[0].device).L2_cache_size
    copies = itertools.cycle([tuple(a.clone() for a in args)
                              for _ in range(2 * l2 // nbytes + 2)])
    return lambda: wrapper(*next(copies))


def host_steps(name: str, args: tuple) -> dict:
    """The host's µs in each step of an image wrapper: its checks, the
    output's allocation, the stream lookup (torch's raw handle, as
    ``_cuda.launch`` takes it, and the Stream object the wrappers built
    before), the ctypes call of the C entry (which launches), and the
    whole call."""
    t, aux = args[0], args[-1]
    dev = t.device
    fn = getattr(_cuda.load_library("image_ops"), ENTRIES[name])
    index = _cuda.device_index(dev)

    def allocate():   # as the wrapper allocates its output
        return (torch.empty((t.shape[0], 256), dtype=torch.int32, device=dev)
                if name == "plane_histogram" else torch.empty_like(t))

    out = allocate()
    if name == "plane_histogram":
        c_args = [t.data_ptr(), t.shape[0], t[0].numel(), out.data_ptr()]
    elif name == "lut_apply":
        c_args = [t.data_ptr(), aux.data_ptr(), t.shape[0], t[0].numel(),
                  out.data_ptr()]
    else:   # rows (N, W) or planes (P, H, W), the fill
        c_args = [t.data_ptr(), aux.data_ptr(), *t.shape, IK.FILL,
                  out.data_ptr()]
    stream = _cuda.stream_handle(index)

    def checks():
        _cuda.check_operand("a", t, t.dtype, tuple(t.shape), dev)
        if name != "plane_histogram":
            _cuda.check_operand("b", aux, aux.dtype, tuple(aux.shape), dev)

    steps = {
        "checks": host_us(checks),
        "allocation": host_us(allocate),
        "stream lookup, raw handle": host_us(
            lambda: _cuda.stream_handle(index)),
        "stream lookup, torch.cuda.current_stream": host_us(
            lambda: torch.cuda.current_stream(index).cuda_stream),
        "ctypes call (launches)": host_us(lambda: fn(*c_args, stream)),
        "whole call": host_us(lambda: getattr(IK, name)(*args)),
    }
    return steps


def inputs(dev: torch.device) -> dict:
    """The transform's operands at its shapes, from SEED."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    src = torch.randint(0, 256, (AUG_BATCH, AUG_SRC, AUG_SRC, 3),
                        generator=gen,
                        device=dev, dtype=torch.uint8)
    x8 = torch.clamp(torch.round(resize_bilinear(src, (SIZE, SIZE))),
                     0, 255).to(torch.uint8)
    planes = A._planes(x8).contiguous()                   # (192, 224, 224)
    # the histogram's worst case for atomics: every pixel of a plane in
    # one bin
    const_planes = torch.full_like(planes, 128)
    p, h, w = planes.shape
    rows = planes.reshape(-1, w)                          # (43008, 224)
    n = rows.shape[0]
    hist = torch.zeros((p, 256), dtype=torch.int32, device=dev)
    hist.scatter_add_(1, planes.reshape(p, -1).long(),
                      torch.ones((p, h * w), dtype=torch.int32, device=dev))
    lut = A._equalize_lut(hist)
    src0 = (torch.rand(n, generator=gen, device=dev) * 2 - 1) * SMAX_SHEAR
    shifts = torch.randint(-SMAX_ROTATE[1], SMAX_ROTATE[1] + 1, (n,),
                           generator=gen, device=dev, dtype=torch.int32)
    col_shifts = torch.randint(-SMAX_ROTATE[1], SMAX_ROTATE[1] + 1, (p, w),
                               generator=gen, device=dev, dtype=torch.int32)
    deg = torch.tensor([-30.0, -26.666666, -10.0, 10.0, 26.666666, 30.0],
                       device=dev)[torch.randint(0, 6, (AUG_BATCH,),
                                                 generator=gen, device=dev)]
    batch = {"qry": src, "pos": [torch.randint(
        0, 256, src.shape, generator=gen, device=dev, dtype=torch.uint8)],
        "neg": [torch.randint(0, 256, src.shape, generator=gen, device=dev,
                              dtype=torch.uint8)]}
    return {"x8": x8, "planes": planes, "const_planes": const_planes,
            "rows": rows, "lut": lut, "src0": src0, "shifts": shifts,
            "col_shifts": col_shifts, "deg": deg, "batch": batch}


def calls(d: dict) -> dict[str, tuple[Callable, str | None, tuple | None]]:
    """name -> (the call, the wrapper whose kernel it launches, the
    wrapper's arguments): the five wrappers, the histogram again on planes
    of one value, the rotate's Sy pass (its shifts and the column form)
    and the whole rotate."""
    planes4 = d["planes"].reshape(AUG_BATCH, 3, SIZE, SIZE)
    v = -torch.sin(-torch.deg2rad(d["deg"]))
    return {
        "plane_histogram": (lambda: IK.plane_histogram(d["planes"]),
                            "plane_histogram", (d["planes"],)),
        "plane_histogram, planes of one value": (
            lambda: IK.plane_histogram(d["const_planes"]), "plane_histogram",
            (d["const_planes"],)),
        "lut_apply": (lambda: IK.lut_apply(d["planes"], d["lut"]),
                      "lut_apply", (d["planes"], d["lut"])),
        "row_shift_cubic": (lambda: IK.row_shift_cubic(d["rows"], d["src0"]),
                            "row_shift_cubic", (d["rows"], d["src0"])),
        "row_shift": (lambda: IK.row_shift(d["rows"], d["shifts"]),
                      "row_shift", (d["rows"], d["shifts"])),
        "column_shift": (lambda: IK.column_shift(d["planes"],
                                                 d["col_shifts"]),
                         "column_shift", (d["planes"], d["col_shifts"])),
        "rotate Sy pass": (lambda: A._nearest_column_shift(planes4, v),
                           None, None),
        "batched_rotate": (lambda: A.batched_rotate(d["x8"], d["deg"]),
                           None, None),
    }


def transform_times(batch: dict, dev: torch.device) -> dict:
    """The triplet transform (3 x train_autoaugment(224)): warm wall
    (median of 5 CUDA-event calls) and one profiled call's wall and
    device-busy time."""
    spec = TransformSpec.train_autoaugment(SIZE)
    transform = build_triplet_transform(spec, spec, spec)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    warm = event_ms(lambda: transform(batch, gen), reps=5)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        transform(batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel = {n: sum(e.self_device_time_total for e in events
                        if _is_kernel(e.key, n)) / 1e3 for n in CUDA_NAMES}
    return {"warm_wall_ms": warm, "profiled_wall_ms": wall,
            "device_busy_ms": sum(e.self_device_time_total
                                  for e in events) / 1e3,
            "device_launches": sum(e.count for e in events),
            "kernel_device_ms": by_kernel}


def sass(lib: str) -> dict[str, list[str]]:
    """Kernel (mangled name, without the hash nvcc gives each build's
    anonymous namespace) -> its SASS instruction lines, from ``cuobjdump
    -sass``."""
    text = subprocess.run(["cuobjdump", "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__",
                          m.group(1))
            out[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            out[name].append(line.split(";")[0].strip())
    return out


def sass_diff(lib_a: str, lib_b: str, kernels: list[str]) -> dict:
    """For each kernel whose mangled name contains a name of ``kernels``:
    its instruction count in both libraries and the lines that differ."""
    a, b = sass(lib_a), sass(lib_b)
    out = {}
    for k in kernels:
        names = sorted(n for n in set(a) | set(b) if k in n)
        for n in names:
            la, lb = a.get(n, []), b.get(n, [])
            diff = sum(x != y for x, y in zip(la, lb)) + abs(len(la)
                                                             - len(lb))
            out[n] = {"lines": [len(la), len(lb)], "differing": diff}
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--label", default="this",
                   help="a name for the version measured, in every line")
    p.add_argument("--sass", default=None,
                   help="another build of image_ops to compare SASS with")
    p.add_argument("--kernels", default=None,
                   help="comma-separated kernels whose SASS --sass compares "
                   "(required with --sass)")
    args = p.parse_args(argv)
    if args.sass and not args.kernels:
        p.error("--sass needs --kernels")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this tool measures the card")
    dev = torch.device("cuda")

    def emit(**kw):
        print(json.dumps({"label": args.label, **kw}), flush=True)

    lib = str(_cuda._lib_path("image_ops"))
    _cuda.load_library("image_ops")
    emit(card=card(), package=str(_cuda._PKG), library=lib)
    if args.sass:
        emit(sass=sass_diff(lib, args.sass, args.kernels.split(",")))
    d = inputs(dev)
    for name, (fn, wrapper, wargs) in calls(d).items():
        total, kernel = device_ms(fn, wrapper)
        row = {"name": name, "ms": event_ms(fn, reps=50),
               "burst_ms": pipelined_ms(fn), "device_ms": total,
               "kernel_ms": kernel, "host_us": host_us(fn)}
        if wrapper is not None:
            _, row["kernel_hbm_ms"] = device_ms(
                from_hbm(getattr(IK, wrapper), wargs), wrapper)
            row["host_steps"] = host_steps(wrapper, wargs)
        emit(**row)
    emit(transform=transform_times(d["batch"], dev))


if __name__ == "__main__":
    main()
