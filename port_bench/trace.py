"""What a run records besides its end-to-end numbers: spans and counts
taken by the benchmark around its calls into the program's layers, and a
``torch.profiler`` trace of a steady slice of the window, reduced to the
device's activity.

The trace is exported as Chrome JSON into a temporary directory under
``TMPDIR`` and read back: kernels (``cat`` ``kernel``) and copies and
fills (``gpu_memcpy``, ``gpu_memset``) are the device's activity; the
host's operators (``cpu_op``) name what the host was doing in each gap.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    """The device's activity in a traced slice of ``window_s`` seconds
    that held ``units`` requests or steps."""

    window_s: float
    units: int
    kernels: list          # (name, start µs, duration µs)
    activity: list         # (start µs, end µs) of every device event
    host_ops: list         # (name, start µs, end µs)

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran."""
        busy, end = 0.0, -float("inf")
        for s, e in sorted(self.activity):
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy * 1e-6

    def kernel_seconds(self, pattern: str) -> tuple[float, int]:
        """Total device seconds and launches of kernels whose name
        matches ``pattern`` (a regular expression)."""
        rx = re.compile(pattern)
        hits = [d for n, _, d in self.kernels if rx.search(n)]
        return sum(hits) * 1e-6, len(hits)

    def gaps(self) -> list:
        """(start µs, end µs) of the idle stretches between device
        events, longest first."""
        out, end = [], None
        for s, e in sorted(self.activity):
            if end is not None and s > end:
                out.append((end, s))
            end = e if end is None else max(end, e)
        return sorted(out, key=lambda g: g[0] - g[1])

    def breakdown(self, n: int = 10) -> dict:
        by_name: dict[str, float] = defaultdict(float)
        for name, _, d in self.kernels:
            by_name[name[:120]] += d * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps: dict[str, float] = defaultdict(float)
        for s, e in self.gaps()[:200]:
            gaps[self._host_at((s + e) / 2)] += (e - s) * 1e-6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}

    def _host_at(self, t: float) -> str:
        """The innermost host operator running at ``t`` µs."""
        if not self.host_ops:
            return "no host operator"
        if not hasattr(self, "_host_arrays"):
            self._host_arrays = (np.array([s for _, s, _ in self.host_ops]),
                                 np.array([e for _, _, e in self.host_ops]))
        starts, ends = self._host_arrays
        inside = np.flatnonzero((starts <= t) & (ends >= t))
        if not inside.size:
            return "no host operator"
        return self.host_ops[inside[np.argmin(ends[inside]
                                              - starts[inside])]][0]


def read_chrome_trace(path: str, window_s: float, units: int) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels, activity, host = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        s, d = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            activity.append((s, s + d))
            if cat == "kernel":
                kernels.append((ev["name"], s, d))
        elif cat == "cpu_op":
            host.append((ev["name"], s, s + d))
    return Trace(window_s, units, kernels, activity, host)


class Profiled:
    """``with Profiled(torch, n) as p: <n units of work>``; then
    ``p.trace``. Synchronises before and after, and times the slice on
    the host clock."""

    def __init__(self, torch, units: int):
        self.torch, self.units = torch, units
        self.trace: Trace | None = None

    def __enter__(self):
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        window = time.perf_counter() - self.t0
        self.prof.stop()
        if exc[0] is not None:
            return False
        tmp = tempfile.mkdtemp(prefix="port_bench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            self.trace = read_chrome_trace(path, window, self.units)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return False


@dataclass
class Reading:
    """What the per-layer readers (``metrics/*.py``) read: the trace (None
    in an untraced run), the spans (seconds per name), the counts, the
    work the cell's shapes need (``work/``) and the device's peaks."""

    trace: Trace | None
    spans: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)
    peaks: dict = field(default_factory=dict)
