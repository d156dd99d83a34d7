"""Profiling hooks: a torch.profiler trace around a block, and step timing.

Counterpart of ``imageretrievalresearch_tpu/utils/profiling.py``. The
trace is a Chrome trace (``chrome://tracing``, ui.perfetto.dev) of the
host and, where a card is present, of its kernels.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace everything inside the context into a Chrome trace file under
    ``log_dir``; yields the ``torch.profiler.profile`` (for
    ``key_averages()``). CUDA activity is recorded where CUDA is
    available."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's kernels end in the trace
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Rolling step timing (ms) + simple throughput accounting."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._last: float | None = None

    def tick(self) -> float | None:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now
        return dt

    @property
    def mean_ms(self) -> float:
        return 1000.0 * (sum(self.times) / len(self.times)) if self.times else 0.0

    def throughput(self, items_per_step: int) -> float:
        mean = (sum(self.times) / len(self.times)) if self.times else 0.0
        return items_per_step / mean if mean else 0.0
