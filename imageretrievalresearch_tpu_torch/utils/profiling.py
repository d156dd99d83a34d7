"""Profiling: program spans and counters, and a torch.profiler trace around
a block.

Counterpart of ``imageretrievalresearch_tpu/utils/profiling.py`` (its
``trace``). The trace is a Chrome trace (``chrome://tracing``,
ui.perfetto.dev) of the host and, where a card is present, of its kernels.

Spans (``span("layer.phase")``) and counters (``count(name, n)``) mark the
program's phases at its layer boundaries: the engine's embed, the index's
query, the top-k kernel and its certificate, the train step's transform,
forward, backward, optimizer and metrics. They are on while a
``torch.profiler`` profile records, as inside :func:`trace`. Off, a span
is one boolean test that returns one shared no-op context, and a counter
does nothing. On, a span is a host operator of its name in the trace
(``cpu_op``, on the clock of the kernels and copies): the benchmark
(``port_bench``) reads spans as host operators. A counter adds numbers
already on the host and never reads the device; :func:`counts` returns
the counters.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

# a host operator of the span's name, ``cpu_op`` in the Chrome trace
# (``record_function`` would make a ``user_annotation``, which the
# benchmark's trace reader does not keep)
_record = torch._C._profiler._RecordFunctionFast

_OFF = contextlib.nullcontext()
_COUNTS: dict = {}


def span(name: str):
    """``with span("layer.phase"):`` around one phase of the program."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _record(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host number) to the counter ``name`` while a profiler
    records."""
    if _autograd_profiler._is_profiler_enabled:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counts() -> dict:
    """The counters, ``{name: n}``, since the process started."""
    return dict(_COUNTS)


def start() -> torch.profiler.profile:
    """A started ``torch.profiler`` profile of the host and, where CUDA is
    available, of its kernels; spans are on while it records."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop(prof: torch.profiler.profile, path: str | None = None,
         device=None) -> None:
    """Wait for ``device``'s kernels (the current card's by default) so
    that they end in the trace, stop ``prof`` and, with ``path``, export
    its Chrome trace there."""
    try:
        if torch.cuda.is_available() and (
                device is None or torch.device(device).type == "cuda"):
            torch.cuda.synchronize(device)
    finally:
        prof.stop()
    if path is not None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        prof.export_chrome_trace(path)


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace everything inside the context, spans included, into a Chrome
    trace file under ``log_dir``; yields the ``torch.profiler.profile``
    (for ``key_averages()``)."""
    prof = start()
    try:
        yield prof
    except BaseException:
        prof.stop()          # no sync: the block may have failed on the card
        raise
    stop(prof, os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
