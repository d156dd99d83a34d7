"""What the readers of the program's own spans and counters share.

The program (``imageretrievalresearch_tpu_torch/utils/profiling.py``)
marks its phases with spans (``engine.upload``, ``index.query``,
``train.forward``, ...) while a ``torch.profiler`` profile records, as in
a traced run's slice: each is a host operator of its name in the trace
(``r.trace.host_ops``), on the clock of the device's activity. Its
counters (``topk.rows``, ...) are read from the program once the run has
ended; in a run they hold the traced slice's alone, since the program
counts only while a profile records. On a program without spans or
counters every reader here returns None.
"""

from __future__ import annotations

import numpy as np


def intervals(trace, name: str) -> list:
    """(start µs, end µs) of every span ``name`` in the trace."""
    return [(s, e) for n, s, e in trace.host_ops if n == name]


def span_ms_per_unit(r, name: str):
    """Ms of span ``name`` a request or step of the traced slice."""
    t = r.trace
    if t is None or not t.units:
        return None
    held = intervals(t, name)
    if not held:
        return None
    return 1e-3 * sum(e - s for s, e in held) / t.units


def idle_ms_per_unit(r, names):
    """Device-idle ms a request or step inside the spans ``names``: the
    idle stretches of the slice (``Trace.gaps``) whose midpoint lies in
    one of their intervals, the spans inside them included."""
    t = r.trace
    if t is None or not t.units:
        return None
    held = [iv for n in names for iv in intervals(t, n)]
    if not held:
        return None
    gaps = t.gaps()
    if not gaps:
        return 0.0
    starts = np.array([s for s, _ in held], dtype=np.float64)
    ends = np.array([e for _, e in held], dtype=np.float64)
    mid = np.array([(s + e) / 2 for s, e in gaps], dtype=np.float64)[:, None]
    inside = ((starts <= mid) & (mid <= ends)).any(axis=1)
    length = np.array([e - s for s, e in gaps], dtype=np.float64)
    return 1e-3 * float(length[inside].sum()) / t.units


def program_counts() -> dict:
    """The program's counters, or {} where it keeps none."""
    try:
        from imageretrievalresearch_tpu_torch.utils import profiling
        return dict(profiling.counts())
    except (ImportError, AttributeError):
        return {}
