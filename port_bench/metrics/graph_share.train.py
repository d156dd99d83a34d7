"""Share of the traced slice's train steps that replayed the step's CUDA
graphs: 100 x ``train.graph_replays`` / (``train.graph_replays`` +
``train.eager_steps``), the program's counters (a step that captured
counts as neither)."""

from port_bench import spans


def read(r):
    c = spans.program_counts()
    replays = c.get("train.graph_replays", 0)
    steps = replays + c.get("train.eager_steps", 0)
    if not steps:
        return None
    return 100.0 * replays / steps
