"""Device-idle ms a step inside the program's spans ``train.forward`` and
``train.backward`` (the host's dispatch of the model), in the trace."""

from port_bench import spans


def read(r):
    return spans.idle_ms_per_unit(r, ["train.forward", "train.backward"])
