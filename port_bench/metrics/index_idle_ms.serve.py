"""Device-idle ms a request inside the program's span ``index.query`` (the
ranking: kernel 1's launch, the certificate's sync, the dedup, the
fetches), in the trace."""

from port_bench import spans


def read(r):
    return spans.idle_ms_per_unit(r, ["index.query"])
