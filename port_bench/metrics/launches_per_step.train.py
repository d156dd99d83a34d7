"""Device kernels a step, in the trace: the host's dispatch load."""


def read(r):
    t = r.trace
    if t is None or not t.units:
        return None
    return len(t.kernels) / t.units
