"""Device kernels launched in the profiled slice over the output tokens the
host received in it."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.kernels:
        return None
    tokens = sum(t.tokens for t in rec.ticks if t.traced)
    return tr.kernels / tokens if tokens else None
