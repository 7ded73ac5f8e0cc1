"""Share of the profiled slice in which no device activity ran."""


def read(rec):
    tr = rec.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
