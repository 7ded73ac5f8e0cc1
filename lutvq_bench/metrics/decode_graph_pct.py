"""Share of the window's decode steps that a CUDA graph replay served: 100
x the replayed steps over the decode steps of every window tick that
decoded, admitting or not, the profiled ticks left out, as the program's
own tick account records them (``tpu_lutvq_torch.tracing.TICKS``,
``TickRecord.replayed``).  None where the program keeps no account of
replays, or its account no longer holds the window's first tick."""


def read(rec):
    try:
        from tpu_lutvq_torch.tracing import TICKS
    except ImportError:
        return None
    ticks = rec.window_ticks()
    records = [r for r in list(TICKS)
               if rec.window_open <= r.t_start and r.t_end <= rec.window_end]
    if not ticks or not records or records[0].t_start > ticks[0].end:
        return None
    if not all(hasattr(r, "replayed") for r in records):
        return None
    lo, hi = rec.slice_span or (float("inf"), float("inf"))
    decoded = [r for r in records if r.steps and not (r.t_start < hi and r.t_end > lo)]
    steps = sum(r.steps for r in decoded)
    return 100.0 * sum(r.replayed for r in decoded) / steps if steps else None
