"""Host time from the end of admission to the return of the decode roll's
last launch, over the roll's decode steps, in the window's ticks that
admitted nothing, the profiled ticks left out: the ticks
``decode_step_ms`` reads, as the program's own tick account stamps them
(``tpu_lutvq_torch.tracing.TICKS``).  None where the program keeps no
account, or its account no longer holds the window's first tick.

The roll's last launch returns once the host has enqueued every step, so
this is host dispatch only while the device keeps up with the host: a
launch that blocks on a full CUDA launch queue, or a sync inside the roll,
counts here too.  While the host is the slower, a value close to
``decode_step_ms`` says host dispatch paces the step and the rest of a step
is the readback waiting on the device; once the device is the slower, the
two read alike for the opposite reason, and only the device's busy time
over the same ticks tells them apart."""


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
    lo, hi = rec.slice_span or (float("inf"), float("inf"))
    decode = [r for r in records if not r.admissions and r.steps
              and not (r.t_start < hi and r.t_end > lo)]
    steps = sum(r.steps for r in decode)
    return 1e3 * sum(r.t_dispatched - r.t_admitted for r in decode) / steps if steps else None
