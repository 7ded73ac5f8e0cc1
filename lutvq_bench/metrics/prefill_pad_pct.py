"""Share of the prefill rows the window's admissions computed that were
padding: 100 x (rows - prompt tokens) / rows over every admission of the
window's ticks, as the program's own tick account records them
(``tpu_lutvq_torch.tracing.TICKS``).  A wave computes each of its prompts
at the wave's power-of-two bucket; a single or chunked prefill computes its
prompt's own rows.  A count, not a time: the profiled ticks count too.
None where the program keeps no account, or its account no longer holds
the window's first tick."""


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
    rows = sum(a.rows for r in records for a in r.admissions)
    real = sum(sum(a.prompt_lens) for r in records for a in r.admissions)
    return 100.0 * (rows - real) / rows if rows else None
