"""Host wall time of the window's ticks that admitted nothing, over their
decode steps (``llama_decode_step`` calls); the profiled ticks left out."""


def read(rec):
    if not rec.batcher_seen:
        return None
    ticks = [t for t in rec.window_ticks(untraced=True) if not t.admitted and t.steps]
    steps = sum(t.steps for t in ticks)
    return 1e3 * sum(t.end - t.start for t in ticks) / steps if steps else None
