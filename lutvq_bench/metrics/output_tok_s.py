"""Output tokens the host received in the window over the window's length."""


def read(rec):
    span = rec.window_end - rec.window_open
    tokens = sum(t.tokens for t in rec.window_ticks())
    return tokens / span if span > 0 else None
