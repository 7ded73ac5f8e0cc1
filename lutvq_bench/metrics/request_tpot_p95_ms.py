"""95th percentile over the requests finished in the window of each one's
time per output token, (last token - first token) / (outputs - 1), leaving
out requests whose span overlaps the profiled slice.  Host clock."""

from lutvq_bench.core.stats import percentile


def values(rec) -> list:
    """Each counted request's time per output token, ms."""
    lo, hi = rec.slice_span or (float("inf"), float("inf"))
    return [(s.receipts[-1][0] - s.first_t) / (s.n_out - 1) * 1e3 for s in rec.served
            if rec.in_window(s.done_t) and s.n_out > 1
            and not (s.first_t < hi and s.receipts[-1][0] > lo)]


def read(rec):
    return percentile(values(rec), 95)
