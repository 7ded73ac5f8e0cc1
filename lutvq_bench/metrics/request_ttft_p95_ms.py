"""95th percentile of submit to first token held by the host, over the
requests whose first token came in the window, leaving out those whose
wait overlaps the profiled slice.  Host clock."""

from lutvq_bench.core.stats import percentile


def values(rec) -> list:
    """Each counted request's wait for its first token, ms."""
    lo, hi = rec.slice_span or (float("inf"), float("inf"))
    return [(s.first_t - s.submit_t) * 1e3 for s in rec.served
            if rec.in_window(s.first_t) and not (s.submit_t < hi and s.first_t > lo)]


def read(rec):
    return percentile(values(rec), 95)
