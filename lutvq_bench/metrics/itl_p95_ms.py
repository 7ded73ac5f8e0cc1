"""95th percentile over every gap between a request's consecutive token
receipts in the window (tokens read back together are 0 apart), leaving
out the gaps that overlap the profiled slice.  Host-paced."""

from lutvq_bench.core.stats import percentile


def read(rec):
    lo, hi = rec.slice_span or (float("inf"), float("inf"))
    gaps = []
    for s in rec.served:
        prev = None
        for t, n in s.receipts:
            if rec.in_window(t):
                if not lo <= t <= hi:
                    gaps.extend([0.0] * (n - 1))
                if prev is not None and not (prev < hi and t > lo):
                    gaps.append(t - prev)
            prev = t
    return percentile([g * 1e3 for g in gaps], 95)
