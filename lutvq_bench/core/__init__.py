"""The yardstick: peaks, counts, traffic, statistics, tracing, the judge."""
