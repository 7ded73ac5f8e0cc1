"""Slots holding a request over the batcher's slots, averaged over the
window's ticks: the slots each tick decoded, as the batcher's own ticket
for the tick lists them (requests admitted by the tick included)."""


def read(rec):
    ticks = rec.window_ticks()
    if not ticks or not rec.batcher_seen:
        return None
    return 100.0 * sum(len(t.positions) / t.n_slots for t in ticks) / len(ticks)
