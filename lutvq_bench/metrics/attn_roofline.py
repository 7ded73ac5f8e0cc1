"""Summed bound time of every attention call in the slice over the device
time of the kernels launched under those calls.  Each call's bound counts
QKᵀ and PV over each sequence's real context (decode: every decoding slot
at its position; prefill: each admitted prompt's own length, pad rows not
counted; a chunk of a chunked prefill attends over the rows before it
too) and reads K and V in the cache's int8 format with their scales
(``core/counts.py``)."""

from lutvq_bench.core import counts, peaks


def queries(rec, meta):
    """(new positions, context) of each sequence the call attends for; None
    where its prefill's position was not read."""
    tick = rec.ticks[meta["tick"]]
    phase, what = meta["phase"]
    if phase == "decode":
        return [(1, p + what + 1) for p in tick.positions]
    pre = rec.spans[what]
    if pre["offset"] is None:
        return None
    if pre["rows"] == 1:
        return [(pre["t"], pre["offset"] + pre["t"])]
    return [(n, n) for n in tick.admitted[: pre["rows"]]]


def read(rec):
    tr = rec.trace
    if tr is None or not rec.batcher_seen:
        return None
    m = rec.model
    kv = m["kv_bytes"]
    bound = dev = 0.0
    for name, meta in rec.spans.items():
        if meta["kind"] != "attn" or meta.get("phase") is None or "out_bytes" not in meta \
                or not tr.span_complete.get(name):
            continue
        qs = queries(rec, meta)
        if qs is None:
            continue
        _, _, heads, head_dim = meta["q_shape"]
        ops, nbytes = counts.attention(qs, heads=heads, kv_heads=m["kv_heads"],
                                       head_dim=head_dim, q_bytes=meta["q_bytes"],
                                       out_bytes=meta["out_bytes"], kv_bytes=kv["value"],
                                       kv_scale_bytes=kv["scale"])
        bound += peaks.bound_s(ops, nbytes)
        dev += tr.span_device_s.get(name, 0.0)
    return 100.0 * bound / dev if dev > 0 else None
