"""Summed bound time of every projection call (``QuantizedLinear.apply``)
in the slice over the device time of the kernels launched under those
calls.  The bound is the larger of operations over the bf16 peak and bytes
over HBM's, counted from each call's shapes (``core/counts.py``)."""

from lutvq_bench.core import counts, peaks


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    bound = dev = 0.0
    for name, meta in rec.spans.items():
        if meta["kind"] != "proj" or "d_out" not in meta or not tr.span_complete.get(name):
            continue
        ops, nbytes = counts.projection(meta["rows"], meta["d_in"], meta["d_out"],
                                        x_bytes=meta["x_bytes"], y_bytes=meta["y_bytes"],
                                        weights=rec.model["weights"])
        bound += peaks.bound_s(ops, nbytes)
        dev += tr.span_device_s.get(name, 0.0)
    return 100.0 * bound / dev if dev > 0 else None
