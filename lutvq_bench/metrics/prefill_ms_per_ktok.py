"""Device time of the kernels launched under the admission prefills
(``llama_forward`` from the batcher or from its chunked prefill, one span
a chunk) per 1,000 prompt tokens, pad rows not counted; prefills whose
launches did not all come back are left out.  A wave's prompts are the
first its tick admitted."""


def read(rec):
    tr = rec.trace
    if tr is None or not rec.batcher_seen:
        return None
    dev = tokens = 0
    for name, meta in rec.spans.items():
        if meta["kind"] != "prefill" or not tr.span_complete.get(name):
            continue
        admitted = rec.ticks[meta["tick"]].admitted
        real = meta["t"] if meta["rows"] == 1 else sum(admitted[: meta["rows"]])
        dev += tr.span_device_s.get(name, 0.0)
        tokens += real
    return dev * 1e6 / tokens if tokens else None
