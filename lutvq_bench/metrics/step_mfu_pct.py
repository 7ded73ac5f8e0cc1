"""Model FLOPs of the profiled slice over its length at the bf16 peak.

Model FLOPs: 2 x the projections' weights x the tokens they process (every
admitted prompt token and every decoding slot's token each step), 2 x the
head's weights x the positions whose logits are needed (one a prompt and
one a decoding slot a step), and QKᵀ and PV over each sequence's real
context.  Padding, garbage slots and logits nobody reads are not model
FLOPs."""

from lutvq_bench.core import counts, peaks


def read(rec):
    tr = rec.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0 or not rec.batcher_seen:
        return None
    m = rec.model
    q_dim, kv_dim = m["heads"] * m["head_dim"], m["kv_heads"] * m["head_dim"]
    per_token = 2.0 * m["layers"] * counts.layer_params(m["hidden"], m["ffn"], q_dim, kv_dim)
    head = 2.0 * m["vocab"] * m["hidden"]
    flops = 0.0
    for t in rec.ticks:
        if not t.traced:
            continue
        decoded = len(t.positions) * t.steps
        flops += per_token * (sum(t.admitted) + decoded) + head * (len(t.admitted) + decoded)
        qs = [(n, n) for n in t.admitted]
        qs += [(1, p + h + 1) for h in range(t.steps) for p in t.positions]
        ops, _ = counts.attention(qs, heads=m["heads"], kv_heads=m["kv_heads"],
                                  head_dim=m["head_dim"], q_bytes=0, out_bytes=0,
                                  kv_bytes=0, kv_scale_bytes=0)
        flops += m["layers"] * ops
    return 100.0 * flops / (tr.window_s * peaks.BF16_FLOPS)
