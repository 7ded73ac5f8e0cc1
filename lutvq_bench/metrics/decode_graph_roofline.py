"""Summed bound time of the window's decode steps that a CUDA graph replay
served, over those replays' device time, as the program's own tick account
records it (``tpu_lutvq_torch.tracing.TICKS``: ``TickRecord.replay_s``, two
CUDA events around each replay, so the card's wait for the graph's first
nodes counts too).  A replay's kernels run under one graph launch, where
the traced slice cannot tie them to the projection and attention calls
that ``proj_roofline`` and ``attn_roofline`` read; this reads them
together.

A step's bound is summed over its calls, each the larger of operations
over the bf16 peak and bytes over HBM's (``core/counts.py``): every
layer's seven projections at the tick's slots (every slot decodes a row),
attention over each decoding slot's real context with int8 K and V, and
the bf16 head.  Norms, RoPE, cache writes and sampling add time and no
bound.  Each record is matched to the loop's tick that holds it, for the
slots' positions; the profiled ticks are left out.  None where the
program keeps no account of replays' device time, or no replay served a
window tick."""

import bisect
import math

from lutvq_bench.core import counts, peaks
from lutvq_bench.models.llama import shapes


def step_bound_s(m: dict, rows: int, contexts: list) -> float:
    """Bound seconds of one decode step over ``rows`` slots, the decoding
    slots attending over ``contexts`` rows each."""
    proj = sum(peaks.bound_s(*counts.projection(rows, d_in, d_out, x_bytes=2, y_bytes=2,
                                                weights=m["weights"]))
               for d_in, d_out in shapes(m).values())
    kv = m["kv_bytes"]
    attn = peaks.bound_s(*counts.attention([(1, c) for c in contexts], heads=m["heads"],
                                           kv_heads=m["kv_heads"], head_dim=m["head_dim"],
                                           q_bytes=2, out_bytes=2, kv_bytes=kv["value"],
                                           kv_scale_bytes=kv["scale"]))
    h, v = m["hidden"], m["vocab"]
    head = peaks.bound_s(2.0 * rows * h * v, 2.0 * (v * h + rows * h + rows * v))
    return m["layers"] * (proj + attn) + head


def read(rec):
    try:
        from tpu_lutvq_torch.tracing import TICKS
    except ImportError:
        return None
    if not rec.batcher_seen:
        return None
    ticks = [t for t in rec.window_ticks(untraced=True) if t.positions is not None]
    starts = [t.start for t in ticks]
    bound = dev = 0.0
    for r in list(TICKS):
        secs = getattr(r, "replay_s", math.nan)
        if not getattr(r, "replayed", 0) or not math.isfinite(secs):
            continue
        i = bisect.bisect_right(starts, r.t_start) - 1
        if i < 0 or r.t_end > ticks[i].end:
            continue  # outside the window, or in a profiled tick
        t = ticks[i]
        bound += sum(step_bound_s(rec.model, t.n_slots, [p + h + 1 for p in t.positions])
                     for h in range(r.replayed))
        dev += secs
    return 100.0 * bound / dev if dev > 0 else None
