"""Tracing and the analytical profile (counterpart of
``tpu_lutvq.utils.profiling``).

- :func:`trace`: a context manager around ``torch.profiler`` (CPU and, on
  the card, CUDA activity) that writes a Chrome trace into ``logdir``.
- :func:`layer_report`: one decoder layer's projections with their
  traffic by the reference's ``perf_cnt`` categories, their lookup and
  tensor operation counts, the strategy ``auto`` takes and its predicted
  time on the H100 (the traffic model of ``dataflow.traffic``, fitted to
  the card's measured sweep).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from tpu_lutvq_torch.dataflow.chips import ChipSpec, default_chip
from tpu_lutvq_torch.dataflow.traffic import STRATEGIES, pick_strategy


@contextlib.contextmanager
def trace(logdir: str):
    """``with trace("dir"): run()`` → ``dir/trace.json``, a Chrome trace
    (chrome://tracing, Perfetto) of the block's CPU and CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def layer_report(
    llama_cfg,
    batch: int = 1,
    chip: Optional[ChipSpec] = None,
) -> list[dict]:
    """Analytical profile of one decoder layer: a row a projection with its
    traffic (MiB by category), lookups (billions of 4-byte shared-memory
    words), tensor operations (billions), the strategy ``auto`` takes,
    its predicted time and the ceiling that sets it, then a total row."""
    chip = chip or default_chip()
    shapes = {
        "wq": (llama_cfg.hidden, llama_cfg.q_dim),
        "wk": (llama_cfg.hidden, llama_cfg.kv_dim),
        "wv": (llama_cfg.hidden, llama_cfg.kv_dim),
        "wo": (llama_cfg.q_dim, llama_cfg.hidden),
        "w_gate": (llama_cfg.hidden, llama_cfg.ffn),
        "w_up": (llama_cfg.hidden, llama_cfg.ffn),
        "w_down": (llama_cfg.ffn, llama_cfg.hidden),
    }
    rows = []
    for name, (d_in, d_out) in shapes.items():
        cfg = llama_cfg.vq_cfg(d_in)
        strat = pick_strategy(cfg, d_out, batch, chip)
        cost = STRATEGIES[strat](cfg, d_out, batch)
        rows.append(
            {
                "proj": name,
                "d_in": d_in,
                "d_out": d_out,
                "strategy": strat,
                **{k: round(v / 2**20, 4) for k, v in cost.hbm_bytes.items()},
                "lookups_g": round(cost.lookup_words / 1e9, 6),
                "tensor_gop": round(cost.tensor_ops / 1e9, 6),
                "pred_us": round(cost.time_s(chip) * 1e6, 2),
                "bound": cost.bound(chip),
            }
        )
    total = sum(r["pred_us"] for r in rows)
    rows.append({"proj": "TOTAL/layer", "pred_us": round(total, 2)})
    return rows


def print_layer_report(llama_cfg, batch: int = 1, chip: Optional[ChipSpec] = None) -> None:
    for r in layer_report(llama_cfg, batch, chip):
        if r["proj"].startswith("TOTAL"):
            print(f"{'TOTAL/layer':12s} {r['pred_us']:>10.1f} us")
        else:
            print(
                f"{r['proj']:12s} {r['d_in']:>6d}x{r['d_out']:<6d} "
                f"{r['strategy']:11s} {r['pred_us']:>8.1f} us  {r['bound']}-bound  "
                f"codes {r['codeword']:.2f} MB"
            )
