"""One run of one cell: set-up, the window, the trace, the judge.

The order is the contract's: the program is built and warmed (its model
from the seed, the kernels built or loaded, the clients ramped in), the
window runs, the peak memory is read, the program is freed, the traced
slice (``--trace 1``) is reduced, and only then does the reference run, so
that neither its memory nor its time lands in the program's numbers.
"""

from __future__ import annotations

import gc
import json
import subprocess
import time

from lutvq_bench.core import judge, spec
from lutvq_bench.core.record import RunRecord
from lutvq_bench.core.stats import percentile
from lutvq_bench.core.traffic import Schedule


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def serve(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
          log=print) -> tuple:
    """Build the program, ramp, run the window.  Returns (record, finished
    requests, the program's (cfg, weights, batcher), tracer)."""
    import torch

    from tpu_lutvq_torch.runtime.batching import ContinuousBatcher, Request

    t0 = time.perf_counter()
    models = cell.model_module()
    arch = models.arch(cell.config)
    cfg, weights = models.build_program(arch, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_weights = time.perf_counter()
    tracer = None
    if trace:
        from lutvq_bench.core.tracing import Tracer

        tracer = Tracer(device)
        tracer.warm()
    batcher = ContinuousBatcher(cfg, weights, **cell.mix["batcher"])
    rec = RunRecord(model=arch, mix=cell.mix, t_start=t_start)
    schedule = Schedule(cell.mix, seed, arch["vocab"])
    t_ramp = time.perf_counter()
    finished = cell.loop_module().drive(batcher, Request, schedule, cell.mix, rec, seconds,
                                        tracer=tracer)
    rec.setup = {"before_weights_s": t0 - t_start, "weights_s": t_weights - t0,
                 "batcher_s": t_ramp - t_weights, "ramp_s": rec.window_open - t_ramp}
    if tracer is not None:
        rec.spans = tracer.spans
        if tracer.missing:
            log(f"trace: no wrapper for {', '.join(tracer.missing)}")
    return rec, finished, (cfg, weights, batcher), tracer


def sample(cell, seed: int, rec, finished: list) -> list:
    """The requests the judge reads: drawn from the seed among those the
    window finished, the longest among them."""
    done = {s.req_id for s in rec.served if rec.in_window(s.done_t)}
    return judge.sample([r for r in finished if r.req_id in done], cell.check["requests"], seed)


def check(cell, seed: int, requests: list, chosen: dict, device) -> dict:
    """The judge.  The reference runs once over each request's prompt and
    served tokens; for each named set of tokens chosen at the served
    positions (``{"served": [r.output for r in requests]}`` in a run), the
    widest gap under the reference's best against the cell's limit, every
    gap, and whether the set is correct."""
    models = cell.model_module()
    arch = models.arch(cell.config)
    weights = dict(models.raw_weights(arch, seed, device))
    seqs, pos = judge.sequences(requests, device)
    logits = cell.reference_module().forward(arch, weights, seqs, pos)
    del weights
    out = {}
    for name, tokens in chosen.items():
        gaps = judge.gaps(logits, tokens)
        checked = {"widest_gap": {"value": max(gaps) if gaps else None,
                                  "limit": cell.check["max_gap"]}}
        out[name] = {"checked": checked, "gaps": gaps,
                     "correct": all(v["value"] is not None and v["value"] <= v["limit"]
                                    for v in checked.values())}
    return out


def tails(rec) -> dict:
    """Per-request tails of the window, for an earlier line in every cell:
    the readers' own values (``metrics/request_*_p95_ms.py``)."""
    tpot = spec.reader_module("request_tpot_p95_ms")
    ttft = spec.reader_module("request_ttft_p95_ms")
    tp, tt = tpot.values(rec), ttft.values(rec)
    return {"requests_done": len(tp), "first_tokens": len(tt),
            "tpot_p50_ms": percentile(tp, 50), "tpot_p95_ms": tpot.read(rec),
            "ttft_p50_ms": percentile(tt, 50), "ttft_p95_ms": ttft.read(rec)}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        log=print) -> tuple:
    """One run: the result line's fields (``correct`` judged here), and the
    window's request tails and set-up phases for an earlier line."""
    import torch

    rec, finished, program, tracer = serve(cell, seed, seconds, trace, device, t_start, log)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if tracer is not None:
        rec.trace = tracer.reduce()
        kinds: dict = {}
        for name, sec in rec.trace.span_device_s.items():
            kinds[name.split("#")[0]] = kinds.get(name.split("#")[0], 0.0) + sec
        log(f"trace: {rec.trace.kernels} kernels, launches matched "
            f"{rec.trace.launches_matched:.4f}, slice {rec.trace.window_s:.3f} s, busy "
            f"{rec.trace.busy_s:.3f} s; device s under spans: {json.dumps(kinds)}")
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    requests = sample(cell, seed, rec, finished)
    served = check(cell, seed, requests, {"served": [r.output for r in requests]}, device)["served"]
    log(f"judge: {len(served['gaps'])} served tokens of {len(requests)} requests compared")
    checked, correct = served["checked"], served["correct"]
    attempted = [s for s in rec.served if rec.in_window(s.done_t)]
    result = {
        "correct": bool(correct),
        "attempted": len(attempted),
        "failed": sum(s.n_out != s.max_new for s in attempted),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if rec.trace is not None:
        result["device"].update(busy_s=rec.trace.busy_s, window_s=rec.trace.window_s)
        result["breakdown"] = {"device_ops": rec.trace.device_ops,
                               "idle_gaps": rec.trace.idle_gaps}
    result["checked"] = checked
    return result, {"tails": tails(rec), "setup": rec.setup}
