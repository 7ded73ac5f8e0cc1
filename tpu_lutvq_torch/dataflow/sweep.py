"""Strategy × workload sweep (counterpart of ``tpu_lutvq.dataflow.sweep``):
the traffic model's counts and predicted time for every projection strategy
at each workload, and on the card the measured time of each whole call.

``WORKLOADS`` are the reference's eight rows and the Llama-2 7B, 13B and 70B
projection shapes (q/k/v/o, gate/up, down; 70B's k/v apart) at 1, 2, 3, 4,
6, 8, 12 and 16 rows, with each model's own layer config
(``LlamaConfig.vq_cfg``: AQLM 2x8, group 8, a shared codebook).
``COLUMNS`` are the reference's, two of them renamed: its ``VPU_Gops``
(TPU vector lane-ops) is ``Lookups_G`` here, the 4-byte shared-memory words
a call gathers (billions), and its ``MXU_Gflop`` is ``Tensor_Gop``, the
tensor-core operations (billions).

The measure leg (``measure=True``) runs on the card only.  It times each
row's whole ``QuantizedLinear.apply`` call (``DenseLinear.apply`` of the
bf16 weight for ``dense_bf16``) two ways: the profiler's device time,
summed over every kernel the call launches, with the L2 warm
(``Measured_us``, the median of three profiler sessions of 20 calls, of
those that saw every kernel: what ``pick_strategy`` is fitted to, since an
event-timed call also measures the host's dispatch), and the CUDA-event
median with the L2 flushed (``Events_us``).  :func:`fit_constants` fits the traffic model's
constants to those device times.

    python -m tpu_lutvq_torch.dataflow.sweep [out.csv]   # the model's rows
    python -m tpu_lutvq_torch.dataflow.sweep --fit       # constants from h100_sweep.csv
    python -m tpu_lutvq_torch.dataflow.sweep --refresh   # its model columns at them
    python3 chip_smoke.py --sweep                        # on the card: rewrite the CSVs
"""

from __future__ import annotations

import csv
import io
import math
import statistics
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from tpu_lutvq_torch.core.config import aqlm_2x8, pq_ann, rq_ann, tmac
from tpu_lutvq_torch.dataflow.chips import ChipSpec, default_chip
from tpu_lutvq_torch.dataflow import traffic
from tpu_lutvq_torch.dataflow.traffic import SWEEP_STRATEGIES

SWEEP_CSV = Path(__file__).resolve().parent / "h100_sweep.csv"

# The reference's eight workloads (sim_dataflow.py:33-52 and its batched
# and Llama-2 7B gate rows)
REFERENCE_WORKLOADS = {
    "TMAC_GEMV": (tmac(4096, bits=4, group=4), 4096, 1),
    "PQ": (pq_ann(d=128, m=8, k=256), 1024, 1),
    "RQ": (rq_ann(d=128, n_codebooks=4, k=256), 1024, 1),
    "AQLM_GEMV": (aqlm_2x8(4096, group=16), 4096, 1),
    "AQLM_GEMM_B64": (aqlm_2x8(4096, group=16), 4096, 64),
    "TMAC_GEMM_B16": (tmac(4096, bits=4, group=4), 4096, 16),
    "LLAMA7B_GATE_B1": (aqlm_2x8(4096, group=8), 11008, 1),
    "LLAMA7B_GATE_B32": (aqlm_2x8(4096, group=8), 11008, 32),
}
# (model, projection): (d_in, d_out) of the Llama-2 projections
LLAMA_PROJECTIONS = {
    ("7B", "QKVO"): (4096, 4096), ("7B", "GATEUP"): (4096, 11008),
    ("7B", "DOWN"): (11008, 4096),
    ("13B", "QKVO"): (5120, 5120), ("13B", "GATEUP"): (5120, 13824),
    ("13B", "DOWN"): (13824, 5120),
    ("70B", "QO"): (8192, 8192), ("70B", "KV"): (8192, 1024),
    ("70B", "GATEUP"): (8192, 28672), ("70B", "DOWN"): (28672, 8192),
}
LLAMA_ROWS = (1, 2, 3, 4, 6, 8, 12, 16)
WORKLOADS = {
    **REFERENCE_WORKLOADS,
    **{f"LLAMA{m}_{p}_B{b}": (aqlm_2x8(d_in, group=8, shared_codebook=True), d_out, b)
       for (m, p), (d_in, d_out) in LLAMA_PROJECTIONS.items() for b in LLAMA_ROWS},
}
# the strategies of the exact tier (bf16 tables), among which auto picks
EXACT_TIER = ("lut_gemv", "dequant_mm")

COLUMNS = [
    "Strategy",
    "VQ_type",
    "Batch",
    "Dout",
    "D",
    "M",
    "N",
    "K",
    "Codeword_MB",
    "Codebook_MB",
    "LUT_MB",
    "Inp_MB",
    "Psum_MB",
    "Total_HBM_MB",
    "Lookups_G",
    "Tensor_Gop",
    "Pred_us",
    "Bound",
    "Roofline_frac",
]
MEASURED_COLUMNS = ["Measured_us", "Events_us", "Pred_over_meas"]


def time_ms(fn, reps=20, warmup=3):
    """Median time of ``fn`` over ``reps`` calls by CUDA events, with the
    50 MB L2 flushed before each call (the serving path meets its codes
    cold); the host's dispatch is included."""
    for _ in range(warmup):
        fn()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls=20, sessions=1):
    """The card's own time for one ``fn()`` (torch.profiler: the self time
    of every CUDA kernel the calls launch, over ``calls`` calls with the L2
    warm), without the host's dispatch that an event-timed call includes.
    With ``sessions`` > 1, the median over the profiler sessions that saw
    the most kernels: a session that lost kernel events reads short."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        seen.append((sum(e.count for e in events),
                     sum(e.self_device_time_total for e in events) / calls / 1e3))
    most = max(n for n, _ in seen)
    return statistics.median(t for n, t in seen if n == most)


def model_row(wname: str, sname: str, cfg, d_out: int, batch: int,
              chip: Optional[ChipSpec] = None) -> dict:
    """One sweep row: the strategy's counts and predicted time."""
    chip = chip or default_chip()
    c = SWEEP_STRATEGIES[sname](cfg, d_out, batch)
    mb = {k: v / 2**20 for k, v in c.hbm_bytes.items()}
    return {
        "Strategy": sname,
        "VQ_type": wname,
        "Batch": batch,
        "Dout": d_out,
        "D": cfg.d_in,
        "M": cfg.n_subvec,
        "N": cfg.n_codebook,
        "K": cfg.n_cluster,
        "Codeword_MB": round(mb["codeword"], 4),
        "Codebook_MB": round(mb["codebook"], 4),
        "LUT_MB": round(mb["lut"], 4),
        "Inp_MB": round(mb["inp"], 4),
        "Psum_MB": round(mb["psum"], 4),
        "Total_HBM_MB": round(c.total_hbm / 2**20, 4),
        "Lookups_G": round(c.lookup_words / 1e9, 6),
        "Tensor_Gop": round(c.tensor_ops / 1e9, 6),
        "Pred_us": round(c.time_s(chip) * 1e6, 3),
        "Bound": c.bound(chip),
        "Roofline_frac": round(c.roofline_frac(chip), 4),
    }


def _layer(cfg, d_out: int, device: str):
    from tpu_lutvq_torch.core.params import init_vq_params
    from tpu_lutvq_torch.kernels.lut_gemv import pack_params
    from tpu_lutvq_torch.models.linear import QuantizedLinear

    gen = torch.Generator(device).manual_seed(0)
    params = init_vq_params(gen, cfg, d_out, with_scales=True)
    return QuantizedLinear(pack_params(cfg, params))


def _call(sname: str, cfg, layer, dense, x):
    """The whole call of ``sname`` on ``x``, or None where the layer has no
    such tables (the W8A8 ones need ``d_subvec % 4 == 0``, the bf16x2 ones
    an even one; a T-MAC layer is packed without nibbles, so the dequant
    kernels read it as any other)."""
    if sname == "dense_bf16":
        return lambda: dense.apply(cfg, x)
    if sname.startswith("dequant_mm") and cfg.d_subvec % (4 if sname == "dequant_mm_i8" else 2):
        return None
    kw = {"lut_gemv": dict(strategy="lut_gemv"),
          "lut_gemv_i8": dict(strategy="lut_gemv", variant="i8"),
          "lut_gemv_i16": dict(strategy="lut_gemv", variant="i16"),
          "dequant_mm": dict(strategy="dequant_mm"),
          "dequant_mm_i8": dict(strategy="dequant_mm", variant="i8")}[sname]
    return lambda: layer.apply(cfg, x, **kw)


def _measure(rows: list, device: str = "cuda") -> None:
    """Add each row's measured times (the card only), one layer a shape."""
    from tpu_lutvq_torch.kernels.dequant_mm import dequant_weight
    from tpu_lutvq_torch.models.linear import DenseLinear

    key = layer = dense = None
    gen = torch.Generator(device).manual_seed(1)
    for r in rows:
        cfg, d_out, batch = WORKLOADS[r["VQ_type"]]
        if key != (cfg, d_out):
            key, layer, dense = (cfg, d_out), None, None
            torch.cuda.empty_cache()
            layer = _layer(cfg, d_out, device)
            dense = DenseLinear(dequant_weight(cfg, layer.packed).to(torch.bfloat16))
        x = torch.randn((batch, cfg.d_in), generator=gen, device=device)
        fn = _call(r["Strategy"], cfg, layer, dense, x)
        if fn is None:
            continue
        try:
            fn()
            torch.cuda.synchronize()
        except (ValueError, RuntimeError) as e:  # record, don't abort the sweep
            print(f"measure {r['VQ_type']}/{r['Strategy']} failed: {e}", flush=True)
            continue
        r["Measured_us"] = round(device_ms(fn, calls=20, sessions=3) * 1e3, 3)
        r["Events_us"] = round(time_ms(fn, reps=20) * 1e3, 3)
        r["Pred_over_meas"] = round(r["Pred_us"] / r["Measured_us"], 4)
        print(f"{r['VQ_type']:22s} {r['Strategy']:14s} device {r['Measured_us']:9.3f} us "
              f"events {r['Events_us']:9.3f} us pred {r['Pred_us']:9.3f} us", flush=True)


def run_sweep(
    chip: Optional[ChipSpec] = None,
    out_path: Optional[str] = None,
    measure: bool = False,
    header: tuple = (),
) -> list[dict]:
    """Every ``WORKLOADS`` row × ``SWEEP_STRATEGIES``.  ``measure=True``
    (the card only; it raises without one) adds ``Measured_us``,
    ``Events_us`` and ``Pred_over_meas``.  ``out_path`` gets the CSV, each
    of ``header``'s lines first as a ``#`` comment."""
    if measure and not torch.cuda.is_available():
        raise RuntimeError("the sweep's measure leg runs on a CUDA card; none is present")
    chip = chip or default_chip()
    rows = [model_row(wname, sname, cfg, d_out, batch, chip)
            for wname, (cfg, d_out, batch) in WORKLOADS.items()
            for sname in SWEEP_STRATEGIES]
    if measure:
        _measure(rows)
    if out_path:
        with open(out_path, "w", newline="") as f:
            write_csv(f, rows, COLUMNS + (MEASURED_COLUMNS if measure else []), header)
    return rows


def write_csv(f, rows: list, columns: list, header: tuple = ()) -> None:
    for line in header:
        f.write(f"# {line}\n")
    w = csv.DictWriter(f, fieldnames=columns, restval="", lineterminator="\n")
    w.writeheader()
    w.writerows(rows)


def sweep_csv(chip: Optional[ChipSpec] = None) -> str:
    buf = io.StringIO()
    write_csv(buf, run_sweep(chip), COLUMNS)
    return buf.getvalue()


def read_csv(path=SWEEP_CSV) -> list[dict]:
    """A sweep CSV's rows (``#`` lines skipped), numbers as floats, empty
    cells dropped."""
    with open(path) as f:
        lines = [ln for ln in f if not ln.startswith("#")]
    rows = []
    for r in csv.DictReader(lines):
        row = {}
        for k, v in r.items():
            if v == "":
                continue
            try:
                row[k] = float(v)
            except ValueError:
                row[k] = v
        rows.append(row)
    return rows


def _fit_terms(r: dict, chip: ChipSpec):
    """A measured row's kernel and its launches, HBM seconds, gathered and
    staged words and tensor operations at unit cost (seconds), and its
    device seconds; None for a row of two kernels (no sweep row has one)."""
    cfg, d_out, batch = WORKLOADS[r["VQ_type"]]
    c = SWEEP_STRATEGIES[r["Strategy"]](cfg, d_out, batch)
    if len(c.calls) != 1:
        return None
    (k, n), = c.calls.items()
    gathered, staged = c.busiest.get(k, (0, 0))
    return (k, n, c.total_hbm / chip.hbm_bytes_s, gathered / chip.sm_words_s,
            staged / chip.sm_words_s, c.lookup_words / chip.lookup_words_s,
            c.tables.get(k, 0) / chip.hbm_bytes_s, c.tensor_ops / chip.peak_ops[c.tensor_kind],
            r["Measured_us"] * 1e-6)


# the grids the fit searches: launch seconds, word costs and tensor costs
_WORD_COSTS = np.concatenate([[0.0], np.round(np.logspace(-2, 3, 251), 5)])
_FIT_GRIDS = {
    "launch": np.arange(0, 801) * 0.25e-6,
    "lookup": _WORD_COSTS,
    "stage": _WORD_COSTS,
    "card": _WORD_COSTS,
    "build": _WORD_COSTS,
    "tensor": np.round(np.logspace(0, 2.5, 126), 5),
}
_FIT_ROUNDS = 30
_FIT_TABLES = {"launch": "LAUNCH_S", "lookup": "LOOKUP_COST", "stage": "STAGE_COST",
               "card": "CARD_COST", "build": "BUILD_COST", "tensor": "TENSOR_COST"}


def fit_constants(rows: list, chip: Optional[ChipSpec] = None) -> dict:
    """The traffic model's constants fitted to the measured rows.  For each
    kernel, over the rows that run it alone: the launch cost, the costs of
    the busiest SM's gathered and staged words and of the card's words
    (lookup kernels and dequant-matmuls), of a table byte built (lookup
    kernels) and of a tensor operation (dequant-matmuls and the dense
    matmul) that minimise the sum of squared log errors of the predicted
    device time, by coordinate descent over the grids above
    (``_FIT_ROUNDS`` passes, each parameter in turn, from launch, card and
    build costs 0 and unit costs).  Returns ``{"LAUNCH_S": ...,
    "LOOKUP_COST": ..., "STAGE_COST": ..., "CARD_COST": ...,
    "BUILD_COST": ..., "TENSOR_COST": ...}``."""
    chip = chip or default_chip()
    by_kernel = {}
    for r in rows:
        if "Measured_us" in r:
            t = _fit_terms(r, chip)
            if t is not None:
                by_kernel.setdefault(t[0], []).append(t[1:])
    out = {table: {} for table in _FIT_TABLES.values()}
    for k, ts in sorted(by_kernel.items()):
        n, hbm, gath, stage, card, build, tens, meas = (np.array(v, dtype=np.float64)
                                                        for v in zip(*ts))
        names = ["launch"] + (["lookup", "stage", "card"] if k in traffic.LOOKUP_COST else [])
        names += ["build"] if k in traffic.BUILD_COST else []
        names += ["tensor"] if k in traffic.TENSOR_COST else []
        p = {"launch": 0.0, "lookup": 1.0, "stage": 1.0, "card": 0.0, "build": 0.0, "tensor": 1.0}

        def loss(name, vals):
            q = {**p, name: vals[:, None]}
            smem = q["lookup"] * gath + q["stage"] * stage + q["card"] * card
            m = np.maximum(np.maximum(hbm, smem), q["tensor"] * tens)
            return (np.log((q["launch"] * n + q["build"] * build + m) / meas) ** 2).sum(axis=1)

        for _ in range(_FIT_ROUNDS):
            for name in names:
                grid = _FIT_GRIDS[name]
                p[name] = float(grid[int(np.argmin(loss(name, grid)))])
        for name in names:
            out[_FIT_TABLES[name]][k] = round(p[name], 9) if name == "launch" else p[name]
    return out


def refresh_csv(path=SWEEP_CSV) -> None:
    """Rewrite a measured sweep CSV's model columns (and ``Pred_over_meas``)
    at the model's current constants, keeping its header lines and its
    measured columns: after the constants are refitted."""
    with open(path) as f:
        header = [ln[2:].rstrip("\n") for ln in f if ln.startswith("# ")]
    rows = []
    for r in read_csv(path):
        cfg, d_out, batch = WORKLOADS[r["VQ_type"]]
        row = model_row(r["VQ_type"], r["Strategy"], cfg, d_out, batch)
        if "Measured_us" in r:
            row.update(Measured_us=r["Measured_us"], Events_us=r["Events_us"],
                       Pred_over_meas=round(row["Pred_us"] / r["Measured_us"], 4))
        rows.append(row)
    with open(path, "w", newline="") as f:
        write_csv(f, rows, COLUMNS + MEASURED_COLUMNS, tuple(header))


def pred_errors(rows: list, chip: Optional[ChipSpec] = None) -> list:
    """(workload, strategy, predicted / measured - 1) of every measured row,
    at the model's current constants."""
    chip = chip or default_chip()
    out = []
    for r in rows:
        if "Measured_us" in r:
            cfg, d_out, batch = WORKLOADS[r["VQ_type"]]
            pred = SWEEP_STRATEGIES[r["Strategy"]](cfg, d_out, batch).time_s(chip)
            out.append((r["VQ_type"], r["Strategy"], pred / (r["Measured_us"] * 1e-6) - 1))
    return out


def crossovers(rows: list) -> dict:
    """For each Llama projection shape, the fewest rows at which the
    fastest measured exact-tier strategy is ``dequant_mm`` from there on
    (None: ``lut_gemv`` is fastest at every measured row)."""
    meas = {(r["VQ_type"], r["Strategy"]): r["Measured_us"] for r in rows
            if "Measured_us" in r}
    out = {}
    for (m, p) in LLAMA_PROJECTIONS:
        lut_wins = [b for b in LLAMA_ROWS
                    if meas.get((f"LLAMA{m}_{p}_B{b}", "lut_gemv"), math.inf)
                    < meas.get((f"LLAMA{m}_{p}_B{b}", "dequant_mm"), math.inf)]
        out[m, p] = next((b for b in LLAMA_ROWS if not any(w >= b for w in lut_wins)), None)
    return out


if __name__ == "__main__":
    import sys

    if "--refresh" in sys.argv:
        refresh_csv()
    elif "--fit" in sys.argv:
        data = read_csv()
        for name, consts in fit_constants(data).items():
            print(f"{name} = {consts!r}")
        errs = pred_errors(data)
        worst = max(errs, key=lambda e: abs(e[2]))
        print(f"# {len(errs)} measured rows; worst predicted/measured - 1: {worst}")
        print(f"# crossovers (rows from which dequant_mm is fastest): {crossovers(data)}")
    else:
        args = [a for a in sys.argv[1:] if not a.startswith("--")]
        path = args[0] if args else "dataflow_sweep.csv"
        rows = run_sweep(out_path=path, measure="--measure" in sys.argv)
        for r in rows:
            print(f"{r['VQ_type']:22s} {r['Strategy']:14s} B={r['Batch']:<4d} "
                  f"HBM={r['Total_HBM_MB']:9.3f}MB pred={r['Pred_us']:9.3f}us "
                  f"bound={r['Bound']} roofline={r['Roofline_frac']:.3f}")
        print(f"\nwrote {path}")
