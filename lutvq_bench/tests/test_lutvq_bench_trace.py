"""The trace reduction and the readers, on a trace and a record made by hand."""

import pytest

from lutvq_bench.core import spec
from lutvq_bench.core.record import RunRecord, Served, Tick
from lutvq_bench.core.tracing import reduce_events

MAIN = 7


def x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def events():
    """A 100 µs slice: one tick, one projection launching two kernels (one
    of them by external id only), an attention call whose kernel never came
    back, and an aten op open during the idle gap."""
    return [
        x("user_annotation", "lb/slice#0", 0, 100),
        x("user_annotation", "lb/tick#1", 1, 98),
        x("user_annotation", "lb/proj#2", 2, 20, **{"External id": 50}),
        x("cuda_runtime", "cudaLaunchKernel", 3, 1, correlation=100),
        x("kernel", "dequant_mm_bf16x2", 10, 10, tid=0, correlation=100),
        x("kernel", "fold", 20, 5, tid=0, correlation=999, **{"External id": 50}),
        x("user_annotation", "lb/attn#3", 30, 20),
        x("cuda_runtime", "cudaLaunchKernelExC", 31, 1, correlation=101),
        x("cpu_op", "aten::mul", 40, 40),
        x("cuda_runtime", "cudaLaunchKernel", 41, 1, correlation=102),
        x("kernel", "elementwise", 60, 10, tid=0, correlation=102),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
    ]


def test_reduce_ties_activity_to_spans():
    s = reduce_events(events())
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(25e-6)  # [10, 25) and [60, 70)
    assert s.kernels == 3
    assert s.span_device_s["proj#2"] == pytest.approx(15e-6)
    assert s.span_device_s["tick#1"] == pytest.approx(25e-6)
    assert s.span_complete["proj#2"] and not s.span_complete["attn#3"]
    assert s.launches_matched == pytest.approx(2 / 3)
    gaps = dict(s.idle_gaps)
    # each gap goes to what the main thread had open when it began
    assert gaps["host/python"] == pytest.approx(10e-6)  # [0, 10): the slice alone
    assert gaps["tick/python"] == pytest.approx(35e-6)  # [25, 60): the tick, no op
    assert gaps["tick/aten::mul"] == pytest.approx(30e-6)  # [70, 100): inside aten::mul
    assert sum(gaps.values()) == pytest.approx(75e-6)
    assert s.device_ops[0] == ["dequant_mm_bf16x2", pytest.approx(10e-6)]


def record():
    model = {"vocab": 100, "hidden": 64, "ffn": 128, "layers": 2, "heads": 4, "kv_heads": 2,
             "head_dim": 16, "max_seq": 64, "kv_bytes": {"value": 1, "scale": 4},
             "weights": {"group": 8, "codebooks": 2, "code_bits": 8, "codebook_bytes": 2,
                         "scale_bytes": 2}}
    rec = RunRecord(model=model, mix={}, t_start=0.0, window_open=10.0, window_end=20.0)
    rec.ticks = [Tick(0, 9.0, 10.0, [5], [5], 2, 2, 2),
                 Tick(1, 10.0, 12.0, [], [6, 7], 2, 4, 2),
                 Tick(2, 12.0, 15.0, [3], [8, 3], 2, 4, 2, traced=True),
                 Tick(3, 15.0, 20.0, [], [10, 5], 2, 4, 2)]
    a = Served(0, 0, 5, 4, submit_t=8.0, receipts=[(10.0, 1), (12.0, 2), (15.0, 1)], done_t=15.0)
    b = Served(1, 1, 3, 5, submit_t=11.0, receipts=[(15.0, 2), (20.0, 3)], done_t=20.0)
    rec.served = [a, b]
    rec.slice_span = (12.001, 15.4)  # begun after tick 1, stopped after tick 2
    return rec


def test_end_to_end_readers():
    rec = record()
    assert spec.reader("output_tok_s")(rec) == pytest.approx(12 / 10)
    assert spec.reader("setup_s")(rec) == 10.0


def test_request_tails_leave_the_slice_out():
    rec = record()
    # both requests overlap the slice (12.001-15.4): nothing to read
    assert spec.reader("request_tpot_p95_ms")(rec) is None
    assert spec.reader("request_ttft_p95_ms")(rec) is None
    rec.slice_span = None
    # a: (15 - 10) / 3 s a token; b: (20 - 15) / 4
    assert spec.reader("request_tpot_p95_ms")(rec) == pytest.approx(1250 + 0.95 * (5000 / 3 - 1250))
    # first tokens in the window: b's only (a's came at the window's opening)
    assert spec.reader("request_ttft_p95_ms")(rec) == pytest.approx(4000)


def test_host_readers_leave_the_slice_out():
    rec = record()
    assert spec.reader("slot_occupancy_pct")(rec) == 100.0
    # untraced window ticks without admissions: ticks 1 and 3, 7 s over 4 steps
    assert spec.reader("decode_step_ms")(rec) == pytest.approx(1750)
    # kept: a's 10→12 and the zero gap at 12; gone: 12→15 and 15→20, which
    # overlap the slice, and the zero gap of b's receipt inside it
    assert spec.reader("itl_p95_ms")(rec) == pytest.approx(0.85 * 2000)
    rec.slice_span = None  # gaps 0 0 0 0 2 3 5 s
    assert spec.reader("itl_p95_ms")(rec) == pytest.approx(3000 + 0.7 * 2000)


def test_attention_bound_counts_a_chunk_over_the_rows_before_it():
    """A chunk of a chunked prefill (one row at an offset) attends over
    its offset's rows too; a wave's rows are the prompts its tick admitted
    first; a prefill whose position was not read counts nothing."""
    attn = spec.reader_module("attn_roofline")
    rec = record()
    rec.spans = {"prefill#0": {"kind": "prefill", "tick": 2, "rows": 1, "t": 256, "offset": 512},
                 "prefill#1": {"kind": "prefill", "tick": 2, "rows": 2, "t": 8, "offset": 0},
                 "prefill#2": {"kind": "prefill", "tick": 2, "rows": 1, "t": 4, "offset": None}}
    rec.ticks[2].admitted = [3, 5, 7]
    assert attn.queries(rec, {"tick": 2, "phase": ("prefill", "prefill#0")}) == [(256, 768)]
    assert attn.queries(rec, {"tick": 2, "phase": ("prefill", "prefill#1")}) == [(3, 3), (5, 5)]
    assert attn.queries(rec, {"tick": 2, "phase": ("prefill", "prefill#2")}) is None
    assert attn.queries(rec, {"tick": 2, "phase": ("decode", 1)}) == [(1, 10), (1, 5)]


def test_a_tagged_name_reads_through_its_reader():
    """``<reader>.<tag>`` without a file of its own is ``metrics/<reader>.py``."""
    rec = record()
    assert spec.reader("output_tok_s.yi34b")(rec) == spec.reader("output_tok_s")(rec)
    assert spec.reader_module("proj_roofline.yi34b").__file__.endswith("proj_roofline.py")


def test_device_readers_read_nothing_without_a_trace():
    rec = record()
    for name in ("prefill_ms_per_ktok", "launches_per_token", "proj_roofline", "attn_roofline",
                 "step_mfu_pct", "device_idle_pct"):
        assert spec.reader(name)(rec) is None
