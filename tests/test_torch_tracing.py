"""The port's spans and tick account (``tpu_lutvq_torch.tracing``)
on a tiny batcher, the benchmark readers of the account, and the program
names the benchmark's outside view still depends on."""

import importlib
import json
from collections import deque

import pytest
import torch

from lutvq_bench.core import spec, tracing
from lutvq_bench.core.record import RunRecord, Tick
from lutvq_bench.loops import closed
from tpu_lutvq_torch import tracing as port
from tpu_lutvq_torch.models.llama import LlamaConfig, init_llama
from tpu_lutvq_torch.runtime import batching
from tpu_lutvq_torch.runtime.batching import ContinuousBatcher, Request
from tpu_lutvq_torch.tracing import Admission, TickRecord

CPU = torch.device("cpu")
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11, 12], [13, 14, 15, 16, 17]]
NEW = [5, 3, 6, 4]


@pytest.fixture(scope="module")
def tiny():
    cfg = LlamaConfig.tiny(max_seq=64)
    return cfg, init_llama(cfg, torch.Generator().manual_seed(3), dtype=torch.float32)


@pytest.fixture(scope="module")
def long_model():
    cfg = LlamaConfig.tiny(n_layers=1, max_seq=512)
    return cfg, init_llama(cfg, torch.Generator().manual_seed(5), dtype=torch.float32)


def serve(model, prompts=PROMPTS, new=NEW, **kw) -> tuple:
    """Every request through a fresh batcher: ({id: output}, batcher)."""
    cfg, w = model
    b = ContinuousBatcher(cfg, w, strategy="dequant_mm", **kw)
    for i, (p, n) in enumerate(zip(prompts, new)):
        b.submit(Request(i, list(p), n))
    return {r.req_id: list(r.output) for r in b.run(horizon=2)}, b


def lutvq_events(prof, tmp_path) -> list:
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("name", "").startswith("lutvq.")]


# -- spans -----------------------------------------------------------------------


def test_span_off_is_the_shared_null_and_enters_no_range(tiny, monkeypatch):
    """With no profiler running a span site enters nothing: no range is
    made during a whole run; under a profiler the same sites make them."""
    made = []
    record = port._RECORD
    monkeypatch.setattr(port, "_RECORD", lambda name: made.append(name) or record(name))
    assert port.span("lutvq.tick") is port.span("lutvq.layer") is port._NULL
    with port.span("lutvq.tick") as v:
        assert not v
    with pytest.raises(KeyError):  # the null context swallows nothing
        with port.span("lutvq.tick"):
            raise KeyError("x")
    serve(tiny, n_slots=2)
    assert made == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        serve(tiny, n_slots=2)
    assert {"lutvq.tick", "lutvq.layer", "lutvq.proj"} <= set(made)
    n = len(made)
    serve(tiny, n_slots=2)  # the profiler gone, no range again
    assert len(made) == n


def test_span_closes_its_range_when_the_body_raises(tmp_path):
    """Under a profiler a span is one range, closed when its body raises,
    and the exception passes through it."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with port.span("lutvq.test"):
            pass
        with pytest.raises(KeyError):
            with port.span("lutvq.test"):
                raise KeyError("x")
        with port.span("lutvq.test"):
            pass
    assert [e["name"] for e in lutvq_events(prof, tmp_path)] == ["lutvq.test"] * 3


@pytest.mark.parametrize("chunk", [None, 4])
def test_spans_nest_on_one_thread(tiny, tmp_path, chunk):
    """Under the profiler every ``lutvq.*`` range lies on one thread and
    ranges nest: a layer inside an admission, a prefill chunk or a decode
    step, each of those inside a tick, and every projection and attention
    inside a layer."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        serve(tiny, n_slots=2, prefill_chunk=chunk)
    ev = lutvq_events(prof, tmp_path)
    assert len({e["tid"] for e in ev}) == 1
    names = {e["name"] for e in ev}
    want = {"lutvq.tick", "lutvq.admit", "lutvq.decode_step", "lutvq.layer", "lutvq.proj",
            "lutvq.attn", "lutvq.kv_write", "lutvq.norm", "lutvq.rope", "lutvq.head",
            "lutvq.sample", "lutvq.stage", "lutvq.collect"}
    assert want <= names
    assert ("lutvq.prefill_chunk" in names) == (chunk is not None)
    iv = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in ev),
                key=lambda x: (x[0], -x[1]))
    eps = 1e-3  # µs
    stack, parents = [], {}
    for s, e, name in iv:
        while stack and stack[-1][1] <= s + eps:
            stack.pop()
        if stack:
            assert e <= stack[-1][1] + eps, (name, "crosses", stack[-1][2])
        parents.setdefault(name, set()).add(tuple(x[2] for x in stack))
        stack.append((s, e, name))

    def always_inside(name, outer):
        return all(set(outer) & set(chain) for chain in parents[name])

    assert always_inside("lutvq.proj", {"lutvq.layer"})
    assert always_inside("lutvq.attn", {"lutvq.layer"})
    assert always_inside("lutvq.kv_write", {"lutvq.attn"})
    assert always_inside("lutvq.rope", {"lutvq.layer"})
    assert always_inside("lutvq.norm", {"lutvq.layer", "lutvq.head"})
    assert always_inside("lutvq.layer", {"lutvq.admit", "lutvq.decode_step"})
    assert always_inside("lutvq.decode_step", {"lutvq.tick"})
    assert always_inside("lutvq.admit", {"lutvq.tick"})
    assert always_inside("lutvq.collect", {"lutvq.tick"})
    if chunk:
        assert always_inside("lutvq.prefill_chunk", {"lutvq.admit"})
        assert any("lutvq.prefill_chunk" in chain for chain in parents["lutvq.layer"])


@pytest.mark.parametrize("pipeline", [False, True])
def test_tokens_equal_with_the_profiler_on_and_off(tiny, pipeline):
    cfg, w = tiny
    outs = []
    for on in (False, True):
        b = ContinuousBatcher(cfg, w, n_slots=2, strategy="dequant_mm")
        for i, (p, n) in enumerate(zip(PROMPTS, NEW)):
            b.submit(Request(i, list(p), n))
        if on:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                done = b.run(horizon=2, pipeline=pipeline)
        else:
            done = b.run(horizon=2, pipeline=pipeline)
        outs.append({r.req_id: r.output for r in done})
    assert outs[0] == outs[1] and len(outs[0]) == len(PROMPTS)


# -- the tick account ------------------------------------------------------------


def records_of(b) -> list:
    return [r for r in port.TICKS if r.batcher == b.batcher_id]


def test_account_of_a_scripted_run(long_model):
    """A wave of prompts of 100 and 300 tokens computes 2 x 512 rows, 400 of
    them real (60.9 % padding); then a single prefill and a chunked one,
    each its prompt's own rows; every tick's roll and stamps are recorded."""
    cfg, w = long_model
    b = ContinuousBatcher(cfg, w, n_slots=4, strategy="dequant_mm", prefill_chunk=320)
    lens = {0: 100, 1: 300, 2: 50, 3: 400}
    script = [[0, 1], [2], [3], [], [], []]
    for ids in script:
        for i in ids:
            b.submit(Request(i, [1 + (i + j) % 200 for j in range(lens[i])], 4))
        b.step(horizon=2)
    while b.has_work:
        b.step(horizon=2)
    recs = records_of(b)
    assert b._chunked_prefill is not None  # the 400-token prompt goes in chunks
    assert [[(a.prompt_lens, a.rows) for a in r.admissions] for r in recs[:3]] == [
        [([100, 300], 1024)], [([50], 50)], [([400], 400)]]
    wave = recs[0].admissions[0]
    assert 100 * (wave.rows - sum(wave.prompt_lens)) / wave.rows == pytest.approx(60.9375)
    assert all(not r.admissions for r in recs[3:]) and all(r.steps == 2 for r in recs)
    assert sum(len(q.output) for q in b.completed) == 16
    for r in recs:
        assert r.t_start <= r.t_admitted <= r.t_dispatched <= r.t_end
        assert not any(isinstance(v, torch.Tensor) for v in vars(r).values())


def test_account_pipelined_and_bounded(tiny, monkeypatch):
    """``run(pipeline=True)`` keeps one record a ticket; the account keeps
    the newest ``maxlen`` records."""
    assert port.TICKS.maxlen == 4096 and batching.TICKS is port.TICKS
    cfg, w = tiny
    b = ContinuousBatcher(cfg, w, n_slots=2, strategy="dequant_mm")
    for i, (p, n) in enumerate(zip(PROMPTS, NEW)):
        b.submit(Request(i, list(p), n))
    b.run(horizon=2, pipeline=True)
    recs = records_of(b)
    admitted = sorted(n for r in recs for a in r.admissions for n in a.prompt_lens)
    assert admitted == sorted(len(p) for p in PROMPTS)  # each request once
    for r in recs:
        assert r.t_start <= r.t_admitted <= r.t_dispatched <= r.t_end and r.steps == 2
    small = deque(maxlen=3)
    monkeypatch.setattr(batching, "TICKS", small)
    _, b = serve(tiny, n_slots=2)
    assert len(small) == 3 and small[0].t_end <= small[1].t_end <= small[2].t_end
    assert all(r.batcher == b.batcher_id for r in small) and not records_of(b)


def test_ticket_keeps_what_the_benchmark_loop_reads(tiny):
    """A tick's ticket still carries the keys the benchmark's closed loop
    reads (``loops/closed.py::_view``), with the values it expects."""
    cfg, w = tiny
    b = ContinuousBatcher(cfg, w, n_slots=4, strategy="dequant_mm")
    for i, p in enumerate(PROMPTS[:3]):
        b.submit(Request(i, list(p), 4))
    ticket = b._dispatch_tick(2)
    assert {"deferred", "pos", "slots", "h", "toks", "reqs"} <= set(ticket)
    admitted, positions, steps = closed._view(ticket)
    assert admitted == [3, 7, 2] and positions == [3, 7, 2] and steps == 2
    b._collect_tick(ticket)


def test_benchmark_targets_resolve_in_the_port():
    """Every entry point the benchmark's traced run wraps still resolves,
    so no existing per-layer metric silently reads nothing."""
    for module, path, _ in tracing.TARGETS:
        owner = importlib.import_module(module)
        for part in path.split("."):
            owner = getattr(owner, part)
        assert callable(owner), (module, path)
    tr = tracing.Tracer(CPU)
    tr._install()
    try:
        assert tr.missing == [] and len(tr._installed) == len(tracing.TARGETS)
    finally:
        tr._uninstall()


# -- the benchmark's readers of the account --------------------------------------


def synthetic(monkeypatch, drop_first=False):
    """A window of [10, 20] s: a tick before it, a wave, a decode-only tick,
    a profiled decode-only tick, a single prefill, another decode-only tick,
    and a tick after the window; the account holds each tick's record."""
    spans = [(9.0, 10.0), (10.0, 10.5), (10.5, 11.0), (11.0, 11.5), (11.5, 12.0),
             (12.0, 12.5), (20.5, 21.0)]
    wave = [Admission([100, 300], 1024)]
    single = [Admission([50], 50)]
    admits = [wave, wave, [], [], single, [], single]
    dispatch = [0.1, 0.3, 0.4, 0.01, 0.2, 0.2, 0.1]
    rec = RunRecord(model={}, mix={}, t_start=0.0, window_open=10.0, window_end=20.0)
    rec.slice_span = (11.0, 11.5)
    ticks = deque(maxlen=4096)
    for i, ((s, e), adm, d) in enumerate(zip(spans, admits, dispatch)):
        rec.ticks.append(Tick(i, s, e, [n for a in adm for n in a.prompt_lens], [0, 0], 4, 8, 2,
                              traced=i == 3))
        if drop_first and i == 1:
            continue
        ticks.append(TickRecord(0, s + 0.001, s + 0.01, s + 0.01 + d, e - 0.001, adm, 4))
    monkeypatch.setattr(port, "TICKS", ticks)
    return rec


def test_readers_of_the_account(monkeypatch):
    rec = synthetic(monkeypatch)
    pad = spec.reader("prefill_pad_pct")(rec)
    assert pad == pytest.approx(100 * (1074 - 450) / 1074)  # the window's wave and single
    assert spec.reader("prefill_pad_pct.yi34b")(rec) == pad
    # ticks 2 and 5: admitted nothing, outside the slice; 4 steps each
    assert spec.reader("decode_dispatch_ms")(rec) == pytest.approx(1e3 * (0.4 + 0.2) / 8)
    assert spec.reader("decode_dispatch_ms")(rec) <= spec.reader("decode_step_ms")(rec)


@pytest.mark.parametrize("metric", ["prefill_pad_pct", "decode_dispatch_ms"])
def test_readers_need_the_window_first_tick(monkeypatch, metric):
    assert spec.reader(metric)(synthetic(monkeypatch, drop_first=True)) is None
    rec = synthetic(monkeypatch)
    monkeypatch.delattr(port, "TICKS")  # a program without the account
    assert spec.reader(metric)(rec) is None
