"""The batcher's decode roll as graphs (``tpu_lutvq_torch.runtime.decode_graph``)
on a tiny model, with a CPU stand-in for the card's graphs, and the
benchmark's readers of the replays (``decode_graph_pct``,
``decode_graph_roofline``).

The stand-in does to the program's state what a CUDA graph does, as far as
the CPU can: a capture computes nothing (the roll runs once with the
caches, the generator and the launch counters put back, and its output is
poisoned), and a replay runs the roll again reading only the static
buffers, with the counters put back, writing a poisoned output anew.  A
replay fails if an attribute of the batcher that the captured roll read
has changed since (a graph would replay the old value).  The rest of what
a graph fixes at capture is not held fixed here, since a replay runs the
roll's host code again: host state outside the batcher (a plan chosen from
host values in a kernel's module), and a value read back from the device
(the card refuses that inside a capture; the CPU path reads some by
design).  Only the card's graphs phase (``chip_smoke.py``) sees those."""

import dataclasses
import math
import time
import types
from collections import deque

import numpy as np
import pytest
import torch

from lutvq_bench.core import spec
from lutvq_bench.core.record import RunRecord, Tick
from lutvq_bench.models.llama import arch
from tpu_lutvq_torch import tracing as port
from tpu_lutvq_torch.kernels import dequant_mm as dq
from tpu_lutvq_torch.models.llama import LlamaConfig, init_llama
from tpu_lutvq_torch.runtime import batching
from tpu_lutvq_torch.runtime.batching import ContinuousBatcher, Request
from tpu_lutvq_torch.runtime.decode_graph import (DecodeGraphs, launch_counters, leaves,
                                                  same_cache_bytes)
from tpu_lutvq_torch.tracing import TickRecord

POISON = -7
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11, 12], [13, 14, 15, 16, 17], [18] * 9,
           [19, 20, 21, 22]]
NEW = [9, 6, 12, 7, 10, 8]
def fingerprint(v):
    """What a capture fixes of a value: a tensor's storage, host data's
    contents, any other object's identity."""
    if isinstance(v, torch.Tensor):
        return ("tensor", v.data_ptr(), tuple(v.shape), v.dtype)
    if isinstance(v, (tuple, list)):
        return tuple(fingerprint(x) for x in v)
    if isinstance(v, np.ndarray):
        return ("array", v.tobytes(), v.shape)
    if isinstance(v, (int, float, str, bool, type(None))):
        return v
    if callable(v):
        return ("fn", getattr(v, "__func__", v))
    if dataclasses.is_dataclass(v):
        return (type(v),) + tuple(fingerprint(getattr(v, f.name)) for f in dataclasses.fields(v))
    return ("object", id(v))


class StandIn:
    """The graph backend on the CPU (``CudaGraphs``' interface)."""

    def __init__(self, batcher):
        self.batcher = batcher
        self.keys = []  # (window, horizon) of each capture, from the roll's arguments
        self.frozen = {}  # batcher attribute → its fingerprint when a capture read it
        roll = batcher._roll

        def recorded(*a):
            if self.capturing:
                self.keys.append((a[4], a[3]))
            return roll(*a)

        self.capturing = False
        batcher._roll = recorded

    def _quiet(self, fn):
        """``fn()`` with the launch counters put back."""
        counters = launch_counters()
        before = [getattr(m, n) for m, n in counters]
        out = fn()
        for (m, n), v in zip(counters, before):
            setattr(m, n, v)
        return out

    def _watched(self, fn):
        """``fn()`` with every batcher attribute it reads fingerprinted."""
        b, frozen = self.batcher, self.frozen
        cls = type(b)

        class Watched(cls):
            def __getattribute__(self, name):
                v = object.__getattribute__(self, name)
                if not name.startswith("__"):
                    frozen.setdefault(name, fingerprint(v))
                return v

        b.__class__ = Watched
        self.capturing = True
        try:
            return fn()
        finally:
            b.__class__ = cls
            self.capturing = False

    def capture(self, fn):
        b = self.batcher
        saved = [t.clone() for t in leaves(b.caches)]
        state = b.generator.get_state()
        out = self._watched(fn)  # counted, as a capture's host code is
        for t, s in zip(leaves(b.caches), saved):
            t.copy_(s)
        b.generator.set_state(state)
        out.fill_(POISON)

        def replay():
            changed = [k for k, f in self.frozen.items() if fingerprint(getattr(b, k)) != f]
            assert not changed, f"the captured roll read {changed}, changed since the capture"
            out.fill_(POISON)
            t0 = time.perf_counter()
            out.copy_(self._quiet(fn))
            secs = time.perf_counter() - t0
            return lambda: secs

        return replay, out


@pytest.fixture(scope="module")
def tiny():
    cfg = LlamaConfig.tiny(max_seq=64)
    return cfg, init_llama(cfg, torch.Generator().manual_seed(3), dtype=torch.float32)


@pytest.fixture(scope="module")
def long_model():
    cfg = LlamaConfig.tiny(n_layers=1, max_seq=512)
    return cfg, init_llama(cfg, torch.Generator().manual_seed(5), dtype=torch.float32)


PAGED = dict(paged_blocks=24, paged_block_size=16)
MODES = {"slab": {}, "paged": PAGED, "stacked": dict(stacked_kv=True)}


def batcher(model, graphed, **kw):
    cfg, w = model
    b = ContinuousBatcher(cfg, w, strategy="dequant_mm", seed=11, **kw)
    if graphed:
        b._graphs = DecodeGraphs(b.generator, backend=StandIn(b))
    return b


def serve(model, graphed, prompts=PROMPTS, new=NEW, temperature=0.0, horizon=4,
          pipeline=False, **kw):
    """Every request through a fresh batcher: ({id: output}, batcher)."""
    b = batcher(model, graphed, **kw)
    for i, (p, n) in enumerate(zip(prompts, new)):
        b.submit(Request(i, list(p), n, temperature=temperature))
    done = b.run(horizon=horizon, pipeline=pipeline)
    return {r.req_id: list(r.output) for r in done}, b


def records_of(b) -> list:
    return [r for r in port.TICKS if r.batcher == b.batcher_id]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("horizon", [1, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_replays_give_the_eager_tokens_and_caches(tiny, mode, horizon, pipeline, temperature):
    """Slab, paged and stacked caches, horizons 1 and 4, pipelined or not,
    greedy or sampled from the same seed: the graphed batcher's tokens and
    cache bytes are the eager one's (a paged pool's junk block left out:
    its duplicate writes land in no fixed order, eager against eager too),
    and replays served most of its steps."""
    kw = dict(temperature=temperature, horizon=horizon, pipeline=pipeline, n_slots=4,
              **MODES[mode])
    want, eager = serve(tiny, False, **kw)
    got, graphed = serve(tiny, True, **kw)
    assert got == want
    assert same_cache_bytes(graphed.caches, eager.caches)
    assert torch.equal(graphed.generator.get_state(), eager.generator.get_state())
    recs = records_of(graphed)
    assert sum(r.replayed for r in recs) > sum(r.steps for r in recs) / 2
    assert not any(r.replayed for r in records_of(eager))


def test_one_capture_per_window_and_horizon(tiny, long_model):
    """A key is captured once, at its second tick, whatever the tick's
    slots: windows 256 and 512 at horizon 4, and horizon 1 near max_seq."""
    prompts = [[1 + j % 200 for j in range(240)], [5, 6, 7], [9] * 30]
    got, b = serve(long_model, True, prompts=prompts, new=[40, 30, 12], n_slots=3)
    assert got == serve(long_model, False, prompts=prompts, new=[40, 30, 12], n_slots=3)[0]
    assert sorted(b._graphs.graphs) == [(256, 4), (512, 4)]
    assert sorted(b._graphs.backend.keys) == sorted(b._graphs.graphs)
    # near max_seq the roll falls back to single steps: (64, 1) joins (64, 4)
    got, b = serve(tiny, True, prompts=[[3] * 41, [4] * 10], new=[23, 8], n_slots=2)
    assert got == serve(tiny, False, prompts=[[3] * 41, [4] * 10], new=[23, 8], n_slots=2)[0]
    assert b._graphs.seen == {(64, 4), (64, 1)} and (64, 4) in b._graphs.graphs
    assert sorted(b._graphs.backend.keys) == sorted(b._graphs.graphs)


def test_pipelined_ticket_survives_the_next_dispatch(tiny):
    """Tick k's tokens are a copy: dispatching tick k+1 (a replay that
    rewrites the static output) leaves them as they were."""
    b = batcher(tiny, True, n_slots=4)
    for i, (p, n) in enumerate(zip(PROMPTS[:4], NEW)):
        b.submit(Request(i, list(p), n))
    prev = b._dispatch_tick(2)
    for _ in range(3):  # after the eager tick: a capture and its replay, then a replay
        held = prev["toks"].clone()
        nxt = b._dispatch_tick(2, prev=prev)
        assert torch.equal(prev["toks"], held)
        b._collect_tick(prev)
        prev = nxt
    assert prev["record"].replayed == 2 and not (prev["toks"] == POISON).any()
    b._collect_tick(prev)


def test_launch_counters_count_replays_as_launches(tiny, monkeypatch):
    """A counter bumped inside the roll reads the eager run's total after a
    graphed run: the capture takes its counts back, each replay adds them."""
    sample = batching.sample_logits_vec

    def counted(*a, **kw):
        dq.DEQUANT_MM_LAUNCHES += 3
        return sample(*a, **kw)

    monkeypatch.setattr(batching, "sample_logits_vec", counted)
    totals = []
    for graphed in (False, True):
        monkeypatch.setattr(dq, "DEQUANT_MM_LAUNCHES", 0)
        _, b = serve(tiny, graphed, n_slots=4)
        totals.append(dq.DEQUANT_MM_LAUNCHES)
    assert totals[0] == totals[1] > 0
    assert b._graphs.graphs and all(ds == [((dq, "DEQUANT_MM_LAUNCHES"), 3 * h)]
                                    for (_, h), (_, _, ds) in b._graphs.graphs.items())
    assert len(launch_counters()) == 15


def test_tick_record_counts_replayed_steps(tiny):
    """Each key's first tick is eager (``replayed`` 0); every later tick of
    the key is a replay of all its steps."""
    _, b = serve(tiny, True, n_slots=4, horizon=4)
    recs = [r for r in records_of(b) if r.steps]
    assert all(r.replayed in (0, r.steps) for r in recs)
    assert sum(r.replayed == 0 for r in recs) == len(b._graphs.seen) == 1
    assert recs[0].replayed == 0 and all(r.replayed == 4 for r in recs[1:])


def test_cpu_batcher_stays_eager(tiny):
    assert batcher(tiny, False)._graphs is None


def test_profiled_key_stays_eager(tiny):
    """A key met while a profiler runs is not captured until it stops."""
    b = batcher(tiny, True, n_slots=4)
    for i, (p, n) in enumerate(zip(PROMPTS[:4], NEW)):
        b.submit(Request(i, list(p), n))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            b.step(horizon=2)
    assert not b._graphs.graphs and b._graphs.seen == {(64, 2)}
    b.step(horizon=2)
    assert list(b._graphs.graphs) == [(64, 2)] and records_of(b)[-1].replayed == 2


def test_stand_in_refuses_host_state_changed_since_capture(tiny, monkeypatch):
    """A roll that reads the batcher's host positions (which change every
    tick) fails at its first replay: a graph would replay the values its
    capture saw."""
    roll = ContinuousBatcher._roll

    def reads_host(self, tok_vec, pos_dev, temps_dev, horizon, window):
        return roll(self, tok_vec, pos_dev, temps_dev + 0 * float(self.slot_pos.max()), horizon,
                    window)

    monkeypatch.setattr(ContinuousBatcher, "_roll", reads_host)
    with pytest.raises(AssertionError, match="slot_pos"):
        serve(tiny, True, n_slots=4)


def test_replays_reach_the_account_with_their_device_seconds(tiny):
    """A replayed tick's record holds the seconds its replay's timer gave
    at collect; an eager tick's holds none.  ``_decode`` still returns the
    roll's (horizon, B) tokens alone, eager or replayed (a wrapper of it
    reads them)."""
    b = batcher(tiny, True, n_slots=4)
    decode, shapes = b._decode, []

    def watched(*a, **kw):
        out = decode(*a, **kw)
        shapes.append(tuple(out.shape))
        return out

    b._decode = watched
    for i, (p, n) in enumerate(zip(PROMPTS, NEW)):
        b.submit(Request(i, list(p), n))
    b.run(horizon=4, pipeline=True)
    recs = [r for r in records_of(b) if r.steps]
    assert shapes == [(r.steps, 4) for r in recs]
    assert all(math.isfinite(r.replay_s) and r.replay_s > 0 for r in recs if r.replayed)
    assert all(math.isnan(r.replay_s) for r in recs if not r.replayed)
    assert any(r.replayed for r in recs) and not all(r.replayed for r in recs)


# -- the benchmark's reader ------------------------------------------------------


def synthetic(monkeypatch, replayed=(0, 4, 0, 4, 4, 4, 0), drop_first=False, account=None):
    """A window of [10, 20] s: a tick before it, a wave that decoded, a
    decode-only tick, a profiled tick, a single prefill, another
    decode-only tick and a tick after the window."""
    spans = [(9.0, 10.0), (10.0, 10.5), (10.5, 11.0), (11.0, 11.5), (11.5, 12.0),
             (12.0, 12.5), (20.5, 21.0)]
    rec = RunRecord(model={}, mix={}, t_start=0.0, window_open=10.0, window_end=20.0)
    rec.slice_span = (11.0, 11.5)
    ticks = deque(maxlen=4096)
    for i, ((s, e), n) in enumerate(zip(spans, replayed)):
        rec.ticks.append(Tick(i, s, e, [], [0, 0], 4, 8, 2, traced=i == 3))
        if drop_first and i == 1:
            continue
        r = TickRecord(0, s + 0.001, s + 0.01, s + 0.3, e - 0.001, [], 4, n)
        ticks.append(r if account is None else account(r))
    monkeypatch.setattr(port, "TICKS", ticks)
    return rec


def test_decode_graph_pct_reads_the_window(monkeypatch):
    # ticks 1, 2, 4, 5: 4 steps each, the profiled tick 3 left out
    for name in ("decode_graph_pct", "decode_graph_pct.yi34b"):
        assert spec.reader(name)(synthetic(monkeypatch)) == pytest.approx(100 * 12 / 16)
    assert spec.reader("decode_graph_pct")(synthetic(monkeypatch, (4,) * 7)) == 100.0
    assert spec.reader("decode_graph_pct")(synthetic(monkeypatch, (0,) * 7)) == 0.0


def test_decode_graph_pct_none_cases(monkeypatch):
    read = spec.reader("decode_graph_pct")
    assert read(synthetic(monkeypatch, drop_first=True)) is None  # the account lost tick 1

    def older(r):  # a program whose account keeps no replays
        return types.SimpleNamespace(**{k: v for k, v in vars(r).items() if k != "replayed"})

    assert read(synthetic(monkeypatch, account=older)) is None
    rec = synthetic(monkeypatch, account=lambda r: TickRecord(**{**vars(r), "steps": 0,
                                                                 "replayed": 0}))
    assert read(rec) is None  # no tick decoded
    rec = synthetic(monkeypatch)
    monkeypatch.delattr(port, "TICKS")  # a program without the account
    assert read(rec) is None


MISTRAL = arch(spec.load_json(spec.BENCH / "configs" / "mistral-7b-v0.3-aqlm2x8.json"))


def roofline_window(monkeypatch, secs=(0.02, 0.02, math.nan, 0.02, 0.02, 0.02, 0.02),
                    replayed=(4, 4, 0, 4, 4, 4, 4), account=None):
    """``synthetic``'s window, two slots at positions 100 and 900, each
    tick's replay timed at ``secs``."""
    spans = [(9.0, 10.0), (10.0, 10.5), (10.5, 11.0), (11.0, 11.5), (11.5, 12.0),
             (12.0, 12.5), (20.5, 21.0)]
    rec = RunRecord(model=MISTRAL, mix={}, t_start=0.0, window_open=10.0, window_end=20.0)
    rec.slice_span = (11.0, 11.5)
    ticks = deque(maxlen=4096)
    for i, ((s, e), n, t) in enumerate(zip(spans, replayed, secs)):
        rec.ticks.append(Tick(i, s, e, [], [100, 900], 4, 8, 2, traced=i == 3))
        r = TickRecord(0, s + 0.001, s + 0.01, s + 0.3, e - 0.001, [], 4, n, t)
        ticks.append(r if account is None else account(r))
    monkeypatch.setattr(port, "TICKS", ticks)
    return rec


def test_decode_graph_roofline_reads_the_window(monkeypatch):
    """Ticks 1, 4 and 5 count (tick 0 and 6 lie outside the window, tick 2
    ran eager, tick 3 is profiled): their steps' bound over their replays'
    seconds."""
    mod = spec.reader_module("decode_graph_roofline")
    step = sum(mod.step_bound_s(MISTRAL, 2, [100 + h + 1, 900 + h + 1]) for h in range(4))
    for name in ("decode_graph_roofline", "decode_graph_roofline.yi34b"):
        got = spec.reader(name)(roofline_window(monkeypatch))
        assert got == pytest.approx(100 * 3 * step / (3 * 0.02))


def test_decode_graph_roofline_step_bound_counts_every_weight_byte():
    """One row and no context: the bound is HBM's time to read each layer's
    codes, codebooks and scales (and the row in and out), and the bf16 head."""
    m, w = MISTRAL, MISTRAL["weights"]
    h, f = m["hidden"], m["ffn"]
    q, kv = m["heads"] * m["head_dim"], m["kv_heads"] * m["head_dim"]
    layer = 0.0
    for d_in, d_out in [(h, q), (h, kv), (h, kv), (q, h), (h, f), (h, f), (f, h)]:
        layer += d_in * d_out * 2 / 8 + 2 * 256 * 8 * 2 + d_out * 2 + d_in * 2 + d_out * 2
    head = 2 * (m["vocab"] * h + h + m["vocab"])
    want = (m["layers"] * layer + head) / 3.35e12
    got = spec.reader_module("decode_graph_roofline").step_bound_s(m, 1, [])
    assert got == pytest.approx(want)
    assert w["codebooks"] == 2 and w["code_bits"] == 8 and w["group"] == 8


def test_decode_graph_roofline_none_cases(monkeypatch):
    read = spec.reader("decode_graph_roofline")

    def older(r):  # a program whose account keeps no replay seconds
        return types.SimpleNamespace(**{k: v for k, v in vars(r).items() if k != "replay_s"})

    assert read(roofline_window(monkeypatch, account=older)) is None
    assert read(roofline_window(monkeypatch, replayed=(0,) * 7)) is None  # nothing replayed
    assert read(roofline_window(monkeypatch, secs=(math.nan,) * 7)) is None  # never timed
    rec = roofline_window(monkeypatch)
    rec.batcher_seen = False
    assert read(rec) is None
    rec = roofline_window(monkeypatch)
    monkeypatch.delattr(port, "TICKS")  # a program without the account
    assert read(rec) is None
