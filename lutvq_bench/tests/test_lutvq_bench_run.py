"""A run end to end at a tiny size on the CPU, its refusals, and its faults.

The harness's look for a card is skipped here (the harness is called
directly); the rest of a run goes as on the card: the program's batcher
driven tick by tick, the window, the judge against the reference."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from lutvq_bench.core import harness, spec
from lutvq_bench.tests import tiny

CPU = torch.device("cpu")
# sound runs of the tiny cell read 0 to 0.0294 (seeds 0-11 on the CPU); the
# faults below read 0.84 to 12.2 on seeds 0-3, 9 and 2**31 + 17
TINY_LIMIT = 0.2


def run(seed: int, seconds: float = 2.0):
    import time

    return harness.run(tiny.cell(max_gap=TINY_LIMIT), seed, seconds, False, CPU,
                       time.perf_counter(), log=lambda m: None)[0]


def test_window_drives_submit_and_step_never_run(monkeypatch):
    from tpu_lutvq_torch.runtime.batching import ContinuousBatcher

    def refuse(*a, **k):
        raise AssertionError("the window must not call run()")

    monkeypatch.setattr(ContinuousBatcher, "run", refuse)
    res = run(5)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"output_tok_s", "setup_s"}
    assert list(res)[-1] == "checked"  # the last key of the line
    assert res["checked"]["widest_gap"]["value"] <= TINY_LIMIT


def serve(seed: int, seconds: float = 2.0):
    import time

    return harness.serve(tiny.cell(max_gap=TINY_LIMIT), seed, seconds, False, CPU,
                         time.perf_counter(), log=lambda m: None)[0]


def test_ticks_hold_what_the_batcher_did():
    """Each tick's admissions are the requests whose first token came back
    at its end, and its slots the batcher's: the closed loop refills every
    freed slot at the next tick."""
    rec = serve(7)
    assert rec.batcher_seen
    firsts: dict = {}
    for s in rec.served:
        if s.receipts:
            firsts[s.receipts[0][0]] = firsts.get(s.receipts[0][0], 0) + 1
    for t in rec.ticks:
        assert len(t.admitted) == firsts.get(t.end, 0)
        assert t.steps in (1, tiny.MIX["horizon"]) and len(t.positions) <= t.n_slots
    assert sum(len(t.admitted) for t in rec.ticks) == sum(bool(s.receipts) for s in rec.served)
    assert spec.reader("slot_occupancy_pct")(rec) == 100.0


def test_occupancy_reads_arrivals_held_back(monkeypatch):
    """A batcher that admits only every other tick leaves freed slots empty
    for a tick: the occupancy the run reads falls below 100 %."""
    from tpu_lutvq_torch.runtime.batching import ContinuousBatcher

    orig = ContinuousBatcher._admit
    calls = []

    def every_other(self):
        calls.append(1)
        return orig(self) if len(calls) % 2 or len(calls) <= tiny.MIX["clients"] * 2 else []

    monkeypatch.setattr(ContinuousBatcher, "_admit", every_other)
    rec = serve(7)
    assert 0 < spec.reader("slot_occupancy_pct")(rec) < 95.0


def test_no_ticket_no_batcher_readings(monkeypatch):
    """Where the batcher keeps no ticket to read, the readers that need one
    read nothing rather than a guess."""
    from tpu_lutvq_torch.runtime.batching import ContinuousBatcher

    collect = ContinuousBatcher._collect_tick

    def step(self, horizon=1):
        ticket = self._dispatch_tick(horizon)
        if ticket is not None:
            collect(self, ticket)

    monkeypatch.delattr(ContinuousBatcher, "_collect_tick")
    monkeypatch.setattr(ContinuousBatcher, "step", step)
    rec = serve(7)
    assert not rec.batcher_seen and rec.ticks[0].positions is None
    assert spec.reader("slot_occupancy_pct")(rec) is None
    assert spec.reader("decode_step_ms")(rec) is None
    assert spec.reader("output_tok_s")(rec) > 0


def test_traced_chunked_prefill_spans_each_chunk_at_its_offset():
    """With ``prefill_chunk``, each admitted prompt of the profiled ticks is
    one prefill span a chunk, at consecutive offsets covering its length."""
    import copy
    import time

    cell = tiny.cell(max_gap=TINY_LIMIT)
    cell.mix = copy.deepcopy(cell.mix)
    cell.mix["batcher"]["prefill_chunk"] = 8
    cell.mix["trace"] = {"after_ticks": 1, "ticks": 6}
    rec = harness.serve(cell, 3, 1.5, True, CPU, time.perf_counter(), log=lambda m: None)[0]
    traced = [t for t in rec.ticks if t.traced]
    assert traced and sum(len(t.admitted) for t in traced)
    for t in traced:
        chunks = [m for m in rec.spans.values() if m["kind"] == "prefill" and m["tick"] == t.index]
        assert all(m["rows"] == 1 for m in chunks)  # no wave: these ticks admit one prompt
        covered, at = [], 0
        for m in chunks:
            if m["offset"] == 0 and at:
                covered.append(at)
            assert m["offset"] == (at if m["offset"] else 0)
            at = m["offset"] + m["t"]
        covered += [at] if at else []
        assert covered == t.admitted


def _token_altered(monkeypatch):
    from tpu_lutvq_torch.runtime import batching

    orig = batching.sample_logits_vec
    monkeypatch.setattr(batching, "sample_logits_vec",
                        lambda logits, *a, **k: (orig(logits, *a, **k) + 1) % logits.shape[-1])


def _state_unchanged(monkeypatch):
    from tpu_lutvq_torch.models import llama

    orig = llama.update_cache

    def keep(cache, k, v, pos):
        return cache if k.shape[1] == 1 else orig(cache, k, v, pos)  # decode writes nothing

    monkeypatch.setattr(llama, "update_cache", keep)


def _half_batch(monkeypatch):
    from tpu_lutvq_torch.runtime import batching

    orig = batching.llama_decode_step

    def half(*a, **k):
        logits, caches = orig(*a, **k)
        b = logits.shape[0]
        logits = logits.clone()
        logits[b // 2:] = logits[: b - b // 2]  # the second half left out, given the first's
        return logits, caches

    monkeypatch.setattr(batching, "llama_decode_step", half)


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged, _half_batch],
                         ids=["token_altered", "state_unchanged", "half_batch"])
@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, seed):
    fault(monkeypatch)
    res = run(seed)
    assert not res["correct"]
    assert res["checked"]["widest_gap"]["value"] > TINY_LIMIT


def test_no_card_no_result(monkeypatch, capsys):
    sys.path.insert(0, str(spec.BENCH))
    import run as entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = entry.main(["--workload", "mistral7b-chat-c64", "--seed", "1", "--seconds", "1"])
    assert code != 0
    assert capsys.readouterr().out == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """In a directory with BENCHMARK.json and the benchmark's files alone."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "lutvq_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "lutvq_bench/run.py", "--workload", "mistral7b-chat-c64",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""
    with pytest.raises(json.JSONDecodeError):
        json.loads(p.stdout or "x")
