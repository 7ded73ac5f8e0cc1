"""On the card: each cell's control fails its limit and the program passes it.

    python -m pytest lutvq_bench/tests -m cuda   (from the checkout's root, on the card)

The control is the program's own lower-precision path (``quality="fast"``,
W8A8) over the served prompts and tokens, judged by the comparison that
decides ``correct`` in a run (``control.py``, ``harness.check``), at the
cell's own size and window, on three seeds."""

import time

import pytest

from lutvq_bench import control
from lutvq_bench.core import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
SEEDS = (101, 2**31 + 3, 77)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_and_the_program_passes(card, workload):
    cell = spec.Cell.load(workload)
    for seed in SEEDS:
        r = control.reading(cell, seed, BENCH["run_seconds"], card, time.perf_counter(),
                            lambda m: None)
        assert r["served_correct"] and not r["control_correct"], r
