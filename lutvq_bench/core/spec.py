"""Everything a cell is, found by name: ``BENCHMARK.json`` at the checkout's
root, the configuration's file, ``traffic/<mix>.json``, ``cells/<cell>.json``
(the correctness limit), ``metrics/<metric>.py`` (one reader a metric),
``models/<architecture>.py`` and ``reference/<architecture>.py``.  Adding a
configuration, mix, cell or metric adds files and entries; nothing here
changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]  # lutvq_bench/
ROOT = BENCH.parent  # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file of the benchmark, imported by path (a metric's
    or architecture's name need not be an identifier)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with everything it names."""

    def __init__(self, name: str, chips: int, config: dict, mix: dict, check: dict,
                 end_to_end: list, per_layer: list):
        self.name, self.chips = name, chips
        self.config, self.mix, self.check = config, mix, check
        self.end_to_end, self.per_layer = end_to_end, per_layer
        self.architecture = config["serving"]["architecture"]

    @classmethod
    def load(cls, workload: str, bench_file: Path = ROOT / "BENCHMARK.json") -> "Cell":
        bench = load_json(bench_file)
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in {bench_file.name}")
        entry = cells[workload]
        conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
        return cls(workload, entry["chips"], load_json(ROOT / conf["file"]),
                   load_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
                   load_json(BENCH / "cells" / f"{workload}.json"),
                   _metrics(bench["end_to_end"], workload), _metrics(bench["per_layer"], workload))

    def model_module(self):
        return load_module(BENCH / "models" / f"{self.architecture}.py",
                           f"lutvq_bench.models.{self.architecture}")

    def reference_module(self):
        return load_module(BENCH / "reference" / f"{self.architecture}.py",
                           f"lutvq_bench.reference.{self.architecture}")

    def loop_module(self):
        return load_module(BENCH / "loops" / f"{self.mix['loop']}.py",
                           f"lutvq_bench.loops.{self.mix['loop']}")


def _metrics(section: list, workload: str) -> list:
    return [m for m in section if workload in m.get("workloads", [workload])]


def reader_module(metric: str):
    """``metrics/<metric>.py``, or for a name ``<reader>.<tag>`` without a
    file of its own, ``metrics/<reader>.py``: one quantity reported under
    a name a cell of its own (``output_tok_s.yi34b``), where that cell
    needs a bound or an end-to-end metric of its own."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{metric.split('.')[0]}.py"
    return load_module(path, f"lutvq_bench.metrics.{path.stem}")


def reader(metric: str):
    """The metric's reader: ``read(record) -> float | None``."""
    return reader_module(metric).read
