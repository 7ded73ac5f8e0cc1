"""BENCHMARK.json against the contract's shapes, and every file it names found."""

import json
import re

import pytest

from lutvq_bench.core import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load_json(spec.ROOT / "BENCHMARK.json")


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["lutvq_bench"]
    assert bench["command"][1].startswith("lutvq_bench/")
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        names.append(w["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES
    for m in bench["end_to_end"] + bench["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]])
def test_each_cell_finds_its_files_by_name(bench, workload):
    cell = spec.Cell.load(workload)
    assert cell.check["max_gap"] > 0 and cell.check["requests"] >= 2
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))
    for m in cell.per_layer:
        assert m["moves"] in e2e  # the metric it moves is reported in the same cell
    models = cell.model_module()
    arch = models.arch(cell.config)
    assert arch["max_seq"] >= cell.mix["prompt"]["max"] + cell.mix["output"]["max"]
    assert cell.mix["batcher"]["n_slots"] == cell.mix["clients"]
    assert callable(cell.reference_module().forward) and callable(cell.loop_module().drive)


WIDTHS = ("hidden_size", "intermediate_size", "num_attention_heads", "num_key_value_heads",
          "head_dim", "vocab_size")


def test_configurations_keep_their_published_widths(bench):
    """Each configuration against its source's published keys, kept beside
    it as ``<file>.published.json``: every key equal but those ``reduced``
    names, and no width among those."""
    for c in bench["configs"]:
        path = spec.ROOT / c["file"]
        cfg = spec.load_json(path)
        published = spec.load_json(path.with_suffix(".published.json"))
        assert published["hidden_size"] and published["num_hidden_layers"]
        for key, value in published.items():
            if key not in c["reduced"]:
                assert cfg.get(key) == value, (c["name"], key)
        assert not set(c["reduced"]) & set(WIDTHS)
        assert not [k for k in c["reduced"] if k.endswith(("_dim", "_rank", "_size"))]
