"""The port's analytical layer report and trace (``tpu_lutvq_torch.utils.
profiling``) against the JAX package's ``tpu_lutvq.utils.profiling``."""

import json
import os

import pytest
import torch

from tpu_lutvq.models import LlamaConfig as JLlamaConfig
from tpu_lutvq.utils import profiling as jprof
from tpu_lutvq_torch.dataflow.traffic import pick_strategy
from tpu_lutvq_torch.models.llama import LlamaConfig
from tpu_lutvq_torch.utils import profiling

RENAMED = {"vpu_gops": "lookups_g", "mxu_gflop": "tensor_gop"}
FUNCTION_BYTES = ("codeword", "codebook", "inp", "psum")


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("model", ["tiny", "llama2_7b", "llama2_13b", "llama2_70b"])
def test_layer_report_has_the_reference_rows(model, batch):
    """The same projections, shapes, keys (the op columns renamed) and
    function bytes as JAX's report; the strategy is the port's
    ``pick_strategy`` and the lut bytes are the port's kernels'."""
    want = jprof.layer_report(getattr(JLlamaConfig, model)(), batch=batch)
    cfg = getattr(LlamaConfig, model)()
    got = profiling.layer_report(cfg, batch=batch)
    assert [r["proj"] for r in got] == [r["proj"] for r in want]
    for g, w in zip(got[:-1], want[:-1]):
        assert set(g) == {RENAMED.get(k, k) for k in w}
        assert (g["d_in"], g["d_out"]) == (w["d_in"], w["d_out"])
        for k in FUNCTION_BYTES:
            assert g[k] == w[k], (g["proj"], k)
        assert g["strategy"] == pick_strategy(cfg.vq_cfg(g["d_in"]), g["d_out"], batch)
        assert g["pred_us"] > 0 and g["bound"] in ("hbm", "lookup", "tensor")
    assert set(got[-1]) == set(want[-1]) == {"proj", "pred_us"}
    assert got[-1]["pred_us"] == pytest.approx(sum(r["pred_us"] for r in got[:-1]), abs=0.011)


def test_print_layer_report(capsys):
    profiling.print_layer_report(LlamaConfig.tiny(), batch=2)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 8 and lines[-1].startswith("TOTAL/layer")


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir) as d:
        assert d == logdir
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
