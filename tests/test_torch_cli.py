"""The port's CLI (``python -m tpu_lutvq_torch.cli``), each command in its
own process: it gives ``generate()``'s tokens, prints the layer report, and
never imports jax."""

import os
import subprocess
import sys

import pytest
import torch

from tpu_lutvq_torch.runtime.checkpoint import load_lutvq
from tpu_lutvq_torch.runtime.generate import generate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# runs the CLI, then says on stderr whether anything imported jax
RUN = ("import runpy, sys\n"
       "sys.argv = ['tpu_lutvq_torch.cli'] + sys.argv[1:]\n"
       "try:\n"
       "    runpy.run_module('tpu_lutvq_torch.cli', run_name='__main__')\n"
       "finally:\n"
       "    print('jax imported:', 'jax' in sys.modules, file=sys.stderr)\n")


def cli(*args, ok=True):
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-c", RUN, *args], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert "jax imported: False" in p.stderr, p.stderr
    assert (p.returncode == 0) == ok, (p.returncode, p.stderr)
    return p


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.lutvq.safetensors")
    out = cli("quantize", "--out", path, "--model", "tiny", "--seed", "3", "--device", "cpu")
    assert out.stdout.strip() == f"wrote {path}"
    return path


@pytest.mark.parametrize("tokens,new", [("1,2,3", 6), ("7", 3)])
def test_quantize_then_generate_gives_generates_tokens(tiny_ckpt, tokens, new):
    out = cli("generate", "--ckpt", tiny_ckpt, "--tokens", tokens, "--max-new-tokens", str(new),
              "--device", "cpu")
    cfg, weights = load_lutvq(tiny_ckpt, device="cpu")
    ids = [int(t) for t in tokens.split(",")]
    want = generate(cfg, weights, torch.tensor([ids], dtype=torch.int32), new,
                    generator=torch.Generator("cpu").manual_seed(0))
    got = [int(t) for t in out.stdout.strip().split(",")]
    assert got == want.tokens[0, len(ids):].tolist()
    assert len(got) == new


@pytest.mark.parametrize("model", ["7b", "tiny"])
def test_report_prints_seven_rows_and_a_total(model):
    lines = cli("report", "--model", model, "--batch", "4").stdout.strip().splitlines()
    assert len(lines) == 8
    assert [ln.split()[0] for ln in lines[:7]] == ["wq", "wk", "wv", "wo", "w_gate", "w_up",
                                                   "w_down"]
    assert lines[7].startswith("TOTAL/layer") and lines[7].endswith(" us")


def test_text_prompts_and_the_stacked_cache_are_refused(tiny_ckpt):
    out = cli("generate", "--ckpt", tiny_ckpt, "--prompt", "hello", "--device", "cpu", ok=False)
    assert "--tokens" in out.stderr and out.returncode == 2
    # --stacked-kv serves now: the tuple caches' tokens
    stacked = cli("generate", "--ckpt", tiny_ckpt, "--tokens", "1", "--stacked-kv", "--device",
                  "cpu", "--max-new-tokens", "4")
    plain = cli("generate", "--ckpt", tiny_ckpt, "--tokens", "1", "--device", "cpu",
                "--max-new-tokens", "4")
    assert stacked.stdout == plain.stdout and len(stacked.stdout.split(",")) == 4
