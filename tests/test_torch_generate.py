"""Parity of the torch port's ``generate()`` with the JAX package's, plus
the port's sampling helpers and its jax-free import.

Both packages get an explicit ``strategy``: their ``auto`` rules differ at
tiny widths (the port's is a fixed batch threshold, the JAX package's a v5e
cost model).
"""

import importlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lutvq.models.llama as jl
import tpu_lutvq_torch.models.llama as tl
from tpu_lutvq_torch.utils.convert import llama_from_numpy

# the packages' ``runtime`` re-export the function ``generate`` over its module
jg = importlib.import_module("tpu_lutvq.runtime.generate")
tg = importlib.import_module("tpu_lutvq_torch.runtime.generate")

torch.set_num_threads(2)

KW = dict(n_layers=1, max_seq=32)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jl.LlamaConfig.tiny(**KW)
    jw = jl.init_llama(jax.random.PRNGKey(7), jcfg)
    tcfg = tl.LlamaConfig.tiny(**KW)
    return jcfg, jw, tcfg, llama_from_numpy(tcfg, jax.tree.map(np.asarray, jw), device="cpu")


def both(tiny, prompt, strategy, **kw):
    jcfg, jw, tcfg, tw = tiny
    jprompt = prompt if isinstance(prompt, list) else jnp.asarray(prompt, jnp.int32)
    tprompt = prompt if isinstance(prompt, list) else torch.tensor(prompt)
    want = jg.generate(jcfg, jw, jprompt, strategy=strategy, interpret=True, **kw)
    got = tg.generate(tcfg, tw, tprompt, strategy=strategy, **kw)
    return got, want


@pytest.mark.parametrize("prompt,strategy", [
    ([[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]], "dequant_mm"),  # equal lengths
    ([[3, 1, 4]], "lut_gemv"),                            # B=1 decode, pair tables
    ([[1, 2, 3], [4, 5], [6, 7, 8, 9, 10, 11]], "dequant_mm"),  # ragged
])
def test_generate_greedy_matches_jax(tiny, prompt, strategy):
    equal = len({len(p) for p in prompt}) == 1
    got, want = both(tiny, prompt if not equal else np.asarray(prompt), strategy,
                     max_new_tokens=5)
    assert got.tokens.dtype == torch.int32
    assert np.array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert np.array_equal(got.lengths.numpy(), np.asarray(want.lengths))


def test_generate_eos_matches_jax(tiny):
    jcfg, jw, tcfg, tw = tiny
    prompt = [[1, 2], [5, 6, 7]]
    first = tg.generate(tcfg, tw, prompt, max_new_tokens=1, strategy="dequant_mm")
    eos = int(first.tokens[0, 2])  # row 0 stops at once; row 1 runs on
    got, want = both(tiny, prompt, "dequant_mm", max_new_tokens=6, eos_id=eos)
    assert np.array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert np.array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert int(got.lengths[0]) == 3


def test_generate_sampling_seeded_and_in_vocab(tiny):
    _, _, tcfg, tw = tiny
    prompt = torch.tensor([[0, 1, 2]])

    def run(seed, **kw):
        return tg.generate(tcfg, tw, prompt, max_new_tokens=6, temperature=1.0,
                           generator=torch.Generator().manual_seed(seed),
                           strategy="lut_gemv", **kw).tokens

    a, b = run(3, top_k=8), run(3, top_k=8)
    assert torch.equal(a, b)
    assert a.shape == (1, 9) and int(a.max()) < tcfg.vocab_size
    assert run(4, top_p=0.9).shape == (1, 9)
    greedy = tg.generate(tcfg, tw, prompt, max_new_tokens=6, strategy="lut_gemv").tokens
    assert torch.equal(run(5, top_k=1), greedy)  # top-1 sampling is greedy


@pytest.mark.parametrize("top_p", [0.3, 0.9])
def test_top_p_filter_matches_jax(top_p):
    logits = np.random.default_rng(0).standard_normal((3, 50)).astype(np.float32) * 2
    logits[1, :4] = 5.0  # ties at the boundary stay in (the JAX rule)
    want = np.asarray(jg._top_p_filter(jnp.asarray(logits), top_p))
    got = tg._top_p_filter(torch.from_numpy(logits), top_p).numpy()
    assert np.array_equal(got, want)


def test_sample_logits_vec_greedy_rows():
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 30)).astype(np.float32))
    temps = torch.tensor([0.0, 1.0, 0.0, 0.7])
    out = tg.sample_logits_vec(logits, torch.Generator().manual_seed(0), temps, top_k=5)
    assert torch.equal(out[[0, 2]], logits.argmax(-1)[[0, 2]].to(torch.int32))
    top5 = torch.topk(logits, 5).indices
    for r in (1, 3):
        assert int(out[r]) in top5[r].tolist()


@pytest.mark.parametrize("n,max_seq", [(1, 2048), (300, 2048), (5000, 4096), (10, 64)])
def test_bucket_window_matches(n, max_seq):
    assert tg.bucket_window(n, max_seq) == jg.bucket_window(n, max_seq)


@pytest.mark.parametrize("lens,max_seq,bucket", [
    ([3], 2048, 8), ([7, 19, 33, 64], 2048, 64), ([9, 2], 2048, 16), ([20, 17], 24, 24),
])
def test_pad_prompts_bucket_layout(lens, max_seq, bucket):
    """The JAX ``generate()``'s ragged layout (``generate.py:288-296``): 0s
    right of each prompt, a power-of-two width of at least 8, cut at max_seq."""
    prompts = [list(range(1, n + 1)) for n in lens]
    toks, got_lens = tg.pad_prompts(prompts, max_seq, "cpu")
    assert toks.dtype == torch.int32 and got_lens.dtype == torch.int32
    assert toks.shape == (len(lens), bucket)
    assert got_lens.tolist() == lens
    for row, n in zip(toks.tolist(), lens):
        assert row == list(range(1, n + 1)) + [0] * (bucket - n)


def test_generate_rejects_overflow_and_stacked(tiny):
    _, _, tcfg, tw = tiny
    with pytest.raises(ValueError, match="max_seq"):
        tg.generate(tcfg, tw, torch.zeros((1, 30), dtype=torch.int32), max_new_tokens=10)
    with pytest.raises(ValueError, match="max_seq"):
        tg.generate(tcfg, tw, torch.zeros((1, 30), dtype=torch.int32), max_new_tokens=10,
                    stacked_kv=True)
    # stacked_kv is ported: the tuple caches' tokens
    assert torch.equal(tg.generate(tcfg, tw, [[1, 2]], max_new_tokens=2, stacked_kv=True).tokens,
                       tg.generate(tcfg, tw, [[1, 2]], max_new_tokens=2).tokens)


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import tpu_lutvq_torch, tpu_lutvq_torch.kernels, tpu_lutvq_torch.models\n"
        "import tpu_lutvq_torch.runtime, tpu_lutvq_torch.utils\n"
        "import tpu_lutvq_torch.kernels.flash_decode, tpu_lutvq_torch.kernels.flash_prefill\n"
        "import tpu_lutvq_torch.models.paged_cache, tpu_lutvq_torch.models.attn_policy\n"
        "import tpu_lutvq_torch.runtime.batching\n"
        "import tpu_lutvq_torch.ann, tpu_lutvq_torch.ann.kmeans, tpu_lutvq_torch.ann.pq\n"
        "import tpu_lutvq_torch.ann.opq, tpu_lutvq_torch.utils.convert\n"
        "assert not any(m == 'tpu_lutvq' or m.startswith('tpu_lutvq.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
