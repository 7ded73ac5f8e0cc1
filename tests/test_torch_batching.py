"""Parity of the torch port's ``ContinuousBatcher`` and chunked prefill with
the JAX package's, on the tiny model.

Both batchers get the same weights (the JAX package's ``init_llama``,
carried across), the same requests and ``strategy="dequant_mm"``, as
``tests/test_runtime.py`` runs the JAX one; greedy outputs must be equal
request by request.  The JAX batcher runs its Pallas kernels in interpret
mode, the port its kernels' plain versions.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lutvq.models.llama as jl
import tpu_lutvq_torch.models.llama as tl
from tpu_lutvq.runtime import ContinuousBatcher as JBatcher
from tpu_lutvq.runtime import Request as JRequest
from tpu_lutvq_torch.runtime import ContinuousBatcher, Request, make_chunked_prefill
from tpu_lutvq_torch.utils.convert import llama_from_numpy

# the packages' ``runtime`` re-export the function ``generate`` over its module
jg = importlib.import_module("tpu_lutvq.runtime.generate")
tg = importlib.import_module("tpu_lutvq_torch.runtime.generate")

torch.set_num_threads(2)

STRATEGY = "dequant_mm"
STAGGERED = ([[1, 2, 3], [4, 5], [6, 7, 8, 9], [3, 1]], [6, 3, 5, 4])
RAGGED = ([[1, 2, 3], [4, 5, 6, 7, 8], [7, 8], [9, 10, 11, 12]], [3, 4, 3, 4])


def carried(max_seq):
    kw = dict(n_layers=1, max_seq=max_seq)
    jcfg, tcfg = jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)
    jw = jl.init_llama(jax.random.PRNGKey(7), jcfg, dtype=jnp.float32)
    return jcfg, jw, tcfg, llama_from_numpy(tcfg, jax.tree.map(np.asarray, jw), device="cpu")


@pytest.fixture(scope="module")
def tiny32():
    return carried(32)


@pytest.fixture(scope="module")
def tiny64():
    return carried(64)


def serve(model, requests, *, horizon=1, pipeline=False, **kw):
    """Run the same requests through both batchers: ({id: output} JAX,
    {id: output} port, JAX batcher, port batcher)."""
    jcfg, jw, tcfg, tw = model
    jb = JBatcher(jcfg, jw, strategy=STRATEGY, interpret=True, **kw)
    tb = ContinuousBatcher(tcfg, tw, strategy=STRATEGY, **kw)
    outs = []
    for b, req in ((jb, JRequest), (tb, Request)):
        for i, (prompt, max_new, eos) in enumerate(requests):
            b.submit(req(req_id=i, prompt=prompt, max_new_tokens=max_new, eos_id=eos))
        done = b.run(max_steps=200, horizon=horizon, pipeline=pipeline)
        assert len(done) == len(requests)
        outs.append({r.req_id: r.output for r in done})
    return outs[0], outs[1], jb, tb


def reqs(prompts, max_new, eos=None):
    return [(p, n, eos) for p, n in zip(prompts, max_new)]


@pytest.mark.parametrize("mode,horizon,pipeline", [
    ("slab", 1, False),
    ("slab", 4, True),
    ("paged", 1, False),
    ("paged", 4, True),
])
def test_batcher_matches_jax(tiny64, mode, horizon, pipeline):
    """Staggered lengths over 2 slots: slots free and refill; the paged
    pool (7 usable blocks of 16) is smaller than 2 slots × 64 rows."""
    kw = dict(paged_blocks=8, paged_block_size=16) if mode == "paged" else {}
    want, got, _, _ = serve(tiny64, reqs(*STAGGERED), horizon=horizon, pipeline=pipeline,
                            n_slots=2, **kw)
    assert got == want
    assert [len(got[i]) for i in range(4)] == STAGGERED[1]


@pytest.mark.parametrize("mode", ["slab", "paged"])
def test_batcher_attn_flash_matches_jax(tiny64, mode):
    """The tiny sizes keep ``attn="auto"`` on the einsum path (B·window <
    1024), so the flash decode kernels' plain versions run under "flash"."""
    kw = dict(paged_blocks=8, paged_block_size=16) if mode == "paged" else {}
    want, got, _, _ = serve(tiny64, reqs(*STAGGERED), n_slots=2, attn="flash", **kw)
    assert got == want


@pytest.mark.parametrize("mode", ["slab", "paged"])
def test_batcher_ragged_wave_matches_jax(tiny32, tiny64, mode):
    """Four lengths ride one padded B=4 wave; paged pads go to block 0."""
    kw = dict(paged_blocks=24, paged_block_size=8) if mode == "paged" else {}
    model = tiny64 if mode == "paged" else tiny32
    want, got, jb, tb = serve(model, reqs(*RAGGED), n_slots=4, **kw)
    assert got == want
    assert tb.wave_admits == jb.wave_admits == 4


def test_batcher_chunked_fifo_not_overtaken_matches_jax(tiny32):
    """A chunked-length prompt at the head of the queue stops the wave:
    later short requests never pass it (``test_runtime.py:417-441``)."""
    prompts, max_new = [[1, 2, 3, 4, 5, 6], [4, 5], [7, 8]], [3, 3, 3]
    want, got, jb, tb = serve(tiny32, reqs(prompts, max_new), n_slots=3, prefill_chunk=4)
    assert got == want
    assert tb.wave_admits == jb.wave_admits == 0


def test_batcher_chunked_paged_matches_jax(tiny64):
    prompts, max_new = [[1, 2, 3, 4, 5], [6, 7], [8, 9, 10, 11, 12, 13, 14]], [4, 3, 4]
    want, got, _, _ = serve(tiny64, reqs(prompts, max_new), n_slots=2, prefill_chunk=3,
                            paged_blocks=16, paged_block_size=8)
    assert got == want


def test_batcher_eos_frees_slot_matches_jax(tiny32):
    _, _, tcfg, tw = tiny32
    first = tg.generate(tcfg, tw, [[1, 2]], max_new_tokens=1, strategy=STRATEGY)
    eos = int(first.tokens[0, -1])  # request 0 stops at its first token
    requests = [([1, 2], 10, eos), ([3], 2, None)]
    want, got, _, tb = serve(tiny32, requests, n_slots=1)
    assert got == want
    assert got[0] == [eos] and len(got[1]) == 2
    assert not tb.has_work


def test_paged_backpressure_matches_jax(tiny64):
    """Pool exhaustion defers admission; a request that could never fit is
    rejected at submit (``test_paged.py:182-203``)."""
    jcfg, jw, tcfg, tw = tiny64
    kw = dict(n_slots=2, paged_blocks=4, paged_block_size=16)
    for b, req in ((JBatcher(jcfg, jw, interpret=True, strategy=STRATEGY, **kw), JRequest),
                   (ContinuousBatcher(tcfg, tw, strategy=STRATEGY, **kw), Request)):
        with pytest.raises(ValueError, match="never run"):
            b.submit(req(req_id=9, prompt=[1] * 40, max_new_tokens=20))
    # each request needs 2 of the 3 usable blocks: the second waits
    want, got, _, _ = serve(tiny64, reqs([[1, 2, 3]] * 3, [4] * 3), **kw)
    assert got == want
    assert all(len(o) == 4 for o in got.values())


@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_chunked_prefill_matches_oneshot_and_jax(tiny32, attn):
    """T=13 in chunks of 4 (a tail of 1): the same last logits and caches
    as one-shot prefill, and as the JAX package's chunked prefill."""
    jcfg, jw, tcfg, tw = tiny32
    b, t = 2, 13
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(3), (b, t), 0, jcfg.vocab_size),
                      np.int32)
    logits_1, caches_1 = tl.llama_forward(tcfg, tw, torch.from_numpy(tokens),
                                          tl.init_caches(tcfg, b, device="cpu"), 0, logits_mode="last",
                                          strategy=STRATEGY, attn=attn)
    chunked = make_chunked_prefill(tcfg, chunk=4, strategy=STRATEGY, attn=attn)
    logits_c, caches_c = chunked(tw, torch.from_numpy(tokens), tl.init_caches(tcfg, b, device="cpu"))
    assert logits_c.shape == (b, tcfg.vocab_size)
    # the chunks' projections see 4 rows instead of 13: f32 sums in another
    # order, so the JAX test's 1e-5 for the logits; the int8 KV rows are
    # exact and the scales within 1 ulp of f32
    np.testing.assert_allclose(logits_c.numpy(), logits_1[:, -1].numpy(), rtol=1e-5, atol=1e-5)
    for got_c, want_c in zip(caches_c, caches_1):
        for got, want in zip(got_c, want_c):
            if got.dtype == torch.int8:
                assert torch.equal(got, want)
            else:
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
    jchunked = jg.make_chunked_prefill(jcfg, chunk=4, strategy=STRATEGY, interpret=True,
                                       attn=attn)
    want, _ = jchunked(jw, jnp.asarray(tokens), jl.init_caches(jcfg, b))
    # bf16-table projections across frameworks: test_torch_model's 2e-2
    np.testing.assert_allclose(logits_c.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


def test_unported_options_raise(tiny32):
    _, _, tcfg, tw = tiny32
    for kw in (dict(prefill_fn=lambda *a: None), dict(step_fn=lambda *a: None),
               dict(cache_factory=tl.init_caches), dict(paged_cache_factory=lambda *a: None)):
        with pytest.raises(NotImplementedError, match="dist/"):
            ContinuousBatcher(tcfg, tw, n_slots=2, **kw)
    with pytest.raises(NotImplementedError, match="stacked"):
        ContinuousBatcher(tcfg, tw, n_slots=2, stacked_kv=True)
    with pytest.raises(NotImplementedError, match="stacked_kv"):
        tg.generate(tcfg, tw, [[1, 2]], 2, stacked_kv=True)
    with pytest.raises(NotImplementedError, match="stacked"):
        tl.llama_forward(tcfg, tw, torch.tensor([[1, 2]]), tl.init_caches(tcfg, 1, device="cpu")[0], 0)
    with pytest.raises(ValueError, match="chunk"):
        make_chunked_prefill(tcfg, chunk=0)
    with pytest.raises(ValueError, match="max_seq"):
        ContinuousBatcher(tcfg, tw, n_slots=2).submit(Request(0, [1] * 30, 10))
