"""Parity of the port's stacked and hybrid cache container with the JAX
package's: the stacked cache functions, the scan and hybrid modes of
``llama_forward``, ``generate(stacked_kv=True)``, the batcher's
``stacked_kv`` route, the fused chunked prefill, flash decode's ``layer=``
mode, and stacked weights carried across (``llama_from_numpy``) or read
from a stacked native file (``load_lutvq``).

Inputs are made with numpy from a seed; the JAX side runs its Pallas
kernels in interpret mode, the port its kernels' plain versions (CPU
tensors).  Where the port's stacked modes read the same bytes through the
same functions as its tuple caches, they are held to them bit for bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lutvq.models.kv_cache as jkv
import tpu_lutvq.models.llama as jl
import tpu_lutvq_torch.models.kv_cache as tkv
import tpu_lutvq_torch.models.llama as tl
from tpu_lutvq.kernels.flash_decode import flash_decode_attention as j_decode
from tpu_lutvq.runtime.checkpoint import save_lutvq as j_save
from tpu_lutvq_torch.kernels.flash_decode import flash_decode_attention as t_decode
from tpu_lutvq_torch.runtime import ContinuousBatcher, Request
from tpu_lutvq_torch.runtime.checkpoint import load_lutvq, save_lutvq
from tpu_lutvq_torch.utils.convert import llama_from_numpy, tensor_from_numpy

jg = importlib.import_module("tpu_lutvq.runtime.generate")
tg = importlib.import_module("tpu_lutvq_torch.runtime.generate")

torch.set_num_threads(2)

GOLDEN_KW = dict(n_layers=2, hidden=128, ffn=256, n_heads=4, n_kv_heads=2,
                 vocab_size=64, max_seq=16)
TOKENS = [[1, 7, 3, 11, 5]]
F32_TOL = 1e-4  # f32 tables, the golden fixture's tolerance (test_torch_model.py)
STRATEGY = "dequant_mm"


def carried(kw, seed):
    jcfg = jl.LlamaConfig.tiny(**kw)
    jw = jl.init_llama(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(**kw)
    return jcfg, jw, tcfg, llama_from_numpy(tcfg, jax.tree.map(np.asarray, jw), device="cpu")


@pytest.fixture(scope="module")
def golden_model():
    return carried(GOLDEN_KW, 42)


@pytest.fixture(scope="module")
def tiny():
    return carried(dict(n_layers=1, max_seq=32), 7)


def np_stacked(rng, lead, dh):
    """Numpy int8 planes and f32 scales of a stacked cache, leaves lead + (Dh,)."""
    k, v = (rng.integers(-127, 128, lead + (dh,)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.02, lead).astype(np.float32) for _ in range(2))
    return k, v, ks, vs


def both_caches(arrays):
    return (jkv.KVCache(*(jnp.asarray(a) for a in arrays)),
            tkv.KVCache(*(tensor_from_numpy(a, "cpu") for a in arrays)))


def assert_same(jcache, tcache):
    for j, t in zip(jcache, tcache):
        assert np.array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("pos", [6, [2, 6]], ids=["scalar", "per-sequence"])
def test_update_cache_stacked_drops_rows_past_the_cache(pos):
    """Three rows into layer 1 of an (L=2, B=2, H=2, S=8) cache: at 6 the
    third row (8) lies past the cache and is dropped, not clamped onto row
    7; every plane bit for bit the reference's, layer 0 untouched."""
    rng = np.random.default_rng(1)
    jc, tc = both_caches(np_stacked(rng, (2, 2, 2, 8), 16))
    k, v = (rng.standard_normal((2, 3, 2, 16)).astype(np.float32) for _ in range(2))
    layer0 = [t[0].clone() for t in tc]
    want = jkv.update_cache_stacked(jc, jnp.int32(1), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(pos, jnp.int32))
    got = tkv.update_cache_stacked(tc, 1, torch.from_numpy(k), torch.from_numpy(v),
                                   torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list)
                                   else pos)
    assert got is tc
    assert_same(want, got)
    assert all(torch.equal(a, t[0]) for a, t in zip(layer0, tc))
    # the row the last token of sequence 1 would clamp onto holds its own token
    assert not np.array_equal(np.asarray(want.k_q[1, 1, :, 7]), np.asarray(want.k_q[1, 1, :, 6]))


def test_slice_layer_window_is_a_view_of_the_reference_window():
    rng = np.random.default_rng(2)
    jc, tc = both_caches(np_stacked(rng, (3, 2, 2, 8), 16))
    for li, w in ((0, 4), (2, 8), (1, 20)):
        got = tkv.slice_layer_window(tc, li, w)
        assert_same(jkv.slice_layer_window(jc, jnp.int32(li), w), got)
        assert got.k_q.data_ptr() == tc.k_q[li].data_ptr()  # no copy


def test_write_cache_slots_stacked_overwrites_each_slot_whole():
    """A wave (k=2, S'=5) into slots (2, 0) of an (L=2, B=3, S=8) container,
    and one request into slot 1: rows past S' zeroed, scales included, bit
    for bit the reference's one scatter."""
    rng = np.random.default_rng(3)
    jbig, tbig = both_caches(np_stacked(rng, (2, 3, 2, 8), 16))
    jsmall, tsmall = both_caches(np_stacked(rng, (2, 2, 2, 5), 16))
    want = jkv.write_cache_slots_stacked(jbig, jsmall, jnp.asarray([2, 0]))
    assert_same(want, tkv.write_cache_slots_stacked(tbig, tsmall, [2, 0]))
    jone, tone = both_caches(np_stacked(rng, (2, 1, 2, 6), 16))
    want = jkv.write_cache_slot_stacked(want, jone, 1)
    assert_same(want, tkv.write_cache_slot_stacked(tbig, tone, 1))


def test_decode_layer_mode_matches_jax():
    """D's ``layer=`` plain version against JAX's ``layer=`` kernel in
    interpret mode at head_dim 128 (the reference's stacked mode needs ≥
    128), ragged positions, GQA 2; and equal to the layer's own slab."""
    rng = np.random.default_rng(4)
    kv = np_stacked(rng, (3, 2, 2, 512), 128)
    q = rng.standard_normal((2, 4, 128)).astype(np.float32)
    pos = np.array([100, 450], np.int32)
    want = j_decode(jnp.asarray(q), *(jnp.asarray(a) for a in kv), jnp.asarray(pos),
                    window=512, layer=jnp.int32(2), interpret=True)
    tkv_ = [tensor_from_numpy(a, "cpu") for a in kv]
    got = t_decode(torch.from_numpy(q), *tkv_, torch.from_numpy(pos), window=512, layer=2)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= 1e-5
    assert torch.equal(got, t_decode(torch.from_numpy(q), *(t[2] for t in tkv_),
                                     torch.from_numpy(pos), window=512))


def forward(cfg, weights, caches, **kw):
    return tl.llama_forward(cfg, weights, torch.tensor(TOKENS), caches, 0, strategy="lut_gemv",
                            variant="f32", **kw)


def test_scan_and_hybrid_forward_match_jax_and_the_tuple_loop(golden_model):
    """Hybrid (stacked cache, per-layer weights) and scan (stacked cache and
    weights) against JAX's same modes at the f32 tables' 1e-4, against the
    golden fixture, and bit for bit against the port's tuple loop, caches
    included; prefill then a decode step at flash attention."""
    import os

    jcfg, jw, tcfg, tw = golden_model
    fixture = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                   "golden_logits.npz"))["logits"]
    jsw = jl.stack_llama_weights(jw)
    tsw = tl.stack_llama_weights(tw)
    for jweights, tweights in ((jw, tw), (jsw, tsw)):  # hybrid, scan
        tup, tup_c = forward(tcfg, tw, tl.init_caches(tcfg, 1, device="cpu"))
        np.testing.assert_allclose(tup.numpy(), fixture, rtol=F32_TOL, atol=F32_TOL)
        want, _ = jl.llama_forward(jcfg, jweights, jnp.asarray(TOKENS),
                                   jl.init_stacked_caches(jcfg, 1), jnp.int32(0),
                                   strategy="lut_gemv", variant="f32", interpret=True)
        got, got_c = forward(tcfg, tweights, tl.init_stacked_caches(tcfg, 1, device="cpu"))
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= F32_TOL
        np.testing.assert_allclose(got.numpy(), fixture, rtol=F32_TOL, atol=F32_TOL)
        assert torch.equal(got, tup)
        for li, c in enumerate(tup_c):
            assert all(torch.equal(a, b[li]) for a, b in zip(c, got_c))
        step = dict(strategy="lut_gemv", variant="f32", attn="flash")
        want_d, _ = tl.llama_decode_step(tcfg, tw, torch.tensor([9]), tup_c, 5, **step)
        got_d, _ = tl.llama_decode_step(tcfg, tweights, torch.tensor([9]), got_c, 5, **step)
        assert torch.equal(got_d, want_d)
    # scan mode runs one set of per-layer views, made once
    assert tl.layer_weights(tsw.layers[0]) is tl.layer_weights(tsw.layers[0])
    assert tl.weights_stacked(tsw) and not tl.weights_stacked(tw)


def test_generate_stacked_ragged_matches_jax(tiny):
    """``generate(stacked_kv=True)`` on a ragged batch gives JAX's stacked
    tokens, and the port's tuple caches' (``tests/test_runtime.py:324,343``)."""
    jcfg, jw, tcfg, tw = tiny
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9], [7, 8]]
    want = jg.generate(jcfg, jw, prompts, max_new_tokens=4, strategy=STRATEGY, interpret=True,
                       stacked_kv=True)
    got = tg.generate(tcfg, tw, prompts, 4, strategy=STRATEGY, stacked_kv=True)
    assert got.tokens.tolist() == np.asarray(want.tokens).tolist()
    assert got.lengths.tolist() == np.asarray(want.lengths).tolist()
    assert torch.equal(got.tokens, tg.generate(tcfg, tw, prompts, 4, strategy=STRATEGY).tokens)


@pytest.mark.parametrize("waves", [False, True])
def test_batcher_stacked_kv_matches_greedy(tiny, waves):
    """The batcher's ``stacked_kv`` route reproduces each request's B=1
    greedy generation (``tests/test_runtime.py:211``): one-request
    admission with a chunked long prompt, or wave admission of equal
    prompts."""
    _, _, tcfg, tw = tiny
    if waves:
        prompts, max_new, kw = [[i + 1, i + 2, i + 3] for i in range(4)], [4, 3, 5, 2], {}
    else:
        prompts, max_new, kw = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [6, 7]], [4, 3, 3], \
            dict(prefill_chunk=4)
    singles = [tg.generate(tcfg, tw, [p], mn, strategy=STRATEGY).tokens[0, len(p):].tolist()
               for p, mn in zip(prompts, max_new)]
    batcher = ContinuousBatcher(tcfg, tw, n_slots=len(prompts) if waves else 2,
                                strategy=STRATEGY, stacked_kv=True, **kw)
    assert batcher.caches.k_q.shape == (1, batcher.n_slots, tcfg.n_kv_heads, tcfg.max_seq,
                                        tcfg.head_dim)
    for i, (p, mn) in enumerate(zip(prompts, max_new)):
        batcher.submit(Request(i, p, mn))
    done = {r.req_id: r.output for r in batcher.run()}
    assert [done[i] for i in range(len(prompts))] == singles
    assert batcher.wave_admits == (len(prompts) if waves else 0)


def test_batcher_stacked_kv_refuses_paged_and_injected(tiny):
    """The reference's two refusals (``tests/test_runtime.py:236``)."""
    _, _, tcfg, tw = tiny
    with pytest.raises(ValueError, match="slab"):
        ContinuousBatcher(tcfg, tw, n_slots=2, stacked_kv=True, paged_blocks=8)
    with pytest.raises(ValueError, match="injected"):
        ContinuousBatcher(tcfg, tw, n_slots=2, stacked_kv=True, step_fn=lambda *a, **k: None)


@pytest.mark.parametrize("t", [12, 13], ids=["full-chunks", "tail"])
def test_fused_chunked_prefill_matches_oneshot(tiny, t):
    """``make_fused_chunked_prefill`` (chunks of 4 at ``bucket_window(T)``,
    then the tail) against a one-shot prefill into a stacked cache
    (``tests/test_runtime.py:247``), and bit for bit against the same chunks
    through tuple caches.  The plain versions' f32 matmuls sum a 4-row and
    a 12-row call in other orders on the CPU (≤ 1.2e-5 apart here), and
    lm_head rounds logits to bf16, so the one-shot comparison takes the
    bf16 logits' 2e-2 of max|logits| (test_torch_model.py) and the int8
    planes one quantization step."""
    _, _, tcfg, tw = tiny
    tokens = torch.from_numpy(np.random.default_rng(t).integers(0, tcfg.vocab_size, (2, t)))
    win = tg.bucket_window(t, tcfg.max_seq)
    want, want_c = tl.llama_forward(tcfg, tw, tokens, tl.init_stacked_caches(tcfg, 2, device="cpu"),
                                    0, strategy=STRATEGY, window=win, attn="auto",
                                    logits_mode="last")
    got, got_c = tg.make_fused_chunked_prefill(tcfg, chunk=4, strategy=STRATEGY)(tw, tokens)
    assert got.shape == (2, tcfg.vocab_size) and got_c.k_q.shape[:2] == (tcfg.n_layers, 2)
    assert float((got - want[:, -1]).abs().max() / want.abs().max()) <= 2e-2
    for a, b in ((got_c.k_q, want_c.k_q), (got_c.v_q, want_c.v_q)):
        assert int((a.int() - b.int()).abs().max()) <= 1
    caches = tl.init_caches(tcfg, 2, device="cpu")
    for c0 in range(0, t, 4):
        chunked, caches = tl.llama_forward(tcfg, tw, tokens[:, c0 : c0 + 4], caches, c0,
                                           strategy=STRATEGY, window=win, attn="auto",
                                           logits_mode="last")
    assert torch.equal(got, chunked[:, -1])
    for li, c in enumerate(caches):
        assert all(torch.equal(a, b[li]) for a, b in zip(c, got_c))


def test_stacked_weights_cross_from_jax_tree_and_file(golden_model, tmp_path):
    """JAX's ``stack_llama_weights`` output carried by ``llama_from_numpy``,
    and a stacked native file written by JAX's ``save_lutvq`` read by
    ``load_lutvq``: both stay stacked and run the scan mode to the per-layer
    weights' logits bit for bit; the port writes the same file back."""
    jcfg, jw, tcfg, tw = golden_model
    jsw = jl.stack_llama_weights(jw)
    want, _ = forward(tcfg, tw, tl.init_caches(tcfg, 1, device="cpu"))
    from_tree = llama_from_numpy(tcfg, jax.tree.map(np.asarray, jsw), device="cpu")
    path = str(tmp_path / "stacked.lutvq.safetensors")
    j_save(path, jcfg, jsw)
    cfg2, from_file = load_lutvq(path, device="cpu")
    assert cfg2 == tcfg
    again = str(tmp_path / "again.lutvq.safetensors")
    save_lutvq(again, cfg2, from_file)
    _, from_port_file = load_lutvq(again, device="cpu")
    for weights in (from_tree, from_file, from_port_file):
        assert tl.weights_stacked(weights)
        assert weights.layers[0].wq.packed.codes_t.shape[0] == tcfg.n_layers
        got, _ = forward(tcfg, weights, tl.init_stacked_caches(tcfg, 1, device="cpu"))
        assert torch.equal(got, want)
