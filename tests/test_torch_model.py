"""Parity of the torch port's Llama model (KV cache, attention, forward)
with the JAX package, on the tiny config.

Weights come from the JAX package's ``init_llama`` and are carried across
with ``llama_from_numpy``; the JAX side runs its Pallas kernels in
interpret mode, the port its kernels' plain versions (CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lutvq.models.kv_cache as jkv
import tpu_lutvq.models.llama as jl
import tpu_lutvq_torch.models.kv_cache as tkv
import tpu_lutvq_torch.models.llama as tl
from tpu_lutvq_torch.utils.convert import llama_from_numpy

torch.set_num_threads(2)

GOLDEN_KW = dict(n_layers=2, hidden=128, ffn=256, n_heads=4, n_kv_heads=2,
                 vocab_size=64, max_seq=16)
TOKENS = [[1, 7, 3, 11, 5]]


def carried(kw, seed, dtype):
    jcfg = jl.LlamaConfig.tiny(**kw)
    jw = jl.init_llama(jax.random.PRNGKey(seed), jcfg, dtype=dtype)
    tcfg = tl.LlamaConfig.tiny(**kw)
    return jcfg, jw, tcfg, llama_from_numpy(tcfg, jax.tree.map(np.asarray, jw), device="cpu")


@pytest.fixture(scope="module")
def golden_model():
    return carried(GOLDEN_KW, 42, jnp.float32)


def test_port_reproduces_golden_logits_fixture(golden_model):
    """The port's f32-table path reproduces ``golden_logits.npz``, built as
    ``tests/test_runtime.py::test_golden_logits_fixture`` builds it."""
    import os

    path = os.path.join(os.path.dirname(__file__), "fixtures", "golden_logits.npz")
    want = np.load(path)["logits"]
    _, _, tcfg, tw = golden_model
    logits, _ = tl.llama_forward(
        tcfg, tw, torch.tensor(TOKENS), tl.init_caches(tcfg, 1, device="cpu"), 0,
        strategy="lut_gemv", variant="f32",
    )
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4, atol=1e-4)


# bf16-table strategies: LUT entries from differently ordered f32 sums can
# round to neighbouring bf16 values and lm_head rounds logits to bf16, so a
# logit may move by a few bf16 ulps: 2e-2 of max|logits|.
@pytest.mark.parametrize("strategy,variant,tol", [
    ("lut_gemv", "f32", 1e-4),
    ("lut_gemv", "auto", 2e-2),
    ("dequant_mm", "auto", 2e-2),
])
def test_forward_logits_match_jax_per_strategy(strategy, variant, tol):
    kw = dict(GOLDEN_KW, n_layers=1)
    jcfg, jw, tcfg, tw = carried(kw, 3, jnp.float16)
    want, _ = jl.llama_forward(
        jcfg, jw, jnp.asarray(TOKENS), jl.init_caches(jcfg, 1), jnp.int32(0),
        strategy=strategy, interpret=True, variant=variant,
    )
    got, _ = tl.llama_forward(
        tcfg, tw, torch.tensor(TOKENS), tl.init_caches(tcfg, 1, device="cpu"), 0,
        strategy=strategy, variant=variant,
    )
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("mode", ["last", "index"])
def test_logits_modes_pick_rows_of_all(golden_model, mode):
    _, _, tcfg, tw = golden_model
    toks = torch.tensor([[1, 7, 3, 11, 5], [2, 4, 6, 8, 10]])
    full, _ = tl.llama_forward(tcfg, tw, toks, tl.init_caches(tcfg, 2, device="cpu"), 0,
                               strategy="dequant_mm")
    idx = torch.tensor([4, 2])
    got, _ = tl.llama_forward(tcfg, tw, toks, tl.init_caches(tcfg, 2, device="cpu"), 0,
                              strategy="dequant_mm", logits_mode=mode, logits_idx=idx)
    rows = idx if mode == "index" else torch.tensor([4, 4])
    torch.testing.assert_close(got[:, 0], full[torch.arange(2), rows])


@pytest.mark.parametrize("kv_dtype", ["int8", "bf16"])
@pytest.mark.parametrize("per_sequence", [False, True])
def test_update_cache_matches(kv_dtype, per_sequence):
    rng = np.random.default_rng(5)
    k = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)  # (B, T, H, Dh)
    v = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    pos = np.array([1, 4], np.int32) if per_sequence else np.int32(2)
    jdt, tdt = (jnp.int8, torch.int8) if kv_dtype == "int8" else (jnp.bfloat16, torch.bfloat16)
    jc = jkv.update_cache(jkv.KVCache.init(2, 8, 2, 16, jdt), jnp.asarray(k),
                          jnp.asarray(v), jnp.asarray(pos))
    tc = tkv.update_cache(tkv.KVCache.init(2, 8, 2, 16, tdt, device="cpu"), torch.from_numpy(k),
                          torch.from_numpy(v), torch.from_numpy(np.asarray(pos)))
    for name in ("k_q", "v_q", "k_scale", "v_scale"):
        got = getattr(tc, name).float().numpy()
        want = np.asarray(getattr(jc, name).astype(jnp.float32))
        assert np.array_equal(got, want), name


def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = np.array([[0, 1, 2], [5, 6, 7]], np.int32)
    np.testing.assert_allclose(
        tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tl.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)), rtol=1e-5, atol=1e-5)


def test_attention_window_matches():
    """Einsum attention over a filled int8 cache with GQA, causal mask at
    per-sequence offsets."""
    rng = np.random.default_rng(7)
    b, t, h, hkv, dh, s = 2, 3, 4, 2, 16, 16
    kv = rng.standard_normal((2, b, s, hkv, dh)).astype(np.float32)
    q = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    off = np.array([2, 9], np.int32)
    jcfg = jl.LlamaConfig.tiny(hidden=h * dh, n_heads=h, n_kv_heads=hkv, max_seq=s)
    tcfg = tl.LlamaConfig.tiny(hidden=h * dh, n_heads=h, n_kv_heads=hkv, max_seq=s)
    jc = jkv.update_cache(jkv.KVCache.init(b, s, hkv, dh), jnp.asarray(kv[0]),
                          jnp.asarray(kv[1]), jnp.int32(0))
    tc = tkv.update_cache(tkv.KVCache.init(b, s, hkv, dh, device="cpu"), torch.from_numpy(kv[0]),
                          torch.from_numpy(kv[1]), 0)
    want = jl._attention_window(jcfg, jnp.asarray(q), jc, jnp.asarray(off), 8)
    got = tl._attention_window(tcfg, torch.from_numpy(q), tc, torch.from_numpy(off), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_init_llama_on_generator_device():
    cfg = tl.LlamaConfig.tiny(n_layers=1, vocab_size=32)
    a = tl.init_llama(cfg, torch.Generator().manual_seed(0))
    b = tl.init_llama(cfg, torch.Generator().manual_seed(0))
    assert a.embed.shape == (32, 128) and a.embed.dtype == torch.bfloat16
    assert a.layers[0].w_down.packed.codes_t.shape == (64, 128)
    assert torch.equal(a.layers[0].wq.packed.codes_t, b.layers[0].wq.packed.codes_t)
    logits, _ = tl.llama_forward(cfg, a, torch.tensor([[1, 2, 3]]),
                                 tl.init_caches(cfg, 1, device="cpu"), 0)
    assert logits.shape == (1, 3, 32) and torch.isfinite(logits).all()


def test_stacked_caches_and_flash_attention_not_ported(golden_model):
    _, _, tcfg, tw = golden_model
    """Stacked caches are ported: one stacked cache (hybrid mode) gives the
    tuple caches' logits and rows bit for bit, and one layer's 4-d cache is
    refused as a container.  ``attn="flash"``: its prefill logits agree
    with the einsum path's within test_flash.py's 2e-2 (other rounding
    points: per-block softmax, p rounded before scaling)."""
    caches = tl.init_caches(tcfg, 1, device="cpu")
    with pytest.raises(ValueError, match="stacked cache has leaves"):
        tl.llama_forward(tcfg, tw, torch.tensor(TOKENS), caches[0], 0)
    kw = dict(strategy="lut_gemv", variant="f32")
    tup, tup_c = tl.llama_forward(tcfg, tw, torch.tensor(TOKENS), tl.init_caches(tcfg, 1, device="cpu"), 0,
                                  **kw)
    hyb, hyb_c = tl.llama_forward(tcfg, tw, torch.tensor(TOKENS),
                                  tl.init_stacked_caches(tcfg, 1, device="cpu"), 0, **kw)
    assert torch.equal(tup, hyb)
    assert all(torch.equal(a, b[i]) for i, c in enumerate(tup_c) for a, b in zip(c, hyb_c))
    flash, _ = tl.llama_forward(tcfg, tw, torch.tensor(TOKENS), caches, 0, attn="flash", **kw)
    xla, _ = tl.llama_forward(tcfg, tw, torch.tensor(TOKENS), tl.init_caches(tcfg, 1, device="cpu"), 0,
                              attn="xla", **kw)
    np.testing.assert_allclose(flash.numpy(), xla.numpy(), rtol=2e-2, atol=2e-2)
