"""Parity of the torch port's paged KV cache, slot writes and block
allocator with the JAX package's, and of paged decode with slab decode.

Cache writes are held to the JAX package bit for bit: both quantize the
same f32 rows the same way and scatter them to the same places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lutvq.models.kv_cache as jkv
import tpu_lutvq.models.llama as jl
import tpu_lutvq.models.paged_cache as jpc
import tpu_lutvq_torch.models.kv_cache as tkv
import tpu_lutvq_torch.models.llama as tl
import tpu_lutvq_torch.models.paged_cache as tpc
from tpu_lutvq_torch.utils.convert import (
    kv_caches_from_numpy,
    llama_from_numpy,
    paged_caches_from_numpy,
)

torch.set_num_threads(2)

BS = 16  # small blocks for CPU tests


def assert_same(tcache, jcache):
    for name, t, j in zip(tcache._fields, tcache, jcache):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


def tables_for(n_slots, max_blocks, n_blocks, seed):
    """Every slot's blocks, from the allocators of both packages after the
    same shuffle of allocations and releases."""
    ja, ta = jpc.BlockAllocator(n_blocks), tpc.BlockAllocator(n_blocks)
    rng = np.random.default_rng(seed)
    for a in (ja, ta):
        held = [a.alloc(2) for _ in range(3)]
        a.release(held[1])
        a.release(held[0])
    assert ja.free == ta.free
    order = rng.permutation(n_slots)
    rows = {}
    for s in order:
        rows[s] = ja.alloc(max_blocks)
        assert ta.alloc(max_blocks) == rows[s]
    return [rows[s] for s in range(n_slots)]


@pytest.fixture
def pools():
    """A JAX and a port pool with the same shuffled block tables."""
    n_slots, max_blocks, h, dh = 3, 4, 2, 32
    n_blocks = 1 + n_slots * max_blocks + 6
    jp = jpc.PagedKVCache.init(n_blocks, n_slots, max_blocks, h, dh, BS)
    tp = tpc.PagedKVCache.init(n_blocks, n_slots, max_blocks, h, dh, BS, device="cpu")
    for slot, blocks in enumerate(tables_for(n_slots, max_blocks, n_blocks, seed=0)):
        jp = jp.set_table(slot, blocks)
        assert tp.set_table(slot, blocks) is tp
    assert_same(tp, jp)
    return jp, tp


def slab_prefill(rng, b, t, h, dh, s_max):
    """A JAX slab cache filled with t rows per sequence, and the port's copy."""
    k = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    j = jkv.update_cache(jkv.KVCache.init(b, s_max, h, dh), jnp.asarray(k), jnp.asarray(v),
                         jnp.int32(0))
    t_ = tkv.update_cache(tkv.KVCache.init(b, s_max, h, dh, device="cpu"), torch.from_numpy(k),
                          torch.from_numpy(v), 0)
    assert_same(t_, j)
    return j, t_


def test_append_matches_jax(pools):
    jp, tp = pools
    rng = np.random.default_rng(1)
    pos0 = np.array([0, 5, 17], np.int32)
    for step in range(20):  # crosses block boundaries at 16 and 32
        k = rng.standard_normal((3, 1, 2, 32)).astype(np.float32)
        v = rng.standard_normal((3, 1, 2, 32)).astype(np.float32)
        p = pos0 + step
        jp = jp.append(jnp.asarray(k), jnp.asarray(v), jnp.asarray(p))
        assert tp.append(torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(p)) is tp
    assert_same(tp, jp)
    for w in (16, 33, 64):
        assert_same(tp.window_view(w), jp.window_view(w))


def test_write_slot_matches_jax(pools):
    jp, tp = pools
    j_small, t_small = slab_prefill(np.random.default_rng(2), 1, 21, 2, 32, 64)
    jp = jp.write_slot(j_small, 1, 21)
    tp.write_slot(t_small, 1, 21)
    assert_same(tp, jp)


def test_write_slots_ragged_pads_go_to_junk_block(pools):
    """A wave padded to t=24: request 1 is 5 rows short; its pad rows must
    land in block 0 and nowhere in its own or a neighbour's blocks."""
    jp, tp = pools
    j_small, t_small = slab_prefill(np.random.default_rng(3), 2, 24, 2, 32, 64)
    slots, t0s = np.array([2, 0], np.int32), np.array([24, 19], np.int32)
    before = tp.k_pool[0].clone()
    jp = jp.write_slots(j_small, jnp.asarray(slots), 24, t0s=jnp.asarray(t0s))
    tp.write_slots(t_small, torch.from_numpy(slots), 24, t0s=torch.from_numpy(t0s))
    assert_same(tp, jp)
    assert not torch.equal(tp.k_pool[0], before)  # the pads went to block 0
    view = tp.window_view(64)
    assert torch.equal(view.k_q[0, :, 19:24], torch.zeros_like(view.k_q[0, :, 19:24]))


@pytest.mark.parametrize("t", [64, 24])
def test_write_cache_slots_match_jax(t):
    """Slab admission writes; t < max_seq zeroes the rest of each slot,
    scales included (the JAX package pads with zeros)."""
    rng = np.random.default_rng(4)
    j_big, t_big = slab_prefill(rng, 3, 5, 2, 32, 64)
    j_small, t_small = slab_prefill(rng, 2, 9, 2, 32, t)
    j_one, t_one = slab_prefill(rng, 1, 7, 2, 32, t)
    j_big = jkv.write_cache_slots(j_big, j_small, jnp.asarray([2, 0], jnp.int32))
    tkv.write_cache_slots(t_big, t_small, torch.tensor([2, 0]))
    assert_same(t_big, j_big)
    j_big = jkv.write_cache_slot(j_big, j_one, 1)
    assert tkv.write_cache_slot(t_big, t_one, 1) is t_big
    assert_same(t_big, j_big)
    if t < 64:
        assert float(t_big.k_scale[1, :, t:].abs().max()) == 0.0


def test_allocator_matches_jax():
    ja, ta = jpc.BlockAllocator(8), tpc.BlockAllocator(8)
    for a in (ja, ta):
        got = a.alloc(7)
        assert 0 not in got and len(set(got)) == 7
        with pytest.raises(RuntimeError, match="exhausted"):
            a.alloc(1)
        a.release(got[2:5] + [0])  # block 0 never returns to the free list
    assert ta.free == ja.free
    assert ta.alloc(3) == ja.alloc(3)


@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_llama_decode_paged_matches_slab(attn):
    """Tiny model (``test_paged.py:89-131``): decode steps over paged
    caches give the slab caches' logits, in the port and against JAX; both
    write paths start from the same JAX slab prefill, carried across."""
    kw = dict(n_layers=1, max_seq=64)
    jcfg, tcfg = jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)
    jw = jl.init_llama(jax.random.PRNGKey(7), jcfg, dtype=jnp.float32)
    tw = llama_from_numpy(tcfg, jax.tree.map(np.asarray, jw), device="cpu")
    b, t0 = 2, 5
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (b, t0 + 3), 0,
                                           jcfg.vocab_size), np.int32)
    run = dict(strategy="lut_gemv", variant="f32")
    _, jcaches = jl.llama_forward(jcfg, jw, jnp.asarray(tokens[:, :t0]),
                                  jl.init_caches(jcfg, b), jnp.int32(0), interpret=True, **run)
    jpaged = []
    for li in range(jcfg.n_layers):
        n_blocks = 1 + b * 4 + 2  # tables_for keeps 2 blocks held
        p = jpc.PagedKVCache.init(n_blocks, b, 4, jcfg.n_kv_heads, jcfg.head_dim, BS)
        for slot, blocks in enumerate(tables_for(b, 4, n_blocks, seed=li)):
            p = p.set_table(slot, blocks)
        for slot in range(b):
            p = p.write_slot(jkv.KVCache(*[x[slot : slot + 1] for x in jcaches[li]]), slot, t0)
        jpaged.append(p)
    np_tree = lambda c: jax.tree.map(np.asarray, c)  # noqa: E731
    tcaches = kv_caches_from_numpy(np_tree(jcaches), device="cpu")
    tpaged = paged_caches_from_numpy(np_tree(tuple(jpaged)), device="cpu")
    jpaged = tuple(jpaged)
    pos = np.full((b,), t0, np.int32)
    for step in range(2):
        tok = tokens[:, t0 + step : t0 + step + 1]
        p = pos + step
        l_slab, tcaches = tl.llama_forward(tcfg, tw, torch.from_numpy(tok), tcaches,
                                           torch.from_numpy(p), window=32, attn=attn, **run)
        l_paged, tpaged = tl.llama_forward(tcfg, tw, torch.from_numpy(tok), tpaged,
                                           torch.from_numpy(p), window=32, attn=attn, **run)
        j_paged, jpaged = jl.llama_forward(jcfg, jw, jnp.asarray(tok), jpaged, jnp.asarray(p),
                                           window=32, attn=attn, interpret=True, **run)
        # paged and slab read the same rows: the JAX test's 2e-4
        np.testing.assert_allclose(l_paged.numpy(), l_slab.numpy(), rtol=2e-4, atol=2e-4)
        # f32-table projections across frameworks: test_torch_model's 1e-4
        np.testing.assert_allclose(l_paged.numpy(), np.asarray(j_paged), rtol=1e-4, atol=1e-4)
    # the appended rows come from each framework's own f32 projections, so
    # a scale may differ in its last bit and an int8 value by one step
    for t, j in zip(tpaged, jpaged):
        for name, a, b_ in zip(t._fields, t, j):
            a, b_ = a.numpy(), np.asarray(b_)
            if name in ("k_scale", "v_scale"):
                np.testing.assert_allclose(a, b_, rtol=1e-6, err_msg=name)
            else:
                assert np.abs(a.astype(np.int32) - b_.astype(np.int32)).max() <= 1, name
