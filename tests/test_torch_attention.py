"""Parity of the torch port's flash attention (decode, paged decode,
prefill) with the JAX package's Pallas kernels.

Inputs are made with numpy from a seed and go through the JAX kernels in
interpret mode (as ``tests/test_flash.py`` and ``tests/test_paged.py`` run
them) and through the port's plain versions (CPU tensors never reach a
CUDA kernel; ``chip_smoke.py`` holds the kernels against the plain
versions on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lutvq_torch.models.llama as tl
from tpu_lutvq.kernels.flash_decode import flash_decode_attention as j_decode
from tpu_lutvq.kernels.flash_decode import flash_decode_paged as j_paged
from tpu_lutvq.kernels.flash_prefill import flash_prefill_attention as j_prefill
from tpu_lutvq_torch.kernels.flash_decode import flash_decode_attention as t_decode
from tpu_lutvq_torch.kernels.flash_decode import flash_decode_paged as t_paged
from tpu_lutvq_torch.kernels.flash_prefill import flash_prefill_attention as t_prefill
from tpu_lutvq_torch.models.kv_cache import KVCache as TKVCache
from tpu_lutvq_torch.models.paged_cache import PagedKVCache
from tpu_lutvq_torch.utils.convert import tensor_from_numpy

torch.set_num_threads(2)

# Plain version vs the JAX kernel: the same function with the same rounding
# points; only the f32 summation order differs, which at most moves a p
# across a bf16 rounding boundary.  Measured ≤ 2.1e-7 of max|out| here;
# 1e-5 leaves room and still fails a wrong rounding point (≥ 1e-3).
KERNEL_TOL = 1e-5
# Against the einsum path (``_attention_window``): other rounding points
# (one softmax over the whole window, p rounded after normalisation), so
# the JAX tests' own tolerance, 2e-2.
EINSUM_TOL = 2e-2


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def kv_arrays(rng, lead, dh, int8=True):
    """Numpy K, V, k_scale, v_scale of shape lead + (Dh,) / lead: random
    int8 values with per-row scales, or bf16 values with unit scales."""
    shape = lead + (dh,)
    if int8:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.02, lead).astype(np.float32) for _ in range(2))
    else:
        k, v = (rng.standard_normal(shape).astype(jnp.bfloat16) for _ in range(2))
        ks, vs = np.ones(lead, np.float32), np.ones(lead, np.float32)
    return k, v, ks, vs


def both(arrays):
    return [jnp.asarray(a) for a in arrays], [tensor_from_numpy(a, "cpu") for a in arrays]


def einsum_ref(q_np, kv, pos_np, window):
    """The port's einsum attention (``_attention_window``) over a slab."""
    q = torch.from_numpy(q_np if q_np.ndim == 4 else q_np[:, None])
    b, t, h, dh = q.shape
    hkv = kv[0].shape[1]
    cfg = tl.LlamaConfig.tiny(n_heads=h, n_kv_heads=hkv, hidden=h * dh, max_seq=kv[0].shape[2])
    cache = TKVCache(*(tensor_from_numpy(a, "cpu") for a in kv))
    out = tl._attention_window(cfg, q, cache, torch.from_numpy(pos_np), window)
    return out.reshape(b, t, h, dh).numpy()


@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("int8", [True, False])
def test_decode_matches_jax_kernel(rep, int8):
    rng = np.random.default_rng(0)
    b, hkv, s_max, dh = 2, 2, 512, 64
    kv = kv_arrays(rng, (b, hkv, s_max), dh, int8)
    q = rng.standard_normal((b, hkv * rep, dh)).astype(np.float32)
    pos = np.array([8, 200], np.int32)
    (jkv, tkv), (jq, tq) = both(kv), both([q, pos])
    want = j_decode(jq[0], *jkv, jq[1], window=256, interpret=True)
    got = t_decode(tq[0], *tkv, tq[1], window=256)
    assert got.dtype == torch.float32 and got.shape == (b, hkv * rep, dh)
    assert rel(got, want) <= KERNEL_TOL
    assert rel(got, einsum_ref(q, kv, pos, s_max)[:, 0]) <= EINSUM_TOL


def test_decode_per_sequence_positions_poisoned_rows():
    """Rows past each sequence's own pos hold 127s: they must not count."""
    rng = np.random.default_rng(1)
    b, hkv, s_max, dh = 3, 2, 256, 64
    k, v, ks, vs = kv_arrays(rng, (b, hkv, s_max), dh)
    pos = np.array([3, 17, 39], np.int32)
    past = np.arange(s_max)[None, None, :, None] > pos[:, None, None, None]
    k, v = np.where(past, np.int8(127), k), np.where(past, np.int8(127), v)
    q = rng.standard_normal((b, hkv, dh)).astype(np.float32)
    (jkv, tkv), (jq, tq) = both([k, v, ks, vs]), both([q, pos])
    want = j_decode(jq[0], *jkv, jq[1], window=s_max, interpret=True)
    got = t_decode(tq[0], *tkv, tq[1], window=s_max)
    assert rel(got, want) <= KERNEL_TOL
    assert rel(got, einsum_ref(q, (k, v, ks, vs), pos, s_max)[:, 0]) <= EINSUM_TOL


def test_decode_window_invariance():
    """Any window covering pos+1 gives the same answer: blocks past pos
    change nothing, so the plain version is bit-identical across windows."""
    rng = np.random.default_rng(2)
    b, hkv, s_max, dh = 1, 2, 1024, 128
    kv = kv_arrays(rng, (b, hkv, s_max), dh)
    q = rng.standard_normal((b, hkv, dh)).astype(np.float32)
    pos = np.array([11], np.int32)
    (jkv, tkv), (jq, tq) = both(kv), both([q, pos])
    outs = [t_decode(tq[0], *tkv, tq[1], window=w) for w in (256, 512, 1024)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    want = j_decode(jq[0], *jkv, jq[1], window=1024, interpret=True)
    assert rel(outs[0], want) <= KERNEL_TOL


def test_decode_window_truncation_raises():
    rng = np.random.default_rng(3)
    _, tkv = both(kv_arrays(rng, (1, 1, 512), 64))
    q = torch.zeros((1, 1, 64))
    with pytest.raises(ValueError, match="truncates attention"):
        t_decode(q, *tkv, torch.tensor([300], dtype=torch.int32), window=256)
    with pytest.raises(NotImplementedError, match="stacked"):
        t_decode(q, *tkv, torch.tensor([3], dtype=torch.int32), window=256, layer=0)


@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("int8", [True, False])
def test_prefill_matches_jax_kernel(rep, int8):
    """block_q=8 makes 3 query blocks of t=24 and block_s=64 four KV
    blocks with causal skips; offsets [0, 7] as chunked admission has."""
    rng = np.random.default_rng(4)
    b, hkv, s_max, dh, t = 2, 2, 256, 64, 24
    kv = kv_arrays(rng, (b, hkv, s_max), dh, int8)
    q = rng.standard_normal((b, t, hkv * rep, dh)).astype(np.float32)
    off = np.array([0, 7], np.int32)
    (jkv, tkv), (jq, tq) = both(kv), both([q, off])
    kw = dict(window=s_max, block_q=8, block_s=64)
    want = j_prefill(jq[0], *jkv, jq[1], interpret=True, **kw)
    got = t_prefill(tq[0], *tkv, tq[1], **kw)
    assert got.dtype == torch.float32 and got.shape == (b, t, hkv * rep, dh)
    assert rel(got, want) <= KERNEL_TOL
    assert rel(got, einsum_ref(q, kv, off, s_max)) <= EINSUM_TOL


def test_prefill_window_and_block_invariance():
    """Any (window, block) covering offset+T gives the same answer; block_s
    moves the softmax's rounding points, so within the JAX test's 1e-5."""
    rng = np.random.default_rng(5)
    b, hkv, s_max, dh, t = 1, 2, 512, 128, 17
    kv = kv_arrays(rng, (b, hkv, s_max), dh)
    q = rng.standard_normal((b, t, hkv, dh)).astype(np.float32)
    off = np.array([9], np.int32)
    (jkv, tkv), (jq, tq) = both(kv), both([q, off])
    outs = [
        t_prefill(tq[0], *tkv, tq[1], window=w, block_q=bq, block_s=bs)
        for (w, bq, bs) in [(64, 32, 32), (128, 8, 64), (512, 256, 256)]
    ]
    for o in outs[1:]:
        assert rel(o, outs[0]) <= 1e-5
    want = j_prefill(jq[0], *jkv, jq[1], window=128, block_q=8, block_s=64, interpret=True)
    assert rel(outs[1], want) <= KERNEL_TOL


def test_prefill_window_truncation_raises():
    rng = np.random.default_rng(6)
    _, tkv = both(kv_arrays(rng, (1, 1, 256), 64))
    q = torch.zeros((1, 16, 1, 64))
    with pytest.raises(ValueError, match="truncates attention"):
        t_prefill(q, *tkv, torch.tensor([20], dtype=torch.int32), window=32, block_s=32)


@pytest.mark.parametrize("rep", [1, 2])
def test_paged_decode_matches_jax_kernel(rep):
    """A shuffled block table: sequence blocks live anywhere in the pool."""
    rng = np.random.default_rng(7)
    n, hkv, bs, dh, b, maxb = 9, 2, 16, 64, 2, 4
    pool = kv_arrays(rng, (n, hkv, bs), dh)
    tables = rng.permutation(np.arange(1, n)).reshape(b, maxb).astype(np.int32)
    q = rng.standard_normal((b, hkv * rep, dh)).astype(np.float32)
    pos = np.array([12, 50], np.int32)
    (jpool, tpool), (jx, tx) = both(pool), both([q, tables, pos])
    want = j_paged(jx[0], *jpool, jx[1], jx[2], window=64, interpret=True)
    got = t_paged(tx[0], *tpool, tx[1], tx[2], window=64)
    assert rel(got, want) <= KERNEL_TOL
    # the same rows as a slab, through the slab kernel with block_s = BS
    cache = PagedKVCache(*tpool, tx[1])
    view = cache.window_view(64)
    slab = t_decode(tx[0], *view, tx[2], window=64, block_s=bs)
    assert torch.equal(got, slab)
    einsum = einsum_ref(q, [a.numpy() for a in view], pos, 64)
    assert rel(got, einsum[:, 0]) <= EINSUM_TOL


def test_kernel_launchers_reject_cpu_tensors():
    """The launchers validate before any pointer crosses into C: a CPU
    tensor never reaches the CUDA kernel, and there is no fallback."""
    from tpu_lutvq_torch.kernels import flash_decode, flash_prefill

    rng = np.random.default_rng(8)
    _, tkv = both(kv_arrays(rng, (1, 2, 256), 128))
    pos = torch.tensor([5], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode._launch(torch.zeros((1, 2, 128)), *tkv, pos, None, 1, 256)
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill._launch(torch.zeros((1, 4, 2, 128)), *tkv, pos, 1, 256)
    with pytest.raises(ValueError, match="head_dim"):
        flash_decode._launch(torch.zeros((1, 2, 96)), *tkv, pos, None, 1, 256)


@pytest.mark.parametrize("case", [
    dict(attn="flash", batch=1, window=256),
    dict(attn="xla", batch=16, window=8192),
    dict(attn="auto", batch=1, window=8192),
    dict(attn="auto", batch=2, window=256),
    dict(attn="auto", batch=2, window=512),
    dict(attn="auto", batch=8, window=256),
    dict(attn="auto", batch=1, window=256, paged=True),
    dict(attn="auto", batch=1, window=512, paged=True),
    dict(attn="auto", batch=2, window=128, paged=True),
    dict(attn="auto", batch=16, window=8192, t=512),
    dict(attn="auto", batch=2, window=8192, t=8192),
    dict(attn="auto", batch=1, window=2048, t=256),
])
def test_resolve_attn_matches_reference(case):
    """``attn="auto"`` picks the reference's path at every shape, on both
    sides of each threshold (the port keeps the reference's constants)."""
    from tpu_lutvq.models.attn_policy import resolve_attn as j_resolve
    from tpu_lutvq_torch.models.attn_policy import resolve_attn as t_resolve

    attn, kw = case["attn"], {k: v for k, v in case.items() if k != "attn"}
    assert t_resolve(attn, heads=32, **kw) == j_resolve(attn, heads=32, **kw)
