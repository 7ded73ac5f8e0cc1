"""The flash-decode kernel's split (``kernels.flash_decode.plan_decode``)
and its pass 1 / pass 2 / combine arithmetic, checked on the CPU.

``csrc/flash_decode.cu`` cuts the window into chunks that lie inside one
reference block, computes every chunk's scores and max (pass 1), rounds
each chunk's ``bf16(p * vs)`` against the prefix max of its block's maxima
(pass 2), and sums the chunks' partials rescaled to the last one's max in
chunk order (combine).  The plan is pure Python, so its cover of each
sequence's rows is checked here at the shapes the main path gives the
kernel; the three passes are emulated with torch ops and held to the JAX
kernels in interpret mode (as ``tests/test_torch_attention.py`` runs them),
with rows past ``pos`` poisoned, and the ``p_f32`` control must still fail.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lutvq.kernels.flash_decode import flash_decode_attention as j_decode
from tpu_lutvq.kernels.flash_decode import flash_decode_paged as j_paged
from tpu_lutvq_torch.kernels import flash_decode as tfd
from tpu_lutvq_torch.utils.convert import tensor_from_numpy

torch.set_num_threads(2)

H100_SMS = 132
KERNEL_TOL = 1e-5  # test_torch_attention.py's: the plain version against JAX
HEADS = 32  # query heads; kv heads = HEADS // rep
POS_8 = (0, 255, 256, 2047, 1000, 511, 1500, 64)  # chip_smoke.py's ragged B=8


def plan_cases():
    for b, window, block_s, rep in itertools.product((1, 8), (256, 2048), (128, 256, 512),
                                                     (1, 2, 8)):
        if window % block_s == 0:
            yield b, window, block_s, rep


@pytest.mark.parametrize("b,window,block_s,rep", list(plan_cases()))
def test_decode_plan_covers_every_row_once(b, window, block_s, rep):
    hkv = HEADS // rep
    plan = tfd.plan_decode(b, hkv, window, block_s, H100_SMS)
    assert plan.grid == (plan.n_chunks, hkv, b)
    assert plan.chunk * plan.n_chunks == window
    assert block_s % plan.chunk == 0 and plan.chunk <= tfd.KERNEL_MAX_CHUNK
    assert plan.per_block == block_s // plan.chunk
    # the card is filled twice over, or the chunk is as small as the plan goes
    assert b * hkv * plan.n_chunks >= 2 * H100_SMS or plan.chunk == tfd.KERNEL_MIN_CHUNK
    for c in range(plan.n_chunks):  # a chunk lies inside its reference block
        first, last = c * plan.chunk, (c + 1) * plan.chunk - 1
        assert first // block_s == last // block_s == c // plan.per_block
    positions = (window - 1,) if b == 1 else tuple(min(p, window - 1) for p in POS_8)
    for pos in positions + (0, block_s - 1, block_s):
        if pos >= window:
            continue
        rows = [r for c in range(plan.n_chunks) for r in plan.rows(c, pos)]
        assert rows == list(range(pos + 1))
    dh = 128
    assert plan.workspace_floats(b, hkv * rep, dh) == (
        b * hkv * rep * (window + plan.n_chunks * (dh + 3)))


def test_decode_plan_is_a_function_of_shapes():
    """Cached and pure: the same shapes give the same plan object, and a
    window that is not whole blocks is refused."""
    assert tfd.plan_decode(8, 32, 2048, 256, H100_SMS) is tfd.plan_decode(8, 32, 2048, 256,
                                                                           H100_SMS)
    assert tfd.plan_decode(1, 32, 2048, 256, H100_SMS).grid == (16, 32, 1)
    assert tfd.plan_decode(1, 8, 2048, 256, H100_SMS).chunk == 32  # 70B layout, B=1
    assert tfd.plan_decode(2, 2, 48, 48, H100_SMS).chunk == 48  # no divisor in [32, 48)
    with pytest.raises(ValueError, match="whole blocks"):
        tfd.plan_decode(1, 1, 100, 64, H100_SMS)


def bf16(t):
    return t.to(torch.bfloat16).float()


def split_emulation(q, k, v, ks, vs, pos, plan, round_p=True):
    """The kernel's three passes with torch ops over a slab ``(B, H_kv, S,
    Dh)``: chunk scores and maxima, each chunk's p at the prefix max of its
    block's chunk maxima, ``bf16(p * vs)`` (left in f32 with ``round_p=False``,
    the p_f32 control), per-chunk partials, combined over the valid chunks
    rescaled to the last one's max."""
    b, h, dh = q.shape
    hkv = k.shape[1]
    rep, n, c = h // hkv, plan.n_chunks, plan.chunk
    w = n * c
    quantized = k.dtype == torch.int8
    qb = tfd._prep_q(q, dh**-0.5).reshape(b, hkv, rep, dh)
    s = qb @ k[:, :, :w].float().transpose(-1, -2)  # (B, H_kv, rep, W)
    if quantized:
        s = s * ks[:, :, None, :w].float()
    live = torch.arange(w)[None, :] <= pos.long()[:, None]  # (B, W)
    s = torch.where(live[:, None, None, :], s, tfd.NEG_INF).reshape(b, hkv, rep, n, c)
    # pass 2: the prefix max over the chunk maxima of blocks 0..s
    running = torch.cummax(s.amax(-1), dim=-1).values  # (B, H_kv, rep, n)
    ends = (torch.arange(n) // plan.per_block + 1) * plan.per_block - 1
    m = running[..., ends]
    p = torch.exp(s - m[..., None])
    l_part = p.sum(-1)
    if quantized:
        p = p * vs[:, :, :w].float().reshape(b, hkv, 1, n, c)
    if round_p:
        p = bf16(p)
    acc = torch.einsum("bgrnj,bgnjd->bgrnd", p, v[:, :, :w].float().reshape(b, hkv, n, c, dh))
    # combine: the valid chunks, rescaled to the last one's (the largest) max
    n_valid = torch.clamp(pos.long() // c + 1, max=n)
    valid = (torch.arange(n)[None, :] < n_valid[:, None])[:, None, None, :]
    m_last = m.gather(-1, (n_valid - 1)[:, None, None, None].expand(b, hkv, rep, 1))
    wgt = torch.where(valid, torch.exp(m - m_last), 0.0)
    out = (acc * wgt[..., None]).sum(3) / (l_part * wgt).sum(3)[..., None]
    return out.reshape(b, h, dh)


def kv_poisoned(rng, lead, dh, pos, int8):
    """K, V, scales (numpy) with every row past each sequence's pos poisoned."""
    shape = lead + (dh,)
    if int8:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.02, lead).astype(np.float32) for _ in range(2))
        big = np.int8(127)
    else:
        k, v = (rng.standard_normal(shape).astype(jnp.bfloat16) for _ in range(2))
        ks, vs = np.ones(lead, np.float32), np.ones(lead, np.float32)
        big = jnp.bfloat16(300.0)
    past = np.arange(lead[2])[None, None, :, None] > pos[:, None, None, None]
    return [np.where(past, big, a).astype(a.dtype) for a in (k, v)] + [ks, vs]


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("rep,int8", [(1, True), (2, True), (4, False)])
def test_split_emulation_matches_jax_slab(rep, int8):
    """Blocks of 64 rows split in chunks of 32; positions in the first
    chunk, on a chunk edge, inside a later block, at the window's end."""
    rng = np.random.default_rng(10 + rep)
    b, hkv, s_max, dh, block_s = 4, 2, 256, 64, 64
    pos = np.array([3, 31, 100, 255], np.int32)
    kv = kv_poisoned(rng, (b, hkv, s_max), dh, pos, int8)
    q = rng.standard_normal((b, hkv * rep, dh)).astype(np.float32)
    want = np.asarray(j_decode(jnp.asarray(q), *(jnp.asarray(a) for a in kv), jnp.asarray(pos),
                               window=s_max, block_s=block_s, interpret=True))
    tkv = [tensor_from_numpy(a, "cpu") for a in kv]
    tq, tpos = torch.from_numpy(q), torch.from_numpy(pos)
    plan = tfd.plan_decode(b, hkv, s_max, block_s, H100_SMS)
    assert plan.chunk == 32 and plan.per_block == 2
    got = split_emulation(tq, *tkv, tpos, plan)
    assert rel(got, want) <= KERNEL_TOL
    plain = tfd.flash_decode_attention(tq, *tkv, tpos, window=s_max, block_s=block_s)
    assert rel(got, plain) <= KERNEL_TOL
    # the control that leaves p in f32 must still fail the limit
    control = split_emulation(tq, *tkv, tpos, plan, round_p=False)
    assert rel(control, want) > KERNEL_TOL


def test_split_emulation_matches_jax_paged():
    """A shuffled pool of 32-row blocks (a block one chunk), rows past pos
    poisoned; the emulation runs on the sequences' rows in order."""
    rng = np.random.default_rng(20)
    hkv, bs, dh, b, maxb, rep = 2, 32, 64, 3, 4, 2
    pos = np.array([0, 40, 127], np.int32)
    slab = kv_poisoned(rng, (b, hkv, maxb * bs), dh, pos, True)
    tables = rng.permutation(np.arange(1, b * maxb + 1)).reshape(b, maxb).astype(np.int32)
    pool = []
    for a in slab:  # block s of sequence i is pool block tables[i, s]; block 0 junk
        blocks = a.reshape((b, hkv, maxb, bs) + a.shape[3:]).swapaxes(1, 2)
        p = np.ones((b * maxb + 1, hkv, bs) + a.shape[3:], a.dtype)
        p[tables.reshape(-1)] = blocks.reshape((b * maxb, hkv, bs) + a.shape[3:])
        pool.append(p)
    q = rng.standard_normal((b, hkv * rep, dh)).astype(np.float32)
    want = np.asarray(j_paged(jnp.asarray(q), *(jnp.asarray(a) for a in pool),
                              jnp.asarray(tables), jnp.asarray(pos), window=maxb * bs,
                              interpret=True))
    plan = tfd.plan_decode(b, hkv, maxb * bs, bs, H100_SMS)
    got = split_emulation(torch.from_numpy(q), *(torch.from_numpy(a) for a in slab),
                          torch.from_numpy(pos), plan)
    assert rel(got, want) <= KERNEL_TOL
