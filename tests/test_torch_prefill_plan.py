"""The flash-prefill kernel's split (``kernels.flash_prefill.plan_prefill``)
and its cluster arithmetic, checked on the CPU.

``csrc/flash_prefill.cu`` serves each (query tile of 64, head, sequence)
with one thread-block cluster whose blocks (ranks) take consecutive KV
blocks.  Each rank finds its KV blocks' row maxima from the scores it keeps,
reads the lower ranks' maxima, rounds ``bf16(p * vs)`` of KV block s at the
reference's prefix max of the block maxima 0..s, and the ranks' (m, l, acc)
are summed in rank order, rescaled to the last live rank's max.  The plan is
pure Python, so its cover of the KV blocks is checked here at the shapes the
main path gives the kernel; the split is emulated with torch ops and held to
the JAX kernel in interpret mode (as ``tests/test_torch_attention.py`` runs
it), rows past each sequence's last query poisoned, and the ``p_f32``
control must still fail.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lutvq.kernels.flash_prefill import flash_prefill_attention as j_prefill
from tpu_lutvq_torch.kernels import flash_prefill as tfp
from tpu_lutvq_torch.utils.convert import tensor_from_numpy

torch.set_num_threads(2)

H100_SMS = 132
# The split moves no rounding point, only f32 summation order: the
# emulation against the plain version, measured <= 5.0e-8 here.
SPLIT_TOL = 1e-6
# Against the JAX kernel the plain version itself differs in f32 order, and
# at these shapes (up to 80 queries over up to 230 keys) that moves a p
# across a bf16 rounding boundary: measured 1.1e-7 to 8.9e-5 (bf16 KV), past
# test_torch_attention.py's 1e-5 for its smaller shapes.  2e-4 holds that
# and fails the p_f32 control (>= 9.7e-4 here).
JAX_TOL = 2e-4
# chip_smoke.py's SUMMARY_AT row: B=1, 32/32 heads, T=256 at offset 512,
# window bucket_window(768) = 1024, blocks of 256
SUMMARY_AT = (1, 256, 32, 32, 1024, 256)


def plan_cases():
    for b, t, (h, hkv), window, block_s in itertools.product(
            (1, 4, 8), (64, 256), ((32, 32), (64, 8)), (256, 1024, 2048), (64, 128, 256)):
        if window % block_s == 0:
            yield b, t, h, hkv, window, block_s


@pytest.mark.parametrize("b,t,h,hkv,window,block_s", list(plan_cases()))
def test_prefill_plan_covers_every_block_once(b, t, h, hkv, window, block_s):
    """The ranks' chunks (round-robin, one a round) cover the window once,
    none empty, within the cluster and round limits; a chunk is whole 64-row
    sub-tiles of one KV block, and every KV block's chunks fall in one round
    (so its maximum is known at that round's exchange); the grid is ranks ×
    query tiles × heads × sequences; for any tile's last query position the
    live ranks are exactly those with a KV row at or below it."""
    plan = tfp.plan_prefill(b, t, h, hkv, window, block_s, H100_SMS)
    nblk = window // block_s
    assert plan.nblk == nblk and plan.q_tile == tfp.KERNEL_Q_TILE
    assert 1 <= plan.n_split <= tfp.KERNEL_MAX_SPLIT and plan.rounds <= tfp.KERNEL_MAX_ROUNDS
    assert plan.chunk % 64 == 0 and block_s % plan.chunk == 0
    assert plan.grid == (plan.n_split * -(-t // 64), h, b)
    cpb = block_s // plan.chunk
    covered = sorted(c for q in range(plan.n_split) for c in plan.chunks(q))
    assert covered == list(range(nblk * cpb))
    for q in range(plan.n_split):
        chunks = list(plan.chunks(q))
        assert chunks and chunks == [r * plan.n_split + q for r in range(len(chunks))]
    for blk in range(nblk):
        assert len({c // plan.n_split for c in range(blk * cpb, (blk + 1) * cpb)}) == 1
    for last in (0, block_s - 1, block_s, window // 2, window - 1):
        live = plan.live_ranks(last)
        assert live == len({q for q in range(plan.n_split) if q * plan.chunk <= last})


def test_prefill_plan_is_a_function_of_shapes():
    """Cached and pure; the SUMMARY_AT shape fills the card in one wave; a
    window that is not whole blocks, blocks past 256 rows, or more than
    8 × 16 KV blocks are refused; a cluster the card cannot hold is not
    chosen."""
    plan = tfp.plan_prefill(*SUMMARY_AT, H100_SMS)
    assert plan is tfp.plan_prefill(*SUMMARY_AT, H100_SMS)
    # halves of the 4 KV blocks over 2 ranks: 4 rounds
    assert (plan.n_split, plan.chunk, plan.rounds) == (2, 128, 4)
    assert np.prod(plan.grid) >= H100_SMS
    # two blocks an SM hold 132 clusters of 2: the 128 tiles take one wave
    assert plan.grid[0] * plan.grid[1] <= 2 * H100_SMS
    alone = tfp.plan_prefill(*SUMMARY_AT, H100_SMS, lambda n, chunk: 264 if n == 1 else 0)
    assert (alone.n_split, alone.chunk) == (1, 256)
    with pytest.raises(ValueError, match="whole blocks"):
        tfp.plan_prefill(1, 64, 8, 8, 1000, 256, H100_SMS)
    with pytest.raises(ValueError, match="whole blocks"):
        tfp.plan_prefill(1, 64, 8, 8, 1024, 512, H100_SMS)
    with pytest.raises(ValueError, match="KV blocks"):
        tfp.plan_prefill(1, 64, 8, 8, 64 * 129, 64, H100_SMS)


def bf16(t):
    return t.to(torch.bfloat16).float()


def cluster_emulation(q, k, v, ks, vs, t_off, plan, round_p=True):
    """The kernel's arithmetic with torch ops: per (sequence, query tile)
    the live ranks take their chunks round by round; in each round every
    rank's p is rounded as ``bf16(p * vs)`` at its KV block's prefix max,
    the max over the chunks of earlier rounds and this round's chunks of its
    block and the blocks before it (p left in f32 with ``round_p=False``,
    the p_f32 control); the ranks' partials are summed in rank order at the
    largest max."""
    b, t, h, dh = q.shape
    hkv = k.shape[1]
    rep, bs, n, w = h // hkv, plan.chunk, plan.n_split, plan.nblk * plan.block_s
    cpb = plan.block_s // plan.chunk
    quantized = k.dtype == torch.int8
    qb = bf16(q.float()).permute(0, 2, 1, 3)  # (B, H, T, Dh), unscaled
    kf = k[:, :, :w].float().repeat_interleave(rep, dim=1)
    vf = v[:, :, :w].float().repeat_interleave(rep, dim=1)
    s = (qb @ kf.transpose(-1, -2)) * dh**-0.5  # (B, H, T, W)
    if quantized:
        s = s * ks[:, :, None, :w].float().repeat_interleave(rep, dim=1)
    vsc = vs[:, :, :w].float().repeat_interleave(rep, dim=1) if quantized else None
    out = torch.empty((b, h, t, dh))
    for bi, t0 in itertools.product(range(b), range(0, t, plan.q_tile)):
        rows = slice(t0, min(t0 + plan.q_tile, t))
        qpos = int(t_off[bi]) + torch.arange(rows.start, rows.stop)
        sc = torch.where(torch.arange(w)[None, None, :] <= qpos[None, :, None], s[bi, :, rows],
                         tfp.NEG_INF)  # (H, tq, W)
        cmax = sc.reshape(h, -1, plan.n_chunks, bs).amax(-1, keepdim=True)  # (H, tq, chunks, 1)
        last = min(plan.n_chunks - 1, int(qpos[-1]) // bs)
        live = plan.live_ranks(int(qpos[-1]))
        shape = (h, sc.shape[1], 1)
        state = [(torch.full(shape, tfp.NEG_INF), torch.zeros(shape),
                  torch.zeros((h, sc.shape[1], dh))) for _ in range(live)]
        seen = torch.full(shape, tfp.NEG_INF)
        for r in range(last // n + 1):
            chunks = range(r * n, min(r * n + n, last + 1))
            for q, c in enumerate(chunks):
                m, l, acc = state[q]
                upto = min(chunks.stop, (c // cpb + 1) * cpb)  # the chunks of its block and before
                pm = torch.maximum(seen, cmax[:, :, r * n : upto, 0].amax(-1, keepdim=True))
                cols = slice(c * bs, (c + 1) * bs)
                alpha = torch.exp(m - pm)
                p = torch.exp(sc[..., cols] - pm)
                l = l * alpha + p.sum(-1, keepdim=True)
                if quantized:
                    p = p * vsc[bi, :, None, cols]
                acc = acc * alpha + (bf16(p) if round_p else p) @ vf[bi, :, cols]
                state[q] = (pm, l, acc)
            seen = torch.maximum(seen, cmax[:, :, chunks.start : chunks.stop, 0].amax(-1,
                                                                                 keepdim=True))
        top = torch.stack([m for m, _, _ in state]).amax(0)
        num = sum(acc * torch.exp(m - top) for m, _, acc in state)
        den = sum(l * torch.exp(m - top) for m, l, _ in state)
        out[bi, :, rows] = num / den
    return out.permute(0, 2, 1, 3)


def kv_poisoned(rng, lead, dh, last, int8):
    """K, V, scales (numpy) with every row past each sequence's last query
    position poisoned."""
    shape = lead + (dh,)
    if int8:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.02, lead).astype(np.float32) for _ in range(2))
        big = np.int8(127)
    else:
        k, v = (rng.standard_normal(shape).astype(jnp.bfloat16) for _ in range(2))
        ks, vs = np.ones(lead, np.float32), np.ones(lead, np.float32)
        big = jnp.bfloat16(300.0)
    past = np.arange(lead[2])[None, None, :, None] > last[:, None, None, None]
    return [np.where(past, big, a).astype(a.dtype) for a in (k, v)] + [ks, vs]


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# (rep, int8, B, kv heads, T, offsets, cache rows, block_s): blocks of 64
# rows so that small shapes split; ragged offsets (a query tile whose last
# rows reach only some ranks, one that ends inside a block); a window of 40
# blocks takes 5 rounds; blocks of 256 split in chunks of 64, 4 a block
EMULATION_CASES = (
    (1, True, 3, 2, 80, (0, 37, 130), 256, 64),
    (4, True, 2, 2, 40, (5, 200), 256, 64),
    (1, False, 2, 2, 40, (0, 190), 256, 64),
    (4, False, 2, 1, 80, (100, 17), 256, 64),
    (2, True, 2, 1, 16, (2300, 5), 2560, 64),
    (2, True, 2, 2, 64, (300, 700), 1024, 256),
)


@pytest.mark.parametrize("rep,int8,b,hkv,t,offsets,s_max,block_s", EMULATION_CASES)
def test_cluster_emulation_matches_jax(rep, int8, b, hkv, t, offsets, s_max, block_s):
    rng = np.random.default_rng(sum(offsets) + rep)
    dh = 64
    off = np.array(offsets, np.int32)
    kv = kv_poisoned(rng, (b, hkv, s_max), dh, off + t - 1, int8)
    q = rng.standard_normal((b, t, hkv * rep, dh)).astype(np.float32)
    want = np.asarray(j_prefill(jnp.asarray(q), *(jnp.asarray(a) for a in kv), jnp.asarray(off),
                                window=s_max, block_s=block_s, interpret=True))
    tkv = [tensor_from_numpy(a, "cpu") for a in kv]
    tq, toff = torch.from_numpy(q), torch.from_numpy(off)
    plan = tfp.plan_prefill(b, t, hkv * rep, hkv, s_max, block_s, H100_SMS)
    assert plan.n_split > 1 and (plan.rounds > 1) == (s_max > 256)
    assert (plan.chunk < block_s) == (block_s > 64)
    got = cluster_emulation(tq, *tkv, toff, plan)
    plain = tfp.flash_prefill_attention(tq, *tkv, toff, window=s_max, block_s=block_s)
    assert rel(got, plain) <= SPLIT_TOL
    assert rel(got, want) <= JAX_TOL
    # the control that leaves p in f32 must still fail both limits
    control = cluster_emulation(tq, *tkv, toff, plan, round_p=False)
    assert rel(control, want) > JAX_TOL and rel(control, plain) > JAX_TOL
