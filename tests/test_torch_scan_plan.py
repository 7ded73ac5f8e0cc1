"""Kernels K, H and I (the f32, int8 and int16 table lookups): their split
(``kernels.lut_gemv.plan_scan``), K's rank-order f32 sum and H's packed
16-bit integer sums, checked on the CPU.

``csrc/lut_scan.cu`` (kinds 1-3) reads the (B, G, Kp) tables as they are,
stages them as (group, k, token) rows of 4-byte words, and covers the
columns in one launch: with one split a block walks column tiles with a
grid stride, keeping its tables staged; where G must split (the
projections) a tile's splits form a thread-block cluster summed in rank
order.  H stages its int8 entries biased by +128 and sums four tokens'
bytes in two registers of two 16-bit lanes, widened into int32 every 256
groups.  The plan is pure Python, so its cover is checked here at the
shapes the main paths give K, H and I; the sums are emulated with torch and
numpy ops in the kernel's order and held to JAX's ``f32`` kernel in
interpret mode and to the port's plain versions.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lutvq.core as jcore

import tpu_lutvq_torch.core as tcore

from test_torch_pair_plan import check_cover, cluster_sum, rel_err, split_plans

jlut = importlib.import_module("tpu_lutvq.kernels.lut_gemv")
tlut = importlib.import_module("tpu_lutvq_torch.kernels.lut_gemv")

torch.set_num_threads(2)

H100_SMS = 132
KINDS = {"f32": 1, "i8": 2, "i16": 3}
# (tokens, groups, padded width, Kp): phase 5's scans (8 queries' PQ16
# tables, the refine bounds' 8 subquantizers, a lone query at K=128 over a
# million codes) and a 7B projection through lut_gemv(variant=f32|i8|i16)
SCAN_SHAPES = ((8, 16, 1 << 20, 256), (8, 8, 1 << 20, 256), (1, 16, 1 << 20, 128),
               (1, 1024, 4096, 256), (8, 1024, 4096, 256), (3, 2752, 4096, 256))
# f32 tables: the JAX kernel and the emulation sum f32 in other orders
F32_TOL = 1e-6


@pytest.mark.parametrize("variant", list(KINDS))
@pytest.mark.parametrize("tokens,groups,width,kp", SCAN_SHAPES)
def test_scan_plan_covers_every_tile_and_group_once(variant, tokens, groups, width, kp):
    """Every (column tile, group) once in one launch: a grid of blocks that
    covers the tiles (one each where the groups split over a cluster), the
    splits and rounds as for A; at a scan the groups do not split, and the
    blocks (at most as many as the card holds) keep the tables staged."""
    bp = next(t for t in (1, 2, 4, 8) if t >= tokens)
    plan = tlut.plan_scan(KINDS[variant], bp, groups, width, kp, H100_SMS)
    assert plan.kind == KINDS[variant] and plan.bp == bp
    check_cover(plan, groups, width, kp)
    if width == 1 << 20:
        n_rounds = len(plan.rounds(range(groups)))
        assert plan.n_splits == 1 and plan.nbuf == n_rounds
        assert plan.grid[0] <= 2 * H100_SMS


@pytest.mark.parametrize("variant", list(KINDS))
def test_scan_plan_splits_the_projection_over_a_cluster(variant):
    """At a 4096² projection the groups split over a cluster (no block
    stages more than a quarter of the tables), one block a column tile."""
    for bp in (1, 8):
        plan = tlut.plan_scan(KINDS[variant], bp, 1024, 4096, 256, H100_SMS)
        assert plan.n_splits >= 4 and plan.grid == (-(-4096 // plan.tile_cols), plan.n_splits)


@pytest.mark.parametrize("kind,bp,lanes,slots", [
    (0, 1, 1, 1), (1, 1, 1, 1), (1, 8, 8, 1), (2, 1, 1, 4), (2, 4, 1, 4), (2, 8, 2, 4),
    (3, 1, 1, 2), (3, 2, 1, 2), (3, 8, 4, 2)])
def test_scan_layout_words(kind, bp, lanes, slots):
    """A staged (group, k) row is the 4-byte words of all token slots, one
    f32 entry, two int16 or four int8 a word, padded to one word."""
    es, got_slots, got_lanes, cols, items = tlut.scan_layout(kind, bp)
    assert (got_lanes, got_slots) == (lanes, slots)
    assert got_lanes * got_slots >= bp and es * got_slots == 4
    assert items == min(4, max(1, 16 // (es * bp)))  # ≤ 64 bytes of entries, ≤ 4 items
    assert items * 4 * es * bp <= max(64, 4 * es * bp)
    assert cols in (8, 16)


def lane_sequences(plan, groups):
    """The groups each lane of the plan sums, in its order: a split's
    rounds, the row group's share of each (≡ its index mod the row
    groups)."""
    seqs = []
    for split in plan.split_groups(groups):
        for rg in range(plan.row_groups):
            seqs.append([g for rnd in plan.rounds(split) for g in rnd
                         if (g - rnd.start) % plan.row_groups == rg])
    return seqs


def packed_int8_sum(lut_q, codes_t, d_out, seqs, flush=256):
    """H's sums over int8 tables (B, G, Kp): a word of four token slots'
    entries biased by +128 (padded slots staged as zeros, so 128), split
    into two uint32 registers of two 16-bit lanes (slots 0/2: bytes 0 and
    2, slots 1/3: bytes 1 and 3) summed with 32-bit wrapping adds, widened
    into int64 every ``flush`` groups of a lane, the bias removed per group
    summed; the lanes' totals added exactly.  (B, d_out) int64."""
    b, g, _ = lut_q.shape
    bp = 4 * -(-b // 4)
    biased = np.full((bp, g, lut_q.shape[2]), 128, np.uint32)
    biased[:b] = lut_q.astype(np.int64) + 128
    codes = codes_t[:g, :d_out].astype(np.int64)
    vals = np.take_along_axis(biased, np.broadcast_to(codes, (bp, g, d_out)), axis=2)
    total = np.zeros((bp, d_out), np.int64)
    for seq in seqs:
        for w in range(bp // 4):
            pk = np.zeros((2, d_out), np.uint32)
            tot = np.zeros((4, d_out), np.int64)
            n = 0

            def widen():
                tot[0] += pk[0] & 0xFFFF
                tot[2] += pk[0] >> 16
                tot[1] += pk[1] & 0xFFFF
                tot[3] += pk[1] >> 16
                pk[:] = 0

            for gg in seq:
                word = sum(vals[4 * w + i, gg] << np.uint32(8 * i) for i in range(4))
                pk[0] += word & np.uint32(0x00FF00FF)
                pk[1] += (word >> np.uint32(8)) & np.uint32(0x00FF00FF)
                n += 1
                if n == flush:
                    widen()
                    n = 0
            widen()
            total[4 * w : 4 * w + 4] += tot - 128 * len(seq)
    return total[:b]


@pytest.mark.parametrize("groups", [16, 256, 257, 258, 2752])
def test_packed_int8_sums_equal_plain(groups):
    """H's packed sums, in the plan's lanes and in one lane that sums every
    group (a scan's layout), equal ``lut_lookup_int_plain`` bit for bit with
    token 0's entries all +127 and token 1's all -127 (a 16-bit lane at its
    limit: 255 a group).  Without the widening a lane carries from 258
    groups on, and the sums differ (the control)."""
    rng = np.random.default_rng(groups)
    b, kp, width = 5, 128, 256
    lut_q = rng.integers(-127, 128, (b, groups, kp)).astype(np.int8)
    lut_q[0], lut_q[1] = 127, -127
    codes_t = rng.integers(0, kp, (groups, width)).astype(np.uint8)
    scales = torch.from_numpy((1 + 0.1 * rng.standard_normal((1, width))).astype(np.float32))
    want = tlut.lut_lookup_int_plain(torch.from_numpy(lut_q), torch.from_numpy(codes_t),
                                     scales, width)
    plan = tlut.plan_scan(KINDS["i8"], 8, groups, width, kp, H100_SMS)
    for seqs in (lane_sequences(plan, groups), [list(range(groups))]):
        got = torch.from_numpy(packed_int8_sum(lut_q, codes_t, width, seqs)).float() * scales
        assert torch.equal(got, want)
    control = torch.from_numpy(packed_int8_sum(lut_q, codes_t, width, [list(range(groups))],
                                               flush=1 << 30)).float() * scales
    assert torch.equal(control, want) == (groups <= 257)


def test_int16_words_sign_extend():
    """I's words: two tokens' int16 entries a word, the low one sign
    extended by a shift pair, the high one by an arithmetic shift; summed in
    the plan's lanes they equal the plain version bit for bit."""
    rng = np.random.default_rng(7)
    b, groups, kp, width = 3, 300, 256, 384
    lut_q = rng.integers(-32767, 32768, (b, groups, kp)).astype(np.int16)
    lut_q[0] = -32767
    codes_t = rng.integers(0, kp, (groups, width)).astype(np.uint8)
    want = tlut.lut_lookup_int_plain(torch.from_numpy(lut_q), torch.from_numpy(codes_t),
                                     None, width)
    vals = np.take_along_axis(lut_q.astype(np.int64) & 0xFFFF,
                              np.broadcast_to(codes_t.astype(np.int64), (b, groups, width)),
                              axis=2).astype(np.uint32)
    pad = np.zeros((1, groups, width), np.uint32)
    vals = np.concatenate([vals, pad])  # token slots padded to 4: two words
    plan = tlut.plan_scan(KINDS["i16"], 4, groups, width, kp, H100_SMS)
    total = np.zeros((4, width), np.int64)
    for seq in lane_sequences(plan, groups):
        for w in range(2):
            word = vals[2 * w, seq] | (vals[2 * w + 1, seq] << np.uint32(16))
            total[2 * w] += ((word << np.uint32(16)).view(np.int32) >> 16).sum(axis=0)
            total[2 * w + 1] += (word.view(np.int32) >> 16).sum(axis=0)
    assert torch.equal(torch.from_numpy(total[:b]).float(), want)


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_f32_rank_order_sum_matches_jax(batch, which):
    """K's order (row groups in order, splits in rank order) over f32
    tables, against JAX's f32 kernel in interpret mode on the same tables
    and against the port's plain version; the bf16-rounded control fails."""
    rng = np.random.default_rng(40 + 3 * batch + which)
    jcfg = jcore.aqlm_2x8(256, shared_codebook=True)
    tcfg = tcore.aqlm_2x8(256, shared_codebook=True)
    cb = rng.standard_normal(jcfg.codebook_shape()).astype(np.float16)
    codes = rng.integers(0, 256, (384, jcfg.n_subvec, 2)).astype(np.uint8)
    sc = (1 + 0.1 * rng.standard_normal(384)).astype(np.float32)
    jpk = jlut.pack_params(jcfg, jcore.VQParams(jnp.asarray(cb), jnp.asarray(codes),
                                                jnp.asarray(sc)))
    tpk = tlut.pack_params(tcfg, tcore.VQParams(torch.from_numpy(cb), torch.from_numpy(codes),
                                                torch.from_numpy(sc)))
    lut = rng.standard_normal((batch, jcfg.n_groups, 256)).astype(np.float32)
    want = np.asarray(jlut._lut_gemv_packed(jcfg, jpk, jnp.asarray(lut),
                                            block_j=jlut.DEFAULT_BLOCK_J, interpret=True,
                                            variant="f32"))
    bp = next(t for t in (1, 2, 4, 8) if t >= batch)
    plan = split_plans(KINDS["f32"], bp, jcfg.n_groups, tpk.codes_t.shape[1], 256)[which]
    got = cluster_sum(torch.from_numpy(lut), tpk, plan, round_bf16=False)
    plain = tlut.lut_gemv_packed(tcfg, tpk, torch.from_numpy(lut), variant="f32")
    assert got.shape == want.shape == (batch, 384)
    assert rel_err(got.numpy(), want) <= F32_TOL
    assert rel_err(got.numpy(), plain.numpy()) <= F32_TOL
    control = cluster_sum(torch.from_numpy(lut), tpk, plan)
    assert rel_err(control.numpy(), want) > F32_TOL


def test_table_launcher_rejects_bad_tables():
    """The table kernels take 1-8 tokens' f32, int8 or int16 tables of Kp
    128 or 256 on the card; anything else is refused before a launch."""
    cfg = tcore.aqlm_2x8(256, shared_codebook=True)
    pk = tlut.pack_params(cfg, tcore.init_vq_params(torch.Generator().manual_seed(1), cfg, 128))
    before = (tlut.LUT_GEMV_F32_LAUNCHES, tlut.LUT_GEMV_I8_LAUNCHES, tlut.LUT_GEMV_I16_LAUNCHES)
    with pytest.raises(ValueError, match="tokens"):
        tlut._launch_table(torch.zeros((9, cfg.n_groups, 256)), pk.codes_t, pk.scales, pk.d_out)
    with pytest.raises(ValueError, match="Kp"):
        tlut._launch_table(torch.zeros((2, cfg.n_groups, 64), dtype=torch.int8), pk.codes_t,
                           pk.scales, pk.d_out)
    with pytest.raises(ValueError, match="f32, int8 or int16"):
        tlut._launch_table(torch.zeros((2, cfg.n_groups, 256), dtype=torch.bfloat16),
                           pk.codes_t, pk.scales, pk.d_out)
    assert (tlut.LUT_GEMV_F32_LAUNCHES, tlut.LUT_GEMV_I8_LAUNCHES,
            tlut.LUT_GEMV_I16_LAUNCHES) == before
