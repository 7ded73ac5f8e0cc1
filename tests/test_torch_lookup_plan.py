"""Kernel B's cluster split (``kernels.lut_gemv.plan_bpair``) and its
rank-order reduce over tables rounded to bf16 as they are staged, checked
on the CPU.

``csrc/lut_bpair.cu`` splits a column tile's groups over a thread-block
cluster of ≤ 16 blocks (above 8 where the card allows it), and the tokens
over blocks of 2 or 4; inside a block, 1024 / tile_cols row groups of
threads interleave the split's groups, each summing its own in order; the
row groups' sums meet in order, then the blocks' in rank order.  The plan
is pure Python, so its cover of the groups is checked here at the shapes
the main path gives B (the Llama-2-7B projections at 2-8 decode tokens,
the PQ16 and RQ4 scans over a million codes); the reduce is emulated with
torch ops in that exact f32 order and held to JAX's ``bpair`` kernel in
interpret mode.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lutvq.core as jcore

import tpu_lutvq_torch.core as tcore

jlut = importlib.import_module("tpu_lutvq.kernels.lut_gemv")
tlut = importlib.import_module("tpu_lutvq_torch.kernels.lut_gemv")

torch.set_num_threads(2)

H100_SMS = 132
# bpair: both packages round the same f32 table entries to bf16 and sum
# them in f32 in another order
BF16_TOL = 1e-5
# (groups, padded width, Kp) of the 7B projections (AQLM 2x8: 2 codebooks
# of d_in / 8 subvectors) and of phase 5's scans (PQ16, RQ4 over 1M codes)
PLAN_SHAPES = ((1024, 4096, 256), (1024, 11264, 256), (2752, 4096, 256), (1024, 1152, 256),
               (16, 1 << 20, 256), (4, 1 << 20, 256), (16, 4096, 128))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("bp", [2, 4, 8])
@pytest.mark.parametrize("groups,width,kp", PLAN_SHAPES)
def test_bpair_plan_covers_every_group_once(groups, width, kp, bp):
    """Each column tile's splits (one cluster) cover the groups in order,
    none empty; each split's rounds cover it; a round's tables fit a stage
    of the ring and are a whole number of row groups, each thread looking
    up ≤ 8 groups of them; the grid covers the width and the tokens."""
    plan = tlut.plan_bpair(groups, width, bp, kp, H100_SMS)
    assert plan.tile_cols in tlut.BPAIR_TILE_COLS
    assert 1 <= plan.n_splits <= tlut.BPAIR_MAX_SPLITS
    tiles, splits, _ = plan.grid
    assert splits == plan.n_splits
    assert tiles * plan.tile_cols >= width > (tiles - 1) * plan.tile_cols
    covered = [g for split in plan.split_groups(groups) for g in split]
    assert covered == list(range(groups))
    for split in plan.split_groups(groups):
        assert len(split) > 0
        assert [g for rnd in plan.rounds(split) for g in rnd] == list(split)
    row_groups = plan.row_groups
    assert plan.stage_groups % row_groups == 0
    assert 1 <= plan.stage_groups // row_groups <= 8
    # tokens in blocks of 2 or 4 along the grid's third axis
    assert plan.token_block == (2 if bp <= 2 else 4)
    assert plan.grid[2] * plan.token_block >= bp > (plan.grid[2] - 1) * plan.token_block
    assert plan.stage_groups * kp * plan.token_block <= 8192


@pytest.mark.parametrize("groups,width", [(1024, 4096), (1024, 11264), (2752, 4096)])
def test_bpair_plan_fills_the_card_and_reads_the_table_few_times(groups, width):
    """At the 7B projections and 8 tokens the plan puts the tokens in two
    blocks of 4 and splits the groups ≥ 6 ways (each block stages at most a
    twelfth of the table) over at most 8 column tiles per 4096 columns (the
    table crosses the L2 ≤ 8 times there), with ≥ 64 blocks."""
    plan = tlut.plan_bpair(groups, width, 8, 256, H100_SMS)
    tiles, splits, zs = plan.grid
    assert zs == 2 and splits >= 6 and tiles <= 8 * -(-width // 4096)
    assert tiles * splits * zs >= 64


@pytest.mark.parametrize("groups,width", [(1024, 4096), (1024, 11264), (2752, 4096)])
def test_bpair_plan_avoids_a_second_wave_of_clusters(groups, width):
    """When the card holds fewer clusters than one block an SM would give,
    the plan counts the clusters that wait, and the plan is cached."""
    def fits(bp, tc, ns, stage):
        return 120 // ns  # 15 clusters of 8 where the ideal is 16

    plan = tlut.plan_bpair(groups, width, 8, 256, H100_SMS, fits)
    tiles, splits, zs = plan.grid
    assert tiles * zs <= fits(4, plan.tile_cols, splits, plan.stage_groups)
    assert tlut.plan_bpair(groups, width, 8, 256, H100_SMS, fits) is plan


def cluster_reduce(lut, pk, plan):
    """B's order over the f32 tables: the entries rounded to bf16 (what the
    kernel does as it stages them), each row group of a block summing the
    split's groups ≡ its index (mod the row groups) in order, the row
    groups' sums in order, the splits in rank order, then the scales."""
    b, g, _ = lut.shape
    tab = lut.to(torch.bfloat16).float()
    codes = pk.codes_t[:g, : pk.d_out].long()
    vals = torch.gather(tab, 2, codes.unsqueeze(0).expand(b, g, pk.d_out))
    row_groups = plan.row_groups
    y = None
    for split in plan.split_groups(g):
        part = None
        for rg in range(row_groups):
            acc = torch.zeros((b, pk.d_out))
            for gg in split[rg::row_groups]:
                acc = acc + vals[:, gg]
            part = acc if part is None else part + acc
        y = part if y is None else y + part
    return y * pk.scales[:, : pk.d_out]


@pytest.mark.parametrize("batch", [2, 3, 4, 8])
def test_bpair_cluster_reduce_matches_jax(batch):
    """The split sum of B's plan (8 SMs split 64 groups 8 ways) over the f32
    tables, rounded as staged, against JAX's bpair kernel in interpret mode
    on the same tables, and against the port's plain lookup."""
    rng = np.random.default_rng(80 + batch)
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
    want = np.asarray(jlut._lut_gemv_packed(jcfg, jpk, jnp.asarray(lut), block_j=jlut.DEFAULT_BLOCK_J,
                                            interpret=True, variant="bpair"))
    plan = tlut.plan_bpair(jcfg.n_groups, tpk.codes_t.shape[1], batch, 256, 8)
    assert plan.n_splits > 1
    got = cluster_reduce(torch.from_numpy(lut), tpk, plan)
    assert got.shape == want.shape == (batch, 384)
    assert rel_err(got.numpy(), want) <= BF16_TOL
    plain = tlut.lut_gemv_packed(tcfg, tpk, torch.from_numpy(lut), variant="bpair")
    assert rel_err(plain.numpy(), want) <= BF16_TOL
    # the f32-entry control: tables left in f32 fail the limit
    control = tlut.lut_lookup_plain(torch.from_numpy(lut), tpk.codes_t, tpk.scales, tpk.d_out,
                                    round_bf16=False)
    assert rel_err(control.numpy(), want) > BF16_TOL


def test_bpair_launcher_rejects_cpu_tensors_and_bad_tables():
    """B reads the f32 tables as build_lut writes them; a CPU tensor, one
    token (A's) or a table width the kernel does not take is refused before
    any launch."""
    cfg = tcore.aqlm_2x8(256, shared_codebook=True)
    pk = tlut.pack_params(cfg, tcore.init_vq_params(torch.Generator().manual_seed(0), cfg, 128))
    lut = torch.zeros((4, cfg.n_groups, 256))
    before = tlut.LUT_GEMV_BPAIR_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tlut._launch_bpair(lut, pk.codes_t, pk.scales, pk.d_out)
    with pytest.raises(ValueError, match="CUDA"):
        tlut._launch(lut, pk.codes_t, pk.scales, pk.d_out)
    with pytest.raises(ValueError, match="tokens"):
        tlut._launch_bpair(lut[:1], pk.codes_t, pk.scales, pk.d_out)
    with pytest.raises(ValueError, match="Kp"):
        tlut._launch_bpair(lut[..., :64], pk.codes_t, pk.scales, pk.d_out)
    assert tlut.LUT_GEMV_BPAIR_LAUNCHES == before
