"""Kernels A and M (one token's lookup, ``pair`` and ``pairf``): their
cluster split (``kernels.lut_gemv.plan_pair``) and rank-order sum over the
f32 table rounded to bf16 as it is staged, checked on the CPU.

``csrc/lut_scan.cu`` (kind 0) reads ``build_lut``'s (1, G, Kp) f32 table as
it is, rounds each entry to bf16 on its way into shared memory, and splits
a column tile's groups over a thread-block cluster of ≤ 16 blocks; inside a
block the row groups of threads interleave each round's groups, each
summing its own in order; the row groups' sums meet in order, then the
blocks' in rank order in the owner's shared memory.  The plan is pure
Python, so its cover of the groups is checked here at the shapes the main
path gives A and M (the Llama-2-7B projections); the sum is emulated with
torch ops in that exact f32 order and held to JAX's ``pair`` and ``pairf``
kernels in interpret mode.
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
# pair/pairf: both packages round the same f32 entries to bf16 and sum
# them in f32 in another order; the emulation sums the plain version's
# values in the kernel's order
BF16_TOL = 1e-5
ORDER_TOL = 1e-6
# (groups, padded width) of the 7B projections at AQLM 2x8 (2 codebooks of
# d_in / 8 subvectors): q/k/v/o, gate/up (11008 → 11264), down, a padded
# d_out (1100 → 2048)
PAIR_SHAPES = ((1024, 4096), (1024, 11264), (2752, 4096), (1024, 2048))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def check_cover(plan, groups, width, kp):
    """Every (column tile, group) once: the blocks along the grid's first
    axis take the tiles (one each with splits), a tile's splits take the
    groups in order with none empty, a split's rounds cover it, a round is
    a whole number of row groups that fits the staging registers, and the
    shared memory fits one block."""
    n_tiles = -(-width // plan.tile_cols)
    tiles = [t for block in plan.tiles(width) for t in block]
    assert sorted(tiles) == list(range(n_tiles))
    if plan.n_splits > 1:
        assert plan.grid[0] == n_tiles
    splits = plan.split_groups(groups)
    assert [g for split in splits for g in split] == list(range(groups))
    for split in splits:
        assert len(split) > 0
        assert [g for rnd in plan.rounds(split) for g in rnd] == list(split)
    assert plan.stage_groups % plan.row_groups == 0
    _, _, _, _, items = tlut.scan_layout(plan.kind, plan.bp)
    assert plan.stage_groups * kp // 4 <= plan.threads * items
    assert plan.smem_bytes(kp) <= 227 * 1024
    assert plan.threads in tlut.SCAN_THREADS and plan.tile_cols in tlut.SCAN_TILE_COLS
    assert 1 <= plan.n_splits <= tlut.SCAN_MAX_SPLITS


@pytest.mark.parametrize("kp", [128, 256])
@pytest.mark.parametrize("groups,width", PAIR_SHAPES)
def test_pair_plan_covers_every_group_once(groups, width, kp):
    plan = tlut.plan_pair(groups, width, kp, H100_SMS)
    assert plan.kind == tlut.SCAN_PAIR and plan.bp == 1
    check_cover(plan, groups, width, kp)


@pytest.mark.parametrize("groups,width", PAIR_SHAPES)
def test_pair_plan_is_a_function_of_the_shapes(groups, width):
    """The same shapes give the same plan (cached), whatever came before;
    the card's occupancy answer, where given, bounds the clusters of a
    wave."""
    a = tlut.plan_pair(groups, width, 256, H100_SMS)
    tlut.plan_pair(16, 1 << 20, 128, H100_SMS)
    assert tlut.plan_pair(groups, width, 256, H100_SMS) is a
    assert tlut.plan_scan(tlut.SCAN_PAIR, 1, groups, width, 256, H100_SMS) == a

    def fits(kind, bp, kp, threads, tc, ns, stage, nbuf):
        return 120 // ns  # clusters fill whole GPCs: fewer than SMs / splits

    plan = tlut.plan_pair(groups, width, 256, H100_SMS, fits)
    check_cover(plan, groups, width, 256)
    if plan.n_splits > 1:
        assert plan.grid[0] <= fits(0, 1, 256, plan.threads, plan.tile_cols, plan.n_splits,
                                    plan.stage_groups, plan.nbuf)


def test_pair_plan_at_4096_splits_the_table_sixteen_ways():
    """At 4096² the plan splits the groups over a cluster of 16 and reads
    the f32 table once per column tile of 1024: the H100's sweep of every
    candidate (``chip_smoke.py --plans``) read 64 such blocks fastest, ahead
    of 128 (tiles of 512) and 256 (tiles of 256), whose extra passes of the
    table through the L2 cost more than their shorter lookups save."""
    plan = tlut.plan_pair(1024, 4096, 256, H100_SMS)
    tiles, splits = plan.grid
    assert splits == 16 and plan.slice_groups == 64
    assert tiles * plan.tile_cols == 4096 and tiles <= 4
    assert tiles * splits >= 64


def cluster_sum(lut, pk, plan, round_bf16=True):
    """The kernel's order over one token's f32 table: the entries rounded to
    bf16 as staged (A, M) or not (K), each row group of a block summing its
    split's groups ≡ its index (mod the row groups) in order, the row
    groups' sums in order, the splits in rank order, then the scales."""
    b, g, _ = lut.shape
    tab = lut.to(torch.bfloat16).float() if round_bf16 else lut.float()
    codes = pk.codes_t[:g, : pk.d_out].long()
    vals = torch.gather(tab, 2, codes.unsqueeze(0).expand(b, g, pk.d_out))
    rgs = plan.row_groups
    y = None
    for split in plan.split_groups(g):
        part = None
        for rg in range(rgs):
            acc = torch.zeros((b, pk.d_out))
            for gg in split[rg::rgs]:
                acc = acc + vals[:, gg]
            part = acc if part is None else part + acc
        y = part if y is None else y + part
    return y if pk.scales is None else y * pk.scales[:, : pk.d_out]


def make_pair_case(seed, d_in=256, d_out=384):
    rng = np.random.default_rng(seed)
    jcfg = jcore.aqlm_2x8(d_in, shared_codebook=True)
    tcfg = tcore.aqlm_2x8(d_in, shared_codebook=True)
    cb = rng.standard_normal(jcfg.codebook_shape()).astype(np.float16)
    codes = rng.integers(0, 256, (d_out, jcfg.n_subvec, 2)).astype(np.uint8)
    sc = (1 + 0.1 * rng.standard_normal(d_out)).astype(np.float32)
    jpk = jlut.pack_params(jcfg, jcore.VQParams(jnp.asarray(cb), jnp.asarray(codes),
                                                jnp.asarray(sc)))
    tpk = tlut.pack_params(tcfg, tcore.VQParams(torch.from_numpy(cb), torch.from_numpy(codes),
                                                torch.from_numpy(sc)))
    lut = rng.standard_normal((1, jcfg.n_groups, 256)).astype(np.float32)
    return jcfg, tcfg, jpk, tpk, lut


def split_plans(kind, bp, groups, width, kp):
    """Candidates of the plan with splits and row groups (the orders the
    emulation must follow), and the picked plan on a card of 8 SMs."""
    cands = [p for _, p in tlut.scan_candidates(kind, bp, groups, width, kp, 8)]
    multi = [p for p in cands if p.n_splits > 1 and p.row_groups > 1]
    return [multi[0], multi[-1], tlut.plan_scan(kind, bp, groups, width, kp, 8)]


@pytest.mark.parametrize("variant", ["pair", "pairf"])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_pair_cluster_sum_matches_jax(variant, which):
    """The rank-order sum of A's and M's plans over the f32 table, rounded
    as staged, against JAX's pair and pairf kernels in interpret mode on the
    same table, and against the port's plain lookup; the f32-entry control
    (entries not rounded) fails the limit."""
    jcfg, tcfg, jpk, tpk, lut = make_pair_case(90 + which)
    want = np.asarray(jlut._lut_gemv_packed(jcfg, jpk, jnp.asarray(lut),
                                            block_j=jlut.DEFAULT_BLOCK_J, interpret=True,
                                            variant=variant))
    width = tpk.codes_t.shape[1]
    plan = split_plans(tlut.SCAN_PAIR, 1, jcfg.n_groups, width, 256)[which]
    got = cluster_sum(torch.from_numpy(lut), tpk, plan)
    plain = tlut.lut_gemv_packed(tcfg, tpk, torch.from_numpy(lut), variant=variant)
    assert got.shape == want.shape == plain.shape == (1, 384)
    assert rel_err(got.numpy(), want) <= BF16_TOL
    assert rel_err(got.numpy(), plain.numpy()) <= ORDER_TOL
    control = cluster_sum(torch.from_numpy(lut), tpk, plan, round_bf16=False)
    assert rel_err(control.numpy(), want) > BF16_TOL


def test_pair_and_pairf_take_the_f32_table_uncast(monkeypatch):
    """``lut_lookup`` at B=1 and ``lut_lookup_pairf`` hand build_lut's f32
    table to the one kernel as it is: no cast or copy before the launch,
    one launch a call, each counted on its own counter."""
    seen = []

    def run_scan(kind, lut, codes_t, scales, d_out, name, plan=None):
        seen.append((kind, lut))
        return torch.zeros((lut.shape[0], d_out))

    monkeypatch.setattr(tlut, "_run_scan", run_scan)
    cfg = tcore.aqlm_2x8(256, shared_codebook=True)
    pk = tlut.pack_params(cfg, tcore.init_vq_params(torch.Generator().manual_seed(3), cfg, 128))
    lut = tlut.build_lut(cfg, pk.codebook, torch.randn(1, 256))
    assert lut.dtype == torch.float32
    n_pair, n_pairf = tlut.LUT_GEMV_LAUNCHES, tlut.LUT_GEMV_PAIRF_LAUNCHES
    tlut._launch(lut, pk.codes_t, pk.scales, pk.d_out)
    tlut._launch_pairf(lut, pk.codes_t, pk.scales, pk.d_out)
    assert [k for k, _ in seen] == [tlut.SCAN_PAIR, tlut.SCAN_PAIR]
    assert all(t is lut for _, t in seen)
    assert tlut.LUT_GEMV_LAUNCHES == n_pair + 1 and tlut.LUT_GEMV_PAIRF_LAUNCHES == n_pairf + 1


def test_pair_launchers_reject_bad_tables():
    """A CPU tensor, more than one token (pairf) or a table width the
    kernel does not take is refused before any launch."""
    cfg = tcore.aqlm_2x8(256, shared_codebook=True)
    pk = tlut.pack_params(cfg, tcore.init_vq_params(torch.Generator().manual_seed(0), cfg, 128))
    lut = torch.zeros((1, cfg.n_groups, 256))
    before = tlut.LUT_GEMV_LAUNCHES, tlut.LUT_GEMV_PAIRF_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tlut._launch(lut, pk.codes_t, pk.scales, pk.d_out)
    with pytest.raises(ValueError, match="one token"):
        tlut._launch_pairf(torch.zeros((2, cfg.n_groups, 256)), pk.codes_t, pk.scales, pk.d_out)
    with pytest.raises(ValueError, match="Kp"):
        tlut._launch(lut[..., :64], pk.codes_t, pk.scales, pk.d_out)
    assert (tlut.LUT_GEMV_LAUNCHES, tlut.LUT_GEMV_PAIRF_LAUNCHES) == before
