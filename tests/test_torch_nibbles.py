"""Parity of the torch port's packing slice with the JAX package: nibble
(T-MAC, kernel J), shard and out_group packs from ``pack_params``, variant
resolution, ``lut_gemv`` over nibble and out_group packs, the layer's
routing of them, and J2's cluster split (``plan_nibbles``, its staged table
layout, and its rank-order reduce emulated against JAX's ``nibbles_bpair``).

Inputs are made with numpy from a seed and go through both packages: the
JAX functions as ``tests/test_kernels.py`` runs them (CPU, Pallas
``interpret=True``), the port's through its plain versions (a CPU tensor
never reaches a CUDA kernel; ``chip_smoke.py`` holds the nibble kernels to
those plain versions on the card).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lutvq.core as jcore
from tpu_lutvq.core import golden as jgolden
from tpu_lutvq.kernels import dequant_mm as jdq
from tpu_lutvq.models.linear import QuantizedLinear as JLinear

import tpu_lutvq_torch.core as tcore
from tpu_lutvq_torch.core import golden as tgolden
from tpu_lutvq_torch.core import params as tparams
from tpu_lutvq_torch.kernels import dequant_mm as tdq
from tpu_lutvq_torch.models import linear as tlin
from tpu_lutvq_torch.utils import native as tnative
from tpu_lutvq_torch.utils.convert import packed_from_numpy

jlut = importlib.import_module("tpu_lutvq.kernels.lut_gemv")
tlut = importlib.import_module("tpu_lutvq_torch.kernels.lut_gemv")

torch.set_num_threads(2)

# B=1 nibbles: f32 tables summed in another order in each package
F32_TOL = 1e-6
# nibbles_bpair: both packages round the same f32 table entries to bf16 and
# sum them in f32; the f32 entries come from bf16 products summed in another
# order, so a rare entry may round to the neighbouring bf16 value
BF16_TOL = 1e-5


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def tmac_params(d_in, d_out, *, bits=4, scales=True, zeros=False, seed=0):
    """Seeded T-MAC parameters (bit-serial codebook, random codes) as
    (jax cfg, torch cfg, jax VQParams, torch VQParams)."""
    rng = np.random.default_rng(seed)
    jcfg, tcfg = jcore.tmac(d_in, bits=bits), tcore.tmac(d_in, bits=bits)
    cb = np.array(jcore.params.tmac_codebook(jcfg, jnp.float32))
    codes = rng.integers(0, 16, (d_out, jcfg.n_subvec, jcfg.n_codebook)).astype(np.uint8)
    sc = (1 + 0.1 * rng.standard_normal(d_out)).astype(np.float32) if scales else None
    zp = (0.05 * rng.standard_normal(d_out)).astype(np.float32) if zeros else None
    jp = jcore.VQParams(*(None if a is None else jnp.asarray(a) for a in (cb, codes, sc, zp)))
    tp = tcore.VQParams(*(None if a is None else torch.from_numpy(a) for a in (cb, codes, sc, zp)))
    return jcfg, tcfg, jp, tp


def aqlm_params(d_in, d_out, *, og=1, seed=0):
    """Seeded AQLM-2x8 parameters with an ``og``-row block codebook."""
    rng = np.random.default_rng(seed)
    jcfg = jcore.aqlm_2x8(d_in, shared_codebook=True)
    tcfg = tcore.aqlm_2x8(d_in, shared_codebook=True)
    cb = rng.standard_normal((og, 2, 256, 8)).astype(np.float16)
    codes = rng.integers(0, 256, (d_out, jcfg.n_subvec, 2)).astype(np.uint8)
    sc = (1 + 0.1 * rng.standard_normal(d_out)).astype(np.float16)
    jp = jcore.VQParams(jnp.asarray(cb), jnp.asarray(codes), jnp.asarray(sc))
    tp = tcore.VQParams(torch.from_numpy(cb), torch.from_numpy(codes), torch.from_numpy(sc))
    return jcfg, tcfg, jp, tp


def assert_same_pack(tpk, jpk):
    assert tpk.codes_t.shape == jpk.codes_t.shape
    assert np.array_equal(tpk.codes_t.numpy(), np.asarray(jpk.codes_t))
    for a, b in ((tpk.scales, jpk.scales), (tpk.zero_points, jpk.zero_points)):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a.numpy(), np.asarray(b))
    assert (tpk.d_out, tpk.shards, tpk.nibbles, tpk.out_group) == (
        jpk.d_out, jpk.shards, jpk.nibbles, jpk.out_group)
    carried = packed_from_numpy(jpk, "cpu")
    assert torch.equal(carried.codes_t, tpk.codes_t)
    assert (carried.shards, carried.nibbles, carried.out_group) == (
        tpk.shards, tpk.nibbles, tpk.out_group)


# ---- packing ------------------------------------------------------------------


def test_nibble_codes_roundtrip_matches_jax():
    codes = np.random.default_rng(0).integers(0, 16, (3, 5, 12)).astype(np.uint8)
    jp = np.asarray(jcore.params.pack_codes_nibbles(jnp.asarray(codes)))
    tp = tparams.pack_codes_nibbles(torch.from_numpy(codes))
    assert np.array_equal(tp.numpy(), jp)
    assert np.array_equal(tnative.pack_nibbles_np(codes), jp)
    assert torch.equal(tparams.unpack_codes_nibbles(tp), torch.from_numpy(codes))
    assert np.array_equal(tnative.unpack_nibbles_np(jp), codes)


@pytest.mark.parametrize("bits,d_out,zeros", [(2, 256, False), (3, 200, True), (4, 1100, False)])
def test_pack_params_nibbles_byte_equal(bits, d_out, zeros):
    """tmac(128, bits): G = 32·bits groups, padded to 16 and packed two a
    byte; a width past block_j=256 pads to its multiple."""
    jcfg, tcfg, jp, tp = tmac_params(128, d_out, bits=bits, zeros=zeros, seed=bits)
    jpk = jlut.pack_params(jcfg, jp, block_j=256, nibble_pack=True)
    tpk = tlut.pack_params(tcfg, tp, block_j=256, nibble_pack=True)
    assert tpk.codes_t.shape[0] == -(-tcfg.n_groups // 16) * 8
    assert_same_pack(tpk, jpk)


@pytest.mark.parametrize("d_out,shards", [(256, 2), (1376 * 2, 2), (384, 4)])
def test_pack_params_shards_byte_equal(d_out, shards):
    """Each shard's chunk padded on its own: to 128 multiples, and to 512
    multiples past 512 (1376 → 1536, the 7B ffn over 8 shards)."""
    jcfg, tcfg, jp, tp = aqlm_params(64, d_out, seed=shards)
    jpk = jlut.pack_params(jcfg, jp, shards=shards)
    tpk = tlut.pack_params(tcfg, tp, shards=shards)
    assert_same_pack(tpk, jpk)
    with pytest.raises(ValueError, match="shard"):
        tlut.lut_gemv(tcfg, tpk, torch.zeros(1, 64))
    # one shard's chunk reads as an unsharded pack of its outputs
    width = tpk.codes_t.shape[1] // shards
    chunk = tlut.PackedVQ(tpk.codes_t[:, width:2 * width], tpk.codebook,
                          tpk.scales[:, width:2 * width], d_out, shards=shards)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 64)).astype(np.float32))
    local = d_out // shards
    want = tlut.lut_gemv(tcfg, tlut.pack_params(tcfg, tp), x)[:, local:2 * local]
    assert torch.equal(tlut.lut_gemv(tcfg, chunk, x), want)


@pytest.mark.parametrize("og", [2, 8])
def test_pack_params_out_group_byte_equal(og):
    jcfg, tcfg, jp, tp = aqlm_params(64, 48, og=og, seed=og)
    jpk = jlut.pack_params(jcfg, jp, out_group=og)
    tpk = tlut.pack_params(tcfg, tp, out_group=og)
    assert_same_pack(tpk, jpk)
    assert tpk.full_d_out == 48 * og


def test_pack_params_refusals_match():
    jcfg, tcfg, jp, tp = aqlm_params(64, 48, og=2)
    for kw, match in ((dict(nibble_pack=True), "4-bit"), (dict(out_group=4), "out_group=4"),
                      (dict(shards=5), "divide")):
        for pack, cfg, p in ((jlut.pack_params, jcfg, jp), (tlut.pack_params, tcfg, tp)):
            with pytest.raises(ValueError, match=match):
                pack(cfg, p, **kw)


# ---- variants ---------------------------------------------------------------------


@pytest.mark.parametrize("nibbles", [False, True])
@pytest.mark.parametrize("batch", [1, 2, 3, 9])
@pytest.mark.parametrize("variant", tlut.VARIANTS)
def test_resolve_variant_matches_jax(variant, batch, nibbles):
    for k in (16, 256):
        want = jlut.resolve_variant(variant, nibbles=nibbles, batch=batch, k=k)
        assert tlut.resolve_variant(variant, nibbles=nibbles, batch=batch, k=k) == want


def test_nibble_variants_only_on_nibble_packs():
    for v in tlut.NIBBLE_VARIANTS:
        assert tlut.resolve_variant(v, nibbles=True, batch=1, k=16) == "nibbles"
        assert tlut.resolve_variant(v, nibbles=True, batch=2, k=16) == "nibbles_bpair"
        # on an 8-bit pack the JAX dispatcher would run the nibble kernel
        # over byte codes; the port refuses the name
        with pytest.raises(ValueError, match="unknown lut_gemv variant"):
            tlut.resolve_variant(v, batch=1, k=256)


# ---- lut_gemv over nibble packs ---------------------------------------------------


@pytest.mark.parametrize("batch,tol", [(1, F32_TOL), (2, BF16_TOL), (3, BF16_TOL), (9, BF16_TOL)])
def test_lut_gemv_nibbles_matches_jax(batch, tol):
    """``test_zero_points_tmac_nibbles``'s layer (scales and zero points) at
    4 bits: B=1 runs ``nibbles`` (f32 tables), B ≥ 2 ``nibbles_bpair`` (bf16
    tables).  Both packages take 8 tokens a launch (``lut_batch=8``), so at
    B=9 the last token runs ``nibbles`` in each."""
    jcfg, tcfg, jp, tp = tmac_params(128, 256, zeros=True, seed=10 + batch)
    x = np.random.default_rng(20 + batch).standard_normal((batch, 128)).astype(np.float32)
    jpk = jlut.pack_params(jcfg, jp, block_j=256, nibble_pack=True)
    want = np.asarray(jlut.lut_gemv(jcfg, jpk, jnp.asarray(x), block_j=256, interpret=True,
                                    lut_batch=8))
    tpk = tlut.pack_params(tcfg, tp, block_j=256, nibble_pack=True)
    counters = (tlut.LUT_GEMV_NIBBLES_LAUNCHES, tlut.LUT_GEMV_NIBBLES_BPAIR_LAUNCHES)
    got = tlut.lut_gemv(tcfg, tpk, torch.from_numpy(x)).numpy()
    assert (tlut.LUT_GEMV_NIBBLES_LAUNCHES, tlut.LUT_GEMV_NIBBLES_BPAIR_LAUNCHES) == counters
    assert got.shape == want.shape == (batch, 256)
    assert rel_err(got, want) <= tol
    # the unpacked K=16 pack sums the same entries through the byte-code
    # lookups (f32 tables at one token, bf16 ones from two up)
    unpacked = tlut.lut_gemv(tcfg, tlut.pack_params(tcfg, tp, block_j=256), torch.from_numpy(x))
    assert rel_err(unpacked.numpy(), got) <= tol
    if batch == 1:  # f32 tables: the golden model's function
        assert rel_err(got, np.asarray(jgolden.lut_gemm(jcfg, jp, jnp.asarray(x)))) <= 1e-5


def test_nibble_plain_versions_round_where_the_kernels_do():
    """The plain version sums the table as it is given: f32 for J1, the
    bf16-rounded one for J2 (what ``_lookup`` hands each)."""
    _, tcfg, _, tp = tmac_params(64, 128, seed=3)
    pk = tlut.pack_params(tcfg, tp, nibble_pack=True)
    lut = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, tcfg.n_groups, 128)).astype(np.float32))
    unpacked = tlut.pack_params(tcfg, tp)
    for tab, round_bf16 in ((lut, False), (lut.to(torch.bfloat16), True)):
        got = tlut.lut_lookup_nibbles(tab, pk.codes_t, pk.scales, pk.d_out)
        want = tlut.lut_lookup_plain(lut, unpacked.codes_t, unpacked.scales, unpacked.d_out,
                                     round_bf16=round_bf16)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_quantized_linear_auto_on_nibbles_matches_jax():
    """At 16 rows ``auto`` would pick dequant_mm; a nibble pack stays on
    the lookup (two launches of 8 tokens, bf16 tables), and dequant_mm
    refuses nibble and out_group packs."""
    jcfg, tcfg, jp, tp = tmac_params(128, 256, bits=3, seed=30)
    x = np.random.default_rng(31).standard_normal((16, 128)).astype(np.float32)
    jl = JLinear(jlut.pack_params(jcfg, jp, nibble_pack=True))
    want = np.asarray(jl.apply(jcfg, jnp.asarray(x), strategy="auto", interpret=True))
    tl = tlin.QuantizedLinear(tlut.pack_params(tcfg, tp, nibble_pack=True))
    before = tdq.DEQUANT_MM_LAUNCHES
    got = tl.apply(tcfg, torch.from_numpy(x), strategy="auto").numpy()
    assert tdq.DEQUANT_MM_LAUNCHES == before
    assert rel_err(got, want) <= BF16_TOL
    for pack in (tl.packed, tlut.pack_params(*aqlm_params(64, 48, og=2)[1::2], out_group=2)):
        with pytest.raises(ValueError, match="nibble|out_group"):
            tdq.dequant_matmul(tcfg, pack, torch.zeros(8, 128))
    with pytest.raises(ValueError, match="nibble"):
        jdq.dequant_matmul(jcfg, jl.packed, jnp.zeros((8, 128)), interpret=True)
    with pytest.raises(ValueError, match="nibble"):
        tl.apply(tcfg, torch.from_numpy(x), strategy="dense_bf16")


# ---- out_group -------------------------------------------------------------------


@pytest.mark.parametrize("og,batch", [(2, 3), (8, 2)])
def test_lut_gemv_out_group_matches_jax(og, batch):
    """The out_group pseudo-batch: auto (bf16 tables, kernel B's function)
    and f32, against JAX and the dense weight."""
    jcfg, tcfg, jp, tp = aqlm_params(64, 40, og=og, seed=40 + og)
    x = np.random.default_rng(41).standard_normal((batch, 64)).astype(np.float32)
    jpk = jlut.pack_params(jcfg, jp, out_group=og)
    tl = tlin.QuantizedLinear(tlut.pack_params(tcfg, tp, out_group=og))
    for variant, tol in (("auto", 1e-2), ("f32", F32_TOL)):
        want = np.asarray(JLinear(jpk).apply(jcfg, jnp.asarray(x), variant=variant,
                                             interpret=True))
        got = tl.apply(tcfg, torch.from_numpy(x), variant=variant).numpy()
        assert got.shape == want.shape == (batch, 40 * og)
        assert rel_err(got, want) <= tol, variant
    # y[b, o·og + r] = x · (block row r of code column o)
    w = torch.stack([tgolden.dequantize(tcfg, tp._replace(codebook=tp.codebook[r:r + 1]))
                     for r in range(og)], dim=1).reshape(40 * og, 64)
    dense = torch.from_numpy(x) @ w.T
    f32 = tl.apply(tcfg, torch.from_numpy(x), variant="f32")
    assert rel_err(f32.numpy(), dense.numpy()) <= 1e-5
    with pytest.raises(ValueError, match="out_group"):
        tl.apply(tcfg, torch.from_numpy(x), strategy="dequant_mm")


# ---- J2's cluster split ----------------------------------------------------------

H100_SMS = 132
# (code rows, padded width) of the T-MAC W4 7B projections and 4096 -> 28672:
# tmac(d_in, bits=4, group=4) has d_in groups, two a code row
TMAC_PLAN_SHAPES = ((2048, 4096), (2048, 11264), (5504, 4096), (2048, 28672))


@pytest.mark.parametrize("bp", [2, 4, 8])
@pytest.mark.parametrize("rows,width", TMAC_PLAN_SHAPES)
def test_nibble_plan_covers_every_code_row_once(rows, width, bp):
    """Each column tile's splits (one cluster of ≤ 8 blocks) cover the code
    rows in order, none empty; each split's staging rounds cover it within
    the stage budget; the grid covers the width and gives (nearly) every SM
    a block, with no workspace in device memory."""
    plan = tlut.plan_nibbles(rows, width, bp, H100_SMS)
    assert plan.tile_cols in tlut.NIBBLE_TILE_COLS
    assert 1 <= plan.n_splits <= tlut.NIBBLE_MAX_SPLITS
    tiles, splits = plan.grid
    assert splits == plan.n_splits and tiles * plan.tile_cols >= width > (tiles - 1) * plan.tile_cols
    assert tiles * splits >= 0.96 * H100_SMS
    covered = [r for split in plan.split_rows(rows) for r in split]
    assert covered == list(range(rows))
    for split in plan.split_rows(rows):
        assert len(split) > 0
        assert [r for rnd in plan.rounds(split) for r in rnd] == list(split)
    assert plan.stage_rows * 2 * tlut.NIBBLE_K * bp * 2 <= 128 * 1024


@pytest.mark.parametrize("rows,width", TMAC_PLAN_SHAPES)
def test_nibble_plan_avoids_a_second_wave_of_clusters(rows, width):
    """When the card holds fewer clusters than the ideal count (one block an
    SM), the plan counts the clusters that wait: at the 7B shapes it finds
    a split that runs in one wave of what fits."""
    def fits(bp, tc, ns, stage_rows):
        return 120 // ns  # 15 clusters of 8 where the ideal is 16

    plan = tlut.plan_nibbles(rows, width, 8, H100_SMS, fits)
    tiles, splits = plan.grid
    if width <= 11264:
        assert tiles <= fits(8, plan.tile_cols, splits, plan.stage_rows)
    assert tlut.plan_nibbles(rows, width, 8, H100_SMS, fits) is plan


def test_nibble_table_layout_puts_a_group_quad_in_one_bank_row():
    """J2's staged layout: entry (token b, group g, k) sits at (g // 2, b //
    4, g % 2, k, b % 4), so one group's 16 entries of a token quad are 128
    contiguous bytes; padded tokens and an odd G's last group are zero."""
    rng = np.random.default_rng(50)
    lut = torch.from_numpy(rng.standard_normal((6, 9, 16)).astype(np.float32)).to(torch.bfloat16)
    tab = tlut.nibble_table_layout(lut, 8)
    assert tab.shape == (5, 2, 2, 16, 4)
    for b, g, k in ((0, 0, 0), (5, 8, 15), (3, 4, 7), (4, 1, 9)):
        assert tab[g // 2, b // 4, g % 2, k, b % 4] == lut[b, g, k]
    assert not tab[4, :, 1].any() and not tab[:, 1, :, :, 2:].any()
    two = tlut.nibble_table_layout(lut[:2, :8], 2)
    assert two.shape == (4, 1, 2, 16, 2) and two[3, 0, 1, 5, 1] == lut[1, 7, 5]


def cluster_reduce(lut, pk, plan):
    """J2's order: each split's f32 sum of its code rows' entries (the
    bf16 tables as given), the splits summed in rank order, then the
    scales."""
    g = lut.shape[1]
    codes = tparams.unpack_codes_nibbles(pk.codes_t[:, :pk.d_out].T).T[:g].long()
    vals = torch.gather(lut.float(), 2, codes.unsqueeze(0).expand(lut.shape[0], g, pk.d_out))
    y = None
    for split in plan.split_rows(-(-g // 2)):
        part = vals[:, 2 * split.start : 2 * split.stop].sum(dim=1)
        y = part if y is None else y + part
    return y * pk.scales[:, :pk.d_out]


@pytest.mark.parametrize("batch", [2, 3, 8])
def test_nibble_cluster_reduce_matches_jax(batch):
    """The split sum of J2's plan (small SM counts split 64 code rows 8 ways)
    against JAX's nibbles_bpair kernel in interpret mode, same f32 tables."""
    jcfg, tcfg, jp, tp = tmac_params(128, 384, seed=60 + batch)
    jpk = jlut.pack_params(jcfg, jp, block_j=128, nibble_pack=True)
    tpk = tlut.pack_params(tcfg, tp, block_j=128, nibble_pack=True)
    lut = np.random.default_rng(61).standard_normal((batch, jcfg.n_groups, 16)).astype(np.float32)
    want = np.asarray(jlut._lut_gemv_packed(jcfg, jpk, jnp.asarray(lut), block_j=128,
                                            interpret=True, variant="nibbles_bpair"))
    bp = next(t for t in (2, 4, 8) if t >= batch)
    plan = tlut.plan_nibbles(jcfg.n_groups // 2, tpk.codes_t.shape[1], bp, 8)
    assert plan.n_splits > 1
    got = cluster_reduce(torch.from_numpy(lut).to(torch.bfloat16), tpk, plan)
    assert got.shape == want.shape == (batch, 384)
    assert rel_err(got.numpy(), want) <= BF16_TOL
    assert rel_err(tlut.lut_gemv_packed(tcfg, tpk, torch.from_numpy(lut)).numpy(), want) <= BF16_TOL


def test_nibble_bf16_launcher_rejects_cpu_tensors():
    _, tcfg, _, tp = tmac_params(64, 128, seed=5)
    pk = tlut.pack_params(tcfg, tp, nibble_pack=True)
    lut = torch.zeros((2, tcfg.n_groups, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tlut._launch_nibbles_bf16(lut, pk.codes_t, pk.scales, pk.d_out)
    with pytest.raises(ValueError, match="tokens"):
        tlut._launch_nibbles_bf16(lut[:1], pk.codes_t, pk.scales, pk.d_out)


# ---- J1's cluster split (one token's f32 tables) ----------------------------------


@pytest.mark.parametrize("rows,width", TMAC_PLAN_SHAPES)
def test_nibble_f32_plan_covers_every_code_row_once(rows, width):
    """J1's plan (f32 entries, one token): each column tile's splits cover
    the code rows in order, none empty, each split's rounds within the
    stage budget at 128 B a code row; and where the card holds two blocks
    an SM the 7B shapes take one wave of clusters."""
    def fits(bp, tc, ns, stage_rows):
        return 2 * H100_SMS // ns

    for f in (None, fits):
        plan = tlut.plan_nibbles_f32(rows, width, H100_SMS, f)
        assert plan.tile_cols in tlut.NIBBLE_TILE_COLS
        assert 1 <= plan.n_splits <= tlut.NIBBLE_MAX_SPLITS
        tiles, splits = plan.grid
        assert tiles * plan.tile_cols >= width > (tiles - 1) * plan.tile_cols
        assert [r for split in plan.split_rows(rows) for r in split] == list(range(rows))
        for split in plan.split_rows(rows):
            assert len(split) > 0
            assert [r for rnd in plan.rounds(split) for r in rnd] == list(split)
        assert plan.stage_rows * 2 * tlut.NIBBLE_K * 4 <= 128 * 1024
        slots = H100_SMS // splits if f is None else f(1, plan.tile_cols, splits, plan.stage_rows)
        if width <= 11264:
            assert tiles <= slots  # no second wave of clusters
    # the f32 rows are twice a bf16 pair's bytes: half as many a round
    assert tlut.plan_nibbles_f32(8192, 4096, 8).stage_rows == 1024
    assert tlut.plan_nibbles(8192, 4096, 2, 8).stage_rows == 1024
    assert tlut.plan_nibbles_f32(rows, width, H100_SMS) is tlut.plan_nibbles_f32(rows, width,
                                                                                H100_SMS)


@pytest.mark.parametrize("bits,width", [(2, 128), (3, 384), (4, 256)])
def test_nibble_f32_cluster_reduce_matches_jax(bits, width):
    """J1's order (each split's f32 sum of its code rows' two entries, the
    splits in rank order, then the scales) over one token's f32 tables,
    against JAX's nibbles kernel in interpret mode; a small SM count splits
    the rows over the cluster."""
    jcfg, tcfg, jp, tp = tmac_params(128, width, bits=bits, seed=70 + bits)
    jpk = jlut.pack_params(jcfg, jp, block_j=128, nibble_pack=True)
    tpk = tlut.pack_params(tcfg, tp, block_j=128, nibble_pack=True)
    lut = np.random.default_rng(71).standard_normal((1, jcfg.n_groups, 128)).astype(np.float32)
    want = np.asarray(jlut._lut_gemv_packed(jcfg, jpk, jnp.asarray(lut), block_j=128,
                                            interpret=True, variant="nibbles"))
    rows = -(-jcfg.n_groups // 2)
    plan = tlut.plan_nibbles_f32(rows, tpk.codes_t.shape[1], 16)
    assert plan.n_splits > 1
    got = cluster_reduce(torch.from_numpy(lut)[..., :16], tpk, plan)
    assert got.shape == want.shape == (1, width)
    assert rel_err(got.numpy(), want) <= F32_TOL
    assert rel_err(tlut.lut_gemv_packed(tcfg, tpk, torch.from_numpy(lut)).numpy(), want) <= F32_TOL


def test_nibble_f32_launcher_rejects_cpu_tensors():
    _, tcfg, _, tp = tmac_params(64, 128, seed=6)
    pk = tlut.pack_params(tcfg, tp, nibble_pack=True)
    lut = torch.zeros((1, tcfg.n_groups, 128), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tlut._launch_nibbles_f32(lut, pk.codes_t, pk.scales, pk.d_out)
    with pytest.raises(ValueError, match="one token"):
        tlut._launch_nibbles_f32(torch.zeros((2, tcfg.n_groups, 128)), pk.codes_t, pk.scales,
                                 pk.d_out)
    # the scan kernel no longer takes nibble codes
    assert set(tlut._SCAN_KINDS) == {torch.float32, torch.int8, torch.int16}
