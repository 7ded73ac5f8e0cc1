"""The dequant kernels' split plans (``kernels.dequant_mm.plan_bf16x2``,
``plan_i8`` and ``plan_f32``) and the fixed-order split reduce, checked on
the CPU.

The CUDA kernels cut d_in into k-steps and, where the output tiles cannot
fill the card, hand consecutive runs of k-steps to blocks along grid z; a
second pass sums the splits' f32 partials in split order.  The plans are
pure Python, so their cover of d_in is checked here at the row counts the
main path gives the kernels (1 and 7-16 decode and phase-2 rows, 256 prefill
rows, 1024 scoring rows) and the Llama-2-7B projection shapes; the reduce is
emulated with the plain versions' per-split partials.  The W8A8 kernel's
splits meet inside a thread-block cluster as exact integer sums: emulated
with the plain version's integer partials, they equal JAX's
``dequant_matmul(tables="i8")`` bit for bit.  The f32 tables are also held
to the JAX package at those row counts (the bf16x2 tables' cases are in
``test_torch_kernels.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lutvq.core as jcore
from tpu_lutvq.kernels import dequant_mm as jdq

import tpu_lutvq_torch.core as tcore
from tpu_lutvq_torch.kernels import dequant_mm as tdq

jlut = importlib.import_module("tpu_lutvq.kernels.lut_gemv")
tlut = importlib.import_module("tpu_lutvq_torch.kernels.lut_gemv")

torch.set_num_threads(2)

H100_SMS = 132
ROWS = (1, 7, 8, 16, 256, 1024)
SHAPES_7B = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 1100))
# the f32 tables sum the same f32 products in another order (the JAX
# comparison of test_torch_tiers.py reads ≤ 4e-7 of max|y|); a reordered
# split sum of f32 partials likewise
F32_TOL = 1e-6


def check_cover(plan):
    """Every k-step in exactly one split, splits in order, none empty."""
    ranges = plan.split_ranges()
    assert len(ranges) == plan.n_splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.steps
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c
    assert all(b > a for a, b in ranges)
    assert sum(b - a for a, b in ranges) == plan.steps


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("d_in,d_out", SHAPES_7B)
@pytest.mark.parametrize("shared", [True, False])
def test_bf16x2_plan_covers_d_in(rows, d_in, d_out, shared):
    plan = tdq.plan_bf16x2(rows, d_in // 8, d_out, shared, H100_SMS)
    check_cover(plan)
    assert plan.step == (8 if shared else 2)
    assert plan.steps * plan.step >= d_in // 8 > (plan.steps - 1) * plan.step
    cols, row_tiles, splits = plan.grid
    assert cols * plan.block_cols >= d_out and row_tiles * plan.block_rows >= rows
    assert splits == plan.n_splits
    # the tile follows the rows: 8- and 16-row swap-AB tiles, 64 rows above
    assert plan.block_rows == (8 if rows <= 8 else 16 if rows <= 16 else 64)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("d_in,d_out", SHAPES_7B + ((4095, 4096), (4095, 1100)))
def test_f32_plan_covers_d_in(rows, d_in, d_out):
    """Including an odd d_subvec's d_in (3 × 1365), which the general path
    takes in 16-input steps that cross subvectors."""
    plan = tdq.plan_f32(rows, d_in, d_out, H100_SMS)
    check_cover(plan)
    assert plan.steps * plan.step >= d_in > (plan.steps - 1) * plan.step
    assert plan.block_rows == (32 if rows <= 32 else 128)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("d_in,d_out", SHAPES_7B)
@pytest.mark.parametrize("shared", [True, False])
def test_i8_plan_covers_d_in(rows, d_in, d_out, shared):
    """The W8A8 plan: every k-step (128 inputs with a shared codebook, 32
    with per-subvector ones) in exactly one split, at most one cluster of 8
    splits a tile, the tile chosen by rows as the bf16x2 kernel's."""
    plan = tdq.plan_i8(rows, d_in // 8, d_out, shared, H100_SMS, 8)
    check_cover(plan)
    assert plan.step == (16 if shared else 4)
    assert plan.steps * plan.step >= d_in // 8 > (plan.steps - 1) * plan.step
    assert 1 <= plan.n_splits <= 8
    cols, row_tiles, splits = plan.grid
    assert cols * plan.block_cols >= d_out and row_tiles * plan.block_rows >= rows
    assert plan.block_rows == (8 if rows <= 8 else 16 if rows <= 16 else 64)
    # x_i8 rows are padded to whole 128-input steps: every split's k-steps read
    # inside the padded row
    cfg = tcore.aqlm_2x8(d_in)
    assert tdq.i8_padded_subvec(cfg) * 8 % 128 == 0
    assert plan.steps * plan.step <= tdq.i8_padded_subvec(cfg)


def test_i8_decode_rows_split_in_one_cluster():
    """At the batcher's 8 rows a 4096x4096 projection has 32 column tiles:
    the plan splits d_in 8 ways, a full cluster a tile, 256 blocks."""
    plan = tdq.plan_i8(8, 512, 4096, True, H100_SMS, 8)
    assert plan.n_splits == 8 and np.prod(plan.grid) == 256
    assert tdq.plan_i8(1024, 512, 4096, True, H100_SMS, 8).n_splits == 1


def i8_split_sum(cfg, pk, x, plan):
    """The W8A8 kernel's order: each split's int32 partial (the plain
    version's integer products over its subvectors), the splits summed in
    rank order, cast once, times xs then the scales."""
    q, s = tdq.quantize_tables_i8(cfg, pk.codebook)
    x_i8, xs = tdq.fold_i8(cfg, x, s)
    w = tdq.weight_i8(cfg, pk, q).long()  # (d_out, N, M, d)
    acc = torch.zeros((x.shape[0], pk.d_out), dtype=torch.int64)
    for a, b in plan.split_ranges():
        m0, m1 = a * plan.step, min(cfg.n_subvec, b * plan.step)
        acc += torch.einsum("rnmd,jnmd->rj", x_i8[:, :, m0:m1].long(), w[:, :, m0:m1])
    assert int(acc.abs().max()) < 2**31  # the kernel's int32 holds it
    return acc.int().float() * xs[:, None] * pk.scales[:, : pk.d_out]


@pytest.mark.parametrize("rows", [1, 8, 16, 256])
@pytest.mark.parametrize("shared", [True, False])
def test_i8_split_sum_matches_jax_bit_for_bit(rows, shared):
    """The cluster's integer split sum at a plan that splits (8 SMs, 1024
    inputs) equals JAX's W8A8 dequant_matmul in interpret mode bit for bit."""
    rng = np.random.default_rng(70 + rows + shared)
    jcfg = jcore.aqlm_2x8(1024, shared_codebook=shared)
    tcfg = tcore.aqlm_2x8(1024, shared_codebook=shared)
    cb = rng.standard_normal(jcfg.codebook_shape()).astype(np.float16)
    codes = rng.integers(0, 256, (200, jcfg.n_subvec, 2)).astype(np.uint8)
    sc = (1 + 0.1 * rng.standard_normal(200)).astype(np.float32)
    jpk = jlut.pack_params(jcfg, jcore.VQParams(jnp.asarray(cb), jnp.asarray(codes),
                                                jnp.asarray(sc)))
    tpk = tlut.pack_params(tcfg, tcore.VQParams(torch.from_numpy(cb), torch.from_numpy(codes),
                                                torch.from_numpy(sc)))
    x = rng.standard_normal((rows, 1024)).astype(np.float32)
    want = np.asarray(jdq.dequant_matmul(jcfg, jpk, jnp.asarray(x), tables="i8", interpret=True))
    plan = tdq.plan_i8(rows, tcfg.n_subvec, 200, shared, 8, 8)
    if rows <= 16:
        assert plan.n_splits > 1
    got = i8_split_sum(tcfg, tpk, torch.from_numpy(x), plan)
    assert np.array_equal(got.numpy(), want)


def test_decode_rows_fill_the_card():
    """At the batcher's 8 rows a 4096x4096 projection has 32 column tiles;
    the split brings both kernels' grids past the H100's 132 SMs."""
    for plan in (tdq.plan_bf16x2(8, 512, 4096, True, H100_SMS),
                 tdq.plan_f32(7, 4096, 4096, H100_SMS), tdq.plan_f32(8, 4096, 4096, H100_SMS)):
        assert np.prod(plan.grid) >= H100_SMS
        assert plan.n_splits > 1
    # 1024 rows fill it with tiles alone: no split, no partials
    assert tdq.plan_bf16x2(1024, 512, 4096, True, H100_SMS).n_splits == 1


@pytest.mark.parametrize("sms", [1, 8, 132])
def test_split_short_d_in_keeps_min_steps(sms):
    plan = tdq.plan_bf16x2(8, 16, 128, True, sms)  # two k-steps of 8 subvectors
    check_cover(plan)
    assert plan.n_splits == 1
    plan = tdq.plan_f32(8, 48, 128, sms)  # three 16-input steps
    check_cover(plan)
    assert plan.n_splits == 1


def params(d_in, d_out, n_sub, seed):
    rng = np.random.default_rng(seed)
    cfg = tcore.VQConfig(d_in, n_sub, 2, 256, shared_codebook=True)
    cb = torch.from_numpy(rng.standard_normal(cfg.codebook_shape()).astype(np.float16))
    codes = torch.from_numpy(rng.integers(0, 256, (d_out, n_sub, 2)).astype(np.uint8))
    sc = torch.from_numpy((1 + 0.1 * rng.standard_normal(d_out)).astype(np.float32))
    return cfg, tlut.pack_params(cfg, tcore.VQParams(cb, codes, sc))


def split_reduce(x, w, scales, plan, unit):
    """The kernels' split order: each split's f32 partial ``x[:, s] @ w[:, s].T``
    over its inputs, summed split 0 first, then the scales."""
    acc = None
    for a, b in plan.split_ranges():
        cols = slice(a * plan.step * unit, b * plan.step * unit)
        part = x[:, cols] @ w[:, cols].T
        acc = part if acc is None else acc + part
    return acc * scales


@pytest.mark.parametrize("rows", [1, 8, 16, 256])
@pytest.mark.parametrize("sms", [8, 132])
def test_bf16x2_split_reduce_matches_plain(rows, sms):
    cfg, pk = params(1024, 384, 128, seed=rows + sms)
    x = np.random.default_rng(rows).standard_normal((rows, 1024)).astype(np.float32)
    x = torch.from_numpy(x)
    plan = tdq.plan_bf16x2(rows, cfg.n_subvec, pk.d_out, True, sms)
    w = tdq.dequant_weight(cfg, pk)
    got = split_reduce(x.to(torch.bfloat16).float(), w, pk.scales[:, : pk.d_out], plan, 8)
    want = tdq.dequant_mm_plain(cfg, pk, x)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= F32_TOL


@pytest.mark.parametrize("rows", [1, 7, 256, 1024])
@pytest.mark.parametrize("d_subvec", [3, 8])
def test_f32_split_reduce_matches_plain(rows, d_subvec):
    rng = np.random.default_rng(rows + d_subvec)
    n_sub = 96
    d_in = n_sub * d_subvec
    cfg = tcore.VQConfig(d_in, n_sub, 2, 256, shared_codebook=d_subvec == 8)
    cb = torch.from_numpy(rng.standard_normal(cfg.codebook_shape()).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 256, (200, n_sub, 2)).astype(np.uint8))
    sc = torch.from_numpy((1 + 0.1 * rng.standard_normal(200)).astype(np.float32))
    pk = tlut.pack_params(cfg, tcore.VQParams(cb, codes, sc))
    x = torch.from_numpy(rng.standard_normal((rows, d_in)).astype(np.float32))
    plan = tdq.plan_f32(rows, d_in, pk.d_out, 8)
    w = tdq.dequant_weight(cfg, pk, round_bf16=False)
    got = split_reduce(x, w, pk.scales[:, : pk.d_out], plan, 1)
    want = tdq.dequant_mm_f32_plain(cfg, pk, x)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= F32_TOL


@pytest.mark.parametrize("rows", [7, 8, 16, 300])
def test_dequant_matmul_f32_matches_jax_at_path_rows(rows):
    """``tables="f32"`` at phase 2's 7 rows, the batcher's 8, 16 and a
    prefill width above 256, against JAX's kernel in interpret mode."""
    rng = np.random.default_rng(40 + rows)
    jcfg = jcore.aqlm_2x8(256, shared_codebook=True)
    tcfg = tcore.aqlm_2x8(256, shared_codebook=True)
    cb = rng.standard_normal(jcfg.codebook_shape()).astype(np.float16)
    codes = rng.integers(0, 256, (384, jcfg.n_subvec, 2)).astype(np.uint8)
    sc = (1 + 0.1 * rng.standard_normal(384)).astype(np.float16)
    jpk = jlut.pack_params(jcfg, jcore.VQParams(jnp.asarray(cb), jnp.asarray(codes),
                                                jnp.asarray(sc)))
    tpk = tlut.pack_params(tcfg, tcore.VQParams(torch.from_numpy(cb), torch.from_numpy(codes),
                                                torch.from_numpy(sc)))
    x = rng.standard_normal((rows, 256)).astype(np.float32)
    want = np.asarray(jdq.dequant_matmul(jcfg, jpk, jnp.asarray(x), interpret=True,
                                         tables="f32"), np.float64)
    before = tdq.DEQUANT_MM_F32_LAUNCHES
    got = tdq.dequant_matmul(tcfg, tpk, torch.from_numpy(x), tables="f32")
    assert tdq.DEQUANT_MM_F32_LAUNCHES == before
    assert got.shape == (rows, 384)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= F32_TOL


def test_wrapper_rejects_codes_it_cannot_stream():
    """The kernels copy code rows in 16-byte pieces: a code width that is
    not a multiple of 16 is refused before any launch."""
    cfg, pk = params(256, 128, 32, seed=3)
    bad = tlut.PackedVQ(pk.codes_t[:, :120].contiguous(), pk.codebook, None, 100)
    with pytest.raises(ValueError, match="does not cover"):
        tdq._launch(cfg, bad, torch.zeros(8, 256))
    with pytest.raises(ValueError, match="does not cover"):
        tdq._launch_f32(cfg, bad, torch.zeros(8, 256))
