"""The dequant kernels at every layer JAX's ``dequant_matmul`` takes (C's
and G's general instances: any even ``d_subvec``, and ``d_subvec % 4 ==
0`` for the W8A8 tables, any codebook count, K ≤ 256), checked on the CPU.

``plan_bf16x2`` and ``plan_i8`` are pure Python: every input lies in
exactly one k-step of one split, in order.  The kernels sum each split's
partial over its inputs and the splits in split order; that order,
emulated with the plain versions' weights, meets JAX's ``dequant_matmul``
in interpret mode (the bf16x2 tables within C's 2e-4, the W8A8 ones bit for
bit: integer sums are exact in any order).  ``auto`` routes an AQLM group
16 and a PQ layer, which C now takes, by the card's measured sweep.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lutvq.core as jcore
import tpu_lutvq_torch.core as tcore
from tpu_lutvq.kernels import dequant_mm as jdq
from tpu_lutvq_torch.dataflow import sweep, traffic
from tpu_lutvq_torch.kernels import dequant_mm as tdq

jlut = importlib.import_module("tpu_lutvq.kernels.lut_gemv")
tlut = importlib.import_module("tpu_lutvq_torch.kernels.lut_gemv")

torch.set_num_threads(2)

H100_SMS = 132
C_TOL = 2e-4  # chip_smoke.py's gate for C against its plain version
CLEAR_LEAD = 1.10  # test_torch_dataflow.py's clear winner


@pytest.mark.parametrize("d_subvec", [2, 4, 6, 8, 16, 32, 128])
@pytest.mark.parametrize("n_codebook", [1, 2, 3, 4])
@pytest.mark.parametrize("rows", [1, 16, 64])
def test_plans_cover_every_input_once(d_subvec, n_codebook, rows):
    """Both plans at a 4096-ish d_in: k-steps of 16 (C's general
    instances), 32 (G's) or the 2x8 instances' steps, every input in one
    split, splits in order and none empty, G's at most one cluster of 8."""
    m = 4096 // d_subvec
    d_in = m * d_subvec
    for shared in (True, False):
        plans = [tdq.plan_bf16x2(rows, m, 1024, shared, H100_SMS, d_subvec, n_codebook)]
        if d_subvec % 4 == 0:
            plans.append(tdq.plan_i8(rows, m, 1024, shared, H100_SMS, d_subvec, n_codebook))
        for plan in plans:
            covered = []
            for a, b in plan.split_ranges():
                assert b > a
                covered.extend(range(a * plan.step, min(d_in, b * plan.step)))
            assert covered == list(range(d_in))
        c = plans[0]
        assert c.step == (16 if tdq.bf16x2_general(d_subvec, n_codebook)
                          else 64 if shared else 16)
        if len(plans) > 1:
            g = plans[1]
            assert 1 <= g.n_splits <= 8
            assert g.step == (32 if tdq.i8_general(d_subvec, n_codebook)
                              else 128 if shared else 32)
            cfg = tcore.VQConfig(d_in, m, n_codebook, 256)
            assert tdq.i8_padded_subvec(cfg) * d_subvec % tdq.I8_PAD_INPUTS == 0
            assert g.steps * g.step <= tdq.i8_padded_subvec(cfg) * d_subvec


# (d_subvec, codebooks, K, shared): the d_subvec 2 and 6 controls, an
# unpacked T-MAC layer's shape, PQ's and AQLM group 16's per-subvector
# codebooks, d_subvec 12 (two subvectors a thread's W8A8 inputs), RQ's one
# long subvector with 4 codebooks (its shared codebook streamed)
LAYERS = [(2, 2, 256, True), (6, 3, 256, True), (4, 4, 16, False), (16, 1, 256, False),
          (16, 2, 256, False), (12, 3, 256, True), (128, 4, 256, True)]


def layer(d_subvec, n_codebook, k, shared, d_out=200):
    rng = np.random.default_rng(d_subvec * 10 + n_codebook)
    m = 384 // d_subvec
    jcfg = jcore.VQConfig(m * d_subvec, m, n_codebook, k, shared_codebook=shared)
    tcfg = tcore.VQConfig(m * d_subvec, m, n_codebook, k, shared_codebook=shared)
    cb = rng.standard_normal(jcfg.codebook_shape()).astype(np.float16)
    codes = rng.integers(0, k, (d_out, m, n_codebook)).astype(np.uint8)
    sc = (1 + 0.1 * rng.standard_normal(d_out)).astype(np.float32)
    jpk = jlut.pack_params(jcfg, jcore.VQParams(jnp.asarray(cb), jnp.asarray(codes),
                                                jnp.asarray(sc)))
    tpk = tlut.pack_params(tcfg, tcore.VQParams(torch.from_numpy(cb), torch.from_numpy(codes),
                                                torch.from_numpy(sc)))
    return jcfg, tcfg, jpk, tpk


@pytest.mark.parametrize("rows", [3, 20])
@pytest.mark.parametrize("d_subvec,n_codebook,k,shared", LAYERS)
def test_bf16x2_split_order_matches_jax(d_subvec, n_codebook, k, shared, rows):
    """C's general instances: each split's f32 partial of bf16(x) against
    the plain weight over its inputs (a split may start inside a subvector),
    summed in split order, then the scales, against JAX's bf16x2
    ``dequant_matmul`` in interpret mode; the wrapper's plain version too."""
    jcfg, tcfg, jpk, tpk = layer(d_subvec, n_codebook, k, shared)
    x = np.random.default_rng(rows).standard_normal((rows, tcfg.d_in)).astype(np.float32)
    want = np.asarray(jdq.dequant_matmul(jcfg, jpk, jnp.asarray(x), interpret=True), np.float64)
    plan = tdq.plan_bf16x2(rows, tcfg.n_subvec, tpk.d_out, shared, 8, d_subvec, n_codebook)
    assert plan.n_splits > 1 and plan.step == 16
    xb = torch.from_numpy(x).to(torch.bfloat16).float()
    w = tdq.dequant_weight(tcfg, tpk)
    acc = None
    for a, b in plan.split_ranges():
        part = xb[:, a * plan.step : b * plan.step] @ w[:, a * plan.step : b * plan.step].T
        acc = part if acc is None else acc + part
    got = acc * tpk.scales[:, : tpk.d_out]
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= C_TOL
    plain = tdq.dequant_matmul(tcfg, tpk, torch.from_numpy(x))
    assert np.abs(plain.numpy() - want).max() / np.abs(want).max() <= C_TOL


@pytest.mark.parametrize("d_subvec,n_codebook,k,shared",
                         [c for c in LAYERS if c[0] % 4 == 0])
def test_i8_split_sum_matches_jax_bit_for_bit(d_subvec, n_codebook, k, shared):
    """G's general instances (and its 2x8-style ones at d_subvec 16 with ≤ 2
    codebooks): the fold padded as ``fold_i8`` writes it, each split's
    integer partial over its inputs, the splits summed in rank order, cast
    once, times xs then the scales: JAX's W8A8 ``dequant_matmul`` bit for bit."""
    jcfg, tcfg, jpk, tpk = layer(d_subvec, n_codebook, k, shared)
    x = np.random.default_rng(5).standard_normal((9, tcfg.d_in)).astype(np.float32)
    want = np.asarray(jdq.dequant_matmul(jcfg, jpk, jnp.asarray(x), tables="i8",
                                         interpret=True))
    q, s = tdq.quantize_tables_i8(tcfg, tpk.codebook)
    x_i8, xs = tdq.fold_i8(tcfg, torch.from_numpy(x), s)
    mp = tdq.i8_padded_subvec(tcfg)
    assert x_i8.shape == (9, n_codebook, mp, d_subvec) and mp * d_subvec % 128 == 0
    plan = tdq.plan_i8(9, tcfg.n_subvec, tpk.d_out, shared, 8, d_subvec, n_codebook)
    assert plan.n_splits > 1
    x_in = x_i8.reshape(9, n_codebook, -1).long()
    w_in = tdq.weight_i8(tcfg, tpk, q).reshape(tpk.d_out, n_codebook, -1).long()
    acc = torch.zeros((9, tpk.d_out), dtype=torch.int64)
    for a, b in plan.split_ranges():
        e0, e1 = a * plan.step, min(tcfg.d_in, b * plan.step)
        acc += torch.einsum("rne,jne->rj", x_in[:, :, e0:e1], w_in[:, :, e0:e1])
    assert int(acc.abs().max()) < 2**31
    got = acc.int().float() * xs[:, None] * tpk.scales[:, : tpk.d_out]
    assert np.array_equal(got.numpy(), want)
    plain = tdq.dequant_matmul(tcfg, tpk, torch.from_numpy(x), tables="i8")
    assert np.array_equal(plain.numpy(), want)


@pytest.mark.parametrize("wname", ["AQLM_GEMV", "AQLM_GEMM_B64", "PQ"])
def test_auto_routes_group16_and_pq_by_the_measured_sweep(wname):
    """The sweep's AQLM group 16 and PQ rows have measured ``dequant_mm``
    times now; ``auto`` takes the measured winner where it leads by 10 %,
    and every such layer is routed by the model's least time (no layer is
    kept off C)."""
    meas = {r["Strategy"]: r["Measured_us"] for r in sweep.read_csv()
            if r["VQ_type"] == wname and "Measured_us" in r}
    assert set(sweep.EXACT_TIER) | {"dequant_mm_i8"} <= set(meas)
    cfg, d_out, batch = sweep.WORKLOADS[wname]
    times = {s: meas[s] for s in sweep.EXACT_TIER}
    (best, t0), (_, t1) = sorted(times.items(), key=lambda kv: kv[1])
    pick = traffic.pick_strategy(cfg, d_out, batch)
    pred = {s: traffic.STRATEGIES[s](cfg, d_out, batch).time_s() for s in sweep.EXACT_TIER}
    assert pick == min(pred, key=pred.get)
    if t1 > CLEAR_LEAD * t0:
        assert pick == best, (wname, times)
