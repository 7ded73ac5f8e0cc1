"""The port's traffic model, sweep and attention crossover
(``tpu_lutvq_torch.dataflow``) against the JAX package's ``dataflow`` and
the card's committed measurements (``h100_sweep.csv``, ``h100_attn.csv``).

The function-level byte categories (codeword, codebook, inp, psum) and the
tensor operations are counted as the reference counts them, for every
reference workload and strategy; ``lut`` and the lookups count what the
port's kernels read.  The fitted model is held to the committed device
times, and ``pick_strategy`` to every clear winner among them.
"""

import pytest

from tpu_lutvq.dataflow import sweep as jsweep
from tpu_lutvq.dataflow import traffic as jtraffic
from tpu_lutvq_torch.core.config import aqlm_1x16, aqlm_2x8
from tpu_lutvq_torch.dataflow import attn_sweep, sweep, traffic
from tpu_lutvq_torch.models import attn_policy

# |predicted / measured - 1| of the fitted model on the committed rows (the
# worst reads 0.371, PERF.md §6), for every row of every strategy
PRED_TOL = 0.40
CLEAR_LEAD = 1.10  # the fastest exact-tier strategy leads by more than 10 %


@pytest.mark.parametrize("sname", sorted(jtraffic.SWEEP_STRATEGIES))
@pytest.mark.parametrize("wname", sorted(jsweep.WORKLOADS))
def test_function_counts_equal_reference(wname, sname):
    """codeword / codebook / inp / psum bytes and the tensor operations of
    each reference workload and strategy equal the reference's counts."""
    jcfg, jd_out, jb = jsweep.WORKLOADS[wname]
    cfg, d_out, b = sweep.WORKLOADS[wname]
    assert (d_out, b) == (jd_out, jb)
    for f in ("d_in", "n_subvec", "n_codebook", "n_cluster", "shared_codebook", "vq_type"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    want = jtraffic.SWEEP_STRATEGIES[sname](jcfg, d_out, b)
    got = traffic.SWEEP_STRATEGIES[sname](cfg, d_out, b)
    for k in ("codeword", "codebook", "inp", "psum"):
        assert got.hbm_bytes[k] == want.hbm_bytes[k], k
    assert got.tensor_ops == want.mxu_flops
    assert set(got.hbm_bytes) == set(want.hbm_bytes)


def test_lut_bytes_count_what_the_kernels_read():
    """A and B read build_lut's f32 tables (B·G·Kp·4 bytes); H and I their
    int8/int16 tables; the dequant-matmuls none."""
    cfg = aqlm_2x8(4096, shared_codebook=True)
    for b in (1, 4, 9):
        tables = b * cfg.n_groups * 256
        assert traffic.cost_lut_gemv(cfg, 4096, b).hbm_bytes["lut"] == 4 * tables
        assert traffic.cost_lut_gemv_i8(cfg, 4096, b).hbm_bytes["lut"] == tables
        assert traffic.cost_lut_gemv_i16(cfg, 4096, b).hbm_bytes["lut"] == 2 * tables
        assert traffic.cost_dequant_mm(cfg, 4096, b).hbm_bytes["lut"] == 0
        assert traffic.cost_dequant_i8(cfg, 4096, b).hbm_bytes["lut"] == 0
    # one launch per MAX_LUT_BATCH tokens: 9 rows are a B launch and an A one
    assert traffic.cost_lut_gemv(cfg, 4096, 9).calls == {"bpair": 1, "pair": 1}


def test_sweep_rows_are_the_reference_rows_and_the_llama_shapes():
    """``run_sweep()`` (no measuring) has the reference's rows, the same
    columns with VPU_Gops/MXU_Gflop renamed, and the Llama-2 projection
    rows at 1-16 rows."""
    j_rows = jsweep.run_sweep()
    rows = sweep.run_sweep()
    keys = {(r["VQ_type"], r["Strategy"]) for r in rows}
    j_keys = {(r["VQ_type"], r["Strategy"]) for r in j_rows}
    assert j_keys <= keys
    llama = {(w, s) for w in sweep.WORKLOADS if w.startswith("LLAMA") and w not in jsweep.WORKLOADS
             for s in traffic.SWEEP_STRATEGIES}
    assert keys - j_keys == llama
    assert len(llama) == 10 * 8 * 6
    renamed = {"VPU_Gops": "Lookups_G", "MXU_Gflop": "Tensor_Gop"}
    assert sweep.COLUMNS == [renamed.get(c, c) for c in jsweep.COLUMNS]
    assert all(set(r) == set(sweep.COLUMNS) for r in rows)


def test_measure_legs_raise_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA card"):
        sweep.run_sweep(measure=True)
    with pytest.raises(RuntimeError, match="CUDA card"):
        attn_sweep.measure_attention()


@pytest.mark.parametrize("batch", [1, 4, 64])
def test_codebooks_over_256_entries_route_dense(batch):
    cfg = aqlm_1x16(4096)
    assert traffic.pick_strategy(cfg, 4096, batch) == "dense_bf16"


def test_committed_csvs_name_the_card():
    for path in (sweep.SWEEP_CSV, attn_sweep.ATTN_CSV):
        first = open(path).readline()
        assert first.startswith("# NVIDIA H100") and " W" in first, first


def test_committed_constants_are_the_fit_of_the_sweep():
    """LAUNCH_S, LOOKUP_COST, STAGE_COST and TENSOR_COST are ``fit_constants`` of the
    committed sweep, and its model columns are the model's at them."""
    rows = sweep.read_csv()
    fit = sweep.fit_constants(rows)
    assert fit["LAUNCH_S"] == traffic.LAUNCH_S
    assert fit["LOOKUP_COST"] == traffic.LOOKUP_COST
    assert fit["STAGE_COST"] == traffic.STAGE_COST
    assert fit["TENSOR_COST"] == traffic.TENSOR_COST
    for r in rows:
        cfg, d_out, b = sweep.WORKLOADS[r["VQ_type"]]
        want = sweep.model_row(r["VQ_type"], r["Strategy"], cfg, d_out, b)
        assert r["Pred_us"] == pytest.approx(want["Pred_us"], abs=1e-3), r["VQ_type"]
        assert r["Bound"] == want["Bound"]


@pytest.mark.parametrize("sname", sorted(traffic.SWEEP_STRATEGIES))
def test_prediction_within_error_of_the_card(sname):
    rows = [r for r in sweep.read_csv() if r["Strategy"] == sname]
    errs = [e for w, s, e in sweep.pred_errors(rows)]
    assert len(errs) >= 80  # every Llama row measured
    worst = max(errs, key=abs)
    assert abs(worst) <= PRED_TOL, worst


@pytest.mark.parametrize("model", ["REF", "7B", "13B", "70B"])
def test_pick_strategy_takes_every_clear_winner(model):
    """Where the fastest exact-tier strategy on the card leads the other by
    more than 10 %, ``pick_strategy`` picks it."""
    meas = {}
    for r in sweep.read_csv():
        if "Measured_us" in r and r["Strategy"] in sweep.EXACT_TIER:
            meas.setdefault(r["VQ_type"], {})[r["Strategy"]] = r["Measured_us"]
    checked = 0
    for wname, times in meas.items():
        ref = wname in sweep.REFERENCE_WORKLOADS
        if (model == "REF") != ref or (not ref and not wname.startswith(f"LLAMA{model}_")):
            continue
        if len(times) < 2:
            continue
        (best, t0), (_, t1) = sorted(times.items(), key=lambda kv: kv[1])
        if t1 > CLEAR_LEAD * t0:
            checked += 1
            assert traffic.pick_strategy(*sweep.WORKLOADS[wname]) == best, (wname, times)
    assert checked > 0 or model == "REF"


def test_crossovers_read_the_measured_rows():
    """The rows from which C is fastest (PERF.md's crossovers) come from the
    same measured rows: at each shape, every row past it is a dequant_mm win."""
    rows = sweep.read_csv()
    meas = {(r["VQ_type"], r["Strategy"]): r["Measured_us"] for r in rows if "Measured_us" in r}
    for (m, p), first in sweep.crossovers(rows).items():
        for b in sweep.LLAMA_ROWS:
            w = f"LLAMA{m}_{p}_B{b}"
            wins = meas[w, "dequant_mm"] <= meas[w, "lut_gemv"]
            if first is not None and b >= first:
                assert wins, w


def test_attention_constants_are_the_committed_table():
    """``attn_policy``'s four constants are ``attn_constants`` of the
    committed table, and each flash decode row past its crossover is a
    flash win there."""
    rows = sweep.read_csv(attn_sweep.ATTN_CSV)
    got = attn_sweep.attn_constants(rows)
    for name, value in got.items():
        assert getattr(attn_policy, name) == value, name
    kinds = {r["Kind"] for r in rows}
    assert kinds == {"decode_slab", "decode_paged", "prefill", "step"}
    assert {r["Layout"] for r in rows} == set(attn_sweep.LAYOUTS)
    for r in rows:
        if r["Kind"] == "decode_paged" and r["BW"] >= got["FLASH_CROSSOVER_PAGED"]:
            assert r["Flash_us"] <= r["Einsum_us"]
        if (r["Kind"] == "decode_slab" and r["Batch"] >= got["MIN_BATCH_FOR_FLASH_SLAB"]
                and r["BW"] >= got["FLASH_CROSSOVER_SLAB"]):
            assert r["Flash_us"] <= r["Einsum_us"]


def test_attn_constants_rule_on_a_constructed_table():
    """The derivation itself: flash wins from B·W = 512 (slab, from batch 2
    on) and 256 (paged), steps lose at batch 1, prefill loses below 1 MiB."""
    def row(kind, b, w, flash, einsum, t=1):
        return dict(Kind=kind, Batch=b, T=t, Window=w, BW=b * w,
                    Transient_B=2 * 4 * b * 32 * t * w, Flash_us=flash, Einsum_us=einsum)

    rows = [row("decode_slab", b, w, 1.0, 2.0 if b * w >= 512 else 0.5)
            for b in (1, 2, 4) for w in (128, 256, 512)]
    rows += [row("decode_paged", b, w, 1.0, 2.0 if b * w >= 256 else 0.5)
             for b in (1, 2) for w in (128, 256)]
    rows += [row("step", b, w, 10.0, 11.0 if b > 1 else 9.0) for b in (1, 2) for w in (256, 512)]
    rows += [row("prefill", 1, t, 1.0, 2.0 if t >= 64 else 0.5, t=t) for t in (16, 64)]
    got = attn_sweep.attn_constants(rows)
    assert got == {"FLASH_CROSSOVER_SLAB": 512, "FLASH_CROSSOVER_PAGED": 256,
                   "MIN_BATCH_FOR_FLASH_SLAB": 2,
                   "XLA_PREFILL_TRANSIENT_BUDGET": 2 * 4 * 32 * 16 * 16}


@pytest.mark.parametrize("cfg", [aqlm_2x8(4096, group=16),
                                 aqlm_2x8(4096, group=16, shared_codebook=True),
                                 aqlm_2x8(4096, group=4, shared_codebook=True)],
                         ids=["g16", "g16-shared", "g4-shared"])
def test_auto_stays_off_a_dequant_kernel_that_cannot_take_the_layer(cfg):
    """C takes every even d_subvec and codebook count now (its general
    instances), so no layer is kept off it: ``auto`` takes the strategy of
    least predicted time at every row count, as for d_subvec 8, and at 64
    rows of these layers that is C."""
    assert not hasattr(traffic, "serves")
    for b in (1, 2, 8, 16, 64, 256):
        t = {s: traffic.STRATEGIES[s](cfg, 4096, b).time_s() for s in ("lut_gemv", "dequant_mm")}
        assert traffic.pick_strategy(cfg, 4096, b) == min(t, key=t.get)
    assert traffic.pick_strategy(cfg, 4096, 64) == "dequant_mm"
