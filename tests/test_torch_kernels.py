"""Parity of the torch port's VQ core and projection kernels with the JAX
package.

Inputs are made with numpy from a seed and go through both packages: the
JAX functions as ``tests/test_kernels.py`` runs them (CPU, Pallas
``interpret=True``), the port's through its plain versions (a CPU tensor
never reaches a CUDA kernel).  The CUDA kernels are held against their
plain versions on the card by ``chip_smoke.py``, which imports no jax.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lutvq.core as jcore
from tpu_lutvq.core import golden as jgolden
from tpu_lutvq.kernels import dequant_mm as jdq
from tpu_lutvq.kernels import lut_ctor as jctor
from tpu_lutvq.models import kv_cache as jkv

import tpu_lutvq_torch.core as tcore
from tpu_lutvq_torch.core import golden as tgolden
from tpu_lutvq_torch.kernels import _build
from tpu_lutvq_torch.kernels import dequant_mm as tdq
from tpu_lutvq_torch.kernels import lut_ctor as tctor
from tpu_lutvq_torch.models import kv_cache as tkv
from tpu_lutvq_torch.models import linear as tlin
from tpu_lutvq_torch.utils.convert import packed_from_numpy

# the packages' ``kernels`` re-export the function ``lut_gemv`` over its module
jlut = importlib.import_module("tpu_lutvq.kernels.lut_gemv")
tlut = importlib.import_module("tpu_lutvq_torch.kernels.lut_gemv")

torch.set_num_threads(2)

# bf16-table paths: both packages round the same f32 values to bf16, but the
# f32 values come from sums taken in different orders, so a rare entry rounds
# to the neighbouring bf16 value; 1e-2 of max|y| bounds that with margin.
BF16_TOL = 1e-2


def make_params(d_in, d_out, *, shared, scales=True, zeros=False, seed=0,
                dtype=np.float16):
    """Seeded numpy VQ parameters, as (jax VQParams, torch VQParams, cfgs)."""
    rng = np.random.default_rng(seed)
    jcfg = jcore.aqlm_2x8(d_in, shared_codebook=shared)
    tcfg = tcore.aqlm_2x8(d_in, shared_codebook=shared)
    cb = rng.standard_normal(jcfg.codebook_shape()).astype(dtype)
    codes = rng.integers(0, jcfg.n_cluster, (d_out, jcfg.n_subvec, jcfg.n_codebook))
    codes = codes.astype(np.uint8)
    sc = (1 + 0.1 * rng.standard_normal(d_out)).astype(dtype) if scales else None
    zp = (0.05 * rng.standard_normal(d_out)).astype(dtype) if zeros else None

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    jp = jcore.VQParams(j(cb), j(codes), j(sc), j(zp))
    tp = tcore.VQParams(t(cb), t(codes), t(sc), t(zp))
    return jcfg, tcfg, jp, tp


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# ---- core ------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("aqlm_2x8", (4096,)), ("aqlm_2x8", (11008, 8, True)), ("aqlm_1x16", (4096,)),
    ("pq_ann", ()), ("rq_ann", ()), ("tmac", (256,)),
])
def test_config_schemes_match(name, args):
    j, t = getattr(jcore, name)(*args), getattr(tcore, name)(*args)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for prop in ("d_subvec", "index_bits", "n_groups", "lut_entries",
                 "bits_per_weight"):
        assert getattr(j, prop) == getattr(t, prop)
    assert j.codebook_shape() == t.codebook_shape()
    assert j.codes_bytes(4096) == t.codes_bytes(4096)


@pytest.mark.parametrize("shared,scales,zeros", [
    (False, True, False), (True, True, True), (True, False, False),
])
def test_dequantize_bit_exact(shared, scales, zeros):
    jcfg, tcfg, jp, tp = make_params(128, 96, shared=shared, scales=scales, zeros=zeros)
    want = np.asarray(jgolden.dequantize(jcfg, jp))
    got = tgolden.dequantize(tcfg, tp).numpy()
    assert np.array_equal(got, want)


def test_golden_lut_gemm_matches():
    jcfg, tcfg, jp, tp = make_params(128, 64, shared=False, zeros=True, seed=3)
    x = np.random.default_rng(4).standard_normal((3, 128)).astype(np.float32)
    np.testing.assert_allclose(
        tgolden.compute_lut(tcfg, tp.codebook, torch.from_numpy(x)).numpy(),
        np.asarray(jgolden.compute_lut(jcfg, jp.codebook, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5,
    )
    for jf, tf in ((jgolden.lut_gemm, tgolden.lut_gemm), (jgolden.fp_gemm, tgolden.fp_gemm)):
        np.testing.assert_allclose(
            tf(tcfg, tp, torch.from_numpy(x)).numpy(),
            np.asarray(jf(jcfg, jp, jnp.asarray(x))), rtol=1e-4, atol=1e-4,
        )


def test_init_vq_params_shapes_and_seed():
    cfg = tcore.aqlm_2x8(64, shared_codebook=True)
    a = tcore.init_vq_params(torch.Generator().manual_seed(5), cfg, 40, with_scales=True)
    b = tcore.init_vq_params(torch.Generator().manual_seed(5), cfg, 40, with_scales=True)
    assert a.codebook.shape == (1, 2, 256, 8) and a.codebook.dtype == torch.float16
    assert a.codes.shape == (40, 8, 2) and a.codes.dtype == torch.uint8
    assert torch.equal(a.codes, b.codes) and torch.equal(a.codebook, b.codebook)


# ---- pack_params / quantize_kv ----------------------------------------------


@pytest.mark.parametrize("d_in,d_out,shared,zeros", [
    (256, 384, False, False),  # lane-aligned
    (256, 100, True, True),    # padded to 128
    (128, 1100, True, False),  # past block_j: padded to a 1024 multiple
    (128, 2048, False, True),  # block_j multiple, no padding
])
def test_pack_params_layout_equal(d_in, d_out, shared, zeros):
    jcfg, tcfg, jp, tp = make_params(d_in, d_out, shared=shared, zeros=zeros)
    jpk = jlut.pack_params(jcfg, jp)
    tpk = tlut.pack_params(tcfg, tp)
    assert tpk.codes_t.shape == jpk.codes_t.shape
    assert np.array_equal(tpk.codes_t.numpy(), np.asarray(jpk.codes_t))
    assert np.array_equal(tpk.scales.numpy(), np.asarray(jpk.scales))
    if zeros:
        assert np.array_equal(tpk.zero_points.numpy(), np.asarray(jpk.zero_points))
    assert tpk.d_out == jpk.d_out
    carried = packed_from_numpy(jpk, "cpu")
    assert torch.equal(carried.codes_t, tpk.codes_t)
    assert torch.equal(carried.codebook, tpk.codebook)


def test_quantize_kv_bit_exact():
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal((2, 3, 5, 16))).astype(np.float32)
    # a row whose scale is exactly 1: x/scale lands on .5 ties (half-to-even)
    x[0, 0, 0] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 0, 0, 0, 0, 0, 0, 0, 0]
    jq, js = jkv.quantize_kv(jnp.asarray(x))
    tq, ts = tkv.quantize_kv(torch.from_numpy(x))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))


def test_quantize_kv_divides_through_div_scalar(monkeypatch):
    """The scale is ``absmax / 127`` as IEEE division on every device: a
    Python-number divisor would become a multiply by the reciprocal on a
    CUDA tensor, which the CPU result above cannot show."""
    calls = []

    def recording(t, divisor):
        calls.append(divisor)
        return tcore.params.div_scalar(t, divisor)

    monkeypatch.setattr(tkv, "div_scalar", recording)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 5, 16)).astype(np.float32))
    q, s = tkv.quantize_kv(x)
    assert calls == [127.0]
    assert torch.equal(s, x.abs().amax(-1) / torch.tensor(127.0))
    assert q.dtype == torch.int8 and q.shape == x.shape


# ---- build_lut / lut_gemv ---------------------------------------------------


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_build_lut_matches(shared, compute):
    jcfg, tcfg, jp, tp = make_params(128, 8, shared=shared)
    x = np.random.default_rng(2).standard_normal((3, 128)).astype(np.float32)
    jd, td = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[compute]
    want = np.asarray(jctor.build_lut(jcfg, jp.codebook, jnp.asarray(x), compute_dtype=jd))
    got = tctor.build_lut(tcfg, tp.codebook, torch.from_numpy(x), compute_dtype=td).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch", [1, 2, 3])
@pytest.mark.parametrize("shared", [False, True])
def test_lut_gemv_pair_bpair_match(batch, shared):
    """B=1 → JAX ``pair``, B≥2 → ``bpair``; the port's plain version of the
    single Hopper kernel stands for both."""
    jcfg, tcfg, jp, tp = make_params(256, 384, shared=shared, seed=batch)
    x = np.random.default_rng(10 + batch).standard_normal((batch, 256)).astype(np.float32)
    want_variant = jlut.resolve_variant("auto", nibbles=False, batch=batch, k=256)
    assert tlut.resolve_variant("auto", batch=batch, k=256) == want_variant
    assert want_variant == ("pair" if batch == 1 else "bpair")
    want = jlut.lut_gemv(jcfg, jlut.pack_params(jcfg, jp), jnp.asarray(x), interpret=True)
    before = tlut.LUT_GEMV_LAUNCHES
    got = tlut.lut_gemv(tcfg, tlut.pack_params(tcfg, tp), torch.from_numpy(x))
    assert tlut.LUT_GEMV_LAUNCHES == before  # CPU tensors take the plain version
    assert got.shape == (batch, 384)
    assert rel_err(got.numpy(), want) <= BF16_TOL


def test_lut_gemv_f32_variant_and_zero_points_match():
    jcfg, tcfg, jp, tp = make_params(128, 200, shared=True, zeros=True, seed=7,
                                     dtype=np.float32)
    x = np.random.default_rng(8).standard_normal((2, 128)).astype(np.float32)
    want = jlut.lut_gemv(jcfg, jlut.pack_params(jcfg, jp), jnp.asarray(x),
                         interpret=True, variant="f32")
    got = tlut.lut_gemv(tcfg, tlut.pack_params(tcfg, tp), torch.from_numpy(x), variant="f32")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ---- int8 / int16 / f32 tables ----------------------------------------------


@pytest.mark.parametrize("qmax", [127, 32767])
def test_quantize_lut_bit_exact(qmax):
    rng = np.random.default_rng(qmax)
    lut = (5 * rng.standard_normal((3, 6, 128))).astype(np.float32)
    # token 0's absmax is qmax, so its scale is 1: entries on .5 ties round
    # half to even in both packages
    lut[0] = np.round(lut[0])
    lut[0, 0, :8] = [qmax, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    lut[2] = 0.0  # an all-zero table: the 1e-30 floor of the scale
    jq, tq = {127: (jctor.quantize_lut_int8, tctor.quantize_lut_int8),
              32767: (jctor.quantize_lut_int16, tctor.quantize_lut_int16)}[qmax]
    for axis in (-1, (1, 2)):
        jl, js = jq(jnp.asarray(lut), axis=axis)
        tl_, ts = tq(torch.from_numpy(lut), axis=axis)
        assert tl_.dtype == (torch.int8 if qmax == 127 else torch.int16)
        assert np.array_equal(tl_.numpy(), np.asarray(jl))
        assert np.array_equal(ts.numpy(), np.asarray(js))
    assert tl_[0, 0, :8].tolist() == [qmax, 0, 2, 2, 0, -2, -2, 4]


@pytest.mark.parametrize("variant", ["i8", "i16", "f32"])
def test_lut_gemv_packed_matches_jax_given_tables(variant):
    """The same f32 tables through both packages' lookup: int8 and int16
    bit for bit (exact integer sums, the same scale order), f32 to 1e-6."""
    jcfg, tcfg, jp, tp = make_params(256, 300, shared=False, seed=11)
    lut = np.random.default_rng(12).standard_normal((5, jcfg.n_groups, 256)).astype(np.float32)
    want = np.asarray(jlut._lut_gemv_packed(jcfg, jlut.pack_params(jcfg, jp), jnp.asarray(lut),
                                            block_j=128, interpret=True, variant=variant))
    got = tlut.lut_gemv_packed(tcfg, tlut.pack_params(tcfg, tp), torch.from_numpy(lut),
                               variant=variant).numpy()
    assert got.shape == want.shape == (5, 300)
    if variant == "f32":
        assert rel_err(got, want) <= 1e-6
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("variant,tol", [("f32", 1e-4), ("i8", BF16_TOL), ("i16", 1e-4)])
def test_lut_gemv_table_variants_match(variant, tol):
    """``lut_gemv`` builds the tables in each variant's precision (bf16 for
    i8, f32 for f32 and i16); the builds agree to an ulp, so an int8 entry
    may land one step apart at a rounding boundary."""
    jcfg, tcfg, jp, tp = make_params(128, 200, shared=True, seed=13, dtype=np.float32)
    x = np.random.default_rng(14).standard_normal((3, 128)).astype(np.float32)
    want = jlut.lut_gemv(jcfg, jlut.pack_params(jcfg, jp), jnp.asarray(x), interpret=True,
                         variant=variant)
    got = tlut.lut_gemv(tcfg, tlut.pack_params(tcfg, tp), torch.from_numpy(x), variant=variant)
    assert rel_err(got.numpy(), want) <= tol


def test_quantized_linear_explicit_variants():
    """``QuantizedLinear.apply(strategy="lut_gemv", variant=...)`` reaches
    each table kernel's wrapper (here its plain version) and stays near
    the dense product."""
    _, tcfg, _, tp = make_params(128, 64, shared=True, seed=15, dtype=np.float32)
    layer = tlin.QuantizedLinear(tlut.pack_params(tcfg, tp))
    x = torch.from_numpy(np.random.default_rng(16).standard_normal((2, 128)).astype(np.float32))
    dense = layer.apply(tcfg, x, strategy="dense_bf16")
    for variant, tol in (("f32", 1e-5), ("i16", 1e-4), ("i8", 2e-2)):
        y = layer.apply(tcfg, x, strategy="lut_gemv", variant=variant)
        assert rel_err(y.numpy(), dense.numpy()) <= tol, variant


# 7: phase 2's odd rows; 8: the batcher's decode rows; 16; 300: a prefill
# width past the kernel's 64-row tiles
@pytest.mark.parametrize("batch", [7, 8, 16, 300])
def test_dequant_matmul_bf16x2_matches(batch):
    jcfg, tcfg, jp, tp = make_params(256, 384, shared=True, seed=batch)
    x = np.random.default_rng(20 + batch).standard_normal((batch, 256)).astype(np.float32)
    want = jdq.dequant_matmul(jcfg, jlut.pack_params(jcfg, jp), jnp.asarray(x),
                              interpret=True, tables="bf16x2")
    before = tdq.DEQUANT_MM_LAUNCHES
    got = tdq.dequant_matmul(tcfg, tlut.pack_params(tcfg, tp), torch.from_numpy(x))
    assert tdq.DEQUANT_MM_LAUNCHES == before
    assert got.shape == (batch, 384)
    assert rel_err(got.numpy(), want) <= BF16_TOL


def test_dequant_plain_keeps_codebook_sum_unrounded():
    """The plain version sums the N bf16 codebook entries in f32, so it
    equals a dense matmul on that f32 weight exactly (no bf16 sum)."""
    _, tcfg, _, tp = make_params(64, 32, shared=False, scales=False, seed=9)
    pk = tlut.pack_params(tcfg, tp)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((4, 64)).astype(np.float32))
    bf = tcore.VQParams(tp.codebook.to(torch.bfloat16).float(), tp.codes)
    w = tgolden.dequantize(tcfg, bf)
    assert torch.equal(tdq.dequant_weight(tcfg, pk), w)
    want = x.to(torch.bfloat16).float() @ w.T
    torch.testing.assert_close(tdq.dequant_matmul(tcfg, pk, x), want, rtol=0, atol=0)


# ---- no fallback -------------------------------------------------------------


def test_kernel_launch_rejects_cpu_tensors():
    _, tcfg, _, tp = make_params(256, 128, shared=True)
    pk = tlut.pack_params(tcfg, tp)
    lut = tctor.build_lut(tcfg, pk.codebook, torch.zeros(1, 256))
    with pytest.raises(ValueError, match="CUDA"):
        tlut._launch(lut, pk.codes_t, pk.scales, pk.d_out)
    with pytest.raises(ValueError, match="CUDA"):
        tdq._launch(tcfg, pk, torch.zeros(8, 256))
    for dtype in (torch.float32, torch.int8, torch.int16):
        with pytest.raises(ValueError, match="CUDA"):
            tlut._launch_table(lut.to(dtype), pk.codes_t, pk.scales, pk.d_out)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setenv("TPU_LUTVQ_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library()


def test_unported_variants_raise():
    """Shard and out_group packs cross into the port equal to its own
    ``pack_params`` layout, and a nibble variant name on an 8-bit pack is
    refused (the JAX dispatcher would run the nibble kernel over byte
    codes)."""
    jcfg, tcfg, jp, tp = make_params(256, 128, shared=True)
    pk = tlut.pack_params(tcfg, tp)
    with pytest.raises(ValueError, match="unknown lut_gemv variant"):
        tlut.lut_gemv(tcfg, pk, torch.zeros(1, 256), variant="nibbles")
    blocks = jp._replace(codebook=jnp.concatenate([jp.codebook] * 2))  # (out_group, N, K, d)
    tblocks = tp._replace(codebook=torch.cat([tp.codebook] * 2))
    for params, tparams, kw in ((jp, tp, dict(shards=2)), (blocks, tblocks, dict(out_group=2))):
        carried = packed_from_numpy(jlut.pack_params(jcfg, params, **kw), "cpu")
        own = tlut.pack_params(tcfg, tparams, **kw)
        assert torch.equal(carried.codes_t, own.codes_t)
        assert torch.equal(carried.scales, own.scales)
        assert (carried.shards, carried.out_group) == (own.shards, own.out_group)
