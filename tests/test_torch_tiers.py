"""Parity of the torch port's serving precision tiers with the JAX package:
the W8A8 dequant tables (``quality="fast"``, ``tables="i8"``), the f32
dequant oracle (``tables="f32"``), the in-kernel-packed ``pairf`` lookup,
the variant routing of ``QuantizedLinear.apply``, ``quality`` through the
model, chunked prefill and batcher, and ``runtime.eval``.

Inputs are made with numpy from a seed and go through both packages: the
JAX functions as its own tests run them (CPU, Pallas ``interpret=True``),
the port's through its plain versions (a CPU tensor never reaches a CUDA
kernel; ``chip_smoke.py`` holds the kernels to those plain versions on the
card).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lutvq.core as jcore
import tpu_lutvq.models.llama as jl
from tpu_lutvq.kernels import dequant_mm as jdq
from tpu_lutvq.models.linear import QuantizedLinear as JLinear
from tpu_lutvq.runtime import ContinuousBatcher as JBatcher
from tpu_lutvq.runtime import Request as JRequest
from tpu_lutvq.runtime import eval as jeval

import tpu_lutvq_torch.core as tcore
import tpu_lutvq_torch.models.llama as tl
from tpu_lutvq_torch.kernels import dequant_mm as tdq
from tpu_lutvq_torch.models import linear as tlin
from tpu_lutvq_torch.runtime import ContinuousBatcher, Request, make_chunked_prefill
from tpu_lutvq_torch.runtime import eval as teval
from tpu_lutvq_torch.utils.convert import llama_from_numpy, packed_from_numpy

# the packages' ``kernels``/``runtime`` re-export functions over their modules
jlut = importlib.import_module("tpu_lutvq.kernels.lut_gemv")
tlut = importlib.import_module("tpu_lutvq_torch.kernels.lut_gemv")
jg = importlib.import_module("tpu_lutvq.runtime.generate")

torch.set_num_threads(2)

# The f32 tables: both packages sum the same f32 products in another order
# (readings ≤ 4e-7 of max|y|), so 1e-6.
F32_TOL = 1e-6
# bf16 tables and tables built from bf16 LUTs: sums taken in different
# orders round a rare entry to the neighbouring bf16 value (or int8 step);
# models: lm_head rounds logits to bf16 — test_torch_model's 2e-2.
BF16_TOL = 1e-2
LOGITS_TOL = 2e-2


def make_params(cfg_args, d_out, *, shared, scales=True, zeros=False, seed=0,
                dtype=np.float16):
    """Seeded numpy VQ parameters as (jax cfg, torch cfg, jax packed, torch packed)."""
    rng = np.random.default_rng(seed)
    jcfg = jcore.VQConfig(*cfg_args, shared_codebook=shared)
    tcfg = tcore.VQConfig(*cfg_args, shared_codebook=shared)
    cb = rng.standard_normal(jcfg.codebook_shape()).astype(dtype)
    codes = rng.integers(0, jcfg.n_cluster, (d_out, jcfg.n_subvec, jcfg.n_codebook))
    codes = codes.astype(np.uint8)
    sc = (1 + 0.1 * rng.standard_normal(d_out)).astype(dtype) if scales else None
    zp = (0.05 * rng.standard_normal(d_out)).astype(dtype) if zeros else None

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    jpk = jlut.pack_params(jcfg, jcore.VQParams(j(cb), j(codes), j(sc), j(zp)))
    tpk = tlut.pack_params(tcfg, tcore.VQParams(t(cb), t(codes), t(sc), t(zp)))
    return jcfg, tcfg, jpk, tpk


def aqlm(d_in, **kw):
    return make_params((d_in, d_in // 8, 2, 256), kw.pop("d_out", 128), **kw)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def seeded_x(rows, d_in, seed):
    return np.random.default_rng(seed).standard_normal((rows, d_in)).astype(np.float32)


# ---- W8A8 tables --------------------------------------------------------------


def jax_fold(cfg, x, s_wg):
    """The JAX package's activation fold, as ``dequant_matmul`` inlines it
    (``dequant_mm.py:648-656``): (x_i8 (b, quarter, n·m·4), xs (b, 1))."""
    b, m, n, quarter = x.shape[0], cfg.n_subvec, cfg.n_codebook, cfg.d_subvec // 4
    xq = jnp.transpose(x.astype(jnp.float32).reshape(b, m, quarter, 4), (0, 2, 1, 3))
    xq = jnp.broadcast_to(xq[:, :, None], (b, quarter, n, m, 4))
    sw = jnp.transpose(s_wg.reshape(quarter, 4, n, m), (0, 2, 3, 1))
    x4 = (xq * sw[None]).reshape(b, quarter, 4 * m * n)
    xs = jnp.maximum(jnp.max(jnp.abs(x4), axis=(1, 2), keepdims=True) / 127.0, 1e-12)[:, 0]
    return jnp.clip(jnp.round(x4 / xs[:, None]), -127, 127).astype(jnp.int8), xs


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_i8_table_quantizer_and_fold_bit_exact(shared, dtype):
    """The compact (M_cb, N, K, d) quantization equals JAX's broadcast-then-
    quantize quad tables word for word, and the fold its int8 activations
    and token scales bit for bit."""
    jcfg, tcfg, jpk, tpk = aqlm(64, shared=shared, dtype=dtype, seed=1)
    tbl, s_wg = jdq.build_gather_tables_i8(jcfg, jpk.codebook)
    q, s = tdq.quantize_tables_i8(tcfg, tpk.codebook)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    d, m, n, k = jcfg.d_subvec, jcfg.n_subvec, jcfg.n_codebook, jcfg.n_cluster
    g_pad = tbl.shape[0] // (d // 4)
    # quad word q' packs words 4q'..4q'+3 in bytes 0..3 (little endian)
    words = np.asarray(tbl).reshape(d // 4, g_pad, -1)[:, : n * m, :k]
    want_q = words.view(np.int8).reshape(d // 4, n * m, k, 4).transpose(0, 3, 1, 2)
    want_q = want_q.reshape(d, n, m, k)  # (w, n, m, k)
    qb = tcore.params.broadcast_codebook(tcfg, q)  # (M, N, K, d)
    assert np.array_equal(qb.numpy().transpose(3, 1, 0, 2), want_q)
    sb = s.expand(m, n, d) if shared else s
    assert np.array_equal(sb.numpy().transpose(2, 1, 0).reshape(d, n * m), np.asarray(s_wg))

    x = seeded_x(5, 64, 2)
    x[1] = 0.0  # an all-zero token: the 1e-12 floor of its scale
    jx, jxs = jax_fold(jcfg, jnp.asarray(x), s_wg)
    tx, txs = tdq.fold_activations_i8(tcfg, torch.from_numpy(x), s)
    assert np.array_equal(txs.numpy(), np.asarray(jxs)[:, 0])
    # JAX columns (q, nn, mm, j) → the port's (n, m, w = 4q + j)
    want_x = np.asarray(jx).reshape(5, d // 4, n, m, 4).transpose(0, 2, 3, 1, 4)
    assert np.array_equal(tx.numpy(), want_x.reshape(5, n, m, d))


@pytest.mark.parametrize("rows", [1, 3, 8, 17])
@pytest.mark.parametrize("scales,zeros", [(True, False), (False, True)])
def test_dequant_matmul_i8_bit_exact_with_jax(rows, scales, zeros):
    """``tables="i8"`` through both packages, bit for bit: the same integer
    sums, one cast, the same scale order (JAX takes its v2 kernel here).
    The zero-point epilogue adds ``z · Σx``, a float sum each framework
    takes in its own order: the W8A8 product is held bit for bit under
    JAX's own epilogue, the whole within 1e-6."""
    jcfg, tcfg, jpk, tpk = aqlm(128, d_out=200, shared=rows % 2 == 1, scales=scales,
                                zeros=zeros, seed=rows)
    x = seeded_x(rows, 128, 30 + rows)
    want = np.asarray(jdq.dequant_matmul(jcfg, jpk, jnp.asarray(x), tables="i8", interpret=True))
    before = tdq.DEQUANT_MM_I8_LAUNCHES
    xt = torch.from_numpy(x)
    got = tdq.dequant_matmul(tcfg, tpk, xt, tables="i8")
    assert tdq.DEQUANT_MM_I8_LAUNCHES == before  # CPU tensors take the plain version
    assert got.shape == (rows, 200)
    q, s = tdq.quantize_tables_i8(tcfg, tpk.codebook)
    core = tdq.dequant_mm_i8(tcfg, tpk, *tdq.fold_activations_i8(tcfg, xt, s), q)
    with_jax_epilogue = jlut._apply_zero_points(jnp.asarray(core.numpy()), jpk, jnp.asarray(x))
    assert np.array_equal(np.asarray(with_jax_epilogue), want)
    if zeros:
        assert rel_err(got.numpy(), want) <= F32_TOL
    else:
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shared", [False, True])
def test_i8_tables_are_quantized_once_per_codebook(shared):
    """``tables_i8`` returns the same (q, s) tensors on a second call, also
    through a shard view of the pack; an in-place edit of the codebook
    recomputes them (equal to a fresh quantization); and with the cache
    warm ``dequant_matmul(tables="i8")`` stays bit-equal to JAX."""
    jcfg, tcfg, jpk, tpk = aqlm(128, d_out=200, shared=shared, dtype=np.float32, seed=11)
    q, s = tdq.tables_i8(tcfg, tpk.codebook)
    again = tdq.tables_i8(tcfg, tlut.local_view(tpk).codebook)
    assert again[0] is q and again[1] is s
    fresh = tdq.quantize_tables_i8(tcfg, tpk.codebook)
    assert torch.equal(q, fresh[0]) and torch.equal(s, fresh[1])
    x = seeded_x(8, 128, 12)
    want = np.asarray(jdq.dequant_matmul(jcfg, jpk, jnp.asarray(x), tables="i8", interpret=True))
    for _ in range(2):
        got = tdq.dequant_matmul(tcfg, tpk, torch.from_numpy(x), tables="i8")
        assert np.array_equal(got.numpy(), want)
    assert tdq.tables_i8(tcfg, tpk.codebook)[0] is q
    with torch.no_grad():
        tpk.codebook.mul_(-2.0)
    edited = tdq.tables_i8(tcfg, tpk.codebook)
    assert edited[0] is not q
    fresh = tdq.quantize_tables_i8(tcfg, tpk.codebook)
    assert torch.equal(edited[0], fresh[0]) and torch.equal(edited[1], fresh[1])
    assert torch.equal(edited[0], -q) and torch.equal(edited[1], 2 * s)


def test_i8_table_cache_drops_freed_codebooks():
    _, tcfg, _, tpk = aqlm(64, shared=True, seed=13)
    cb = tpk.codebook.clone()
    tdq.tables_i8(tcfg, cb)
    key = id(cb)
    assert key in tdq._TABLES_I8
    del cb
    assert key not in tdq._TABLES_I8


@pytest.mark.parametrize("d_in,shared", [(64, True), (136, False), (1024, True)])
def test_fold_i8_pads_the_plain_fold(d_in, shared):
    """``fold_i8`` (the fold kernel's wrapper; on the CPU its plain version)
    writes ``fold_activations_i8``'s values padded with zero subvectors to
    whole 128-input steps, the rows the W8A8 kernel reads."""
    _, tcfg, _, tpk = aqlm(d_in, shared=shared, seed=d_in)
    _, s = tdq.quantize_tables_i8(tcfg, tpk.codebook)
    x = torch.from_numpy(seeded_x(3, d_in, 14))
    before = tdq.FOLD_I8_LAUNCHES
    x_pad, xs = tdq.fold_i8(tcfg, x, s)
    assert tdq.FOLD_I8_LAUNCHES == before
    want, want_xs = tdq.fold_activations_i8(tcfg, x, s)
    mp = tdq.i8_padded_subvec(tcfg)
    assert mp * 8 % 128 == 0 and mp - 16 < tcfg.n_subvec <= mp
    assert x_pad.shape == (3, 2, mp, 8) and x_pad.dtype == torch.int8
    assert torch.equal(x_pad[:, :, : tcfg.n_subvec], want) and not x_pad[:, :, tcfg.n_subvec :].any()
    assert torch.equal(xs, want_xs)
    q, _ = tdq.quantize_tables_i8(tcfg, tpk.codebook)
    assert torch.equal(tdq.dequant_mm_i8(tcfg, tpk, x_pad, xs, q),
                       tdq.dequant_mm_i8(tcfg, tpk, want, want_xs, q))


def test_dequant_matmul_i8_matches_jax_grid_split():
    """70B w_down's d_in (28672), where JAX takes its v3 kernel
    (``tests/test_kernels.py:154``): it casts each quarter's int32 partial
    to f32 and adds them, the port casts one int32 sum.  Each cast rounds to
    the nearest f32, so they may differ by a few f32 ulps of the partials:
    1e-6 of max|y|."""
    jcfg, tcfg, jpk, tpk = aqlm(28672, d_out=256, shared=True, dtype=np.float32, seed=8)
    x = seeded_x(4, 28672, 8)
    want = jdq.dequant_matmul(jcfg, jpk, jnp.asarray(x), tables="i8", interpret=True)
    got = tdq.dequant_matmul(tcfg, tpk, torch.from_numpy(x), tables="i8")
    assert rel_err(got.numpy(), want) <= F32_TOL


def test_dequant_matmul_i8_int32_oracle():
    """The port's W8A8 path equals the numpy int32 oracle of
    ``tests/test_kernels.py::test_dequant_matmul_i8_integer_exactness``."""
    _, tcfg, jpk, tpk = aqlm(64, shared=False, dtype=np.float32, seed=7)
    x = seeded_x(3, 64, 7)
    got = tdq.dequant_matmul(tcfg, tpk, torch.from_numpy(x), tables="i8").numpy()
    d, m, n, k = tcfg.d_subvec, tcfg.n_subvec, tcfg.n_codebook, tcfg.n_cluster
    G, quarter, d_out = tcfg.n_groups, d // 4, 128
    cb = np.asarray(jpk.codebook, np.float32)
    t = np.transpose(cb, (3, 1, 0, 2)).reshape(d, G, k)
    s = np.maximum(np.abs(t).max(axis=2) / 127.0, 1e-12)
    tq = np.clip(np.round(t / s[:, :, None]), -127, 127).astype(np.int32)
    xq = x.reshape(3, m, quarter, 4).transpose(0, 2, 1, 3)
    xq = np.broadcast_to(xq[:, :, None], (3, quarter, n, m, 4))
    sw = s.reshape(quarter, 4, n, m).transpose(0, 2, 3, 1)
    x4 = (xq * sw[None]).reshape(3, quarter * 4 * m * n)
    xs = np.maximum(np.abs(x4).max(axis=1, keepdims=True) / 127.0, 1e-12)
    xi = np.clip(np.round(x4 / xs), -127, 127).astype(np.int32)
    idx = np.asarray(jpk.codes_t)[:G, :d_out].astype(np.int64)
    w_cols = np.stack([np.take_along_axis(tq[4 * q + j], idx, axis=1)
                       for q in range(quarter) for j in range(4)])
    w_int = w_cols.reshape(quarter, 4, G, d_out).transpose(0, 2, 1, 3)
    y = (xi @ w_int.reshape(quarter * 4 * m * n, d_out)).astype(np.float32) * xs
    y = y * np.asarray(jpk.scales)[:, :d_out]
    assert np.array_equal(got, y)


# ---- f32 tables ----------------------------------------------------------------


@pytest.mark.parametrize("d_subvec", [3, 4, 8, 16])
@pytest.mark.parametrize("n_codebook", [1, 2])
@pytest.mark.parametrize("k", [16, 128, 256])
def test_dequant_matmul_f32_matches_jax(d_subvec, n_codebook, k):
    jcfg, tcfg, jpk, tpk = make_params((8 * d_subvec, 8, n_codebook, k), 130,
                                       shared=k == 128, zeros=d_subvec == 3, seed=k + d_subvec)
    x = seeded_x(5, 8 * d_subvec, n_codebook)
    want = jdq.dequant_matmul(jcfg, jpk, jnp.asarray(x), tables="f32", interpret=True)
    before = tdq.DEQUANT_MM_F32_LAUNCHES
    got = tdq.dequant_matmul(tcfg, tpk, torch.from_numpy(x), tables="f32")
    assert tdq.DEQUANT_MM_F32_LAUNCHES == before
    assert got.shape == (5, 130)
    assert rel_err(got.numpy(), want) <= F32_TOL


@pytest.mark.parametrize("d_subvec,tables", [(3, "bf16x2"), (3, "i8"), (6, "i8")])
def test_dequant_matmul_reroutes_to_f32(d_subvec, tables):
    """Odd d_subvec, and the i8 tables at d_subvec % 4, take the f32
    tables in both packages (``dequant_mm.py:575-576``)."""
    jcfg, tcfg, jpk, tpk = make_params((8 * d_subvec, 8, 2, 256), 128, shared=False, seed=4)
    x = torch.from_numpy(seeded_x(4, 8 * d_subvec, 5))
    got = tdq.dequant_matmul(tcfg, tpk, x, tables=tables)
    assert torch.equal(got, tdq.dequant_matmul(tcfg, tpk, x, tables="f32"))
    want = jdq.dequant_matmul(jcfg, jpk, jnp.asarray(x.numpy()), tables=tables, interpret=True)
    assert rel_err(got.numpy(), want) <= F32_TOL


# ---- pairf ----------------------------------------------------------------------


def test_lut_gemv_pairf_matches_jax_and_pair():
    """``pairf`` sums the same bf16 entries as ``pair``: given the same f32
    tables it is JAX's ``pairf`` within 1e-6 (f32 sums in another order) and
    the port's ``pair`` exactly; from activations, ``lut_gemv``'s pairf is
    its pair bit for bit (``tests/test_kernels.py:327-337``)."""
    jcfg, tcfg, jpk, tpk = aqlm(256, d_out=384, shared=False, seed=11)
    lut = np.random.default_rng(12).standard_normal((1, jcfg.n_groups, 256)).astype(np.float32)
    want = jlut._lut_gemv_packed(jcfg, jpk, jnp.asarray(lut), block_j=128, interpret=True,
                                 variant="pairf")
    before = tlut.LUT_GEMV_PAIRF_LAUNCHES
    got = tlut.lut_gemv_packed(tcfg, tpk, torch.from_numpy(lut), variant="pairf")
    assert tlut.LUT_GEMV_PAIRF_LAUNCHES == before
    assert rel_err(got.numpy(), want) <= F32_TOL
    assert torch.equal(got, tlut.lut_gemv_packed(tcfg, tpk, torch.from_numpy(lut), variant="pair"))
    x = torch.from_numpy(seeded_x(1, 256, 13))
    y_pairf = tlut.lut_gemv(tcfg, tpk, x, variant="pairf")
    assert torch.equal(y_pairf, tlut.lut_gemv(tcfg, tpk, x, variant="pair"))
    jy = jlut.lut_gemv(jcfg, jpk, jnp.asarray(x.numpy()), interpret=True, variant="pairf")
    assert rel_err(y_pairf.numpy(), jy) <= BF16_TOL


def test_pairf_resolves_and_rejects_as_jax():
    for k, want in ((128, "f32"), (64, "f32"), (256, "pairf")):
        assert tlut.resolve_variant("pairf", batch=1, k=k) == want
        assert jlut.resolve_variant("pairf", nibbles=False, batch=1, k=k) == want
    _, tcfg, _, tpk = aqlm(256, shared=True)
    with pytest.raises(ValueError, match="B=1"):
        tlut.lut_gemv(tcfg, tpk, torch.zeros(2, 256), variant="pairf")


# ---- QuantizedLinear routing -----------------------------------------------------

VARIANTS = ("auto", "pair", "pairf", "bpair", "f32", "i8", "i16")


def expected_route(strategy, rows, variant, quality):
    """The JAX layer's routing (``linear.py:171-193``) as (path, tables or
    lookup variant): which port call the layer must equal exactly."""
    if strategy == "dequant_mm":
        if variant in ("f32", "i8"):
            return strategy, variant
        return strategy, "i8" if quality == "fast" else "bf16x2"
    return strategy, variant


@pytest.mark.parametrize("strategy,rows", [
    ("lut_gemv", 1), ("lut_gemv", 3), ("dequant_mm", 3), ("auto", 2), ("auto", 8),
    ("dense_bf16", 3),
])
def test_quantized_linear_routes_every_variant_as_jax(strategy, rows):
    """Every (variant, quality) the JAX layer accepts at this strategy and
    batch: the port takes the JAX layer's kernel path (equal to a direct
    call of it) and gives JAX's result.  Covers the repaired dequant_mm
    routing (any variant but f32/i8 → the tables ``quality`` picks).  JAX
    gets the strategy the port's ``auto`` resolved to, so that kernel path
    is held against the same one (the two ``auto`` rules differ at tiny
    widths; ``test_pick_strategy_pins_tiny_model_routes``)."""
    jcfg, tcfg, jpk, tpk = aqlm(256, d_out=256, shared=True, seed=rows, dtype=np.float32)
    x = seeded_x(rows, 256, 40 + rows)
    jlayer, tlayer = JLinear(jpk), tlin.QuantizedLinear(tpk)
    xt = torch.from_numpy(x)
    route = tlin.pick_strategy(tcfg, tpk.d_out, rows) if strategy == "auto" else strategy
    for variant in VARIANTS:
        for quality in ("exact", "fast"):
            path, how = expected_route(route, rows, variant, quality)
            if path == "lut_gemv" and how == "pairf" and rows > 1:
                for layer, xx in ((tlayer, xt), (jlayer, jnp.asarray(x))):
                    kw = {} if layer is tlayer else dict(interpret=True)
                    with pytest.raises(ValueError, match="B=1"):
                        layer.apply(tcfg if layer is tlayer else jcfg, xx,
                                    strategy=strategy if layer is tlayer else route,
                                    variant=variant, quality=quality, **kw)
                continue
            got = tlayer.apply(tcfg, xt, strategy=strategy, variant=variant, quality=quality)
            if path == "lut_gemv":
                direct = tlut.lut_gemv(tcfg, tpk, xt, variant=how)
            elif path == "dequant_mm":
                direct = tdq.dequant_matmul(tcfg, tpk, xt, tables=how)
            else:
                direct = tlayer.apply(tcfg, xt, strategy="dense_bf16")
            assert torch.equal(got, direct), (variant, quality)
            want = np.asarray(jlayer.apply(jcfg, jnp.asarray(x), strategy=route,
                                           interpret=True, variant=variant, quality=quality))
            if (path, how) == ("dequant_mm", "i8"):
                assert np.array_equal(got.numpy(), want), (variant, quality)
                continue
            resolved = tlut.resolve_variant(how, batch=rows, k=256) if path == "lut_gemv" else how
            tol = {"f32": F32_TOL, "i16": 1e-4}.get(resolved, BF16_TOL)
            if path == "dense_bf16":
                tol = F32_TOL
            assert rel_err(got.numpy(), want) <= tol, (variant, quality)


TINY_PROJECTIONS = {  # LlamaConfig.tiny(): (d_in, d_out) of each projection
    "wq": (128, 128), "wk": (128, 64), "wv": (128, 64), "wo": (128, 128),
    "w_gate": (128, 256), "w_up": (128, 256), "w_down": (256, 128),
}


@pytest.mark.parametrize("name", sorted(TINY_PROJECTIONS))
def test_pick_strategy_pins_tiny_model_routes(name):
    """What ``auto`` resolves to at each tiny-model projection and 1-9 rows:
    the port's provisional rule (``lut_gemv`` up to ``LUT_GEMV_MAX_BATCH =
    6`` rows at every shape) beside the JAX package's v5e cost model, which
    leaves ``lut_gemv`` earlier at some of these widths.  A measured H100
    crossover that moves a route must change this table."""
    from tpu_lutvq.dataflow.traffic import pick_strategy as j_pick

    d_in, d_out = TINY_PROJECTIONS[name]
    tcfg = tl.LlamaConfig.tiny().vq_cfg(d_in)
    jcfg = jl.LlamaConfig.tiny().vq_cfg(d_in)
    got = [tlin.pick_strategy(tcfg, d_out, rows) for rows in range(1, 10)]
    assert got == ["lut_gemv"] * 6 + ["dequant_mm"] * 3
    jax_routes = [j_pick(jcfg, d_out, rows) for rows in range(1, 10)]
    assert set(jax_routes) <= {"lut_gemv", "dequant_mm"}
    assert jax_routes[0] == "lut_gemv" and jax_routes[6:] == ["dequant_mm"] * 3
    # where the rules part, the port keeps the lookup longer
    assert all(t == "lut_gemv" for t, j in zip(got, jax_routes) if t != j)


# ---- the model, chunked prefill, batcher ---------------------------------------------


def carried(seed=3, dtype=jnp.float16, **kw):
    kw = dict(dict(n_layers=1, vocab_size=64, max_seq=32), **kw)
    jcfg, tcfg = jl.LlamaConfig.tiny(**kw), tl.LlamaConfig.tiny(**kw)
    jw = jl.init_llama(jax.random.PRNGKey(seed), jcfg, dtype=dtype)
    return jcfg, jw, tcfg, llama_from_numpy(tcfg, jax.tree.map(np.asarray, jw), device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return carried()


def forward_both(model, tokens, **kw):
    jcfg, jw, tcfg, tw = model
    b = tokens.shape[0]
    want, _ = jl.llama_forward(jcfg, jw, jnp.asarray(tokens), jl.init_caches(jcfg, b),
                               jnp.int32(0), interpret=True, **kw)
    got, _ = tl.llama_forward(tcfg, tw, torch.from_numpy(tokens),
                              tl.init_caches(tcfg, b, device="cpu"), 0, **kw)
    return got.numpy(), np.asarray(want)


def test_llama_forward_i16_variant_at_prefill_rows_matches_jax(tiny):
    """``variant="i16"`` with ``strategy="auto"`` at 14 rows: the dequant_mm
    projections take the bf16x2 tables, as in JAX (the port raised here)."""
    tokens = np.random.default_rng(1).integers(0, 64, (2, 7)).astype(np.int32)
    got, want = forward_both(tiny, tokens, strategy="auto", variant="i16")
    assert got.shape == want.shape == (2, 7, 64)
    assert rel_err(got, want) <= LOGITS_TOL


def test_llama_forward_quality_fast_matches_jax():
    """``quality="fast"`` under dequant_mm serves the W8A8 tables in both
    packages, on ``tests/test_models.py:245-264``'s model and tokens: logits
    match JAX's, and differ from the exact path's within that test's band."""
    model = carried(seed=0, dtype=jnp.float32, n_layers=2, vocab_size=256, max_seq=64)
    tokens = np.zeros((8, 4), np.int32)
    fast, want_fast = forward_both(model, tokens, strategy="dequant_mm", quality="fast")
    exact, want_exact = forward_both(model, tokens, strategy="dequant_mm", quality="exact")
    assert rel_err(fast, want_fast) <= LOGITS_TOL
    assert rel_err(exact, want_exact) <= LOGITS_TOL
    assert not np.array_equal(fast, exact)
    assert rel_err(fast, exact) < 0.05  # the JAX test's band


def test_decode_step_quality_reaches_projections(tiny):
    """``llama_decode_step`` forwards ``quality`` (``**kw``): at 8 rows under
    dequant_mm, fast and exact differ and fast matches JAX's step."""
    jcfg, jw, tcfg, tw = tiny
    tok = np.arange(8, dtype=np.int32)
    outs = {}
    for quality in ("exact", "fast"):
        got, _ = tl.llama_decode_step(tcfg, tw, torch.from_numpy(tok),
                                      tl.init_caches(tcfg, 8, device="cpu"), 0,
                                      strategy="dequant_mm", quality=quality)
        outs[quality] = got.numpy()
    want, _ = jl.llama_decode_step(jcfg, jw, jnp.asarray(tok), jl.init_caches(jcfg, 8),
                                   jnp.int32(0), strategy="dequant_mm", quality="fast",
                                   interpret=True)
    assert not np.array_equal(outs["fast"], outs["exact"])
    assert rel_err(outs["fast"], np.asarray(want)) <= LOGITS_TOL


def test_chunked_prefill_quality_fast_matches_jax(tiny):
    jcfg, jw, tcfg, tw = tiny
    tokens = np.random.default_rng(3).integers(0, 64, (2, 13)).astype(np.int32)
    out = {}
    for quality in ("exact", "fast"):
        chunked = make_chunked_prefill(tcfg, chunk=8, strategy="dequant_mm", quality=quality)
        out[quality] = chunked(tw, torch.from_numpy(tokens),
                               tl.init_caches(tcfg, 2, device="cpu"))[0].numpy()
    jchunked = jg.make_chunked_prefill(jcfg, chunk=8, strategy="dequant_mm", interpret=True,
                                       quality="fast")
    want, _ = jchunked(jw, jnp.asarray(tokens), jl.init_caches(jcfg, 2))
    assert out["fast"].shape == (2, 64)
    assert rel_err(out["fast"], np.asarray(want)) <= LOGITS_TOL
    assert not np.array_equal(out["fast"], out["exact"])


def test_batcher_quality_fast_matches_jax():
    """Greedy outputs of both batchers at ``quality="fast"``, 2 slots,
    staggered requests (prompts past 6 tokens and 2-row decode ticks under
    dequant_mm: the W8A8 tables in admission and decode)."""
    jcfg, jw, tcfg, tw = carried(seed=7, dtype=jnp.float32, max_seq=64)
    requests = [([1, 2, 3, 4, 5, 6, 7, 8], 5), ([4, 5], 4), ([6, 7, 8, 9, 10, 11, 12], 3)]
    outs = []
    for b, req in ((JBatcher(jcfg, jw, n_slots=2, strategy="dequant_mm", quality="fast",
                             interpret=True), JRequest),
                   (ContinuousBatcher(tcfg, tw, n_slots=2, strategy="dequant_mm",
                                      quality="fast"), Request)):
        for i, (prompt, new) in enumerate(requests):
            b.submit(req(req_id=i, prompt=prompt, max_new_tokens=new))
        done = b.run(max_steps=100)
        outs.append({r.req_id: r.output for r in done})
    assert outs[1] == outs[0]
    assert [len(outs[1][i]) for i in range(3)] == [5, 4, 3]


# ---- eval ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def eval_model():
    """``tests/test_eval.py``'s setup: the tiny model, 1 layer, f32 weights."""
    model = carried(seed=0, dtype=jnp.float32)
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0, 64), np.int32)
    return model, tokens


@pytest.mark.parametrize("kw,tol", [
    (dict(strategy="dense_bf16"), 1e-5),
    (dict(strategy="lut_gemv"), LOGITS_TOL),
    (dict(strategy="dequant_mm", variant="i8"), LOGITS_TOL),
])
def test_sequence_logprobs_and_perplexity_match_jax(eval_model, kw, tol):
    (jcfg, jw, tcfg, tw), tokens = eval_model
    want = np.asarray(jeval.sequence_logprobs(jcfg, jw, jnp.asarray(tokens), interpret=True,
                                              **kw))
    got = teval.sequence_logprobs(tcfg, tw, torch.from_numpy(tokens), **kw)
    assert got.shape == want.shape == (2, 11)
    assert float(got.max()) <= 0.0
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()
    p_got = teval.perplexity(tcfg, tw, torch.from_numpy(tokens), **kw)
    p_want = jeval.perplexity(jcfg, jw, jnp.asarray(tokens), interpret=True, **kw)
    assert abs(p_got - p_want) / p_want <= tol
    # test_eval.py's band: every tier within 2e-2 of the dense path's perplexity
    p_dense = teval.perplexity(tcfg, tw, torch.from_numpy(tokens), strategy="dense_bf16")
    assert abs(p_got - p_dense) / p_dense < 2e-2


def test_perplexity_chunking_matches_jax(eval_model):
    (jcfg, jw, tcfg, tw), _ = eval_model
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(2), (1, 25), 0, 64), np.int32)
    got = teval.perplexity(tcfg, tw, torch.from_numpy(tokens), chunk=8, strategy="dense_bf16")
    want = jeval.perplexity(jcfg, jw, jnp.asarray(tokens), chunk=8, strategy="dense_bf16")
    assert np.isfinite(got) and got > 1.0
    assert abs(got - want) / want <= 1e-5
    whole = teval.perplexity(tcfg, tw, torch.from_numpy(tokens[:, :24]), strategy="dense_bf16")
    assert got != whole  # windows do not attend across the boundary


# ---- no fallback, what still raises ----------------------------------------------


def test_new_kernel_launches_reject_cpu_tensors():
    _, tcfg, _, tpk = aqlm(256, shared=True)
    x = torch.zeros(8, 256)
    q, s = tdq.quantize_tables_i8(tcfg, tpk.codebook)
    x_i8, xs = tdq.fold_activations_i8(tcfg, x, s)
    with pytest.raises(ValueError, match="CUDA"):
        tdq._launch_i8(tcfg, tpk, x_i8, xs, q)
    with pytest.raises(ValueError, match="CUDA"):
        tdq._launch_i8(tcfg, tpk, *tdq.fold_i8(tcfg, x, s), q)
    with pytest.raises(ValueError, match="CUDA"):
        tdq._launch_fold_i8(tcfg, x, s)
    with pytest.raises(ValueError, match="CUDA"):
        tdq._launch_f32(tcfg, tpk, x)
    lut = torch.zeros(1, tcfg.n_groups, 256)
    with pytest.raises(ValueError, match="CUDA"):
        tlut._launch_pairf(lut, tpk.codes_t, tpk.scales, tpk.d_out)


def test_unknown_tables_and_packs_raise():
    jcfg, tcfg, _, tpk = aqlm(256, shared=True)
    with pytest.raises(ValueError, match="tables"):
        tdq.dequant_matmul(tcfg, tpk, torch.zeros(8, 256), tables="bf16")
    big = tcore.VQConfig(256, 32, 1, 512)
    with pytest.raises(ValueError, match="K ≤ 256"):
        tdq.dequant_matmul(big, tpk, torch.zeros(8, 256), tables="i8")
    # a nibble pack (kernel J) crosses into the port equal to its own layout
    params = jcore.init_vq_params(jax.random.PRNGKey(0), jcore.tmac(256), 128)
    nib = packed_from_numpy(jlut.pack_params(jcore.tmac(256), params, nibble_pack=True), "cpu")
    own = tlut.pack_params(tcore.tmac(256), tcore.VQParams(
        *(None if a is None else torch.from_numpy(np.array(a)) for a in params)),
        nibble_pack=True)
    assert nib.nibbles and own.nibbles
    assert torch.equal(nib.codes_t, own.codes_t)
