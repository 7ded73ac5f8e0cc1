"""Parity of the torch port's checkpoint entry points with the JAX package:
the AQLM Hugging Face loaders (2x8, out_group 8, and 1x16 in each
``one_x16`` mode), the port's own safetensors reader and writer, and the
native format across packages.

Checkpoints are synthetic, in the exact AQLM layout, made with numpy from a
seed and handed to both packages; the JAX side runs its Pallas kernels in
interpret mode, the port its kernels' plain versions (CPU tensors).
"""

import dataclasses
import importlib
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load
from safetensors.numpy import save_file as st_save

import tpu_lutvq.models.llama as jl
import tpu_lutvq.runtime.checkpoint as jck
from tpu_lutvq.core import quantize as jquant
from tpu_lutvq.models.linear import ChunkedVQLinear as JChunked

import tpu_lutvq_torch.models.llama as tl
import tpu_lutvq_torch.runtime.checkpoint as tck
from tpu_lutvq_torch.core import quantize as tquant
from tpu_lutvq_torch.models import linear as tlin
from tpu_lutvq_torch.utils import safetensors_io
from tpu_lutvq_torch.utils.convert import llama_from_numpy

jg = importlib.import_module("tpu_lutvq.runtime.generate")
tg = importlib.import_module("tpu_lutvq_torch.runtime.generate")

torch.set_num_threads(2)

# a bf16-table projection: the packages round differently ordered f32 LUT
# sums to bf16, so a rare entry lands on the neighbouring value
BF16_TOL = 1e-2
LOGITS_TOL = 2e-2  # test_torch_model.py's limit for bf16-table strategies
TINY = dict(n_layers=1, hidden=64, ffn=128, n_heads=2, n_kv_heads=2, vocab_size=32,
            max_seq=16)


def synth_aqlm_tensors(prefix, d_in, d_out, g, n_cb, k, rng, codes_dtype, out_g=1):
    """One projection's tensors in the AQLM HF layout (``tests/
    test_checkpoint.py``'s helper) and its unsigned codes."""
    m = d_in // g
    rows = d_out // out_g
    codebooks = rng.randn(n_cb, k, out_g, g).astype(np.float16)
    codes_u = rng.randint(0, k, size=(rows, m, n_cb))
    if codes_dtype == np.int8:
        codes = codes_u.astype(np.uint8).view(np.int8).reshape(rows, m, n_cb)
    elif codes_dtype == np.int16:
        codes = codes_u.astype(np.uint16).view(np.int16).reshape(rows, m, n_cb)
    else:
        codes = codes_u.astype(codes_dtype)
    scales = (1 + 0.05 * rng.randn(rows, 1, 1, 1)).astype(np.float16)
    return {
        f"{prefix}.codes": codes,
        f"{prefix}.codebooks": codebooks,
        f"{prefix}.scales": scales,
    }, codes_u


def numpy_dequant(tensors, prefix, codes_u):
    """Independent oracle: AQLM's generic ``_dequantize_weight`` (out_group
    blocks interleave as ``W[o·og + r]`` = block row r of code o)."""
    cb4 = tensors[f"{prefix}.codebooks"].astype(np.float32)  # (N, K, og, g)
    sc = tensors[f"{prefix}.scales"].reshape(-1).astype(np.float32)
    rows, m, n_cb = codes_u.shape
    og, g = cb4.shape[2], cb4.shape[3]
    w = np.zeros((rows, m, og, g), np.float32)
    for n in range(n_cb):
        w += cb4[n][codes_u[:, :, n]]
    w = w * sc[:, None, None, None]
    return w.transpose(0, 2, 1, 3).reshape(rows * og, m * g)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def both_linear(tensors, prefix, **kw):
    jlayer, jcfg = jck.load_aqlm_linear(tensors, prefix, **kw)
    tlayer, tcfg = tck.load_aqlm_linear(tensors, prefix, device="cpu", **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jlayer, jcfg, tlayer, tcfg


def tiny_hf_tensors(seed):
    """A one-layer Llama in the HF AQLM layout (2x8, int8 codes)."""
    rng = np.random.RandomState(seed)
    tensors, base = {}, "model.layers.0"
    for proj, (di, do) in {
        "self_attn.q_proj": (64, 64), "self_attn.k_proj": (64, 64),
        "self_attn.v_proj": (64, 64), "self_attn.o_proj": (64, 64),
        "mlp.gate_proj": (64, 128), "mlp.up_proj": (64, 128), "mlp.down_proj": (128, 64),
    }.items():
        tensors.update(synth_aqlm_tensors(f"{base}.{proj}", di, do, 8, 2, 256, rng, np.int8)[0])
    for norm in ("input_layernorm", "post_attention_layernorm"):
        tensors[f"{base}.{norm}.weight"] = (1 + 0.1 * rng.randn(64)).astype(np.float16)
    tensors["model.embed_tokens.weight"] = rng.randn(32, 64).astype(np.float16)
    tensors["model.norm.weight"] = np.ones(64, np.float16)
    tensors["lm_head.weight"] = rng.randn(32, 64).astype(np.float16)
    return tensors


# ---- AQLM projections -------------------------------------------------------------


def test_load_2x8_matches_jax_and_oracle():
    rng = np.random.RandomState(0)
    tensors, codes_u = synth_aqlm_tensors("proj", 64, 48, 8, 2, 256, rng, np.int8)
    jlayer, jcfg, tlayer, tcfg = both_linear(tensors, "proj")
    assert isinstance(tlayer, tlin.QuantizedLinear)
    assert np.array_equal(tlayer.packed.codes_t.numpy(), np.asarray(jlayer.packed.codes_t))
    eye = np.eye(64, dtype=np.float32)
    got = tlayer.apply(tcfg, torch.from_numpy(eye), strategy="dense_bf16").numpy()
    want = np.asarray(jlayer.apply(jcfg, jnp.asarray(eye), strategy="dense_bf16"))
    assert np.array_equal(got, want)
    np.testing.assert_allclose(got.T, numpy_dequant(tensors, "proj", codes_u), rtol=1e-6, atol=1e-6)
    x = np.random.RandomState(1).randn(3, 64).astype(np.float32)
    got = tlayer.apply(tcfg, torch.from_numpy(x), strategy="lut_gemv").numpy()
    want = np.asarray(jlayer.apply(jcfg, jnp.asarray(x), strategy="lut_gemv", interpret=True))
    assert rel_err(got, want) <= BF16_TOL


def test_load_out_group8_matches_jax_and_oracle():
    """out_group_size=8 loads as an out_group pack served by the lookup
    pseudo-batch; ``tests/test_checkpoint.py``'s tolerances."""
    rng = np.random.RandomState(7)
    tensors, codes_u = synth_aqlm_tensors("proj", 64, 48, 8, 2, 256, rng, np.int8, out_g=8)
    jlayer, jcfg, tlayer, tcfg = both_linear(tensors, "proj")
    assert tlayer.packed.out_group == 8 and tlayer.packed.full_d_out == 48
    assert np.array_equal(tlayer.packed.codes_t.numpy(), np.asarray(jlayer.packed.codes_t))
    x = np.random.RandomState(8).randn(3, 64).astype(np.float32)
    want = x @ numpy_dequant(tensors, "proj", codes_u).T
    got = tlayer.apply(tcfg, torch.from_numpy(x), strategy="lut_gemv").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=0.15)
    jgot = np.asarray(jlayer.apply(jcfg, jnp.asarray(x), strategy="lut_gemv", interpret=True))
    assert rel_err(got, jgot) <= BF16_TOL
    got32 = tlayer.apply(tcfg, torch.from_numpy(x), strategy="lut_gemv", variant="f32").numpy()
    np.testing.assert_allclose(got32, want, rtol=1e-4, atol=1e-4)


def test_load_1x16_dequant_bit_equal_and_negative_codes():
    """1x16 ``dequant``: the same bf16 weight bit for bit; int16 -1 is code 65535."""
    rng = np.random.RandomState(2)
    tensors, codes_u = synth_aqlm_tensors("p", 32, 16, 8, 1, 65536, rng, np.int16)
    raw = tensors["p.codes"].copy()
    raw[0, 0, 0] = -1
    tensors["p.codes"] = raw
    codes_u[0, 0, 0] = 65535
    jlayer, _, tlayer, _ = both_linear(tensors, "p")
    assert isinstance(tlayer, tlin.DenseLinear) and tlayer.w.dtype == torch.bfloat16
    got = tlayer.w.float().numpy()
    assert np.array_equal(got, np.asarray(jlayer.w.astype(jnp.float32)))
    want = numpy_dequant(tensors, "p", codes_u)
    assert np.array_equal(got, want.astype(ml_dtypes.bfloat16).astype(np.float32))
    # the layer slots into a projection: apply as QuantizedLinear's
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 32).astype(np.float32))
    y = tlayer.apply(None, x, strategy="auto", variant="auto", quality="fast", plain=True)
    assert y.dtype == torch.float32
    assert torch.equal(y, (x.to(torch.bfloat16) @ tlayer.w.T).float())


@pytest.mark.parametrize("og,k", [(1, 65536), (8, 4096)])
def test_load_1x16_chunked_matches_jax(og, k):
    rng = np.random.RandomState(11)
    tensors, codes_u = synth_aqlm_tensors("proj", 32, 64, 8, 1, k, rng, np.int16, out_g=og)
    jlayer, jcfg, tlayer, tcfg = both_linear(tensors, "proj", one_x16="chunked")
    assert isinstance(tlayer, tlin.ChunkedVQLinear) and isinstance(jlayer, JChunked)
    assert tlayer.codes.dtype == torch.uint16 and (tlayer.d_in, tlayer.d_out) == (32, 64)
    x = np.random.RandomState(12).randn(3, 32).astype(np.float32)
    got = tlayer.apply(tcfg, torch.from_numpy(x), chunk=3).numpy()
    want = x @ numpy_dequant(tensors, "proj", codes_u).T
    assert rel_err(got, want) <= 2e-2
    assert rel_err(got, np.asarray(jlayer.apply(jcfg, jnp.asarray(x), chunk=4))) <= 2e-2


def test_refit_decomposable_codebook_in_both_packages():
    """A 1x16 codebook that decomposes as C[k] = C_hi[k >> 8] + C_lo[k & 255]
    (values on a grid that f16 holds exactly): the refit's byte-split
    candidate recovers it, ``quantization_error`` ≤ 1e-3 in each package,
    and the loader serves the refit layer through the lookup kernels."""
    rng = np.random.RandomState(4)
    tensors, codes_u = synth_aqlm_tensors("proj", 32, 64, 8, 1, 65536, rng, np.int16)
    hi, lo = (rng.randint(-32, 32, (256, 8)) / 16 for _ in range(2))
    k = np.arange(65536)
    tensors["proj.codebooks"] = (hi[k >> 8] + lo[k & 255]).astype(np.float16)[None, :, None, :]
    w = numpy_dequant(tensors, "proj", codes_u)
    codes16 = codes_u[..., 0]
    cfg2, p2, err = tquant.refit_to_2x8(torch.Generator().manual_seed(0), torch.from_numpy(w),
                                        codes_1x16=torch.from_numpy(codes16))
    assert err <= 1e-3 and tquant.quantization_error(cfg2, p2, torch.from_numpy(w)) == err
    jcfg2, jp2, jerr = jquant.refit_to_2x8(jax.random.PRNGKey(0), jnp.asarray(w),
                                           codes_1x16=jnp.asarray(codes16))
    assert jerr <= 1e-3 and dataclasses.asdict(jcfg2) == dataclasses.asdict(cfg2)
    layer, cfg = tck.load_aqlm_linear(tensors, "proj", one_x16="refit", device="cpu")
    assert isinstance(layer, tlin.QuantizedLinear) and cfg.n_cluster == 256
    x = np.random.RandomState(5).randn(2, 32).astype(np.float32)
    y = layer.apply(cfg, torch.from_numpy(x), strategy="lut_gemv", variant="f32").numpy()
    assert rel_err(y, x @ w.T) <= 1e-3


def test_unknown_one_x16_mode_raises():
    tensors, _ = synth_aqlm_tensors("p", 16, 8, 8, 1, 65536, np.random.RandomState(0), np.int16)
    with pytest.raises(ValueError, match="one_x16"):
        tck.load_aqlm_linear(tensors, "p", one_x16="fast", device="cpu")


# ---- safetensors ------------------------------------------------------------------


def sample_tensors():
    rng = np.random.default_rng(0)
    return {
        "f16": rng.standard_normal((3, 4)).astype(np.float16),
        "bf16": rng.standard_normal(5).astype(ml_dtypes.bfloat16),
        "f32": rng.standard_normal((2, 2, 3)).astype(np.float32),
        "i8": rng.integers(-128, 128, 7).astype(np.int8),
        "i16": rng.integers(-2**15, 2**15, (2, 3)).astype(np.int16),
        "u8": rng.integers(0, 256, 9).astype(np.uint8),
        "i32": rng.integers(-2**31, 2**31, 4).astype(np.int32),
        "scalar": np.array(2.5, np.float32),
    }


@pytest.mark.parametrize("writer", ["port", "safetensors"])
def test_safetensors_roundtrip_across_implementations(tmp_path, writer):
    arrays = sample_tensors()
    path = str(tmp_path / "t.safetensors")
    meta = {"lutvq": json.dumps({"a": [1, 2]}), "format": "pt"}
    if writer == "port":
        safetensors_io.save_file({k: torch.from_numpy(np.array(v).view(np.int16)).view(
            torch.bfloat16) if k == "bf16" else torch.from_numpy(np.array(v))
            for k, v in arrays.items()}, path, metadata=meta)
        back = {k: np.asarray(v) for k, v in st_load(path).items()}
        from safetensors import safe_open

        with safe_open(path, framework="np") as f:
            assert f.metadata() == meta
    else:
        st_save(arrays, path, metadata=meta)
        loaded = safetensors_io.load_file(path)
        back = {k: v.view(torch.int16).numpy().view(ml_dtypes.bfloat16) if k == "bf16"
                else v.numpy() for k, v in loaded.items()}
        assert safetensors_io.metadata(path) == meta
    assert sorted(back) == sorted(arrays)
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert np.array_equal(back[k].reshape(-1).view(np.uint8),
                              np.asarray(v).reshape(-1).view(np.uint8)), k


def test_open_checkpoint_sharded_directory(tmp_path):
    tensors = tiny_hf_tensors(3)
    names = sorted(tensors)
    shards = {"model-00001-of-00002.safetensors": names[::2],
              "model-00002-of-00002.safetensors": names[1::2]}
    for shard, ns in shards.items():
        safetensors_io.save_file({n: torch.from_numpy(tensors[n]) for n in ns},
                                 str(tmp_path / shard))
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {n: s for s, ns in shards.items() for n in ns}}, f)
    got = tck.open_checkpoint(str(tmp_path))
    assert sorted(got) == names
    for n in names:
        assert np.array_equal(got[n].numpy(), tensors[n]), n
    assert np.array_equal(jck.open_checkpoint(str(tmp_path))["lm_head.weight"],
                          tensors["lm_head.weight"])
    with pytest.raises(FileNotFoundError, match="safetensors"):
        tck.open_checkpoint(str(tmp_path / "missing"))


# ---- whole models -----------------------------------------------------------------


def port_leaves(w):
    """The port's LlamaWeights as a flat list of tensors and pack metadata."""
    out = [w.embed, w.final_norm, w.lm_head.w]
    for lw in w.layers:
        out += [lw.attn_norm, lw.mlp_norm]
        for field in tck.PROJ_NAMES:
            p = getattr(lw, field).packed
            out += [p.codes_t, p.codebook, p.scales, p.zero_points,
                    (p.d_out, p.shards, p.nibbles, p.out_group)]
    return out


def test_load_aqlm_llama_matches_jax(tmp_path):
    """One HF checkpoint on disk, loaded by both packages: logits within
    test_torch_model's limit, greedy tokens equal."""
    tensors = tiny_hf_tensors(3)
    path = str(tmp_path / "model.safetensors")
    st_save(tensors, path)
    jcfg, tcfg = jl.LlamaConfig.tiny(**TINY), tl.LlamaConfig.tiny(**TINY)
    jw = jck.load_aqlm_llama(path, jcfg)
    tw = tck.load_aqlm_llama(path, tcfg, device="cpu")
    tokens = [[1, 2, 3, 9, 4]]
    want, _ = jl.llama_forward(jcfg, jw, jnp.asarray(tokens), jl.init_caches(jcfg, 1),
                               jnp.int32(0), strategy="dequant_mm", interpret=True)
    got, _ = tl.llama_forward(tcfg, tw, torch.tensor(tokens), tl.init_caches(tcfg, 1, device="cpu"),
                              0, strategy="dequant_mm")
    assert rel_err(got.numpy(), np.asarray(want)) <= LOGITS_TOL
    want = jg.generate(jcfg, jw, jnp.asarray(tokens, jnp.int32), max_new_tokens=5,
                       strategy="dequant_mm", interpret=True)
    got = tg.generate(tcfg, tw, torch.tensor(tokens), max_new_tokens=5, strategy="dequant_mm")
    assert np.array_equal(got.tokens.numpy(), np.asarray(want.tokens))


def test_native_format_crosses_packages(tmp_path):
    """JAX ``save_lutvq`` → port ``load_lutvq`` equals ``llama_from_numpy``
    of the same weights bit for bit; port ``save_lutvq`` → JAX
    ``load_lutvq`` gives the same config and bit-equal leaves."""
    jcfg = jl.LlamaConfig.tiny(**dict(TINY, n_layers=2))
    jw = jl.init_llama(jax.random.PRNGKey(0), jcfg)
    jpath, tpath = str(tmp_path / "j.lutvq.safetensors"), str(tmp_path / "t.lutvq.safetensors")
    jck.save_lutvq(jpath, jcfg, jw)
    tcfg, tw = tck.load_lutvq(jpath, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want = llama_from_numpy(tcfg, jax.tree.map(np.asarray, jw), device="cpu")
    for a, b in zip(port_leaves(tw), port_leaves(want), strict=True):
        assert type(a) is type(b)
        assert a == b if not isinstance(a, torch.Tensor) else (
            a.dtype == b.dtype and torch.equal(a, b))
    tck.save_lutvq(tpath, tcfg, tw)
    jcfg2, jw2 = jck.load_lutvq(tpath)
    assert jcfg2 == jcfg
    for a, b in zip(jax.tree.leaves(jw2), jax.tree.leaves(jw), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and the port's own round trip decodes identically
    tcfg2, tw2 = tck.load_lutvq(tpath, device="cpu")
    toks = torch.tensor([[1, 2, 3]])
    l1, _ = tl.llama_forward(tcfg, tw, toks, tl.init_caches(tcfg, 1, device="cpu"), 0)
    l2, _ = tl.llama_forward(tcfg2, tw2, toks, tl.init_caches(tcfg2, 1, device="cpu"), 0)
    assert torch.equal(l1, l2)
    os.remove(tpath)
