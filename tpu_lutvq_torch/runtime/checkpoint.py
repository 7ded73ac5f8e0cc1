"""AQLM checkpoint loading and the native checkpoint format (counterpart of
``tpu_lutvq.runtime.checkpoint``).

AQLM's Hugging Face layout, per quantized linear:

    <prefix>.codes      int8/int16/int32, (out_features / out_group_size,
                        num_in_groups, N), stored two's-complement: the bits
                        are the unsigned code (int16 -1 is code 65535)
    <prefix>.codebooks  fp16, (N, K, out_group_size, in_group_size)
    <prefix>.scales     fp16, (out_features / out_group_size, 1, 1, 1)

mapped to ``VQConfig(d_in, M = d_in / in_group_size, N, K,
shared_codebook=True)``.  K ≤ 256 (2x8) loads as a ``QuantizedLinear``
served by the lookup and dequant kernels (``out_group_size > 1`` as an
out_group pack); wider codes (1x16) as ``one_x16`` says: ``"dequant"``, a
bf16 ``DenseLinear`` dequantized at load; ``"chunked"``, a
``ChunkedVQLinear`` at the checkpoint's footprint; ``"refit"``, re-fit to
2x8.  Files are read and written by the port's own safetensors code
(``utils.safetensors_io``).  Codes cross to the card once, and the
transpose and pack run there.

The native format (``save_lutvq``/``load_lutvq``) is the JAX package's:
one safetensors file of kernel-ready tensors named ``embed``,
``final_norm``, ``lm_head``, ``layer.<i>.<norm>`` and
``layer.<i>.<proj>.{codes_t,codebook,scales,zero_points,w}``, with the
structure as JSON under ``__metadata__["lutvq"]``; a file either package
writes loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import zlib
from typing import Union

import numpy as np
import torch

from tpu_lutvq_torch.core.config import VQConfig
from tpu_lutvq_torch.core.params import VQParams
from tpu_lutvq_torch.kernels.lut_gemv import PackedVQ, pack_params
from tpu_lutvq_torch.models.linear import ChunkedVQLinear, DenseLinear, QuantizedLinear
from tpu_lutvq_torch.models.llama import LayerWeights, LlamaConfig, LlamaWeights
from tpu_lutvq_torch.utils import safetensors_io

PROJ_NAMES = {
    "wq": "self_attn.q_proj",
    "wk": "self_attn.k_proj",
    "wv": "self_attn.v_proj",
    "wo": "self_attn.o_proj",
    "w_gate": "mlp.gate_proj",
    "w_up": "mlp.up_proj",
    "w_down": "mlp.down_proj",
}
ONE_X16_MODES = ("dequant", "chunked", "refit")
# a refit whose relative error passes this does not serve the checkpoint's quality
REFIT_WARN_ERR = 0.05

log = logging.getLogger(__name__)


def open_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """All tensors (on the host) of a safetensors file or a Hugging Face
    directory: sharded (``model.safetensors.index.json``) or one
    ``model.safetensors``."""
    if os.path.isfile(path):
        return safetensors_io.load_file(path)
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            weight_map = json.load(f)["weight_map"]
        tensors = {}
        for shard in sorted(set(weight_map.values())):
            tensors.update(safetensors_io.load_file(os.path.join(path, shard)))
        return tensors
    single = os.path.join(path, "model.safetensors")
    if os.path.exists(single):
        return safetensors_io.load_file(single)
    raise FileNotFoundError(f"no safetensors checkpoint at {path}")


def _tensor(a) -> torch.Tensor:
    """A checkpoint entry (torch tensor or numpy array) as a torch tensor."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def _unsigned_codes(codes: torch.Tensor) -> torch.Tensor:
    """Two's-complement bitcast to the unsigned code value: int8 as uint8,
    wider codes as int32/int64 values."""
    if codes.dtype == torch.int8:
        return codes.view(torch.uint8)
    if codes.dtype == torch.int16:
        return codes.int() & 0xFFFF
    if codes.dtype in (torch.int32, torch.uint8, torch.uint16, torch.uint32):
        return codes.long() & 0xFFFFFFFF
    raise ValueError(f"unexpected codes dtype {codes.dtype}")


def aqlm_layer_config(codes, codebooks) -> tuple[VQConfig, int, int]:
    """``(VQConfig, logical d_out, out_group_size)`` from the AQLM tensors'
    shapes: each code selects an ``(out_g, in_g)`` weight block."""
    n_cb, k, out_g, in_g = codebooks.shape
    code_rows, n_in_groups, n_cb2 = codes.shape
    if n_cb2 != n_cb:
        raise ValueError(f"codes have {n_cb2} codebooks, codebooks {n_cb}")
    cfg = VQConfig(d_in=n_in_groups * in_g, n_subvec=n_in_groups, n_codebook=n_cb,
                   n_cluster=k, shared_codebook=True)
    return cfg, code_rows * out_g, out_g


def _dequant(codes: torch.Tensor, cb: torch.Tensor, scales) -> np.ndarray:
    """The exact load-time dequant (AQLM's ``_dequantize_weight``): unsigned
    ``codes (rows, M, N)``, ``cb (out_g, N, K, g)``, per-row ``scales`` →
    ``(rows·out_g, M·g)`` f32, row ``o·out_g + r`` block row r of code row o."""
    from tpu_lutvq_torch.utils.native import dequant_additive

    c = codes.cpu().numpy().astype(np.int64)
    cbf = cb.cpu().float().numpy()
    sc = None if scales is None else scales.cpu().numpy()
    w_rows = [dequant_additive(c, cbf[r], sc) for r in range(cbf.shape[0])]
    if len(w_rows) == 1:
        return w_rows[0]
    return np.stack(w_rows, axis=1).reshape(-1, w_rows[0].shape[1])


def load_aqlm_linear(
    tensors: dict,
    prefix: str,
    dequant_threshold_k: int = 256,
    one_x16: str = "dequant",
    device="cuda",
) -> tuple[Union[QuantizedLinear, DenseLinear, ChunkedVQLinear], VQConfig]:
    """One projection → ``(layer, cfg)``: a ``QuantizedLinear`` for K ≤
    ``dequant_threshold_k``, else per ``one_x16`` (see the module doc; a
    refit returns its 2x8 cfg and logs its relative error).  ``tensors``
    holds torch tensors or numpy arrays in the AQLM layout."""
    if one_x16 not in ONE_X16_MODES:
        raise ValueError(f"unknown one_x16 mode {one_x16!r} ({'|'.join(ONE_X16_MODES)})")
    raw = _tensor(tensors[f"{prefix}.codes"])
    codebooks = _tensor(tensors[f"{prefix}.codebooks"])
    scales = tensors.get(f"{prefix}.scales")
    cfg, d_out, out_g = aqlm_layer_config(raw, codebooks)
    code_rows = d_out // out_g
    # (N, K, out_g, g) → (out_g, N, K, g): slice r = row r of each entry block
    cb = codebooks.permute(2, 0, 1, 3).contiguous()
    # AQLM scales are per code row (out group)
    sc = None if scales is None else _tensor(scales).reshape(code_rows).float()

    if cfg.n_cluster <= dequant_threshold_k:
        params = VQParams(codebook=cb.to(device), codes=_unsigned_codes(raw.to(device)),
                          scales=None if sc is None else sc.to(device))
        return QuantizedLinear(pack_params(cfg, params, out_group=out_g)), cfg

    codes = _unsigned_codes(raw)
    if one_x16 == "chunked":
        return ChunkedVQLinear(
            codes=codes.to(device=device, dtype=torch.uint16),
            codebooks=cb.to(device=device, dtype=torch.bfloat16),
            scales=None if sc is None else sc.repeat_interleave(out_g).to(device),
        ), cfg
    w = _dequant(codes, cb, sc)
    if one_x16 == "dequant":
        return DenseLinear(w=torch.from_numpy(w).to(device=device, dtype=torch.bfloat16)), cfg

    from tpu_lutvq_torch.core.quantize import refit_to_2x8

    # seeded from the prefix's CRC-32: the same fit in every process (the
    # JAX package seeds from Python's per-process string hash)
    gen = torch.Generator(device).manual_seed(zlib.crc32(prefix.encode()))
    codes16 = codes[..., 0].to(device) if cfg.n_codebook == 1 and out_g == 1 else None
    cfg2, params2, err = refit_to_2x8(gen, torch.from_numpy(w).to(device), codes_1x16=codes16,
                                      group=cfg.d_subvec)
    log.info("refit %s: K=%d -> 2x8, rel err %.4f", prefix, cfg.n_cluster, err)
    if err > REFIT_WARN_ERR:
        log.warning("refit %s rel err %.3f > %.0f%%: this codebook is not additively "
                    "decomposable, and the 2x8 layer does not serve the 1x16 checkpoint's "
                    "quality (one_x16='dequant' is exact)", prefix, err, 100 * REFIT_WARN_ERR)
    return QuantizedLinear(pack_params(cfg2, params2)), cfg2


def load_aqlm_llama(
    path_or_tensors: Union[str, os.PathLike, dict],
    cfg: LlamaConfig,
    dequant_threshold_k: int = 256,
    one_x16: str = "dequant",
    device="cuda",
) -> LlamaWeights:
    """A Llama in the AQLM Hugging Face layout (a path, or its tensors) →
    ``LlamaWeights`` on ``device``: norms f32, embedding and lm_head bf16."""
    tensors = path_or_tensors
    if isinstance(path_or_tensors, (str, os.PathLike)):
        tensors = open_checkpoint(os.fspath(path_or_tensors))

    def get(name, dtype):
        return _tensor(tensors[name]).to(device=device, dtype=dtype)

    layers = []
    for i in range(cfg.n_layers):
        base = f"model.layers.{i}"
        fields = {
            field: load_aqlm_linear(tensors, f"{base}.{proj}", dequant_threshold_k,
                                    one_x16=one_x16, device=device)[0]
            for field, proj in PROJ_NAMES.items()
        }
        layers.append(LayerWeights(
            attn_norm=get(f"{base}.input_layernorm.weight", torch.float32),
            mlp_norm=get(f"{base}.post_attention_layernorm.weight", torch.float32),
            **fields,
        ))
    return LlamaWeights(
        embed=get("model.embed_tokens.weight", torch.bfloat16),
        layers=tuple(layers),
        final_norm=get("model.norm.weight", torch.float32),
        lm_head=DenseLinear(w=get("lm_head.weight", torch.bfloat16)),
    )


def save_lutvq(path: str, cfg: LlamaConfig, weights: LlamaWeights) -> None:
    """Write the model in the native (kernel-ready) format."""
    tensors: dict[str, torch.Tensor] = {
        "embed": weights.embed, "final_norm": weights.final_norm,
        "lm_head": weights.lm_head.w,
    }
    meta: dict = {"config": dataclasses.asdict(cfg),
                  "n_layer_entries": len(weights.layers), "layers": []}
    for i, lw in enumerate(weights.layers):
        lmeta: dict = {}
        tensors[f"layer.{i}.attn_norm"] = lw.attn_norm
        tensors[f"layer.{i}.mlp_norm"] = lw.mlp_norm
        for field in PROJ_NAMES:
            proj, base = getattr(lw, field), f"layer.{i}.{field}"
            if isinstance(proj, DenseLinear):
                lmeta[field] = {"kind": "dense"}
                tensors[f"{base}.w"] = proj.w
                continue
            if not isinstance(proj, QuantizedLinear):
                raise ValueError(f"{base}: {type(proj).__name__} has no native form")
            p = proj.packed
            lmeta[field] = {
                "kind": "vq", "d_out": p.d_out, "shards": p.shards, "nibbles": p.nibbles,
                "out_group": p.out_group, "has_scales": p.scales is not None,
                "has_zp": p.zero_points is not None,
            }
            tensors[f"{base}.codes_t"] = p.codes_t
            tensors[f"{base}.codebook"] = p.codebook
            if p.scales is not None:
                tensors[f"{base}.scales"] = p.scales
            if p.zero_points is not None:
                tensors[f"{base}.zero_points"] = p.zero_points
        meta["layers"].append(lmeta)
    safetensors_io.save_file(tensors, path, metadata={"lutvq": json.dumps(meta)})


def load_lutvq(path: str, device="cuda") -> tuple[LlamaConfig, LlamaWeights]:
    """Read a native checkpoint (either package's) → ``(cfg, weights)``."""
    meta = json.loads(safetensors_io.metadata(path)["lutvq"])
    host = safetensors_io.load_file(path)
    cfg = LlamaConfig(**meta["config"])
    if meta["n_layer_entries"] != cfg.n_layers:
        raise NotImplementedError("stacked (scan) weights are not ported")

    def get(name):
        return host[name].to(device)

    layers = []
    for i, lmeta in enumerate(meta["layers"]):
        fields = {}
        for field in PROJ_NAMES:
            base, fm = f"layer.{i}.{field}", lmeta[field]
            if fm["kind"] == "dense":
                fields[field] = DenseLinear(w=get(f"{base}.w"))
                continue
            fields[field] = QuantizedLinear(PackedVQ(
                codes_t=get(f"{base}.codes_t"),
                codebook=get(f"{base}.codebook"),
                scales=get(f"{base}.scales") if fm["has_scales"] else None,
                d_out=fm["d_out"],
                shards=fm["shards"],
                nibbles=fm["nibbles"],
                out_group=fm.get("out_group", 1),
                zero_points=get(f"{base}.zero_points") if fm.get("has_zp") else None,
            ))
        layers.append(LayerWeights(attn_norm=get(f"layer.{i}.attn_norm"),
                                   mlp_norm=get(f"layer.{i}.mlp_norm"), **fields))
    return cfg, LlamaWeights(embed=get("embed"), layers=tuple(layers),
                             final_norm=get("final_norm"), lm_head=DenseLinear(w=get("lm_head")))
