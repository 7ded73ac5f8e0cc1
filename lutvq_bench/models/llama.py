"""Llama-architecture decoders (Mistral, Yi, Llama): AQLM-2x8 weights made
from the seed, and the program's model built from them.

The weights are the benchmark's inputs: ``raw_weights`` makes them on the
card from the seed in a few large calls, in the types a checkpoint ships
(uint8 codes, fp16 codebooks and scales, bf16 embedding and head, f32
norms), and yields them one projection type at a time so that set-up holds
one type's raw codes at once.  The program gets them through its public
packing call; the reference gets the same tensors made again from the seed.

Their distribution keeps a random model well conditioned and the
comparison sharp.  Each codebook is centred (its entries' mean taken out),
so no part of a projection is common to all its rows: a shared codebook
with a mean gives every row the same vector over each group, a rank-one
part that maps a residual stream's mean across channels onto itself with
a gain that grows with the number of groups; at Yi-34B's width it takes
over the residual stream within a few layers.  Each layer adds about
``1/sqrt(2L)`` of the residual stream's scale, attention scores have a
standard deviation of about 1.5
(soft, not argmax), logits about 2, and each RMSNorm weight has
``ceil(hidden/1024)`` outlier channels of 24, as trained models have
(LLM.int8, SmoothQuant): a precision that quantizes activations per token
loses on them, as it does on a trained model.
"""

from __future__ import annotations

import math

import torch

from lutvq_bench.core.traffic import seed_key

PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
OUTLIER_GAIN = 24.0
SCORE_STD = 1.5
LOGIT_STD = 2.0
ATTN_OUT_STD = 0.3  # expected attention output scale before wo (soft attention)
SWIGLU_STD = 0.6  # silu(g) * u for g, u ~ N(0, 1)


def arch(cfg: dict) -> dict:
    """The numbers the model needs, from a configuration file's published
    keys (Hugging Face ``config.json`` names) and its serving group."""
    if cfg.get("hidden_act", "silu") != "silu" or cfg.get("attention_bias", False):
        raise ValueError("the Llama path serves SiLU MLPs without attention bias")
    if cfg.get("sliding_window") is not None or cfg.get("rope_scaling") is not None:
        raise ValueError("the Llama path has no sliding window and no RoPE scaling")
    if cfg.get("tie_word_embeddings", False):
        raise ValueError("the Llama path keeps an untied head")
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    head_dim = cfg.get("head_dim") or h // heads
    if head_dim * heads != h:
        raise ValueError("the Llama path needs hidden_size = heads * head_dim")
    serving = cfg["serving"]
    w = serving["weights"]
    if (w["format"], w["codebooks"], w["code_bits"], w["group"], w["codebook_bytes"],
            w["scale_bytes"]) != ("aqlm", 2, 8, 8, 2, 2):
        raise ValueError("the weights are AQLM 2x8 over groups of 8 with fp16 codebooks and scales")
    if serving["kv"] != {"dtype": "int8", "scale": "float32"}:
        raise ValueError("the KV cache is int8 with float32 scales")
    return {
        "vocab": cfg["vocab_size"], "hidden": h, "ffn": cfg["intermediate_size"],
        "layers": cfg["num_hidden_layers"], "heads": heads,
        "kv_heads": cfg["num_key_value_heads"], "head_dim": head_dim,
        "rope_theta": float(cfg["rope_theta"]), "eps": float(cfg["rms_norm_eps"]),
        "max_seq": serving["max_seq"], "weights": w, "kv_bytes": {"value": 1, "scale": 4},
    }


def shapes(a: dict) -> dict:
    """(d_in, d_out) of each projection."""
    h, f, q, kv = a["hidden"], a["ffn"], a["heads"] * a["head_dim"], a["kv_heads"] * a["head_dim"]
    return {"wq": (h, q), "wk": (h, kv), "wv": (h, kv), "wo": (q, h),
            "w_gate": (h, f), "w_up": (h, f), "w_down": (f, h)}


def _outliers(a: dict) -> int:
    return -(-a["hidden"] // 1024)


def _fan_power(a: dict) -> float:
    """Σ w² of a normed input's weights: the variance a unit-RMS input
    carries into a projection fed by an RMSNorm."""
    k = _outliers(a)
    return (a["hidden"] - k) * 1.01 + k * OUTLIER_GAIN**2


def _base_scale(a: dict, name: str) -> float:
    """The scale of a projection's weights (its codes' sum is unit variance)."""
    d_in, _ = shapes(a)[name]
    two_l = 2 * a["layers"]
    return {
        "wq": math.sqrt(SCORE_STD) / math.sqrt(_fan_power(a)),
        "wk": math.sqrt(SCORE_STD) / math.sqrt(_fan_power(a)),
        "wv": 1 / math.sqrt(_fan_power(a)),
        "wo": 1 / (ATTN_OUT_STD * math.sqrt(two_l * d_in)),
        "w_gate": 1 / math.sqrt(_fan_power(a)),
        "w_up": 1 / math.sqrt(_fan_power(a)),
        "w_down": 1 / (SWIGLU_STD * math.sqrt(two_l * d_in)),
    }[name]


def raw_weights(a: dict, seed: int, device):
    """Yield the weights, made from ``seed`` on ``device`` in this order:
    ``("codebooks", (L, 7, N, K, g) fp16)``, ``("norms", (L, 2, hidden)
    f32)``, one ``(name, (codes (L, d_out, d_in/g, N) uint8, scales (L,
    d_out) fp16))`` a projection, ``("final_norm", (hidden,) f32)``,
    ``("embed", (vocab, hidden) bf16)``, ``("head", (vocab, hidden) bf16)``."""
    g = torch.Generator(device=device).manual_seed(seed_key(seed))
    w = a["weights"]
    L, h, n_cb, k, grp = a["layers"], a["hidden"], w["codebooks"], 2 ** w["code_bits"], w["group"]
    cb = torch.randn((L, len(PROJECTIONS), n_cb, k, grp), generator=g, device=device)
    cb -= cb.mean(dim=3, keepdim=True)
    yield "codebooks", (cb / math.sqrt(n_cb)).to(torch.float16)
    del cb
    norms = 1 + 0.1 * torch.randn((L, 2, h), generator=g, device=device)
    idx = torch.randint(0, h, (L, 2, _outliers(a)), generator=g, device=device)
    norms.scatter_(2, idx, OUTLIER_GAIN)
    yield "norms", norms
    for name, (d_in, d_out) in shapes(a).items():
        codes = torch.empty((L, d_out, d_in // grp, n_cb), dtype=torch.uint8, device=device)
        codes.random_(0, k, generator=g)
        noise = torch.randn((L, d_out), generator=g, device=device)
        scales = ((1 + 0.1 * noise) * _base_scale(a, name)).to(torch.float16)
        yield name, (codes, scales)
        del codes, scales, noise
    yield "final_norm", 1 + 0.1 * torch.randn((h,), generator=g, device=device)
    emb = torch.randn((a["vocab"], h), generator=g, device=device)
    yield "embed", emb.to(torch.bfloat16)
    del emb
    head = torch.randn((a["vocab"], h), generator=g, device=device) * (LOGIT_STD / math.sqrt(h))
    yield "head", head.to(torch.bfloat16)


def build_program(a: dict, seed: int, device):
    """The program's model from the seeded weights: its ``LlamaConfig`` and
    ``LlamaWeights``, every projection packed by the program's own
    ``pack_params``."""
    from tpu_lutvq_torch.core.config import aqlm_2x8
    from tpu_lutvq_torch.core.params import VQParams
    from tpu_lutvq_torch.kernels.lut_gemv import pack_params
    from tpu_lutvq_torch.models.linear import DenseLinear, QuantizedLinear
    from tpu_lutvq_torch.models.llama import LayerWeights, LlamaConfig, LlamaWeights

    cfg = LlamaConfig(
        vocab_size=a["vocab"], hidden=a["hidden"], ffn=a["ffn"], n_layers=a["layers"],
        n_heads=a["heads"], n_kv_heads=a["kv_heads"], rope_theta=a["rope_theta"],
        rms_eps=a["eps"], max_seq=a["max_seq"], group=a["weights"]["group"],
        shared_codebook=True, kv_dtype="int8", kv_scale_dtype="f32",
        head_dim_override=None if a["head_dim"] * a["heads"] == a["hidden"] else a["head_dim"],
    )
    parts = {}
    projs = {}
    for name, value in raw_weights(a, seed, device):
        if name not in PROJECTIONS:
            parts[name] = value
            continue
        codes, scales = value
        pi = PROJECTIONS.index(name)
        vq = aqlm_2x8(shapes(a)[name][0], group=a["weights"]["group"], shared_codebook=True)
        projs[name] = [
            QuantizedLinear(pack_params(vq, VQParams(parts["codebooks"][li, pi][None].clone(),
                                                     codes[li], scales[li])))
            for li in range(a["layers"])
        ]
        del codes, scales, value
    norms = parts["norms"]
    layers = tuple(
        LayerWeights(attn_norm=norms[li, 0].clone(), mlp_norm=norms[li, 1].clone(),
                     **{n: projs[n][li] for n in PROJECTIONS})
        for li in range(a["layers"])
    )
    weights = LlamaWeights(embed=parts["embed"], layers=layers, final_norm=parts["final_norm"],
                           lm_head=DenseLinear(parts["head"]))
    return cfg, weights
