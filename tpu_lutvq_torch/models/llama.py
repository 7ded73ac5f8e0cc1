"""Llama-2 decoder with AQLM-quantized projections (counterpart of
``tpu_lutvq.models.llama``, per-layer tuple caches, slab or paged).

RMSNorm, RoPE, GQA attention over the INT8 KV cache and a SwiGLU MLP, with
every projection a ``QuantizedLinear``.  Attention runs the flash kernels
(``attn="flash"``), the einsum form of the JAX package's ``attn="xla"``
path (bf16 operands, f32 accumulation, computed as f32 products of
bf16-rounded values), or whichever ``resolve_attn`` picks (``"auto"``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from tpu_lutvq_torch.core.config import VQConfig, aqlm_2x8
from tpu_lutvq_torch.kernels.flash_decode import flash_decode_attention, flash_decode_paged
from tpu_lutvq_torch.kernels.flash_prefill import flash_prefill_attention
from tpu_lutvq_torch.models.attn_policy import resolve_attn
from tpu_lutvq_torch.models.kv_cache import KVCache, update_cache
from tpu_lutvq_torch.models.paged_cache import PagedKVCache
from tpu_lutvq_torch.models.linear import DenseLinear, QuantizedLinear, make_quantized_linear


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden: int = 4096
    ffn: int = 11008
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_seq: int = 2048
    group: int = 8  # AQLM group size (codes per d_subvec weights)
    shared_codebook: bool = True  # layer-wide codebooks, as AQLM checkpoints ship
    kv_dtype: str = "int8"  # "int8" | "bf16"
    kv_scale_dtype: str = "f32"  # "f32" | "bf16"
    # head_dim when it is not hidden // n_heads (the JAX package sets it for
    # a tensor-parallel shard's config); a field of both packages' native
    # checkpoint config
    head_dim_override: Optional[int] = None

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def vq_cfg(self, d_in: int) -> VQConfig:
        return aqlm_2x8(d_in, group=self.group, shared_codebook=self.shared_codebook)

    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test-scale config."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden", 128)
        kw.setdefault("ffn", 256)
        kw.setdefault("n_layers", 2)
        kw.setdefault("n_heads", 4)
        kw.setdefault("n_kv_heads", 2)
        kw.setdefault("max_seq", 64)
        return cls(**kw)


class LayerWeights(NamedTuple):
    attn_norm: torch.Tensor  # (hidden,)
    mlp_norm: torch.Tensor
    wq: QuantizedLinear
    wk: QuantizedLinear
    wv: QuantizedLinear
    wo: QuantizedLinear
    w_gate: QuantizedLinear
    w_up: QuantizedLinear
    w_down: QuantizedLinear


class LlamaWeights(NamedTuple):
    embed: torch.Tensor  # (vocab, hidden) bf16, kept dense
    layers: tuple[LayerWeights, ...]
    final_norm: torch.Tensor
    lm_head: DenseLinear


def init_llama(
    cfg: LlamaConfig, generator: torch.Generator, dtype=torch.float16
) -> LlamaWeights:
    """Random AQLM-quantized Llama on ``generator.device``."""
    device = generator.device
    h, f = cfg.hidden, cfg.ffn
    vq_h, vq_f = cfg.vq_cfg(h), cfg.vq_cfg(f)

    def ones():
        return torch.ones((h,), dtype=torch.float32, device=device)

    def qlin(vq, d_out):
        return make_quantized_linear(generator, vq, d_out, dtype)

    layers = tuple(
        LayerWeights(
            attn_norm=ones(),
            mlp_norm=ones(),
            wq=qlin(vq_h, cfg.q_dim),
            wk=qlin(vq_h, cfg.kv_dim),
            wv=qlin(vq_h, cfg.kv_dim),
            wo=qlin(vq_h, h),
            w_gate=qlin(vq_h, f),
            w_up=qlin(vq_h, f),
            w_down=qlin(vq_f, h),
        )
        for _ in range(cfg.n_layers)
    )
    emb_scale = 1.0 / math.sqrt(h)

    def dense():
        w = torch.randn((cfg.vocab_size, h), generator=generator, device=device)
        return (w * emb_scale).to(torch.bfloat16)

    return LlamaWeights(
        embed=dense(), layers=layers, final_norm=ones(), lm_head=DenseLinear(dense())
    )


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, Dh); pos: (B, T) absolute positions."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = pos[..., None].float() * freqs  # (B, T, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _bf16_f32(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and compute on in f32 (a bf16 operand, f32 accumulation)."""
    return t.to(torch.bfloat16).float()


def _attention_window(
    cfg: LlamaConfig,
    q: torch.Tensor,  # (B, T, H, Dh)
    cache: KVCache,
    t_offset: torch.Tensor,  # (B,)
    window: int,  # prefix of the cache to attend over
) -> torch.Tensor:
    """Einsum attention over the cache prefix, int8 scales folded into the
    score and probability matrices (``llama.py:166-221``)."""
    b, t, nh, dh = q.shape
    rep = cfg.n_heads // cfg.n_kv_heads
    pre = cache.slice_prefix(window)
    k, v = pre.k_q.float(), pre.v_q.float()  # int8 or bf16 values are exact in f32
    ks = vs = None
    if pre.k_q.dtype == torch.int8:
        ks, vs = pre.k_scale.float(), pre.v_scale.float()  # (B, H_kv, S)
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        if ks is not None:
            ks = ks.repeat_interleave(rep, dim=1)
            vs = vs.repeat_interleave(rep, dim=1)
    scores = torch.einsum("bthd,bhsd->bhts", _bf16_f32(q), k) / math.sqrt(dh)
    if ks is not None:
        scores = scores * ks[:, :, None, :]
    spos = torch.arange(window, device=q.device)[None, None, None, :]
    qpos = t_offset[:, None, None, None] + torch.arange(t, device=q.device)[None, None, :, None]
    scores = torch.where(spos <= qpos, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    if vs is not None:
        probs = probs * vs[:, :, None, :]
    out = torch.einsum("bhts,bhsd->bthd", _bf16_f32(probs), v)
    return out.reshape(b, t, nh * dh)


def _attention(
    cfg: LlamaConfig,
    q: torch.Tensor,  # (B, T, H, Dh)
    cache: KVCache,
    t_offset: torch.Tensor,  # (B,) int32: position of q[:, 0] per sequence
    window: Optional[int],
    attn: str,
    plain: bool,
) -> torch.Tensor:
    """Attention over a prefix ``window`` of the slab cache: flash decode
    (T=1) or flash prefill under ``attn="flash"``, the einsum path under
    ``"xla"``; ``"auto"`` resolves as the reference does (``llama.py:224-278``)."""
    b, t, nh, dh = q.shape
    if window is None:
        window = cache.max_seq
    attn = resolve_attn(attn, batch=b, window=window, t=t, paged=False, heads=cfg.n_heads)
    if attn == "flash":
        args = (cache.k_q, cache.v_q, cache.k_scale, cache.v_scale, t_offset)
        if t == 1:
            out = flash_decode_attention(q[:, 0], *args, window=window, plain=plain)
        else:
            out = flash_prefill_attention(q, *args, window=window, plain=plain)
        return out.reshape(b, t, nh * dh)
    if attn != "xla":
        raise ValueError(f"unknown attn {attn!r}")
    return _attention_window(cfg, q, cache, t_offset, window)


def _paged_attention(
    cfg: LlamaConfig,
    q: torch.Tensor,  # (B, 1, H, Dh)
    cache: PagedKVCache,
    pos: torch.Tensor,  # (B,) int32
    window: Optional[int],
    attn: str,
    plain: bool,
) -> torch.Tensor:
    """Decode attention over the pool: the paged flash kernel, or the
    einsum path over a gathered slab view (``llama.py:332-358``)."""
    b = q.shape[0]
    w = window if window is not None else cache.max_seq
    if resolve_attn(attn, batch=b, window=w, heads=cfg.n_heads, paged=True) == "flash":
        out = flash_decode_paged(
            q[:, 0], cache.k_pool, cache.v_pool, cache.k_scale, cache.v_scale,
            cache.block_tables, pos, window=w, plain=plain,
        )
        return out.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    view = cache.window_view(w)
    return _attention_window(cfg, q, view, pos, min(w, view.max_seq))


def _block(
    cfg: LlamaConfig,
    lw: LayerWeights,
    x: torch.Tensor,  # (B, T, hidden) f32
    cache,  # KVCache or PagedKVCache
    pos: torch.Tensor,  # (B,) int32 index of the first new token per sequence
    kw: dict,
    window: Optional[int],
    attn: str,
    cache_pos,  # pos as update_cache takes it (int for one shared position)
) -> tuple[torch.Tensor, object]:
    b, t, _ = x.shape
    vq_h, vq_f = cfg.vq_cfg(cfg.hidden), cfg.vq_cfg(cfg.ffn)
    vq_o = cfg.vq_cfg(cfg.q_dim)
    xn = rms_norm(x, lw.attn_norm, cfg.rms_eps)
    q = lw.wq.apply(vq_h, xn, **kw).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = lw.wk.apply(vq_h, xn, **kw).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = lw.wv.apply(vq_h, xn, **kw).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    tpos = pos[:, None] + torch.arange(t, device=x.device)[None, :]  # (B, T)
    q = rope(q, tpos, cfg.rope_theta)
    k = rope(k, tpos, cfg.rope_theta)
    if isinstance(cache, PagedKVCache):
        if t != 1:
            raise ValueError(
                "paged caches decode one token per step; prefill runs on a slab "
                "cache and is copied in with PagedKVCache.write_slot(s)"
            )
        cache = cache.append(k, v, pos)
        attn_out = _paged_attention(cfg, q, cache, pos, window, attn, kw["plain"])
    else:
        cache = update_cache(cache, k, v, cache_pos)
        attn_out = _attention(cfg, q, cache, pos, window, attn, kw["plain"])
    x = x + lw.wo.apply(vq_o, attn_out, **kw)
    xn = rms_norm(x, lw.mlp_norm, cfg.rms_eps)
    gate = lw.w_gate.apply(vq_h, xn, **kw)
    up = lw.w_up.apply(vq_h, xn, **kw)
    x = x + lw.w_down.apply(vq_f, F.silu(gate) * up, **kw)
    return x, cache


def llama_forward(
    cfg: LlamaConfig,
    weights: LlamaWeights,
    tokens: torch.Tensor,  # (B, T) integer ids
    caches: tuple,  # per-layer KVCache (slab) or PagedKVCache (pool)
    pos,  # int / 0-d tensor, or (B,) per-sequence positions
    *,
    strategy: str = "auto",
    window: Optional[int] = None,
    attn: str = "xla",
    variant: str = "auto",
    quality: str = "exact",
    logits_mode: str = "all",  # "all" | "last" | "index"
    logits_idx: Optional[torch.Tensor] = None,  # (B,), logits_mode="index"
    plain: bool = False,
) -> tuple[torch.Tensor, tuple]:
    """Forward pass over T new tokens at absolute position(s) ``pos``.

    Per-layer tuple caches (the JAX package's python-loop mode), slab
    ``KVCache`` or paged ``PagedKVCache`` (decode only, T=1); the caches are
    updated in place and returned.  ``window`` bounds the cache prefix
    attention reads; ``attn`` is "xla" (einsum), "flash" (the flash
    kernels) or "auto" (``resolve_attn``).  ``variant`` and ``quality``
    ("exact" | "fast", the serving precision budget: "fast" serves the
    ``dequant_mm`` projections with the W8A8 tables) go to every projection
    (``QuantizedLinear.apply``).  ``plain=True`` runs every kernel's plain
    version instead (a reference run on the card).

    Returns (logits (B, T', vocab) float32, caches), T' = T for
    ``logits_mode="all"`` and 1 otherwise.
    """
    if isinstance(caches, (KVCache, PagedKVCache)):
        raise NotImplementedError(
            "stacked (scan/hybrid) caches are not ported (ROADMAP Queue 1 item 8)"
        )
    b = tokens.shape[0]
    device = weights.embed.device
    if isinstance(pos, int) or torch.as_tensor(pos).ndim == 0:
        cache_pos = int(pos)
        pos_vec = torch.full((b,), cache_pos, dtype=torch.int32, device=device)
    else:
        pos_vec = cache_pos = pos.to(device=device, dtype=torch.int32)
    kw = dict(strategy=strategy, variant=variant, quality=quality, plain=plain)
    x = weights.embed[tokens.to(device).long()].float()
    new_caches = []
    for lw, cache in zip(weights.layers, caches):
        x, cache = _block(cfg, lw, x, cache, pos_vec, kw, window, attn, cache_pos)
        new_caches.append(cache)
    if logits_mode == "last":
        x = x[:, -1:]
    elif logits_mode == "index":
        idx = logits_idx.to(device=device, dtype=torch.long)
        x = x[torch.arange(b, device=device), idx][:, None]  # (B, 1, D)
    elif logits_mode != "all":
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    x = rms_norm(x, weights.final_norm, cfg.rms_eps)
    logits = weights.lm_head(x).float()
    return logits, tuple(new_caches)


def llama_decode_step(
    cfg: LlamaConfig,
    weights: LlamaWeights,
    tokens: torch.Tensor,  # (B,) one new token per sequence
    caches: tuple[KVCache, ...],
    pos,
    **kw,
) -> tuple[torch.Tensor, tuple[KVCache, ...]]:
    """Single decode step: (B,) tokens → (B, vocab) logits."""
    logits, caches = llama_forward(cfg, weights, tokens[:, None], caches, pos, **kw)
    return logits[:, 0], caches


def init_caches(cfg: LlamaConfig, batch: int, device="cuda") -> tuple[KVCache, ...]:
    dtype = torch.int8 if cfg.kv_dtype == "int8" else torch.bfloat16
    sdtype = torch.bfloat16 if cfg.kv_scale_dtype == "bf16" else torch.float32
    return tuple(
        KVCache.init(batch, cfg.max_seq, cfg.n_kv_heads, cfg.head_dim, dtype,
                     scale_dtype=sdtype, device=device)
        for _ in range(cfg.n_layers)
    )
