"""Llama-2 decoder with AQLM-quantized projections (counterpart of
``tpu_lutvq.models.llama``): per-layer tuple caches (slab or paged), and
the stacked container's hybrid and scan modes.

RMSNorm, RoPE, GQA attention over the INT8 KV cache and a SwiGLU MLP, with
every projection a ``QuantizedLinear``.  Attention runs the flash kernels
(``attn="flash"``), the einsum form of the JAX package's ``attn="xla"``
path (bf16 operands, f32 accumulation, computed as f32 products of
bf16-rounded values), or whichever ``resolve_attn`` picks (``"auto"``).

Profiler ranges (``tpu_lutvq_torch.tracing.span``, recorded only while a
profiler runs): ``lutvq.layer`` a decoder layer; inside it ``lutvq.norm``
each RMSNorm, ``lutvq.rope`` the rotary embedding of q and of k,
``lutvq.attn`` the cache write (``lutvq.kv_write``) and attention (slab,
paged or stacked), and each projection ``lutvq.proj`` (``models.linear``);
``lutvq.head`` the final norm and ``lm_head``.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from tpu_lutvq_torch.core.config import VQConfig, aqlm_2x8
from tpu_lutvq_torch.kernels.flash_decode import flash_decode_attention, flash_decode_paged
from tpu_lutvq_torch.kernels.flash_prefill import flash_prefill_attention
from tpu_lutvq_torch.models.attn_policy import resolve_attn
from tpu_lutvq_torch.models.kv_cache import (
    KVCache,
    layer_view,
    update_cache,
    update_cache_stacked,
)
from tpu_lutvq_torch.models.paged_cache import PagedKVCache
from tpu_lutvq_torch.models.linear import DenseLinear, QuantizedLinear, make_quantized_linear
from tpu_lutvq_torch.tracing import span


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
    def llama2_13b(cls, **kw) -> "LlamaConfig":
        return cls(hidden=5120, ffn=13824, n_layers=40, n_heads=40, n_kv_heads=40, **kw)

    @classmethod
    def llama2_70b(cls, **kw) -> "LlamaConfig":
        return cls(hidden=8192, ffn=28672, n_layers=80, n_heads=64, n_kv_heads=8, **kw)

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
    with span("lutvq.norm"):
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + eps)) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, Dh); pos: (B, T) absolute positions."""
    with span("lutvq.rope"):
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
    stacked=None,  # (stacked KVCache, layer index): read and write layer li in place
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
    with span("lutvq.attn"):
        if stacked is not None:
            caches_all, li = stacked
            with span("lutvq.kv_write"):
                update_cache_stacked(caches_all, li, k, v, cache_pos)
            s_max = caches_all.k_q.shape[3]
            w = min(window if window is not None else s_max, s_max)
            attn_r = resolve_attn(attn, batch=b, window=w, t=t, heads=cfg.n_heads, stacked=True)
            if t == 1 and attn_r == "flash":
                # decode reads the stacked planes at layer li in place (D's layer= mode)
                out = flash_decode_attention(
                    q[:, 0], caches_all.k_q, caches_all.v_q, caches_all.k_scale,
                    caches_all.v_scale, pos, window=w, layer=li, plain=kw["plain"],
                )
                attn_out = out.reshape(b, 1, cfg.n_heads * cfg.head_dim)
            else:  # the layer's view, read as the tuple path reads its cache
                attn_out = _attention(cfg, q, layer_view(caches_all, li), pos, window, attn_r,
                                      kw["plain"])
        elif isinstance(cache, PagedKVCache):
            if t != 1:
                raise ValueError(
                    "paged caches decode one token per step; prefill runs on a slab "
                    "cache and is copied in with PagedKVCache.write_slot(s)"
                )
            with span("lutvq.kv_write"):
                cache = cache.append(k, v, pos)
            attn_out = _paged_attention(cfg, q, cache, pos, window, attn, kw["plain"])
        else:
            with span("lutvq.kv_write"):
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
    caches,  # per-layer KVCache (slab) or PagedKVCache (pool), or one stacked KVCache
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

    Three modes, told apart by the containers as in the reference
    (``llama.py:496-538``):

    - per-layer tuple caches, slab ``KVCache`` or paged ``PagedKVCache``
      (decode only, T=1): the python loop;
    - one stacked ``KVCache`` (:func:`init_stacked_caches`) with per-layer
      weights: HYBRID, each layer's rows written into its slab of the
      stacked planes and decode attention (flash) reading them there,
      ``flash_decode_attention(layer=)``;
    - one stacked ``KVCache`` with stacked weights
      (:func:`stack_llama_weights`): SCAN, the same over per-layer views of
      the stacked weights, built once per weights and kept
      (:func:`layer_weights`).

    Stacked weights are told apart by the rank of ``attn_norm`` (``(L,
    hidden)``), not by ``len(layers)``: a 1-layer model has one entry too.
    The caches are updated in place and returned.  ``window`` bounds the cache
    prefix attention reads; ``attn`` is "xla" (einsum), "flash" (the flash
    kernels) or "auto" (``resolve_attn``).  ``variant`` and ``quality``
    ("exact" | "fast", the serving precision budget: "fast" serves the
    ``dequant_mm`` projections with the W8A8 tables) go to every projection
    (``QuantizedLinear.apply``).  ``plain=True`` runs every kernel's plain
    version instead (a reference run on the card).

    Returns (logits (B, T', vocab) float32, caches), T' = T for
    ``logits_mode="all"`` and 1 otherwise.
    """
    if isinstance(caches, PagedKVCache):
        raise ValueError("paged caches are per-layer: pass a tuple of PagedKVCache")
    layers = weights.layers
    if weights_stacked(weights):
        layers = layer_weights(layers[0])
    stacked = isinstance(caches, KVCache)
    if stacked and (caches.k_q.ndim != 5 or caches.k_q.shape[0] != len(layers)):
        raise ValueError(
            f"a stacked cache has leaves (L={len(layers)}, B, H_kv, S, Dh); got "
            f"{tuple(caches.k_q.shape)}"
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
    if stacked:
        for li, lw in enumerate(layers):
            with span("lutvq.layer"):
                x, _ = _block(cfg, lw, x, None, pos_vec, kw, window, attn, cache_pos,
                              stacked=(caches, li))
        new_caches = caches
    else:
        new_caches = []
        for lw, cache in zip(layers, caches):
            with span("lutvq.layer"):
                x, cache = _block(cfg, lw, x, cache, pos_vec, kw, window, attn, cache_pos)
            new_caches.append(cache)
        new_caches = tuple(new_caches)
    with span("lutvq.head"):
        if logits_mode == "last":
            x = x[:, -1:]
        elif logits_mode == "index":
            idx = logits_idx.to(device=device, dtype=torch.long)
            x = x[torch.arange(b, device=device), idx][:, None]  # (B, 1, D)
        elif logits_mode != "all":
            raise ValueError(f"unknown logits_mode {logits_mode!r}")
        x = rms_norm(x, weights.final_norm, cfg.rms_eps)
        logits = weights.lm_head(x).float()
    return logits, new_caches


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


def init_stacked_caches(cfg: LlamaConfig, batch: int, device="cuda") -> KVCache:
    """One ``KVCache`` with a leading layer axis, ``(L, B, H_kv, S, Dh)``
    (``llama.py:414-420``): the hybrid and scan modes' container."""
    dtype = torch.int8 if cfg.kv_dtype == "int8" else torch.bfloat16
    sdtype = torch.bfloat16 if cfg.kv_scale_dtype == "bf16" else torch.float32
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim)
    return KVCache(
        k_q=torch.zeros(shape, dtype=dtype, device=device),
        v_q=torch.zeros(shape, dtype=dtype, device=device),
        k_scale=torch.ones(shape[:4], dtype=sdtype, device=device),
        v_scale=torch.ones(shape[:4], dtype=sdtype, device=device),
    )


_PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _stack_projection(ps: list):
    p0 = ps[0]
    if isinstance(p0, DenseLinear):
        return DenseLinear(torch.stack([p.w for p in ps]))
    if not isinstance(p0, QuantizedLinear):
        raise ValueError(f"{type(p0).__name__} projections do not stack")
    pk = [p.packed for p in ps]
    aux = {(k.d_out, k.shards, k.nibbles, k.out_group) for k in pk}
    if len(aux) != 1:
        raise ValueError(f"layers' packs differ in (d_out, shards, nibbles, out_group): {aux}")

    def stack(name):
        leaves = [getattr(k, name) for k in pk]
        return None if leaves[0] is None else torch.stack(leaves)

    return QuantizedLinear(dataclasses.replace(
        pk[0], codes_t=stack("codes_t"), codebook=stack("codebook"), scales=stack("scales"),
        zero_points=stack("zero_points")))


def stack_llama_weights(weights: LlamaWeights) -> LlamaWeights:
    """Per-layer weights stacked on a leading axis (``llama.py:404-412``):
    ``layers`` becomes a 1-tuple whose leaves are ``(L, ...)``, the scan
    mode's weights.  The stacked tensors are copies; the per-layer views
    :func:`llama_forward` runs them through are made once
    (:func:`layer_weights`)."""
    ls = weights.layers
    stacked = LayerWeights(
        attn_norm=torch.stack([lw.attn_norm for lw in ls]),
        mlp_norm=torch.stack([lw.mlp_norm for lw in ls]),
        **{name: _stack_projection([getattr(lw, name) for lw in ls]) for name in _PROJECTIONS},
    )
    return weights._replace(layers=(stacked,))


def weights_stacked(weights: LlamaWeights) -> bool:
    """Whether ``weights`` are stacked (scan mode): one layer entry whose
    ``attn_norm`` is ``(L, hidden)``, as the reference tells them apart."""
    return len(weights.layers) == 1 and weights.layers[0].attn_norm.ndim == 2


# id(stacked attn_norm) → (weak reference to it, the layers' views)
_LAYER_VIEWS: dict = {}


def layer_weights(stacked: LayerWeights) -> tuple[LayerWeights, ...]:
    """The per-layer views of stacked weights, made once and kept while the
    stacked ``attn_norm`` lives: every step runs the same view objects, so
    the caches keyed on a codebook tensor (``kernels.dequant_mm.tables_i8``,
    ``codebook_bf16``) hit instead of re-quantizing each step.  The views
    are taken of detached tensors, so they do not keep the stacked weights
    alive on their own."""
    key = id(stacked.attn_norm)
    hit = _LAYER_VIEWS.get(key)
    if hit is not None and hit[0]() is stacked.attn_norm:
        return hit[1]

    def view(t, i):
        return None if t is None else t.detach()[i]

    def proj(p, i):
        if isinstance(p, DenseLinear):
            return DenseLinear(view(p.w, i))
        k = p.packed
        return QuantizedLinear(dataclasses.replace(
            k, codes_t=view(k.codes_t, i), codebook=view(k.codebook, i),
            scales=view(k.scales, i), zero_points=view(k.zero_points, i)))

    views = tuple(
        LayerWeights(attn_norm=view(stacked.attn_norm, i), mlp_norm=view(stacked.mlp_norm, i),
                     **{name: proj(getattr(stacked, name), i) for name in _PROJECTIONS})
        for i in range(stacked.attn_norm.shape[0])
    )
    ref = weakref.ref(stacked.attn_norm, lambda _, key=key: _LAYER_VIEWS.pop(key, None))
    _LAYER_VIEWS[key] = (ref, views)
    return views
