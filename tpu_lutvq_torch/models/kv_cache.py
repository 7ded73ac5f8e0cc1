"""INT8 KV cache (counterpart of ``tpu_lutvq.models.kv_cache``).

Layout ``(B, H_kv, S, Dh)``, per (token, head) symmetric int8 quantization
(or bf16 storage with unit scales).  Unlike the JAX package, whose arrays
are immutable, :func:`update_cache` writes the new rows into the cache's
tensors in place — a functional copy would move the whole cache every step —
and returns the same cache.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_lutvq_torch.core.params import div_scalar


class KVCache(NamedTuple):
    """One layer's cache.

    k_q / v_q:         (B, H_kv, S_max, Dh) int8 (quantized) or bf16 (direct)
    k_scale / v_scale: (B, H_kv, S_max) float32 (all ones in bf16 mode)
    """

    k_q: torch.Tensor
    v_q: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor

    @classmethod
    def init(
        cls, batch: int, max_seq: int, n_kv_heads: int, head_dim: int,
        dtype=torch.int8, scale_dtype=torch.float32, device="cuda",
    ) -> "KVCache":
        shape = (batch, n_kv_heads, max_seq, head_dim)
        return cls(
            k_q=torch.zeros(shape, dtype=dtype, device=device),
            v_q=torch.zeros(shape, dtype=dtype, device=device),
            k_scale=torch.ones(shape[:3], dtype=scale_dtype, device=device),
            v_scale=torch.ones(shape[:3], dtype=scale_dtype, device=device),
        )

    @property
    def max_seq(self) -> int:
        return self.k_q.shape[2]

    def slice_prefix(self, window: int) -> "KVCache":
        """Prefix view ``[0, window)`` of the sequence axis."""
        if window == self.max_seq:
            return self
        return KVCache(
            k_q=self.k_q[:, :, :window],
            v_q=self.v_q[:, :, :window],
            k_scale=self.k_scale[:, :, :window],
            v_scale=self.v_scale[:, :, :window],
        )


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., Dh) → int8 values + (...) f32 scales (symmetric, per row;
    ``torch.round`` rounds half to even, as ``jnp.round`` does)."""
    absmax = x.abs().amax(dim=-1)
    scale = div_scalar(absmax.clamp_min(1e-10), 127.0)
    q = torch.round(x / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.float()


def update_cache(
    cache: KVCache, k: torch.Tensor, v: torch.Tensor, pos
) -> KVCache:
    """Write T new tokens at ``pos`` (in place; returns ``cache``).

    ``k``/``v`` are ``(B, T, H, Dh)`` projection outputs; ``pos`` is an int or
    0-d tensor (one position for the batch) or a ``(B,)`` tensor (one per
    sequence).  Rows must fit: callers guard ``pos + T ≤ max_seq``.
    """
    b, t = k.shape[0], k.shape[1]
    if cache.k_q.dtype == torch.int8:
        k_q, k_s = quantize_kv(k)
        v_q, v_s = quantize_kv(v)
    else:  # direct storage (bf16 mode): unit scales
        k_q, v_q = k.to(cache.k_q.dtype), v.to(cache.v_q.dtype)
        k_s = torch.ones(k.shape[:-1], dtype=torch.float32, device=k.device)
        v_s = torch.ones(v.shape[:-1], dtype=torch.float32, device=v.device)
    k_s = k_s.to(cache.k_scale.dtype)
    v_s = v_s.to(cache.v_scale.dtype)
    pos = torch.as_tensor(pos, device=cache.k_q.device)
    if pos.ndim == 0:
        p = int(pos)
        if p + t > cache.max_seq:
            raise ValueError(f"rows [{p}, {p + t}) exceed max_seq={cache.max_seq}")
        # (B, T, H, ...) → (B, H, T, ...)
        cache.k_q[:, :, p : p + t] = k_q.transpose(1, 2)
        cache.v_q[:, :, p : p + t] = v_q.transpose(1, 2)
        cache.k_scale[:, :, p : p + t] = k_s.transpose(1, 2)
        cache.v_scale[:, :, p : p + t] = v_s.transpose(1, 2)
        return cache
    bi = torch.arange(b, device=pos.device)[:, None]  # (B, 1)
    si = pos.long()[:, None] + torch.arange(t, device=pos.device)[None, :]  # (B, T)
    # advanced indices around a slice put (B, T) first: values stay (B, T, H, ...)
    cache.k_q[bi, :, si] = k_q
    cache.v_q[bi, :, si] = v_q
    cache.k_scale[bi, :, si] = k_s
    cache.v_scale[bi, :, si] = v_s
    return cache


def write_cache_slots(big: KVCache, small: KVCache, slots) -> KVCache:
    """Admission: copy a B=k cache (one wave's prefills) into slots
    ``slots`` (k,) of a batched cache, in place.  Each slot is overwritten
    whole: rows past the small cache's length are zeroed, scales included,
    as the reference pads with zeros (``kv_cache.py:206-228``), not with the
    unit scales ``KVCache.init`` starts from."""
    slots = torch.as_tensor(slots, device=big.k_q.device).long()
    t = small.k_q.shape[2]
    if t > big.max_seq:
        raise ValueError(f"{t} rows do not fit max_seq={big.max_seq}")
    for dst, src in zip(big, small):
        dst[slots, :, :t] = src.to(dst.dtype)
        dst[slots, :, t:] = 0
    return big


def write_cache_slot(big: KVCache, small: KVCache, slot: int) -> KVCache:
    """Admission: copy a B=1 cache into slot ``slot`` (``kv_cache.py:257-272``)."""
    return write_cache_slots(big, small, [slot])
