"""Paged INT8 KV cache: a pool of fixed-size blocks per layer and per-slot
block tables (counterpart of ``tpu_lutvq.models.paged_cache``).

- pool ``(n_blocks, H_kv, BS, Dh)`` int8 (or bf16) with ``(n_blocks, H_kv,
  BS)`` f32 scale planes: memory scales with the tokens in flight, not with
  slots × max_seq;
- block tables ``(n_slots, max_blocks)`` int32, set on the host by the
  batcher's :class:`BlockAllocator`; block 0 is the junk block.

The same quantization as the slab cache.  Unlike the JAX package, the
writes go into the pool and table tensors in place (as the port's
``update_cache`` does) and return the same cache.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_lutvq_torch.models.kv_cache import KVCache, quantize_kv

DEFAULT_BLOCK = 128  # tokens per block


class PagedKVCache(NamedTuple):
    """One layer's paged cache.

    k_pool / v_pool:   (n_blocks, H_kv, BS, Dh) int8 (or bf16)
    k_scale / v_scale: (n_blocks, H_kv, BS) f32
    block_tables:      (n_slots, max_blocks) int32 pool-block ids
    """

    k_pool: torch.Tensor
    v_pool: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    block_tables: torch.Tensor

    @property
    def block_size(self) -> int:
        return self.k_pool.shape[2]

    @property
    def max_blocks(self) -> int:
        return self.block_tables.shape[1]

    @property
    def max_seq(self) -> int:  # interface parity with KVCache
        return self.max_blocks * self.block_size

    @classmethod
    def init(
        cls,
        n_blocks: int,
        n_slots: int,
        max_blocks: int,
        n_kv_heads: int,
        head_dim: int,
        block_size: int = DEFAULT_BLOCK,
        dtype=torch.int8,
        device="cuda",
    ) -> "PagedKVCache":
        shape = (n_blocks, n_kv_heads, block_size, head_dim)
        return cls(
            k_pool=torch.zeros(shape, dtype=dtype, device=device),
            v_pool=torch.zeros(shape, dtype=dtype, device=device),
            k_scale=torch.ones(shape[:3], dtype=torch.float32, device=device),
            v_scale=torch.ones(shape[:3], dtype=torch.float32, device=device),
            block_tables=torch.zeros((n_slots, max_blocks), dtype=torch.int32, device=device),
        )

    def _put(self, blk: torch.Tensor, off: torch.Tensor, k_q, v_q, k_s, v_s) -> None:
        """Write rows (R, H, Dh) / (R, H) at pool block ``blk`` (R,), offset
        ``off`` (R,)."""
        bi, oi = blk.long()[:, None], off.long()[:, None]
        hi = torch.arange(self.k_pool.shape[1], device=blk.device)[None, :]
        self.k_pool[bi, hi, oi] = k_q.to(self.k_pool.dtype)
        self.v_pool[bi, hi, oi] = v_q.to(self.v_pool.dtype)
        self.k_scale[bi, hi, oi] = k_s.to(self.k_scale.dtype)
        self.v_scale[bi, hi, oi] = v_s.to(self.v_scale.dtype)

    # --- writes (in place) ---

    def append(self, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor) -> "PagedKVCache":
        """Insert one new token per slot: k/v (B, 1, H, Dh), pos (B,), at
        block ``block_tables[b, pos_b // BS]``, offset ``pos_b % BS``."""
        k, v = k[:, 0].float(), v[:, 0].float()  # (B, H, Dh)
        if self.k_pool.dtype == torch.int8:
            k_q, k_s = quantize_kv(k)
            v_q, v_s = quantize_kv(v)
        else:
            k_q, v_q = k, v
            k_s = torch.ones(k.shape[:-1], dtype=torch.float32, device=k.device)
            v_s = torch.ones(v.shape[:-1], dtype=torch.float32, device=v.device)
        pos = pos.to(device=k.device, dtype=torch.long)
        bs = self.block_size
        blk = self.block_tables.gather(1, (pos // bs)[:, None])[:, 0]
        self._put(blk, pos % bs, k_q, v_q, k_s, v_s)
        return self

    def write_slot(self, small: KVCache, slot: int, t: int) -> "PagedKVCache":
        """Admission: copy the first ``t`` rows of a B=1 slab cache into slot
        ``slot``'s blocks."""
        return self.write_slots(small, torch.tensor([slot]), t)

    def write_slots(self, small: KVCache, slots, t: int, t0s=None) -> "PagedKVCache":
        """Admission wave: copy the first ``t`` rows of a B=k slab cache into
        slots ``slots`` (k,).  With ``t0s`` (k,), rows at or past a request's
        own length ``t0s[j]`` (pads to the shared bucket ``t``) go to the
        junk block 0, so they can never land in a neighbour's blocks
        (``paged_cache.py:163-170``)."""
        device = self.block_tables.device
        slots = torch.as_tensor(slots, device=device).long()
        k = slots.shape[0]
        bs = self.block_size
        rows = torch.arange(t, device=device)
        blk = self.block_tables[slots][:, rows // bs]  # (k, t)
        if t0s is not None:
            valid = rows[None, :] < torch.as_tensor(t0s, device=device)[:, None]
            blk = torch.where(valid, blk, torch.zeros_like(blk))
        off = (rows % bs).repeat(k)  # (k*t,)
        h = self.k_pool.shape[1]

        def rows_of(src):  # (k, H, S[, Dh]) → (k*t, H[, Dh])
            x = src[:, :, :t].transpose(1, 2)
            return x.reshape((k * t, h) + tuple(src.shape[3:]))

        self._put(blk.reshape(-1), off, rows_of(small.k_q), rows_of(small.v_q),
                  rows_of(small.k_scale), rows_of(small.v_scale))
        return self

    def set_table(self, slot: int, blocks) -> "PagedKVCache":
        """Assign pool blocks to a slot; the rest of its row points at 0."""
        blocks = torch.as_tensor(blocks, dtype=torch.int32)
        row = torch.zeros((self.max_blocks,), dtype=torch.int32)
        row[: blocks.shape[0]] = blocks
        self.block_tables[slot] = row.to(self.block_tables.device)
        return self

    # --- reads ---

    def window_view(self, window: int) -> KVCache:
        """Gather each slot's first ``ceil(window/BS)`` blocks into a slab
        ``KVCache`` ``(B, H, W, Dh)`` (a copy; the einsum attention path)."""
        bs = self.block_size
        nblk = min(-(-window // bs), self.max_blocks)
        tbl = self.block_tables[:, :nblk].long()  # (B, nblk)
        b = tbl.shape[0]

        def gather(pool):
            x = pool[tbl].movedim(2, 1)  # (B, H, nblk, BS, ...)
            return x.reshape((b, pool.shape[1], nblk * bs) + tuple(pool.shape[3:]))

        return KVCache(
            k_q=gather(self.k_pool),
            v_q=gather(self.v_pool),
            k_scale=gather(self.k_scale),
            v_scale=gather(self.v_scale),
        )


class BlockAllocator:
    """Host-side free list over the pool.  Block 0 is reserved as the junk
    block (inactive slots' tables point at it)."""

    def __init__(self, n_blocks: int):
        self.free = list(range(n_blocks - 1, 0, -1))

    def alloc(self, n: int) -> list[int]:
        if n > len(self.free):
            raise RuntimeError(f"KV pool exhausted: need {n} blocks, {len(self.free)} free")
        return [self.free.pop() for _ in range(n)]

    def release(self, blocks) -> None:
        for blk in blocks:
            if blk:  # never return the reserved junk block
                self.free.append(int(blk))
