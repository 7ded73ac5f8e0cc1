"""Flash-decode attention over the INT8 (or bf16) KV cache, slab and paged
(counterpart of ``tpu_lutvq.kernels.flash_decode``).

Single-query GQA attention with the reference's online-softmax recurrence
and its rounding points (``flash_decode.py:108-143``, ``:156-165``):

- q is scaled by ``1/sqrt(Dh)`` in f32, then rounded to bf16;
- int8 (or bf16) K and V convert exactly; scores accumulate in f32 and are
  then multiplied by the k row-scale; rows ``s > pos[b]`` are masked;
- the running max moves once per block of ``block_s`` rows (the pool block
  for the paged cache): ``p = exp(s - m_new)`` feeds ``l`` unrounded, is
  multiplied by the v row-scale, rounded to bf16 and multiplied into V with
  f32 accumulation; the output is ``acc / l``.

Query head ``h`` reads kv head ``h // rep``.  Blocks wholly past ``pos[b]``
are skipped by the kernel; the plain versions compute them, which changes
nothing (their rows are masked, so ``m`` stays, ``alpha`` is 1 and ``p`` 0).

:func:`decode_slab` and :func:`decode_paged` are the kernel's wrappers: a
CUDA tensor launches ``csrc/flash_decode.cu`` (counted in
``FLASH_DECODE_LAUNCHES`` / ``FLASH_DECODE_PAGED_LAUNCHES``, one a call) or
raises; a CPU tensor takes :func:`decode_slab_plain` /
:func:`decode_paged_plain`.  The kernel splits the window into chunks
across blocks as :func:`plan_decode` says and rounds each chunk's p against
its reference block's prefix max, so it keeps the rounding points above.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from tpu_lutvq_torch.kernels import _build

DEFAULT_BLOCK_S = 256
NEG_INF = -1e30

FLASH_DECODE_LAUNCHES = 0  # slab kernel launches since the last reset
FLASH_DECODE_PAGED_LAUNCHES = 0  # paged kernel launches since the last reset

KERNEL_HEAD_DIMS = (64, 128)  # head_dim values csrc/flash_decode.cu is built for
KERNEL_MAX_REP = 8  # query heads per kv head the kernel holds in registers
KERNEL_MAX_BLOCK = 512  # rows per block the kernel takes
KERNEL_MAX_CHUNK = 128  # rows a chunk of the split (csrc/flash_decode.cu kMaxChunk)
KERNEL_MIN_CHUNK = 32  # smallest chunk the plan picks to fill the card


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How ``csrc/flash_decode.cu`` splits a window of ``n_chunks * chunk``
    rows: pass 1 and pass 2 run one block per (chunk, kv head, sequence)
    (``grid``, x fastest), and chunk ``c`` rounds its p against the prefix
    max of its reference block ``c // per_block``."""

    chunk: int  # rows a chunk: a divisor of block_s, ≤ KERNEL_MAX_CHUNK
    n_chunks: int
    per_block: int  # chunks a reference block
    grid: tuple

    def rows(self, c: int, pos: int) -> range:
        """The rows chunk ``c`` attends for a sequence at ``pos``: empty
        when the chunk lies wholly past it (its blocks exit at once)."""
        start = c * self.chunk
        return range(start, min(start + self.chunk, pos + 1) if start <= pos else start)

    def workspace_floats(self, b: int, h: int, dh: int) -> int:
        """f32 workspace: scores (B, H, W), then per (B, H, chunk) the chunk
        max, the partial sum of bf16(p vs) V (Dh), Σ p and the prefix max."""
        return b * h * self.n_chunks * (self.chunk + dh + 3)


@functools.lru_cache(maxsize=None)
def plan_decode(b: int, hkv: int, window: int, block_s: int, sms: int) -> DecodePlan:
    """The split of a ``window``-row read (whole blocks of ``block_s``
    rows) for ``b`` sequences of ``hkv`` kv heads on a card of ``sms`` SMs.
    The chunk is the largest divisor of block_s up to KERNEL_MAX_CHUNK that
    gives two waves of blocks, halving no further than KERNEL_MIN_CHUNK.  A
    function of the shapes alone: the positions stay on the device, and
    chunks past them exit."""
    if window % block_s:
        raise ValueError(f"window {window} is not whole blocks of {block_s}")
    divisors = [d for d in range(min(block_s, KERNEL_MAX_CHUNK), 0, -1) if block_s % d == 0]
    cands = [d for d in divisors if d >= KERNEL_MIN_CHUNK] or divisors[:1]
    chunk = next((d for d in cands if b * hkv * (window // d) >= 2 * sms), cands[-1])
    n_chunks = window // chunk
    return DecodePlan(chunk, n_chunks, block_s // chunk, (n_chunks, hkv, b))


def _bf16_f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def check_window(pos: torch.Tensor, t: int, window: int, s_max: int, what: str) -> None:
    """The reference's truncation check (``flash_decode.py:227-236``): a
    window that would never stream row ``max(pos) + t - 1`` raises.  It runs
    only when ``pos`` lies on the CPU, as the reference's runs only when
    ``pos`` is concrete: a CUDA ``pos`` is never read back on the host."""
    if window < s_max and pos.device.type == "cpu":
        max_pos = int(pos.max())
        if max_pos + t > window:
            raise ValueError(
                f"window={window} truncates attention: {what}={max_pos + t}"
                " rows would never be streamed (bucket the window up)"
            )


def _prep_q(q: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Decode's query rounding (``flash_decode.py:156-165``): scaled in f32,
    then rounded to bf16 (returned as f32 values)."""
    return _bf16_f32(q.float() * sm_scale)


def online_block(m, l, acc, scores, v, v_scale):
    """One block of the online softmax: ``scores`` (..., R, BS) already
    scaled and masked, ``v`` (..., BS, Dh) exact f32 values, ``v_scale``
    (..., 1, BS) or None.  Returns the new (m, l, acc)."""
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale
    return m_new, l, acc * alpha + _bf16_f32(p) @ v


def _decode_plain(q, pos, blocks, hkv: int, quantized: bool):
    """The recurrence over ``blocks``: (start, k, v, k_scale, v_scale) with
    k/v (B, H_kv, BS, Dh) and scales (B, H_kv, BS)."""
    b, h, dh = q.shape
    q3 = _prep_q(q, 1.0 / dh**0.5).reshape(b, hkv, h // hkv, dh)
    m = torch.full((b, hkv, h // hkv, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q3)
    for start, k, v, ks, vs in blocks:
        scores = q3 @ k.float().transpose(-1, -2)  # (B, H_kv, rep, BS)
        if quantized:
            scores = scores * ks.float()[:, :, None, :]
        span = start + torch.arange(k.shape[2], device=q.device)
        scores = torch.where(span <= pos.long()[:, None, None, None], scores, NEG_INF)
        m, l, acc = online_block(
            m, l, acc, scores, v.float(), vs.float()[:, :, None, :] if quantized else None
        )
    return (acc / l).reshape(b, h, dh)


def decode_slab_plain(q, k_q, v_q, k_scale, v_scale, pos, nblk: int, block_s: int):
    """Plain version of the slab kernel: ``nblk`` blocks of ``block_s`` rows
    of the ``(B, H_kv, S, Dh)`` cache.  ``(B, H, Dh)`` f32."""
    def blocks():
        for s in range(nblk):
            sl = slice(s * block_s, (s + 1) * block_s)
            yield s * block_s, k_q[:, :, sl], v_q[:, :, sl], k_scale[:, :, sl], v_scale[:, :, sl]

    return _decode_plain(q, pos, blocks(), k_q.shape[1], k_q.dtype == torch.int8)


def decode_paged_plain(q, k_pool, v_pool, k_scale, v_scale, block_tables, pos, nblk: int):
    """Plain version of the paged kernel: block ``s`` of sequence ``b`` is
    pool block ``block_tables[b, s]``.  ``(B, H, Dh)`` f32."""
    bs = k_pool.shape[2]

    def blocks():
        for s in range(nblk):
            blk = block_tables[:, s].long()
            yield s * bs, k_pool[blk], v_pool[blk], k_scale[blk], v_scale[blk]

    return _decode_plain(q, pos, blocks(), k_pool.shape[1], k_pool.dtype == torch.int8)


def decode_slab(q, k_q, v_q, k_scale, v_scale, pos, nblk: int, block_s: int):
    """The slab kernel's wrapper: plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor."""
    if q.device.type == "cpu":
        return decode_slab_plain(q, k_q, v_q, k_scale, v_scale, pos, nblk, block_s)
    global FLASH_DECODE_LAUNCHES
    out = _launch(q, k_q, v_q, k_scale, v_scale, pos, None, nblk, block_s)
    FLASH_DECODE_LAUNCHES += 1
    return out


def decode_paged(q, k_pool, v_pool, k_scale, v_scale, block_tables, pos, nblk: int):
    """The paged kernel's wrapper: plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor."""
    if q.device.type == "cpu":
        return decode_paged_plain(q, k_pool, v_pool, k_scale, v_scale, block_tables, pos, nblk)
    global FLASH_DECODE_PAGED_LAUNCHES
    out = _launch(q, k_pool, v_pool, k_scale, v_scale, pos, block_tables, nblk,
                  k_pool.shape[2])
    FLASH_DECODE_PAGED_LAUNCHES += 1
    return out


def _launch(q, k, v, k_scale, v_scale, pos, block_tables, nblk, block_s):
    b, h, dh = q.shape
    hkv, rows = k.shape[1], k.shape[2]  # rows: S (slab) or BS (pool)
    rep = h // hkv
    if dh not in KERNEL_HEAD_DIMS or rep > KERNEL_MAX_REP or block_s > KERNEL_MAX_BLOCK:
        raise ValueError(
            f"flash_decode kernel takes head_dim in {KERNEL_HEAD_DIMS}, ≤ {KERNEL_MAX_REP} "
            f"query heads per kv head and ≤ {KERNEL_MAX_BLOCK} rows a block; got "
            f"head_dim={dh}, rep={rep}, block={block_s}"
        )
    if k.dtype not in (torch.int8, torch.bfloat16) or v.dtype != k.dtype:
        raise ValueError(f"flash_decode kernel takes int8 or bf16 K/V, got {k.dtype}/{v.dtype}")
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    q, pos = q.float().contiguous(), pos.to(torch.int32).contiguous()
    k_scale, v_scale = k_scale.float().contiguous(), v_scale.float().contiguous()
    for t, name, dtype in ((q, "q", torch.float32), (k, "k", k.dtype), (v, "v", k.dtype),
                           (k_scale, "k_scale", torch.float32),
                           (v_scale, "v_scale", torch.float32), (pos, "pos", torch.int32)):
        _build.require_cuda_tensor(t, name, dtype)
    max_blocks = 0
    if block_tables is not None:
        block_tables = block_tables.to(torch.int32).contiguous()
        _build.require_cuda_tensor(block_tables, "block_tables", torch.int32)
        max_blocks = block_tables.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = plan_decode(b, hkv, nblk * block_s, block_s, sms)
    ws = torch.empty((plan.workspace_floats(b, h, dh),), dtype=torch.float32, device=q.device)
    lib = _build.library()
    err = lib.lutvq_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        pos.data_ptr(), None if block_tables is None else block_tables.data_ptr(),
        out.data_ptr(), ws.data_ptr(), b, h, hkv, dh, rows, nblk, block_s, max_blocks,
        plan.chunk, int(k.dtype == torch.int8), ctypes.c_float(1.0 / dh**0.5),
        _build.stream_ptr(q),
    )
    _build.check(lib, err, "flash_decode")
    return out


def flash_decode_attention(
    q: torch.Tensor,  # (B, H, Dh) single-token queries, post-RoPE
    k_q: torch.Tensor,  # (B, H_kv, S, Dh) int8 or bf16
    v_q: torch.Tensor,
    k_scale: torch.Tensor,  # (B, H_kv, S)
    v_scale: torch.Tensor,
    pos: torch.Tensor,  # (B,) int32: attend to rows s <= pos[b]
    *,
    window: int,
    block_s: int = DEFAULT_BLOCK_S,
    layer=None,
    plain: bool = False,
) -> torch.Tensor:
    """Single-step attention ``(B, H, Dh)`` f32 over the first ``window``
    rows of a slab cache.  ``block_s`` is clamped and ``window`` floored to
    whole blocks as in the reference (``flash_decode.py:217-222``).
    ``plain=True`` runs the plain version on any device (reference runs)."""
    if layer is not None:
        raise NotImplementedError(
            "flash_decode_attention(layer=) reads a stacked cache, which is not "
            "ported (ROADMAP Queue 1 item 8)"
        )
    b, h, dh = q.shape
    hkv, s_max = k_q.shape[1], k_q.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    block_s = min(block_s, s_max, max(8192 // hkv, 32))
    window = (min(_round_up(window, block_s), s_max) // block_s) * block_s
    check_window(pos, 1, window, s_max, "max(pos)+1")
    fn = decode_slab_plain if plain else decode_slab
    return fn(q, k_q, v_q, k_scale, v_scale, pos, window // block_s, block_s)


def flash_decode_paged(
    q: torch.Tensor,  # (B, H, Dh)
    k_pool: torch.Tensor,  # (N, H_kv, BS, Dh) int8 or bf16
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,  # (N, H_kv, BS)
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # (B, MAXB) int32
    pos: torch.Tensor,  # (B,) int32
    *,
    window: int,
    plain: bool = False,
) -> torch.Tensor:
    """Paged single-step attention ``(B, H, Dh)`` f32; ``window`` bounds the
    blocks visited, rounded up to whole pool blocks (``flash_decode.py:397``)."""
    b, h, dh = q.shape
    hkv, bs = k_pool.shape[1], k_pool.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    nblk = min(-(-window // bs), block_tables.shape[1])
    fn = decode_paged_plain if plain else decode_paged
    return fn(q, k_pool, v_pool, k_scale, v_scale, block_tables, pos, nblk)
