"""Flash-prefill attention over the INT8 (or bf16) KV cache (counterpart of
``tpu_lutvq.kernels.flash_prefill``).

Causal attention of T queries per sequence, query ``t`` of sequence ``b``
at position ``t_offset[b] + t``, over the cache rows already written.  The
rounding points are the reference kernel's (``flash_prefill.py:82-113``),
which are not flash decode's: q is rounded to bf16 unscaled, and the f32
scores are multiplied by ``sm_scale`` and then by the k row-scale.  The
running max moves once per ``block_s`` KV rows; ``p`` feeds ``l`` unrounded
and is multiplied by the v row-scale and rounded to bf16 before the PV
product, as in decode.

Query rows are independent and a KV block wholly above a row's diagonal
leaves its state unchanged, so the function depends on ``block_s`` but not
on the query tiling: ``block_q`` (shrunk for short T as in the reference,
``:166-168``) tiles the plain version, and the CUDA kernel tiles by 64.

:func:`prefill` is the kernel's wrapper: a CUDA tensor launches
``csrc/flash_prefill.cu`` (counted in ``FLASH_PREFILL_LAUNCHES``) or
raises; a CPU tensor takes :func:`prefill_plain`, the plain version.  The
kernel splits each query tile's KV rows (whole blocks, or halves or
quarters of them) over a thread-block cluster as :func:`plan_prefill` says
and rounds each block's p against the prefix max of its and the earlier
blocks' maxima, so it keeps the rounding points above.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from tpu_lutvq_torch.kernels import _build
from tpu_lutvq_torch.kernels.flash_decode import (
    NEG_INF,
    _bf16_f32,
    _round_up,
    check_window,
    online_block,
)

DEFAULT_BLOCK_Q = 256
DEFAULT_BLOCK_S = 256

FLASH_PREFILL_LAUNCHES = 0  # kernel launches since the last reset

KERNEL_HEAD_DIMS = (64, 128)  # head_dim values csrc/flash_prefill.cu is built for
KERNEL_TILE = 64  # the kernel's KV sub-tile: block_s must be a multiple
KERNEL_Q_TILE = 64  # query rows a block (4 warps of 16)
KERNEL_MAX_BLOCK = 256  # rows of a KV block whose scores a block holds (kMaxBlock)
KERNEL_MAX_SPLIT = 8  # blocks a cluster (the portable cluster size)
KERNEL_MAX_ROUNDS = 16  # chunks (rounds) a rank may take (kMaxRounds)
# plan_prefill's cost model, in KV sub-tiles of one block's chain: a block's
# set-up (Q, the first sub-tile) and, split, its exchange and combine
_SETUP_SUBTILES = 4
_SPLIT_SUBTILES = 2


@dataclasses.dataclass(frozen=True)
class PrefillPlan:
    """How ``csrc/flash_prefill.cu`` covers ``nblk`` KV blocks of
    ``block_s`` rows: one cluster of ``n_split`` blocks per (query tile of
    ``q_tile`` rows, head, sequence); the window is cut into chunks of
    ``chunk`` rows (``block_s`` or a divisor of it), and chunk ``c`` goes to
    rank ``c % n_split`` in round ``c // n_split``.  ``grid`` = (n_split ×
    query tiles, H, B), x fastest.  A rank whose first chunk lies above a
    tile's last query position exits at once."""

    q_tile: int
    n_split: int
    chunk: int
    block_s: int
    nblk: int
    grid: tuple

    @property
    def n_chunks(self) -> int:
        return self.nblk * (self.block_s // self.chunk)

    @property
    def rounds(self) -> int:
        return -(-self.n_chunks // self.n_split)

    def chunks(self, rank: int) -> range:
        """Rank ``rank``'s chunks, one a round."""
        return range(rank, self.n_chunks, self.n_split)

    def live_ranks(self, last_pos: int) -> int:
        """Ranks with a KV row at or below ``last_pos`` (a tile's last query
        position): the ranks that do not exit."""
        return min(self.n_split, min(self.n_chunks - 1, last_pos // self.chunk) + 1)


@functools.lru_cache(maxsize=None)
def plan_prefill(b: int, t: int, h: int, hkv: int, window: int, block_s: int, sms: int,
                 fits=None) -> PrefillPlan:
    """The split of a ``window``-row read (whole blocks of ``block_s`` rows)
    for ``b`` sequences of ``t`` queries over ``h`` query heads (``hkv`` kv
    heads) on a card of ``sms`` SMs: the (chunk, cluster size) that
    minimises waves × a block's chain, in KV sub-tiles (two for each of its
    rounds' 64-row sub-tiles, K and V, and its set-up, exchange and
    combine); of equal costs, the finer chunks (a window's last, partly
    masked blocks spread over the ranks).  ``fits(n_split, chunk)`` is how
    many such clusters the card holds at once (the wrapper asks the card;
    by default two blocks an SM, ``2 * sms // n_split``): a cluster that
    does not fit waits for a later wave.  The chain counts every chunk of
    the window (the offsets stay on the device: a function of the shapes
    alone), so it is the worst tile's."""
    if window % block_s or block_s % KERNEL_TILE or block_s > KERNEL_MAX_BLOCK:
        raise ValueError(f"window {window} is not whole blocks of {block_s} (a multiple of "
                         f"{KERNEL_TILE}, at most {KERNEL_MAX_BLOCK})")
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    nblk = window // block_s
    q_tiles = -(-t // KERNEL_Q_TILE)
    best = None
    for cpb in (4, 2, 1):  # chunks a KV block
        chunk = block_s // cpb
        if block_s % cpb or chunk % KERNEL_TILE:
            continue
        for n in range(cpb, KERNEL_MAX_SPLIT + 1, cpb):
            rounds = -(-nblk * cpb // n)
            if n > nblk * cpb or rounds > KERNEL_MAX_ROUNDS:
                continue
            slots = 2 * sms // n if fits is None else fits(n, chunk)
            if slots < 1:
                continue
            chain = 2 * rounds * (chunk // KERNEL_TILE) + _SETUP_SUBTILES + (
                _SPLIT_SUBTILES if n > 1 else 0)
            cost = -(-q_tiles * h * b // slots) * chain
            if best is None or cost < best[0]:
                best = (cost, PrefillPlan(KERNEL_Q_TILE, n, chunk, block_s, nblk,
                                          (n * q_tiles, h, b)))
    if best is None:
        raise ValueError(f"flash_prefill kernel takes ≤ {KERNEL_MAX_SPLIT * KERNEL_MAX_ROUNDS} "
                         f"KV blocks; got {nblk} of {block_s} rows")
    return best[1]


@functools.lru_cache(maxsize=None)
def _cluster_fits(dh: int, int8: bool):
    """``fits`` of :func:`plan_prefill` for this head_dim and KV type: the
    clusters of a plan the card holds at once (the CUDA occupancy query),
    0 when one cannot launch.  Cached, so the plan's cache hits."""
    @functools.lru_cache(maxsize=None)
    def fits(n_split: int, chunk: int) -> int:
        return max(_build.library().lutvq_flash_prefill_clusters(dh, int(int8), n_split,
                                                                 chunk), 0)
    return fits


def _prep_q(q: torch.Tensor) -> torch.Tensor:
    """Prefill's query rounding (``flash_prefill.py:82-84``): bf16,
    unscaled; ``sm_scale`` multiplies the f32 scores."""
    return _bf16_f32(q.float())


def prefill_plain(q, k_q, v_q, k_scale, v_scale, t_offset, nblk: int, block_s: int,
                  block_q: int = DEFAULT_BLOCK_Q):
    """Plain version: query tiles of ``block_q``, ``nblk`` KV blocks of
    ``block_s`` rows each.  ``(B, T, H, Dh)`` f32."""
    b, t, h, dh = q.shape
    hkv = k_q.shape[1]
    rep = h // hkv
    quantized = k_q.dtype == torch.int8
    sm_scale = 1.0 / dh**0.5
    # (B, T, H, Dh) -> (B, H_kv, rep, T, Dh), bf16 values, unscaled
    qb = _prep_q(q).reshape(b, t, hkv, rep, dh).permute(0, 2, 3, 1, 4)
    out = torch.empty_like(qb)
    for q0 in range(0, t, block_q):
        q1 = min(q0 + block_q, t)
        qq = qb[:, :, :, q0:q1]
        qpos = t_offset.long()[:, None] + torch.arange(q0, q1, device=q.device)  # (B, tq)
        m = torch.full(qq.shape[:-1] + (1,), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qq)
        for s in range(nblk):
            sl = slice(s * block_s, (s + 1) * block_s)
            k = k_q[:, :, None, sl].float()  # (B, H_kv, 1, BS, Dh)
            scores = (qq @ k.transpose(-1, -2)) * sm_scale  # (B, H_kv, rep, tq, BS)
            if quantized:
                scores = scores * k_scale[:, :, None, None, sl].float()
            span = s * block_s + torch.arange(block_s, device=q.device)
            valid = span[None, None, None, None, :] <= qpos[:, None, None, :, None]
            scores = torch.where(valid, scores, NEG_INF)
            vs = v_scale[:, :, None, None, sl].float() if quantized else None
            m, l, acc = online_block(m, l, acc, scores, v_q[:, :, None, sl].float(), vs)
        out[:, :, :, q0:q1] = acc / l
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, dh)


def prefill(q, k_q, v_q, k_scale, v_scale, t_offset, nblk: int, block_s: int,
            block_q: int = DEFAULT_BLOCK_Q):
    """The kernel's wrapper: plain version for a CPU tensor, the CUDA kernel
    for a CUDA tensor (which tiles queries by 64 whatever ``block_q``)."""
    if q.device.type == "cpu":
        return prefill_plain(q, k_q, v_q, k_scale, v_scale, t_offset, nblk, block_s, block_q)
    global FLASH_PREFILL_LAUNCHES
    out = _launch(q, k_q, v_q, k_scale, v_scale, t_offset, nblk, block_s)
    FLASH_PREFILL_LAUNCHES += 1
    return out


def _launch(q, k_q, v_q, k_scale, v_scale, t_offset, nblk, block_s):
    b, t, h, dh = q.shape
    hkv, s_max = k_q.shape[1], k_q.shape[2]
    if dh not in KERNEL_HEAD_DIMS or block_s % KERNEL_TILE or block_s > KERNEL_MAX_BLOCK:
        raise ValueError(
            f"flash_prefill kernel takes head_dim in {KERNEL_HEAD_DIMS} and block_s a "
            f"multiple of {KERNEL_TILE} up to {KERNEL_MAX_BLOCK}; got head_dim={dh}, "
            f"block_s={block_s}"
        )
    if k_q.dtype not in (torch.int8, torch.bfloat16) or v_q.dtype != k_q.dtype:
        raise ValueError(f"flash_prefill kernel takes int8 or bf16 K/V, got {k_q.dtype}")
    out = torch.empty((b, t, h, dh), dtype=torch.float32, device=q.device)
    q, t_offset = q.float().contiguous(), t_offset.to(torch.int32).contiguous()
    k_scale, v_scale = k_scale.float().contiguous(), v_scale.float().contiguous()
    for x, name, dtype in ((q, "q", torch.float32), (k_q, "k", k_q.dtype),
                           (v_q, "v", k_q.dtype), (k_scale, "k_scale", torch.float32),
                           (v_scale, "v_scale", torch.float32),
                           (t_offset, "t_offset", torch.int32)):
        _build.require_cuda_tensor(x, name, dtype)
    int8 = k_q.dtype == torch.int8
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = plan_prefill(b, t, h, hkv, nblk * block_s, block_s, sms, _cluster_fits(dh, int8))
    lib = _build.library()
    err = lib.lutvq_flash_prefill(
        q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        t_offset.data_ptr(), out.data_ptr(), b, t, h, hkv, dh, s_max, nblk, block_s,
        plan.chunk, plan.n_split, int(int8), ctypes.c_float(1.0 / dh**0.5),
        _build.stream_ptr(q),
    )
    _build.check(lib, err, "flash_prefill")
    return out


def flash_prefill_attention(
    q: torch.Tensor,  # (B, T, H, Dh) post-RoPE queries
    k_q: torch.Tensor,  # (B, H_kv, S, Dh) int8 or bf16, new rows already written
    v_q: torch.Tensor,
    k_scale: torch.Tensor,  # (B, H_kv, S)
    v_scale: torch.Tensor,
    t_offset: torch.Tensor,  # (B,) int32: position of q[:, 0] per sequence
    *,
    window: int,
    block_q: int = DEFAULT_BLOCK_Q,
    block_s: int = DEFAULT_BLOCK_S,
    plain: bool = False,
) -> torch.Tensor:
    """Causal prefill attention ``(B, T, H, Dh)`` f32 over the first
    ``window`` cache rows (rounded up to whole KV blocks, as the reference
    does).  ``plain=True`` runs the plain version on any device."""
    b, t, h, dh = q.shape
    hkv, s_max = k_q.shape[1], k_q.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    block_s = min(block_s, s_max)
    window = min(_round_up(window, block_s), s_max)
    check_window(t_offset, t, window, s_max, "max(t_offset)+T")
    if t <= block_q:
        block_q = _round_up(t, 8)
    fn = prefill_plain if plain else prefill
    return fn(q, k_q, v_q, k_scale, v_scale, t_offset, window // block_s, block_s, block_q)
