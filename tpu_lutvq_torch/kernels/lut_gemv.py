"""Fused LUT lookup-accumulate GEMV (counterpart of ``tpu_lutvq.kernels.lut_gemv``).

Semantics: ``y[b, j] = s[j] · Σ_g lut[b, g, codes_t[g, j]]``, in five
flavours of table, each a hand-written CUDA kernel for 1 to
``MAX_LUT_BATCH`` tokens per launch (larger batches are chunked):

- ``pair``/``bpair`` (B=1 / B≥2): bf16 entries, f32 sum, wrapper
  :func:`lut_lookup` — ``pair`` in ``csrc/lut_scan.cu`` (kind 0: one
  token's f32 table rounded to bf16 as the kernel stages it, its groups
  split over a thread-block cluster as :func:`plan_pair` says; counter
  ``LUT_GEMV_LAUNCHES``), ``bpair`` in ``csrc/lut_bpair.cu``, which rounds
  the f32 tables to bf16 as it stages them and splits the groups over a
  thread-block cluster as :func:`plan_bpair` says (counter
  ``LUT_GEMV_BPAIR_LAUNCHES``);
- ``pairf`` (B=1): ``pair``'s function from the f32 table — the same
  kernel, wrapper :func:`lut_lookup_pairf`, counter
  ``LUT_GEMV_PAIRF_LAUNCHES``;
- ``f32``: f32 entries, f32 sum — ``csrc/lut_scan.cu`` (kind 1), wrapper
  :func:`lut_lookup_table`, counter ``LUT_GEMV_F32_LAUNCHES``;
- ``i8``/``i16``: per-token range-quantized int8/int16 entries, exact
  integer sum, then the token's table scale — the same source (kinds 2, 3)
  and wrapper, counters ``LUT_GEMV_I8_LAUNCHES``/``LUT_GEMV_I16_LAUNCHES``;
  the table kernels' splits are :func:`plan_scan`'s;
- ``nibbles``/``nibbles_bpair`` (B=1 / B≥2), the only variants of a
  nibble-packed (T-MAC, K=16) pack: two groups' 4-bit codes a byte, one
  token's f32 table (J1) or 2-8 tokens' bf16 tables (J2), f32 sum — one
  source, ``csrc/lut_nibbles.cu``, its code rows split over a thread-block
  cluster as :func:`plan_nibbles_f32` (J1) or :func:`plan_nibbles` (J2)
  says — wrapper :func:`lut_lookup_nibbles`,
  counters ``LUT_GEMV_NIBBLES_LAUNCHES``/``LUT_GEMV_NIBBLES_BPAIR_LAUNCHES``.

A wrapper launches its kernel for a CUDA tensor (and counts the launch) or
raises; a CPU tensor takes the plain PyTorch version
(:func:`lut_lookup_plain`, :func:`lut_lookup_int_plain`,
:func:`lut_lookup_nibbles_plain`).  :func:`lut_gemv_packed` runs the lookup
over prebuilt tables (the ANN scan), :func:`lut_gemv` builds the tables
from activations first; an ``out_group`` pack (AQLM ``out_group_size``)
runs as a pseudo-batch of one table per block row.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from tpu_lutvq_torch.core.config import VQConfig
from tpu_lutvq_torch.core.params import VQParams, pack_codes_nibbles, unpack_codes_nibbles
from tpu_lutvq_torch.kernels import _build
from tpu_lutvq_torch.kernels.lut_ctor import (
    LANE,
    build_lut,
    quantize_lut_int8,
    quantize_lut_int16,
)

DEFAULT_BLOCK_J = 1024  # the JAX tiling's output block; sets the padding rule
MAX_LUT_BATCH = 8  # widest token tile of the CUDA kernel
# kernel launches since the last reset (see module doc)
LUT_GEMV_LAUNCHES = 0  # bf16 tables, one token (pair)
LUT_GEMV_BPAIR_LAUNCHES = 0  # bf16 tables, 2-8 tokens (bpair)
LUT_GEMV_PAIRF_LAUNCHES = 0  # f32 tables rounded to bf16 in the kernel
LUT_GEMV_F32_LAUNCHES = 0
LUT_GEMV_I8_LAUNCHES = 0
LUT_GEMV_I16_LAUNCHES = 0
LUT_GEMV_NIBBLES_LAUNCHES = 0  # nibble codes, f32 tables (J1)
LUT_GEMV_NIBBLES_BPAIR_LAUNCHES = 0  # nibble codes, bf16 tables (J2)

_TOKEN_TILES = (1, 2, 4, 8)
# csrc/lut_bpair.cu (B): columns × row groups a block spans (256 threads of
# 4 columns), column tiles a block may take, blocks a cluster may hold
# (above 8 where the card allows it), table entries (groups × Kp × a
# block's tokens) a round stages, groups a thread looks up a round
BPAIR_SPAN = 1024
BPAIR_TILE_COLS = (1024, 512, 256, 128)
BPAIR_MAX_SPLITS = 16
_BPAIR_STAGE_ENTRIES = 8192
_BPAIR_MAX_PER_THREAD = 8
# plan_bpair's cost model, in clocks of one SM: a round writes its entries
# as bf16 (2 B each) and looks up its groups' entries for every column, both
# through shared memory at 128 B/clk, ~3.5 times slower as measured on the
# H100 (random codes over K = 256 rows meet bank conflicts), and has a
# barrier; two blocks an SM share it; the tables cross the L2 (~2560 B/clk
# in all) once per column tile
_BPAIR_SMEM_BPC = 128 / 3.5
_BPAIR_ROUND_CLK = 200
_BPAIR_L2_BPC = 2560
# csrc/lut_scan.cu (A, M, K, H, I): block sizes, column tiles a block may
# take, blocks a cluster may hold (above 8 where the card allows it), a
# block's shared memory
SCAN_THREADS = (256, 512)
SCAN_TILE_COLS = (128, 256, 512, 1024, 2048)
SCAN_MAX_SPLITS = 16
_SCAN_SMEM_MAX = 227 * 1024
# kernel kind by entries: 0 one token's f32 table rounded to bf16 (A, M), 1
# f32 (K), 2 int8 (H), 3 int16 (I); its entry bytes and a lane's columns
SCAN_PAIR = 0
_SCAN_ENTRY_BYTES = {0: 4, 1: 4, 2: 1, 3: 2}
_SCAN_LANE_COLS = {0: 16, 1: 16, 2: 8, 3: 8}
# plan_scan's cost model, in clocks of one SM, fit to chip_smoke.py
# --plans on an H100 (every candidate plan timed at the main paths'
# shapes): a warp's 4-byte shared-memory load of random K = 256 codes meets
# _SCAN_CONFLICT[words a row] distinct words on its busiest bank (Monte
# Carlo; 32 / words rows a load), each costing _SCAN_WAVE_CLK; a block has a
# fixed cost, a cost a column tile, and stages its tables through its SM at
# _SCAN_SM_L2_BPC bytes a clock; the tables cross the L2 at _SCAN_L2_BPC in
# all, codes and outputs HBM at _SCAN_HBM_BPC (3.35 TB/s at 1980 MHz)
_SCAN_CONFLICT = {1: 3.15, 2: 2.92, 4: 2.54, 8: 2.11}
_SCAN_WAVE_CLK = 0.75
_SCAN_BLOCK_CLK = 1000
_SCAN_TILE_CLK = 1500
_SCAN_SM_L2_BPC = 64
_SCAN_L2_BPC = 800
_SCAN_HBM_BPC = 1692
_SCAN_SM_SMEM = 228 * 1024  # an SM's shared memory, 1 KiB of it per block reserved
NIBBLE_K = 16  # table entries a group has under 4-bit codes
# entry type → (kernel kind in csrc/lut_scan.cu, its counter)
_SCAN_KINDS = {
    torch.float32: (1, "LUT_GEMV_F32_LAUNCHES"),
    torch.int8: (2, "LUT_GEMV_I8_LAUNCHES"),
    torch.int16: (3, "LUT_GEMV_I16_LAUNCHES"),
}
# csrc/lut_nibbles.cu (J1, J2): column tiles a block may take, blocks a
# cluster may hold (the portable cluster size), the table bytes staged at a
# time
NIBBLE_TILE_COLS = (1024, 512, 256, 128)
NIBBLE_MAX_SPLITS = 8
_NIBBLE_STAGE_BYTES = 128 * 1024
# plan_nibbles_f32's cost model (fit to J1's H100 sweep of tile and split
# sizes at the T-MAC shapes): a block's fixed cost in column lookups, the
# SMs a wave of clusters leaves idle, and the cluster sizes it takes (odd
# ones read slower on the H100)
_F32_BLOCK_LOOKUPS = 40_000
_F32_IDLE_SMS = 8
NIBBLE_F32_SPLITS = (1, 2, 4, 6, 8)
VARIANTS = ("auto", "pair", "pairf", "bpair", "f32", "i8", "i16")
NIBBLE_VARIANTS = ("nibbles", "nibbles_bpair")  # what a nibble pack resolves to


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass
class PackedVQ:
    """Kernel-facing parameter layout, prepared once at load time.

    codes_t:  ``(G_pad, d_out_pad)`` uint8 — transposed, padded codes in
              n-major group order (``g = n·M + m``, matching build_lut);
              ``(G_pad/2, d_out_pad)`` with ``nibbles``, row r holding group
              2r in its low and 2r+1 in its high nibble.
    codebook: original ``(M_cb, N, K, d)`` float codebook (for LUT build);
              ``(out_group, N, K, d)`` with ``out_group > 1``, slice r holding
              row r of every entry block.
    scales:   ``(1, d_out_pad)`` float32 or None.
    d_out:    code columns (≤ d_out_pad); the layer's outputs are
              ``full_d_out = d_out · out_group``.
    shards:   column-parallel shards the pack was padded for (each shard's
              chunk padded on its own); the kernels read one shard's chunk.
    zero_points: ``(1, d_out_pad)`` float32 or None (``W = s·W_q + z``).
    """

    codes_t: torch.Tensor
    codebook: torch.Tensor
    scales: Optional[torch.Tensor]
    d_out: int
    shards: int = 1
    nibbles: bool = False
    out_group: int = 1
    zero_points: Optional[torch.Tensor] = None

    @property
    def local_d_out(self) -> int:
        """Valid outputs per shard (``d_out`` when unsharded)."""
        return self.d_out // self.shards

    @property
    def full_d_out(self) -> int:
        """Logical output dim (code columns × block rows per code)."""
        return self.d_out * self.out_group


def pack_params(
    cfg: VQConfig,
    params: VQParams,
    block_j: int = DEFAULT_BLOCK_J,
    shards: int = 1,
    nibble_pack: bool = False,
    out_group: int = 1,
) -> PackedVQ:
    """Transpose codes to ``(G, d_out)`` (n-major groups) and pad: groups to a
    multiple of 8, outputs to a multiple of 128 and, past ``block_j``, to a
    multiple of it; with ``shards > 1`` each shard's chunk on its own (to 512
    multiples past 512).  ``nibble_pack`` (4-bit codes) pads groups to 16
    and packs two a byte.  Byte for byte the JAX package's layout
    (``lut_gemv.py:140-236``), computed on the params' device."""
    d_out = params.codes.shape[0]
    if d_out % shards:
        raise ValueError(f"d_out={d_out} must divide by shards={shards}")
    if cfg.n_cluster > 256:
        raise ValueError(
            f"pack_params stores uint8 codes; K={cfg.n_cluster} > 256 needs the "
            "1x16 loader paths (runtime.checkpoint one_x16='refit'|'dequant'|'chunked')"
        )
    g_pad = _round_up(cfg.n_groups, 8)
    # (d_out, M, N) -> n-major (N, M, d_out) -> (G, d_out)
    codes_t = params.codes.permute(2, 1, 0).reshape(cfg.n_groups, d_out).to(torch.uint8)
    codes_t = F.pad(codes_t, (0, 0, 0, g_pad - cfg.n_groups))
    scales = None if params.scales is None else params.scales.float().reshape(1, d_out)
    zero_points = None
    if params.zero_points is not None:
        if out_group > 1:
            raise ValueError("zero_points do not compose with out_group > 1")
        zero_points = params.zero_points.float().reshape(1, d_out)
    local = d_out // shards
    if shards > 1:
        local_pad = _round_up(local, 512 if local > 512 else LANE)
    else:
        local_pad = _round_up(local, LANE)
        if local_pad > block_j and local_pad % block_j:
            local_pad = _round_up(local_pad, block_j)

    def pad_chunks(arr, fill):
        if arr is None:
            return None
        return torch.cat([F.pad(arr[:, s * local : (s + 1) * local], (0, local_pad - local),
                                value=fill) for s in range(shards)], dim=1)

    codes_t = pad_chunks(codes_t, 0)
    if nibble_pack:
        if cfg.index_bits != 4:
            raise ValueError("nibble_pack requires 4-bit codes (K=16)")
        codes_t = F.pad(codes_t, (0, 0, 0, -codes_t.shape[0] % 16))
        codes_t = pack_codes_nibbles(codes_t.T).T
    if out_group > 1:
        if shards > 1 or nibble_pack:
            raise ValueError("out_group > 1 does not compose with shards/nibbles yet")
        if params.codebook.shape[0] != out_group:
            raise ValueError(
                f"out_group={out_group} needs codebook (out_group, N, K, d); "
                f"got leading dim {params.codebook.shape[0]}"
            )
    return PackedVQ(
        codes_t=codes_t.contiguous(),
        codebook=params.codebook,
        scales=pad_chunks(scales, 1.0),
        d_out=d_out,
        shards=shards,
        nibbles=nibble_pack,
        out_group=out_group,
        zero_points=pad_chunks(zero_points, 0.0),
    )


def _valid_width(packed: PackedVQ) -> int:
    """Valid outputs of the array the kernels see (``lut_gemv.py:57-71``):
    ``d_out``, or one shard's ``local_d_out`` when a shard pack's codes are
    one shard's chunk; a whole shard pack is refused."""
    if packed.shards == 1:
        return packed.d_out
    local = packed.local_d_out
    lp = _round_up(local, 512 if local > 512 else LANE)
    if packed.codes_t.shape[1] == lp:
        return local
    raise ValueError(
        "shard-packed weights (shards>1) are read one shard's chunk at a time; "
        f"got width {packed.codes_t.shape[1]}, expected per-shard {lp}"
    )


def local_view(packed: PackedVQ) -> PackedVQ:
    """The pack as the kernels read it: a shard's chunk as an unsharded pack
    of its ``local_d_out`` outputs."""
    if packed.shards == 1:
        return packed
    return dataclasses.replace(packed, d_out=_valid_width(packed), shards=1)


def resolve_variant(variant: str, *, nibbles: bool = False, batch: int, k: int) -> str:
    """Resolve "auto" as the JAX package does (``lut_gemv.py:239-247``): a
    nibble pack takes ``nibbles`` at B=1 and ``nibbles_bpair`` at B ≥ 2,
    whatever was asked; otherwise ``pair`` at B=1, ``bpair`` at B ≥ 2, and
    ``pair`` and ``pairf`` at K ≤ 128, where there are no K halves to pack,
    become ``f32``."""
    if variant not in VARIANTS + (NIBBLE_VARIANTS if nibbles else ()):
        raise ValueError(f"unknown lut_gemv variant {variant!r} ({'|'.join(VARIANTS)})")
    if nibbles:
        return "nibbles" if batch == 1 else "nibbles_bpair"
    if variant == "auto":
        variant = ("pair" if k > LANE else "f32") if batch == 1 else "bpair"
    if variant in ("pair", "pairf") and k <= LANE:
        return "f32"
    return variant


def lut_lookup_plain(
    lut: torch.Tensor,
    codes_t: torch.Tensor,
    scales: Optional[torch.Tensor],
    d_out: int,
    round_bf16: bool = True,
) -> torch.Tensor:
    """Plain version of the lookup kernel: ``(B, G, Kp)`` f32 LUTs →
    ``(B, d_out)`` f32.  Entries are rounded to bf16 where the JAX pair
    kernels pack them (``_pack_lut_pair_lohi``/``_pack_lut_pair_batch``);
    ``round_bf16=False`` is the f32-table variant."""
    b, g, _ = lut.shape
    tab = lut.to(torch.bfloat16).float() if round_bf16 else lut.float()
    idx = codes_t[:g, :d_out].long().unsqueeze(0).expand(b, g, d_out)
    y = torch.gather(tab, 2, idx).sum(dim=1)
    if scales is not None:
        y = y * scales[:, :d_out]
    return y


def lut_lookup(
    lut: torch.Tensor,
    codes_t: torch.Tensor,
    scales: Optional[torch.Tensor],
    d_out: int,
) -> torch.Tensor:
    """The lookup kernel's wrapper (bf16 tables): plain version for a CPU
    tensor, the CUDA kernel for a CUDA tensor."""
    if lut.device.type == "cpu":
        return lut_lookup_plain(lut, codes_t, scales, d_out)
    return _launch(lut, codes_t, scales, d_out)


def lut_lookup_pairf(
    lut: torch.Tensor,
    codes_t: torch.Tensor,
    scales: Optional[torch.Tensor],
    d_out: int,
) -> torch.Tensor:
    """The ``pairf`` wrapper (one token's f32 table, rounded to bf16 inside
    the kernel): plain version for a CPU tensor — :func:`lut_lookup_plain`,
    ``pair``'s, since both sum the same bf16 entries — the CUDA kernel for
    a CUDA tensor."""
    if lut.device.type == "cpu":
        return lut_lookup_plain(lut, codes_t, scales, d_out)
    return _launch_pairf(lut, codes_t, scales, d_out)


def _launch(lut, codes_t, scales, d_out):
    """One token's table: A (``csrc/lut_scan.cu`` kind 0, build_lut's f32
    table as it is, rounded to bf16 in the kernel — a bf16 table is widened
    first, exactly); 2-8 tokens': B (``csrc/lut_bpair.cu``)."""
    global LUT_GEMV_LAUNCHES
    if lut.shape[0] > 1:
        return _launch_bpair(lut, codes_t, scales, d_out)
    out = _run_scan(SCAN_PAIR, lut.float(), codes_t, scales, d_out, "lut_gemv")
    LUT_GEMV_LAUNCHES += 1
    return out


def _launch_pairf(lut, codes_t, scales, d_out):
    """``pairf``: A's kernel on one token's f32 table."""
    global LUT_GEMV_PAIRF_LAUNCHES
    if lut.shape[0] != 1 or lut.dtype != torch.float32:
        raise ValueError(f"pairf kernel takes one token's f32 table, got "
                         f"{tuple(lut.shape)} {lut.dtype}")
    out = _run_scan(SCAN_PAIR, lut, codes_t, scales, d_out, "lut_gemv_pairf")
    LUT_GEMV_PAIRF_LAUNCHES += 1
    return out


def scan_layout(kind: int, bp: int) -> tuple:
    """``csrc/lut_scan.cu``'s (kind, ``bp`` token slots) instance: (entry
    bytes, tokens a 4-byte word, words a staged (group, k) row — the lanes
    that share a column chunk —, columns a lane takes, (group, 4 k) items a
    thread stages a round: up to 64 bytes of entries, at most 4, at least
    one)."""
    es = _SCAN_ENTRY_BYTES[kind]
    lanes = bp * es // 4 if bp * es > 4 else 1
    return es, 4 // es, lanes, _SCAN_LANE_COLS[kind], min(4, max(1, 16 // (es * bp)))


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """How ``csrc/lut_scan.cu`` covers ``groups`` groups × the padded width
    for its ``kind`` and ``bp`` token slots: blocks of ``threads``, ``grid`` =
    (blocks along the columns, ``n_splits``).  With one split a block walks
    column tiles of ``tile_cols`` with a grid stride; with more, each block
    takes one tile and a tile's splits form one cluster.  Split ``q`` takes
    ``slice_groups`` groups from ``q * slice_groups`` in rounds of
    ``stage_groups`` (a multiple of the row groups), staged into ``nbuf``
    buffers: all rounds at once when they fit (the tables then stay staged
    from tile to tile)."""

    kind: int
    bp: int
    threads: int
    tile_cols: int
    n_splits: int
    slice_groups: int
    stage_groups: int
    nbuf: int
    grid: tuple

    @property
    def row_groups(self) -> int:
        """Thread groups of a block that interleave its rounds' groups."""
        _, _, lanes, cols, _ = scan_layout(self.kind, self.bp)
        return self.threads // (lanes * self.tile_cols // cols)

    def tiles(self, d_out_pad: int) -> list:
        """Column tiles of each block along the grid's first axis."""
        n = -(-d_out_pad // self.tile_cols)
        return [list(range(x, n, self.grid[0])) for x in range(self.grid[0])]

    def split_groups(self, groups: int) -> list:
        return [range(min(groups, q * self.slice_groups),
                      min(groups, (q + 1) * self.slice_groups)) for q in range(self.n_splits)]

    def rounds(self, split: range) -> list:
        return [range(s, min(split.stop, s + self.stage_groups))
                for s in range(split.start, split.stop, self.stage_groups)]

    def smem_bytes(self, kp: int) -> int:
        """The kernel's shared memory (``Smem`` in the source): the tables'
        round buffers, two rounds' codes, the row groups' partials, the
        cluster's inbox."""
        _, slots, lanes, _, _ = scan_layout(self.kind, self.bp)
        tokens = lanes * slots
        red = (self.row_groups > 1 or self.n_splits > 1) * self.row_groups * tokens * self.tile_cols
        inbox = (self.n_splits > 1) * (tokens * self.tile_cols + SCAN_MAX_SPLITS)
        codes = 2 * self.stage_groups * self.tile_cols
        return self.nbuf * self.stage_groups * kp * lanes * 4 + codes + 4 * (red + inbox)


@functools.lru_cache(maxsize=None)
def plan_scan(kind: int, bp: int, groups: int, d_out_pad: int, kp: int, sms: int,
              fits=None) -> ScanPlan:
    """The split of ``groups`` groups (tables of ``kp`` entries) over
    ``d_out_pad`` columns for ``csrc/lut_scan.cu``'s ``kind`` at ``bp``
    token slots on a card of ``sms`` SMs: of :func:`scan_candidates`, the
    one of least modelled time.  Pure."""
    return min(scan_candidates(kind, bp, groups, d_out_pad, kp, sms, fits),
               key=lambda c: c[0])[1]


def scan_candidates(kind: int, bp: int, groups: int, d_out_pad: int, kp: int, sms: int,
                    fits=None) -> list:
    """Every (block size, column tile, splits ≤ SCAN_MAX_SPLITS, rounds)
    plan that fits, with its sort key: the larger of waves × a block's time
    (a fixed cost, its tables through its SM, its lookups at the bank
    conflicts of random codes, shared with the blocks on its SM, its
    epilogue), the tables' traffic through the L2 (once per column tile, or
    per block where they stay staged) and the codes' and outputs' through
    HBM, in clocks of one SM; then the clocks before the HBM floor, the
    splits and the block size.  ``fits(kind, bp, kp, threads, tile_cols,
    n_splits, stage_groups, nbuf)`` is how many such clusters (with one
    split, blocks) the card holds at once (the wrapper asks the card; by
    default as registers, threads and shared memory allow on ``sms`` SMs);
    a cluster that does not fit waits for a second wave.  No split is left
    empty.  [(key, plan)]."""
    es, _, lanes, cols, items = scan_layout(kind, bp)
    table = groups * kp * bp * es
    hbm = (groups * d_out_pad + table + d_out_pad * bp * 4) / _SCAN_HBM_BPC
    out = []
    for threads in SCAN_THREADS:
        for tc in SCAN_TILE_COLS:
            per_rg = lanes * tc // cols  # threads of one row group
            if per_rg > threads or threads % per_rg:
                continue
            rg = threads // per_rg
            max_stage = threads * items * 4 // kp // rg * rg  # rounds of whole row groups
            if max_stage < rg:
                continue
            tiles = -(-d_out_pad // tc)
            for ns in range(1, SCAN_MAX_SPLITS + 1):
                slice_groups = -(-groups // ns)
                if slice_groups * (ns - 1) >= groups:
                    continue
                stage = min(max_stage, _round_up(slice_groups, rg))
                n_rounds = -(-slice_groups // stage)
                for nbuf in dict.fromkeys((n_rounds, min(2, n_rounds))):  # staged once, or a ring
                    plan = ScanPlan(kind, bp, threads, tc, ns, slice_groups, stage, nbuf,
                                    (tiles, ns))
                    if plan.smem_bytes(kp) <= _SCAN_SMEM_MAX:
                        break
                else:
                    continue
                if fits is None:
                    per_sm = min(2048 // threads, 65536 // (128 * threads),
                                 _SCAN_SM_SMEM // (plan.smem_bytes(kp) + 1024))
                    slots = sms * per_sm // ns
                else:
                    slots = fits(kind, bp, kp, threads, tc, ns, stage, plan.nbuf)
                if slots < 1:
                    continue
                if ns == 1:
                    plan = dataclasses.replace(plan, grid=(min(tiles, slots), 1))
                cost = _scan_cost(plan, tiles, slots, table, sms, n_rounds)
                out.append(((max(cost, hbm), cost, ns, threads), plan))
    return out


def _scan_cost(plan: ScanPlan, tiles: int, slots: int, table: int, sms: int,
               n_rounds: int) -> float:
    """plan_scan's clocks for a plan, before the HBM floor: waves × a
    block's time, or the tables' L2 traffic."""
    _, _, lanes, _, _ = scan_layout(plan.kind, plan.bp)
    ns = plan.n_splits
    resident = plan.nbuf == n_rounds
    if ns > 1:
        blocks, waves, block_tiles = tiles * ns, -(-tiles // slots), 1
    else:
        blocks, waves = plan.grid[0], 1
        block_tiles = -(-tiles // blocks)
    waves_clk = plan.slice_groups * plan.tile_cols * lanes / 32 * _SCAN_CONFLICT[lanes]
    share = max(1.0, blocks / waves / sms)  # blocks an SM runs at once
    staged = table / ns * (1 if resident else block_tiles)
    block = _SCAN_BLOCK_CLK + staged / _SCAN_SM_L2_BPC + block_tiles * (
        waves_clk * _SCAN_WAVE_CLK * share + _SCAN_TILE_CLK)
    l2 = (blocks if resident and ns == 1 else tiles) * table / _SCAN_L2_BPC
    return max(waves * block, l2)


def plan_pair(groups: int, d_out_pad: int, kp: int, sms: int, fits=None) -> ScanPlan:
    """A's and M's split (one token's table, rounded to bf16 as staged):
    :func:`plan_scan` at kind 0."""
    return plan_scan(SCAN_PAIR, 1, groups, d_out_pad, kp, sms, fits)


@functools.lru_cache(maxsize=None)
def _scan_fits(kind: int, bp: int, kp: int, threads: int, tile_cols: int, n_splits: int,
               stage_groups: int, nbuf: int) -> int:
    """Clusters (with one split, blocks) of a scan plan the card holds at
    once (the CUDA occupancy query); 0 when one cannot launch."""
    n = _build.library().lutvq_lut_scan_clusters(kind, bp, kp, threads, tile_cols, n_splits,
                                                  stage_groups, nbuf)
    return max(n, 0)


def _run_scan(kind, lut, codes_t, scales, d_out, name, plan=None):
    """``csrc/lut_scan.cu`` over the (B, G, Kp) tables as they are — f32
    (kinds 0, 1), int8 or int16 — in one launch, as :func:`plan_scan`
    splits it (or as ``plan`` does: a sweep of the candidates)."""
    b, g, kp = lut.shape
    g_pad, d_out_pad = codes_t.shape
    kps = (LANE, 2 * LANE)
    tokens = 1 if kind == SCAN_PAIR else MAX_LUT_BATCH
    if not 1 <= b <= tokens:
        raise ValueError(f"{name} kernel takes 1-{tokens} tokens' tables, got {b}")
    if kp not in kps:
        raise ValueError(f"{name} kernel takes Kp in {kps}, got {kp}")
    if g > g_pad or d_out > d_out_pad or d_out_pad % LANE:
        raise ValueError(f"codes_t {tuple(codes_t.shape)} does not cover G={g}, d_out={d_out}")
    tab = lut.contiguous()  # build_lut's and the quantizers' tables already are: no copy
    for t, what, dtype in ((tab, "lut", lut.dtype), (codes_t, "codes_t", torch.uint8)):
        _build.require_cuda_tensor(t, what, dtype)
    if scales is not None:
        _build.require_cuda_tensor(scales, "scales", torch.float32)
    bp = next(t for t in _TOKEN_TILES if t >= b)
    if plan is None:
        plan = plan_scan(kind, bp, g, d_out_pad, kp, _sms(lut.device), _scan_fits)
    out = torch.empty((b, d_out), dtype=torch.float32, device=lut.device)
    lib = _build.library()
    err = lib.lutvq_lut_scan(
        kind, tab.data_ptr(), codes_t.data_ptr(), None if scales is None else scales.data_ptr(),
        out.data_ptr(), b, bp, g, kp, d_out, d_out_pad, plan.threads, plan.tile_cols,
        plan.n_splits, plan.slice_groups, plan.stage_groups, plan.nbuf, plan.grid[0],
        _build.stream_ptr(lut),
    )
    _build.check(lib, err, name)
    return out


@dataclasses.dataclass(frozen=True)
class BpairPlan:
    """How ``csrc/lut_bpair.cu`` covers ``groups`` groups × the padded
    width for B tokens: ``grid`` = (column tiles of ``tile_cols``,
    ``n_splits``, token blocks of ``token_block``), the splits of a tile one
    cluster; split ``q`` takes ``slice_groups`` groups from ``q *
    slice_groups`` in rounds of ``stage_groups``, a thread looking up
    ``stage_groups / row_groups`` of them a round."""

    tile_cols: int
    n_splits: int
    slice_groups: int
    stage_groups: int
    token_block: int
    grid: tuple

    @property
    def row_groups(self) -> int:
        """Thread groups of a block that interleave its split's groups."""
        return BPAIR_SPAN // self.tile_cols

    def split_groups(self, groups: int) -> list:
        return [range(min(groups, q * self.slice_groups),
                      min(groups, (q + 1) * self.slice_groups)) for q in range(self.n_splits)]

    def rounds(self, split: range) -> list:
        return [range(s, min(split.stop, s + self.stage_groups))
                for s in range(split.start, split.stop, self.stage_groups)]


@functools.lru_cache(maxsize=None)
def plan_bpair(groups: int, d_out_pad: int, tokens: int, kp: int, sms: int,
               fits=None) -> BpairPlan:
    """B's split of ``groups`` groups (tables of ``kp`` entries) over
    ``d_out_pad`` columns for ``tokens`` (2-8) tokens on a card of ``sms``
    SMs.  Tokens go in blocks of 2 (two tokens) or 4, along the grid's
    third axis, so each block stages its tokens' tables only; the (column
    tile, splits ≤ BPAIR_MAX_SPLITS) is the one that minimises the larger
    of waves × a block's rounds (each rounding its tables into shared
    memory and looking them up) and the tables' traffic through the L2
    (once per column tile), then the former.  ``fits(token_block,
    tile_cols, n_splits, stage_groups)`` is how many such clusters the card
    holds at once (the wrapper asks the card; by default two blocks an SM,
    ``2 * sms // n_splits``): a cluster that does not fit waits for a second
    wave.  No split is left empty.  Pure."""
    tb = 2 if tokens <= 2 else 4
    zs = -(-tokens // tb)
    best = None
    for tc in BPAIR_TILE_COLS:
        row_groups = BPAIR_SPAN // tc
        per_thread = min(_BPAIR_MAX_PER_THREAD, _BPAIR_STAGE_ENTRIES // (row_groups * kp * tb))
        if per_thread < 1:
            continue
        stage = row_groups * per_thread
        tiles = -(-d_out_pad // tc)
        l2 = tiles * groups * kp * tokens * 4 / _BPAIR_L2_BPC
        for ns in range(1, BPAIR_MAX_SPLITS + 1):
            slice_groups = -(-groups // ns)
            if slice_groups * (ns - 1) >= groups:
                continue
            slots = 2 * sms // ns if fits is None else fits(tb, tc, ns, stage)
            if slots < 1:
                continue
            rnd = min(stage, slice_groups)
            per_round = (rnd * kp * tb * 2 + rnd * tc * tb * 2) / _BPAIR_SMEM_BPC
            # the rounds, then the row-group sums and the tile's share read
            # across the cluster
            block = -(-slice_groups // stage) * (per_round + _BPAIR_ROUND_CLK) + (
                (BPAIR_SPAN + tc) * tb * 4 / _BPAIR_SMEM_BPC)
            share = max(1.0, min(tiles * zs, slots) * ns / sms)  # blocks an SM runs at once
            blocks = -(-tiles * zs // slots) * block * share
            cost = (max(blocks, l2), blocks)  # where the L2 bounds, the shorter blocks
            if best is None or cost < best[0]:
                best = (cost, BpairPlan(tc, ns, slice_groups, stage, tb, (tiles, ns, zs)))
    return best[1]


@functools.lru_cache(maxsize=None)
def _bpair_cluster_fits(token_block: int, tile_cols: int, n_splits: int,
                        stage_groups: int) -> int:
    """Clusters of a B plan the card holds at once (the CUDA occupancy
    query); 0 when one cannot launch."""
    n = _build.library().lutvq_lut_bpair_clusters(token_block, tile_cols, n_splits, stage_groups)
    return max(n, 0)


def _launch_bpair(lut, codes_t, scales, d_out):
    """B over build_lut's (B, G, Kp) f32 tables as they are: the kernel
    rounds the entries to bf16 as it stages them (a bf16 table is widened
    first, exactly)."""
    global LUT_GEMV_BPAIR_LAUNCHES
    b, g, kp = lut.shape
    g_pad, d_out_pad = codes_t.shape
    if not 2 <= b <= MAX_LUT_BATCH or kp not in (LANE, 2 * LANE):
        raise ValueError(f"bpair kernel takes 2-{MAX_LUT_BATCH} tokens' tables of Kp in "
                         f"{(LANE, 2 * LANE)}, got {tuple(lut.shape)}")
    if g > g_pad or d_out > d_out_pad or d_out_pad % LANE:
        raise ValueError(f"codes_t {tuple(codes_t.shape)} does not cover G={g}, d_out={d_out}")
    tab = lut.float().contiguous()
    for t, name, dtype in ((tab, "lut", torch.float32), (codes_t, "codes_t", torch.uint8)):
        _build.require_cuda_tensor(t, name, dtype)
    if scales is not None:
        _build.require_cuda_tensor(scales, "scales", torch.float32)
    plan = plan_bpair(g, d_out_pad, b, kp, _sms(lut.device), _bpair_cluster_fits)
    out = torch.empty((b, d_out), dtype=torch.float32, device=lut.device)
    lib = _build.library()
    err = lib.lutvq_lut_bpair(
        tab.data_ptr(), codes_t.data_ptr(), None if scales is None else scales.data_ptr(),
        out.data_ptr(), b, plan.token_block, g, kp, d_out, d_out_pad, plan.tile_cols,
        plan.n_splits, plan.slice_groups, plan.stage_groups, _build.stream_ptr(lut),
    )
    _build.check(lib, err, "lut_bpair")
    LUT_GEMV_BPAIR_LAUNCHES += 1
    return out


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def lut_lookup_int_plain(
    lut_q: torch.Tensor,
    codes_t: torch.Tensor,
    scales: Optional[torch.Tensor],
    d_out: int,
) -> torch.Tensor:
    """Plain version of the integer-table kernels: ``(B, G, Kp)`` int8 or
    int16 tables → ``(B, d_out)`` f32, the sum exact in int64, then
    ``float(sum) · s[j]``."""
    b, g, _ = lut_q.shape
    idx = codes_t[:g, :d_out].long().unsqueeze(0).expand(b, g, d_out)
    y = torch.gather(lut_q.long(), 2, idx).sum(dim=1).float()
    if scales is not None:
        y = y * scales[:, :d_out]
    return y


def lut_lookup_table(
    lut: torch.Tensor,
    codes_t: torch.Tensor,
    scales: Optional[torch.Tensor],
    d_out: int,
) -> torch.Tensor:
    """The f32/int8/int16-table kernels' wrapper (the entry type picks the
    kernel): plain version for a CPU tensor, the CUDA kernel for a CUDA
    tensor."""
    if lut.device.type == "cpu":
        if lut.dtype == torch.float32:
            return lut_lookup_plain(lut, codes_t, scales, d_out, round_bf16=False)
        return lut_lookup_int_plain(lut, codes_t, scales, d_out)
    return _launch_table(lut, codes_t, scales, d_out)


def lut_lookup_nibbles_plain(
    lut: torch.Tensor,
    codes_t: torch.Tensor,
    scales: Optional[torch.Tensor],
    d_out: int,
) -> torch.Tensor:
    """Plain version of the nibble kernels: ``(B, G, Kp)`` tables (f32, or
    bf16 for ``nibbles_bpair``) and ``(G_pad/2, d_out_pad)`` nibble-packed
    codes → ``(B, d_out)`` f32: the codes unpacked (row 2r the low, 2r+1 the
    high nibbles), the table's entries gathered and summed in f32."""
    b, g, _ = lut.shape
    codes = unpack_codes_nibbles(codes_t[:, :d_out].T).T  # (G_pad, d_out)
    idx = codes[:g].long().unsqueeze(0).expand(b, g, d_out)
    y = torch.gather(lut[..., :NIBBLE_K].float(), 2, idx).sum(dim=1)
    if scales is not None:
        y = y * scales[:, :d_out]
    return y


def lut_lookup_nibbles(
    lut: torch.Tensor,
    codes_t: torch.Tensor,
    scales: Optional[torch.Tensor],
    d_out: int,
) -> torch.Tensor:
    """The nibble kernels' wrapper (the table's type picks the kernel: f32
    → ``nibbles`` (J1), bf16 → ``nibbles_bpair`` (J2)): plain version for a
    CPU tensor, the CUDA kernel for a CUDA tensor."""
    if lut.device.type == "cpu":
        return lut_lookup_nibbles_plain(lut, codes_t, scales, d_out)
    if lut.dtype == torch.bfloat16:
        return _launch_nibbles_bf16(lut, codes_t, scales, d_out)
    return _launch_nibbles_f32(lut, codes_t, scales, d_out)


@dataclasses.dataclass(frozen=True)
class NibblePlan:
    """How ``csrc/lut_nibbles.cu`` (J1 or J2) covers ``rows`` code rows × the padded
    width: ``grid`` = (column tiles of ``tile_cols``, ``n_splits``), the
    splits of a tile one cluster; split ``q`` takes ``slice_rows`` rows from
    ``q * slice_rows`` and stages their tables ``stage_rows`` at a time."""

    tile_cols: int
    n_splits: int
    slice_rows: int
    stage_rows: int
    grid: tuple

    def split_rows(self, rows: int) -> list:
        return [range(min(rows, q * self.slice_rows), min(rows, (q + 1) * self.slice_rows))
                for q in range(self.n_splits)]

    def rounds(self, split: range) -> list:
        return [range(s, min(split.stop, s + self.stage_rows))
                for s in range(split.start, split.stop, self.stage_rows)]


@functools.lru_cache(maxsize=None)
def plan_nibbles(rows: int, d_out_pad: int, bp: int, sms: int, fits=None) -> NibblePlan:
    """J2's split of ``rows`` code rows over ``d_out_pad`` columns for a
    ``bp``-token tile on a card of ``sms`` SMs: the (column tile, splits ≤
    NIBBLE_MAX_SPLITS) that minimises waves × a block's work, counted in
    column lookups per code row plus the staging of that row's tables (~6
    lookups a token).  ``fits(bp, tile_cols, n_splits, stage_rows)`` is how many
    such clusters the card holds at once (the wrapper asks the card; by
    default one block an SM, ``sms // n_splits``): a cluster that does not
    fit waits for a second wave.  No split is left empty.  Pure."""
    stage_cost = 6 * bp
    best = None
    for tc in NIBBLE_TILE_COLS:
        tiles = -(-d_out_pad // tc)
        for ns in range(1, NIBBLE_MAX_SPLITS + 1):
            slice_rows = -(-rows // ns)
            if slice_rows * (ns - 1) >= rows:
                continue
            stage_rows = min(slice_rows, _NIBBLE_STAGE_BYTES // (2 * NIBBLE_K * bp * 2))
            slots = sms // ns if fits is None else fits(bp, tc, ns, stage_rows)
            if slots < 1:
                continue
            cost = -(-tiles // slots) * (tc + stage_cost) * slice_rows
            if best is None or cost < best[0]:
                best = (cost, NibblePlan(tc, ns, slice_rows, stage_rows, (tiles, ns)))
    return best[1]


@functools.lru_cache(maxsize=None)
def plan_nibbles_f32(rows: int, d_out_pad: int, sms: int, fits=None) -> NibblePlan:
    """J1's split (one token's f32 tables): as :func:`plan_nibbles`, but the
    cost also counts a block's fixed cost (its first code loads' latency,
    the cluster barrier and the rank-order sums, ~_F32_BLOCK_LOOKUPS
    lookups) and the blocks that share an SM: a wave of clusters spreads
    over at most ``sms - _F32_IDLE_SMS`` SMs (clusters fill whole GPCs; on
    an H100 a wave was seen on 120-124 of its 132), and blocks past that
    count twice.
    Each code row's tables are 128 bytes; the cluster sizes are
    NIBBLE_F32_SPLITS.  ``fits(1, tile_cols, n_splits, stage_rows)`` as
    for J2.  Pure."""
    usable = max(1, sms - _F32_IDLE_SMS)
    best = None
    for tc in NIBBLE_TILE_COLS:
        tiles = -(-d_out_pad // tc)
        for ns in NIBBLE_F32_SPLITS:
            slice_rows = -(-rows // ns)
            if slice_rows * (ns - 1) >= rows:
                continue
            stage_rows = min(slice_rows, _NIBBLE_STAGE_BYTES // (2 * NIBBLE_K * 4))
            slots = sms // ns if fits is None else fits(1, tc, ns, stage_rows)
            if slots < 1:
                continue
            per_sm = -(-min(tiles, slots) * ns // usable)
            cost = -(-tiles // slots) * ((tc + 6) * slice_rows * per_sm + _F32_BLOCK_LOOKUPS)
            key = (cost, tiles * ns)
            if best is None or key < best[0]:
                best = (key, NibblePlan(tc, ns, slice_rows, stage_rows, (tiles, ns)))
    return best[1]


@functools.lru_cache(maxsize=None)
def _cluster_fits(bp: int, tile_cols: int, n_splits: int, stage_rows: int) -> int:
    """Clusters of a J2 (``bp`` ≥ 2) or J1 (``bp`` 1) plan the card holds at
    once (the CUDA occupancy query); 0 when one cannot launch."""
    lib = _build.library()
    if bp == 1:
        n = lib.lutvq_lut_nibbles_f32_clusters(tile_cols, n_splits, stage_rows)
    else:
        n = lib.lutvq_lut_nibbles_bf16_clusters(bp, tile_cols, n_splits, stage_rows)
    return max(n, 0)


def nibble_table_layout(lut: torch.Tensor, bp: int) -> torch.Tensor:
    """(B, G, 16) bf16 tables as J2 stages them: (G/2 code rows, token
    quads, low/high group, 16 entries, ≤ 4 tokens), tokens padded to ``bp``
    with zero tables and an odd G with a zero group."""
    b, g, _ = lut.shape
    tq = min(bp, 4)
    lut = F.pad(lut[..., :NIBBLE_K], (0, 0, 0, g % 2, 0, bp - b))
    return lut.reshape(bp // tq, tq, -1, 2, NIBBLE_K).permute(2, 0, 3, 4, 1).contiguous()


def _launch_nibbles_bf16(lut, codes_t, scales, d_out):
    global LUT_GEMV_NIBBLES_BPAIR_LAUNCHES
    b, g, kp = lut.shape
    r_pad, d_out_pad = codes_t.shape
    rows = -(-g // 2)
    if not 2 <= b <= MAX_LUT_BATCH or kp < NIBBLE_K:
        raise ValueError(f"nibbles_bpair kernel takes 2-{MAX_LUT_BATCH} tokens' tables of ≥ "
                         f"{NIBBLE_K} entries, got {tuple(lut.shape)}")
    if rows > r_pad or d_out > d_out_pad or d_out_pad % LANE:
        raise ValueError(f"codes_t {tuple(codes_t.shape)} does not cover G={g}, d_out={d_out}")
    bp = next(t for t in _TOKEN_TILES if t >= b)
    tab = nibble_table_layout(lut, bp)
    for t, name, dtype in ((tab, "lut", torch.bfloat16), (codes_t, "codes_t", torch.uint8)):
        _build.require_cuda_tensor(t, name, dtype)
    if scales is not None:
        _build.require_cuda_tensor(scales, "scales", torch.float32)
    plan = plan_nibbles(rows, d_out_pad, bp, _sms(lut.device), _cluster_fits)
    out = torch.empty((b, d_out), dtype=torch.float32, device=lut.device)
    lib = _build.library()
    err = lib.lutvq_lut_nibbles_bf16(
        tab.data_ptr(), codes_t.data_ptr(), None if scales is None else scales.data_ptr(),
        out.data_ptr(), b, bp, rows, d_out, d_out_pad, plan.tile_cols, plan.n_splits,
        plan.slice_rows, plan.stage_rows, _build.stream_ptr(lut),
    )
    _build.check(lib, err, "lut_nibbles_bf16")
    LUT_GEMV_NIBBLES_BPAIR_LAUNCHES += 1
    return out


def _launch_nibbles_f32(lut, codes_t, scales, d_out):
    """J1 over build_lut's (1, G, Kp) f32 table as it is: the kernel stages
    the 16 real entries of each group (and a zero group past an odd G)
    itself, so the call is one launch."""
    global LUT_GEMV_NIBBLES_LAUNCHES
    b, g, kp = lut.shape
    r_pad, d_out_pad = codes_t.shape
    rows = -(-g // 2)
    if b != 1 or kp < NIBBLE_K or kp % 4:
        raise ValueError(f"nibbles kernel takes one token's table of ≥ {NIBBLE_K} entries "
                         f"(a multiple of 4), got {tuple(lut.shape)}")
    if rows > r_pad or d_out > d_out_pad or d_out_pad % LANE:
        raise ValueError(f"codes_t {tuple(codes_t.shape)} does not cover G={g}, d_out={d_out}")
    tab = lut.contiguous()  # build_lut's table already is: no copy
    for t, name, dtype in ((tab, "lut", torch.float32), (codes_t, "codes_t", torch.uint8)):
        _build.require_cuda_tensor(t, name, dtype)
    if scales is not None:
        _build.require_cuda_tensor(scales, "scales", torch.float32)
    plan = plan_nibbles_f32(rows, d_out_pad, _sms(lut.device), _cluster_fits)
    out = torch.empty((1, d_out), dtype=torch.float32, device=lut.device)
    lib = _build.library()
    err = lib.lutvq_lut_nibbles_f32(
        tab.data_ptr(), codes_t.data_ptr(), None if scales is None else scales.data_ptr(),
        out.data_ptr(), g, kp, rows, d_out, d_out_pad, plan.tile_cols, plan.n_splits,
        plan.slice_rows, plan.stage_rows, _build.stream_ptr(lut),
    )
    _build.check(lib, err, "lut_nibbles_f32")
    LUT_GEMV_NIBBLES_LAUNCHES += 1
    return out


def _launch_table(lut, codes_t, scales, d_out):
    if lut.dtype not in _SCAN_KINDS:
        raise ValueError(f"lut_scan kernel takes f32, int8 or int16 tables, got {lut.dtype}")
    kind, counter = _SCAN_KINDS[lut.dtype]
    out = _run_scan(kind, lut, codes_t, scales, d_out, "lut_scan")
    globals()[counter] += 1
    return out


def _lookup(variant: str, lut: torch.Tensor, packed: PackedVQ, plain: bool) -> torch.Tensor:
    """One chunk of ≤ ``MAX_LUT_BATCH`` tokens' f32 tables through the
    lookup of a resolved ``variant`` (``_lut_gemv_packed``'s dispatch)."""
    args = (packed.codes_t, packed.scales, packed.d_out)
    if variant in NIBBLE_VARIANTS:
        # f32 tables at one token, bf16 (the TPU's pair words) from two up
        tab = lut if variant == "nibbles" else lut.to(torch.bfloat16)
        return (lut_lookup_nibbles_plain if plain else lut_lookup_nibbles)(tab, *args)
    if variant == "pairf":
        if lut.shape[0] != 1:
            raise ValueError("pairf is the B=1 in-kernel-pack variant")
        return (lut_lookup_plain if plain else lut_lookup_pairf)(lut, *args)
    if variant in ("i8", "i16"):
        quantize = quantize_lut_int8 if variant == "i8" else quantize_lut_int16
        lut_q, lut_scale = quantize(lut, axis=(1, 2))  # per token
        y = (lut_lookup_int_plain if plain else lut_lookup_table)(lut_q, *args)
        return y * lut_scale[:, 0]  # the per-token table scale, after the sum
    if variant == "f32":
        if plain:
            return lut_lookup_plain(lut, *args, round_bf16=False)
        return lut_lookup_table(lut, *args)
    return (lut_lookup_plain if plain else lut_lookup)(lut, *args)


def _check_k(cfg: VQConfig) -> None:
    if cfg.n_cluster > 2 * LANE:
        raise ValueError(f"lookup kernel supports K ≤ {2 * LANE}; got K={cfg.n_cluster}")


def lut_gemv_packed(
    cfg: VQConfig,
    packed: PackedVQ,
    lut: torch.Tensor,
    *,
    variant: str = "auto",
    plain: bool = False,
) -> torch.Tensor:
    """The lookup over prebuilt tables ``(B, G, Kp)`` f32 → ``(B, d_out)``
    f32, in chunks of ``MAX_LUT_BATCH`` tokens, each with its own resolved
    variant (counterpart of ``_lut_gemv_packed``, ``lut_gemv.py:689``).
    ``G`` may be below the codes' padded group count: groups past it add
    nothing (the JAX package pads the tables with zero rows instead).
    ``i8``/``i16`` quantize each token's tables over (G, Kp), sum the
    integers and multiply by the token's scale.  ``plain=True`` runs the
    plain versions on any device."""
    _check_k(cfg)
    packed = local_view(packed)
    outs = []
    for b0 in range(0, lut.shape[0], MAX_LUT_BATCH):
        chunk = lut[b0 : b0 + MAX_LUT_BATCH]
        v = resolve_variant(variant, nibbles=packed.nibbles, batch=chunk.shape[0],
                            k=cfg.n_cluster)
        outs.append(_lookup(v, chunk, packed, plain))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def lut_gemv(
    cfg: VQConfig,
    packed: PackedVQ,
    x: torch.Tensor,
    *,
    variant: str = "auto",
    plain: bool = False,
) -> torch.Tensor:
    """Fused LUT-VQ matmul: ``(B, d_in) → (B, full_d_out)`` float32.

    Builds each chunk's LUTs as the JAX package does per variant (bf16
    inputs with f32 accumulation for the bf16 and int8 tables, f32 for the
    ``f32``, ``nibbles`` and ``i16`` ones, whose precision a bf16 build would
    throw away) and runs the lookup.  ``plain=True`` runs the plain versions
    on any device — the reference a caller compares the kernel with; the
    default never falls back."""
    _check_k(cfg)
    packed = local_view(packed)
    if packed.out_group > 1:
        return _lut_gemv_out_group(cfg, packed, x, variant, plain)
    outs = []
    for b0 in range(0, x.shape[0], MAX_LUT_BATCH):
        xb = x[b0 : b0 + MAX_LUT_BATCH]
        v = resolve_variant(variant, nibbles=packed.nibbles, batch=xb.shape[0],
                            k=cfg.n_cluster)
        cdt = torch.float32 if v in ("f32", "nibbles", "i16") else torch.bfloat16
        lut = build_lut(cfg, packed.codebook, xb, compute_dtype=cdt)
        outs.append(_lookup(v, lut, packed, plain))
    y = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
    return _apply_zero_points(y, packed, x)


def _lut_gemv_out_group(cfg, packed, x, variant, plain):
    """AQLM ``out_group_size`` (``lut_gemv.py:912-941``): code column o
    selects an (og, d) weight block, so block row r's tables come from
    codebook slice r and the og tables of a token ride as a pseudo-batch
    over the og-times-smaller code array; ``y[b, o·og + r]`` interleaves
    them back.  The variant is resolved at the pseudo-batch's rows."""
    og = packed.out_group
    tokens_per = max(1, MAX_LUT_BATCH // og)
    outs = []
    for b0 in range(0, x.shape[0], tokens_per):
        xb = x[b0 : b0 + tokens_per]
        bc = xb.shape[0]
        v = resolve_variant(variant, batch=bc * og, k=cfg.n_cluster)
        cdt = torch.float32 if v == "f32" else torch.bfloat16
        luts = [build_lut(cfg, packed.codebook[r : r + 1], xb, compute_dtype=cdt)
                for r in range(og)]
        lut = torch.stack(luts, dim=1).reshape(bc * og, *luts[0].shape[1:])
        out = torch.cat([_lookup(v, lut[i : i + MAX_LUT_BATCH], packed, plain)
                         for i in range(0, bc * og, MAX_LUT_BATCH)])
        outs.append(out.reshape(bc, og, -1).transpose(1, 2).reshape(bc, -1))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _apply_zero_points(y: torch.Tensor, packed: PackedVQ, x: torch.Tensor) -> torch.Tensor:
    """Asymmetric-offset epilogue: ``W = s·W_q + z`` ⇒ ``y += z ⊙ Σx``."""
    if packed.zero_points is None:
        return y
    xsum = x.float().sum(-1, keepdim=True)
    return y + xsum * packed.zero_points[:, : y.shape[-1]]
