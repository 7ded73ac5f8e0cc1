"""Fused LUT lookup-accumulate GEMV (counterpart of ``tpu_lutvq.kernels.lut_gemv``).

Semantics: ``y[b, j] = s[j] · Σ_g lut[b, g, codes_t[g, j]]``, in four
flavours of table, each a hand-written CUDA kernel for 1 to
``MAX_LUT_BATCH`` tokens per launch (larger batches are chunked):

- ``pair``/``bpair`` (B=1 / B≥2): bf16 entries, f32 sum —
  ``csrc/lut_gemv.cu``, wrapper :func:`lut_lookup`, counter
  ``LUT_GEMV_LAUNCHES``;
- ``pairf`` (B=1): ``pair`` with the f32 table rounded to bf16 inside the
  kernel — the same source, wrapper :func:`lut_lookup_pairf`, counter
  ``LUT_GEMV_PAIRF_LAUNCHES``;
- ``f32``: f32 entries, f32 sum — ``csrc/lut_scan.cu``, wrapper
  :func:`lut_lookup_table`, counter ``LUT_GEMV_F32_LAUNCHES``;
- ``i8``/``i16``: per-token range-quantized int8/int16 entries, exact
  integer sum, then the token's table scale — the same source and wrapper,
  counters ``LUT_GEMV_I8_LAUNCHES``/``LUT_GEMV_I16_LAUNCHES``.

A wrapper launches its kernel for a CUDA tensor (and counts the launch) or
raises; a CPU tensor takes the plain PyTorch version
(:func:`lut_lookup_plain`, :func:`lut_lookup_int_plain`).
:func:`lut_gemv_packed` runs the lookup over prebuilt tables (the ANN scan),
:func:`lut_gemv` builds the tables from activations first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from tpu_lutvq_torch.core.config import VQConfig
from tpu_lutvq_torch.core.params import VQParams
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
LUT_GEMV_LAUNCHES = 0  # bf16 tables (pair, bpair)
LUT_GEMV_PAIRF_LAUNCHES = 0  # f32 tables rounded to bf16 in the kernel
LUT_GEMV_F32_LAUNCHES = 0
LUT_GEMV_I8_LAUNCHES = 0
LUT_GEMV_I16_LAUNCHES = 0

_TOKEN_TILES = (1, 2, 4, 8)
_TILE_COLS = 512  # output columns per CUDA block (csrc/lut_gemv.cu kTileCols)
_SCAN_TILE_COLS = 1024  # csrc/lut_scan.cu kTileCols
_SCAN_STAGE_BYTES = 128 * 1024  # staged table slice per block (f32 G=16 K=256 B=8)
_SM_SHARED_BYTES = 228 * 1024  # an H100 SM's shared memory, 1 KiB of it per block reserved
# entry type → (kernel kind in csrc/lut_scan.cu, its launch counter)
_SCAN_KINDS = {
    torch.float32: (0, "LUT_GEMV_F32_LAUNCHES"),
    torch.int8: (1, "LUT_GEMV_I8_LAUNCHES"),
    torch.int16: (2, "LUT_GEMV_I16_LAUNCHES"),
}
VARIANTS = ("auto", "pair", "pairf", "bpair", "f32", "i8", "i16")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass
class PackedVQ:
    """Kernel-facing parameter layout, prepared once at load time.

    codes_t:  ``(G_pad, d_out_pad)`` uint8 — transposed, padded codes in
              n-major group order (``g = n·M + m``, matching build_lut).
    codebook: original ``(M_cb, N, K, d)`` float codebook (for LUT build).
    scales:   ``(1, d_out_pad)`` float32 or None.
    d_out:    logical output dim (≤ d_out_pad).
    zero_points: ``(1, d_out_pad)`` float32 or None (``W = s·W_q + z``).
    """

    codes_t: torch.Tensor
    codebook: torch.Tensor
    scales: Optional[torch.Tensor]
    d_out: int
    zero_points: Optional[torch.Tensor] = None


def pack_params(cfg: VQConfig, params: VQParams) -> PackedVQ:
    """Transpose codes to ``(G, d_out)`` (n-major groups) and pad: groups to a
    multiple of 8, outputs to a multiple of 128 and, past 1024, to a multiple
    of 1024 — the JAX package's layout (``lut_gemv.py:163-209``, one shard,
    default block), so both packages consume the same arrays."""
    d_out = params.codes.shape[0]
    if cfg.n_cluster > 256:
        raise ValueError(
            f"pack_params stores uint8 codes; K={cfg.n_cluster} > 256 is not served"
        )
    g_pad = _round_up(cfg.n_groups, 8)
    d_out_pad = _round_up(d_out, LANE)
    if d_out_pad > DEFAULT_BLOCK_J and d_out_pad % DEFAULT_BLOCK_J:
        d_out_pad = _round_up(d_out_pad, DEFAULT_BLOCK_J)
    # (d_out, M, N) -> n-major (N, M, d_out) -> (G, d_out)
    codes_t = params.codes.permute(2, 1, 0).reshape(cfg.n_groups, d_out).to(torch.uint8)
    codes_t = F.pad(codes_t, (0, d_out_pad - d_out, 0, g_pad - cfg.n_groups))

    def row(v, fill):
        if v is None:
            return None
        return F.pad(v.float().reshape(1, d_out), (0, d_out_pad - d_out), value=fill)

    return PackedVQ(
        codes_t=codes_t.contiguous(),
        codebook=params.codebook,
        scales=row(params.scales, 1.0),
        d_out=d_out,
        zero_points=row(params.zero_points, 0.0),
    )


def resolve_variant(variant: str, *, batch: int, k: int) -> str:
    """Resolve "auto" as the JAX package does (``lut_gemv.py:239-247``):
    ``pair`` at B=1, ``bpair`` at B ≥ 2; ``pair`` and ``pairf`` at K ≤ 128,
    where there are no K halves to pack, become ``f32``."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown lut_gemv variant {variant!r} ({'|'.join(VARIANTS)})")
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


def _prepare(lut, codes_t, scales, d_out, tile_cols, name):
    """What both lookup kernels check and take: the table in (G, Kp, token)
    layout, tokens padded to the kernel's tile, so that one load fetches
    every token's entry; and G split until column tiles × splits fill the
    card twice over.  Returns (table, token tile, SMs, column tiles, groups
    per split, splits)."""
    b, g, kp = lut.shape
    g_pad, d_out_pad = codes_t.shape
    if b > MAX_LUT_BATCH:
        raise ValueError(f"{name} kernel takes ≤ {MAX_LUT_BATCH} tokens, got {b}")
    if kp not in (LANE, 2 * LANE):
        raise ValueError(f"{name} kernel takes Kp in (128, 256), got {kp}")
    if g > g_pad or d_out > d_out_pad or d_out_pad % LANE:
        raise ValueError(f"codes_t {tuple(codes_t.shape)} does not cover G={g}, d_out={d_out}")
    bp = next(t for t in _TOKEN_TILES if t >= b)
    tab = lut.permute(1, 2, 0)  # at B=1 already (G, Kp, 1) in memory: no copy
    if bp > b:
        tab = F.pad(tab, (0, bp - b))
    tab = tab.contiguous()
    _build.require_cuda_tensor(tab, "lut", lut.dtype)
    _build.require_cuda_tensor(codes_t, "codes_t", torch.uint8)
    if scales is not None:
        _build.require_cuda_tensor(scales, "scales", torch.float32)
    n_tiles = -(-d_out_pad // tile_cols)
    sms = torch.cuda.get_device_properties(lut.device).multi_processor_count
    g_per_split = max(16, math.ceil(g / max(1, math.ceil(2 * sms / n_tiles))))
    return tab, bp, sms, n_tiles, g_per_split, -(-g // g_per_split)


def _launch(lut, codes_t, scales, d_out):
    global LUT_GEMV_LAUNCHES
    # bf16: the rounding point of the JAX pair packers
    out = _run_lut_gemv(lut.to(torch.bfloat16), codes_t, scales, d_out)
    LUT_GEMV_LAUNCHES += 1
    return out


def _launch_pairf(lut, codes_t, scales, d_out):
    global LUT_GEMV_PAIRF_LAUNCHES
    if lut.shape[0] != 1 or lut.dtype != torch.float32:
        raise ValueError(f"pairf kernel takes one token's f32 table, got "
                         f"{tuple(lut.shape)} {lut.dtype}")
    out = _run_lut_gemv(lut, codes_t, scales, d_out)
    LUT_GEMV_PAIRF_LAUNCHES += 1
    return out


def _run_lut_gemv(lut, codes_t, scales, d_out):
    """``csrc/lut_gemv.cu`` over a bf16 table, or an f32 one (``pairf``)
    that the kernel rounds to bf16 as it stages it."""
    b, g, kp = lut.shape
    d_out_pad = codes_t.shape[1]
    tab, bp, _, _, g_per_split, n_splits = _prepare(
        lut, codes_t, scales, d_out, _TILE_COLS, "lut_gemv")
    ws = torch.empty((n_splits, bp, d_out_pad), dtype=torch.float32, device=lut.device)
    out = torch.empty((b, d_out), dtype=torch.float32, device=lut.device)
    lib = _build.library()
    err = lib.lutvq_lut_gemv(
        tab.data_ptr(), codes_t.data_ptr(),
        None if scales is None else scales.data_ptr(),
        ws.data_ptr(), out.data_ptr(),
        b, bp, g, kp, d_out, d_out_pad, g_per_split, n_splits,
        int(lut.dtype == torch.float32), _build.stream_ptr(lut),
    )
    _build.check(lib, err, "lut_gemv")
    return out


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


def _launch_table(lut, codes_t, scales, d_out):
    if lut.dtype not in _SCAN_KINDS:
        raise ValueError(f"lut_scan kernel takes f32, int8 or int16 tables, got {lut.dtype}")
    kind, counter = _SCAN_KINDS[lut.dtype]
    b, g, kp = lut.shape
    d_out_pad = codes_t.shape[1]
    tab, bp, sms, n_tiles, g_per_split, n_splits = _prepare(
        lut, codes_t, scales, d_out, _SCAN_TILE_COLS, "lut_scan")
    # the whole G-slice staged once when it fits; blocks per SM as many as
    # the shared memory holds, and no more than there are column tiles
    row_bytes = kp * bp * tab.element_size()
    stage_groups = min(g_per_split, _SCAN_STAGE_BYTES // row_bytes)
    per_sm = max(1, min(8, _SM_SHARED_BYTES // (stage_groups * row_bytes + 1024)))
    grid_x = min(n_tiles, per_sm * sms)
    ws = None
    if n_splits > 1:
        acc = torch.float32 if lut.dtype == torch.float32 else torch.int32
        ws = torch.empty((n_splits, bp, d_out_pad), dtype=acc, device=lut.device)
    out = torch.empty((b, d_out), dtype=torch.float32, device=lut.device)
    lib = _build.library()
    err = lib.lutvq_lut_scan(
        kind, tab.data_ptr(), codes_t.data_ptr(),
        None if scales is None else scales.data_ptr(),
        None if ws is None else ws.data_ptr(), out.data_ptr(),
        b, bp, g, kp, d_out, d_out_pad, g_per_split, n_splits, stage_groups, grid_x,
        _build.stream_ptr(lut),
    )
    _build.check(lib, err, "lut_scan")
    globals()[counter] += 1
    return out


def _lookup(variant: str, lut: torch.Tensor, packed: PackedVQ, plain: bool) -> torch.Tensor:
    """One chunk of ≤ ``MAX_LUT_BATCH`` tokens' f32 tables through the
    lookup of a resolved ``variant`` (``_lut_gemv_packed``'s dispatch)."""
    args = (packed.codes_t, packed.scales, packed.d_out)
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
    if cfg.n_cluster > 2 * LANE:
        raise ValueError(f"lookup kernel supports K ≤ {2 * LANE}; got K={cfg.n_cluster}")
    outs = []
    for b0 in range(0, lut.shape[0], MAX_LUT_BATCH):
        chunk = lut[b0 : b0 + MAX_LUT_BATCH]
        v = resolve_variant(variant, batch=chunk.shape[0], k=cfg.n_cluster)
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
    """Fused LUT-VQ matmul: ``(B, d_in) → (B, d_out)`` float32.

    Builds each chunk's LUTs as the JAX package does per variant (bf16
    inputs with f32 accumulation for the bf16 and int8 tables, f32 for the
    ``f32`` and ``i16`` ones, whose precision a bf16 build would throw away)
    and runs the lookup.  ``plain=True`` runs the plain versions on any
    device — the reference a caller compares the kernel with; the default
    never falls back."""
    if cfg.n_cluster > 2 * LANE:
        raise ValueError(f"lookup kernel supports K ≤ {2 * LANE}; got K={cfg.n_cluster}")
    outs = []
    for b0 in range(0, x.shape[0], MAX_LUT_BATCH):
        xb = x[b0 : b0 + MAX_LUT_BATCH]
        v = resolve_variant(variant, batch=xb.shape[0], k=cfg.n_cluster)
        cdt = torch.float32 if v in ("f32", "i16") else torch.bfloat16
        lut = build_lut(cfg, packed.codebook, xb, compute_dtype=cdt)
        outs.append(_lookup(v, lut, packed, plain))
    y = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
    return _apply_zero_points(y, packed, x)


def _apply_zero_points(y: torch.Tensor, packed: PackedVQ, x: torch.Tensor) -> torch.Tensor:
    """Asymmetric-offset epilogue: ``W = s·W_q + z`` ⇒ ``y += z ⊙ Σx``."""
    if packed.zero_points is None:
        return y
    xsum = x.float().sum(-1, keepdim=True)
    return y + xsum * packed.zero_points[:, : y.shape[-1]]
