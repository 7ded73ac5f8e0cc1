"""Fused LUT lookup-accumulate GEMV (counterpart of ``tpu_lutvq.kernels.lut_gemv``).

Semantics: ``y[b, j] = s[j] · Σ_g bf16(lut[b, g, codes_t[g, j]])`` with f32
accumulation — what the JAX package's ``pair`` (B=1) and ``bpair`` (B≥2)
Pallas kernels compute.  On Hopper one hand-written CUDA kernel
(``csrc/lut_gemv.cu``) covers both, for 1 to ``MAX_LUT_BATCH`` tokens per
launch; larger batches are chunked.

:func:`lut_lookup` is the kernel's wrapper: a CUDA tensor launches the
kernel (and counts the launch in ``LUT_GEMV_LAUNCHES``) or raises; a CPU
tensor takes :func:`lut_lookup_plain`, the plain PyTorch version.
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
from tpu_lutvq_torch.kernels.lut_ctor import LANE, build_lut

DEFAULT_BLOCK_J = 1024  # the JAX tiling's output block; sets the padding rule
MAX_LUT_BATCH = 8  # widest token tile of the CUDA kernel
LUT_GEMV_LAUNCHES = 0  # kernel launches since the last reset (see module doc)

_TOKEN_TILES = (1, 2, 4, 8)
_TILE_COLS = 512  # output columns per CUDA block (csrc/lut_gemv.cu kTileCols)


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
    """Resolve "auto" as the JAX package does: ``pair`` at B=1 (``f32`` when
    K ≤ 128, where there are no K halves to pack), ``bpair`` at B ≥ 2."""
    if variant not in ("auto", "pair", "bpair", "f32"):
        raise ValueError(
            f"lut_gemv variant {variant!r} is not ported (auto|pair|bpair|f32)"
        )
    if variant == "auto":
        variant = ("pair" if k > LANE else "f32") if batch == 1 else "bpair"
    if variant == "pair" and k <= LANE:
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


def _launch(lut, codes_t, scales, d_out):
    global LUT_GEMV_LAUNCHES
    b, g, kp = lut.shape
    g_pad, d_out_pad = codes_t.shape
    if b > MAX_LUT_BATCH:
        raise ValueError(f"lut_gemv kernel takes ≤ {MAX_LUT_BATCH} tokens, got {b}")
    if kp not in (LANE, 2 * LANE):
        raise ValueError(f"lut_gemv kernel takes Kp in (128, 256), got {kp}")
    if g > g_pad or d_out > d_out_pad or d_out_pad % LANE:
        raise ValueError(f"codes_t {tuple(codes_t.shape)} does not cover G={g}, d_out={d_out}")
    bp = next(t for t in _TOKEN_TILES if t >= b)
    # bf16 rounding point of the JAX pair packers; (G, Kp, token) layout so
    # one load fetches every token's entry
    tab = lut.to(torch.bfloat16).permute(1, 2, 0)
    tab = F.pad(tab, (0, bp - b)).contiguous()
    _build.require_cuda_tensor(tab, "lut", torch.bfloat16)
    _build.require_cuda_tensor(codes_t, "codes_t", torch.uint8)
    if scales is not None:
        _build.require_cuda_tensor(scales, "scales", torch.float32)
    # about two blocks per SM: split G until column tiles × splits fill the card
    n_tiles = -(-d_out_pad // _TILE_COLS)
    sms = torch.cuda.get_device_properties(lut.device).multi_processor_count
    g_per_split = max(16, math.ceil(g / max(1, math.ceil(2 * sms / n_tiles))))
    n_splits = -(-g // g_per_split)
    ws = torch.empty((n_splits, bp, d_out_pad), dtype=torch.float32, device=lut.device)
    out = torch.empty((b, d_out), dtype=torch.float32, device=lut.device)
    lib = _build.library()
    err = lib.lutvq_lut_gemv(
        tab.data_ptr(), codes_t.data_ptr(),
        None if scales is None else scales.data_ptr(),
        ws.data_ptr(), out.data_ptr(),
        b, bp, g, kp, d_out, d_out_pad, g_per_split, n_splits,
        _build.stream_ptr(lut),
    )
    _build.check(lib, err, "lut_gemv")
    LUT_GEMV_LAUNCHES += 1
    return out


def lut_gemv(
    cfg: VQConfig,
    packed: PackedVQ,
    x: torch.Tensor,
    *,
    variant: str = "auto",
    plain: bool = False,
) -> torch.Tensor:
    """Fused LUT-VQ matmul: ``(B, d_in) → (B, d_out)`` float32.

    Builds each chunk's LUTs (bf16 inputs, f32 accumulation; f32 for the
    ``f32`` variant) and runs the lookup.  ``plain=True`` runs the plain
    versions on any device — the reference a caller compares the kernel
    with; the default never falls back."""
    if cfg.n_cluster > 2 * LANE:
        raise ValueError(f"lookup kernel supports K ≤ {2 * LANE}; got K={cfg.n_cluster}")
    outs = []
    for b0 in range(0, x.shape[0], MAX_LUT_BATCH):
        xb = x[b0 : b0 + MAX_LUT_BATCH]
        v = resolve_variant(variant, batch=xb.shape[0], k=cfg.n_cluster)
        cdt = torch.float32 if v == "f32" else torch.bfloat16
        lut = build_lut(cfg, packed.codebook, xb, compute_dtype=cdt)
        if v == "f32":
            if lut.device.type != "cpu" and not plain:
                raise NotImplementedError(
                    "the f32-table lookup kernel is not ported to CUDA yet"
                )
            y = lut_lookup_plain(lut, packed.codes_t, packed.scales, packed.d_out,
                                 round_bf16=False)
        elif plain:
            y = lut_lookup_plain(lut, packed.codes_t, packed.scales, packed.d_out)
        else:
            y = lut_lookup(lut, packed.codes_t, packed.scales, packed.d_out)
        outs.append(y)
    y = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
    return _apply_zero_points(y, packed, x)


def _apply_zero_points(y: torch.Tensor, packed: PackedVQ, x: torch.Tensor) -> torch.Tensor:
    """Asymmetric-offset epilogue: ``W = s·W_q + z`` ⇒ ``y += z ⊙ Σx``."""
    if packed.zero_points is None:
        return y
    xsum = x.float().sum(-1, keepdim=True)
    return y + xsum * packed.zero_points[:, : y.shape[-1]]
