"""Fused dequant-matmul (counterpart of ``tpu_lutvq.kernels.dequant_mm``,
``tables="bf16x2"``): ``Y = X · Wᵀ · diag(s)`` with W rebuilt from codes and
the bf16 codebook, never written to device memory.

Rounding points, as in the JAX kernel (``dequant_mm.py:264-277, 726-734``):
x and every codebook entry are rounded to bf16, each codebook's entry is
contracted against x on its own, and everything sums in f32 — the sum of
the N codebook entries is never rounded to bf16.

:func:`dequant_mm_bf16x2` is the kernel's wrapper: a CUDA tensor launches
``csrc/dequant_mm.cu`` (counted in ``DEQUANT_MM_LAUNCHES``) or raises; a CPU
tensor takes :func:`dequant_mm_plain`, the plain PyTorch version.
"""

from __future__ import annotations

import torch

from tpu_lutvq_torch.core.config import VQConfig
from tpu_lutvq_torch.core.params import broadcast_codebook
from tpu_lutvq_torch.kernels import _build
from tpu_lutvq_torch.kernels.lut_gemv import PackedVQ, _apply_zero_points

DEQUANT_MM_LAUNCHES = 0  # kernel launches since the last reset (see module doc)

_KERNEL_D_SUBVEC = 8  # csrc/dequant_mm.cu rebuilds 16-byte (8 × bf16) rows
_KERNEL_MAX_CODEBOOKS = 2


def dequant_weight(cfg: VQConfig, packed: PackedVQ) -> torch.Tensor:
    """The plain version's weight, ``W = Σ_n float(bf16(cb_n))`` summed in
    f32, without scales: ``(d_out, d_in)`` float32."""
    m, n, d_out = cfg.n_subvec, cfg.n_codebook, packed.d_out
    cb = broadcast_codebook(cfg, packed.codebook).to(torch.bfloat16).float()
    codes = packed.codes_t[: cfg.n_groups, :d_out].long().reshape(n, m, d_out)
    m_idx = torch.arange(m, device=codes.device)[:, None]
    w = cb[m_idx, 0, codes[0]]  # (M, d_out, d)
    for nn in range(1, n):
        w = w + cb[m_idx, nn, codes[nn]]
    return w.permute(1, 0, 2).reshape(d_out, cfg.d_in)


def dequant_mm_plain(cfg: VQConfig, packed: PackedVQ, x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``float(bf16(x)) @ Wᵀ`` in f32 with :func:`dequant_weight`,
    times the scales.  ``(B, d_in) → (B, d_out)``."""
    y = x.to(torch.bfloat16).float() @ dequant_weight(cfg, packed).T
    if packed.scales is not None:
        y = y * packed.scales[:, : packed.d_out]
    return y


def dequant_mm_bf16x2(cfg: VQConfig, packed: PackedVQ, x: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: plain version for a CPU tensor, the CUDA kernel
    for a CUDA tensor."""
    if x.device.type == "cpu":
        return dequant_mm_plain(cfg, packed, x)
    return _launch(cfg, packed, x)


def _launch(cfg: VQConfig, packed: PackedVQ, x: torch.Tensor) -> torch.Tensor:
    global DEQUANT_MM_LAUNCHES
    if cfg.d_subvec != _KERNEL_D_SUBVEC or cfg.n_codebook > _KERNEL_MAX_CODEBOOKS:
        raise ValueError(
            f"dequant_mm kernel takes d_subvec={_KERNEL_D_SUBVEC} and ≤ "
            f"{_KERNEL_MAX_CODEBOOKS} codebooks; got {cfg}"
        )
    g_pad, d_out_pad = packed.codes_t.shape
    if g_pad < cfg.n_groups or d_out_pad < packed.d_out:
        raise ValueError(f"codes_t {tuple(packed.codes_t.shape)} does not cover {cfg}")
    r = x.shape[0]
    out = torch.empty((r, packed.d_out), dtype=torch.float32, device=x.device)
    if r == 0:
        return out
    xb = x.to(torch.bfloat16).contiguous()
    cb = packed.codebook.to(torch.bfloat16).contiguous()  # (M_cb, N, K, d)
    _build.require_cuda_tensor(xb, "x", torch.bfloat16)
    _build.require_cuda_tensor(cb, "codebook", torch.bfloat16)
    _build.require_cuda_tensor(packed.codes_t, "codes_t", torch.uint8)
    if packed.scales is not None:
        _build.require_cuda_tensor(packed.scales, "scales", torch.float32)
    lib = _build.library()
    err = lib.lutvq_dequant_mm(
        xb.data_ptr(), packed.codes_t.data_ptr(), cb.data_ptr(),
        None if packed.scales is None else packed.scales.data_ptr(),
        out.data_ptr(), r, cfg.n_subvec, cfg.n_codebook, cfg.n_cluster,
        int(cb.shape[0] == 1), packed.d_out, d_out_pad, _build.stream_ptr(x),
    )
    _build.check(lib, err, "dequant_mm")
    DEQUANT_MM_LAUNCHES += 1
    return out


def dequant_matmul(
    cfg: VQConfig,
    packed: PackedVQ,
    x: torch.Tensor,
    *,
    tables: str = "bf16x2",
    plain: bool = False,
) -> torch.Tensor:
    """Batched fused dequant-matmul: ``(B, d_in) → (B, d_out)`` float32.

    Only the serving tables (``bf16x2``) are ported; ``plain=True`` runs the
    plain version on any device, for comparison with the kernel."""
    if tables != "bf16x2":
        raise NotImplementedError(f"dequant_matmul tables={tables!r} is not ported")
    if cfg.n_cluster > 256:
        raise ValueError("dequant_matmul supports K ≤ 256")
    if cfg.d_subvec % 2:
        raise NotImplementedError("odd d_subvec needs the f32 tables, not ported")
    y = dequant_mm_plain(cfg, packed, x) if plain else dequant_mm_bf16x2(cfg, packed, x)
    return _apply_zero_points(y, packed, x)
