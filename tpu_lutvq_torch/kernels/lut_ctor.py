"""LUT construction (the "activation → lookup table" phase), counterpart of
``tpu_lutvq.kernels.lut_ctor.build_lut``.

A small contraction per subvector; the JAX package leaves it to XLA and the
port leaves it to ``torch.einsum``.  Inputs are rounded to ``compute_dtype``
and the product is taken in float32, which is the JAX
``preferred_element_type=float32`` contraction: products of bf16 values are
exact in f32, and the sum runs in f32.
"""

from __future__ import annotations

import torch

from tpu_lutvq_torch.core.config import VQConfig
from tpu_lutvq_torch.core.params import broadcast_codebook, div_scalar

LANE = 128  # table width the JAX kernels pad to; kept so both packages agree


def build_lut(
    cfg: VQConfig,
    codebook: torch.Tensor,
    x: torch.Tensor,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Per-token LUTs ``(B, G, Kp)`` float32, groups n-major (``g = n·M + m``),
    ``Kp = max(K, 128)``:

    ``lut[b, n·M+m, k] = Σ_d codebook[m,n,k,d] · x[b, m·d_sub + d]``.
    """
    b = x.shape[0]
    xr = x.reshape(b, cfg.n_subvec, cfg.d_subvec).to(compute_dtype).float()
    if codebook.shape[0] == 1 and cfg.n_subvec > 1:
        # shared codebook: one (N·K, d) × (d, B·M) contraction, no broadcast
        cb = codebook[0].to(compute_dtype).float()
        lut = torch.einsum("nkd,bmd->bnmk", cb, xr)
    else:
        cb = broadcast_codebook(cfg, codebook).to(compute_dtype).float()
        lut = torch.einsum("mnkd,bmd->bnmk", cb, xr)
    lut = lut.reshape(b, cfg.n_groups, cfg.n_cluster)
    if cfg.n_cluster < LANE:
        lut = torch.nn.functional.pad(lut, (0, LANE - cfg.n_cluster))
    return lut


def _quantize_lut(lut: torch.Tensor, axis, qmax: float, dtype: torch.dtype):
    absmax = lut.abs().amax(dim=axis, keepdim=True)
    scale = div_scalar(absmax.clamp_min(1e-30), qmax)
    # a division, as the JAX package takes it (a reciprocal multiply can
    # round differently); torch.round rounds half to even like jnp.round
    lut_q = torch.round(lut / scale).clamp(-qmax, qmax).to(dtype)
    return lut_q, scale


def quantize_lut_int8(lut: torch.Tensor, axis=-1) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 range quantization of a LUT: ``(lut_q int8,
    scale f32)`` with ``lut ≈ lut_q * scale``, the scale ``absmax / 127``
    over ``axis`` (the reference's QuantizerMAX; bit for bit the JAX
    package's ``quantize_lut_int8``)."""
    return _quantize_lut(lut, axis, 127.0, torch.int8)


def quantize_lut_int16(lut: torch.Tensor, axis=-1) -> tuple[torch.Tensor, torch.Tensor]:
    """The int16 tier of :func:`quantize_lut_int8` (scale ``absmax /
    32767``): ~15 bits of table precision where int8's 7 saturate."""
    return _quantize_lut(lut, axis, 32767.0, torch.int16)
