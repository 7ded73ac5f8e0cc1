"""VQ parameters: codebooks, codes, scales (torch counterpart of
``tpu_lutvq.core.params``).

Randomness comes from an explicit ``torch.Generator``; the numbers differ
from ``jax.random`` for the same seed, so parity tests carry the JAX
package's parameters across with :mod:`tpu_lutvq_torch.utils.convert`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu_lutvq_torch.core.config import VQConfig


def codes_dtype(cfg: VQConfig) -> torch.dtype:
    """Narrowest torch integer dtype that stores indices in [0, K)."""
    if cfg.n_cluster <= 256:
        return torch.uint8
    if cfg.n_cluster <= 65536:
        return torch.uint16
    return torch.int32


class VQParams(NamedTuple):
    """Quantized weight for one linear layer.

    codebook: ``(M_cb, N, K, d)`` float (M_cb=1 when shared across subvectors)
    codes:    ``(d_out, M, N)`` unsigned integer indices
    scales:   optional ``(d_out,)`` per-output-channel scale
    zero_points: optional ``(d_out,)`` asymmetric offset, ``W = s·W_q + z``
    """

    codebook: torch.Tensor
    codes: torch.Tensor
    scales: Optional[torch.Tensor] = None
    zero_points: Optional[torch.Tensor] = None

    @property
    def d_out(self) -> int:
        return self.codes.shape[0]


def tmac_codebook(cfg: VQConfig, dtype=torch.float16, device="cuda") -> torch.Tensor:
    """Bit-serial codebook: entry k of codebook n is the ±1 binary expansion of
    k over d_subvec dims, scaled by 2^n (reference: vq.py:38-50)."""
    k_ids = np.arange(cfg.n_cluster)[:, None]
    bit_ids = np.arange(cfg.d_subvec)[None, :]
    base = ((k_ids >> bit_ids) & 1) * 2 - 1  # (K, d) in {-1, +1}
    cb = np.broadcast_to(
        base[None, None], (cfg.n_subvec, cfg.n_codebook, cfg.n_cluster, cfg.d_subvec)
    ).astype(np.float32)
    scaling = (2.0 ** np.arange(cfg.n_codebook)).reshape(1, -1, 1, 1)
    return torch.as_tensor(cb * scaling, dtype=dtype, device=device)


def init_vq_params(
    generator: torch.Generator,
    cfg: VQConfig,
    d_out: int,
    dtype=torch.float16,
    with_scales: bool = False,
    with_zeros: bool = False,
) -> VQParams:
    """Random VQ parameters on ``generator.device`` (vq.py:38-66)."""
    device = generator.device
    m_cb = 1 if cfg.shared_codebook else cfg.n_subvec
    if cfg.vq_type == "tmac":
        codebook = tmac_codebook(cfg, dtype, device)
        if cfg.shared_codebook:
            codebook = codebook[:1]
    else:
        codebook = torch.randn(
            (m_cb, cfg.n_codebook, cfg.n_cluster, cfg.d_subvec),
            generator=generator, device=device, dtype=torch.float32,
        ).to(dtype)
    codes = torch.randint(
        0, cfg.n_cluster, (d_out, cfg.n_subvec, cfg.n_codebook),
        generator=generator, device=device, dtype=torch.int32,
    ).to(codes_dtype(cfg))
    scales = None
    if with_scales:
        noise = torch.randn((d_out,), generator=generator, device=device)
        scales = (1.0 + 0.1 * noise).to(dtype)
    zeros = None
    if with_zeros:
        noise = torch.randn((d_out,), generator=generator, device=device)
        zeros = (0.05 * noise).to(dtype)
    return VQParams(codebook=codebook, codes=codes, scales=scales, zero_points=zeros)


def div_scalar(t: torch.Tensor, divisor: float) -> torch.Tensor:
    """``t / divisor`` as IEEE division on every device, as the JAX package
    divides: torch's CUDA kernels multiply by the reciprocal when the
    divisor is a Python number, which can round one bit away, so the
    divisor goes in as a tensor on ``t``'s device (made once: no fill
    kernel a call)."""
    return t / _scalar_tensor(divisor, t.dtype, t.device)


@functools.lru_cache(maxsize=None)
def _scalar_tensor(value: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=device)


def broadcast_codebook(cfg: VQConfig, codebook: torch.Tensor) -> torch.Tensor:
    """Expand a shared ``(1, N, K, d)`` codebook to ``(M, N, K, d)`` (a view)."""
    if codebook.shape[0] == cfg.n_subvec:
        return codebook
    return codebook.expand((cfg.n_subvec,) + tuple(codebook.shape[1:]))


def pack_codes_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Pack 4-bit codes pairwise along the last axis into uint8 (the T-MAC
    storage layout): ``(..., 2L)`` values in ``[0, 16)`` → ``(..., L)``, the
    even index in the low nibble."""
    lo = codes[..., 0::2].to(torch.uint8)
    hi = codes[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack_codes_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_codes_nibbles`."""
    lo = packed & 0xF
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)
