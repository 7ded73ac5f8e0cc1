"""Pure-torch golden model for LUT-VQ GEMM (counterpart of
``tpu_lutvq.core.golden``): the f32 oracle every kernel is held against
(reference: vq_dataflow_sim/vq.py:269-307).  Written for clarity, not speed.
"""

from __future__ import annotations

import torch

from tpu_lutvq_torch.core.config import VQConfig
from tpu_lutvq_torch.core.params import VQParams, broadcast_codebook


def _gather_rows(cfg: VQConfig, codebook: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``cb[m, n, codes[j, m, n], :]`` → ``(d_out, M, N, d)``."""
    cb = broadcast_codebook(cfg, codebook)  # (M, N, K, d)
    m_idx = torch.arange(cfg.n_subvec, device=codes.device)[None, :, None]
    n_idx = torch.arange(cfg.n_codebook, device=codes.device)[None, None, :]
    return cb[m_idx, n_idx, codes.long()]


def dequantize(cfg: VQConfig, params: VQParams, dtype=torch.float32) -> torch.Tensor:
    """Dense weight ``W (d_out, d_in)``: ``W[j, m·d:(m+1)·d] = Σ_n
    codebook[m, n, codes[j,m,n], :]`` (vq.py:269-278), then per-row scale and
    zero point.  A pure lookup, so it equals the JAX golden bit for bit."""
    w = _gather_rows(cfg, params.codebook, params.codes).to(dtype).sum(dim=2)
    w = w.reshape(params.d_out, cfg.d_in)
    if params.scales is not None:
        w = w * params.scales.to(dtype)[:, None]
    if params.zero_points is not None:
        w = w + params.zero_points.to(dtype)[:, None]
    return w


def compute_lut(cfg: VQConfig, codebook: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``lut[b, m, n, k] = Σ_d codebook[m, n, k, d] · x[b, m·d+d]`` (vq.py:280-285).

    x: ``(B, d_in)`` → ``(B, M, N, K)`` float32.
    """
    cb = broadcast_codebook(cfg, codebook).float()
    xr = x.reshape(x.shape[0], cfg.n_subvec, cfg.d_subvec).float()
    return torch.einsum("mnkd,bmd->bmnk", cb, xr)


def lut_gemm(cfg: VQConfig, params: VQParams, x: torch.Tensor) -> torch.Tensor:
    """``y[b, j] = Σ_m Σ_n lut[b, m, n, codes[j,m,n]]`` (vq.py:287-302).

    x: ``(B, d_in)`` → ``(B, d_out)`` float32.
    """
    b = x.shape[0]
    lut = compute_lut(cfg, params.codebook, x).reshape(b, cfg.n_groups, cfg.n_cluster)
    codes_gt = params.codes.reshape(params.d_out, cfg.n_groups).T.long()  # (G, O)
    picked = torch.gather(lut, 2, codes_gt.unsqueeze(0).expand(b, -1, -1))
    out = picked.sum(dim=1)
    if params.scales is not None:
        out = out * params.scales.to(out.dtype)[None, :]
    if params.zero_points is not None:
        out = out + x.to(out.dtype).sum(-1, keepdim=True) * (
            params.zero_points.to(out.dtype)[None, :]
        )
    return out


def fp_gemm(cfg: VQConfig, params: VQParams, x: torch.Tensor) -> torch.Tensor:
    """Dense golden GEMM on the dequantized weight (vq.py:304-307)."""
    return x.float() @ dequantize(cfg, params).T
