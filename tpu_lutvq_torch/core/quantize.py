"""Fit VQ parameters to a dense weight matrix (counterpart of
``tpu_lutvq.core.quantize``).

Additive-codebook fitting: a residual k-means initialization, then
alternating minimization (nearest-entry assignment of each codebook against
the residual the others leave, then the codebook as its assigned samples'
means), with optional per-output scales and zero points.  All randomness
comes from an explicit ``torch.Generator`` (the port's ``ann.kmeans``); its
numbers differ from ``jax.random``'s, so the two packages fit different but
equally good codebooks from one seed.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_lutvq_torch.ann.kmeans import _assign, _update, kmeans
from tpu_lutvq_torch.core.config import VQConfig, aqlm_2x8
from tpu_lutvq_torch.core.params import VQParams, codes_dtype


def _residual(cbs, codes, skip, x):
    """``x − Σ_{j ≠ skip} cbs[j][codes[j]]``."""
    out = x
    for j, (cb, c) in enumerate(zip(cbs, codes)):
        if j != skip:
            out = out - cb[c]
    return out


def fit_vq(
    generator: torch.Generator,
    w: torch.Tensor,
    cfg: VQConfig,
    iters: int = 8,
    kmeans_iters: int = 15,
    with_scales: bool = True,
    init_codes: Optional[torch.Tensor] = None,
    with_zero_points: bool = False,
) -> VQParams:
    """Quantize ``w (d_out, d_in)`` into codes and shared codebooks under
    ``cfg`` (AQLM semantics), on ``w``'s device.

    ``init_codes (d_out·M, N)`` warm-starts the alternating loop from a
    given assignment (codebooks solved as conditional means) instead of the
    residual k-means init — the 1x16 → 2x8 refit's second candidate."""
    d_out, d_in = w.shape
    assert d_in == cfg.d_in, (d_in, cfg.d_in)
    m, n, k, g = cfg.n_subvec, cfg.n_codebook, cfg.n_cluster, cfg.d_subvec
    w = w.float()
    zero_points = None
    if with_zero_points:
        zero_points = w.mean(dim=1)
        w = w - zero_points[:, None]
    x = w.reshape(d_out * m, g)  # subvector samples

    if init_codes is not None:
        codes = [init_codes[:, nn].long() for nn in range(n)]
        cbs = [torch.zeros((k, g), device=w.device) for _ in range(n)]
        for nn in range(n):
            cbs[nn] = _update(_residual(cbs, codes, nn, x), codes[nn], k)[0]
    else:
        cbs, codes, resid = [], [], x
        for _ in range(n):
            cb, a = kmeans(generator, resid, k, kmeans_iters)
            cbs.append(cb)
            codes.append(a)
            resid = resid - cb[a]

    for _ in range(iters):
        for nn in range(n):
            target = _residual(cbs, codes, nn, x)
            codes[nn] = _assign(target, cbs[nn])
            cbs[nn] = _update(target, codes[nn], k)[0]

    codebook = torch.stack(cbs)[None]  # (1, N, K, g) shared
    codes_arr = torch.stack(codes, dim=-1).reshape(d_out, m, n).to(codes_dtype(cfg))
    scales = None
    if with_scales:
        recon = sum(cbs[nn][codes[nn]] for nn in range(n)).reshape(d_out, d_in)
        num = (recon * w).sum(dim=1)
        den = (recon * recon).sum(dim=1).clamp_min(1e-20)
        scales = num / den
    return VQParams(codebook=codebook, codes=codes_arr, scales=scales,
                    zero_points=zero_points)


def refit_to_2x8(
    generator: torch.Generator,
    w: torch.Tensor,
    codes_1x16: Optional[torch.Tensor] = None,
    group: int = 8,
    iters: int = 8,
) -> tuple[VQConfig, VQParams, float]:
    """Re-fit a dequantized weight to AQLM **2x8** at the same code bytes as
    1x16, so that it runs through the lookup kernels.  Two candidates, the
    lower-error one kept: residual k-means, and the hi/lo bytes of the
    16-bit codes as the initial assignment (exact whenever the 1x16
    codebook decomposes as ``C[k] = C_hi[k >> 8] + C_lo[k & 255]``).
    Returns ``(cfg2, params2, relative Frobenius error)``."""
    d_out, d_in = w.shape
    cfg2 = aqlm_2x8(d_in, group=group, shared_codebook=True)
    candidates = [fit_vq(generator, w, cfg2, iters=iters)]
    if codes_1x16 is not None:
        c = codes_1x16.reshape(-1).long()
        split = torch.stack([(c >> 8) & 0xFF, c & 0xFF], dim=-1)
        candidates.append(fit_vq(generator, w, cfg2, iters=iters, init_codes=split))
    errs = [quantization_error(cfg2, p, w) for p in candidates]
    best = min(range(len(errs)), key=errs.__getitem__)
    return cfg2, candidates[best], errs[best]


def quantization_error(cfg: VQConfig, params: VQParams, w: torch.Tensor) -> float:
    """Relative Frobenius reconstruction error ``||W − Ŵ|| / ||W||``."""
    from tpu_lutvq_torch.core.golden import dequantize

    wf = w.float()
    return float(torch.linalg.norm(dequantize(cfg, params) - wf)
                 / torch.linalg.norm(wf).clamp_min(1e-20))
