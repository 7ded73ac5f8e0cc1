"""Host-side layout helpers of the checkpoint loader, in numpy (the port's
copy of ``tpu_lutvq.utils.native``'s numpy branches, with their f32
summation order; the native ``csrc/lutvq_pack.cpp`` library is not bound).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def pack_nibbles_np(codes: np.ndarray) -> np.ndarray:
    """``(..., 2L)`` uint8 4-bit values → ``(..., L)`` packed bytes, the
    even index in the low nibble."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    return (codes[..., 0::2] & 0xF) | ((codes[..., 1::2] & 0xF) << 4)


def unpack_nibbles_np(packed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_nibbles_np`."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    out = np.stack([packed & 0xF, packed >> 4], axis=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def dequant_additive(
    codes: np.ndarray,  # (d_out, M, N) unsigned values (any int dtype)
    codebook: np.ndarray,  # (N, K, g) float32
    scales: Optional[np.ndarray] = None,  # (d_out,)
) -> np.ndarray:
    """Load-time dequant of additive-VQ weights (the AQLM 1x16 path):
    ``w[o, m·g + j] = s[o] · Σ_n codebook[n, codes[o, m, n], j]``, summed in
    f32 from zero in codebook order, then scaled."""
    d_out, m, n = codes.shape
    assert codebook.shape[0] == n
    g = codebook.shape[2]
    codes_i = np.ascontiguousarray(codes, dtype=np.int32)
    cb = np.ascontiguousarray(codebook, dtype=np.float32)
    w = np.zeros((d_out, m, g), np.float32)
    for nn in range(n):
        w += cb[nn][codes_i[:, :, nn]]
    out = w.reshape(d_out, m * g)
    if scales is not None:
        out = out * np.asarray(scales, np.float32)[:, None]
    return out
