"""OPQ — optimized product quantization rotation trainer (counterpart of
``tpu_lutvq.ann.opq``).

The reference's ``OVPQMatrix`` trainer (faiss-simd/VecProductQuantizer.h:
2838-3025): alternate between training the PQ on rotated data and solving
the orthogonal Procrustes problem ``min_R ||R x − decode(encode(R x))||`` by
an SVD of the correlation matrix (``torch.linalg.svd``, on the data's device).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpu_lutvq_torch.ann.pq import ProductQuantizer


def procrustes_step(pq: ProductQuantizer, x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """One rotation update given a trained ``pq``: ``R = U Vᵀ`` of
    ``Yᵀ X = U Σ Vᵀ``, ``Y`` the reconstruction of ``x Rᵀ``, which maximises
    ``tr(R Xᵀ Y)``."""
    x = x.float()
    xr = x @ r.T
    rec = pq.decode(pq.encode(xr))  # (n, d) in rotated space
    u, _, vt = torch.linalg.svd(rec.T @ x, full_matrices=False)
    return u @ vt


@dataclasses.dataclass
class OPQ:
    d: int
    m: int
    k: int = 256
    rotation: Optional[torch.Tensor] = None  # (d, d) orthogonal
    pq: Optional[ProductQuantizer] = None

    def train(
        self,
        generator: torch.Generator,
        x: torch.Tensor,
        outer_iters: int = 8,
        kmeans_iters: int = 12,
    ) -> "OPQ":
        x = x.float()
        r = torch.eye(self.d, dtype=torch.float32, device=x.device)
        pq = ProductQuantizer(self.d, self.m, self.k)
        for _ in range(outer_iters):
            pq.train(generator, x @ r.T, iters=kmeans_iters)
            r = procrustes_step(pq, x, r)
        self.rotation = r
        self.pq = pq
        return self

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.pq.encode(x.float() @ self.rotation.T)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self.pq.decode(codes) @ self.rotation

    def reconstruction_mse(self, x: torch.Tensor) -> float:
        rec = self.decode(self.encode(x))
        return float(((rec - x.float()) ** 2).mean())
