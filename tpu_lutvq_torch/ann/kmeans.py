"""k-means codebook training (counterpart of ``tpu_lutvq.ann.kmeans``).

Lloyd iterations over ``x (n, d)``: the assignment is one ``(n, d) × (d, k)``
distance matmul, the update a scatter-add of the points into their
centroids.  A Python loop runs the iterations, and all randomness comes from
an explicit ``torch.Generator``; its numbers differ from ``jax.random``'s, so
the parity tests hand both packages the same centroids.
"""

from __future__ import annotations

import torch


def _assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per point via ``||c||² − 2x·c`` (``||x||²`` is the
    same for every centroid)."""
    dots = x @ centroids.T  # (n, k)
    c2 = (centroids * centroids).sum(dim=1)
    return torch.argmin(c2[None, :] - 2.0 * dots, dim=1)


def _update(x: torch.Tensor, assign: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean of each centroid's points (an empty one gets zeros) and the
    point counts, as f32 ``(k, d)`` and ``(k,)``."""
    sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    sums.index_add_(0, assign, x)
    counts = torch.bincount(assign, minlength=k).to(x.dtype)
    return sums / counts.clamp_min(1.0)[:, None], counts


def _choice(generator: torch.Generator, n: int, k: int, device) -> torch.Tensor:
    """``k`` point indices in ``[0, n)``: without replacement when n ≥ k."""
    if n >= k:
        idx = torch.randperm(n, generator=generator, device=generator.device)[:k]
    else:
        idx = torch.randint(0, n, (k,), generator=generator, device=generator.device)
    return idx.to(device)


def hypercube_init(x: torch.Tensor, k: int) -> torch.Tensor:
    """±σ hypercube corners on the first log2(k) dims around the mean, as in
    the reference's init_hypercube (VecProductQuantizer.h:80-103)."""
    d = x.shape[1]
    nbits = max(1, (k - 1).bit_length())
    mean = x.mean(dim=0)
    std = x.std(correction=0) + 1e-12
    ids = torch.arange(k, device=x.device)[:, None]
    bits = torch.arange(nbits, device=x.device)[None, :]
    corners = ((ids >> bits) & 1).to(torch.float32) * 2.0 - 1.0  # (k, nbits)
    c = torch.zeros((k, d), dtype=x.dtype, device=x.device)
    take = min(nbits, d)
    c[:, :take] = corners[:, :take] * std
    return c + mean[None, :]


def _kmeanspp_init(generator: torch.Generator, x: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding: each next centroid drawn ∝ its squared distance to
    the nearest centroid so far (floored at 1e-30, as the JAX package's
    logits are)."""
    n = x.shape[0]
    first = int(torch.randint(0, n, (1,), generator=generator, device=generator.device))
    cents = torch.empty((k, x.shape[1]), dtype=x.dtype, device=x.device)
    cents[0] = x[first]
    mind2 = ((x - x[first]) ** 2).sum(dim=1)
    for i in range(1, k):
        w = mind2.clamp_min(1e-30).to(generator.device)
        pick = torch.multinomial(w, 1, generator=generator).to(x.device)
        cents[i] = x[pick[0]]
        mind2 = torch.minimum(mind2, ((x - cents[i]) ** 2).sum(dim=1))
    return cents


def kmeans(
    generator: torch.Generator,
    x: torch.Tensor,
    k: int,
    iters: int = 25,
    init: str = "kmeans++",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Train ``k`` centroids on ``x (n, d)`` (in f32, on ``x``'s device).
    Returns ``(centroids (k, d), assign (n,))``.

    init: "kmeans++" (default), "sample" (random points), or "hypercube"
    (reference-style, VecProductQuantizer.h:80-103).  Each iteration
    re-seeds empty clusters from random points.  ``generator`` draws every
    random number; it may live on another device than ``x``.
    """
    n = x.shape[0]
    x = x.float()
    if init == "hypercube":
        centroids = hypercube_init(x, k)
    elif init == "kmeans++":
        centroids = _kmeanspp_init(generator, x, k)
    elif init == "sample":
        centroids = x[_choice(generator, n, k, x.device)]
    else:
        raise ValueError(f"unknown kmeans init {init!r}")
    for _ in range(iters):
        a = _assign(x, centroids)
        new_c, counts = _update(x, a, k)
        repl = x[_choice(generator, n, k, x.device)]
        centroids = torch.where((counts > 0)[:, None], new_c, repl)
    return centroids, _assign(x, centroids)
