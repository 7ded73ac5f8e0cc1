"""A plain float32 Llama-architecture decoder: the reference that decides
whether the program's served tokens are right.

It imports torch alone: no kernel, cache or batching of the program, and
nothing the program made.  It takes the benchmark's seeded weights as a
checkpoint ships them and works the rest out itself: each AQLM projection
is dequantized from its codes, codebooks and scales (``W[j, g*8:(g+1)*8] =
s_j * Σ_n C_n[code[j, g, n]]``), and the model follows the published
description: RMSNorm, rotate-half RoPE at the configured θ (angles in
float64), grouped-query attention with a causal mask, a SwiGLU MLP and an
untied head.  Keys and values pass through the configuration's int8 cache
format (per token and head, symmetric, ``absmax / 127``, round half to
even, float32 scales), as every served token reads them.  Everything else
is float32 with TF32 off.  The forward pass is one causal pass over each
whole sequence (no cache), computed layer by layer over all sequences, so
each layer's weights are dequantized once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dequantize(codes: torch.Tensor, codebooks: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``codes`` (d_out, groups, N) uint8, ``codebooks`` (N, K, g), ``scales``
    (d_out,) → the f32 weight (d_out, groups * g)."""
    cb = codebooks.float()
    idx = codes.long()
    w = cb[0][idx[..., 0]]
    for n in range(1, cb.shape[0]):
        w += cb[n][idx[..., n]]
    w *= scales.float()[:, None, None]
    return w.reshape(codes.shape[0], -1)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (T, H, Dh) at positions 0..T-1, rotate-half layout."""
    t, _, dh = x.shape
    half = dh // 2
    inv = theta ** (-torch.arange(0, half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def int8_round_trip(x: torch.Tensor) -> torch.Tensor:
    """The cache's int8 format applied to rows of (..., Dh)."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-10) / 127.0
    return torch.round(x / scale).clamp(-127, 127) * scale


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal GQA: q (T, H, Dh), k and v (T, H_kv, Dh) → (T, H * Dh)."""
    t, h, dh = q.shape
    rep = h // k.shape[1]
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for j in range(k.shape[1]):  # one KV head and its query heads at a time
        qs = q[:, j * rep:(j + 1) * rep].transpose(0, 1)  # (rep, T, Dh)
        s = qs @ k[:, j].T / math.sqrt(dh)  # (rep, T, T)
        s = s.masked_fill(~mask, float("-inf"))
        out[:, j * rep:(j + 1) * rep] = (s.softmax(dim=-1) @ v[:, j]).transpose(0, 1)
    return out.reshape(t, h * dh)


def forward(model: dict, weights: dict, sequences: list[torch.Tensor],
            positions: list[torch.Tensor]) -> list[torch.Tensor]:
    """Logits (len(p), vocab) of each sequence at ``positions``.

    ``model``: vocab, hidden, layers, heads, kv_heads, head_dim,
    rope_theta, eps.  ``weights``: ``codebooks`` (L, 7, N, K, g), ``norms``
    (L, 2, hidden), per projection name ``(codes (L, d_out, groups, N),
    scales (L, d_out))``, ``final_norm``, ``embed``, ``head`` — as the
    benchmark made them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    h, dh, eps = model["heads"], model["head_dim"], model["eps"]
    xs = [weights["embed"][s.long()].float() for s in sequences]
    with torch.no_grad():
        for li in range(model["layers"]):
            w = {n: dequantize(weights[n][0][li], weights["codebooks"][li, pi], weights[n][1][li])
                 for pi, n in enumerate(names)}
            attn_norm, mlp_norm = weights["norms"][li, 0], weights["norms"][li, 1]
            for i, x in enumerate(xs):
                t = x.shape[0]
                xn = rms_norm(x, attn_norm, eps)
                q = rope((xn @ w["wq"].T).reshape(t, h, dh), model["rope_theta"])
                k = rope((xn @ w["wk"].T).reshape(t, -1, dh), model["rope_theta"])
                v = (xn @ w["wv"].T).reshape(t, -1, dh)
                a = attention(q, int8_round_trip(k), int8_round_trip(v))
                x = x + a @ w["wo"].T
                xn = rms_norm(x, mlp_norm, eps)
                xs[i] = x + (F.silu(xn @ w["w_gate"].T) * (xn @ w["w_up"].T)) @ w["w_down"].T
            del w
        head = weights["head"].float()
        return [rms_norm(x[p.long()], weights["final_norm"], eps) @ head.T
                for x, p in zip(xs, positions)]
