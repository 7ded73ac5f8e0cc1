"""Perplexity and log-likelihood scoring (counterpart of
``tpu_lutvq.runtime.eval``).

Teacher-forced scoring of token sequences through ``llama_forward``: the
means by which the precision tiers (the bf16 serving tables, the W8A8
``quality="fast"`` tables, the f32 oracle) show what they cost in model
quality on the same weights.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpu_lutvq_torch.models.llama import (
    LlamaConfig,
    LlamaWeights,
    init_caches,
    llama_forward,
)


def sequence_logprobs(
    cfg: LlamaConfig,
    weights: LlamaWeights,
    tokens: torch.Tensor,  # (B, T) integer ids
    *,
    strategy: str = "auto",
    variant: str = "auto",
    plain: bool = False,
) -> torch.Tensor:
    """Teacher-forced ``log p(t_i | t_<i)`` for positions 1..T-1 → ``(B, T-1)``
    float32, on fresh caches on the weights' device.  ``plain=True`` runs
    the kernels' plain versions."""
    device = weights.embed.device
    tokens = tokens.to(device)
    logits, _ = llama_forward(
        cfg, weights, tokens, init_caches(cfg, tokens.shape[0], device=device), 0,
        strategy=strategy, variant=variant, plain=plain,
    )
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return logp.gather(-1, tokens[:, 1:, None].long())[..., 0]


def perplexity(
    cfg: LlamaConfig,
    weights: LlamaWeights,
    tokens: torch.Tensor,
    chunk: Optional[int] = None,
    **kw,
) -> float:
    """``exp(−mean log-likelihood)`` over all predicted positions.

    ``chunk`` splits long sequences into independent windows of that many
    tokens (strided perplexity: windows do not attend across the boundary;
    a tail shorter than ``chunk`` is dropped)."""
    if chunk is not None and tokens.shape[1] > chunk:
        t = tokens.shape[1] // chunk * chunk
        tokens = tokens[:, :t].reshape(-1, chunk)
    lp = sequence_logprobs(cfg, weights, tokens, **kw)
    return math.exp(-float(lp.mean()))
