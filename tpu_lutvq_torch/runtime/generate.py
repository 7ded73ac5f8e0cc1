"""Decode loop: prefill + autoregressive generation (counterpart of
``tpu_lutvq.runtime.generate``).  Runs eagerly; sampling draws from an
explicit ``torch.Generator``."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpu_lutvq_torch.models.llama import (
    LlamaConfig,
    LlamaWeights,
    init_caches,
    init_stacked_caches,
    llama_decode_step,
    llama_forward,
)


class GenerationResult(NamedTuple):
    tokens: torch.Tensor  # (B, prompt_len + max_new) int32
    lengths: torch.Tensor  # (B,) total valid length per sequence


MIN_BUCKET = 256


def bucket_window(n_valid: int, max_seq: int, min_bucket: int = MIN_BUCKET) -> int:
    """Attention window (length bucket) covering ``n_valid`` cache rows:
    powers of two from ``min_bucket`` up to ``max_seq``."""
    w = min(min_bucket, max_seq)
    while w < min(n_valid, max_seq):
        w *= 2
    return min(w, max_seq)


def make_chunked_prefill(
    cfg: LlamaConfig,
    *,
    chunk: int = 1024,
    strategy: str = "auto",
    variant: str = "auto",
    attn: str = "auto",
    quality: str = "exact",
):
    """Chunked prefill (``generate.py:49-113``): a (B, T) prompt runs in
    T-slices of ``chunk`` tokens, so activation transients scale with the
    chunk; chunk ``[c0, c1)`` attends over window ``bucket_window(c1)`` at
    offset ``c0`` (the flash-prefill kernel once ``attn`` resolves to it).

    ``quality`` goes to every chunk's projections (``llama_forward``).

    Returns ``prefill(weights, tokens, caches) -> (last_logits (B, vocab),
    caches)``, the caches filled in place."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")

    def prefill(weights: LlamaWeights, tokens: torch.Tensor, caches):
        t = tokens.shape[1]
        logits = None
        for c0 in range(0, t, chunk):
            c1 = min(c0 + chunk, t)
            logits, caches = llama_forward(
                cfg, weights, tokens[:, c0:c1], caches, c0, strategy=strategy,
                window=bucket_window(c1, cfg.max_seq), attn=attn, variant=variant,
                quality=quality, logits_mode="last",
            )
        return logits[:, -1], caches

    return prefill


def make_fused_chunked_prefill(
    cfg: LlamaConfig,
    *,
    chunk: int = 1024,
    strategy: str = "auto",
    variant: str = "auto",
    attn: str = "auto",
    quality: str = "exact",
):
    """Chunked prefill into a stacked cache made inside the call
    (``generate.py:116-172``): ``prefill(weights, tokens) -> (last_logits
    (B, vocab), stacked caches)``.  Every full chunk, then the tail chunk,
    attends at the one window ``bucket_window(T)``, as the reference's
    single compiled program does.  The reference fuses the chunks to keep
    the cache from crossing a call boundary; here the chunks run eagerly
    into the one stacked cache, written in place."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")

    def prefill(weights: LlamaWeights, tokens: torch.Tensor):
        b, t = tokens.shape
        win = bucket_window(t, cfg.max_seq)
        caches = init_stacked_caches(cfg, b, device=weights.embed.device)
        logits = None
        for c0 in range(0, t, chunk):
            logits, caches = llama_forward(
                cfg, weights, tokens[:, c0 : c0 + chunk], caches, c0, strategy=strategy,
                window=win, attn=attn, variant=variant, quality=quality, logits_mode="last",
            )
        return logits[:, -1], caches

    return prefill


def pad_prompts(prompts, max_seq: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Ragged prompts right-padded with 0 to a power-of-two bucket (≥ 8,
    ≤ ``max_seq``): ``(B, bucket)`` int32 ids and ``(B,)`` int32 lengths."""
    lens = [len(p) for p in prompts]
    bucket = 8
    while bucket < max(lens):
        bucket *= 2
    bucket = min(bucket, max_seq)
    padded = torch.zeros((len(prompts), bucket), dtype=torch.int32)
    for i, p in enumerate(prompts):
        padded[i, : len(p)] = torch.as_tensor(p, dtype=torch.int32)
    return padded.to(device), torch.as_tensor(lens, dtype=torch.int32, device=device)


def _top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter: mask tokens outside the smallest set whose cumulative
    probability reaches ``top_p`` (the top-1 token is always kept; ties with
    the boundary probability are kept too, as in the JAX package)."""
    probs = torch.softmax(logits, dim=-1)
    desc = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(desc, dim=-1)
    keep = (csum - desc) < top_p
    thresh = torch.where(keep, desc, torch.full_like(desc, float("inf")))
    thresh = thresh.amin(dim=-1, keepdim=True)
    return torch.where(probs >= thresh, logits, torch.full_like(logits, float("-inf")))


def _top_k_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
    return torch.where(logits < kth, torch.full_like(logits, float("-inf")), logits)


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def sample_logits(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
) -> torch.Tensor:
    """(B, vocab) → (B,) int32 token ids.  temperature 0 = greedy; ``top_k``
    then ``top_p`` (nucleus, active in (0, 1)) filter before sampling."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k > 0:
        logits = _top_k_filter(logits, top_k)
    if 0.0 < top_p < 1.0:
        logits = _top_p_filter(logits, top_p)
    return _categorical(logits, generator)


def sample_logits_vec(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temps: torch.Tensor,
    top_k: int = 0,
    top_p: float = 0.0,
) -> torch.Tensor:
    """(B, vocab) + per-row temperatures (B,) → (B,) token ids: rows with
    ``temps <= 0`` decode greedily, the rest sample at their own temperature."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / temps.clamp_min(1e-6)[:, None]
    if top_k > 0:
        scaled = _top_k_filter(scaled, top_k)
    if 0.0 < top_p < 1.0:
        scaled = _top_p_filter(scaled, top_p)
    sampled = _categorical(scaled, generator)
    return torch.where(temps <= 0.0, greedy, sampled)


def generate(
    cfg: LlamaConfig,
    weights: LlamaWeights,
    prompt,  # (B, T0) integer tensor, or a list of per-sequence token lists
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    eos_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    strategy: str = "auto",
    stacked_kv: bool = False,
    plain: bool = False,
) -> GenerationResult:
    """Prefill the prompt, then decode ``max_new_tokens`` greedily/sampled.

    A ragged ``prompt`` (list of unequal-length token lists) is right-padded
    to a power-of-two bucket for one batched prefill; each row's first token
    comes from its own last real position and decode runs at per-sequence
    positions.  Output rows are left-aligned: ``tokens[i]`` holds prompt_i,
    then its generated tokens, then padding; ``lengths[i]`` marks the valid
    prefix.  ``plain=True`` runs the kernels' plain versions (reference run).

    ``stacked_kv=True`` serves the hybrid container (``generate.py:310-314``):
    one stacked ``(L, ...)`` cache, per-layer weights (or stacked ones:
    scan mode), each layer's rows written into its slab in place and read
    there.  The tokens and logits are the tuple caches' bit for bit: the
    same kernels read the same bytes.
    """
    device = weights.embed.device
    ragged = isinstance(prompt, (list, tuple))
    if ragged:
        lens = [len(p) for p in prompt]
        b, t_max = len(prompt), max(lens)
        if t_max + max_new_tokens > cfg.max_seq:
            raise ValueError(
                f"longest prompt({t_max}) + max_new({max_new_tokens}) "
                f"exceeds max_seq={cfg.max_seq}"
            )
        prompt_arr, t0s = pad_prompts(prompt, cfg.max_seq, device)
        if len(set(lens)) == 1 and lens[0] == prompt_arr.shape[1]:
            ragged = False  # equal lengths on the bucket: plain path
            t0 = lens[0]
    else:
        prompt_arr = prompt.to(device=device, dtype=torch.int32)
        b, t0 = prompt_arr.shape
        if t0 + max_new_tokens > cfg.max_seq:
            raise ValueError(
                f"prompt({t0}) + max_new({max_new_tokens}) exceeds max_seq={cfg.max_seq}"
            )
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    caches = (init_stacked_caches if stacked_kv else init_caches)(cfg, b, device=device)
    kw = dict(strategy=strategy, plain=plain)

    if ragged:
        t_hi = max(lens)  # window bookkeeping tracks the longest row
        logits, caches = llama_forward(
            cfg, weights, prompt_arr, caches, 0,
            window=bucket_window(prompt_arr.shape[1], cfg.max_seq),
            logits_mode="index", logits_idx=t0s - 1, **kw,
        )
        first = logits[:, 0]
    else:
        t_hi = t0
        t0s = torch.full((b,), t0, dtype=torch.int32, device=device)
        logits, caches = llama_forward(
            cfg, weights, prompt_arr, caches, 0,
            window=bucket_window(t0, cfg.max_seq), **kw,
        )
        first = logits[:, -1]
    next_tok = sample_logits(first, generator, temperature, top_k, top_p)

    out = [next_tok]
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    lengths = t0s + 1
    for i in range(1, max_new_tokens):
        if eos_id is not None:
            done = done | (next_tok == eos_id)
            if bool(done.all()):
                break
        pos = t0s + (i - 1) if ragged else t0 + i - 1
        logits, caches = llama_decode_step(
            cfg, weights, next_tok, caches, pos,
            window=bucket_window(t_hi + i, cfg.max_seq), **kw,
        )
        next_tok = sample_logits(logits, generator, temperature, top_k, top_p)
        if eos_id is not None:
            next_tok = torch.where(done, torch.full_like(next_tok, eos_id), next_tok)
        lengths = lengths + (~done).to(torch.int32)
        out.append(next_tok)
    if len(out) < max_new_tokens:
        # early all-EOS break: pad to the promised (B, t0 + max_new) width
        pad_tok = out[-1] if eos_id is None else torch.full_like(out[-1], eos_id)
        out.extend([pad_tok] * (max_new_tokens - len(out)))
    gen = torch.stack(out, dim=1)  # (B, max_new)
    if ragged:
        # left-align: row i = prompt_i ++ generated_i ++ pad
        width = t_hi + max_new_tokens
        tokens = torch.zeros((b, width), dtype=torch.int32, device=device)
        tokens[:, :t_hi] = prompt_arr[:, :t_hi]
        cols = t0s.long()[:, None] + torch.arange(max_new_tokens, device=device)[None, :]
        tokens[torch.arange(b, device=device)[:, None], cols] = gen
    else:
        tokens = torch.cat([prompt_arr, gen], dim=1)
    return GenerationResult(tokens=tokens, lengths=lengths)
