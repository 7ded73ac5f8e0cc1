"""The attention crossover on the card: where ``attn="auto"`` should take
the flash kernels (``models/attn_policy.py``'s four constants).

At the Llama-2 7B (32/32 heads) and 70B (64/8) head layouts, head_dim 128,
int8 KV, :func:`measure_attention` times

- decode attention, flash (D; F over a paged pool of ``DEFAULT_BLOCK``-row
  blocks) against the einsum path (over the slab, or over the pool's
  gathered window), at every batch of ``DECODE_BATCHES`` × window of
  ``DECODE_WINDOWS``, each sequence at the window's last row;
- causal prefill of a fresh prompt, flash (E) against the einsum prefill,
  at T of ``PREFILL_T`` × batch of ``PREFILL_B`` (window T);
- whole decode steps of a ``STEP_LAYERS``-layer model of each geometry
  (random weights, per-layer tuple caches) under each path, at
  ``STEP_BATCHES`` × ``STEP_WINDOWS``: the end-to-end check behind
  ``MIN_BATCH_FOR_FLASH_SLAB``.

Each is the profiler's device time of a call (``Flash_us``, ``Einsum_us``,
L2 warm; the median of three sessions of those that saw every kernel),
with the CUDA-event medians beside it (L2 flushed, the host's
dispatch included).  :func:`attn_constants` derives the constants from the
rows by device time; ``h100_attn.csv`` beside this file holds the card's
table (``python3 chip_smoke.py --sweep`` rewrites it).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from tpu_lutvq_torch.dataflow.sweep import device_ms, read_csv, time_ms, write_csv

ATTN_CSV = Path(__file__).resolve().parent / "h100_attn.csv"
LAYOUTS = {"7B": (32, 32), "70B": (64, 8)}  # (query heads, KV heads)
HEAD_DIM = 128
DECODE_BATCHES = (1, 2, 4, 8, 16)
DECODE_WINDOWS = (256, 512, 1024, 2048, 4096)
PREFILL_T = (64, 256, 1024)
PREFILL_B = (1, 4)
STEP_BATCHES = (1, 2, 4)
STEP_WINDOWS = (256, 1024, 4096)
STEP_LAYERS = 4
STEP_MODELS = {"7B": "llama2_7b", "70B": "llama2_70b"}  # LlamaConfig's presets
MAX_SEQ = max(DECODE_WINDOWS)
COLUMNS = ["Kind", "Layout", "H", "H_kv", "Batch", "T", "Window", "BW", "Transient_B",
           "Flash_us", "Einsum_us", "Flash_events_us", "Einsum_events_us"]


def _config(layout: str, **kw):
    from tpu_lutvq_torch.models.llama import LlamaConfig

    h, hkv = LAYOUTS[layout]
    return LlamaConfig(hidden=h * HEAD_DIM, n_heads=h, n_kv_heads=hkv, max_seq=MAX_SEQ, **kw)


def _random_cache(gen, batch, hkv, device):
    from tpu_lutvq_torch.models.kv_cache import KVCache

    shape = (batch, hkv, MAX_SEQ, HEAD_DIM)
    return KVCache(
        torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8),
        torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8),
        torch.rand(shape[:3], generator=gen, device=device) * 0.015 + 0.005,
        torch.rand(shape[:3], generator=gen, device=device) * 0.015 + 0.005,
    )


def _as_pool(cache, window):
    """The slab's first ``window`` rows of each sequence as a paged pool."""
    from tpu_lutvq_torch.models.paged_cache import DEFAULT_BLOCK, PagedKVCache

    b, hkv = cache.k_q.shape[:2]
    per = -(-window // DEFAULT_BLOCK)
    tables = torch.arange(b * per, dtype=torch.int32, device=cache.k_q.device).reshape(b, per)

    def blocks(t):
        t = t[:, :, : per * DEFAULT_BLOCK]
        t = t.reshape((b, hkv, per, DEFAULT_BLOCK) + t.shape[3:]).transpose(1, 2)
        return t.reshape((b * per, hkv, DEFAULT_BLOCK) + t.shape[4:]).contiguous()

    return PagedKVCache(blocks(cache.k_q), blocks(cache.v_q), blocks(cache.k_scale),
                        blocks(cache.v_scale), tables)


def _row(kind, layout, batch, t, window, flash, einsum):
    h, hkv = LAYOUTS[layout]
    row = dict(Kind=kind, Layout=layout, H=h, H_kv=hkv, Batch=batch, T=t, Window=window,
               BW=batch * window, Transient_B=2 * 4 * batch * h * t * window)
    for name, fn in (("Flash", flash), ("Einsum", einsum)):
        fn()
        torch.cuda.synchronize()
        row[f"{name}_us"] = round(device_ms(fn, calls=10, sessions=3) * 1e3, 3)
        row[f"{name}_events_us"] = round(time_ms(fn, reps=10) * 1e3, 3)
    print(" ".join(f"{k}={v}" for k, v in row.items()), flush=True)
    return row


def measure_attention(out_path=None, header: tuple = (), device: str = "cuda") -> list:
    """Every row above, on the card (it raises without one)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the attention crossover is measured on a CUDA card; none is present")
    from tpu_lutvq_torch.models import llama

    gen = torch.Generator(device).manual_seed(0)
    rows = []
    for layout, (h, hkv) in LAYOUTS.items():
        cfg = _config(layout)
        for b in DECODE_BATCHES:
            cache = _random_cache(gen, b, hkv, device)
            q = torch.randn((b, 1, h, HEAD_DIM), generator=gen, device=device)
            for w in DECODE_WINDOWS:
                pos = torch.full((b,), w - 1, dtype=torch.int32, device=device)
                rows.append(_row(
                    "decode_slab", layout, b, 1, w,
                    lambda: llama._attention(cfg, q, cache, pos, w, "flash", False),
                    lambda: llama._attention(cfg, q, cache, pos, w, "xla", False)))
                pool = _as_pool(cache, w)
                rows.append(_row(
                    "decode_paged", layout, b, 1, w,
                    lambda: llama._paged_attention(cfg, q, pool, pos, w, "flash", False),
                    lambda: llama._paged_attention(cfg, q, pool, pos, w, "xla", False)))
                del pool
            del cache
        for b in PREFILL_B:
            cache = _random_cache(gen, b, hkv, device)
            zero = torch.zeros((b,), dtype=torch.int32, device=device)
            for t in PREFILL_T:
                q = torch.randn((b, t, h, HEAD_DIM), generator=gen, device=device)
                rows.append(_row(
                    "prefill", layout, b, t, t,
                    lambda: llama._attention(cfg, q, cache, zero, t, "flash", False),
                    lambda: llama._attention(cfg, q, cache, zero, t, "xla", False)))
            del cache
        torch.cuda.empty_cache()
        rows += _steps(layout, gen, device)
        torch.cuda.empty_cache()
    if out_path:
        with open(out_path, "w", newline="") as f:
            write_csv(f, rows, COLUMNS, header)
    return rows


def _steps(layout, gen, device):
    """Whole decode steps of a ``STEP_LAYERS``-layer model, flash against einsum."""
    from tpu_lutvq_torch.models.llama import LlamaConfig, init_caches, init_llama, llama_decode_step

    base = getattr(LlamaConfig, STEP_MODELS[layout])()
    cfg = dataclasses.replace(base, n_layers=STEP_LAYERS, max_seq=MAX_SEQ)
    weights = init_llama(cfg, torch.Generator(device).manual_seed(0))
    rows = []
    for b in STEP_BATCHES:
        caches = init_caches(cfg, b, device=device)
        tok = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=device)
        for w in STEP_WINDOWS:
            pos = torch.full((b,), w - 1, dtype=torch.int32, device=device)

            def step(attn):
                return lambda: llama_decode_step(cfg, weights, tok, caches, pos, window=w,
                                                 attn=attn)
            rows.append(_row("step", layout, b, 1, w, step("flash"), step("xla")))
        del caches
    return rows


def _crossover(rows: list) -> int:
    """The least B·window from which flash is no slower at every row."""
    products = sorted({int(r["BW"]) for r in rows})
    return next((p for p in products
                 if all(r["Flash_us"] <= r["Einsum_us"] for r in rows if r["BW"] >= p)),
                2 * products[-1])


def attn_constants(rows: list) -> dict:
    """``attn_policy``'s four constants from the measured rows (device time):

    - ``FLASH_CROSSOVER_PAGED``: the least B·window from which the paged
      flash kernel wins at every measured paged row;
    - ``MIN_BATCH_FOR_FLASH_SLAB``: the least batch from which the flash
      decode step wins at every measured step at or past the slab
      crossover of all batches' rows;
    - ``FLASH_CROSSOVER_SLAB``: the slab crossover over the rows from that
      batch on;
    - ``XLA_PREFILL_TRANSIENT_BUDGET``: the largest einsum-prefill transient
      (``Transient_B``) at which the einsum prefill won, so that every
      measured prefill past it is a flash win (0: flash won every row).
    """
    def kind(k):
        return [r for r in rows if r["Kind"] == k]

    slab_all = _crossover(kind("decode_slab"))
    steps = [r for r in kind("step") if r["BW"] >= slab_all]
    batches = sorted({int(r["Batch"]) for r in kind("step")})
    min_batch = next((b for b in batches
                      if all(r["Flash_us"] <= r["Einsum_us"] for r in steps if r["Batch"] >= b)),
                     batches[-1] + 1)
    slab = _crossover([r for r in kind("decode_slab") if r["Batch"] >= min_batch])
    losses = [int(r["Transient_B"]) for r in kind("prefill") if r["Flash_us"] > r["Einsum_us"]]
    return {"FLASH_CROSSOVER_SLAB": slab,
            "FLASH_CROSSOVER_PAGED": _crossover(kind("decode_paged")),
            "MIN_BATCH_FOR_FLASH_SLAB": min_batch,
            "XLA_PREFILL_TRANSIENT_BUDGET": max(losses, default=0)}


if __name__ == "__main__":
    print(attn_constants(read_csv(ATTN_CSV)))
