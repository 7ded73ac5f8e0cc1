#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpu_lutvq_torch``) on one CUDA card.

    python3 chip_smoke.py          # from the repository root; one H100, nvcc

Phases, one result line each; any failure raises and exits non-zero:
  0. device: the card's name and power limit, torch and CUDA versions;
  1. build: compile ``tpu_lutvq_torch/csrc/*.cu`` (one nvcc per source, in
     parallel, sm_90a), link and load; one line per kernel with registers
     and spills, and the redesigned sources' kernels (flash decode's three,
     flash prefill's, J1's and J2's, G's and its fold's, B's, and every
     instance of lut_scan.cu's A/M/K/H/I template) must not spill;
  2. kernels: each CUDA kernel against its plain PyTorch version on the same
     inputs, error, CUDA-event median times and profiler device times, at
     the shapes its path gives it: the projections at the Llama-2-7B shapes
     and a padded d_out (the lookup at 1 token (A, one kernel a call by the
     profiler) and 2/3/4/8 (B), each with its shared-memory floor, the
     bf16x2 dequant-matmul at 7/8/16/256/1024 rows,
     and with per-subvector codebooks at 8/256); flash
     decode (slab and paged) at B 1/8, the 7B (32/32) and 70B (64/8) head
     layouts, windows 256/2048, int8 and bf16 KV, rows past pos poisoned;
     flash prefill at the chunked-admission and ragged-wave shapes, bf16 KV
     once, and at its other splits (blocks of 64, a 4096-row window); both
     at head_dim 64 once; ``quantize_kv`` of 7B-width K/V rows on the card
     equal to the CPU's bit for bit; the table lookups at each scan that
     phase 5 gives them (8 queries over a million codes: bf16 tables at
     PQ16 and at RQ's 4 codebooks, f32 at PQ16 and at the refine bounds' 8
     subquantizers, int8 and int16 at PQ16), a lone query at K=128 and (f32,
     int8, int16) a 7B projection, two calls bit-equal, one kernel a call at
     the projection (profiler); the precision tiers at the 7B projection
     shapes: the W8A8 dequant-matmul and its fold kernel at 7/8/16/256 rows
     (and the kernels one whole W8A8 call launches, by the profiler), the f32 one at
     7/256/1024 rows (and at 8/256 with per-subvector codebooks and with
     d_subvec 3, its general path), ``pairf`` at one token (M: A's kernel,
     one launch a call, two calls bit-equal); the three dequant
     kernels, B, the attention kernels and the nibble lookups give bit-equal
     outputs from two calls; the T-MAC W4 nibble lookups (J1 at one token's f32
     table, one kernel a call by the profiler, J2 at 2, 8 and 16 tokens' bf16
     tables, each with its shared-memory lookup floor) at the 7B projection
     shapes and 4096 -> 28672; then the routes: at the Llama-2-7B projection
     shapes and 1/2/4/8 rows every exact-tier strategy's whole
     ``QuantizedLinear.apply`` call on the device, the route
     ``pick_strategy`` takes within 10 % of the fastest, beside
     ``layer_report``'s predicted time; and the native host library
     (``csrc/lutvq_pack.cpp``, built with g++) bit-equal to its numpy
     branches at 7B width.  Wrong-rounding
     controls must fail each kernel's tolerance (the int8 and int16 lookups
     and the W8A8 matmul and fold must equal their plain versions, ``pairf``
     the ``pair`` kernel; truncating instead of rounding must not).  Each row
     also times one PyTorch library call computing the same function (events
     and device) and states the least time the card could take (bytes or
     operations);
  3. slice: a Llama-2-7B-geometry AQLM-2x8 model (random weights, seed 0)
     serves (a) a ragged batch of 4 prompts for 32 new tokens and (b) one
     16-token prompt for 16 new tokens through ``generate()``, and (c) (b)'s
     prompt through the lookups (``strategy="lut_gemv"``); each request
     must launch the kernels its routes take (``pick_strategy``'s, or the
     asked strategy's) and no other, outputs must be well formed, and the
     prefill and first decode-step logits must match a plain-version re-run
     within a tolerance that the plain-vs-plain noise (the plain versions
     with reordered f32 sums) stays under;
  4. batcher: the same model serves 16 requests (prompts of 5-300 tokens,
     24 new tokens each) through ``ContinuousBatcher`` with 8 slots: (i) slab
     cache, ``attn="auto"``; (ii) paged pool, blocks of 256; (iii) slab,
     ``attn="flash"``, chunked admission of two ~700-token prompts,
     ``run(horizon=4, pipeline=True)``.  Each run must launch its attention
     kernels (as ``resolve_attn`` picks them) and its decode rows' routes,
     (ii) must give (i)'s tokens, and a B=8 flash decode step from
     (i)'s caches must match the plain versions' step as in phase 3, where
     the attention controls must fail too;
  5. ann: FAISS's IndexPQ(128, 16, 8) on SIFT1M's size (benchs/
     bench_polysemous_sift1m.py): a seeded Gaussian mixture, 1M base, 100k
     training and 1,000 query vectors (SIFT1M has 10,000), PQ16 trained and
     the base encoded on the card, top-100 searches in chunks of 128
     queries: l2 with the default, int8 and int16 tables, refined from 8
     subquantizers' bounds, ip; then RQ (4 codebooks) ip, SDC and a mixed
     width PQ once each.  Each search prints queries/s, R@1/10/100 against
     exact brute force on the raw base and its kernels' launches; the int8,
     int16 and f32 table kernels must launch in theirs, and the refined
     search must return the exact f32-table top-100;
  6. tiers (run after phase 4, on its model): (a) batcher run (iv), run
     (i)'s 16 requests at ``quality="fast"``: the W8A8 kernel and its fold
     must launch at every 8-row decode tick for each projection routed to
     the dequant-matmul, and the bf16x2 one never, and a B=8 step from
     its caches must match the plain versions' fast step as in phase 4; (b)
     one B=1 decode step with ``variant="pairf"``, 224 ``pairf`` launches,
     logits equal to the ``pair`` step's; (c) ``sequence_logprobs`` of 4 × 256
     seeded tokens exact, W8A8 and through the f32 oracle (which must
     launch): KL and perplexity ratios against the oracle (findings);
  7. tmac (after phase 5): one Llama-2-7B decoder layer's seven projections
     as T-MAC W4 nibble-packed layers, ``apply(strategy="auto")`` at 1, 8 and
     9 rows: J1 must launch at 1, J2 at 8, both at 9, no dequant kernel;
     each output held to the unpacked pack's lookup and (1 row) the golden
     model;
  8. checkpoint: (a) a synthetic 32-layer Llama-2-7B-geometry AQLM 2x8
     checkpoint (HF layout, numpy seed 0) loaded by ``load_aqlm_llama``
     serves ``generate()`` as phase 3 (b) does, through its routes, with phase
     3's logits gate, and a projection of each kind reconstructs to a numpy
     dequant; (b) two of its layers as a sharded HF directory (the port's
     safetensors writer) load back equal, ``save_lutvq``/``load_lutvq`` is
     bit-equal with the same greedy tokens, and again at out_group_size 8
     (B at 8 pseudo-rows, f32 tables against the numpy dequant); (c) a
     4096x4096 1x16 projection in each ``one_x16`` mode;
  graphs (after the stacked phase, on phase 3's model): batcher runs (i)-(iv),
     the stacked run and a sampled run (temperature 0.8, ``horizon=4``,
     pipelined), each served with the decode roll's CUDA graphs and again
     with the eager roll (the method the graphs capture): tokens, cache
     bytes and launch counts must be equal, and replays must serve every
     tick after each (window, horizon)'s first.
Each phase prints its seconds.  The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.

    python3 chip_smoke.py --profile   # phases 0-1, then the profile below

profiles batcher runs (iv) (``quality="fast"``), (iii) (flash, chunked
admission), (ii) (paged) and (i) instead: device busy share, launches and
device time by kernel (torch.profiler), flash decode's share of it (in run
(iii) flash prefill's, in run (iv) the W8A8 kernel's and its fold's), a
B=8 decode step, flash against einsum attention, and phase 3 (a)'s B=4
decode tok/s.  Copied into an earlier tree's checkout it profiles that tree
the same way.

    python3 chip_smoke.py --guard     # phases 0-1, then 2-4, 6 and 7 guarded

runs phases 2, 3, 4, 6 and 7 with every CUDA buffer that a kernel wrapper
allocates (outputs, workspaces) placed between two bands of 0xA5 bytes, and
fails if any kernel wrote into a band: a check for writes past the end of a
buffer, which no tool on the card reports.

    python3 chip_smoke.py --spread    # phases 0-1, then phase 8 (a)'s gate

holds phase 8 (a)'s loaded checkpoint to the logits gate at ten prompt
seeds: how the chaotic random model's readings spread around the limit.

    python3 chip_smoke.py --plans     # phases 0-1, then csrc/lut_scan.cu's plans

launches every candidate plan of ``kernels/lut_gemv.py::plan_scan`` at the
shapes the main paths give A, M, K, H and I (``PLAN_CASES``), each held to
the plain version and timed on the device, beside the plan the wrapper
picks: the data of the plan's cost model.

    python3 chip_smoke.py --sweep     # phases 0-1, then the crossover tables

measures the projection strategies' sweep (``tpu_lutvq_torch/dataflow/
sweep.py``) and the attention crossover (``dataflow/attn_sweep.py``) on the
card and rewrites ``dataflow/h100_sweep.csv`` and ``dataflow/h100_attn.csv``
(refit the traffic model with ``python -m tpu_lutvq_torch.dataflow.sweep
--fit``).

    python3 chip_smoke.py --lookups   # phases 0-1, then the lookups alone

times A and M at phase 2's projection shapes and K, H and I at its scans
and a 4096x4096 projection (device time, kernels a call, error), counts
phase 3 (b)'s launches a decode step (also under ``--profile``) and runs
phase 5.  It calls the wrappers alone, so copied into an earlier tree's
checkout it measures that tree the same way.
"""

import contextlib
import functools
import importlib
import json
import math
import re
import statistics
import subprocess
import sys
import time

import torch

from tpu_lutvq_torch.dataflow.chips import default_chip
from tpu_lutvq_torch.dataflow.sweep import device_ms, time_ms
from tpu_lutvq_torch.runtime.decode_graph import same_cache_bytes

CHIP = default_chip()
# max|kernel - plain| / max|plain| per call.  Readings on the H100 were
# <= 1.6e-7 (lut_gemv) and <= 2.9e-5 (dequant_mm, tensor-core accumulation);
# the wrong rounding (LUT left in f32, codebook sum rounded to bf16) reads
# ~1.5e-3, and phase 2 checks in every run that such a control fails.
KERNEL_TOL = {"lut_gemv": 1e-5, "lut_gemv_bpair": 1e-5, "dequant_mm": 2e-4}
# The table lookups: int8 and int16 sum integers exactly, so kernel and plain
# version must be equal (0).  The f32 one sums f32 in another order than the
# plain version; its limit, and the bf16-table control it must reject, are
# set from the H100 readings in PERF.md.
TABLE_TOL = {"lut_gemv_bpair": KERNEL_TOL["lut_gemv_bpair"], "lut_gemv_f32": 1e-5,
             "lut_gemv_i8": 0.0, "lut_gemv_i16": 0.0}
TABLE_VARIANTS = {"lut_gemv_bpair": "bpair", "lut_gemv_f32": "f32", "lut_gemv_i8": "i8",
                  "lut_gemv_i16": "i16"}
ANN_N = 1_000_000  # database codes of the scan rows and of phase 5
# (B, G, K) of each scan row over ANN_N codes, and the lookups held to their
# plain versions there: 8 queries' PQ16 tables (phase 5's searches (a)-(c),
# (e), SDC, MixedPQ), their first 8 subquantizers (the bounds of (d)), RQ's
# 4 codebooks, and a lone query at K=128
TABLE_SCANS = {
    (8, 16, 256): ("lut_gemv_bpair", "lut_gemv_f32", "lut_gemv_i8", "lut_gemv_i16"),
    (8, 8, 256): ("lut_gemv_f32",),
    (8, 4, 256): ("lut_gemv_bpair",),
    (1, 16, 128): ("lut_gemv_f32", "lut_gemv_i8", "lut_gemv_i16"),
}
# H100 SXM peaks (NVIDIA's data sheet, dense; tpu_lutvq_torch.dataflow.chips):
# HBM bytes/s, and operations/s by the type the work runs in (f32 on the
# CUDA cores, bf16 and int8 tensor cores)
HBM_BYTES_S = CHIP.hbm_bytes_s
PEAK_OPS_S = CHIP.peak_ops
# the lookups' floor (A, M, B, J1, J2): their shared-memory bytes at 128 B a
# clock an SM, at the card's maximum SM clock (nvidia-smi clocks.max.sm, read
# in phase 0)
SMEM_BYTES_CLK = CHIP.smem_bytes_clk
SM_CLOCK_HZ = None
# kernels of the sources redesigned for Hopper that phase 1 holds to zero
# spills: csrc/flash_decode.cu (D, F), csrc/lut_nibbles.cu (J1, J2),
# csrc/dequant_mm_i8.cu (G and the W8A8 fold), csrc/lut_bpair.cu (B),
# csrc/flash_prefill.cu (E) and csrc/lut_scan.cu (A, M, K, H, I: every
# instance of its one template)
NO_SPILL_KERNELS = ("decode_scores", "decode_values", "decode_combine", "lut_nibbles_bf16",
                    "lut_nibbles_f32", "dequant_mm_i8", "fold_i8", "lut_bpair",
                    "flash_prefill_cluster", "lut_scan")
# the profiler's name of csrc/lut_scan.cu's kernel (A, M, K, H, I)
SCAN_KERNEL = "lut_scan"
# flash decode's and flash prefill's kernels as the profiler names them
# (this tree's and the designs before it), for --profile's shares of device
# time
DECODE_KERNELS = re.compile(r"flash_decode<|decode_(scores|values|combine)")
PREFILL_KERNELS = re.compile(r"flash_prefill")
# max|logits - plain logits| / max|plain logits|, prefill and first step.
# The random 7B model turns last-bit differences into int8-KV and bf16
# rounding flips: the plain versions with reordered f32 sums read 0.87-2.0e-2
# on the H100, the wrong-rounding control >= 2.9e-2 (PERF.md).  Each run
# checks that every reordered run passes and the control fails.
LOGITS_TOL = 2.5e-2
SHAPES = (  # (d_in, d_out): the Llama-2-7B projections, and a padded d_out
    (4096, 4096), (4096, 11008), (11008, 4096), (4096, 1100),
)
LUT_BATCHES = (1, 2, 3, 4, 8)  # decode rows: A at 1 token, B at 2-8 (ragged and full tiles)
# C's rows: phase 2's 7 and 16, the batcher's 8 decode rows (every tick of
# phase 4), phase 3's 256 prefill rows, phase 6 (c)'s 1024 scoring rows.
# Each tile of csrc/dequant_mm.cu (8, 16, 64 rows) and its split-K meet
# these; two calls must give bit-equal outputs (the split sums in order).
DEQUANT_ROWS = (7, 8, 16, 256, 1024)
# C and L with per-subvector codebooks (streamed through the kernels' rings)
# and L at an odd d_subvec (its general path): (name, d_in, d_out, d_subvec,
# shared codebook) at PATH_ROWS
PATH_CASES = (("per-subvector", 4096, 4096, 8, False), ("d_subvec=3", 4095, 4096, 3, False))
PATH_ROWS = (8, 256)
# Phase 2's general dequant shapes: every layer JAX's dequant_matmul takes
# beyond 2x8's d_subvec 8 (C's and G's general instances).  (name, config
# maker, d_out): the sweep's AQLM group 16, PQ and RQ rows, a T-MAC W4
# layer packed without nibbles, d_subvec 2 (per-subvector codebooks:
# streamed, two subvectors a thread's inputs) and 6 (a shared codebook
# staged; 511 subvectors, so x rows are not 16-byte aligned) controls (C
# only: the i8 tables need d_subvec % 4 == 0), 8 codebooks of d_subvec 12
# (two codebook groups a k-step, two subvectors a thread's inputs in G) and
# 4 of d_subvec 16 (staged in both).  Between them every general instance
# kind runs: staged or streamed codebooks, one or two subvectors a thread.
SHAPE_CASES = (
    ("AQLM g16", lambda c: c.aqlm_2x8(4096, group=16), 4096),
    ("PQ", lambda c: c.pq_ann(), 1024),
    ("RQ", lambda c: c.rq_ann(), 1024),
    ("T-MAC unpacked", lambda c: c.tmac(4096), 4096),
    ("d_subvec=2", lambda c: c.VQConfig(3072, 1536, 2, 256), 4096),
    ("d_subvec=6", lambda c: c.VQConfig(3066, 511, 2, 256, shared_codebook=True), 4096),
    ("N=8 d_subvec=12", lambda c: c.VQConfig(1536, 128, 8, 256, shared_codebook=True), 1024),
    ("N=4 d_subvec=16", lambda c: c.VQConfig(1024, 64, 4, 256, shared_codebook=True), 1024),
)
SHAPE_ROWS = (1, 64)  # the sweep's AQLM_GEMV and AQLM_GEMM_B64 rows
# the 2x8 d_subvec 8 rows' device times in PERF.md (NVIDIA H100 80GB HBM3,
# 700.00 W): (kernel, shape) -> ms
PERF_MD_MS = {("dequant_mm", "4096x4096 rows=8"): 0.0130,
              ("dequant_mm", "4096x4096 rows=256"): 0.0664,
              ("dequant_mm_i8", "4096x4096 rows=8"): 0.0118,
              ("dequant_mm_i8", "4096x4096 rows=256"): 0.0813}
# The precision tiers (phase 2).  W8A8 (dequant_mm_i8): 7 prefill rows, the
# batcher's 8 decode rows, partial and full 64-row tiles; it sums integers
# exactly, so kernel and plain version must be equal.  f32 (dequant_mm_f32):
# f32 sums in another order than the plain version's matmul; H100 readings
# 1.77-3.73e-6 against >= 2.09e-3 for the bf16x2 control (PERF.md).  pairf
# (lut_gemv_pairf): equal to the pair kernel, within 1e-5 of plain.
I8_ROWS = (7, 8, 16, 256)
F32_ROWS = (7, 256, 1024)  # phase 6 (c) scores 4 x 256 tokens: 1024 rows
TIER_TOL = {"dequant_mm_i8": 0.0, "fold_i8": 0.0, "dequant_mm_f32": 1e-5,
            "lut_gemv_pairf": 1e-5}
EVAL_B, EVAL_T = 4, 256  # phase 6 (c): sequences scored under each tier
# Kernel J, the T-MAC W4 nibble lookups (phase 2 rows and phase 7): the
# T-MAC scheme tmac(d_in, bits=4, group=4), K=16, with scales and zero
# points, nibble-packed, at the Llama-2-7B projection shapes and the
# microbench's 4096 -> 28672.  J1 (nibbles) takes one token's f32 table, J2
# (nibbles_bpair) 2-8 tokens' bf16 tables, 16 tokens in two launches; both
# sum in f32 in another order than the plain version.  Controls: J1 with
# its table rounded to bf16, J2 with its table left in f32.
NIBBLE_TOL = 1e-5
TMAC_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 28672))
NIBBLE_BATCHES = {"lut_gemv_nibbles": (1,), "lut_gemv_nibbles_bpair": (2, 8, 16)}
# phase 7: one Llama-2-7B decoder layer's projections as T-MAC W4 layers
# (name, d_in, d_out), at 1, 8 and 9 rows (9 = a launch of 8 and one of 1)
TMAC_LAYER = (("wq", 4096, 4096), ("wk", 4096, 4096), ("wv", 4096, 4096),
              ("wo", 4096, 4096), ("w_gate", 4096, 11008), ("w_up", 4096, 11008),
              ("w_down", 11008, 4096))
TMAC_ROWS = (1, 8, 9)
TMAC_GOLDEN_TOL = 1e-4  # B=1 against core.golden.lut_gemm (f32, another order)
# phase 8: AQLM checkpoints at Llama-2-7B geometry (synthetic, numpy seed 0)
CKPT_MODEL = {}  # LlamaConfig.llama2_7b's arguments: its geometry, uncut
CKPT_PROMPT, CKPT_NEW = 16, 16  # phase 3 (b)'s request
CKPT_PROMPT_SEED = 1  # phase 3's prompt seed
SPREAD_SEEDS = tuple(range(1, 11))  # --spread: prompt seeds of phase 8 (a)'s gate
ONE_X16_SHAPE = (4096, 4096)  # (d_in, d_out) of (c)'s 1x16 projection
CKPT_DISK_LAYERS = 2
CKPT_OG_TOL = 1e-4  # out_group 8, f32 tables against the numpy dequant
CKPT_CHUNKED_TOL = 2e-2  # 1x16 chunked (bf16 weights) against the numpy dequant
# Attention kernels, max|kernel - plain| / max|plain| per call.  Kernel and
# plain version compute the same function with the same rounding points and
# differ only in f32 summation order, which now and then moves a p across a
# bf16 rounding boundary: one such flip costs 2^-9 of that row's share of
# the output, most in rows with few keys.  The controls move a rounding
# point: "q_scale" puts sm_scale on the other side of q's bf16 rounding
# (decode's rounding in prefill, prefill's in decode), "p_f32" leaves p
# unrounded (at head_dim 64 only "p_f32" moves a rounding, ``live_controls``).
# H100 readings: decode and paged <= 1.34e-5 against controls >= 2.57e-4;
# prefill (tensor-core sums) <= 3.96e-4 against >= 1.04e-3.
ATTN_TOL = {"flash_decode": 6e-5, "flash_decode_paged": 6e-5, "flash_prefill": 7e-4}
ATTN_CONTROLS = ("q_scale", "p_f32")
S_MAX = 2048  # cache rows per sequence (the model's max_seq)
PAGE = 128  # pool block of the paged kernel runs
POS_256 = (0, 255, 17, 128, 200, 3, 100, 254)  # B=8 positions under window 256
POS_2048 = (0, 255, 256, 2047, 1000, 511, 1500, 64)  # and under window 2048
DECODE_CASES = (  # (B, H, H_kv, window, pos per sequence, KV dtype, Dh)
    (1, 32, 32, 256, (255,), "int8", 128),
    (1, 32, 32, 2048, (2047,), "int8", 128),
    (8, 32, 32, 256, POS_256, "int8", 128),
    (8, 32, 32, 2048, POS_2048, "int8", 128),
    (1, 64, 8, 256, (255,), "int8", 128),
    (1, 64, 8, 2048, (2047,), "int8", 128),
    (8, 64, 8, 256, POS_256, "int8", 128),
    (8, 64, 8, 2048, POS_2048, "int8", 128),
    (8, 32, 32, 2048, POS_2048, "bf16", 128),
    (8, 32, 8, 2048, POS_2048, "int8", 64),  # the kernels' other head_dim
)
RAGGED = (0, 100, 700, 1500)
PREFILL_CASES = (  # (H, H_kv, T, offsets, KV dtype, Dh): chunked admission, ragged B=4
    (32, 32, 256, (0,), "int8", 128), (32, 32, 256, (256,), "int8", 128),
    (32, 32, 256, (512,), "int8", 128), (32, 32, 64, RAGGED, "int8", 128),
    (64, 8, 256, (0,), "int8", 128), (64, 8, 256, (256,), "int8", 128),
    (64, 8, 256, (512,), "int8", 128), (64, 8, 64, RAGGED, "int8", 128),
    (32, 32, 256, (512,), "bf16", 128), (32, 8, 64, RAGGED, "int8", 64),
)
# E's other splits (the rows above take one KV block of 256 a rank):
# (H, H_kv, T, offsets, KV dtype, Dh, cache rows, block_s).  Blocks of 64
# put 4 KV blocks in a rank's 256 rows; a 4096-row window puts 2 blocks of
# 256 in a rank, past the 256 score columns it holds (the recompute).
PREFILL_SPANS = (
    (32, 32, 256, (512,), "int8", 128, S_MAX, 64),
    (32, 8, 64, (3000, 100), "int8", 128, 2 * S_MAX, 256),
)
SUMMARY_AT = {
    "lut_gemv": "4096x4096 B=1", "lut_gemv_bpair": "4096x4096 B=8",
    "dequant_mm": "4096x4096 rows=256", "fold_i8": "4096x4096 rows=8",
    "flash_decode": "B=8 H=32/32 W=2048 int8",
    "flash_decode_paged": "B=8 H=32/32 W=2048 int8",
    "flash_prefill": "B=1 H=32/32 T=256 off=(512,)",
    "lut_gemv_f32": "scan B=8 G=8 K=256", "lut_gemv_i8": "scan B=8 G=16 K=256",
    "lut_gemv_i16": "scan B=8 G=16 K=256",
    "dequant_mm_i8": "4096x4096 rows=8", "dequant_mm_f32": "4096x4096 rows=256",
    "lut_gemv_pairf": "4096x4096 B=1",
    "lut_gemv_nibbles": "tmac 4096x4096 B=1", "lut_gemv_nibbles_bpair": "tmac 4096x4096 B=8",
}
# phase 5: FAISS benchs/bench_polysemous_sift1m.py, IndexPQ(128, 16, 8)
ANN_D, ANN_M, ANN_K = 128, 16, 256
ANN_NT, ANN_NQ, ANN_NQ_SIFT1M = 100_000, 1_000, 10_000
# the Gaussian mixture standing in for SIFT: components, the dimension and
# scale of their shared subspace, the isotropic noise
ANN_CENTERS, ANN_LATENT, ANN_SPREAD, ANN_NOISE = 1024, 16, 1.0, 0.05
ANN_TOPK, ANN_CHUNK = 100, 128  # results per query, queries per search call
ANN_REFINE_GROUPS = 8
# candidates rescored per refine round: the default (4·topk = 400) takes
# ~700 rounds a chunk here, where bounds from 8 of 16 groups leave a
# quarter of the base open (PERF.md)
ANN_SHORTLIST = 16384
ANN_MIXED_KS = (256, 128) * 8  # the mixed-width PQ's subquantizer sizes
ANN_TIE_REL = 1e-5  # refined vs exact top-100: ties within this of the k-th value
# phase 4: 16 requests, prompts cycling over 5-300 tokens, 24 new tokens each
PROMPT_LENS = (5, 300, 41, 128, 9, 260, 77, 33, 190, 6, 150, 290, 12, 64, 230, 100)
NEW_TOKENS = 24
LONG_PROMPTS = {3: 700, 10: 690}  # run (iii): two prompts past the chunk
N_SLOTS = 8
PAGED = dict(paged_blocks=32, paged_block_size=256)  # 31 usable: no admission waits
PREFILL_CHUNK = 256
# the routes phase: the rows at which every Llama-2-7B projection's route
# must read within ROUTE_TOL of the fastest exact-tier strategy
# The stacked phase (the hybrid and scan containers at the 7B geometry,
# depth uncut): phase 3's requests (a) and (b) and run (i) again, the fused
# chunked prefill on two prompts of FUSED_T tokens, and B=1 decode over a
# STACKED_CONTEXT-token context for STACKED_STEPS steps, tuple against
# stacked, in turns (tuple, stacked, stacked, tuple)
FUSED_T = 700
STACKED_CONTEXT = 1900
STACKED_STEPS = 32
GRAPH_TEMPERATURE = 0.8  # the graphs phase's sampled run
ROUTE_ROWS = (1, 2, 4, 8)
ROUTE_TOL = 1.10


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def kernel_times(kernel, plain, library, reps=10, plain_reps=5):
    """A row's times: the kernel's wrapper and the library call by CUDA
    events (``ms``, ``library_ms``; the host's dispatch included) and by the
    profiler (``device_ms``, ``library_device_ms``: the card's kernels
    alone), the plain version by events.  ``library`` None: no one PyTorch
    call computes the function."""
    return dict(ms=time_ms(kernel, reps=reps), device_ms=device_ms(kernel, calls=10),
                plain_ms=time_ms(plain, reps=plain_reps),
                library_ms=None if library is None else time_ms(library, reps=reps),
                library_device_ms=None if library is None else device_ms(library, calls=10))


def attention_modules():
    return (importlib.import_module("tpu_lutvq_torch.kernels.flash_decode"),
            importlib.import_module("tpu_lutvq_torch.kernels.flash_prefill"))


def kernel_modules():
    """The two kernel modules (``tpu_lutvq_torch.kernels`` re-exports the
    function ``lut_gemv`` under its module's name)."""
    return (importlib.import_module("tpu_lutvq_torch.kernels.lut_gemv"),
            importlib.import_module("tpu_lutvq_torch.kernels.dequant_mm"))


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes, ops, kind):
    """The least time the card could take for work that moves ``n_bytes``
    (each input read once, each output written once) and does ``ops``
    operations of ``kind``: (ms, "bytes" or "operations")."""
    by_bytes, by_ops = 1e3 * n_bytes / HBM_BYTES_S, 1e3 * ops / PEAK_OPS_S[kind]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def with_bound(row, n_bytes, ops, kind):
    row["bound_ms"], row["bound_by"] = bound(n_bytes, ops, kind)
    return row


def lookup_floor_ms(smem_bytes):
    """A lookup kernel's floor: ``smem_bytes`` read from shared memory at
    ``SMEM_BYTES_CLK`` an SM on every SM at the card's maximum clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 1e3 * smem_bytes / (SMEM_BYTES_CLK * sms * SM_CLOCK_HZ)


def floor_text(floor_ms):
    return "" if floor_ms is None else (
        f"  lookup floor {floor_ms:.4f} ms (shared memory, {SMEM_BYTES_CLK} B/clk an SM at "
        f"{SM_CLOCK_HZ / 1e6:.0f} MHz)")


def times(r):
    library = "none" if r["library_ms"] is None else (
        f"{r['library_ms']:.4f} ms (device {r['library_device_ms']:.4f})")
    return (f"kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f})  plain {r['plain_ms']:.4f} "
            f"ms  library {library}  bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def dense_bf16(cfg, packed):
    """The layer's weight as the library call takes it: (d_out, d_in) bf16."""
    _, dq = kernel_modules()
    return dq.dequant_weight(cfg, packed).to(torch.bfloat16)


# Stand-ins for the plain versions, same signatures.  ``parts`` > 1 splits
# the contraction into that many f32 partial sums: as exact as the plain
# order, so a run through them measures the model's plain-vs-plain noise.
# ``exact=False`` is the wrong rounding a kernel might fall into: the LUT
# left in f32, the codebook sum rounded to bf16 (a control).


def lut_lookup_variant(parts=1, exact=True):
    def lookup(lut, codes_t, scales, d_out, round_bf16=True):
        b, g, _ = lut.shape
        tab = lut.to(torch.bfloat16).float() if exact else lut.float()
        idx = codes_t[:g, :d_out].long().unsqueeze(0).expand(b, g, d_out)
        vals = torch.gather(tab, 2, idx)
        y = sum(v.sum(dim=1) for v in vals.chunk(parts, dim=1))
        return y if scales is None else y * scales[:, :d_out]
    return lookup


def dequant_mm_variant(parts=1, exact=True):
    _, dq = kernel_modules()

    def matmul(cfg, packed, x):
        w = dq.dequant_weight(cfg, packed)
        w = w if exact else w.to(torch.bfloat16).float()
        xb = x.to(torch.bfloat16).float()
        y = sum(xc @ wc.T for xc, wc in zip(xb.chunk(parts, 1), w.chunk(parts, 1)))
        return y if packed.scales is None else y * packed.scales[:, : packed.d_out]
    return matmul


REFERENCE_RUNS = {  # name: the variant that stands in for the plain versions
    "floor2": dict(parts=2),
    "floor3": dict(parts=3),
    "floor4": dict(parts=4),
    "floor8": dict(parts=8),
    "control": dict(exact=False),
}


@contextlib.contextmanager
def plain_versions(parts=1, exact=True):
    """Put the variants in place of the plain versions for a ``plain=True`` run."""
    lg, dq = kernel_modules()
    saved = lg.lut_lookup_plain, dq.dequant_mm_plain
    lg.lut_lookup_plain = lut_lookup_variant(parts, exact)
    dq.dequant_mm_plain = dequant_mm_variant(parts, exact)
    try:
        yield
    finally:
        lg.lut_lookup_plain, dq.dequant_mm_plain = saved


def online_block_p_f32(m, l, acc, scores, v, v_scale):
    """``online_block`` with p left in f32 before the PV product (a control)."""
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale
    return m_new, l, acc * alpha + p @ v


@contextlib.contextmanager
def attention_control(name):
    """Put a wrong rounding point into the attention plain versions."""
    fd, fp = attention_modules()
    saved = fd._prep_q, fp._prep_q, fd.online_block, fp.online_block

    def bf16(t):
        return t.to(torch.bfloat16).float()

    if name == "q_scale":
        fd._prep_q = lambda q, sm: bf16(q.float()) * sm
        fp._prep_q = lambda q: bf16(q.float() * q.shape[-1] ** -0.5) / q.shape[-1] ** -0.5
    elif name == "p_f32":
        fd.online_block = fp.online_block = online_block_p_f32
    else:
        raise ValueError(name)
    try:
        yield
    finally:
        fd._prep_q, fp._prep_q, fd.online_block, fp.online_block = saved


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    global SM_CLOCK_HZ
    SM_CLOCK_HZ = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0])
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} count {torch.cuda.device_count()}")
    # the plain versions' f32 products must be full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build(strict=True):
    """Build and load the kernels; with ``strict`` every kernel of
    ``NO_SPILL_KERNELS`` must be in the build and spill nothing (``--profile``
    also profiles an earlier tree, which lacks some of them)."""
    from tpu_lutvq_torch.kernels import _build

    _build.library()
    print(f"[build] {_build.BUILD_SECONDS:.1f} s")
    # one line per kernel: its name and template arguments as mangled,
    # registers, shared memory and spills; the redesigned sources' kernels
    # must not spill
    name, spill, seen = "?", "", set()
    for line in _build.BUILD_LOG.splitlines():
        m = re.search(r"Compiling entry function '\w*?_cu_[0-9a-f]+(\d+)(\w+)'", line)
        if m:
            n = int(m.group(1))
            name = m.group(2)[:n] + re.sub(r"E(P|v).*$", "", m.group(2)[n:])
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            print(f"[build] {name}: {line.split(':', 1)[1].strip()}; {spill}")
            kernel = next((k for k in NO_SPILL_KERNELS if name.startswith(k)), None)
            if kernel:
                seen.add(kernel)
                check("0 bytes spill stores, 0 bytes spill loads" in spill or not strict,
                      f"{name} spills: {spill}")
    check(seen == set(NO_SPILL_KERNELS) or not strict, f"kernels missing from the build log: "
          f"{sorted(set(NO_SPILL_KERNELS) - seen)}")


def phase_kernels(device):
    """Each kernel against its plain version on the same inputs, and a
    control with the wrong rounding that the tolerance must reject."""
    from tpu_lutvq_torch import VQConfig, aqlm_2x8, init_vq_params
    from tpu_lutvq_torch.kernels.lut_ctor import build_lut

    lg, dq = kernel_modules()
    lut_control = lut_lookup_variant(exact=False)

    gen = torch.Generator(device).manual_seed(1234)
    rows = {"lut_gemv": [], "lut_gemv_bpair": [], "dequant_mm": []}
    for d_in, d_out in SHAPES:
        cfg = aqlm_2x8(d_in, shared_codebook=True)
        packed = lg.pack_params(cfg, init_vq_params(gen, cfg, d_out, with_scales=True))
        w = dense_bf16(cfg, packed)
        for b in LUT_BATCHES:
            x = torch.randn((b, d_in), generator=gen, device=device)
            lut = build_lut(cfg, packed.codebook, x, compute_dtype=torch.bfloat16)
            args = (lut, packed.codes_t, packed.scales, packed.d_out)
            got, again = lg.lut_lookup(*args), lg.lut_lookup(*args)
            want = lg.lut_lookup_plain(*args)
            torch.cuda.synchronize()
            xb = x.to(torch.bfloat16)
            # the lookup floor: B's token tile's bf16 entries, A's one 4-byte
            # word (the entry rounded, as staged), from shared memory per
            # group and column
            bp = next(t for t in (2, 4, 8) if t >= b)
            smem = cfg.n_groups * packed.codes_t.shape[1] * (4 if b == 1 else bp * 2)
            extra = {}
            if b == 1:  # A: one kernel a call, from build_lut's f32 table as it is
                extra["call_kernels"] = launched_kernels(lambda: lg.lut_lookup(*args))
            rows["lut_gemv" if b == 1 else "lut_gemv_bpair"].append(with_bound(dict(
                shape=f"{d_in}x{d_out} B={b}", rel=rel_err(got, want),
                abs=float((got - want).abs().max()), control=rel_err(lut_control(*args), want),
                equal=bool(torch.equal(got, again)), floor_ms=lookup_floor_ms(smem), **extra,
                **kernel_times(lambda: lg.lut_lookup(*args), lambda: lg.lut_lookup_plain(*args),
                               lambda: xb @ w.T, reps=20, plain_reps=20),
            ), nbytes(*args[:3], got), b * cfg.n_groups * d_out, "f32"))
        for r in DEQUANT_ROWS:
            rows["dequant_mm"].append(dequant_row(f"{d_in}x{d_out} rows={r}", cfg, packed, w,
                                                  r, gen))
        del w, packed
    for name, d_in, d_out, d, shared in PATH_CASES:
        if d % 2:
            continue  # an odd d_subvec takes the f32 tables (L), not C
        cfg = VQConfig(d_in, d_in // d, 2, 256, shared_codebook=shared)
        packed = lg.pack_params(cfg, init_vq_params(gen, cfg, d_out, with_scales=True))
        w = dense_bf16(cfg, packed)
        for r in PATH_ROWS:
            rows["dequant_mm"].append(dequant_row(f"{name} {d_in}x{d_out} rows={r}", cfg,
                                                  packed, w, r, gen))
        del w, packed
    for name, rs in rows.items():
        tol = KERNEL_TOL[name]
        for r in rs:
            print(f"[kernels] {name} {r['shape']}: rel err {r['rel']:.3e} (tol {tol:.0e}, "
                  f"wrong-rounding control {r['control']:.3e}) abs err {r['abs']:.3e}  "
                  + times(r) + floor_text(r.get("floor_ms"))
                  + (f"  two calls bit-equal {r['equal']}" if "equal" in r else "")
                  + one_kernel_text(r))
            check(r["rel"] <= tol, f"{name} {r['shape']} disagrees with plain: {r['rel']}")
            check(r["control"] > tol, f"{name} {r['shape']}: tolerance passes the control")
            check(r.get("equal", True), f"{name} {r['shape']}: two calls differ")
            check_one_kernel(name, r)
    return rows


def one_kernel_text(r):
    ks = r.get("call_kernels")
    return "" if ks is None else (f"  one call launches {sum(ks.values())} kernels: "
                                  + ", ".join(f"{k[:48]} x{c}" for k, c in ks.items()))


def check_one_kernel(name, r):
    """A row's ``call_kernels`` (the profiler's kernels of one warm call)
    must be one launch of csrc/lut_scan.cu's kernel."""
    ks = r.get("call_kernels")
    check(ks is None or (sum(ks.values()) == 1 and SCAN_KERNEL in next(iter(ks))),
          f"{name} {r['shape']}: one call launched {ks}")


def dequant_row(shape, cfg, packed, w, r, gen):
    """C against its plain version at ``r`` rows, the wrong-rounding control,
    and two calls bit for bit."""
    _, dq = kernel_modules()
    x = torch.randn((r, cfg.d_in), generator=gen, device=w.device)
    got, again = dq.dequant_mm_bf16x2(cfg, packed, x), dq.dequant_mm_bf16x2(cfg, packed, x)
    want = dq.dequant_mm_plain(cfg, packed, x)
    torch.cuda.synchronize()
    xb = x.to(torch.bfloat16)
    return with_bound(dict(
        shape=shape, rel=rel_err(got, want), abs=float((got - want).abs().max()),
        control=rel_err(dequant_mm_variant(exact=False)(cfg, packed, x), want),
        equal=bool(torch.equal(got, again)),
        **kernel_times(lambda: dq.dequant_mm_bf16x2(cfg, packed, x),
                       lambda: dq.dequant_mm_plain(cfg, packed, x), lambda: xb @ w.T),
    ), nbytes(x, packed.codes_t, packed.codebook, packed.scales, got),
        2 * r * cfg.d_in * packed.d_out, "bf16")


@contextlib.contextmanager
def truncating_quantizers():
    """Put int8/int16 table quantizers that truncate instead of rounding half
    to even in place of the lookup's (a control)."""
    lg, _ = kernel_modules()
    saved = lg.quantize_lut_int8, lg.quantize_lut_int16

    def truncating(qmax, dtype):
        def quantize(lut, axis=-1):
            scale = lut.abs().amax(dim=axis, keepdim=True).clamp_min(1e-30) / qmax
            return torch.trunc(lut / scale).clamp(-qmax, qmax).to(dtype), scale
        return quantize

    lg.quantize_lut_int8 = truncating(127.0, torch.int8)
    lg.quantize_lut_int16 = truncating(32767.0, torch.int16)
    try:
        yield
    finally:
        lg.quantize_lut_int8, lg.quantize_lut_int16 = saved


def table_row(shape, cfg, packed, lut, variant, library, wrapper=None):
    """One table lookup through ``lut_gemv_packed`` against its plain
    version, with the variant's control (truncating quantizers; f32 tables
    rounded to bf16; bf16 tables left in f32).  ``ms``/``plain_ms`` time the
    kernel's wrapper and its plain version on the prebuilt (quantized)
    tables; ``wrapper``, a pair of calls (kernel path, plain path) such as
    ``lut_gemv`` and its ``plain=True``, is checked and timed too."""
    lg, _ = kernel_modules()
    got = lg.lut_gemv_packed(cfg, packed, lut, variant=variant)
    want = lg.lut_gemv_packed(cfg, packed, lut, variant=variant, plain=True)
    torch.cuda.synchronize()
    if variant in ("f32", "bpair"):
        tab = lut
        control_lut = lut.to(torch.bfloat16).float() if variant == "f32" else lut
        control = lg.lut_gemv_packed(cfg, packed, control_lut, variant="f32", plain=True)
    else:
        quantize = lg.quantize_lut_int8 if variant == "i8" else lg.quantize_lut_int16
        tab = quantize(lut, axis=(1, 2))[0]
        with truncating_quantizers():
            control = lg.lut_gemv_packed(cfg, packed, lut, variant=variant, plain=True)
    kernel, plain = {
        "bpair": (lg.lut_lookup, lg.lut_lookup_plain),
        "f32": (lg.lut_lookup_table, functools.partial(lg.lut_lookup_plain, round_bf16=False)),
    }.get(variant, (lg.lut_lookup_table, lg.lut_lookup_int_plain))
    args = (tab, packed.codes_t, packed.scales, packed.d_out)
    first, again = kernel(*args), kernel(*args)
    torch.cuda.synchronize()
    row = dict(shape=shape, rel=rel_err(got, want), abs=float((got - want).abs().max()),
               control=rel_err(control, want), equal=bool(torch.equal(first, again)),
               **kernel_times(lambda: kernel(*args), lambda: plain(*args), library, reps=20))
    if variant != "bpair" and packed.d_out != ANN_N:  # a projection: one launch
        row["call_kernels"] = launched_kernels(lambda: kernel(*args))
    if wrapper is not None:
        kernel_path, plain_path = wrapper
        y, y_plain = kernel_path(), plain_path()
        torch.cuda.synchronize()
        row["wrapper_rel"] = rel_err(y, y_plain)
        row["wrapper_ms"] = time_ms(kernel_path)
    b, g, _ = lut.shape
    return with_bound(row, nbytes(*args[:3], got), b * g * packed.d_out, "f32")


def phase_tables(device):
    """The table lookups against their plain versions at the scans of
    phase 5 (``TABLE_SCANS``: 8 queries' tables over a million codes at
    each group count a search gives a kernel, a lone query at K=128), and
    the f32, int8 and int16 ones at a Llama-2-7B projection through
    ``lut_gemv`` at one and eight tokens (the bf16 one's projection rows
    are phase_kernels')."""
    from tpu_lutvq_torch import VQConfig, VQParams, aqlm_2x8, init_vq_params
    from tpu_lutvq_torch.kernels.lut_ctor import build_lut

    lg, _ = kernel_modules()
    gen = torch.Generator(device).manual_seed(99)
    rows = {name: [] for name in TABLE_VARIANTS}
    for (b, g, k), names in TABLE_SCANS.items():
        cfg = VQConfig(8 * g, g, 1, k)
        codes = torch.randint(0, k, (ANN_N, g, 1), generator=gen, device=device,
                              dtype=torch.int32).to(torch.uint8)
        packed = lg.pack_params(cfg, VQParams(torch.zeros((1, 1, 1, 1), device=device), codes))
        lut = 100 * torch.rand((b, g, k), generator=gen, device=device)  # L2-like tables
        # the library call: the queries against a decoded (n, d) bf16 base
        base = torch.randn((ANN_N, cfg.d_in), generator=gen, device=device).to(torch.bfloat16)
        qb = torch.randn((b, cfg.d_in), generator=gen, device=device).to(torch.bfloat16)
        for name in names:
            rows[name].append(table_row(f"scan B={b} G={g} K={k} n={ANN_N}", cfg, packed, lut,
                                        TABLE_VARIANTS[name], lambda: qb @ base.T))
        del codes, packed, base
    cfg = aqlm_2x8(4096, shared_codebook=True)
    packed = lg.pack_params(cfg, init_vq_params(gen, cfg, 4096, with_scales=True))
    w = dense_bf16(cfg, packed)
    for b in (1, 8):
        x = torch.randn((b, 4096), generator=gen, device=device)
        xb = x.to(torch.bfloat16)
        for name, v in TABLE_VARIANTS.items():
            if v == "bpair":
                continue
            cdt = torch.float32 if v in ("f32", "i16") else torch.bfloat16
            lut = build_lut(cfg, packed.codebook, x, compute_dtype=cdt)
            wrapper = (lambda v=v, x=x: lg.lut_gemv(cfg, packed, x, variant=v),
                       lambda v=v, x=x: lg.lut_gemv(cfg, packed, x, variant=v, plain=True))
            rows[name].append(table_row(f"4096x4096 aqlm_2x8 B={b}", cfg, packed, lut, v,
                                        lambda: xb @ w.T, wrapper))
    for name, rs in rows.items():
        tol = TABLE_TOL[name]
        for r in rs:
            extra = ""
            if "wrapper_rel" in r:
                extra = (f"  lut_gemv(variant={TABLE_VARIANTS[name]!r}) rel err "
                         f"{r['wrapper_rel']:.3e}, {r['wrapper_ms']:.4f} ms")
            print(f"[kernels] {name} {r['shape']}: rel err {r['rel']:.3e} (tol {tol:.0e}, "
                  f"wrong-rounding control {r['control']:.3e}) abs err {r['abs']:.3e}  "
                  + times(r) + extra + f"  two calls bit-equal {r['equal']}"
                  + one_kernel_text(r))
            check(r["rel"] <= tol, f"{name} {r['shape']} disagrees with plain: {r['rel']}")
            check(r.get("wrapper_rel", 0.0) <= tol,
                  f"{name} {r['shape']}: lut_gemv disagrees with plain: {r.get('wrapper_rel')}")
            check(r["control"] > tol, f"{name} {r['shape']}: tolerance passes the control")
            check(r["equal"], f"{name} {r['shape']}: two calls differ")
            check_one_kernel(name, r)
    return rows


# --plans: the shapes the main paths give csrc/lut_scan.cu, (label, kind,
# tokens, groups, width, K): A and M at the Llama-2-7B projections and the
# padded d_out, K/H/I at phase 5's scans and a lone query, and at a 7B
# projection through lut_gemv(variant=f32|i8|i16)
PLAN_CASES = (
    ("A 4096x4096", 0, 1, 1024, 4096, 256), ("A 4096x11008", 0, 1, 1024, 11008, 256),
    ("A 11008x4096", 0, 1, 2752, 4096, 256), ("A 4096x1100", 0, 1, 1024, 1100, 256),
    ("K scan B=8 G=8", 1, 8, 8, ANN_N, 256), ("K scan B=8 G=16", 1, 8, 16, ANN_N, 256),
    ("H scan B=8 G=16", 2, 8, 16, ANN_N, 256), ("I scan B=8 G=16", 3, 8, 16, ANN_N, 256),
    ("K scan B=1 G=16 K=128", 1, 1, 16, ANN_N, 128), ("H scan B=1 G=16 K=128", 2, 1, 16, ANN_N, 128),
    ("I scan B=1 G=16 K=128", 3, 1, 16, ANN_N, 128),
    ("K 4096x4096 B=1", 1, 1, 1024, 4096, 256), ("K 4096x4096 B=8", 1, 8, 1024, 4096, 256),
    ("H 4096x4096 B=1", 2, 1, 1024, 4096, 256), ("H 4096x4096 B=8", 2, 8, 1024, 4096, 256),
    ("I 4096x4096 B=1", 3, 1, 1024, 4096, 256), ("I 4096x4096 B=8", 3, 8, 1024, 4096, 256),
)


def kernel_device_ms(fns, calls=5):
    """Each ``fn``'s device time, its one csrc/lut_scan.cu kernel's mean
    duration over ``calls`` calls, from one profiler run: the kernels
    are assigned to the functions in launch order."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            for _ in range(calls):
                fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                 and SCAN_KERNEL in e.name), key=lambda e: e.time_range.start)
    check(len(ev) == calls * len(fns), f"{len(ev)} kernels for {len(fns)} x {calls} calls")
    return [sum(e.time_range.elapsed_us() for e in ev[i * calls:(i + 1) * calls]) / calls / 1e3
            for i in range(len(fns))]


def phase_plans(device):
    """``--plans``: every candidate plan of ``plan_scan`` (``kernels/
    lut_gemv.py::scan_candidates``) at each of ``PLAN_CASES`` launched
    through the wrapper's ``plan=`` hook, held to the plain version (equal
    for the integer kinds, 1e-5 else) and timed on the device (profiler);
    then the plan the wrapper picks beside the fastest: the data the cost
    model's constants come from."""
    from tpu_lutvq_torch import VQConfig, VQParams

    lg, _ = kernel_modules()
    gen = torch.Generator(device).manual_seed(5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, kind, b, g, width, k in PLAN_CASES:
        cfg = VQConfig(8 * g, g, 1, k)
        codes = torch.randint(0, k, (width, g, 1), generator=gen, device=device,
                              dtype=torch.int32).to(torch.uint8)
        packed = lg.pack_params(cfg, VQParams(torch.zeros((1, 1, 1, 1), device=device), codes))
        del codes
        codes_t, d_out_pad = packed.codes_t, packed.codes_t.shape[1]
        scales = 1 + 0.1 * torch.rand((1, d_out_pad), generator=gen, device=device)
        lut = torch.randn((b, g, k), generator=gen, device=device)
        if kind == 2:
            lut = lg.quantize_lut_int8(lut, axis=(1, 2))[0]
        elif kind == 3:
            lut = lg.quantize_lut_int16(lut, axis=(1, 2))[0]
        if kind >= 2:
            want = lg.lut_lookup_int_plain(lut, codes_t, scales, width)
        else:
            want = lg.lut_lookup_plain(lut, codes_t, scales, width, round_bf16=kind == 0)
        bp = next(t for t in (1, 2, 4, 8) if t >= b)
        chosen = lg.plan_scan(kind, bp, g, d_out_pad, k, sms, lg._scan_fits)
        cands = sorted(lg.scan_candidates(kind, bp, g, d_out_pad, k, sms, lg._scan_fits),
                       key=lambda c: c[0])
        runs, rows = [], []
        for key, plan in cands:
            def run(plan=plan):
                return lg._run_scan(kind, lut, codes_t, scales, width, label, plan=plan)
            got = run()
            torch.cuda.synchronize()
            err = 0.0 if torch.equal(got, want) else rel_err(got, want)
            ok = err == 0.0 if kind >= 2 else err <= 1e-5
            runs.append(run)
            rows.append([None, key[0], err, ok, plan])
        for row, ms in zip(rows, kernel_device_ms(runs)):
            row[0] = ms
        print(f"[plans] {label}: {len(rows)} candidates; picked {chosen}")
        for ms, model, err, ok, plan in rows:
            tag = " <- picked" if plan == chosen else ""
            print(f"[plans]   {ms:.4f} ms model {model / 1980:.2f} us err {err:.2e}"
                  f"{'' if ok else ' WRONG'} threads {plan.threads} tc {plan.tile_cols} "
                  f"splits {plan.n_splits} stage {plan.stage_groups}x{plan.nbuf} "
                  f"grid {plan.grid}{tag}")
        best = min(rows, key=lambda r: r[0])
        picked = next(r for r in rows if r[4] == chosen)
        print(f"[plans] {label}: fastest {best[0]:.4f} ms ({best[4]}), picked {picked[0]:.4f} ms")
        check(all(r[3] for r in rows), f"{label}: a plan disagrees with plain")
        del packed, codes_t, lut, want


def truncating_fold(cfg, x, s):
    """``fold_activations_i8`` with x4/xs truncated instead of rounded half
    to even (a control)."""
    b = x.shape[0]
    x4 = x.float().reshape(b, 1, cfg.n_subvec, cfg.d_subvec) * s.permute(1, 0, 2)[None]
    xs = torch.clamp_min(x4.abs().amax(dim=(1, 2, 3)) / 127.0, 1e-12)
    x_i8 = torch.clamp(torch.trunc(x4 / xs[:, None, None, None]), -127, 127)
    return x_i8.to(torch.int8), xs


@contextlib.contextmanager
def truncating_folds():
    """Put :func:`truncating_fold` in place of the W8A8 activation fold."""
    _, dq = kernel_modules()
    saved = dq.fold_activations_i8
    dq.fold_activations_i8 = truncating_fold
    try:
        yield
    finally:
        dq.fold_activations_i8 = saved


def launched_kernels(fn, calls=5):
    """The CUDA kernels one warm ``fn()`` launches (torch.profiler, the
    counts of ``calls`` calls over ``calls``, rounded, each kernel's largest
    of three profiler sessions: the profiler can drop kernel events, up to
    every one of a session, and never adds one): {name: count}, without
    the fills of ``--guard``'s bands."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and not (GUARDING and "FillFunctor" in e.key):  # the guard bands' own fills
                counts[e.key] = max(counts.get(e.key, 0), round(e.count / calls))
    return {k: c for k, c in counts.items() if c}


def phase_tiers(device):
    """The precision tiers' kernels against their plain versions at the
    Llama-2-7B projection shapes: the W8A8 dequant-matmul (G) on the fold
    kernel's int8 inputs, bit for bit, two calls bit-equal, against a
    truncating fold; the fold kernel bit for bit ``fold_activations_i8``,
    against the same control; the kernels one whole ``dequant_matmul(tables=
    "i8")`` call launches (the profiler: the fold and G, the tables cached);
    the f32 one (L) against the bf16x2 function; ``pairf`` (M) equal to the
    ``pair`` kernel (A) on the same f32 table, against f32 entries (K's
    function).  ``wrapper_ms`` times the whole ``dequant_matmul``/``lut_gemv``
    call."""
    from tpu_lutvq_torch import VQConfig, aqlm_2x8, init_vq_params
    from tpu_lutvq_torch.kernels.lut_ctor import build_lut

    lg, dq = kernel_modules()
    gen = torch.Generator(device).manual_seed(777)
    rows = {"dequant_mm_i8": [], "fold_i8": [], "dequant_mm_f32": [], "lut_gemv_pairf": []}
    for d_in, d_out in SHAPES:
        cfg = aqlm_2x8(d_in, shared_codebook=True)
        packed = lg.pack_params(cfg, init_vq_params(gen, cfg, d_out, with_scales=True))
        w_bf16 = dense_bf16(cfg, packed)
        q, s = dq.tables_i8(cfg, packed.codebook)
        w_i8 = dq.weight_i8(cfg, packed, q).reshape(d_out, -1).contiguous()
        m = cfg.n_subvec
        for r in I8_ROWS:
            x = torch.randn((r, d_in), generator=gen, device=device)
            x_i8, xs = dq.fold_i8(cfg, x, s)  # the fold kernel: padded rows
            plain_x, plain_xs = dq.fold_activations_i8(cfg, x, s)
            trunc_x, trunc_xs = truncating_fold(cfg, x, s)
            args = (cfg, packed, x_i8, xs, q)
            got, again = dq.dequant_mm_i8(*args), dq.dequant_mm_i8(*args)
            want = dq.dequant_mm_i8_plain(*args)
            control = dq.dequant_mm_i8_plain(cfg, packed, trunc_x, trunc_xs, q)
            y = dq.dequant_matmul(cfg, packed, x, tables="i8")
            y_plain = dq.dequant_matmul(cfg, packed, x, tables="i8", plain=True)
            torch.cuda.synchronize()
            call_ks = launched_kernels(lambda: dq.dequant_matmul(cfg, packed, x, tables="i8"))
            rows["fold_i8"].append(with_bound(dict(
                shape=f"{d_in}x{d_out} rows={r}",
                rel=rel_err(x_i8[:, :, :m].float(), plain_x.float()),
                abs=float((x_i8[:, :, :m].float() - plain_x.float()).abs().max()),
                equal=bool(torch.equal(xs, plain_xs)) and not bool(x_i8[:, :, m:].any()),
                control=rel_err(trunc_x.float(), plain_x.float()), library="none",
                **kernel_times(lambda: dq.fold_i8(cfg, x, s),
                               lambda: dq.fold_activations_i8(cfg, x, s), None),
            ), nbytes(x, s, x_i8, xs), 2 * r * cfg.n_codebook * d_in, "f32"))
            x2 = plain_x.reshape(r, -1)
            # torch._int_mm's shape rules: more than 16 rows, K and N multiples of 8
            if r > 16 and x2.shape[1] % 8 == 0 and d_out % 8 == 0:
                library, call = (lambda: torch._int_mm(x2, w_i8.T)), "torch._int_mm int8"
            else:
                xb = x.to(torch.bfloat16)
                library, call = (lambda: xb @ w_bf16.T), "x @ W.T bf16"
            rows["dequant_mm_i8"].append(with_bound(dict(
                shape=f"{d_in}x{d_out} rows={r}", rel=rel_err(got, want),
                equal=bool(torch.equal(got, want)), abs=float((got - want).abs().max()),
                calls_equal=bool(torch.equal(got, again)), call_kernels=call_ks,
                control=rel_err(control, want), wrapper_rel=rel_err(y, y_plain),
                **kernel_times(lambda: dq.dequant_mm_i8(*args),
                               lambda: dq.dequant_mm_i8_plain(*args), library),
                library=call,
                wrapper_ms=time_ms(lambda: dq.dequant_matmul(cfg, packed, x, tables="i8"),
                                   reps=10),
            ), nbytes(x_i8, xs, packed.codes_t, q, packed.scales, got),
                2 * r * x2.shape[1] * d_out, "int8"))
        del w_i8
        for r in F32_ROWS:
            rows["dequant_mm_f32"].append(f32_row(f"{d_in}x{d_out} rows={r}", cfg, packed, r,
                                                  gen))
        x = torch.randn((1, d_in), generator=gen, device=device)
        lut = build_lut(cfg, packed.codebook, x, compute_dtype=torch.bfloat16)
        args = (lut, packed.codes_t, packed.scales, packed.d_out)
        got, pair, want = lg.lut_lookup_pairf(*args), lg.lut_lookup(*args), lg.lut_lookup_plain(*args)
        again = lg.lut_lookup_pairf(*args)
        y = lg.lut_gemv(cfg, packed, x, variant="pairf")
        y_pair = lg.lut_gemv(cfg, packed, x, variant="pair")
        torch.cuda.synchronize()
        xb = x.to(torch.bfloat16)
        rows["lut_gemv_pairf"].append(with_bound(dict(
            shape=f"{d_in}x{d_out} B=1", rel=rel_err(got, want),
            equal=bool(torch.equal(got, pair)) and bool(torch.equal(y, y_pair)),
            calls_equal=bool(torch.equal(got, again)),
            call_kernels=launched_kernels(lambda: lg.lut_lookup_pairf(*args)),
            floor_ms=lookup_floor_ms(cfg.n_groups * packed.codes_t.shape[1] * 4),
            abs=float((got - want).abs().max()),
            control=rel_err(lg.lut_lookup_plain(*args, round_bf16=False), want),
            **kernel_times(lambda: lg.lut_lookup_pairf(*args),
                           lambda: lg.lut_lookup_plain(*args), lambda: xb @ w_bf16.T, reps=20,
                           plain_reps=20),
            pair_ms=time_ms(lambda: lg.lut_lookup(*args)), library="x @ W.T bf16",
            wrapper_ms=time_ms(lambda: lg.lut_gemv(cfg, packed, x, variant="pairf")),
        ), nbytes(*args[:3], got), cfg.n_groups * d_out, "f32"))
        del w_bf16
    for name, d_in, d_out, d, shared in PATH_CASES:
        cfg = VQConfig(d_in, d_in // d, 2, 256, shared_codebook=shared)
        packed = lg.pack_params(cfg, init_vq_params(gen, cfg, d_out, with_scales=True))
        for r in PATH_ROWS:
            rows["dequant_mm_f32"].append(f32_row(f"{name} {d_in}x{d_out} rows={r}", cfg,
                                                  packed, r, gen))
        del packed
    for name, rs in rows.items():
        tol = TIER_TOL[name]
        for r in rs:
            extra = ""
            if "wrapper_ms" in r:
                extra = f"  whole call {r['wrapper_ms']:.4f} ms"
            if "pair_ms" in r:
                extra += f"  pair kernel {r['pair_ms']:.4f} ms"
            if name == "dequant_mm_f32":
                extra += f"  two calls bit-equal {r['equal']}"
            if name == "fold_i8":
                extra += f"  xs equal, padding zero {r['equal']}"
            if "calls_equal" in r and name == "lut_gemv_pairf":
                extra += (f"  two calls bit-equal {r['calls_equal']}" + floor_text(r["floor_ms"])
                          + one_kernel_text(r))
            elif "calls_equal" in r:
                n_call = sum(r["call_kernels"].values())
                extra += (f"  two calls bit-equal {r['calls_equal']}  whole call launches "
                          f"{n_call} kernels: " + ", ".join(
                              f"{k[:40]} x{c}" for k, c in r["call_kernels"].items()))
            print(f"[kernels] {name} {r['shape']}: rel err {r['rel']:.3e} (tol {tol:.0e}, "
                  f"wrong-rounding control {r['control']:.3e}) abs err {r['abs']:.3e}  "
                  + times(r) + f" [library: {r['library']}]" + extra)
            check(r["rel"] <= tol, f"{name} {r['shape']} disagrees with plain: {r['rel']}")
            check(r["control"] > tol, f"{name} {r['shape']}: tolerance passes the control")
            check(r.get("equal", True), f"{name} {r['shape']}: not equal to its reference")
            check(r.get("calls_equal", True), f"{name} {r['shape']}: two calls differ")
            if name == "lut_gemv_pairf":
                check_one_kernel(name, r)
            elif "call_kernels" in r:
                ks = r["call_kernels"]
                check(sum(ks.values()) == 2 and any("fold_i8" in k for k in ks)
                      and any("dequant_mm_i8" in k for k in ks),
                      f"{name} {r['shape']}: dequant_matmul(tables='i8') launched {ks}")
            check(r.get("wrapper_rel", 0.0) == 0.0,
                  f"{name} {r['shape']}: dequant_matmul differs from plain: {r.get('wrapper_rel')}")
    return rows


def phase_shapes(device):
    """C and G (with the fold) at ``SHAPE_CASES``: each against its plain
    version (C within 2e-4 against a wrong-rounding control, G and the fold
    bit for bit against a truncating fold), two calls bit-equal, and one
    whole ``dequant_matmul`` call of each table launching its kernels: C
    alone (its split reduce where d_in is split), the fold and G."""
    import tpu_lutvq_torch as c

    lg, dq = kernel_modules()
    gen = torch.Generator(device).manual_seed(4242)
    rows = {"dequant_mm": [], "dequant_mm_i8": [], "fold_i8": []}
    for name, make, d_out in SHAPE_CASES:
        cfg = make(c)
        packed = lg.pack_params(cfg, c.init_vq_params(gen, cfg, d_out, with_scales=True))
        w = dense_bf16(cfg, packed)
        for r in SHAPE_ROWS:
            shape = f"{name} {cfg.d_in}x{d_out} rows={r}"
            row = dequant_row(shape, cfg, packed, w, r, gen)
            x = torch.randn((r, cfg.d_in), generator=gen, device=device)
            if row["control"] <= KERNEL_TOL["dequant_mm"]:
                # one codebook (PQ), or sums exact in bf16 (T-MAC's ±2^n
                # entries): the control leaves x unrounded instead
                want = dq.dequant_mm_plain(cfg, packed, x)
                row["rel"] = max(row["rel"], rel_err(dq.dequant_mm_bf16x2(cfg, packed, x), want))
                row["control"] = rel_err(dq._scaled(x @ dq.dequant_weight(cfg, packed).T,
                                                    packed), want)
            row["call_kernels"] = launched_kernels(lambda: dq.dequant_matmul(cfg, packed, x))
            rows["dequant_mm"].append(row)
            if cfg.d_subvec % 4:
                continue
            q, s = dq.tables_i8(cfg, packed.codebook)
            x_i8, xs = dq.fold_i8(cfg, x, s)
            plain_x, plain_xs = dq.fold_activations_i8(cfg, x, s)
            trunc_x, trunc_xs = truncating_fold(cfg, x, s)
            args = (cfg, packed, x_i8, xs, q)
            got, again = dq.dequant_mm_i8(*args), dq.dequant_mm_i8(*args)
            want = dq.dequant_mm_i8_plain(*args)
            control = dq.dequant_mm_i8_plain(cfg, packed, trunc_x, trunc_xs, q)
            y = dq.dequant_matmul(cfg, packed, x, tables="i8")
            y_plain = dq.dequant_matmul(cfg, packed, x, tables="i8", plain=True)
            torch.cuda.synchronize()
            m = cfg.n_subvec
            rows["fold_i8"].append(with_bound(dict(
                shape=shape, rel=rel_err(x_i8[:, :, :m].float(), plain_x.float()),
                abs=float((x_i8[:, :, :m].float() - plain_x.float()).abs().max()),
                equal=bool(torch.equal(xs, plain_xs)) and not bool(x_i8[:, :, m:].any()),
                control=rel_err(trunc_x.float(), plain_x.float()),
                **kernel_times(lambda: dq.fold_i8(cfg, x, s),
                               lambda: dq.fold_activations_i8(cfg, x, s), None),
            ), nbytes(x, s, x_i8, xs), 2 * r * cfg.n_codebook * cfg.d_in, "f32"))
            x2 = plain_x.reshape(r, -1)
            if r > 16 and x2.shape[1] % 8 == 0 and d_out % 8 == 0:
                w_i8 = dq.weight_i8(cfg, packed, q).reshape(d_out, -1).contiguous()
                library = lambda: torch._int_mm(x2, w_i8.T)  # noqa: E731
            else:
                xb = x.to(torch.bfloat16)
                library = lambda: xb @ w.T  # noqa: E731
            rows["dequant_mm_i8"].append(with_bound(dict(
                shape=shape, rel=rel_err(got, want), equal=bool(torch.equal(got, want)),
                abs=float((got - want).abs().max()), calls_equal=bool(torch.equal(got, again)),
                control=rel_err(control, want), wrapper_rel=rel_err(y, y_plain),
                call_kernels=launched_kernels(
                    lambda: dq.dequant_matmul(cfg, packed, x, tables="i8")),
                **kernel_times(lambda: dq.dequant_mm_i8(*args),
                               lambda: dq.dequant_mm_i8_plain(*args), library),
            ), nbytes(x_i8, xs, packed.codes_t, q, packed.scales, got),
                2 * r * x2.shape[1] * d_out, "int8"))
        del w, packed
    for name, rs in rows.items():
        tol = TIER_TOL.get(name, KERNEL_TOL.get(name))
        for r in rs:
            ks = r.pop("call_kernels", None)
            print(f"[shapes] {name} {r['shape']}: rel err {r['rel']:.3e} (tol {tol:.0e}, "
                  f"control {r['control']:.3e}) abs err {r['abs']:.3e}  " + times(r)
                  + ("" if ks is None else "  whole call: " + ", ".join(
                      f"{k[:40]} x{n}" for k, n in ks.items())))
            check(r["rel"] <= tol, f"{name} {r['shape']} disagrees with plain: {r['rel']}")
            check(r["control"] > tol, f"{name} {r['shape']}: tolerance passes the control")
            check(r.get("equal", True), f"{name} {r['shape']}: not equal to its reference")
            check(r.get("calls_equal", True), f"{name} {r['shape']}: two calls differ")
            check(r.get("wrapper_rel", 0.0) == 0.0,
                  f"{name} {r['shape']}: dequant_matmul differs from plain")
            if ks is not None and name == "dequant_mm":
                check(any("dequant_mm_bf16x2" in k or "dequant_mm_any" in k for k in ks)
                      and all("dequant_mm" in k or "copy" in k.lower() for k in ks),
                      f"{name} {r['shape']}: dequant_matmul launched {ks}")
            elif ks is not None:
                check(sum(ks.values()) == 2 and any("fold_i8" in k for k in ks)
                      and any("dequant_mm_i8" in k for k in ks),
                      f"{name} {r['shape']}: dequant_matmul(tables='i8') launched {ks}")
    return rows


def report_2x8_times(rows):
    """The 2x8 d_subvec 8 rows' device times beside PERF.md's (a card set
    below 700 W reads slower, so this prints and does not gate)."""
    for (name, shape), was in PERF_MD_MS.items():
        r = next(r for r in rows[name] if r["shape"] == shape)
        print(f"[2x8] {name} {shape}: device {r['device_ms']:.4f} ms, PERF.md {was:.4f} ms "
              f"({r['device_ms'] / was:.3f}x, {'within' if r['device_ms'] <= 1.1 * was else 'over'}"
              " 10 %)")


def f32_row(shape, cfg, packed, r, gen):
    """L against its plain version at ``r`` rows, the bf16x2 function as the
    control, and two calls bit for bit (``equal``)."""
    _, dq = kernel_modules()
    x = torch.randn((r, cfg.d_in), generator=gen, device=packed.codes_t.device)
    got, again = dq.dequant_mm_f32(cfg, packed, x), dq.dequant_mm_f32(cfg, packed, x)
    want = dq.dequant_mm_f32_plain(cfg, packed, x)
    torch.cuda.synchronize()
    w_f32 = dq.dequant_weight(cfg, packed, round_bf16=False)
    return with_bound(dict(
        shape=shape, rel=rel_err(got, want), abs=float((got - want).abs().max()),
        control=rel_err(dq.dequant_mm_plain(cfg, packed, x), want),
        equal=bool(torch.equal(got, again)),
        **kernel_times(lambda: dq.dequant_mm_f32(cfg, packed, x),
                       lambda: dq.dequant_mm_f32_plain(cfg, packed, x), lambda: x @ w_f32.T),
        library="x @ W.T f32",
    ), nbytes(x, packed.codes_t, packed.codebook.float(), packed.scales, got),
        2 * r * cfg.d_in * packed.d_out, "f32")


def tmac_layer(gen, d_in, d_out):
    """A T-MAC W4 layer (scales and zero points) from ``gen``: (cfg,
    params, nibble pack)."""
    from tpu_lutvq_torch import init_vq_params, tmac

    lg, _ = kernel_modules()
    cfg = tmac(d_in, bits=4, group=4)
    params = init_vq_params(gen, cfg, d_out, with_scales=True, with_zeros=True)
    return cfg, params, lg.pack_params(cfg, params, nibble_pack=True)


def phase_nibbles(device):
    """Kernel J against its plain version at the T-MAC W4 shapes
    (``TMAC_SHAPES``): J1 at one token, J2 at 2, 8 and 16 (two launches),
    each through ``lut_gemv_packed`` over the f32 tables ``lut_gemv`` builds
    for it (J2 rounds them to bf16), with the wrong-precision control.
    ``ms`` times that lookup (events, L2 flushed: the host's dispatch
    included), ``device_ms`` the card's kernels alone (profiler),
    ``wrapper_ms`` the whole ``lut_gemv`` call (table build, lookup,
    zero-point epilogue); the library call is ``x @ W.T`` in bf16 over the
    dequantized weight."""
    from tpu_lutvq_torch.core.golden import dequantize
    from tpu_lutvq_torch.kernels.lut_ctor import build_lut

    lg, _ = kernel_modules()
    gen = torch.Generator(device).manual_seed(4242)
    rows = {name: [] for name in NIBBLE_BATCHES}
    for d_in, d_out in TMAC_SHAPES:
        cfg, params, packed = tmac_layer(gen, d_in, d_out)
        w = dequantize(cfg, params).to(torch.bfloat16)
        for name, batches in NIBBLE_BATCHES.items():
            for b in batches:
                x = torch.randn((b, d_in), generator=gen, device=device)
                f32 = name == "lut_gemv_nibbles"
                lut = build_lut(cfg, packed.codebook, x,
                                compute_dtype=torch.float32 if f32 else torch.bfloat16)
                got = lg.lut_gemv_packed(cfg, packed, lut)
                again = lg.lut_gemv_packed(cfg, packed, lut)
                want = lg.lut_gemv_packed(cfg, packed, lut, plain=True)
                # the other table precision, through the same plain version
                wrong = lut.to(torch.bfloat16) if f32 else lut
                control = torch.cat([
                    lg.lut_lookup_nibbles_plain(wrong[i : i + 8], packed.codes_t,
                                                packed.scales, packed.d_out)
                    for i in range(0, b, 8)])
                torch.cuda.synchronize()
                xb = x.to(torch.bfloat16)
                n_bytes = nbytes(packed.codes_t, packed.scales, got) + (
                    b * cfg.n_groups * 16 * (4 if f32 else 2))
                # the lookup floor: two entries of each launch's token tile
                # (bf16, J2; one f32 token, J1) from shared memory per code
                # byte and column
                tiles = [min(8, b - i) for i in range(0, b, 8)]
                smem = sum(packed.codes_t.shape[0] * packed.codes_t.shape[1] * 2 *
                           (4 if n == 1 else 2 * next(t for t in (2, 4, 8) if t >= n))
                           for n in tiles)
                floor = lookup_floor_ms(smem)
                if f32:  # one launch a call: no copy of the table, no reduce kernel
                    launched = launched_kernels(lambda: lg.lut_gemv_packed(cfg, packed, lut))
                    print(f"[kernels] lut_gemv_nibbles tmac {d_in}x{d_out} B=1: one call launches "
                          + ", ".join(f"{k[:60]} x{n}" for k, n in launched.items()))
                    check(list(launched.values()) == [1] and "lut_nibbles_f32" in next(
                        iter(launched)), f"J1 tmac {d_in}x{d_out}: one call launched {launched}")
                rows[name].append(with_bound(dict(
                    shape=f"tmac {d_in}x{d_out} B={b}", rel=rel_err(got, want),
                    abs=float((got - want).abs().max()), control=rel_err(control, want),
                    equal=bool(torch.equal(got, again)), floor_ms=floor,
                    **kernel_times(lambda: lg.lut_gemv_packed(cfg, packed, lut),
                                   lambda: lg.lut_gemv_packed(cfg, packed, lut, plain=True),
                                   lambda: xb @ w.T, reps=20),
                    wrapper_ms=time_ms(lambda: lg.lut_gemv(cfg, packed, x)),
                ), n_bytes, b * cfg.n_groups * d_out, "f32"))
                del lut, got, again, want, control
        del w, packed, params
    for name, rs in rows.items():
        for r in rs:
            print(f"[kernels] {name} {r['shape']}: rel err {r['rel']:.3e} (tol "
                  f"{NIBBLE_TOL:.0e}, wrong-precision control {r['control']:.3e}) abs err "
                  f"{r['abs']:.3e}  " + times(r) + floor_text(r["floor_ms"]) + f"  whole lut_gemv "
                  f"{r['wrapper_ms']:.4f} ms  two calls bit-equal {r['equal']}")
            check(r["rel"] <= NIBBLE_TOL, f"{name} {r['shape']} disagrees with plain: {r['rel']}")
            check(r["equal"], f"{name} {r['shape']}: two calls differ")
            check(r["control"] > NIBBLE_TOL, f"{name} {r['shape']}: tolerance passes the control")
    return rows


def kv_cache(gen, lead, dh, kv_dtype, device):
    """Random K, V and their row scales: int8 values with scales in
    [0.005, 0.02), or bf16 values with unit scales."""
    shape = lead + (dh,)
    if kv_dtype == "int8":
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=device,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(lead, generator=gen, device=device) * 0.015 + 0.005
                  for _ in range(2))
    else:
        k, v = (torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
                for _ in range(2))
        ks, vs = torch.ones(lead, device=device), torch.ones(lead, device=device)
    return [k, v, ks, vs]


def poison_past(cache, last):
    """Rows past ``last[b]`` (per sequence) get large values: a mask error
    shows.  ``cache`` is (k, v, ks, vs) of a (B, H_kv, S, Dh) slab."""
    k = cache[0]
    rows = torch.arange(k.shape[2], device=k.device)
    past = (rows[None, :] > last[:, None])[:, None, :, None]  # (B, 1, S, 1)
    big = 127 if k.dtype == torch.int8 else 30000.0
    for t in cache[:2]:
        t.masked_fill_(past, big)


def to_pool(cache, gen, page):
    """The slab's rows as a pool of ``page``-row blocks behind a shuffled
    block table (block 0 left as junk): (pool k, v, ks, vs, tables)."""
    k = cache[0]
    b, hkv, s_max = k.shape[:3]
    per = s_max // page
    tables = (torch.randperm(b * per, generator=gen, device=k.device) + 1).reshape(b, per)
    pool = []
    for t in cache:
        blocks = t.reshape((b, hkv, per, page) + t.shape[3:]).transpose(1, 2)
        p = torch.zeros((b * per + 1, hkv, page) + t.shape[3:], dtype=t.dtype, device=t.device)
        p[tables.reshape(-1)] = blocks.reshape((b * per, hkv, page) + t.shape[3:])
        pool.append(p)
    return pool + [tables.to(torch.int32)]


def live_controls(dh):
    """The controls that move a rounding at this head_dim: where sm_scale =
    dh**-0.5 is a power of two (dh 64), scaling commutes with the bf16
    rounding of q and ``q_scale`` computes the same function."""
    return tuple(c for c in ATTN_CONTROLS if c != "q_scale" or math.log2(dh) % 2)


def attention_row(shape, kernel, plain, dh, library, work):
    """Kernel against plain version (and the controls) on the same inputs,
    and two kernel calls bit for bit (``equal``); ``library`` is the SDPA
    call on dequantized K/V, ``work`` the (bytes, operations) the attention
    needs."""
    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    controls = {}
    for c in live_controls(dh):
        with attention_control(c):
            controls[c] = rel_err(plain(), want)
    return with_bound(dict(
        shape=shape, rel=rel_err(got, want), abs=float((got - want).abs().max()),
        control=controls, equal=bool(torch.equal(got, again)),
        **kernel_times(kernel, plain, library, reps=20, plain_reps=10)), *work, "bf16")


def dequant_kv(cache, rows, rep):
    """The cache's first ``rows`` rows as bf16 K and V, each kv head
    repeated for its ``rep`` query heads: (B, H, rows, Dh) each."""
    return [(t[:, :, :rows].float() * s[:, :, :rows, None]).to(torch.bfloat16)
            .repeat_interleave(rep, dim=1) for t, s in ((cache[0], cache[2]), (cache[1], cache[3]))]


def sdpa(q, k, v, mask):
    return lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def attention_work(q, cache, rows, queries, out, extra=0):
    """(bytes, operations) of attention over ``rows[b]`` cache rows per
    sequence and ``queries[b]`` score rows (Σ over a sequence's queries of
    the rows each attends): K, V and their scales read once, q and the
    output once, two multiply-adds per (query, row, head, dim)."""
    k = cache[0]
    hkv, dh = k.shape[1], k.shape[3]
    h = q.shape[-2]
    row_bytes = 2 * hkv * (dh * k.element_size() + 4)
    return (row_bytes * int(rows.sum()) + nbytes(q, out) + extra,
            4 * h * dh * int(queries.sum()))


def phase_attention(device):
    """The flash kernels against their plain versions, with controls."""
    from tpu_lutvq_torch.runtime.generate import bucket_window

    from tpu_lutvq_torch.models.kv_cache import quantize_kv

    fd, fp = attention_modules()
    gen = torch.Generator(device).manual_seed(4321)
    # quantize_kv's IEEE division on the card: a batch of 7B-width K/V rows,
    # values and scales bit for bit against the same call on the CPU (a
    # generator of its own: the kernel rows below keep their inputs)
    x = torch.randn((8, 256, 32, 128), generator=torch.Generator(device).manual_seed(4322),
                    device=device) * 3
    (q_gpu, s_gpu), (q_cpu, s_cpu) = quantize_kv(x), quantize_kv(x.cpu())
    same = torch.equal(q_gpu.cpu(), q_cpu) and torch.equal(s_gpu.cpu(), s_cpu)
    print(f"[kernels] quantize_kv (8, 256, 32, 128) on the card equals the CPU's bit for bit: "
          f"{same}")
    check(same, "quantize_kv on the card differs from the CPU")
    del x, q_gpu, s_gpu
    rows = {"flash_decode": [], "flash_decode_paged": [], "flash_prefill": []}
    for b, h, hkv, window, pos, kv_dtype, dh in DECODE_CASES:
        pos_t = torch.tensor(pos, dtype=torch.int32, device=device)
        cache = kv_cache(gen, (b, hkv, S_MAX), dh, kv_dtype, device)
        poison_past(cache, pos_t)
        q = torch.randn((b, h, dh), generator=gen, device=device)
        shape = f"B={b} H={h}/{hkv} W={window} {kv_dtype} Dh={dh}"

        def slab(plain, cache=cache, q=q, pos_t=pos_t, window=window):
            return fd.flash_decode_attention(q, *cache, pos_t, window=window, plain=plain)

        k, v = dequant_kv(cache, window, h // hkv)
        mask = (torch.arange(window, device=device)[None, :] <= pos_t[:, None])[:, None, None]
        library = sdpa(q[:, :, None].to(torch.bfloat16), k, v, mask)
        n_rows = pos_t.long() + 1
        work = attention_work(q, cache, n_rows, n_rows, q)
        rows["flash_decode"].append(
            attention_row(shape, lambda: slab(False), lambda: slab(True), dh, library, work))
        pool = to_pool(cache, gen, PAGE)

        def paged(plain, pool=pool, q=q, pos_t=pos_t, window=window):
            return fd.flash_decode_paged(q, *pool, pos_t, window=window, plain=plain)

        tables = 4 * int((-(-n_rows // PAGE)).sum())  # the block-table entries read
        rows["flash_decode_paged"].append(attention_row(
            f"{shape} BS={PAGE}", lambda: paged(False), lambda: paged(True), dh, library,
            attention_work(q, cache, n_rows, n_rows, q, extra=tables)))
        del k, v
    spans = [c + (S_MAX, fp.DEFAULT_BLOCK_S) for c in PREFILL_CASES] + list(PREFILL_SPANS)
    for h, hkv, t, offsets, kv_dtype, dh, s_max, block_s in spans:
        b = len(offsets)
        off = torch.tensor(offsets, dtype=torch.int32, device=device)
        cache = kv_cache(gen, (b, hkv, s_max), dh, kv_dtype, device)
        poison_past(cache, off + t - 1)
        q = torch.randn((b, t, h, dh), generator=gen, device=device)
        window = bucket_window(max(offsets) + t, s_max)

        def pre(plain, cache=cache, q=q, off=off, window=window, block_s=block_s):
            return fp.flash_prefill_attention(q, *cache, off, window=window, block_s=block_s,
                                              plain=plain)

        k, v = dequant_kv(cache, window, h // hkv)
        causal = off[:, None] + torch.arange(t, device=device)[None, :]  # (B, T) last row
        mask = (torch.arange(window, device=device)[None, None, :] <= causal[..., None])[:, None]
        library = sdpa(q.transpose(1, 2).to(torch.bfloat16), k, v, mask)
        attended = t * off.long() + t * (t + 1) // 2  # Σ_t (off + t + 1) per sequence
        extra = "" if (s_max, block_s) == (S_MAX, fp.DEFAULT_BLOCK_S) else (
            f" S={s_max} BS={block_s}")
        rows["flash_prefill"].append(attention_row(
            f"B={b} H={h}/{hkv} T={t} off={offsets} {kv_dtype} Dh={dh}{extra}",
            lambda: pre(False), lambda: pre(True), dh, library,
            attention_work(q, cache, off.long() + t, attended, q)))
        del k, v
    for name, rs in rows.items():
        tol = ATTN_TOL[name]
        for r in rs:
            ctl = " ".join(f"{c} {v:.3e}" for c, v in r["control"].items())
            print(f"[kernels] {name} {r['shape']}: rel err {r['rel']:.3e} (tol {tol:.0e}, "
                  f"controls {ctl}) abs err {r['abs']:.3e}  " + times(r)
                  + f"  two calls bit-equal {r['equal']}")
            check(r["rel"] <= tol, f"{name} {r['shape']} disagrees with plain: {r['rel']}")
            check(r["equal"], f"{name} {r['shape']}: two calls differ")
            for c, v in r["control"].items():
                check(v > tol, f"{name} {r['shape']}: tolerance passes the {c} control ({v})")
    return rows


def prefill(cfg, weights, prompts, plain, **kw):
    """Prefill last-position logits and the caches, as ``generate()``
    computes them (ragged layout, per-sequence positions); ``kw`` goes to
    ``llama_forward`` (``strategy``)."""
    from tpu_lutvq_torch.models.llama import init_caches, llama_forward
    from tpu_lutvq_torch.runtime.generate import bucket_window, pad_prompts

    toks, lens = pad_prompts(prompts, cfg.max_seq, weights.embed.device)
    caches = init_caches(cfg, len(prompts), device=weights.embed.device)
    logits, caches = llama_forward(
        cfg, weights, toks, caches, 0, window=bucket_window(toks.shape[1], cfg.max_seq),
        logits_mode="index", logits_idx=lens - 1, plain=plain, **kw,
    )
    return logits[:, 0], caches, lens


def logits_errors(cfg, weights, prompts, **kw):
    """Prefill last-position and first-decode-step logits of each run against
    the plain run's, as (prefill, step) errors.  Every step starts from the
    kernel run's caches and token, so it measures the step alone.  Runs: the
    kernels, and the ``REFERENCE_RUNS`` (noise floors and a control); ``kw``
    goes to every forward (``strategy``)."""
    from tpu_lutvq_torch.models.llama import llama_decode_step
    from tpu_lutvq_torch.runtime.generate import bucket_window

    pre_k, caches, lens = prefill(cfg, weights, prompts, plain=False, **kw)
    tok = pre_k.argmax(-1).to(torch.int32)
    window = bucket_window(int(lens.max()) + 1, cfg.max_seq)

    def step(plain):
        copy = tuple(type(c)(*(t.clone() for t in c)) for c in caches)
        return llama_decode_step(cfg, weights, tok, copy, lens, window=window, plain=plain,
                                 **kw)[0]

    pre_p, step_p = prefill(cfg, weights, prompts, plain=True, **kw)[0], step(True)
    step_k = step(False)
    finite = bool(torch.isfinite(pre_k).all() and torch.isfinite(step_k).all())
    errs = {"kernel": (rel_err(pre_k, pre_p), rel_err(step_k, step_p))}
    for name, variant in REFERENCE_RUNS.items():
        with plain_versions(**variant):
            pre = prefill(cfg, weights, prompts, plain=True, **kw)[0]
            errs[name] = (rel_err(pre, pre_p), rel_err(step(True), step_p))
    return errs, finite


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def model(device):
    """The Llama-2-7B-geometry model with random weights from seed 0."""
    from tpu_lutvq_torch.models.llama import LlamaConfig, init_llama

    cfg = LlamaConfig.llama2_7b()
    weights, secs = timed(lambda: init_llama(cfg, torch.Generator(device).manual_seed(0)))
    print(f"[model] Llama-2-7B geometry, {cfg.n_layers} layers, init {secs:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return cfg, weights


def slice_requests(cfg):
    """Phase 3's requests from a seeded generator: (a) a ragged B=4 batch for
    32 new tokens, (b) one 16-token prompt for 16, both ``strategy="auto"``;
    (c) (b)'s prompt through the lookups (``strategy="lut_gemv"``: A decodes,
    B prefills), which ``auto`` no longer takes at this geometry."""
    ids = torch.Generator().manual_seed(1)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=ids).tolist()

    a, b = [prompt(n) for n in (7, 19, 33, 64)], [prompt(16)]
    return {"a": dict(prompts=a, new=32, strategy="auto"),
            "b": dict(prompts=b, new=16, strategy="auto"),
            "c": dict(prompts=b, new=16, strategy="lut_gemv")}


def phase_slice(device, cfg, weights):
    from tpu_lutvq_torch.runtime import generate
    from tpu_lutvq_torch.runtime.generate import pad_prompts

    requests = slice_requests(cfg)
    generate(cfg, weights, requests["b"]["prompts"], 2)  # warm-up: lazy inits
    for r in requests.values():  # prefill-only timing runs, before the counted run
        _, r["prefill_s"] = timed(lambda: generate(cfg, weights, r["prompts"], 1,
                                                   strategy=r["strategy"]))

    # A (one row), B (2-8 rows), C: each where pick_strategy routes the
    # prefill's and the decode steps' rows
    names = ("lut_gemv", "lut_gemv_bpair", "dequant_mm")
    for k in names:
        setattr(*counters()[k], 0)
    for name, r in requests.items():
        before = [getattr(*counters()[k]) for k in names]
        r["res"], r["total_s"] = timed(lambda: generate(cfg, weights, r["prompts"], r["new"],
                                                        strategy=r["strategy"]))
        r["launches"] = [getattr(*counters()[k]) - n for k, n in zip(names, before)]
        rows = pad_prompts(r["prompts"], cfg.max_seq, "cpu")[0].numel()
        check_routes(f"request {name}", dict(zip(names, r["launches"])),
                     [routed_launches(cfg, rows, strategy=r["strategy"]),
                      routed_launches(cfg, len(r["prompts"]), strategy=r["strategy"])], names)
    launches = {k: getattr(*counters()[k]) for k in names}

    for name, r in requests.items():
        lens = [len(p) for p in r["prompts"]]
        b, new = len(lens), r["new"]
        toks, lengths = r["res"].tokens, r["res"].lengths
        check(toks.shape == (b, max(lens) + new), f"request {name}: tokens {tuple(toks.shape)}")
        check(lengths.tolist() == [n + new for n in lens], f"request {name}: lengths {lengths}")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"request {name}: token ids")
        for i, n in enumerate(lens):
            check(toks[i, :n].tolist() == r["prompts"][i], f"request {name}: prompt {i} altered")
        # logits against a re-run through the plain versions
        r["errs"], finite = logits_errors(cfg, weights, r["prompts"], strategy=r["strategy"])
        check(finite, f"request {name}: non-finite logits")
        plain_toks = generate(cfg, weights, r["prompts"], new, plain=True,
                              strategy=r["strategy"]).tokens
        agree = sum(
            int((toks[i, n : n + new] == plain_toks[i, n : n + new]).sum())
            for i, n in enumerate(lens)
        ) / (b * new)
        decode_tps = b * (new - 1) / (r["total_s"] - r["prefill_s"])
        print(f"[slice] request {name}: B={b} prompts {lens} new {new} strategy "
              f"{r['strategy']}; launches "
              + " ".join(f"{k} {n}" for k, n in zip(names, r["launches"])) + "; tokens agreeing "
              f"with plain {agree:.3f}; prefill {1e3 * r['prefill_s']:.1f} ms; decode "
              f"{decode_tps:.1f} tok/s (host clock, {r['total_s']:.2f} s total)")
        print(f"[slice] request {name}: logits rel err vs plain, prefill/step: " + ", ".join(
            f"{run} {pre:.3e}/{stp:.3e}" for run, (pre, stp) in r["errs"].items()))
    for name, r in requests.items():
        errs = r["errs"]
        floor = max(max(errs[run]) for run in REFERENCE_RUNS if run.startswith("floor"))
        check(max(errs["kernel"]) <= LOGITS_TOL, f"request {name}: logits disagree {errs}")
        check(floor <= LOGITS_TOL, f"request {name}: plain-vs-plain noise over the tolerance")
        check(max(errs["control"]) > LOGITS_TOL, f"request {name}: tolerance passes the control")
    return launches


def step_errors(cfg, weights, caches, tok, pos):
    """A B=8 flash decode step from ``caches`` through the kernels, against
    the plain versions' step, and the ``REFERENCE_RUNS`` against it."""
    from tpu_lutvq_torch.models.llama import llama_decode_step
    from tpu_lutvq_torch.runtime.generate import bucket_window

    window = bucket_window(int(pos.max()) + 1, cfg.max_seq)

    def step(plain):
        copy = tuple(type(c)(*(t.clone() for t in c)) for c in caches)
        return llama_decode_step(cfg, weights, tok, copy, pos, window=window, attn="flash",
                                 plain=plain)[0]

    want, got = step(True), step(False)
    errs = {"kernel": rel_err(got, want)}
    for name, variant in REFERENCE_RUNS.items():
        with plain_versions(**variant):
            errs[name] = rel_err(step(True), want)
    for c in ATTN_CONTROLS:
        with attention_control(c):
            errs[f"attn_{c}"] = rel_err(step(True), want)
    return errs, bool(torch.isfinite(got).all())


def counters():
    lg, dq = kernel_modules()
    fd, fp = attention_modules()
    return {"lut_gemv": (lg, "LUT_GEMV_LAUNCHES"), "lut_gemv_bpair": (lg, "LUT_GEMV_BPAIR_LAUNCHES"),
            "dequant_mm": (dq, "DEQUANT_MM_LAUNCHES"), "fold_i8": (dq, "FOLD_I8_LAUNCHES"),
            "flash_decode": (fd, "FLASH_DECODE_LAUNCHES"),
            "flash_decode_paged": (fd, "FLASH_DECODE_PAGED_LAUNCHES"),
            "flash_prefill": (fp, "FLASH_PREFILL_LAUNCHES"),
            "lut_gemv_f32": (lg, "LUT_GEMV_F32_LAUNCHES"),
            "lut_gemv_i8": (lg, "LUT_GEMV_I8_LAUNCHES"),
            "lut_gemv_i16": (lg, "LUT_GEMV_I16_LAUNCHES"),
            "dequant_mm_i8": (dq, "DEQUANT_MM_I8_LAUNCHES"),
            "dequant_mm_f32": (dq, "DEQUANT_MM_F32_LAUNCHES"),
            "lut_gemv_pairf": (lg, "LUT_GEMV_PAIRF_LAUNCHES"),
            "lut_gemv_nibbles": (lg, "LUT_GEMV_NIBBLES_LAUNCHES"),
            "lut_gemv_nibbles_bpair": (lg, "LUT_GEMV_NIBBLES_BPAIR_LAUNCHES")}


def projections(cfg):
    """(d_in, d_out) of each of a decoder layer's seven projections."""
    return {"wq": (cfg.hidden, cfg.q_dim), "wk": (cfg.hidden, cfg.kv_dim),
            "wv": (cfg.hidden, cfg.kv_dim), "wo": (cfg.q_dim, cfg.hidden),
            "w_gate": (cfg.hidden, cfg.ffn), "w_up": (cfg.hidden, cfg.ffn),
            "w_down": (cfg.ffn, cfg.hidden)}


def routed_launches(cfg, rows, quality="exact", strategy="auto"):
    """The launches one forward of ``rows`` rows makes through ``cfg``'s
    projections, by counter, as ``strategy`` routes them ("auto": as
    ``dataflow.traffic.pick_strategy`` does): the lookups one launch per 8
    tokens (A at one, B at 2-8), the dequant-matmul one a call (at
    ``quality="fast"`` the W8A8 kernel and its fold)."""
    from tpu_lutvq_torch.dataflow.traffic import pick_strategy

    out = {}
    for d_in, d_out in projections(cfg).values():
        route = strategy if strategy != "auto" else pick_strategy(cfg.vq_cfg(d_in), d_out, rows)
        if route == "lut_gemv":
            names = ["lut_gemv" if min(8, rows - b0) == 1 else "lut_gemv_bpair"
                     for b0 in range(0, rows, 8)]
        else:
            names = ["dequant_mm"] if quality == "exact" else ["dequant_mm_i8", "fold_i8"]
        for k in names:
            out[k] = out.get(k, 0) + cfg.n_layers
    return out


def check_routes(label, launches, expected, names=None):
    """Among ``names`` (default: the projection kernels), the kernels that
    launched are those the routes of ``expected`` (a list of
    ``routed_launches``) take."""
    names = names or ("lut_gemv", "lut_gemv_bpair", "dequant_mm", "dequant_mm_i8", "fold_i8")
    want = {k for e in expected for k in e}
    got = {k for k in names if launches.get(k, 0) > 0}
    check(got == want & set(names), f"{label}: launched {sorted(got)}, the routes take "
                                    f"{sorted(want & set(names))}")


def serve(cfg, weights, prompts, run_kw=None, watch=None, temperature=0.0, **kw):
    """One batcher run from zeroed launch counters: (outputs by id, seconds,
    launches by kernel, the batcher).  ``watch(batcher)`` runs before it."""
    from tpu_lutvq_torch.runtime import ContinuousBatcher, Request

    b = ContinuousBatcher(cfg, weights, n_slots=N_SLOTS, **kw)
    if watch is not None:
        watch(b)
    for i, p in enumerate(prompts):
        b.submit(Request(req_id=i, prompt=p, max_new_tokens=NEW_TOKENS, temperature=temperature))
    for mod, name in counters().values():
        setattr(mod, name, 0)
    done, secs = timed(lambda: b.run(**(run_kw or {})))
    launches = {k: getattr(mod, name) for k, (mod, name) in counters().items()}
    return {r.req_id: r.output for r in done}, secs, launches, b


def batcher_prompts(cfg):
    """Phase 4's prompts, and those of run (iii), from a seeded generator
    (returned too: the B=8 step draws its tokens from it)."""
    ids = torch.Generator().manual_seed(2)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=ids).tolist()

    prompts = [prompt(n) for n in PROMPT_LENS]
    long_prompts = [prompt(LONG_PROMPTS[i]) if i in LONG_PROMPTS else p
                    for i, p in enumerate(prompts)]
    return prompts, long_prompts, ids


def phase_batcher(device, cfg, weights):
    """Phase 4: the continuous batcher over slab and paged caches."""
    prompts, long_prompts, ids = batcher_prompts(cfg)
    serve(cfg, weights, prompts[:N_SLOTS])  # warm-up: lazy inits, allocator pools
    runs = {
        "i slab auto": (prompts, {}, {}),
        "ii paged auto": (prompts, {}, PAGED),
        "iii slab flash chunked": (long_prompts, dict(horizon=4, pipeline=True),
                                   dict(attn="flash", prefill_chunk=PREFILL_CHUNK)),
    }
    # every decode tick runs all N_SLOTS rows: the projections' routes at
    # that many rows, and attention as resolve_attn picks it at the longest
    # request's window
    from tpu_lutvq_torch.models.attn_policy import resolve_attn
    from tpu_lutvq_torch.runtime.generate import bucket_window

    decode = set(routed_launches(cfg, N_SLOTS))
    window = bucket_window(max(PROMPT_LENS) + NEW_TOKENS, cfg.max_seq)

    def flash(kernel, paged):
        auto = resolve_attn("auto", batch=N_SLOTS, window=window, heads=cfg.n_heads, paged=paged)
        return {kernel} if auto == "flash" else set()

    must_launch = {"i slab auto": decode | flash("flash_decode", False),
                   "ii paged auto": decode | flash("flash_decode_paged", True),
                   "iii slab flash chunked": decode | {"flash_decode", "flash_prefill"}}
    results = {}
    for name, (ps, run_kw, kw) in runs.items():
        outs, secs, launches, b = serve(cfg, weights, ps, run_kw, **kw)
        results[name] = dict(outs=outs, secs=secs, launches=launches, batcher=b)
        n_tok = sum(len(o) for o in outs.values())
        print(f"[batcher] {name}: {len(outs)} requests, {n_tok} tokens in {secs:.2f} s, "
              f"{n_tok / secs:.1f} tok/s delivered (host clock); waves admitted "
              f"{b.wave_admits}; launches " + " ".join(f"{k} {v}" for k, v in launches.items()))
        check(sorted(outs) == list(range(len(ps))), f"{name}: requests missing")
        for i, o in outs.items():
            check(len(o) == NEW_TOKENS, f"{name}: request {i} has {len(o)} tokens")
            check(all(0 <= t < cfg.vocab_size for t in o), f"{name}: request {i} token ids")
        for k in must_launch[name]:
            check(launches[k] > 0, f"{name}: {k} did not launch")
    same = results["ii paged auto"]["outs"] == results["i slab auto"]["outs"]
    print(f"[batcher] paged run gives the slab run's tokens: {same}")
    check(same, "the paged run's tokens differ from the slab run's")

    b = results["i slab auto"]["batcher"]
    # each slot's next step, as the batcher would feed it
    pos = torch.tensor(b.slot_pos - 1, dtype=torch.int32, device=device)
    tok = torch.randint(0, cfg.vocab_size, (N_SLOTS,), generator=ids).to(device, torch.int32)
    errs, finite = step_errors(cfg, weights, b.caches, tok, pos)
    print(f"[batcher] B={N_SLOTS} flash decode step from run (i)'s caches, positions "
          f"{pos.tolist()}: logits rel err vs plain: "
          + ", ".join(f"{run} {e:.3e}" for run, e in errs.items()))
    floor = max(e for run, e in errs.items() if run.startswith("floor"))
    check(finite, "non-finite logits in the B=8 step")
    check(errs["kernel"] <= LOGITS_TOL, f"B=8 step logits disagree: {errs}")
    check(floor <= LOGITS_TOL, "B=8 step: plain-vs-plain noise over the tolerance")
    check(errs["control"] > LOGITS_TOL, "B=8 step: tolerance passes the control")
    # An attention fault must fail the step too.  The q_scale control (a
    # 2^-9 relative change of q) reads at the plain-vs-plain noise here
    # (1.678e-2 on the H100): only phase 2's per-kernel gates see it.
    check(errs["attn_p_f32"] > LOGITS_TOL, "B=8 step: tolerance passes the p_f32 control")
    # each run's outputs, seconds and launches (the batchers and their caches go)
    return {name: {k: v for k, v in r.items() if k != "batcher"} for name, r in results.items()}


def eager_roll(b):
    """Serve ``b``'s decode rolls with the eager roll called directly (the
    method its graphs capture), as on the CPU."""
    b._graphs = None


# what a graph's memset and copy nodes are called in the profiler → what the
# same work is called when launched eagerly
GRAPH_NODE_NAMES = {"Memset (Unknown)": "Memset (Device)",
                    "memcpy32_post": "Memcpy DtoD (Device -> Device)"}
# CUDAGraph.replay's own launches ahead of the graph: the seed and offset
# fills of each registered generator's Philox state
RNG_PROLOGUE = "FillFunctor<long>"


def kernels_per_call(fn, calls=4):
    """({name: launches a call}, {name: device µs a call}) of the CUDA work
    one warm ``fn()`` does, a graph's memset and copy nodes under their eager
    names.  Launches: the largest over three profiler sessions of ceil(count
    / calls), since the profiler drops a few events of a session (seen: one
    at a session's start, tens in 47,000) and never adds one.  µs: the mean
    over the sessions."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts, us = {}, {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and not (GUARDING and "FillFunctor" in e.key):  # the guard bands' own fills
                k = GRAPH_NODE_NAMES.get(e.key, e.key)
                counts[k] = max(counts.get(k, 0), -(-e.count // calls))
                t = getattr(e, "device_time_total", None)
                us[k] = us.get(k, 0.0) + (e.cuda_time_total if t is None else t) / (3 * calls)
    return counts, us


def replay_against_roll(graphs, eager, key):
    """One replay of ``graphs``' graph for ``key`` = (window, horizon) held
    against the eager roll of ``eager`` (a batcher whose roll runs eager) at
    the same static inputs: (kernels a replay launches, its RNG prologue's
    fills, kernels the roll launches, launch counts the roll's host code
    adds, the counts the capture recorded, µs a call of each kernel
    replayed, the same eager)."""
    window, horizon = key
    replay, _, deltas = graphs.graphs[key]

    def roll():
        return eager._roll(*graphs.static, horizon, window)

    (ks_g, us_g), (ks_e, us_e) = kernels_per_call(replay), kernels_per_call(roll)
    fills = {k: ks_g.pop(k) for k in list(ks_g) if RNG_PROLOGUE in k}
    before = {k: getattr(mod, name) for k, (mod, name) in counters().items()}
    roll()
    torch.cuda.synchronize()
    counted = {k: getattr(mod, name) - before[k] for k, (mod, name) in counters().items()}
    names = {name: k for k, (_, name) in counters().items()}
    captured = {names[name]: d for (_, name), d in deltas}
    return ks_g, fills, ks_e, {k: n for k, n in counted.items() if n}, captured, us_g, us_e


def phase_graphs(device, cfg, weights):
    """The decode roll as CUDA graphs: batcher runs (i)-(iv), the stacked
    run and a sampled run, each against the same run with the eager roll
    (``eager_roll``): the same tokens, cache bytes and launch counts, and
    replays serving every tick after each (window, horizon)'s first.  Then
    each key's graph, replayed once, against the eager roll at the same
    inputs: the kernels the profiler sees it launch are the roll's, name for
    name and count for count (besides at most two RNG prologue fills that
    ``CUDAGraph.replay`` launches itself), and the launch counts a replay
    adds are those the roll's own host code counts; with each kernel's
    device time in both."""
    from tpu_lutvq_torch.tracing import TICKS

    prompts, long_prompts, _ = batcher_prompts(cfg)
    runs = {
        "i slab auto": (prompts, {}, {}),
        "ii paged auto": (prompts, {}, PAGED),
        "iii slab flash chunked": (long_prompts, dict(horizon=4, pipeline=True),
                                   dict(attn="flash", prefill_chunk=PREFILL_CHUNK)),
        "iv slab auto fast": (prompts, {}, dict(quality="fast")),
        "stacked": (prompts, {}, dict(stacked_kv=True)),
        "sampled h4 pipelined": (prompts, dict(horizon=4, pipeline=True),
                                 dict(temperature=GRAPH_TEMPERATURE)),
    }
    for name, (ps, run_kw, kw) in runs.items():
        want, secs_e, launches_e, eager = serve(cfg, weights, ps, run_kw, eager_roll, **kw)
        got, secs_g, launches_g, graphed = serve(cfg, weights, ps, run_kw, **kw)
        same_caches = same_cache_bytes(graphed.caches, eager.caches)
        recs = [r for r in TICKS if r.batcher == graphed.batcher_id and r.steps]
        steps, replayed = sum(r.steps for r in recs), sum(r.replayed for r in recs)
        first = sum(not r.replayed for r in recs)
        print(f"[graphs] {name}: tokens equal {got == want}, caches bit-equal {same_caches}, "
              f"launches equal {launches_g == launches_e}; {replayed} of {steps} decode steps "
              f"replayed, {len(graphed._graphs.graphs)} graphs, {first} eager ticks for "
              f"{len(graphed._graphs.seen)} keys; {secs_e:.2f} s eager, {secs_g:.2f} s graphed "
              f"(host clock, captures included)")
        check(got == want, f"graphs {name}: tokens differ from the eager roll's")
        check(same_caches, f"graphs {name}: cache bytes differ from the eager roll's")
        check(launches_g == launches_e, f"graphs {name}: launch counts differ from the eager "
                                        f"roll's: {launches_g} against {launches_e}")
        check(replayed > 0 and first == len(graphed._graphs.seen),
              f"graphs {name}: replays did not serve every tick after a key's first")
        for key in sorted(graphed._graphs.graphs):
            ks_g, fills, ks_e, counted, captured, us_g, us_e = replay_against_roll(
                graphed._graphs, eager, key)
            top = sorted(us_e, key=lambda k: -us_e[k])[:4]
            differ = {k: (ks_g.get(k, 0), ks_e.get(k, 0)) for k in set(ks_g) | set(ks_e)
                      if ks_g.get(k, 0) != ks_e.get(k, 0)}
            print(f"[graphs] {name} {key}: one replay launches {sum(ks_g.values())} kernels and "
                  f"{sum(fills.values())} RNG prologue fills, the eager roll "
                  f"{sum(ks_e.values())} kernels, equal by name {not differ}; launch counts a "
                  f"replay adds {captured}, the roll counts {counted}; device ms "
                  f"{sum(us_g.values()) / 1e3:.3f} replayed, {sum(us_e.values()) / 1e3:.3f} "
                  f"eager; µs a call, replayed / eager: "
                  + ", ".join(f"{k[:40]} {us_g.get(k, 0.0):.0f} / {us_e[k]:.0f}" for k in top))
            check(not differ, f"graphs {name} {key}: a replay's kernels differ from the eager "
                              f"roll's (replayed, eager): {differ}")
            check(sum(fills.values()) <= 2, f"graphs {name} {key}: {fills} ahead of a replay")
            check(captured == counted, f"graphs {name} {key}: a replay adds {captured} launches, "
                                       f"the eager roll counts {counted}")
        del eager, graphed
    torch.cuda.empty_cache()


def first_logits(cfg, weights, prompts, stacked, **kw):
    """Prefill then one flash decode step, as ``generate()`` lays a ragged
    batch out, into tuple or stacked caches: (prefill logits, step logits)."""
    from tpu_lutvq_torch.models.llama import (
        init_caches, init_stacked_caches, llama_decode_step, llama_forward)
    from tpu_lutvq_torch.runtime.generate import bucket_window, pad_prompts

    toks, lens = pad_prompts(prompts, cfg.max_seq, weights.embed.device)
    init = init_stacked_caches if stacked else init_caches
    caches = init(cfg, len(prompts), device=weights.embed.device)
    pre, caches = llama_forward(cfg, weights, toks, caches, 0,
                                window=bucket_window(toks.shape[1], cfg.max_seq),
                                logits_mode="index", logits_idx=lens - 1, **kw)
    tok = pre[:, 0].argmax(-1).to(torch.int32)
    step, _ = llama_decode_step(cfg, weights, tok, caches, lens, attn="flash",
                                window=bucket_window(int(lens.max()) + 1, cfg.max_seq), **kw)
    return pre[:, 0], step


def phase_stacked(device, cfg, weights, batcher):
    """The stacked container at the 7B geometry: (a) and (b) through
    ``generate(stacked_kv=True)`` give the tuple runs' tokens, and their
    prefill and flash decode logits bit for bit; (b) in scan mode
    (``stack_llama_weights``) gives the hybrid's bit for bit; the fused
    chunked prefill within the logits gate of the chunked one; batcher run
    (i) with ``stacked_kv`` gives run (i)'s tokens; B=1 decode over a
    1,900-token context, stacked against tuple: D launched in ``layer=``
    mode, the same kernels a step as the tuple caches' and no layer-sized
    allocation (no copy of the cache), and decode tok/s of each."""
    import tpu_lutvq_torch.models.llama as tl
    from tpu_lutvq_torch.runtime import generate
    from tpu_lutvq_torch.runtime.generate import (
        bucket_window, make_chunked_prefill, make_fused_chunked_prefill)

    layer_calls = []
    decode = tl.flash_decode_attention

    def counted_decode(*a, layer=None, **k):
        layer_calls.append(layer)
        return decode(*a, layer=layer, **k)

    tl.flash_decode_attention = counted_decode
    for mod, name in counters().values():
        setattr(mod, name, 0)
    try:
        requests = slice_requests(cfg)
        for name in ("a", "b"):
            r = requests[name]
            kw = dict(strategy=r["strategy"])
            tup = generate(cfg, weights, r["prompts"], r["new"], **kw)
            hyb = generate(cfg, weights, r["prompts"], r["new"], stacked_kv=True, **kw)
            same = torch.equal(tup.tokens, hyb.tokens) and torch.equal(tup.lengths, hyb.lengths)
            want = first_logits(cfg, weights, r["prompts"], False, **kw)
            got = first_logits(cfg, weights, r["prompts"], True, **kw)
            bits = all(torch.equal(g, w) for g, w in zip(got, want))
            print(f"[stacked] request {name}: B={len(r['prompts'])} tokens equal to the tuple "
                  f"run's {same}; prefill and flash-step logits bit-equal {bits} "
                  f"(stacked cache {nbytes(*tl.init_stacked_caches(cfg, len(r['prompts']), device='meta')) / 2**30:.2f} GiB)")
            check(same, f"stacked request {name}: tokens differ from the tuple run's")
            check(bits, f"stacked request {name}: logits differ from the tuple run's")
        r = requests["b"]
        sw = tl.stack_llama_weights(weights)
        scan = generate(cfg, sw, r["prompts"], r["new"], stacked_kv=True, strategy=r["strategy"])
        hyb = generate(cfg, weights, r["prompts"], r["new"], stacked_kv=True,
                       strategy=r["strategy"])
        bits = all(torch.equal(g, w) for g, w in zip(
            first_logits(cfg, sw, r["prompts"], True, strategy=r["strategy"]),
            first_logits(cfg, weights, r["prompts"], True, strategy=r["strategy"])))
        same = torch.equal(scan.tokens, hyb.tokens)
        print(f"[stacked] request b in scan mode: tokens equal to hybrid {same}; logits "
              f"bit-equal {bits}")
        check(same and bits, "scan mode differs from hybrid")
        del sw, scan
        torch.cuda.empty_cache()

        ids = torch.Generator().manual_seed(3)
        toks = torch.randint(0, cfg.vocab_size, (2, FUSED_T), generator=ids).to(device)
        fused, fused_c = make_fused_chunked_prefill(cfg, chunk=PREFILL_CHUNK)(weights, toks)
        chunked, _ = make_chunked_prefill(cfg, chunk=PREFILL_CHUNK)(
            weights, toks, tl.init_caches(cfg, 2, device=device))
        err = rel_err(fused, chunked)
        print(f"[stacked] fused chunked prefill, B=2 T={FUSED_T} chunk {PREFILL_CHUNK}: logits "
              f"rel err vs make_chunked_prefill {err:.3e} (gate {LOGITS_TOL})")
        check(bool(torch.isfinite(fused).all()) and fused_c.k_q.shape[0] == cfg.n_layers,
              "fused prefill: bad output")
        check(err <= LOGITS_TOL, f"fused prefill disagrees with the chunked one: {err}")
        del fused_c

        prompts = batcher_prompts(cfg)[0]
        before = {k: getattr(mod, name) for k, (mod, name) in counters().items()}
        outs, secs, _, _ = serve(cfg, weights, prompts, stacked_kv=True)  # zeroes the counts
        same = outs == batcher["i slab auto"]["outs"]
        n_tok = sum(len(o) for o in outs.values())
        print(f"[stacked] batcher run (i) with stacked_kv: {n_tok} tokens in {secs:.2f} s, "
              f"{n_tok / secs:.1f} tok/s delivered (host clock); run (i)'s tokens {same}")
        check(same, "the stacked batcher's tokens differ from run (i)'s")
        launches = {k: before[k] + getattr(mod, name) for k, (mod, name) in counters().items()}
        tps = stacked_decode_rate(cfg, weights, device)
    finally:
        tl.flash_decode_attention = decode
    n_layer = sum(c is not None for c in layer_calls)
    print(f"[stacked] flash decode calls with layer=: {n_layer} of {len(layer_calls)}; launches "
          + " ".join(f"{k} {v}" for k, v in launches.items() if v))
    check(n_layer > 0, "no flash decode call read a stacked cache (layer=)")
    for k in ("dequant_mm", "flash_decode", "flash_prefill"):
        check(launches[k] > 0, f"stacked phase: {k} did not launch")
    return launches, tps


def stacked_decode_rate(cfg, weights, device):
    """B=1 decode over a STACKED_CONTEXT-token context, flash attention:
    the kernels one step launches (tuple and stacked must match), the
    memory a stacked step allocates (below one layer's plane: nothing
    copies the cache), and decode tok/s of each container in turns."""
    import tpu_lutvq_torch.models.llama as tl
    from tpu_lutvq_torch.runtime.generate import bucket_window, make_chunked_prefill

    ids = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (1, STACKED_CONTEXT), generator=ids).to(device)
    logits, tup = make_chunked_prefill(cfg, chunk=PREFILL_CHUNK)(
        weights, prompt, tl.init_caches(cfg, 1, device=device))
    stacked = tl.KVCache(*(torch.stack(planes) for planes in zip(*tup)))
    tok = logits.argmax(-1).to(torch.int32)
    window = bucket_window(STACKED_CONTEXT + STACKED_STEPS, cfg.max_seq)

    def step(caches, pos):
        return tl.llama_decode_step(cfg, weights, tok, caches, pos, attn="flash", window=window)

    ks_tup = launched_kernels(lambda: step(tup, STACKED_CONTEXT), calls=2)
    ks_stk = launched_kernels(lambda: step(stacked, STACKED_CONTEXT), calls=2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(stacked, STACKED_CONTEXT)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - base
    plane = nbytes(stacked.k_q[0])
    print(f"[stacked] B=1 decode step at {STACKED_CONTEXT} tokens: {sum(ks_stk.values())} "
          f"kernels stacked, {sum(ks_tup.values())} tuple, same kernels "
          f"{ks_stk == ks_tup}; a stacked step allocates {grew / 2**20:.2f} MiB (one layer's "
          f"K plane {plane / 2**20:.0f} MiB)")
    check(ks_stk == ks_tup, f"a stacked step launches other kernels: {ks_stk} vs {ks_tup}")
    check(grew < plane, "a stacked decode step allocates a layer's plane: the cache is copied")

    def rate(caches):
        def run():
            for i in range(STACKED_STEPS):
                step(caches, STACKED_CONTEXT + i)
        _, secs = timed(run)
        return STACKED_STEPS / secs

    tps = {"tuple": [], "stacked": []}
    for name in ("tuple", "stacked", "stacked", "tuple"):
        tps[name].append(rate(tup if name == "tuple" else stacked))
    print(f"[stacked] decode tok/s B=1 context {STACKED_CONTEXT}, {STACKED_STEPS} steps, "
          f"flash: tuple {tps['tuple'][0]:.1f}/{tps['tuple'][1]:.1f}, stacked "
          f"{tps['stacked'][0]:.1f}/{tps['stacked'][1]:.1f} (host clock, turns tuple, stacked, "
          "stacked, tuple)")
    return tps


def fast_step_errors(cfg, weights, caches, tok, pos):
    """A B=8 flash decode step from ``caches`` at ``quality="fast"`` through
    the kernels, against the plain versions' fast step, and the controls
    against it: a truncating activation fold, the attention controls."""
    from tpu_lutvq_torch.models.llama import llama_decode_step
    from tpu_lutvq_torch.runtime.generate import bucket_window

    window = bucket_window(int(pos.max()) + 1, cfg.max_seq)

    def step(plain):
        copy = tuple(type(c)(*(t.clone() for t in c)) for c in caches)
        return llama_decode_step(cfg, weights, tok, copy, pos, window=window, attn="flash",
                                 quality="fast", plain=plain)[0]

    want, got = step(True), step(False)
    errs = {"kernel": rel_err(got, want)}
    with truncating_folds():
        errs["i8_trunc"] = rel_err(step(True), want)
    for c in ATTN_CONTROLS:
        with attention_control(c):
            errs[f"attn_{c}"] = rel_err(step(True), want)
    return errs, bool(torch.isfinite(got).all())


def phase_tier_runs(device, cfg, weights, batcher_results):
    """Phase 6: the precision tiers at 7B geometry on phase 3's model.
    Returns each new kernel's launches on its main path."""
    from tpu_lutvq_torch.models.llama import init_caches, llama_decode_step, llama_forward
    from tpu_lutvq_torch.runtime import sequence_logprobs
    from tpu_lutvq_torch.runtime.generate import bucket_window

    lg, dq = kernel_modules()
    per_step = 7 * cfg.n_layers  # projections in one forward
    prompts, _, ids = batcher_prompts(cfg)

    # (a) batcher run (iv): run (i)'s requests at quality="fast"
    ticks = []

    def watch(b):
        decode = b._decode

        def counted(*a, **kw):
            before = dq.DEQUANT_MM_I8_LAUNCHES, dq.DEQUANT_MM_LAUNCHES, dq.FOLD_I8_LAUNCHES
            out = decode(*a, **kw)
            ticks.append((out.shape[0], dq.DEQUANT_MM_I8_LAUNCHES - before[0],
                          dq.DEQUANT_MM_LAUNCHES - before[1], dq.FOLD_I8_LAUNCHES - before[2]))
            return out
        b._decode = counted

    serve(cfg, weights, prompts[:N_SLOTS], quality="fast")  # warm-up, as run (i)'s
    outs, secs, launches, b = serve(cfg, weights, prompts, watch=watch, quality="fast")
    n_tok = sum(len(o) for o in outs.values())
    base = batcher_results["i slab auto"]
    agree = sum(sum(int(t == u) for t, u in zip(o, base["outs"][i]))
                for i, o in outs.items()) / n_tok
    print(f"[tiers] (a) batcher run iv slab auto quality=fast: {len(outs)} requests, {n_tok} "
          f"tokens in {secs:.2f} s, {n_tok / secs:.1f} tok/s delivered (host clock; run i "
          f"{sum(len(o) for o in base['outs'].values()) / base['secs']:.1f}); {len(ticks)} "
          f"decode ticks, W8A8 launches per tick {sorted({g for _, g, _, _ in ticks})}; tokens "
          f"equal to run i's {agree:.3f}; launches "
          + " ".join(f"{k} {v}" for k, v in launches.items()))
    check(sorted(outs) == list(range(len(prompts))), "run iv: requests missing")
    for i, o in outs.items():
        check(len(o) == NEW_TOKENS and all(0 <= t < cfg.vocab_size for t in o),
              f"run iv: request {i} malformed")
    # a step's W8A8 launches: the projections auto routes to dequant_mm at N_SLOTS rows
    w8a8 = routed_launches(cfg, N_SLOTS, quality="fast").get("dequant_mm_i8", 0)
    check(len(ticks) > 0 and all(g == w8a8 * h == f and c == 0 for h, g, c, f in ticks),
          f"run iv: a decode tick's W8A8 kernels or folds are not its routes' "
          f"({w8a8} a step), or it took bf16x2: {ticks[:4]}")
    check(launches["dequant_mm"] == 0 and launches["dequant_mm_i8"] > 0,
          "run iv: the bf16x2 kernel launched, or the W8A8 one did not")
    check(launches["fold_i8"] == launches["dequant_mm_i8"],
          f"run iv: {launches['fold_i8']} folds for {launches['dequant_mm_i8']} W8A8 launches")
    pos = torch.tensor(b.slot_pos - 1, dtype=torch.int32, device=device)
    tok = torch.randint(0, cfg.vocab_size, (N_SLOTS,), generator=ids).to(device, torch.int32)
    errs, finite = fast_step_errors(cfg, weights, b.caches, tok, pos)
    print(f"[tiers] (a) B={N_SLOTS} flash decode step at quality=fast from run iv's caches, "
          f"positions {pos.tolist()}: logits rel err vs plain: "
          + ", ".join(f"{run} {e:.3e}" for run, e in errs.items()))
    check(finite, "non-finite logits in the fast B=8 step")
    check(errs["kernel"] <= LOGITS_TOL, f"fast B=8 step logits disagree: {errs}")
    check(errs["attn_p_f32"] > LOGITS_TOL, "fast B=8 step: tolerance passes the p_f32 control")
    check(errs["i8_trunc"] > LOGITS_TOL, "fast B=8 step: tolerance passes the truncating fold")
    result = {"dequant_mm_i8": launches["dequant_mm_i8"], "fold_i8": launches["fold_i8"]}
    del b

    # (b) one B=1 decode step through the pairf kernel, against the pair step
    prompt = torch.randint(0, cfg.vocab_size, (1, 16), generator=ids).to(device)
    caches = init_caches(cfg, 1, device=device)
    logits, caches = llama_forward(cfg, weights, prompt, caches, 0,
                                   window=bucket_window(16, cfg.max_seq))
    tok = logits[:, -1].argmax(-1).to(torch.int32)

    def step(variant):  # pairf is a variant of the lookups: every projection on them
        copy = tuple(type(c)(*(t.clone() for t in c)) for c in caches)
        return llama_decode_step(cfg, weights, tok, copy, 16, variant=variant,
                                 strategy="lut_gemv", window=bucket_window(17, cfg.max_seq))[0]

    lg.LUT_GEMV_PAIRF_LAUNCHES = 0
    y_pairf = step("pairf")
    result["lut_gemv_pairf"] = lg.LUT_GEMV_PAIRF_LAUNCHES
    y_pair = step("pair")
    same = bool(torch.equal(y_pairf, y_pair))
    print(f"[tiers] (b) B=1 decode step, variant=pairf: {result['lut_gemv_pairf']} pairf "
          f"launches; logits equal to the pair step's: {same}")
    check(result["lut_gemv_pairf"] == per_step, "pairf did not serve every projection")
    check(same and bool(torch.isfinite(y_pairf).all()), "pairf step differs from the pair step")

    # (c) the tiers' cost in model quality, against the f32 oracle
    tokens = torch.randint(0, cfg.vocab_size, (EVAL_B, EVAL_T), generator=ids).to(device)
    settings = {"exact": (dict(strategy="auto"), "dequant_mm"),
                "i8": (dict(strategy="dequant_mm", variant="i8"), "dequant_mm_i8"),
                "f32": (dict(strategy="dequant_mm", variant="f32"), "dequant_mm_f32")}
    logp, ppl = {}, {}
    for name, (kw, kernel) in settings.items():
        mod, attr = counters()[kernel]
        setattr(mod, attr, 0)
        lp, s_lp = timed(lambda: sequence_logprobs(cfg, weights, tokens, **kw))
        n_launch = getattr(mod, attr)
        logits, _ = llama_forward(cfg, weights, tokens, init_caches(cfg, EVAL_B, device=device),
                                  0, **kw)
        logp[name] = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        ppl[name] = math.exp(-float(lp.mean()))
        own = logp[name].gather(-1, tokens[:, 1:, None].long())[..., 0]
        print(f"[tiers] (c) sequence_logprobs B={EVAL_B} T={EVAL_T} {name}: perplexity "
              f"{ppl[name]:.4f}, {s_lp:.2f} s (host clock), {kernel} launches {n_launch}; "
              f"max |logprob - the logits' re-run| {float((own - lp).abs().max()):.3e}")
        check(bool(torch.isfinite(lp).all()) and bool((lp <= 0).all()), f"(c) {name}: logprobs")
        check(n_launch == per_step, f"(c) {name}: {kernel} did not serve every projection")
        if name == "f32":
            result["dequant_mm_f32"] = n_launch
        del logits
    p_oracle = logp["f32"].exp()
    for name in ("exact", "i8"):
        kl = (p_oracle * (logp["f32"] - logp[name])).sum(-1).flatten()
        print(f"[tiers] (c) {name} vs the f32 oracle: KL mean {float(kl.mean()):.4e} p95 "
              f"{float(kl.quantile(0.95)):.4e} nats; perplexity ratio "
              f"{ppl[name] / ppl['f32']:.6f}")
    return result


def phase_profile(device, cfg, weights):
    """``--profile``: where the time of batcher runs (iv) (phase 6,
    ``quality="fast"``), (iii) (flash, chunked admission), (i) and (ii)
    (paged) goes.  Each run once unprofiled and once under torch.profiler
    (device busy share, kernel launches, device time by kernel, flash
    decode's share of it, in run (iii) flash prefill's (E) and in run (iv)
    the W8A8 kernel's and its fold's), then a B=8 decode step from run
    (i)'s caches under each attention path (host clock, 5 steps each, flash
    and einsum alternated), then phase 3 (a)'s decode tok/s (three runs).
    It runs on an earlier tree too (copied into its checkout), whose kernels
    and counters it does not require."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_lutvq_torch.models.llama import llama_decode_step
    from tpu_lutvq_torch.runtime import generate
    from tpu_lutvq_torch.runtime.generate import bucket_window

    prompts, long_prompts, ids = batcher_prompts(cfg)
    for run, ps, run_kw, kw in (
            ("iv", prompts, None, dict(quality="fast")),
            ("iii", long_prompts, dict(horizon=4, pipeline=True),
             dict(attn="flash", prefill_chunk=PREFILL_CHUNK)),
            ("ii", prompts, None, PAGED), ("i", prompts, None, {})):
        serve(cfg, weights, prompts[:N_SLOTS], **kw)  # warm-up: lazy inits, allocator pools
        secs = serve(cfg, weights, ps, run_kw, **kw)[1]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, prof_secs, launches, b = serve(cfg, weights, ps, run_kw, **kw)
        on_device = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in on_device) / 1e6
        print(f"[profile] run ({run}): {secs:.3f} s unprofiled, {prof_secs:.3f} s profiled; "
              f"device busy {100 * busy / prof_secs:.1f} % of the profiled wall time "
              f"({busy:.3f} s), {sum(e.count for e in on_device)} device launches; counters "
              + " ".join(f"{k} {v}" for k, v in launches.items() if v))
        on_device.sort(key=lambda e: -e.self_device_time_total)
        for e in on_device[:10]:
            ms = e.self_device_time_total / 1e3
            print(f"[profile]   {ms:10.1f} ms {100 * ms / 1e3 / busy:5.1f} % {e.count:7d} "
                  f"calls  {e.key[:100]}")
        decode = [e for e in on_device if DECODE_KERNELS.search(e.key)]
        ms = sum(e.self_device_time_total for e in decode) / 1e3
        print(f"[profile] run ({run}): flash decode {ms:.1f} ms, {100 * ms / 1e3 / busy:.1f} % of "
              f"device time, {sum(e.count for e in decode)} kernel launches over "
              f"{len(decode)} kernels")
        if run == "iii":
            found = [e for e in on_device if PREFILL_KERNELS.search(e.key)]
            ms = sum(e.self_device_time_total for e in found) / 1e3
            print(f"[profile] run (iii): flash prefill (E) {ms:.1f} ms, "
                  f"{100 * ms / 1e3 / busy:.1f} % of device time, "
                  f"{sum(e.count for e in found)} launches over {len(found)} kernels")
        if run == "iv":
            for label, pattern in (("G", "dequant_mm_i8"), ("the fold kernel", "fold_i8")):
                found = [e for e in on_device if pattern in e.key]
                ms = sum(e.self_device_time_total for e in found) / 1e3
                print(f"[profile] run (iv): {label} ({pattern}*) {ms:.1f} ms, "
                      f"{100 * ms / 1e3 / busy:.1f} % of device time, "
                      f"{sum(e.count for e in found)} launches over {len(found)} kernels")

    pos = torch.tensor(b.slot_pos - 1, dtype=torch.int32, device=device)
    tok = torch.randint(0, cfg.vocab_size, (N_SLOTS,), generator=ids).to(device, torch.int32)
    window = bucket_window(int(pos.max()) + 1, cfg.max_seq)
    step_ms = {"flash": [], "xla": []}
    for attn in ("flash", "xla", "xla", "flash"):
        step_ms[attn].append(1e3 / 5 * timed(lambda: [llama_decode_step(
            cfg, weights, tok, b.caches, pos, window=window, attn=attn) for _ in range(5)])[1])
    print(f"[profile] B={N_SLOTS} decode step at window {window}, ms per step: "
          + ", ".join(f"{a} " + " / ".join(f"{t:.1f}" for t in ts) for a, ts in step_ms.items()))
    del b
    decode_step_launches(cfg, weights)
    req = slice_requests(cfg)["a"]
    generate(cfg, weights, req["prompts"], 2)  # warm-up
    rates = []
    for _ in range(3):
        prefill_s = timed(lambda: generate(cfg, weights, req["prompts"], 1))[1]
        total_s = timed(lambda: generate(cfg, weights, req["prompts"], req["new"]))[1]
        rates.append(len(req["prompts"]) * (req["new"] - 1) / (total_s - prefill_s))
    print(f"[profile] phase 3 (a) B={len(req['prompts'])} decode: "
          + " / ".join(f"{r:.1f}" for r in rates) + " tok/s (host clock)")


def decode_step_launches(cfg, weights):
    """Phase 3 (b)'s request (B=1, 16 new tokens): the device launches of a
    decode step, by the profiler's kernel counts of a whole ``generate()``
    less those of a prefill-only one, over the steps between them."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_lutvq_torch.runtime import generate

    req = slice_requests(cfg)["b"]
    generate(cfg, weights, req["prompts"], 2)  # warm-up: lazy inits
    counts = {}
    for n in (1, req["new"]):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            generate(cfg, weights, req["prompts"], n)
            torch.cuda.synchronize()
        counts[n] = sum(e.count for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
    per_step = (counts[req["new"]] - counts[1]) / (req["new"] - 1)
    print(f"[steps] phase 3 (b) B=1: {per_step:.1f} device launches a decode step "
          f"(generate of {req['new']} tokens {counts[req['new']]}, of 1 {counts[1]})")
    return per_step


def phase_lookups(device):
    """``--lookups``: A and M at phase 2's projection shapes, K, H and I at
    its scans and a 4096² projection, each call's device time (profiler),
    the kernels it launches and its error against the plain version (equal
    for H and I); then phase 3 (b)'s launches a decode step and phase 5.  It
    calls the wrappers alone, so copied into an earlier tree's checkout it
    measures that tree the same way: one call can run parent, change,
    change, parent."""
    from tpu_lutvq_torch import VQConfig, VQParams, aqlm_2x8, init_vq_params
    from tpu_lutvq_torch.kernels.lut_ctor import build_lut

    lg, _ = kernel_modules()
    gen = torch.Generator(device).manual_seed(1234)

    def row(label, fn, want, exact):
        got = fn()
        torch.cuda.synchronize()
        err = 0.0 if torch.equal(got, want) else rel_err(got, want)
        ks = launched_kernels(fn)
        print(f"[lookups] {label}: device {device_ms(fn, calls=20):.4f} ms, "
              f"{sum(ks.values())} kernels a call, err {err:.3e}")
        check(err == 0.0 if exact else err <= 1e-5, f"{label} disagrees with plain: {err}")

    for d_in, d_out in SHAPES:
        cfg = aqlm_2x8(d_in, shared_codebook=True)
        packed = lg.pack_params(cfg, init_vq_params(gen, cfg, d_out, with_scales=True))
        x = torch.randn((1, d_in), generator=gen, device=device)
        args = (build_lut(cfg, packed.codebook, x, compute_dtype=torch.bfloat16),
                packed.codes_t, packed.scales, packed.d_out)
        want = lg.lut_lookup_plain(*args)
        row(f"A {d_in}x{d_out} B=1", lambda: lg.lut_lookup(*args), want, False)
        row(f"M {d_in}x{d_out} B=1", lambda: lg.lut_lookup_pairf(*args), want, False)
        del packed
    cases = [(b, g, k, n) for (b, g, k), ns in TABLE_SCANS.items() for n in ns
             if n != "lut_gemv_bpair"]
    cases += [(b, 1024, 256, n) for b in (1, 8) for n in ("lut_gemv_f32", "lut_gemv_i8",
                                                          "lut_gemv_i16")]
    for b, g, k, name in cases:
        width = ANN_N if g < 1024 else 4096
        cfg = VQConfig(8 * g, g, 1, k)
        codes = torch.randint(0, k, (width, g, 1), generator=gen, device=device,
                              dtype=torch.int32).to(torch.uint8)
        packed = lg.pack_params(cfg, VQParams(torch.zeros((1, 1, 1, 1), device=device), codes))
        del codes
        lut = 100 * torch.rand((b, g, k), generator=gen, device=device)
        v = TABLE_VARIANTS[name]
        if v != "f32":
            quantize = lg.quantize_lut_int8 if v == "i8" else lg.quantize_lut_int16
            lut = quantize(lut, axis=(1, 2))[0]
            want = lg.lut_lookup_int_plain(lut, packed.codes_t, packed.scales, width)
        else:
            want = lg.lut_lookup_plain(lut, packed.codes_t, packed.scales, width,
                                       round_bf16=False)
        row(f"{name} B={b} G={g} K={k} n={width}",
            lambda: lg.lut_lookup_table(lut, packed.codes_t, packed.scales, width), want,
            v != "f32")
        del packed, lut, want
    cfg, weights = model(device)
    decode_step_launches(cfg, weights)
    del weights
    torch.cuda.empty_cache()
    phase_ann(device)


def ann_data(device):
    """Phase 5's base, training set and queries from a seeded generator on
    the card: a mixture of ``ANN_CENTERS`` Gaussian components in d=128,
    each spread over a shared ``ANN_LATENT``-dimensional subspace (with a
    little isotropic noise), so that the data's intrinsic dimension is low,
    as SIFT's is, and nearest neighbours stand out."""
    gen = torch.Generator(device).manual_seed(0)
    centers = torch.randn((ANN_CENTERS, ANN_D), generator=gen, device=device)
    basis = torch.randn((ANN_LATENT, ANN_D), generator=gen, device=device) / ANN_LATENT ** 0.5

    def draw(n):
        a = torch.randint(0, ANN_CENTERS, (n,), generator=gen, device=device)
        z = torch.randn((n, ANN_LATENT), generator=gen, device=device)
        eps = torch.randn((n, ANN_D), generator=gen, device=device)
        return centers[a] + ANN_SPREAD * (z @ basis) + ANN_NOISE * eps

    return draw(ANN_N), draw(ANN_NT), draw(ANN_NQ), gen


def exact_topk(base, queries, metric, k=ANN_TOPK):
    """Brute force on the raw base (f32 matmul, 128 queries at a time): the
    indices of the k nearest (l2) or highest inner products (ip)."""
    b2 = (base * base).sum(dim=1)
    out = []
    for q0 in range(0, queries.shape[0], ANN_CHUNK):
        dots = queries[q0 : q0 + ANN_CHUNK] @ base.T
        if metric == "l2":
            out.append(torch.topk(b2[None] - 2 * dots, k, dim=1, largest=False).indices)
        else:
            out.append(torch.topk(dots, k, dim=1).indices)
    return torch.cat(out)


def recall(idx, truth):
    """R@r for r in 1, 10, 100: the share of queries whose true nearest
    neighbour is among the first r results (FAISS's 1-recall@r)."""
    hit = idx == truth[:, :1]
    return {r: float(hit[:, :r].any(dim=1).float().mean()) for r in (1, 10, 100)}


def adc_scores(pq, queries, codes):
    """Exact ADC distances from the f32 tables, summed in subquantizer order."""
    tables = pq.l2_tables(queries)
    codes = codes.long()
    scores = tables[:, 0, codes[:, 0]]
    for m in range(1, pq.m):
        scores = scores + tables[:, m, codes[:, m]]
    return scores


def same_topk(vals, idx, scores, rel=ANN_TIE_REL):
    """Whether (vals, idx), sorted ascending, are the exact top-k of
    ``scores``: each value within ``rel`` of the exact one at its rank and of
    its own index's score, and an index in only one of the two results tied
    within ``rel`` with the k-th value."""
    ref_v, ref_i = torch.topk(scores, vals.shape[1], dim=1, largest=False)
    tol = rel * ref_v[:, -1:].abs()
    ok = bool(((vals - ref_v).abs() <= tol).all())
    ok &= bool(((scores.gather(1, idx) - vals).abs() <= tol).all())
    only_got = ~(idx[:, :, None] == ref_i[:, None, :]).any(dim=2)
    only_ref = ~(ref_i[:, :, None] == idx[:, None, :]).any(dim=2)
    for i, only in ((idx, only_got), (ref_i, only_ref)):
        off = (scores.gather(1, i) - ref_v[:, -1:]).abs() > tol
        ok &= not bool((only & off).any())
    return ok, int(only_got.sum())


def ann_search(name, search, queries, truth, metric, must_launch, check_chunk=None):
    """One search over all queries in chunks of ``ANN_CHUNK``, from zeroed
    launch counters: timed (host clock, synchronised), checked well formed,
    its recall printed.  ``check_chunk(q0, vals, idx)`` runs after the timing."""
    lookups = {k: v for k, v in counters().items() if k.startswith("lut_gemv")}
    for mod, attr in lookups.values():
        setattr(mod, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    chunks = range(0, queries.shape[0], ANN_CHUNK)
    res, secs = timed(lambda: [search(queries[q0 : q0 + ANN_CHUNK]) for q0 in chunks])
    launches = {k: getattr(mod, attr) for k, (mod, attr) in lookups.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    vals, idx = torch.cat([v for v, _ in res]), torch.cat([i for _, i in res])
    nq = queries.shape[0]
    check(vals.shape == idx.shape == (nq, ANN_TOPK), f"{name}: result shape {tuple(idx.shape)}")
    check(bool(torch.isfinite(vals).all()), f"{name}: non-finite values")
    check(bool(((idx >= 0) & (idx < ANN_N)).all()), f"{name}: indices out of range")
    step = vals[:, 1:] - vals[:, :-1]
    check(bool((step >= 0).all() if metric == "l2" else (step <= 0).all()),
          f"{name}: results not sorted")
    check(all(launches[k] > 0 for k in must_launch), f"{name}: {must_launch} did not launch")
    extra = ""
    if check_chunk is not None:
        extra = check_chunk([(q0, v, i) for q0, (v, i) in zip(chunks, res)])
    r = recall(idx, truth)
    print(f"[ann] {name}: {nq / secs:.1f} queries/s ({secs:.3f} s, host clock); R@1 {r[1]:.4f} "
          f"R@10 {r[10]:.4f} R@100 {r[100]:.4f}; launches "
          + " ".join(f"{k} {v}" for k, v in launches.items())
          + f"; peak device memory {peak:.2f} GiB{extra}")
    return dict(launches=launches, recall=r, qps=nq / secs)


def phase_ann(device):
    """Phase 5: FAISS's IndexPQ(128, 16, 8) at SIFT1M's size on the card."""
    from tpu_lutvq_torch.ann import ProductQuantizer, ResidualQuantizer
    from tpu_lutvq_torch.ann.pq import MixedPQ, sdc_search

    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 matmuls would break the refine bounds")
    (base, train, queries, gen), secs = timed(lambda: ann_data(device))
    print(f"[ann] data: Gaussian mixture of {ANN_CENTERS} components over a "
          f"{ANN_LATENT}-dimensional subspace, d={ANN_D}, base "
          f"{ANN_N}, train {ANN_NT}, queries {ANN_NQ} (cut from SIFT1M's {ANN_NQ_SIFT1M}), "
          f"{secs:.2f} s")
    truth = {m: exact_topk(base, queries, m) for m in ("l2", "ip")}
    pq, secs = timed(lambda: ProductQuantizer(ANN_D, ANN_M, ANN_K).train(gen, train))
    codes, enc_secs = timed(lambda: pq.encode(base))
    mse = float(((pq.decode(codes[:ANN_NT]) - base[:ANN_NT]) ** 2).sum(dim=1).mean())
    print(f"[ann] PQ{ANN_M}x{ANN_K.bit_length() - 1}: trained in {secs:.2f} s (25 iterations, "
          f"init 'sample'), base encoded in {enc_secs:.2f} s, codes {tuple(codes.shape)} "
          f"{codes.dtype}; reconstruction error {mse:.4f} per vector")

    results = {}
    for name, kw, must in (
        ("(a) l2 f32 tables", dict(), ("lut_gemv_bpair",)),
        ("(b) l2 int8 tables", dict(table_dtype="int8"), ("lut_gemv_i8",)),
        ("(c) l2 int16 tables", dict(table_dtype="int16"), ("lut_gemv_i16",)),
    ):
        results[name] = ann_search(
            name, lambda q, kw=kw: pq.search(q, codes, topk=ANN_TOPK, **kw), queries,
            truth["l2"], "l2", must)

    stats = []

    def refined(q):
        s = {}
        out = pq.search(q, codes, topk=ANN_TOPK, refine_groups=ANN_REFINE_GROUPS,
                        shortlist=ANN_SHORTLIST, stats=s)
        stats.append(s["scored_frac"])
        return out

    def exact_check(chunks):
        agree, moved = True, 0
        for q0, v, i in chunks:
            ok, n = same_topk(v, i, adc_scores(pq, queries[q0 : q0 + ANN_CHUNK], codes))
            agree, moved = agree and ok, moved + n
        check(agree, "(d): the refined search is not the exact f32 ADC top-100")
        return (f"; the exact f32 ADC top-{ANN_TOPK}: {agree} ({moved} indices differ by "
                f"ties within {ANN_TIE_REL:g}); scored_frac {min(stats):.5f}-{max(stats):.5f}")

    results["(d) l2 refined"] = ann_search(
        f"(d) l2 refined from {ANN_REFINE_GROUPS} groups, shortlist {ANN_SHORTLIST}", refined, queries, truth["l2"], "l2",
        ("lut_gemv_f32",), exact_check)
    results["(e) ip f32 tables"] = ann_search(
        "(e) ip f32 tables", lambda q: pq.search(q, codes, topk=ANN_TOPK, metric="ip"),
        queries, truth["ip"], "ip", ("lut_gemv_bpair",))

    rq, secs = timed(lambda: ResidualQuantizer(ANN_D, 4, ANN_K).train(gen, train))
    rq_codes = rq.encode(base)
    print(f"[ann] RQ 4x{ANN_K}: trained in {secs:.2f} s, base encoded")
    ann_search("RQ4 ip", lambda q: rq.search(q, rq_codes, topk=ANN_TOPK), queries,
               truth["ip"], "ip", ("lut_gemv_bpair",))
    ann_search("SDC l2", lambda q: sdc_search(pq, pq.encode(q), codes, topk=ANN_TOPK),
               queries, truth["l2"], "l2", ("lut_gemv_bpair",))
    mpq, secs = timed(lambda: MixedPQ(ANN_D, ANN_MIXED_KS).train(gen, train))
    mpq_codes = mpq.encode(base)
    print(f"[ann] MixedPQ ks {ANN_MIXED_KS[:2]}x{len(ANN_MIXED_KS) // 2}: trained in "
          f"{secs:.2f} s, base encoded")
    ann_search("MixedPQ l2", lambda q: mpq.search(q, mpq_codes, topk=ANN_TOPK), queries,
               truth["l2"], "l2", ("lut_gemv_bpair",))
    return {"lut_gemv_i8": results["(b) l2 int8 tables"]["launches"]["lut_gemv_i8"],
            "lut_gemv_i16": results["(c) l2 int16 tables"]["launches"]["lut_gemv_i16"],
            "lut_gemv_f32": results["(d) l2 refined"]["launches"]["lut_gemv_f32"]}


def phase_tmac(device):
    """Phase 7: one Llama-2-7B decoder layer's seven projections as T-MAC
    W4 nibble-packed layers through ``QuantizedLinear.apply(strategy=
    "auto")`` at 1, 8 and 9 rows.  J1 must launch at 1, J2 at 8, both at 9,
    the dequant kernels never.  Each output is held to the same layer from
    the unpacked K=16 pack through ``lut_gemv`` (the same entries: f32
    tables through K at one token, bf16 ones through B from two up), and at
    one row to ``core.golden.lut_gemm``.  Returns J1's and J2's launches."""
    from tpu_lutvq_torch.core.golden import lut_gemm
    from tpu_lutvq_torch.models.linear import QuantizedLinear

    lg, dq = kernel_modules()
    gen = torch.Generator(device).manual_seed(0)
    j_counters = ("LUT_GEMV_NIBBLES_LAUNCHES", "LUT_GEMV_NIBBLES_BPAIR_LAUNCHES")
    dq_counters = ("DEQUANT_MM_LAUNCHES", "DEQUANT_MM_I8_LAUNCHES", "DEQUANT_MM_F32_LAUNCHES")
    layers = []
    for name, d_in, d_out in TMAC_LAYER:
        cfg, params, packed = tmac_layer(gen, d_in, d_out)
        unpacked = QuantizedLinear(lg.pack_params(cfg, params))
        layers.append((name, cfg, params, QuantizedLinear(packed), unpacked))
        print(f"[tmac] {name} {d_in}x{d_out}: code bytes nibble pack {nbytes(packed.codes_t):,}, "
              f"unpacked {nbytes(unpacked.packed.codes_t):,}")
    xs = {(b, d_in): torch.randn((b, d_in), generator=gen, device=device)
          for b in TMAC_ROWS for d_in in sorted({d for _, d, _ in TMAC_LAYER})}
    for _, cfg, _, nib, _ in layers:  # warm-up: lazy inits, allocator pools
        nib.apply(cfg, xs[1, cfg.d_in])
    torch.cuda.synchronize()
    for attr in j_counters + dq_counters:
        setattr(lg if attr in j_counters else dq, attr, 0)
    results = []
    for b in TMAC_ROWS:
        for name, cfg, params, nib, unpacked in layers:
            x = xs[b, cfg.d_in]
            before = [getattr(lg, a) for a in j_counters] + [getattr(dq, a) for a in dq_counters]
            y = nib.apply(cfg, x, strategy="auto")
            after = [getattr(lg, a) for a in j_counters] + [getattr(dq, a) for a in dq_counters]
            results.append((name, b, cfg, params, nib, unpacked, x, y,
                            [u - v for u, v in zip(after, before)]))
    launches = {"lut_gemv_nibbles": getattr(lg, j_counters[0]),
                "lut_gemv_nibbles_bpair": getattr(lg, j_counters[1])}
    for name, b, cfg, params, nib, unpacked, x, y, delta in results:
        ref = unpacked.apply(cfg, x, strategy="lut_gemv")
        golden = lut_gemm(cfg, params, x) if b == 1 else None
        torch.cuda.synchronize()
        err = rel_err(y, ref)
        g_err = rel_err(y, golden) if golden is not None else float("nan")
        ms = time_ms(lambda: nib.apply(cfg, x, strategy="auto"), reps=10)
        print(f"[tmac] {name} B={b}: launches J1 {delta[0]} J2 {delta[1]} dequant {sum(delta[2:])}; "
              f"rel err vs the unpacked pack {err:.3e} (tol {NIBBLE_TOL:.0e}), vs golden "
              f"{g_err:.3e}; apply {ms:.4f} ms")
        check(y.shape == (b, nib.packed.d_out) and bool(torch.isfinite(y).all()),
              f"phase 7 {name} B={b}: output {tuple(y.shape)}")
        check((delta[0] > 0) == (b % 8 == 1) and (delta[1] > 0) == (b >= 8),
              f"phase 7 {name} B={b}: the wrong nibble kernels launched {delta[:2]}")
        check(sum(delta[2:]) == 0, f"phase 7 {name} B={b}: a dequant kernel launched")
        check(err <= NIBBLE_TOL, f"phase 7 {name} B={b}: differs from the unpacked pack {err}")
        check(b != 1 or g_err <= TMAC_GOLDEN_TOL, f"phase 7 {name}: differs from golden {g_err}")
    print(f"[tmac] launches over the layer at rows {TMAC_ROWS}: " +
          " ".join(f"{k} {v}" for k, v in launches.items()))
    return launches


def synth_aqlm(cfg, n_layers, out_g=1, seed=0):
    """A Llama in the AQLM Hugging Face layout (``runtime/checkpoint.py``'s
    doc) at ``cfg``'s widths, numpy ``default_rng(seed)``: 2x8 codes as
    two's-complement int8, fp16 codebooks (N, K, out_g, 8) and per-row
    scales, fp16 embedding, norms and lm_head, distributed as
    ``init_llama``'s weights are."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, f = cfg.hidden, cfg.ffn
    shapes = {"self_attn.q_proj": (h, cfg.q_dim), "self_attn.k_proj": (h, cfg.kv_dim),
              "self_attn.v_proj": (h, cfg.kv_dim), "self_attn.o_proj": (cfg.q_dim, h),
              "mlp.gate_proj": (h, f), "mlp.up_proj": (h, f), "mlp.down_proj": (f, h)}
    t = {}
    for i in range(n_layers):
        base = f"model.layers.{i}"
        for proj, (d_in, d_out) in shapes.items():
            rows = d_out // out_g
            t[f"{base}.{proj}.codes"] = rng.integers(0, 256, (rows, d_in // 8, 2),
                                                     dtype=np.uint8).view(np.int8)
            t[f"{base}.{proj}.codebooks"] = rng.standard_normal(
                (2, 256, out_g, 8), dtype=np.float32).astype(np.float16)
            t[f"{base}.{proj}.scales"] = (1 + 0.1 * rng.standard_normal(
                (rows, 1, 1, 1), dtype=np.float32)).astype(np.float16)
        for norm in ("input_layernorm", "post_attention_layernorm"):
            t[f"{base}.{norm}.weight"] = np.ones(h, np.float16)
    for name in ("model.embed_tokens.weight", "lm_head.weight"):
        t[name] = (rng.standard_normal((cfg.vocab_size, h), dtype=np.float32)
                   / math.sqrt(h)).astype(np.float16)
    t["model.norm.weight"] = np.ones(h, np.float16)
    return t


def numpy_dequant(tensors, prefix):
    """Independent oracle: AQLM's ``_dequantize_weight`` in numpy f32, block
    rows interleaved (row o·og + r = block row r of code row o)."""
    import numpy as np

    codes = tensors[f"{prefix}.codes"]
    codes = codes.view(np.uint8 if codes.dtype == np.int8 else np.uint16).astype(np.int64)
    cb = tensors[f"{prefix}.codebooks"].astype(np.float32)  # (N, K, og, g)
    rows, m, n_cb = codes.shape
    og, g = cb.shape[2], cb.shape[3]
    w = np.zeros((rows, m, og, g), np.float32)
    for n in range(n_cb):
        w += cb[n][codes[:, :, n]]
    w *= tensors[f"{prefix}.scales"].reshape(-1).astype(np.float32)[:, None, None, None]
    return torch.from_numpy(w.transpose(0, 2, 1, 3).reshape(rows * og, m * g))


def save_sharded(tensors, directory, n_shards=2):
    """``tensors`` as a Hugging Face directory: ``n_shards`` safetensors
    files and ``model.safetensors.index.json``, with the port's writer."""
    import os

    from tpu_lutvq_torch.utils import safetensors_io

    names = sorted(tensors)
    weight_map = {}
    for s in range(n_shards):
        shard = f"model-{s + 1:05d}-of-{n_shards:05d}.safetensors"
        part = names[s::n_shards]
        safetensors_io.save_file({n: torch.from_numpy(tensors[n]) for n in part},
                                 os.path.join(directory, shard))
        weight_map.update({n: shard for n in part})
    with open(os.path.join(directory, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)


def weight_tensors(weights):
    """Every tensor of a LlamaWeights, and each pack's metadata, in order."""
    out = [weights.embed, weights.final_norm, weights.lm_head.w]
    for lw in weights.layers:
        out += [lw.attn_norm, lw.mlp_norm]
        for proj in (lw.wq, lw.wk, lw.wv, lw.wo, lw.w_gate, lw.w_up, lw.w_down):
            p = proj.packed
            out += [p.codes_t, p.codebook, p.scales, p.zero_points,
                    (p.d_out, p.shards, p.nibbles, p.out_group)]
    return out


def same_weights(a, b):
    ta, tb = weight_tensors(a), weight_tensors(b)
    return len(ta) == len(tb) and all(
        (u is None and v is None) or (isinstance(u, tuple) and u == v)
        or (isinstance(u, torch.Tensor) and isinstance(v, torch.Tensor)
            and u.dtype == v.dtype and torch.equal(u, v))
        for u, v in zip(ta, tb))


def phase_checkpoint(device):
    """Phase 8: the checkpoint entry point.  (a) A synthetic 32-layer
    Llama-2-7B-geometry AQLM checkpoint in memory, loaded by
    ``load_aqlm_llama``, serves ``generate()`` as phase 3 (b) does, through
    A and C, with phase 3's logits gate; a projection of each kind
    reconstructs to the numpy dequant.  (b) Two of its layers written as a
    sharded HF directory, loaded back equal; ``save_lutvq``/``load_lutvq``
    bit-equal with the same greedy tokens; the same at out_group_size 8,
    where B serves 8 pseudo-rows a token and the f32 tables meet the numpy
    dequant.  (c) One 4096x4096 1x16 projection in each ``one_x16`` mode.
    Temporary files go at the end."""
    import os
    import tempfile

    import numpy as np

    from tpu_lutvq_torch.models.llama import LlamaConfig
    from tpu_lutvq_torch.runtime import generate
    from tpu_lutvq_torch.runtime.checkpoint import (
        PROJ_NAMES, load_aqlm_linear, load_aqlm_llama, load_lutvq, save_lutvq)

    lg, dq = kernel_modules()
    # (a) full depth, in memory; the prompt from phase 3's prompt seed (the
    # logits gate is a draw on a chaotic random model: ``--spread``)
    cfg = LlamaConfig.llama2_7b(**CKPT_MODEL)
    prompt = ckpt_prompt(cfg, CKPT_PROMPT_SEED)
    tensors, secs = timed(lambda: synth_aqlm(cfg, cfg.n_layers))
    weights, load_s = timed(lambda: load_aqlm_llama(tensors, cfg, device=device))
    print(f"[ckpt] (a) synthetic AQLM 2x8 checkpoint, {cfg.n_layers} layers: made in {secs:.1f} s "
          f"({sum(a.nbytes for a in tensors.values()) / 2**30:.2f} GiB on the host), loaded in "
          f"{load_s:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    lw = weights.layers[0]
    for field, proj in PROJ_NAMES.items():
        layer = getattr(lw, field)
        d_in = tensors[f"model.layers.0.{proj}.codes"].shape[1] * 8
        vq = cfg.vq_cfg(d_in)
        w = layer.apply(vq, torch.eye(d_in, device=device), strategy="dense_bf16").T
        err = rel_err(w, numpy_dequant(tensors, f"model.layers.0.{proj}").to(device))
        print(f"[ckpt] (a) layer 0 {field} {tuple(w.shape)}: dense_bf16 vs numpy dequant {err:.3e}")
        check(err <= 1e-6, f"(a) {field} reconstructs wrong: {err}")
        del w
    generate(cfg, weights, prompt, 2)  # warm-up
    lg.LUT_GEMV_LAUNCHES = lg.LUT_GEMV_BPAIR_LAUNCHES = dq.DEQUANT_MM_LAUNCHES = 0
    res, total_s = timed(lambda: generate(cfg, weights, prompt, CKPT_NEW))
    launches = {"lut_gemv": lg.LUT_GEMV_LAUNCHES, "lut_gemv_bpair": lg.LUT_GEMV_BPAIR_LAUNCHES,
                "dequant_mm": dq.DEQUANT_MM_LAUNCHES}
    check_routes("(a)", launches, [routed_launches(cfg, CKPT_PROMPT), routed_launches(cfg, 1)],
                 tuple(launches))
    toks = res.tokens
    check(toks.shape == (1, CKPT_PROMPT + CKPT_NEW) and toks[0, :CKPT_PROMPT].tolist() == prompt[0]
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), f"(a) tokens {toks}")
    errs, finite = logits_errors(cfg, weights, prompt)
    floor = max(max(errs[run]) for run in REFERENCE_RUNS if run.startswith("floor"))
    print(f"[ckpt] (a) generate() B=1 prompt {CKPT_PROMPT} new {CKPT_NEW}: {total_s:.2f} s "
          f"(host clock); launches " + " ".join(f"{k} {v}" for k, v in launches.items()))
    print("[ckpt] (a) logits rel err vs plain, prefill/step: " + ", ".join(
        f"{run} {pre:.3e}/{stp:.3e}" for run, (pre, stp) in errs.items()))
    check(finite, "(a) non-finite logits")
    check(max(errs["kernel"]) <= LOGITS_TOL, f"(a) logits disagree {errs}")
    check(floor <= LOGITS_TOL, "(a) plain-vs-plain noise over the tolerance")
    check(max(errs["control"]) > LOGITS_TOL, "(a) tolerance passes the control")
    del weights

    with tempfile.TemporaryDirectory() as tmp:
        # (b) two layers on disk, out_group_size 1 and 8
        cfg2 = LlamaConfig.llama2_7b(**dict(CKPT_MODEL, n_layers=CKPT_DISK_LAYERS))
        keep = tuple(f"model.layers.{i}." for i in range(CKPT_DISK_LAYERS))
        for og in (1, 8):
            if og == 1:
                part = {k: v for k, v in tensors.items()
                        if not k.startswith("model.layers.") or k.startswith(keep)}
            else:
                part = synth_aqlm(cfg2, CKPT_DISK_LAYERS, out_g=og, seed=1)
            hf = os.path.join(tmp, f"hf_og{og}")
            os.makedirs(hf)
            _, write_s = timed(lambda: save_sharded(part, hf))
            disk = sum(os.path.getsize(os.path.join(hf, f)) for f in os.listdir(hf))
            w_disk, read_s = timed(lambda: load_aqlm_llama(hf, cfg2, device=device))
            w_mem = load_aqlm_llama(part, cfg2, device=device)
            check(same_weights(w_disk, w_mem), f"(b) og={og}: the disk load differs from memory")
            native = os.path.join(tmp, f"og{og}.lutvq.safetensors")
            _, save_s = timed(lambda: save_lutvq(native, cfg2, w_disk))
            (cfg3, w_native), native_s = timed(lambda: load_lutvq(native, device=device))
            check(cfg3 == cfg2 and same_weights(w_native, w_disk),
                  f"(b) og={og}: the native round trip is not bit-equal")
            t1 = generate(cfg2, w_disk, prompt, 8).tokens
            t2 = generate(cfg2, w_native, prompt, 8).tokens
            check(torch.equal(t1, t2), f"(b) og={og}: tokens differ after the native round trip")
            print(f"[ckpt] (b) out_group {og}, {CKPT_DISK_LAYERS} layers: HF directory of 2 shards, "
                  f"{disk / 2**20:.1f} MiB written in {write_s:.2f} s, read and loaded in "
                  f"{read_s:.2f} s, equal to the in-memory load; native file "
                  f"{os.path.getsize(native) / 2**20:.1f} MiB saved in {save_s:.2f} s, loaded in "
                  f"{native_s:.2f} s, bit-equal, greedy tokens equal")
            if og > 1:
                out_group_checks(device, cfg2, w_disk, part, og)
            del w_disk, w_mem, w_native, part
        del tensors

        # (c) one 1x16 projection in each mode
        d_in, d_out = ONE_X16_SHAPE
        rng = np.random.default_rng(2)
        one = {"p.codes": rng.integers(0, 65536, (d_out, d_in // 8, 1), dtype=np.uint16)
               .view(np.int16),
               "p.codebooks": rng.standard_normal((1, 65536, 1, 8), dtype=np.float32)
               .astype(np.float16),
               "p.scales": (1 + 0.1 * rng.standard_normal((d_out, 1, 1, 1), dtype=np.float32))
               .astype(np.float16)}
        w_ref = numpy_dequant(one, "p").to(device)
        x = torch.randn((8, d_in), generator=torch.Generator(device).manual_seed(3), device=device)
        y_ref = x.double() @ w_ref.double().T
        (dense, _), secs = timed(lambda: load_aqlm_linear(one, "p", one_x16="dequant",
                                                          device=device))
        same = bool(torch.equal(dense.w, w_ref.to(torch.bfloat16)))
        print(f"[ckpt] (c) 1x16 {d_in}x{d_out} dequant: loaded in {secs:.2f} s, weight equal to "
              f"the numpy dequant rounded to bf16: {same}")
        check(same, "(c) dequant differs from the numpy oracle")
        (chunked, c_cfg), secs = timed(lambda: load_aqlm_linear(one, "p", one_x16="chunked",
                                                                device=device))
        err = rel_err(chunked.apply(c_cfg, x).double(), y_ref)
        ms = time_ms(lambda: chunked.apply(c_cfg, x), reps=5)
        print(f"[ckpt] (c) chunked: loaded in {secs:.2f} s, 8 rows rel err {err:.3e} (tol "
              f"{CKPT_CHUNKED_TOL:.0e}), {ms:.3f} ms a call; codes "
              f"{nbytes(chunked.codes) / 2**20:.1f} MiB against the dense "
              f"{nbytes(dense.w) / 2**20:.1f} MiB")
        check(err <= CKPT_CHUNKED_TOL, f"(c) chunked disagrees: {err}")
        (refit, r_cfg), secs = timed(lambda: load_aqlm_linear(one, "p", one_x16="refit",
                                                              device=device))
        w2 = refit.apply(r_cfg, torch.eye(d_in, device=device), strategy="dense_bf16").T
        q_err = float(torch.linalg.norm(w2 - w_ref) / torch.linalg.norm(w_ref))
        print(f"[ckpt] (c) refit to 2x8: {secs:.2f} s, relative error {q_err:.4f} (random "
              f"codebooks do not decompose; a finding, not a gate)")
        check(math.isfinite(q_err) and r_cfg.n_cluster == 256, "(c) refit failed")


def ckpt_prompt(cfg, seed):
    ids = torch.Generator().manual_seed(seed)
    return [torch.randint(0, cfg.vocab_size, (CKPT_PROMPT,), generator=ids).tolist()]


def phase_gate_spread(device):
    """``--spread``: phase 8 (a)'s logits gate on its loaded checkpoint for
    each prompt seed of ``SPREAD_SEEDS``: how often a fresh draw of the
    chaotic random model reads over the limit, with its floors and control."""
    from tpu_lutvq_torch.models.llama import LlamaConfig
    from tpu_lutvq_torch.runtime.checkpoint import load_aqlm_llama

    cfg = LlamaConfig.llama2_7b(**CKPT_MODEL)
    weights = load_aqlm_llama(synth_aqlm(cfg, cfg.n_layers), cfg, device=device)
    over = 0
    for seed in SPREAD_SEEDS:
        errs, finite = logits_errors(cfg, weights, ckpt_prompt(cfg, seed))
        floor = max(max(errs[run]) for run in REFERENCE_RUNS if run.startswith("floor"))
        over += max(errs["kernel"]) > LOGITS_TOL
        print(f"[spread] prompt seed {seed}: kernel {max(errs['kernel']):.3e} floors "
              f"{floor:.3e} control {max(errs['control']):.3e} finite {finite}")
    print(f"[spread] kernel runs over {LOGITS_TOL:g}: {over} of {len(SPREAD_SEEDS)}")


def out_group_checks(device, cfg, weights, tensors, og):
    """Phase 8 (b) at ``out_group_size`` og: one B=1 decode step, where B
    must serve every projection at og pseudo-rows, and layer 0's
    projections through the f32 tables against the numpy dequant."""
    from tpu_lutvq_torch.models.llama import init_caches, llama_decode_step
    from tpu_lutvq_torch.runtime.checkpoint import PROJ_NAMES

    lg, _ = kernel_modules()
    rows, launch = [], lg._launch

    def recording(lut, *a):
        rows.append(lut.shape[0])
        return launch(lut, *a)

    tok = torch.tensor([1], dtype=torch.int32, device=device)
    lg._launch, lg.LUT_GEMV_LAUNCHES, lg.LUT_GEMV_BPAIR_LAUNCHES = recording, 0, 0
    try:
        llama_decode_step(cfg, weights, tok, init_caches(cfg, 1, device=device), 0)
        torch.cuda.synchronize()
    finally:
        lg._launch = launch
    n = lg.LUT_GEMV_LAUNCHES + lg.LUT_GEMV_BPAIR_LAUNCHES  # A at 1 pseudo-row, B at 2-8
    print(f"[ckpt] (b) out_group {og}: a B=1 decode step launched B {n} times at "
          f"{sorted(set(rows))} pseudo-rows")
    check(n == 7 * cfg.n_layers and set(rows) == {og}, f"(b) B did not serve {og} pseudo-rows")
    gen = torch.Generator(device).manual_seed(5)
    for field, proj in PROJ_NAMES.items():
        layer = getattr(weights.layers[0], field)
        prefix = f"model.layers.0.{proj}"
        d_in = tensors[f"{prefix}.codes"].shape[1] * 8
        x = torch.randn((1, d_in), generator=gen, device=device)
        y = layer.apply(cfg.vq_cfg(d_in), x, strategy="lut_gemv", variant="f32")
        want = x.double() @ numpy_dequant(tensors, prefix).to(device).double().T
        err = rel_err(y.double(), want)
        check(err <= CKPT_OG_TOL, f"(b) out_group {og} {field}: f32 tables disagree {err}")
    print(f"[ckpt] (b) out_group {og}: layer 0's projections, f32 tables against the numpy "
          f"dequant within {CKPT_OG_TOL:.0e}")


def phase_routes(device):
    """At the Llama-2-7B projection shapes and ``ROUTE_ROWS`` rows, every
    exact-tier strategy's whole ``QuantizedLinear.apply`` call on the
    device (the median of three turns of the strategies, each the median of
    three profiler sessions of 20 calls that saw every kernel, L2 warm):
    ``pick_strategy``'s route must be within ``ROUTE_TOL`` of the fastest.
    Beside each route, ``layer_report``'s predicted time, and a layer's
    total of both."""
    from tpu_lutvq_torch import init_vq_params
    from tpu_lutvq_torch.dataflow.sweep import EXACT_TIER
    from tpu_lutvq_torch.dataflow.traffic import pick_strategy
    from tpu_lutvq_torch.models.linear import QuantizedLinear
    from tpu_lutvq_torch.models.llama import LlamaConfig
    from tpu_lutvq_torch.utils.profiling import layer_report

    lg, _ = kernel_modules()
    cfg = LlamaConfig.llama2_7b()
    gen = torch.Generator(device).manual_seed(7)
    shapes = sorted(set(projections(cfg).values()))
    layers = {}
    for d_in, d_out in shapes:
        vq = cfg.vq_cfg(d_in)
        layers[d_in, d_out] = QuantizedLinear(
            lg.pack_params(vq, init_vq_params(gen, vq, d_out, with_scales=True)))
    for rows in ROUTE_ROWS:
        report = {r["proj"]: r for r in layer_report(cfg, batch=rows)[:-1]}
        measured = {}
        for (d_in, d_out), layer in layers.items():
            vq = cfg.vq_cfg(d_in)
            x = torch.randn((rows, d_in), generator=gen, device=device)
            times = {s: [] for s in EXACT_TIER}
            for _ in range(3):  # the strategies in turn
                for s in EXACT_TIER:
                    times[s].append(1e3 * device_ms(lambda: layer.apply(vq, x, strategy=s),
                                                    sessions=3))
            times = {s: statistics.median(t) for s, t in times.items()}
            pick, fastest = pick_strategy(vq, d_out, rows), min(times, key=times.get)
            measured[d_in, d_out] = times[pick]
            pred = next(r for r in report.values() if (r["d_in"], r["d_out"]) == (d_in, d_out))
            print(f"[routes] {d_in}x{d_out} rows={rows}: device us " + " ".join(
                f"{s} {t:.2f}" for s, t in times.items()) + f"; route {pick} "
                f"({times[pick] / times[fastest]:.3f} of the fastest), layer_report predicts "
                f"{pred['strategy']} {pred['pred_us']:.2f} us ({pred['bound']}-bound)")
            check(pred["strategy"] == pick, f"layer_report's route {pred['strategy']} is not {pick}")
            check(times[pick] <= ROUTE_TOL * times[fastest],
                  f"{d_in}x{d_out} rows={rows}: the route {pick} reads {times[pick]:.2f} us, "
                  f"over {ROUTE_TOL} x the fastest ({fastest} {times[fastest]:.2f} us)")
        total = sum(measured[r["d_in"], r["d_out"]] for r in report.values())
        print(f"[routes] rows={rows}: a 7B layer's seven routed projections {total:.2f} us on "
              f"the device, layer_report predicts {sum(r['pred_us'] for r in report.values()):.2f}")


def phase_native():
    """The port's native host library (``tpu_lutvq_torch/csrc/lutvq_pack.cpp``),
    built here with g++, bit-equal to its numpy branches at Llama-2-7B
    width: a gate projection's codes transposed and split into two padded
    shards, and a 4096x4096 1x16 projection dequantized (host seconds of
    each beside the numpy branch's)."""
    import numpy as np

    native = importlib.import_module("tpu_lutvq_torch.utils.native")
    built, secs = timed(native.have_native)
    check(built, "the native library did not build")
    print(f"[native] built and loaded {native._build()} in {secs:.1f} s")
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 256, (11008, 1024), dtype=np.uint8)  # (d_out, G) of w_gate
    one_x16 = rng.integers(0, 1 << 16, (4096, 512, 1), dtype=np.uint16)  # (d_out, M, N)
    cb = rng.standard_normal((1, 1 << 16, 8), dtype=np.float32)
    scales = rng.random(4096, dtype=np.float32) + 0.5
    cases = {
        "transpose_u8 11008x1024": lambda: native.transpose_u8(codes),
        "shard_repack_u8 1024x11008 into 2 shards of 5632": lambda: native.shard_repack_u8(
            codes.T, 5504, 5632, 2, 0),
        "dequant_additive 1x16 4096x4096": lambda: native.dequant_additive(one_x16, cb, scales),
    }
    load = native._load
    for name, fn in cases.items():
        got, t_native = timed(fn)
        native._load = lambda: None  # the numpy branch
        try:
            want, t_numpy = timed(fn)
        finally:
            native._load = load
        same = got.dtype == want.dtype and np.array_equal(got, want)
        print(f"[native] {name}: bit-equal to numpy {same}; native {t_native:.3f} s, numpy "
              f"{t_numpy:.3f} s (host clock)")
        check(same, f"native {name} differs from the numpy branch")


KERNELS = {
    "lut_gemv": dict(
        route="cuda", source="tpu_lutvq_torch/csrc/lut_scan.cu",
        replaces="tpu_lutvq/kernels/lut_gemv.py:344",
    ),
    "lut_gemv_bpair": dict(
        route="cuda", source="tpu_lutvq_torch/csrc/lut_bpair.cu",
        replaces="tpu_lutvq/kernels/lut_gemv.py:376",
    ),
    "dequant_mm": dict(
        route="cuda", source="tpu_lutvq_torch/csrc/dequant_mm.cu",
        replaces="tpu_lutvq/kernels/dequant_mm.py:247",
        also_replaces=["tpu_lutvq/kernels/dequant_mm.py:311"],
    ),
    "flash_decode": dict(
        route="cuda", source="tpu_lutvq_torch/csrc/flash_decode.cu",
        replaces="tpu_lutvq/kernels/flash_decode.py:168",
        also_replaces=["tpu_lutvq/kernels/flash_decode.py:74"],
    ),
    "flash_decode_paged": dict(
        route="cuda", source="tpu_lutvq_torch/csrc/flash_decode.cu",
        replaces="tpu_lutvq/kernels/flash_decode.py:378",
        also_replaces=["tpu_lutvq/kernels/flash_decode.py:306"],
    ),
    "flash_prefill": dict(
        route="cuda", source="tpu_lutvq_torch/csrc/flash_prefill.cu",
        replaces="tpu_lutvq/kernels/flash_prefill.py:122",
        also_replaces=["tpu_lutvq/kernels/flash_prefill.py:45"],
    ),
    "lut_gemv_f32": dict(
        route="cuda", source="tpu_lutvq_torch/csrc/lut_scan.cu",
        replaces="tpu_lutvq/kernels/lut_gemv.py:586",
    ),
    "lut_gemv_i8": dict(
        route="cuda", source="tpu_lutvq_torch/csrc/lut_scan.cu",
        replaces="tpu_lutvq/kernels/lut_gemv.py:487",
    ),
    "lut_gemv_i16": dict(
        route="cuda", source="tpu_lutvq_torch/csrc/lut_scan.cu",
        replaces="tpu_lutvq/kernels/lut_gemv.py:541",
    ),
    "dequant_mm_i8": dict(
        route="cuda", source="tpu_lutvq_torch/csrc/dequant_mm_i8.cu",
        replaces="tpu_lutvq/kernels/dequant_mm.py:137",
        also_replaces=["tpu_lutvq/kernels/dequant_mm.py:188"],
    ),
    "fold_i8": dict(  # the W8A8 activation fold: XLA ops in the JAX package, not Pallas
        route="cuda", source="tpu_lutvq_torch/csrc/dequant_mm_i8.cu",
        replaces="tpu_lutvq/kernels/dequant_mm.py:644",
    ),
    "dequant_mm_f32": dict(
        route="cuda", source="tpu_lutvq_torch/csrc/dequant_mm_f32.cu",
        replaces="tpu_lutvq/kernels/dequant_mm.py:388",
        also_replaces=["tpu_lutvq/kernels/dequant_mm.py:449"],
    ),
    "lut_gemv_pairf": dict(
        route="cuda", source="tpu_lutvq_torch/csrc/lut_scan.cu",
        replaces="tpu_lutvq/kernels/lut_gemv.py:309",
    ),
    "lut_gemv_nibbles": dict(
        route="cuda", source="tpu_lutvq_torch/csrc/lut_nibbles.cu",
        replaces="tpu_lutvq/kernels/lut_gemv.py:628",
    ),
    "lut_gemv_nibbles_bpair": dict(
        route="cuda", source="tpu_lutvq_torch/csrc/lut_nibbles.cu",
        replaces="tpu_lutvq/kernels/lut_gemv.py:658",
    ),
}
# the main-path run whose launch counts each kernel's summary reports
LAUNCHES_FROM = {"flash_decode": "i slab auto", "flash_decode_paged": "ii paged auto",
                 "flash_prefill": "iii slab flash chunked"}


GUARD_PAD = 1 << 16  # bytes of 0xA5 on each side of a guarded buffer
GUARDING = False  # under --guard every wrapper buffer is filled: one more kernel each


class GuardBands:
    """``torch`` as the kernel modules see it under ``--guard``: ``empty``
    and ``empty_like`` of a CUDA tensor return a view into a buffer with
    ``GUARD_PAD`` bytes of 0xA5 on each side; :meth:`check` names every
    buffer whose bands changed."""

    def __init__(self):
        self.guards, self.live, self.checked, self.bad = [], 0, 0, []

    def __getattr__(self, name):
        return getattr(torch, name)

    def _guarded(self, shape, dtype):
        n_bytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        buf = torch.full((2 * GUARD_PAD + -(-n_bytes // 256) * 256,), 0xA5,
                         dtype=torch.uint8, device="cuda")
        caller = sys._getframe(2)
        self.guards.append((buf, n_bytes, f"{caller.f_code.co_name}:{caller.f_lineno} "
                                          f"{tuple(shape)} {dtype}"))
        self.live += buf.numel()
        # a check synchronises the card: never inside a graph capture
        if self.live > 2 << 30 and not torch.cuda.is_current_stream_capturing():
            self.check("(2 GiB of buffers)")
        return buf[GUARD_PAD:GUARD_PAD + n_bytes].view(dtype).view(shape)

    def empty(self, *shape, dtype=None, device=None, **kw):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
            shape = tuple(shape[0])
        if device is None or torch.device(device).type != "cuda" or kw:
            return torch.empty(shape, dtype=dtype, device=device, **kw)
        return self._guarded(shape, dtype or torch.get_default_dtype())

    def empty_like(self, t, **kw):
        if t.device.type != "cuda" or kw:
            return torch.empty_like(t, **kw)
        return self._guarded(tuple(t.shape), t.dtype)

    def check(self, tag):
        torch.cuda.synchronize()
        if self.guards:
            changed = torch.stack([
                (buf[:GUARD_PAD] != 0xA5).any() | (buf[GUARD_PAD + n:] != 0xA5).any()
                for buf, n, _ in self.guards]).tolist()
            self.bad += [f"{tag}: {who}" for c, (_, _, who) in zip(changed, self.guards) if c]
        self.checked += len(self.guards)
        self.guards, self.live = [], 0


def phase_guarded(device):
    """Phases 2 (its shapes rows too), 3, 4, 6 and 7 with the kernel
    wrappers' buffers in guard bands."""
    mods = [importlib.import_module(f"tpu_lutvq_torch.kernels.{m}")
            for m in ("lut_gemv", "dequant_mm", "flash_decode", "flash_prefill")]
    global GUARDING
    bands = GuardBands()
    for m in mods:
        m.torch = bands
    GUARDING = True
    try:
        for phase in (phase_kernels, phase_attention, phase_tables, phase_tiers, phase_nibbles,
                      phase_shapes):
            phase(device)
            bands.check(phase.__name__)
        cfg, weights = model(device)
        phase_slice(device, cfg, weights)
        bands.check("phase_slice")
        batcher = phase_batcher(device, cfg, weights)
        bands.check("phase_batcher")
        phase_tier_runs(device, cfg, weights, batcher)
        bands.check("phase_tier_runs")
        del weights, batcher
        phase_tmac(device)
        bands.check("phase_tmac")
    finally:
        GUARDING = False
        for m in mods:
            m.torch = torch
    print(f"[guard] {bands.checked} buffers checked, {len(bands.bad)} with a band written")
    for who in bands.bad:
        print(f"[guard] written past: {who}")
    check(not bands.bad, "a kernel wrote outside its buffer")


def phase_sweep(smi):
    """``--sweep``: measure the projection strategies' sweep and the attention
    crossover on this card and rewrite ``tpu_lutvq_torch/dataflow/
    h100_sweep.csv`` and ``h100_attn.csv``, the card's name and power limit
    in their first line."""
    from tpu_lutvq_torch.dataflow import attn_sweep, sweep

    header = (smi, "python3 chip_smoke.py --sweep; device times by torch.profiler, L2 warm; "
                   "events: CUDA-event medians, L2 flushed")
    run_phase("sweep", sweep.run_sweep, None, str(sweep.SWEEP_CSV), True, header)
    run_phase("attention crossover", attn_sweep.measure_attention, str(attn_sweep.ATTN_CSV),
              header)
    print(f"[sweep] wrote {sweep.SWEEP_CSV} and {attn_sweep.ATTN_CSV}")


def run_phase(label, fn, *args):
    """``fn(*args)``, then its seconds (host clock, synchronised)."""
    out, secs = timed(lambda: fn(*args))
    print(f"[time] {label}: {secs:.1f} s")
    return out


def main(mode=None):
    import tpu_lutvq_torch  # noqa: F401  (fails at once outside the repository)

    smi = phase_device()
    device = torch.device("cuda")
    phase_build(strict=mode not in ("--profile", "--plans", "--lookups"))
    if mode == "--profile":
        phase_profile(device, *model(device))
        return
    if mode == "--guard":
        phase_guarded(device)
        return
    if mode == "--spread":
        phase_gate_spread(device)
        return
    if mode == "--plans":
        phase_plans(device)
        return
    if mode == "--lookups":
        phase_lookups(device)
        return
    if mode == "--sweep":
        phase_sweep(smi)
        return
    rows = run_phase("phase 2 projections", phase_kernels, device)
    rows.update(run_phase("phase 2 attention", phase_attention, device))
    for name, rs in run_phase("phase 2 tables", phase_tables, device).items():
        rows.setdefault(name, []).extend(rs)
    rows.update(run_phase("phase 2 tiers", phase_tiers, device))
    rows.update(run_phase("phase 2 nibbles", phase_nibbles, device))
    for name, rs in run_phase("phase 2 shapes", phase_shapes, device).items():
        rows[name].extend(rs)
    report_2x8_times(rows)
    run_phase("routes", phase_routes, device)
    run_phase("native", phase_native)
    cfg, weights = model(device)
    launches = run_phase("phase 3", phase_slice, device, cfg, weights)
    batcher = run_phase("phase 4", phase_batcher, device, cfg, weights)
    for name, run in LAUNCHES_FROM.items():
        launches[name] = batcher[run]["launches"][name]
    launches.update(run_phase("phase 6", phase_tier_runs, device, cfg, weights, batcher))
    run_phase("stacked", phase_stacked, device, cfg, weights, batcher)
    run_phase("graphs", phase_graphs, device, cfg, weights)
    del weights, batcher
    torch.cuda.empty_cache()
    launches.update(run_phase("phase 5", phase_ann, device))
    torch.cuda.empty_cache()
    launches.update(run_phase("phase 7", phase_tmac, device))
    run_phase("phase 8", phase_checkpoint, device)
    summary = []
    for name, meta in KERNELS.items():
        at = next(r for r in rows[name] if r["shape"].startswith(SUMMARY_AT[name]))
        summary.append(dict(
            name=name, **meta, launches=launches[name],
            max_abs_err=max(r["abs"] for r in rows[name]),
            ms=at["ms"], device_ms=at["device_ms"], plain_ms=at["plain_ms"],
            bound_ms=at["bound_ms"], bound_by=at["bound_by"], library_ms=at["library_ms"],
            library_device_ms=at["library_device_ms"], at=at["shape"],
        ))
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    if sys.argv[1:] not in ([], ["--profile"], ["--guard"], ["--spread"], ["--plans"],
                            ["--lookups"], ["--sweep"]):
        print("usage: chip_smoke.py [--profile | --guard | --spread | --plans | --lookups | "
              "--sweep]", file=sys.stderr)
        sys.exit(2)
    main(*sys.argv[1:])
