"""Traffic and time model of the port's projection strategies on the H100
(counterpart of ``tpu_lutvq.dataflow.traffic``).

Each strategy's :class:`KernelCost` keeps the reference's byte categories
(``codeword / codebook / lut / inp / psum``, the paper's ``perf_cnt``):
``codeword``, ``codebook``, ``inp`` and ``psum`` describe the function, as
the reference counts them (``_base_traffic``), and ``lut`` the tables the
port's kernels really read: ``build_lut``'s f32 tables for the bf16 lookups
(A and B round them as they stage them), the quantized int8/int16 tables for
H and I, none for the dequant-matmuls C and G.  In place of the TPU's VPU
lane-ops it counts the kernels' shared-memory words, by kernel:
``lookups``, the 4-byte words one call gathers (table entries for A, B, H
and I; codebook rows for C and G, once per row tile), and ``staged``, the
words it writes into shared memory first (a split's tables once per column
tile; the codebook once per block, or streamed through every block where
each subvector has its own), each in total and on the busiest SM
(``busiest``: the kernel's own plan, its blocks in waves of as many as the
card holds at once).  Tensor-core operations (``tensor_ops``) are counted
as the reference counts ``mxu_flops``.

``time_s`` is a launch cost a kernel call (the whole call: ``build_lut``
and the lookup, the fold and the W8A8 kernel), the building of the
lookups' tables (their bytes at a cost over the HBM rate), plus the
largest of the HBM time, the shared-memory time and the tensor time
(operations at a cost each over the peak rate).  The shared-memory time is
the busiest SM's gathered and staged words, each at a cost a word, over
one SM's rate (the lookups wait on their own latency, so the longest block
sets the time where the card is not full), plus all the call's words at a
cost over the card's rate (the SMs' throughput, where blocks share them).
The costs are fitted to the card's measurements, ``h100_sweep.csv`` beside
this file, by :func:`tpu_lutvq_torch.dataflow.sweep.fit_constants`.
``pick_strategy`` takes the least predicted time, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

from tpu_lutvq_torch.core.config import VQConfig
from tpu_lutvq_torch.dataflow.chips import ChipSpec, default_chip
from tpu_lutvq_torch.kernels.dequant_mm import (
    _BF16X2_TILES,
    _I8_TILES,
    STAGED_CODEBOOK_BYTES,
    bf16x2_general,
    i8_general,
    plan_bf16x2,
    plan_i8,
)
from tpu_lutvq_torch.kernels.lut_ctor import LANE
from tpu_lutvq_torch.kernels.lut_gemv import (
    DEFAULT_BLOCK_J,
    MAX_LUT_BATCH,
    SCAN_PAIR,
    _round_up,
    plan_bpair,
    plan_scan,
    scan_blocks_per_sm,
    scan_layout,
)

# Fitted to h100_sweep.csv (NVIDIA H100 80GB HBM3, 700.00 W) by
# sweep.fit_constants: the device time of one whole call of each kernel
# beyond its roofline terms, s ...
LAUNCH_S = {
    "pair": 1.675e-05,  # A (one token's lookups, csrc/lut_scan.cu kind 0/1) + build_lut
    "bpair": 1.875e-05,  # B (2-8 tokens, csrc/lut_bpair.cu) + build_lut
    "scan_i8": 3.45e-05,  # H (csrc/lut_scan.cu kind 2) + build_lut and the quantizer
    "scan_i16": 2.85e-05,  # I (kind 3) + build_lut and the quantizer
    "bf16x2": 3.25e-06,  # C (csrc/dequant_mm.cu), the 2x8 instances
    "bf16x2_any": 6.75e-06,  # C's general instances (every other even d_subvec and N)
    "w8a8": 5.5e-06,  # G and its fold (csrc/dequant_mm_i8.cu)
    "w8a8_any": 9.75e-06,  # G's general instances and the fold
    "dense": 6.25e-06,  # cuBLAS bf16 x @ W.T
}
# ... the cost of the busiest SM's gathered and staged words over one SM's
# shared-memory rate, and of all the call's words over the card's ...
LOOKUP_COST = {"pair": 6.60693, "bpair": 5.49541, "scan_i8": 6.30957, "scan_i16": 1.14815,
               "bf16x2": 14.4544, "bf16x2_any": 0.0, "w8a8": 14.4544,
               "w8a8_any": 25.11886}
STAGE_COST = {"pair": 17.37801, "bpair": 7.58578, "scan_i8": 10.47129, "scan_i16": 11.48154,
              "bf16x2": 10.96478, "bf16x2_any": 19.05461, "w8a8": 7.58578,
              "w8a8_any": 0.72444}
CARD_COST = {"pair": 0.0, "bpair": 1.90546, "scan_i8": 1.20226, "scan_i16": 2.63027,
             "bf16x2": 0.45709, "bf16x2_any": 9.12011, "w8a8": 2.63027, "w8a8_any": 8.70964}
# ... the lookups' tables built before their kernel (build_lut, the
# quantizer), a cost a byte over the HBM rate ...
BUILD_COST = {"pair": 0.0, "bpair": 8.70964, "scan_i8": 72.4436, "scan_i16": 36.30781}
# ... and of one tensor-core operation in units of the peak rate
TENSOR_COST = {"bf16x2": 18.19701, "bf16x2_any": 1.0, "w8a8": 13.80384,
               "w8a8_any": 47.86301, "dense": 1.0}

_SCAN_KIND = {"pair": SCAN_PAIR, "scan_i8": 2, "scan_i16": 3}
_SCAN_TOKEN_TILES = (1, 2, 4, 8)  # csrc/lut_scan.cu's token slots


@dataclasses.dataclass(frozen=True)
class KernelCost:
    strategy: str
    hbm_bytes: dict  # per-tensor traffic (codeword/codebook/lut/inp/psum)
    lookups: dict  # kernel -> 4-byte shared-memory words one call gathers
    staged: dict  # kernel -> 4-byte words one call writes into shared memory
    busiest: dict  # kernel -> (gathered, staged) words of the busiest SM
    tables: dict  # kernel -> bytes of the tables built for its launches
    tensor_ops: float  # counted as the reference counts mxu_flops
    tensor_kind: str  # "bf16" | "int8"
    calls: dict  # kernel -> launches of that kernel one call makes

    @property
    def total_hbm(self) -> float:
        return float(sum(self.hbm_bytes.values()))

    @property
    def lookup_words(self) -> float:
        """Shared-memory words one call moves: gathered and staged."""
        return float(sum(self.lookups.values()) + sum(self.staged.values()))

    def _terms(self, chip: ChipSpec) -> dict:
        tensor_cost = max([TENSOR_COST.get(k, 1.0) for k in self.calls] or [1.0])
        smem = sum(g * LOOKUP_COST[k] + st * STAGE_COST[k]
                   for k, (g, st) in self.busiest.items()) / chip.sm_words_s
        smem += sum((self.lookups[k] + self.staged[k]) * CARD_COST[k]
                    for k in self.busiest) / chip.lookup_words_s
        return {
            "hbm": self.total_hbm / chip.hbm_bytes_s,
            "lookup": smem,
            "tensor": tensor_cost * self.tensor_ops / chip.peak_ops[self.tensor_kind],
        }

    def launch_s(self, chip: Optional[ChipSpec] = None) -> float:
        """The calls' launch costs and the building of their tables."""
        chip = chip or default_chip()
        return (sum(n * LAUNCH_S[k] for k, n in self.calls.items())
                + sum(n * BUILD_COST[k] for k, n in self.tables.items()) / chip.hbm_bytes_s)

    def time_s(self, chip: Optional[ChipSpec] = None) -> float:
        chip = chip or default_chip()
        return self.launch_s(chip) + max(self._terms(chip).values())

    def bound(self, chip: Optional[ChipSpec] = None) -> str:
        """The ceiling that sets the time past the launch: "hbm", "lookup"
        or "tensor"."""
        terms = self._terms(chip or default_chip())
        return max(terms, key=terms.get)

    def roofline_frac(self, chip: Optional[ChipSpec] = None) -> float:
        """Fraction of the HBM roofline this strategy reaches (≤ 1)."""
        chip = chip or default_chip()
        return (self.total_hbm / chip.hbm_bytes_s) / self.time_s(chip)


def _base_traffic(cfg: VQConfig, d_out: int, batch: int, itemsize_cb: int = 4):
    """The function's bytes, as the reference counts them."""
    codes = cfg.codes_bytes(d_out)
    inp = batch * cfg.d_in * 4
    psum = batch * d_out * 4
    codebook = cfg.codebook_bytes(itemsize_cb)
    return codes, inp, psum, codebook


def _chunks(batch: int) -> list:
    """Token counts of ``lut_gemv``'s launches: ``MAX_LUT_BATCH`` at a time."""
    return [min(MAX_LUT_BATCH, batch - b0) for b0 in range(0, batch, MAX_LUT_BATCH)]


def _d_out_pad(d_out: int) -> int:
    """``pack_params``' padded width of an unsharded pack."""
    pad = _round_up(d_out, LANE)
    if pad > DEFAULT_BLOCK_J and pad % DEFAULT_BLOCK_J:
        pad = _round_up(pad, DEFAULT_BLOCK_J)
    return pad


def _waves(blocks: int, slots: int) -> int:
    return -(-blocks // max(1, slots))


def _scan_words(kernel: str, cfg: VQConfig, d_out: int, b: int) -> tuple:
    """(gathered, staged, busiest) words of one csrc/lut_scan.cu launch over
    ``b`` tokens' tables, as :func:`plan_scan` splits it: a block's split of
    the groups over its column tiles, a split's tables staged once per tile
    (once per block where they stay staged)."""
    kind, sms = _SCAN_KIND[kernel], default_chip().sms
    bp = next(t for t in _SCAN_TOKEN_TILES if t >= b)
    kp, pad = max(cfg.n_cluster, LANE), _d_out_pad(d_out)
    lanes = scan_layout(kind, bp)[2]  # words a lookup reads, and a staged (group, k) row
    plan = plan_scan(kind, bp, cfg.n_groups, pad, kp, sms)
    tiles, ns = -(-pad // plan.tile_cols), plan.n_splits
    resident = plan.nbuf * plan.stage_groups >= plan.slice_groups
    if ns > 1:
        waves, block_tiles = _waves(tiles, sms * scan_blocks_per_sm(plan, kp) // ns), 1
    else:
        waves, block_tiles = 1, -(-tiles // plan.grid[0])
    stagings = 1 if resident and ns == 1 else block_tiles
    copies = plan.grid[0] * stagings
    busiest = (waves * block_tiles * plan.slice_groups * plan.tile_cols * lanes,
               waves * stagings * plan.slice_groups * kp * lanes)
    return cfg.n_groups * d_out * lanes, copies * cfg.n_groups * kp * lanes, busiest


def _bpair_words(cfg: VQConfig, d_out: int, b: int) -> tuple:
    """(gathered, staged, busiest) words of one csrc/lut_bpair.cu launch:
    each token block's bf16 entries, a split's tables once per column tile,
    the clusters in waves of as many as two blocks an SM hold."""
    kp, pad, sms = max(cfg.n_cluster, LANE), _d_out_pad(d_out), default_chip().sms
    plan = plan_bpair(cfg.n_groups, pad, b, kp, sms)
    tiles, ns, blocks = plan.grid
    words = plan.token_block * 2 // 4  # a (group, k) row of a token block's bf16 entries
    waves = _waves(tiles * blocks, 2 * sms // ns)
    busiest = (waves * plan.slice_groups * plan.tile_cols * words,
               waves * plan.slice_groups * kp * words)
    return (blocks * cfg.n_groups * d_out * words, tiles * blocks * cfg.n_groups * kp * words,
            busiest)


def _lut_cost(strategy, cfg, d_out, batch, kernel, entry_bytes, reduce_ops):
    """A lookup strategy: each launch of ``b`` tokens runs ``kernel(b)``
    over their tables of ``entry_bytes`` entries."""
    codes, inp, psum, codebook = _base_traffic(cfg, d_out, batch)
    kp = max(cfg.n_cluster, LANE)
    lookups, staged, busiest, tables, calls = {}, {}, {}, {}, {}
    for b in _chunks(batch):
        k = kernel(b)
        gathered, stage, (bg, bs) = (_bpair_words(cfg, d_out, b) if k == "bpair"
                                     else _scan_words(k, cfg, d_out, b))
        lookups[k] = lookups.get(k, 0) + gathered
        staged[k] = staged.get(k, 0) + stage
        g0, s0 = busiest.get(k, (0, 0))
        busiest[k] = (g0 + bg, s0 + bs)  # launches run one after another
        calls[k] = calls.get(k, 0) + 1
        tables[k] = tables.get(k, 0) + b * cfg.n_groups * kp * entry_bytes
    lut = batch * cfg.n_groups * kp * entry_bytes
    tensor = 2 * batch * cfg.lut_entries * cfg.d_subvec + reduce_ops * batch * d_out * cfg.n_groups
    return KernelCost(
        strategy,
        {"codeword": codes, "codebook": codebook, "lut": lut, "inp": inp, "psum": psum},
        lookups, staged, busiest, tables, tensor, "bf16", calls,
    )


def cost_lut_gemv(cfg: VQConfig, d_out: int, batch: int) -> KernelCost:
    """The bf16 lookups (``lut_gemv`` variant "auto"): A at one token, B at
    2-8 tokens, ``build_lut``'s f32 tables read by either."""
    return _lut_cost("lut_gemv", cfg, d_out, batch, lambda b: "pair" if b == 1 else "bpair",
                     4, 2)


def cost_lut_gemv_i8(cfg: VQConfig, d_out: int, batch: int) -> KernelCost:
    """int8 tables, exact int32 sums (H, ``variant="i8"``).  Not an ``auto``
    candidate (a precision decision)."""
    return _lut_cost("lut_gemv_i8", cfg, d_out, batch, lambda b: "scan_i8", 1, 2)


def cost_lut_gemv_i16(cfg: VQConfig, d_out: int, batch: int) -> KernelCost:
    """int16 tables (I, ``variant="i16"``)."""
    return _lut_cost("lut_gemv_i16", cfg, d_out, batch, lambda b: "scan_i16", 2, 4)


def _dequant_words(plan, tiles, cfg: VQConfig, d_out: int, entry_bytes: int,
                   staged: bool) -> tuple:
    """(gathered, staged, busiest) words of a dequant-matmul: every row tile
    rebuilds each weight of its split from ``d_subvec`` codebook entries a
    code; a block stages a small shared codebook once (``staged``), and
    otherwise each split's inputs' d-chunks of every codebook row stream
    through the block (per-subvector codebooks, and a shared one too large
    to stage); the blocks in waves of as many as the card holds."""
    cols, row_tiles, splits = plan.grid
    row = cfg.d_subvec * entry_bytes / 4  # words of one codebook entry row
    entries = cfg.n_codebook * cfg.n_cluster * row  # one subvector's codebooks
    split_subvec = min(cfg.d_in, plan.split_steps * plan.step) / cfg.d_subvec
    block_cb = entries if staged else split_subvec * entries
    waves = _waves(cols * row_tiles * splits, default_chip().sms * tiles[plan.config][3])
    busiest = (waves * plan.block_cols * split_subvec * cfg.n_codebook * row,
               waves * block_cb)
    return (row_tiles * d_out * cfg.n_groups * row,
            cols * row_tiles * (splits * entries if staged else cfg.n_subvec * entries),
            busiest)


def cost_dequant_mm(cfg: VQConfig, d_out: int, batch: int) -> KernelCost:
    """C (bf16x2 dequant-matmul), as :func:`plan_bf16x2` tiles it."""
    codes, inp, psum, codebook = _base_traffic(cfg, d_out, batch)
    d, n = cfg.d_subvec, cfg.n_codebook
    plan = plan_bf16x2(batch, cfg.n_subvec, d_out, cfg.shared_codebook, default_chip().sms,
                       d, n)
    general = bf16x2_general(d, n)
    staged = cfg.shared_codebook and (
        not general or n * cfg.n_cluster * d * 2 <= STAGED_CODEBOOK_BYTES)
    gathered, staged, busiest = _dequant_words(plan, _BF16X2_TILES, cfg, d_out, 2, staged)
    k = "bf16x2_any" if general else "bf16x2"
    return KernelCost(
        "dequant_mm",
        {"codeword": codes, "codebook": codebook, "lut": 0.0, "inp": inp, "psum": psum},
        {k: gathered}, {k: staged}, {k: busiest}, {},
        2 * batch * cfg.d_in * d_out, "bf16", {k: 1},
    )


def cost_dequant_i8(cfg: VQConfig, d_out: int, batch: int) -> KernelCost:
    """G (W8A8) and its fold, as :func:`plan_i8` tiles it: int8 entries,
    the contraction duplicated over the codebooks as the reference counts
    it.  Sweep row only (a precision decision, as ``lut_gemv_i8``)."""
    codes, inp, psum, codebook = _base_traffic(cfg, d_out, batch)
    d, n = cfg.d_subvec, cfg.n_codebook
    plan = plan_i8(batch, cfg.n_subvec, d_out, cfg.shared_codebook, default_chip().sms, d, n)
    general = i8_general(d, n)
    staged = cfg.shared_codebook and (
        not general or n * cfg.n_cluster * d <= STAGED_CODEBOOK_BYTES)
    gathered, staged, busiest = _dequant_words(plan, _I8_TILES, cfg, d_out, 1, staged)
    k = "w8a8_any" if general else "w8a8"
    return KernelCost(
        "dequant_mm_i8",
        {"codeword": codes, "codebook": codebook, "lut": 0.0, "inp": inp, "psum": psum},
        {k: gathered}, {k: staged}, {k: busiest}, {},
        2 * batch * cfg.d_in * d_out * cfg.n_codebook, "int8", {k: 1},
    )


def cost_dense_bf16(cfg: VQConfig, d_out: int, batch: int) -> KernelCost:
    """Baseline: dense bf16 weights, one library matmul."""
    inp = batch * cfg.d_in * 4
    psum = batch * d_out * 4
    w = cfg.d_in * d_out * 2
    return KernelCost(
        "dense_bf16",
        {"codeword": 0.0, "codebook": w, "lut": 0.0, "inp": inp, "psum": psum},
        {}, {}, {}, {}, 2 * batch * cfg.d_in * d_out, "bf16", {"dense": 1},
    )


STRATEGIES = {
    "lut_gemv": cost_lut_gemv,
    "dequant_mm": cost_dequant_mm,
    "dense_bf16": cost_dense_bf16,
}

# the sweep's rows; the i8/i16 ones change precision, so pick_strategy
# leaves them out
SWEEP_STRATEGIES = {
    **STRATEGIES,
    "lut_gemv_i8": cost_lut_gemv_i8,
    "lut_gemv_i16": cost_lut_gemv_i16,
    "dequant_mm_i8": cost_dequant_i8,
}


def estimate(
    cfg: VQConfig, d_out: int, batch: int, strategy: str, chip: Optional[ChipSpec] = None
) -> KernelCost:
    return STRATEGIES[strategy](cfg, d_out, batch)


@functools.lru_cache(maxsize=4096)
def pick_strategy(
    cfg: VQConfig,
    d_out: int,
    batch: int,
    chip: Optional[ChipSpec] = None,
    quantized_only: bool = True,
) -> str:
    """The strategy of least predicted time for ``batch`` rows of a ``cfg``
    layer with ``d_out`` outputs (the reference's rule, ``traffic.py:388``):
    the argmin of :meth:`KernelCost.time_s` over ``STRATEGIES`` (without
    ``dense_bf16`` when ``quantized_only``: the port's kernels take every
    layer the reference's do), and ``dense_bf16`` for
    codebooks of more than 256 entries (the 1x16 load-time dequant).
    Cached: every ``QuantizedLinear.apply(strategy="auto")`` asks, and the
    model costs tens of microseconds of host time (the reference decides
    once, while tracing)."""
    chip = chip or default_chip()
    names = [s for s in STRATEGIES if not quantized_only or s != "dense_bf16"]
    if cfg.n_cluster > 256:
        return "dense_bf16"
    return min(names, key=lambda s: STRATEGIES[s](cfg, d_out, batch).time_s(chip))
