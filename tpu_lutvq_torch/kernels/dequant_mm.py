"""Fused dequant-matmul (counterpart of ``tpu_lutvq.kernels.dequant_mm``):
``Y = X · Wᵀ · diag(s)`` with W rebuilt from codes and a codebook, never
written to device memory, at three table precisions (``tables=``), each a
hand-written CUDA kernel with its plain PyTorch version beside it:

- ``bf16x2`` (serving, ``quality="exact"``): x and every codebook entry
  rounded to bf16, each codebook's entry contracted against x on its own,
  everything summed in f32 — the sum of the N codebook entries is never
  rounded to bf16 (``dequant_mm.py:264-277, 726-734``).  Wrapper
  :func:`dequant_mm_bf16x2` (``csrc/dequant_mm.cu``, counter
  ``DEQUANT_MM_LAUNCHES``), plain :func:`dequant_mm_plain`.
- ``i8`` (W8A8, ``quality="fast"``): codebook words quantized to int8 per
  (word, group), those row scales folded into x, x quantized per token,
  an exact integer sum, then the token's and the output's scales
  (``dequant_mm.py:94-134, 602-719``).  Wrapper :func:`dequant_mm_i8`
  (``csrc/dequant_mm_i8.cu``, ``DEQUANT_MM_I8_LAUNCHES``), plain
  :func:`dequant_mm_i8_plain`; :func:`quantize_tables_i8` (kept per
  codebook by :func:`tables_i8`) and :func:`fold_activations_i8` (the
  same source's fold kernel, :func:`fold_i8`, ``FOLD_I8_LAUNCHES``)
  prepare their inputs.
- ``f32`` (the oracle; every odd ``d_subvec``): x and the codebook in f32,
  the N entries summed in f32, an f32 contraction (``dequant_mm.py:830-924``).
  Wrapper :func:`dequant_mm_f32` (``csrc/dequant_mm_f32.cu``,
  ``DEQUANT_MM_F32_LAUNCHES``), plain :func:`dequant_mm_f32_plain`.

A wrapper launches its kernel for a CUDA tensor (and counts the launch) or
raises; a CPU tensor takes the plain version.  :func:`dequant_matmul`
picks the tables and adds the zero points.  The three kernels pick their
tile by rows and split d_in across blocks when the output tiles cannot
fill the card; :func:`plan_bf16x2`, :func:`plan_i8` and :func:`plan_f32`
work the split out in Python, and the kernels sum the splits in split
order (the W8A8 one inside a thread-block cluster, in one launch).
"""

from __future__ import annotations

import dataclasses
import functools
import weakref

import torch
import torch.nn.functional as F

from tpu_lutvq_torch.core.config import VQConfig
from tpu_lutvq_torch.core.params import broadcast_codebook, div_scalar
from tpu_lutvq_torch.kernels import _build
from tpu_lutvq_torch.kernels.lut_gemv import (
    PackedVQ,
    _apply_zero_points,
    _round_up,
    local_view,
)

# kernel launches since the last reset (see module doc)
DEQUANT_MM_LAUNCHES = 0  # bf16x2 tables
DEQUANT_MM_I8_LAUNCHES = 0
DEQUANT_MM_F32_LAUNCHES = 0
FOLD_I8_LAUNCHES = 0  # the W8A8 activation fold (XLA in the JAX package)

TABLES = ("bf16x2", "i8", "f32")
_KERNEL_D_SUBVEC = 8  # csrc/dequant_mm.cu rebuilds 16-byte (8 × bf16) rows
_I8_KERNEL_D_SUBVEC = (4, 8, 16)  # csrc/dequant_mm_i8.cu reads 4-, 8- or 16-byte rows
# csrc/dequant_mm_i8.cu's tiles, chosen by rows, as the bf16x2 ones: (most
# rows, output columns a block, rows a block, blocks an SM holds)
_I8_TILES = ((8, 128, 8, 4), (16, 128, 16, 4), (None, 256, 64, 2))
# inputs a k-step: a shared codebook is staged once, per-subvector ones ride
# the ring 32 inputs a stage; x_i8 rows are padded to whole 128-input steps
_I8_STEP_INPUTS = {True: 128, False: 32}
I8_PAD_INPUTS = 128
# the splits of an output tile form one thread-block cluster (portable size)
_I8_MAX_SPLITS = 8
_KERNEL_MAX_CODEBOOKS = 2
# csrc/dequant_mm.cu's tiles, chosen by rows: (most rows, output columns a
# block, rows a block, blocks an SM holds); above 16 rows x goes in as bf16
_BF16X2_TILES = ((8, 128, 8, 4), (16, 128, 16, 4), (None, 256, 64, 2))
# subvectors a k-step: a shared codebook is staged once, per-subvector ones
# ride the ring two subvectors a stage
_BF16X2_STEP = {True: 8, False: 2}
# csrc/dequant_mm_f32.cu's tiles: 32 or 128 rows by 128 columns, 16 inputs a
# step; its fast path takes d_subvec 4, 8, 16 with ≤ 2 codebooks
_F32_TILES = ((32, 128, 32, 2), (None, 128, 128, 2))
_F32_STEP = 16
_F32_FAST_D_SUBVEC = (4, 8, 16)
# d_in is split across blocks when the output tiles leave SM slots empty,
# each split at least this many k-steps long
_MIN_SPLIT_STEPS = 4
_CB_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def dequant_weight(cfg: VQConfig, packed: PackedVQ, round_bf16: bool = True) -> torch.Tensor:
    """The plain versions' weight, ``W = Σ_n float(bf16(cb_n))`` summed in
    f32 in codebook order (``round_bf16=False``: ``Σ_n cb_n`` in f32),
    without scales: ``(d_out, d_in)`` float32."""
    m, n, d_out = cfg.n_subvec, cfg.n_codebook, packed.d_out
    cb = broadcast_codebook(cfg, packed.codebook)
    cb = cb.to(torch.bfloat16).float() if round_bf16 else cb.float()
    codes = packed.codes_t[: cfg.n_groups, :d_out].long().reshape(n, m, d_out)
    m_idx = torch.arange(m, device=codes.device)[:, None]
    w = cb[m_idx, 0, codes[0]]  # (M, d_out, d)
    for nn in range(1, n):
        w = w + cb[m_idx, nn, codes[nn]]
    return w.permute(1, 0, 2).reshape(d_out, cfg.d_in)


def _scaled(y: torch.Tensor, packed: PackedVQ) -> torch.Tensor:
    return y if packed.scales is None else y * packed.scales[:, : packed.d_out]


def _check_codes(cfg: VQConfig, packed: PackedVQ) -> tuple[int, int]:
    g_pad, d_out_pad = packed.codes_t.shape
    if g_pad < cfg.n_groups or d_out_pad < packed.d_out or d_out_pad % 16:
        raise ValueError(f"codes_t {tuple(packed.codes_t.shape)} does not cover {cfg}")
    return g_pad, d_out_pad


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How a dequant kernel cuts its work: the tile ``config`` (an index
    into the kernel's tiles), the block's rows and columns, d_in as
    ``steps`` k-steps of ``step`` units (subvectors or inputs), and the
    ``n_splits`` blocks along d_in, each ``split_steps`` k-steps long (the
    last one shorter)."""

    config: int
    block_rows: int
    block_cols: int
    step: int
    steps: int
    split_steps: int
    n_splits: int
    rows: int
    d_out: int

    @property
    def grid(self) -> tuple[int, int, int]:
        return (-(-self.d_out // self.block_cols), -(-self.rows // self.block_rows),
                self.n_splits)

    def split_ranges(self) -> list[tuple[int, int]]:
        """Each split's k-steps, ``[first, end)``, in the order the reduce sums them."""
        return [(s * self.split_steps, min(self.steps, (s + 1) * self.split_steps))
                for s in range(self.n_splits)]


def _plan(tiles, rows, d_out, step, steps, sms, max_splits=None) -> SplitPlan:
    config = next(i for i, t in enumerate(tiles) if t[0] is None or rows <= t[0])
    _, cols, brows, per_sm = tiles[config]
    n_tiles = -(-d_out // cols) * -(-rows // brows)
    slots = per_sm * sms
    n_splits = 1
    if n_tiles < slots:
        # waves of blocks times a block's share of d_in, over at most two
        # waves' worth of splits (each split writes and reads its partials):
        # the fewest splits within 5 % of the least
        most = min(max(1, steps // _MIN_SPLIT_STEPS), 2 * -(-slots // n_tiles),
                   max_splits or steps)
        cost = {n: -(-n_tiles * n // slots) / n for n in range(1, most + 1)}
        n_splits = min(n for n, c in cost.items() if c <= 1.05 * min(cost.values()))
    split_steps = -(-steps // n_splits)
    return SplitPlan(config, brows, cols, step, steps, split_steps, -(-steps // split_steps),
                     rows, d_out)


@functools.lru_cache(maxsize=None)
def plan_bf16x2(rows: int, n_subvec: int, d_out: int, shared: bool, sms: int) -> SplitPlan:
    """``csrc/dequant_mm.cu``'s plan for ``rows`` × ``n_subvec`` subvectors →
    ``d_out`` on ``sms`` SMs; its k-steps count subvectors."""
    step = _BF16X2_STEP[shared]
    return _plan(_BF16X2_TILES, rows, d_out, step, -(-n_subvec // step), sms)


@functools.lru_cache(maxsize=None)
def plan_f32(rows: int, d_in: int, d_out: int, sms: int) -> SplitPlan:
    """``csrc/dequant_mm_f32.cu``'s plan; its k-steps count inputs."""
    return _plan(_F32_TILES, rows, d_out, _F32_STEP, -(-d_in // _F32_STEP), sms)


@functools.lru_cache(maxsize=None)
def plan_i8(rows: int, n_subvec: int, d_out: int, shared: bool, sms: int,
            d_subvec: int) -> SplitPlan:
    """``csrc/dequant_mm_i8.cu``'s plan; its k-steps count subvectors (128
    inputs a step with a shared codebook, 32 with per-subvector ones), and
    at most ``_I8_MAX_SPLITS`` splits, one thread-block cluster a tile."""
    step = _I8_STEP_INPUTS[shared] // d_subvec
    return _plan(_I8_TILES, rows, d_out, step, -(-n_subvec // step), sms, _I8_MAX_SPLITS)


def i8_padded_subvec(cfg: VQConfig) -> int:
    """Subvectors a W8A8 kernel's x_i8 row holds: ``n_subvec`` rounded up to
    whole ``I8_PAD_INPUTS``-input steps, the rest zeros."""
    return _round_up(cfg.n_subvec, I8_PAD_INPUTS // cfg.d_subvec)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---- bf16x2 tables -------------------------------------------------------------


def dequant_mm_plain(cfg: VQConfig, packed: PackedVQ, x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``float(bf16(x)) @ Wᵀ`` in f32 with :func:`dequant_weight`,
    times the scales.  ``(B, d_in) → (B, d_out)``."""
    return _scaled(x.to(torch.bfloat16).float() @ dequant_weight(cfg, packed).T, packed)


def dequant_mm_bf16x2(cfg: VQConfig, packed: PackedVQ, x: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: plain version for a CPU tensor, the CUDA kernel
    for a CUDA tensor."""
    if x.device.type == "cpu":
        return dequant_mm_plain(cfg, packed, x)
    return _launch(cfg, packed, x)


def _launch(cfg: VQConfig, packed: PackedVQ, x: torch.Tensor) -> torch.Tensor:
    global DEQUANT_MM_LAUNCHES
    if cfg.d_subvec != _KERNEL_D_SUBVEC or cfg.n_codebook > _KERNEL_MAX_CODEBOOKS:
        raise ValueError(
            f"dequant_mm kernel takes d_subvec={_KERNEL_D_SUBVEC} and ≤ "
            f"{_KERNEL_MAX_CODEBOOKS} codebooks; got {cfg}"
        )
    _, d_out_pad = _check_codes(cfg, packed)
    r = x.shape[0]
    out = torch.empty((r, packed.d_out), dtype=torch.float32, device=x.device)
    if r == 0:
        return out
    # up to 16 rows the kernel reads x in f32 and rounds it; wider tiles read bf16
    xk = x.to(torch.float32 if r <= _BF16X2_TILES[1][0] else torch.bfloat16).contiguous()
    _build.require_cuda_tensor(xk, "x", xk.dtype)
    shared = packed.codebook.shape[0] == 1
    cb = packed.codebook
    if not shared:
        cb = cb.to(torch.bfloat16)  # streamed through the kernel's ring as bf16
    elif cb.dtype not in _CB_DTYPES:
        cb = cb.float()  # the kernel rounds a shared one to bf16 as it stages it
    cb = cb.contiguous()  # (M_cb, N, K, d)
    _build.require_cuda_tensor(cb, "codebook", cb.dtype)
    _build.require_cuda_tensor(packed.codes_t, "codes_t", torch.uint8)
    if packed.scales is not None:
        _build.require_cuda_tensor(packed.scales, "scales", torch.float32)
    plan = plan_bf16x2(r, cfg.n_subvec, packed.d_out, shared, _sms(x.device))
    part = None
    if plan.n_splits > 1:
        part = torch.empty((plan.n_splits, r, d_out_pad), dtype=torch.float32, device=x.device)
    lib = _build.library()
    err = lib.lutvq_dequant_mm(
        xk.data_ptr(), packed.codes_t.data_ptr(), cb.data_ptr(),
        None if packed.scales is None else packed.scales.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        r, cfg.n_subvec, cfg.n_codebook, cfg.n_cluster, int(shared), _CB_DTYPES[cb.dtype],
        plan.config, packed.d_out, d_out_pad, plan.split_steps * plan.step, plan.n_splits,
        _build.stream_ptr(x),
    )
    _build.check(lib, err, "dequant_mm")
    DEQUANT_MM_LAUNCHES += 1
    return out


# ---- i8 tables (W8A8) ------------------------------------------------------------


def quantize_tables_i8(cfg: VQConfig, codebook: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The codebook words quantized to int8 per (word w, group g) over K, as
    ``build_gather_tables_i8`` does (``dequant_mm.py:113-118``):
    ``s = max(max|t|/127, 1e-12)``, ``q = clip(round(t/s), -127, 127)``.

    Works on the compact ``(M_cb, N, K, d)`` codebook: every group of one
    codebook n of a shared ``(1, N, K, d)`` codebook holds the same rows, so
    quantizing it once equals quantizing each group.  Returns ``q (M_cb, N,
    K, d)`` int8 and ``s (M_cb, N, d)`` float32; group ``g = n·M + m`` reads
    ``s[m or 0, n, w]``."""
    t = codebook.float()
    s = torch.clamp_min(div_scalar(t.abs().amax(dim=2), 127.0), 1e-12)
    q = torch.clamp(torch.round(t / s[:, :, None, :]), -127, 127).to(torch.int8)
    return q, s


def fold_activations_i8(
    cfg: VQConfig, x: torch.Tensor, s: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The W8A8 activation fold (``dequant_mm.py:644-656``): x duplicated per
    codebook, each copy scaled by its table rows' scales,
    ``x4[b, n, m, w] = x[b, m·d + w] · s[m, n, w]``; then per token
    ``xs = max(max|x4|/127, 1e-12)`` and ``x_i8 = clip(round(x4/xs), -127,
    127)`` (``torch.round`` rounds half to even, as ``jnp.round``).  The
    columns are JAX's ``(q, nn, mm, j)`` ones in ``(n, m, w)`` order.
    Returns ``x_i8 (B, N, M, d)`` int8 and ``xs (B,)`` float32."""
    b = x.shape[0]
    x4 = x.float().reshape(b, 1, cfg.n_subvec, cfg.d_subvec) * s.permute(1, 0, 2)[None]
    xs = torch.clamp_min(div_scalar(x4.abs().amax(dim=(1, 2, 3)), 127.0), 1e-12)
    x_i8 = torch.clamp(torch.round(x4 / xs[:, None, None, None]), -127, 127)
    return x_i8.to(torch.int8), xs


def weight_i8(cfg: VQConfig, packed: PackedVQ, q: torch.Tensor) -> torch.Tensor:
    """The int8 weight the W8A8 kernel rebuilds on chip: ``(d_out, N, M, d)``,
    ``w[j, n, m] = q[m, n, code(n·M + m, j)]``."""
    m, n, d_out = cfg.n_subvec, cfg.n_codebook, packed.d_out
    codes = packed.codes_t[: cfg.n_groups, :d_out].long().reshape(n, m, d_out)
    n_idx = torch.arange(n, device=codes.device)[:, None, None]
    m_idx = torch.arange(m, device=codes.device)[None, :, None]
    qb = q.expand((m,) + tuple(q.shape[1:])) if q.shape[0] == 1 else q
    return qb[m_idx, n_idx, codes].permute(2, 0, 1, 3)  # (N, M, d_out, d) → (d_out, N, M, d)


def dequant_mm_i8_plain(
    cfg: VQConfig, packed: PackedVQ, x_i8: torch.Tensor, xs: torch.Tensor, q: torch.Tensor
) -> torch.Tensor:
    """Plain version of the W8A8 kernel: ``float(Σ x_i8 · w_i8) · xs[b] · s[j]``.
    Every product and partial sum is an integer below 2^53, so the f64
    matmul (the card has no integer one) is exact in any order: the int32
    sum of the JAX kernel and of ours, cast once.  ``x_i8`` is ``(B, N, M,
    d)`` or, as :func:`fold_i8` writes it, padded with zero subvectors."""
    w = weight_i8(cfg, packed, q).reshape(packed.d_out, -1)
    x = x_i8[:, :, : cfg.n_subvec].reshape(x_i8.shape[0], -1)
    acc = x.double() @ w.double().T
    return _scaled(acc.float() * xs[:, None], packed)


def dequant_mm_i8(
    cfg: VQConfig, packed: PackedVQ, x_i8: torch.Tensor, xs: torch.Tensor, q: torch.Tensor
) -> torch.Tensor:
    """The W8A8 kernel's wrapper: plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor.  ``q`` from :func:`quantize_tables_i8` (or
    :func:`tables_i8`); ``x_i8, xs`` from :func:`fold_i8` (the plain version
    also takes :func:`fold_activations_i8`'s unpadded ``x_i8``)."""
    if x_i8.device.type == "cpu":
        return dequant_mm_i8_plain(cfg, packed, x_i8, xs, q)
    return _launch_i8(cfg, packed, x_i8, xs, q)


def _launch_i8(cfg, packed, x_i8, xs, q):
    global DEQUANT_MM_I8_LAUNCHES
    d, m = cfg.d_subvec, cfg.n_subvec
    if d not in _I8_KERNEL_D_SUBVEC or cfg.n_codebook > _KERNEL_MAX_CODEBOOKS:
        raise ValueError(
            f"dequant_mm_i8 kernel takes d_subvec in {_I8_KERNEL_D_SUBVEC} and ≤ "
            f"{_KERNEL_MAX_CODEBOOKS} codebooks; got {cfg}"
        )
    _, d_out_pad = _check_codes(cfg, packed)
    r = x_i8.shape[0]
    out = torch.empty((r, packed.d_out), dtype=torch.float32, device=x_i8.device)
    if r == 0:
        return out
    mp = i8_padded_subvec(cfg)
    if tuple(x_i8.shape[1:]) != (cfg.n_codebook, mp, d):
        raise ValueError(f"dequant_mm_i8 kernel takes x_i8 as fold_i8 writes it, "
                         f"(B, {cfg.n_codebook}, {mp}, {d}); got {tuple(x_i8.shape)}")
    _build.require_cuda_tensor(x_i8, "x_i8", torch.int8)
    _build.require_cuda_tensor(xs, "xs", torch.float32)
    _build.require_cuda_tensor(q, "q", torch.int8)
    _build.require_cuda_tensor(packed.codes_t, "codes_t", torch.uint8)
    if packed.scales is not None:
        _build.require_cuda_tensor(packed.scales, "scales", torch.float32)
    shared = q.shape[0] == 1
    plan = plan_i8(r, m, packed.d_out, shared, _sms(x_i8.device), d)
    lib = _build.library()
    err = lib.lutvq_dequant_mm_i8(
        x_i8.data_ptr(), xs.data_ptr(), packed.codes_t.data_ptr(), q.data_ptr(),
        None if packed.scales is None else packed.scales.data_ptr(), out.data_ptr(),
        r, m, mp, cfg.n_codebook, cfg.n_cluster, d, int(shared), plan.config,
        packed.d_out, d_out_pad, plan.split_steps * plan.step, plan.n_splits,
        _build.stream_ptr(x_i8),
    )
    _build.check(lib, err, "dequant_mm_i8")
    DEQUANT_MM_I8_LAUNCHES += 1
    return out


def fold_i8(cfg: VQConfig, x: torch.Tensor, s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fold kernel's wrapper (``csrc/dequant_mm_i8.cu::fold_i8``, counter
    ``FOLD_I8_LAUNCHES``): :func:`fold_activations_i8`'s values, ``x_i8``
    written ``(B, N, Mp, d)`` with zero subvectors up to
    :func:`i8_padded_subvec` (what the W8A8 kernel reads, so it needs no
    pad pass), and ``xs``.  One launch for a CUDA tensor; the plain version
    padded for a CPU tensor."""
    if x.device.type == "cpu":
        x_i8, xs = fold_activations_i8(cfg, x, s)
        return F.pad(x_i8, (0, 0, 0, i8_padded_subvec(cfg) - cfg.n_subvec)), xs
    return _launch_fold_i8(cfg, x, s)


def _launch_fold_i8(cfg, x, s):
    global FOLD_I8_LAUNCHES
    mp = i8_padded_subvec(cfg)
    if cfg.d_subvec % 4:
        raise ValueError(f"fold_i8 kernel takes d_subvec % 4 == 0; got {cfg}")
    b = x.shape[0]
    xf = x.float().contiguous()
    s = s.contiguous()
    _build.require_cuda_tensor(xf, "x", torch.float32)
    _build.require_cuda_tensor(s, "s", torch.float32)
    x_i8 = torch.empty((b, cfg.n_codebook, mp, cfg.d_subvec), dtype=torch.int8, device=x.device)
    xs = torch.empty((b,), dtype=torch.float32, device=x.device)
    lib = _build.library()
    err = lib.lutvq_fold_i8(xf.data_ptr(), s.data_ptr(), x_i8.data_ptr(), xs.data_ptr(), b,
                            cfg.n_subvec, mp, cfg.n_codebook, cfg.d_subvec, int(s.shape[0] == 1),
                            _build.stream_ptr(x))
    _build.check(lib, err, "fold_i8")
    FOLD_I8_LAUNCHES += 1
    return x_i8, xs


# (id of a codebook tensor) → (weak reference, its _version, q, s)
_TABLES_I8: dict = {}


def tables_i8(cfg: VQConfig, codebook: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_tables_i8` once per codebook tensor: the result is
    kept, weakly keyed on the tensor, until the tensor is edited in place
    (its ``_version`` moves) or freed.  ``local_view`` keeps the pack's
    codebook object, so every shard view of a layer shares one entry.  The
    cache holds ``q`` and ``s``: N·K·d bytes (4 KiB at 2x8) a projection
    with a shared codebook, M·N·K·d (2 MiB at 7B width) with per-subvector
    ones.  The values are those of a fresh call (the JAX package quantizes
    per call)."""
    key = id(codebook)
    hit = _TABLES_I8.get(key)
    if hit is not None and hit[0]() is codebook and hit[1] == codebook._version:
        return hit[2], hit[3]
    q, s = quantize_tables_i8(cfg, codebook)
    ref = weakref.ref(codebook, lambda _, key=key: _TABLES_I8.pop(key, None))
    _TABLES_I8[key] = (ref, codebook._version, q, s)
    return q, s


# ---- f32 tables (the oracle) ---------------------------------------------------


def dequant_mm_f32_plain(cfg: VQConfig, packed: PackedVQ, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the f32-table kernel: ``x @ Wᵀ`` in f32 with the
    unrounded :func:`dequant_weight`, times the scales (a matmul on the card
    must run with TF32 off to stay the oracle)."""
    return _scaled(x.float() @ dequant_weight(cfg, packed, round_bf16=False).T, packed)


def dequant_mm_f32(cfg: VQConfig, packed: PackedVQ, x: torch.Tensor) -> torch.Tensor:
    """The f32-table kernel's wrapper: plain version for a CPU tensor, the
    CUDA kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return dequant_mm_f32_plain(cfg, packed, x)
    return _launch_f32(cfg, packed, x)


def _launch_f32(cfg, packed, x):
    global DEQUANT_MM_F32_LAUNCHES
    _, d_out_pad = _check_codes(cfg, packed)
    r = x.shape[0]
    out = torch.empty((r, packed.d_out), dtype=torch.float32, device=x.device)
    if r == 0:
        return out
    xf = x.float().contiguous()
    cb = packed.codebook.float().contiguous()  # (M_cb, N, K, d)
    _build.require_cuda_tensor(xf, "x", torch.float32)
    _build.require_cuda_tensor(cb, "codebook", torch.float32)
    _build.require_cuda_tensor(packed.codes_t, "codes_t", torch.uint8)
    if packed.scales is not None:
        _build.require_cuda_tensor(packed.scales, "scales", torch.float32)
    plan = plan_f32(r, cfg.d_in, packed.d_out, _sms(x.device))
    fast = cfg.d_subvec in _F32_FAST_D_SUBVEC and cfg.n_codebook <= _KERNEL_MAX_CODEBOOKS
    part = None
    if plan.n_splits > 1:
        part = torch.empty((plan.n_splits, r, d_out_pad), dtype=torch.float32, device=x.device)
    lib = _build.library()
    err = lib.lutvq_dequant_mm_f32(
        xf.data_ptr(), packed.codes_t.data_ptr(), cb.data_ptr(),
        None if packed.scales is None else packed.scales.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        r, cfg.n_subvec, cfg.n_codebook, cfg.n_cluster, cfg.d_subvec, int(cb.shape[0] == 1),
        int(fast), 2 if plan.config == 0 else 8, packed.d_out, d_out_pad,
        plan.split_steps * plan.step, plan.n_splits, _build.stream_ptr(x),
    )
    _build.check(lib, err, "dequant_mm_f32")
    DEQUANT_MM_F32_LAUNCHES += 1
    return out


def dequant_matmul(
    cfg: VQConfig,
    packed: PackedVQ,
    x: torch.Tensor,
    *,
    tables: str = "bf16x2",
    plain: bool = False,
) -> torch.Tensor:
    """Batched fused dequant-matmul: ``(B, d_in) → (B, d_out)`` float32.

    ``tables`` is ``"bf16x2"`` (serving), ``"i8"`` (W8A8) or ``"f32"``
    (oracle); odd ``d_subvec``, and ``"i8"`` with ``d_subvec % 4``, take the
    f32 tables, as in the JAX package (``dequant_mm.py:575-576``).  The
    tables derive from the packed codebook (the W8A8 ones quantized once
    per codebook tensor, :func:`tables_i8`).  ``plain=True``
    runs the plain versions on any device, for comparison with the kernels."""
    if tables not in TABLES:
        raise ValueError(f"unknown dequant_matmul tables {tables!r} ({'|'.join(TABLES)})")
    if cfg.n_cluster > 256:
        raise ValueError("dequant_matmul supports K ≤ 256")
    if packed.nibbles:
        raise ValueError(
            "dequant_matmul cannot read nibble-packed codes (T-MAC packing is a "
            "lookup-kernel layout); pack with nibble_pack=False for this path"
        )
    if packed.out_group > 1:
        raise ValueError("dequant_matmul cannot read out_group > 1 packs; use lut_gemv")
    packed = local_view(packed)
    if cfg.d_subvec % 2 or (tables == "i8" and cfg.d_subvec % 4):
        tables = "f32"
    if tables == "i8":
        q, s = tables_i8(cfg, packed.codebook)
        if plain:
            y = dequant_mm_i8_plain(cfg, packed, *fold_activations_i8(cfg, x, s), q)
        else:  # two launches on the card: the fold and the W8A8 kernel
            y = dequant_mm_i8(cfg, packed, *fold_i8(cfg, x, s), q)
    elif tables == "f32":
        y = (dequant_mm_f32_plain if plain else dequant_mm_f32)(cfg, packed, x)
    else:
        y = dequant_mm_plain(cfg, packed, x) if plain else dequant_mm_bf16x2(cfg, packed, x)
    return _apply_zero_points(y, packed, x)
