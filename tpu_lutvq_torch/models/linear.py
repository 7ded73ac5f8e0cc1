"""Quantized linear layers (counterpart of ``tpu_lutvq.models.linear``).

``QuantizedLinear.apply`` dispatches between the LUT-GEMV kernel and the
dequant-matmul kernel; ``strategy="auto"`` takes the one of least predicted
device time on the H100 (``dataflow.traffic.pick_strategy``, fitted to the
card's measured sweep), and nibble and out_group packs stay on the LUT-GEMV
kernel.  ``DenseLinear`` and ``ChunkedVQLinear`` (the two 1x16 tiers a
checkpoint loads into) take the same ``apply`` call, so any of the three
fills a projection slot.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpu_lutvq_torch.core.config import VQConfig
from tpu_lutvq_torch.core.params import VQParams, init_vq_params
from tpu_lutvq_torch.dataflow.traffic import pick_strategy
from tpu_lutvq_torch.kernels.dequant_mm import dequant_matmul
from tpu_lutvq_torch.kernels.lut_gemv import PackedVQ, local_view, lut_gemv, pack_params


class DenseLinear(NamedTuple):
    """Unquantized layer (lm_head, or a 1x16 projection dequantized at load)."""

    w: torch.Tensor  # (d_out, d_in)

    @property
    def d_in(self) -> int:
        return self.w.shape[1]

    @property
    def d_out(self) -> int:
        return self.w.shape[0]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.w.dtype) @ self.w.T

    def apply(self, cfg, x: torch.Tensor, **_kw) -> torch.Tensor:
        """``QuantizedLinear.apply``'s call (cfg, strategy, variant, quality
        and plain ignored): ``x @ w.T`` as float32."""
        return self(x).float()


class ChunkedVQLinear(NamedTuple):
    """A 1x16 AQLM layer served at its checkpoint footprint: the raw codes
    and the bf16 codebooks stay on the card, and each call rebuilds the
    weight ``chunk`` code rows at a time (a gather and a sum over the
    codebooks, in bf16) and multiplies it in bf16.  The JAX package computes
    this tier outside Pallas (an XLA gather and a matmul), and so does the
    port: ``torch.matmul`` and indexing, no kernel of its own.  The same
    weights as ``one_x16="dequant"`` at an eighth of the memory, far slower."""

    codes: torch.Tensor  # (r_out, n_groups, n_codebook) uint16 (or int32) raw codes
    codebooks: torch.Tensor  # (out_g, n_codebook, K, d_subvec) bf16
    scales: Optional[torch.Tensor]  # (d_out,) f32 per output row

    @property
    def out_g(self) -> int:
        return self.codebooks.shape[0]

    @property
    def d_in(self) -> int:
        return self.codes.shape[1] * self.codebooks.shape[-1]

    @property
    def d_out(self) -> int:
        return self.codes.shape[0] * self.out_g

    def apply(self, cfg, x: torch.Tensor, *, chunk: int = 512, **_kw) -> torch.Tensor:
        """``(..., d_in) → (..., d_out)`` f32 (``linear.py:98-127``); out row
        j is code row j // out_g, block row j % out_g."""
        lead = x.shape[:-1]
        xb = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
        r_out, g, ncb = self.codes.shape
        ys = []
        for c0 in range(0, r_out, chunk):
            c = self.codes[c0 : c0 + chunk].int()  # (rows, g, ncb)
            w = self.codebooks[:, 0][:, c[..., 0]]  # (out_g, rows, g, d)
            for nn in range(1, ncb):
                w = w + self.codebooks[:, nn][:, c[..., nn]]
            ys.append(xb @ w.transpose(0, 1).reshape(-1, self.d_in).T)
        y = torch.cat(ys, dim=1).float()
        if self.scales is not None:
            y = y * self.scales[None, :]
        return y.reshape(*lead, self.d_out)


class QuantizedLinear(NamedTuple):
    """LUT-VQ quantized linear layer; ``cfg`` travels alongside."""

    packed: PackedVQ

    def apply(
        self,
        cfg: VQConfig,
        x: torch.Tensor,
        *,
        strategy: str = "auto",
        variant: str = "auto",
        quality: str = "exact",
        plain: bool = False,
    ) -> torch.Tensor:
        """x: ``(..., d_in)`` → ``(..., d_out)`` float32.

        ``variant`` picks the compute flavour on both kernel strategies, as
        the JAX layer routes it (``linear.py:171-193``; nibble and out_group
        packs take ``lut_gemv`` under "auto", and an out_group pack refuses
        any other strategy): under ``lut_gemv``
        the lookup ("auto" → the bf16 pair tables; "pairf" → ``pair`` packed
        in the kernel; "f32" → exact f32 tables; "i8"/"i16" → per-token
        int8/int16 tables with integer sums); under ``dequant_mm`` the table
        precision, "f32" (oracle) or "i8" (W8A8), any other variant leaving
        it to ``quality``: "exact" → the bf16x2 tables, "fast" → the W8A8
        tables.  ``plain=True`` runs the kernels' plain versions on any
        device (reference runs only)."""
        lead = x.shape[:-1]
        xb = x.reshape(-1, x.shape[-1])
        if strategy == "auto":
            strategy = pick_strategy(cfg, self.packed.d_out, xb.shape[0])
            if self.packed.nibbles or self.packed.out_group > 1:
                strategy = "lut_gemv"  # the only kernels that read these layouts
        elif strategy != "lut_gemv" and self.packed.out_group > 1:
            raise ValueError(
                f"strategy {strategy!r} does not support out_group > 1 packs; "
                "use 'lut_gemv' (or 'auto')"
            )
        if strategy == "lut_gemv":
            y = lut_gemv(cfg, self.packed, xb, variant=variant, plain=plain)
        elif strategy == "dequant_mm":
            if variant in ("f32", "i8"):
                tables = variant
            else:
                tables = "i8" if quality == "fast" else "bf16x2"
            y = dequant_matmul(cfg, self.packed, xb, tables=tables, plain=plain)
        elif strategy == "dense_bf16":
            from tpu_lutvq_torch.core.golden import dequantize

            if self.packed.nibbles:
                raise ValueError(
                    "dense_bf16 reconstruction cannot read nibble-packed codes; "
                    "use strategy='lut_gemv' (or pack with nibble_pack=False)"
                )
            p = local_view(self.packed)
            codes = p.codes_t[: cfg.n_groups, : p.d_out].T.reshape(
                p.d_out, cfg.n_codebook, cfg.n_subvec
            ).transpose(1, 2)
            scales = None if p.scales is None else p.scales[0, : p.d_out]
            zps = None if p.zero_points is None else p.zero_points[0, : p.d_out]
            w = dequantize(cfg, VQParams(p.codebook, codes, scales, zps))
            y = xb.float() @ w.T
        else:
            raise ValueError(f"unknown strategy {strategy!r}")
        return y.reshape(*lead, y.shape[-1])


def make_quantized_linear(
    generator: torch.Generator,
    cfg: VQConfig,
    d_out: int,
    dtype=torch.float16,
    with_scales: bool = True,
) -> QuantizedLinear:
    """Random-initialized quantized layer on ``generator.device``."""
    params = init_vq_params(generator, cfg, d_out, dtype=dtype, with_scales=with_scales)
    return QuantizedLinear(packed=pack_params(cfg, params))
