"""The card's peak figures for the traffic model (counterpart of
``tpu_lutvq.dataflow.chips``, which lists TPUs only).

One entry, the H100 SXM, from NVIDIA's data sheet (dense rates, no
sparsity, at the card's 700 W power limit): HBM size and bandwidth, the f32
rate outside the tensor cores, the bf16 and int8 tensor-core rates, the SM
count, and shared memory's 128 bytes a clock an SM at the maximum SM
clock, the ceiling of the lookup kernels' gathers.  ``chip_smoke.py`` reads
its bounds from here, so the peaks live in one place.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_bytes: float  # HBM capacity
    hbm_bytes_s: float  # HBM bandwidth, bytes/s
    f32_flops: float  # f32 FLOP/s on the CUDA cores
    bf16_flops: float  # bf16 tensor-core FLOP/s
    int8_ops: float  # int8 tensor-core OP/s
    sms: int
    smem_bytes_clk: int  # shared-memory bytes a clock, per SM
    sm_clock_hz: float  # the maximum SM clock

    @property
    def peak_ops(self) -> dict:
        """Operations/s by the type the work runs in."""
        return {"f32": self.f32_flops, "bf16": self.bf16_flops, "int8": self.int8_ops}

    @property
    def sm_words_s(self) -> float:
        """4-byte shared-memory words/s of one SM."""
        return self.smem_bytes_clk * self.sm_clock_hz / 4

    @property
    def lookup_words_s(self) -> float:
        """4-byte shared-memory words/s over every SM: the lookups' ceiling."""
        return self.sms * self.sm_words_s


CHIPS: dict[str, ChipSpec] = {
    "h100_sxm": ChipSpec(
        name="h100_sxm",
        hbm_bytes=80e9,
        hbm_bytes_s=3.35e12,
        f32_flops=67e12,
        bf16_flops=989e12,
        int8_ops=1979e12,
        sms=132,
        smem_bytes_clk=128,
        sm_clock_hz=1.98e9,
    ),
}


def default_chip() -> ChipSpec:
    return CHIPS["h100_sxm"]
