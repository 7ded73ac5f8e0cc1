"""Projection kernels: LUT construction, the LUT-GEMV and dequant-matmul
wrappers around the hand-written CUDA kernels in ``csrc/``."""

from tpu_lutvq_torch.kernels.lut_ctor import LANE, build_lut  # noqa: F401
from tpu_lutvq_torch.kernels.lut_gemv import (  # noqa: F401
    PackedVQ,
    lut_gemv,
    pack_params,
)
from tpu_lutvq_torch.kernels.dequant_mm import dequant_matmul  # noqa: F401
