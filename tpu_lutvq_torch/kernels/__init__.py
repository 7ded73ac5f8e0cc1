"""Kernels: LUT construction, the LUT-GEMV and dequant-matmul projections
and the flash attention kernels, wrappers around the hand-written CUDA
kernels in ``csrc/``."""

from tpu_lutvq_torch.kernels.lut_ctor import (  # noqa: F401
    LANE,
    build_lut,
    quantize_lut_int8,
    quantize_lut_int16,
)
from tpu_lutvq_torch.kernels.lut_gemv import (  # noqa: F401
    PackedVQ,
    lut_gemv,
    lut_gemv_packed,
    pack_params,
)
from tpu_lutvq_torch.kernels.dequant_mm import dequant_matmul  # noqa: F401
from tpu_lutvq_torch.kernels.flash_decode import (  # noqa: F401
    flash_decode_attention,
    flash_decode_paged,
)
from tpu_lutvq_torch.kernels.flash_prefill import flash_prefill_attention  # noqa: F401
