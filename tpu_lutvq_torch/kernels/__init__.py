"""Kernels: LUT construction, the LUT-GEMV and dequant-matmul projections
(bf16, W8A8 and f32 tables) and the flash attention kernels, wrappers
around the hand-written CUDA kernels in ``csrc/``.  Each module keeps its
kernels' launch counters (``*_LAUNCHES``)."""

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
from tpu_lutvq_torch.kernels.dequant_mm import (  # noqa: F401
    dequant_matmul,
    fold_activations_i8,
    quantize_tables_i8,
)
from tpu_lutvq_torch.kernels.flash_decode import (  # noqa: F401
    flash_decode_attention,
    flash_decode_paged,
)
from tpu_lutvq_torch.kernels.flash_prefill import flash_prefill_attention  # noqa: F401
