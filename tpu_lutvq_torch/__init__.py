"""tpu-lutvq, PyTorch + CUDA port for NVIDIA Hopper.

The JAX/Pallas package ``tpu_lutvq`` is the reference; this package serves
the same AQLM-2x8 Llama ``generate()`` and ``ContinuousBatcher`` paths (from
random weights or an AQLM checkpoint), T-MAC nibble-packed layers, and the
same PQ/RQ ANN search, with PyTorch around hand-written CUDA kernels
(``csrc/``).  It imports no jax.  Entry points that make tensors put them on
the CUDA device unless a ``device`` argument says otherwise.

- ``tpu_lutvq_torch.core``    — VQ<D,M,N,K> configs, params, golden model
- ``tpu_lutvq_torch.kernels`` — LUT build, LUT-GEMV, dequant-matmul and flash
                                 attention wrappers, the nvcc build (``_build``)
- ``tpu_lutvq_torch.models``  — QuantizedLinear, Llama decoder, INT8 KV cache
                                 (slab and paged), attention policy
- ``tpu_lutvq_torch.runtime`` — ``generate()``, chunked prefill, the batcher,
                                 perplexity (``runtime.eval``), AQLM and
                                 native checkpoint loading (``runtime.checkpoint``)
- ``tpu_lutvq_torch.utils``   — parameters carried across from the JAX package,
                                 the safetensors reader and writer
- ``tpu_lutvq_torch.ann``     — PQ/RQ ANN search engine: k-means, f32/int8/int16
                                 table scans, refined search, SDC, OPQ
- ``tpu_lutvq_torch.tracing`` — profiler ranges (``span``) and the batchers'
                                 tick account (``TICKS``)
"""

from tpu_lutvq_torch.core.config import (  # noqa: F401
    VQConfig,
    aqlm_2x8,
    aqlm_1x16,
    pq_ann,
    rq_ann,
    tmac,
)
from tpu_lutvq_torch.core.params import VQParams, init_vq_params  # noqa: F401
from tpu_lutvq_torch.core import golden  # noqa: F401
from tpu_lutvq_torch import ann  # noqa: F401

__version__ = "0.1.0"
