"""AQLM QuantizedLinear, Llama decoder, INT8 KV cache."""

from tpu_lutvq_torch.models.linear import DenseLinear, QuantizedLinear  # noqa: F401
from tpu_lutvq_torch.models.kv_cache import KVCache  # noqa: F401
from tpu_lutvq_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    LlamaWeights,
    init_llama,
    llama_decode_step,
    llama_forward,
)
