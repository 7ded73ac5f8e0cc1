"""AQLM QuantizedLinear, Llama decoder, INT8 KV cache (slab, paged and
stacked), the attention policy."""

from tpu_lutvq_torch.models.linear import (  # noqa: F401
    ChunkedVQLinear,
    DenseLinear,
    QuantizedLinear,
)
from tpu_lutvq_torch.models.kv_cache import KVCache  # noqa: F401
from tpu_lutvq_torch.models.paged_cache import BlockAllocator, PagedKVCache  # noqa: F401
from tpu_lutvq_torch.models.attn_policy import resolve_attn  # noqa: F401
from tpu_lutvq_torch.models.llama import (  # noqa: F401
    LlamaConfig,
    LlamaWeights,
    init_caches,
    init_llama,
    init_stacked_caches,
    llama_decode_step,
    llama_forward,
    stack_llama_weights,
)
