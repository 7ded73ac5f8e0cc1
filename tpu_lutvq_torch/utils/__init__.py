"""Parameter and cache-state conversion from the JAX package (numpy in,
torch out)."""

from tpu_lutvq_torch.utils.convert import (  # noqa: F401
    kv_caches_from_numpy,
    llama_from_numpy,
    packed_from_numpy,
    paged_caches_from_numpy,
)
