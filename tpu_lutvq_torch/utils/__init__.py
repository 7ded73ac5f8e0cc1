"""Parameter, cache-state and ANN-state conversion from the JAX package
(numpy in, torch out); the safetensors reader and writer and the numpy
layout helpers of the checkpoint loader."""

from tpu_lutvq_torch.utils.convert import (  # noqa: F401
    kv_caches_from_numpy,
    llama_from_numpy,
    mixed_pq_from_numpy,
    opq_from_numpy,
    packed_from_numpy,
    paged_caches_from_numpy,
    pq_from_numpy,
    rq_from_numpy,
)
