"""Parameter conversion from the JAX package (numpy in, torch out)."""

from tpu_lutvq_torch.utils.convert import (  # noqa: F401
    llama_from_numpy,
    packed_from_numpy,
)
