"""Decode loop, chunked prefill and the continuous batcher."""

from tpu_lutvq_torch.runtime.generate import (  # noqa: F401
    GenerationResult,
    generate,
    make_chunked_prefill,
)
from tpu_lutvq_torch.runtime.batching import ContinuousBatcher, Request  # noqa: F401
