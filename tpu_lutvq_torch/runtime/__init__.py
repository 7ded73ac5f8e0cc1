"""Decode loop, chunked prefill, the continuous batcher and perplexity
scoring."""

from tpu_lutvq_torch.runtime.generate import (  # noqa: F401
    GenerationResult,
    generate,
    make_chunked_prefill,
)
from tpu_lutvq_torch.runtime.batching import ContinuousBatcher, Request  # noqa: F401
from tpu_lutvq_torch.runtime.eval import perplexity, sequence_logprobs  # noqa: F401
