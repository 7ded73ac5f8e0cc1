"""Decode loop, chunked prefill, the continuous batcher, perplexity
scoring, and the checkpoint loaders (``runtime.checkpoint``)."""

from tpu_lutvq_torch.runtime.generate import (  # noqa: F401
    GenerationResult,
    generate,
    make_chunked_prefill,
)
from tpu_lutvq_torch.runtime.batching import ContinuousBatcher, Request  # noqa: F401
from tpu_lutvq_torch.runtime.eval import perplexity, sequence_logprobs  # noqa: F401
from tpu_lutvq_torch.runtime.checkpoint import (  # noqa: F401
    load_aqlm_linear,
    load_aqlm_llama,
    load_lutvq,
    open_checkpoint,
    save_lutvq,
)
