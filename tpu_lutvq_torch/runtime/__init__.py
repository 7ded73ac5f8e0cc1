"""Decode loop."""

from tpu_lutvq_torch.runtime.generate import GenerationResult, generate  # noqa: F401
