"""Serving: the continuous-batching decode engine over the paged KV
block pool (port of ``deeplearning4j_tpu/serving``'s engine core)."""

from deeplearning4j_tpu_torch.serving.engine import DecodeEngine
from deeplearning4j_tpu_torch.serving.scheduler import (
    GenerationResult,
    Request,
    Scheduler,
)
