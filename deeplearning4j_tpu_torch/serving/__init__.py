"""Serving: the continuous-batching decode engine over a dense slot pool
or the paged KV block pool, with the prefix caches and chunked admission
(port of ``deeplearning4j_tpu/serving``'s engine core)."""

from deeplearning4j_tpu_torch.serving.engine import DecodeEngine
from deeplearning4j_tpu_torch.serving.prefix_cache import (
    PagedPrefixCache,
    RadixPrefixCache,
)
from deeplearning4j_tpu_torch.serving.scheduler import (
    GenerationResult,
    Request,
    Scheduler,
)
