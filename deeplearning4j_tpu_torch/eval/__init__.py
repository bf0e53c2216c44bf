"""Evaluation: classification metrics with distributed merge (copy of
``deeplearning4j_tpu/eval``)."""

from deeplearning4j_tpu_torch.eval.evaluation import (  # noqa: F401
    ConfusionMatrix,
    Evaluation,
)
