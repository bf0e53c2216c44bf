"""Optimization: the solver loop, line-search optimizers, listeners,
terminations, step functions and training telemetry (port of
``deeplearning4j_tpu/optimize``). The SGD path is the networks' own
train step; ``solver.py`` runs the second-order paths over the flat
parameter vector from a host loop."""

from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    ComposableIterationListener,
    IterationListener,
    ScoreIterationListener,
    TracingIterationListener,
)
from deeplearning4j_tpu_torch.optimize.stepfunctions import (  # noqa: F401
    DefaultStepFunction,
    GradientStepFunction,
    NegativeDefaultStepFunction,
    NegativeGradientStepFunction,
    StepFunction,
)
from deeplearning4j_tpu_torch.optimize.telemetry import (  # noqa: F401
    MetricsLog,
    TrainTelemetry,
)
