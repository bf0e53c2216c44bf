"""Parameter step functions for the optimizer loop.

A copy of ``deeplearning4j_tpu/optimize/stepfunctions.py``: the
reference step-function SPI (reference
optimize/stepfunctions/{DefaultStepFunction,GradientStepFunction,
NegativeDefaultStepFunction,NegativeGradientStepFunction}.java and the
nn/conf/stepfunctions beans): how ``params`` moves along the search
direction after line search. Pure functions over flat tensors (or numpy
arrays).
"""

from __future__ import annotations


class StepFunction:
    """``step(x, direction, step_size) -> new x``."""

    def step(self, x, direction, step_size: float = 1.0):
        raise NotImplementedError


class DefaultStepFunction(StepFunction):
    """x + step * direction (reference DefaultStepFunction.java)."""

    def step(self, x, direction, step_size: float = 1.0):
        return x + step_size * direction


class GradientStepFunction(StepFunction):
    """x + direction, ignoring the line-search scale (reference
    GradientStepFunction.java)."""

    def step(self, x, direction, step_size: float = 1.0):
        return x + direction


class NegativeDefaultStepFunction(StepFunction):
    """x - step * direction, for ascent-convention directions (reference
    NegativeDefaultStepFunction.java)."""

    def step(self, x, direction, step_size: float = 1.0):
        return x - step_size * direction


class NegativeGradientStepFunction(StepFunction):
    """x - direction (reference NegativeGradientStepFunction.java)."""

    def step(self, x, direction, step_size: float = 1.0):
        return x - direction


_REGISTRY = {
    "default": DefaultStepFunction,
    "gradient": GradientStepFunction,
    "negative_default": NegativeDefaultStepFunction,
    "negative_gradient": NegativeGradientStepFunction,
}


def from_name(name) -> StepFunction:
    """Resolve a step function from its conf name (reference
    StepFunctions.java factory)."""
    if isinstance(name, StepFunction):
        return name
    key = str(name).lower().replace("stepfunction", "").strip("_")
    key = {"negativedefault": "negative_default",
           "negativegradient": "negative_gradient"}.get(key, key)
    if key not in _REGISTRY:
        raise ValueError(
            f"unknown step function {name!r}; one of {sorted(_REGISTRY)}")
    return _REGISTRY[key]()
