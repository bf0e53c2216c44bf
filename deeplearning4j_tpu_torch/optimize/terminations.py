"""Termination conditions for the iterative optimizers.

A copy of ``deeplearning4j_tpu/optimize/terminations.py``. Mirror of
reference optimize/terminations/{EpsTermination,Norm2Termination,
ZeroDirection}.java, checked at the end of each optimizer iteration
(BaseOptimizer.java:222).
"""

from __future__ import annotations

import numpy as np


class TerminationCondition:
    def terminate(self, cost: float, old_cost: float, direction) -> bool:
        raise NotImplementedError


class EpsTermination(TerminationCondition):
    def __init__(self, eps: float = 1e-4, tolerance: float = 1e-8):
        self.eps = eps
        self.tolerance = tolerance

    def terminate(self, cost, old_cost, direction) -> bool:
        if old_cost == 0.0:
            return abs(cost - old_cost) < self.tolerance
        return abs(cost - old_cost) / abs(old_cost) < self.eps


class Norm2Termination(TerminationCondition):
    def __init__(self, gradient_tolerance: float = 1e-6):
        self.gradient_tolerance = gradient_tolerance

    def terminate(self, cost, old_cost, direction) -> bool:
        return float(np.linalg.norm(_host(direction))) < self.gradient_tolerance


class ZeroDirection(TerminationCondition):
    def terminate(self, cost, old_cost, direction) -> bool:
        return float(np.abs(_host(direction)).max()) == 0.0


def _host(direction) -> np.ndarray:
    """A direction (numpy or a tensor on any device) as float64 numpy."""
    if hasattr(direction, "detach"):
        direction = direction.detach().double().cpu().numpy()
    return np.asarray(direction, dtype=np.float64)


DEFAULT_CONDITIONS = (ZeroDirection(), EpsTermination())
