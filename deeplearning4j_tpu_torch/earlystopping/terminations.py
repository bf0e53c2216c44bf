"""Early-stopping termination conditions.

A copy of ``deeplearning4j_tpu/earlystopping/terminations.py``.

Mirror of reference earlystopping/termination/{MaxEpochsTerminationCondition,
ScoreImprovementEpochTerminationCondition, MaxTimeIterationTerminationCondition,
MaxScoreIterationTerminationCondition, InvalidScoreIterationTerminationCondition,
BestScoreEpochTerminationCondition}.java.

Epoch conditions are checked once per epoch with (epoch, score); iteration
conditions every iteration with (elapsed_ms, score).
"""

from __future__ import annotations

import math


class EpochTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class IterationTerminationCondition:
    def initialize(self) -> None:
        pass

    def terminate(self, elapsed_ms: float, score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch: int, score: float) -> bool:
        return epoch + 1 >= self.max_epochs


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs with no (sufficient) score improvement."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.max_epochs_without_improvement = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self.initialize()

    def initialize(self) -> None:
        self._best = math.inf
        self._stale = 0

    def terminate(self, epoch: int, score: float) -> bool:
        if score < self._best - self.min_improvement:
            self._best = score
            self._stale = 0
        else:
            self._stale += 1
        return self._stale > self.max_epochs_without_improvement


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score is at least as good as a target."""

    def __init__(self, best_expected_score: float):
        self.best_expected_score = best_expected_score

    def terminate(self, epoch: int, score: float) -> bool:
        return score <= self.best_expected_score


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_time_seconds: float):
        self.max_time_seconds = max_time_seconds

    def terminate(self, elapsed_ms: float, score: float) -> bool:
        return elapsed_ms >= self.max_time_seconds * 1000.0


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort if the score exceeds a threshold (divergence guard)."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, elapsed_ms: float, score: float) -> bool:
        return score > self.max_score


class InvalidScoreIterationTerminationCondition(IterationTerminationCondition):
    def terminate(self, elapsed_ms: float, score: float) -> bool:
        return math.isnan(score) or math.isinf(score)
