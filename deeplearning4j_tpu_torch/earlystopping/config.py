"""EarlyStoppingConfiguration + result.

A copy of ``deeplearning4j_tpu/earlystopping/config.py``.

Mirror of reference earlystopping/EarlyStoppingConfiguration.java (builder
with saver/score-calculator/terminations) and EarlyStoppingResult.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

from deeplearning4j_tpu_torch.earlystopping.savers import InMemoryModelSaver, ModelSaver
from deeplearning4j_tpu_torch.earlystopping.scorecalc import ScoreCalculator
from deeplearning4j_tpu_torch.earlystopping.terminations import (
    EpochTerminationCondition,
    IterationTerminationCondition,
)


class TerminationReason(str, enum.Enum):
    EPOCH_TERMINATION_CONDITION = "epoch_termination_condition"
    ITERATION_TERMINATION_CONDITION = "iteration_termination_condition"
    ERROR = "error"


@dataclasses.dataclass
class EarlyStoppingConfiguration:
    score_calculator: Optional[ScoreCalculator] = None
    model_saver: ModelSaver = dataclasses.field(default_factory=InMemoryModelSaver)
    epoch_terminations: List[EpochTerminationCondition] = dataclasses.field(
        default_factory=list
    )
    iteration_terminations: List[IterationTerminationCondition] = (
        dataclasses.field(default_factory=list)
    )
    save_last_model: bool = False
    evaluate_every_n_epochs: int = 1

    class Builder:
        def __init__(self):
            self._c = EarlyStoppingConfiguration()

        def score_calculator(self, sc) -> "EarlyStoppingConfiguration.Builder":
            self._c.score_calculator = sc
            return self

        def model_saver(self, saver) -> "EarlyStoppingConfiguration.Builder":
            self._c.model_saver = saver
            return self

        def epoch_termination_conditions(self, *conds):
            self._c.epoch_terminations = list(conds)
            return self

        def iteration_termination_conditions(self, *conds):
            self._c.iteration_terminations = list(conds)
            return self

        def save_last_model(self, flag: bool):
            self._c.save_last_model = flag
            return self

        def evaluate_every_n_epochs(self, n: int):
            self._c.evaluate_every_n_epochs = n
            return self

        def build(self) -> "EarlyStoppingConfiguration":
            return self._c


@dataclasses.dataclass
class EarlyStoppingResult:
    termination_reason: TerminationReason
    termination_details: str
    total_epochs: int
    best_model_epoch: int
    best_model_score: float
    score_vs_epoch: dict
    best_model: object
