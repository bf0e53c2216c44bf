"""Score calculators for early stopping.

A copy of ``deeplearning4j_tpu/earlystopping/scorecalc.py``.

Mirror of reference earlystopping/scorecalc/DataSetLossCalculator.java
(+CG variant): average model loss over a held-out iterator.
"""

from __future__ import annotations


class ScoreCalculator:
    def calculate_score(self, model) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, model) -> float:
        total = 0.0
        n = 0
        self.iterator.reset()
        for ds in self.iterator:
            b = ds.num_examples()
            total += model.score(ds) * b
            n += b
        if n == 0:
            return float("nan")
        return total / n if self.average else total
