"""Iteration listeners.

Port of the listeners ``MultiLayerNetwork.fit`` drives, from
``deeplearning4j_tpu/optimize/listeners.py``: the ``IterationListener``
SPI, the fused-window cadence ``fire_crossed``, ``ScoreIterationListener``
and ``CollectScoresIterationListener``. Invoked from the host loop after
each optimizer iteration.
"""

from __future__ import annotations

import logging
from typing import List

log = logging.getLogger(__name__)


class IterationListener:
    """SPI: ``iteration_done(model, iteration)``."""

    invoked_every: int = 1

    def iteration_done(self, model, iteration: int) -> None:
        raise NotImplementedError


def fire_crossed(listeners, model, start: int, end: int) -> None:
    """Fused K-step (``fit_scan``) listener cadence: fire each listener
    once per call iff the (start, end] iteration window crossed a
    multiple of its ``invoked_every`` (``<= 1`` means every call; an
    empty window never fires; a window crossing several multiples fires
    once, at the window's final iteration)."""
    for listener in listeners:
        n = max(1, listener.invoked_every)
        if end // n > start // n:
            listener.iteration_done(model, end)


class ScoreIterationListener(IterationListener):
    """Log the score every N iterations (reference
    ScoreIterationListener.java:31)."""

    def __init__(self, print_iterations: int = 10):
        self.invoked_every = max(1, print_iterations)

    def iteration_done(self, model, iteration: int) -> None:
        log.info("Score at iteration %d is %s", iteration,
                 float(model.score_value))


class CollectScoresIterationListener(IterationListener):
    """Accumulate (iteration, score) pairs in memory (reference
    CollectScoresIterationListener)."""

    def __init__(self, frequency: int = 1):
        self.invoked_every = max(1, frequency)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration: int) -> None:
        self.scores.append((iteration, float(model.score_value)))
