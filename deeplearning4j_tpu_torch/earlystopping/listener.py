"""Early-stopping lifecycle listener.

A copy of ``deeplearning4j_tpu/earlystopping/listener.py``.

Port of the reference listener SPI (reference
earlystopping/listener/EarlyStoppingListener.java): callbacks at training
start, after every epoch evaluation, and at completion — the hook the UI
and logging ride on during early-stopping runs.
"""

from __future__ import annotations


class EarlyStoppingListener:
    def on_start(self, config, net) -> None:
        pass

    def on_epoch(self, epoch: int, score: float, config, net) -> None:
        pass

    def on_completion(self, result) -> None:
        pass


class ComposableEarlyStoppingListener(EarlyStoppingListener):
    """Fan one callback out to many listeners."""

    def __init__(self, *listeners: EarlyStoppingListener):
        self.listeners = list(listeners)

    def on_start(self, config, net) -> None:
        for cb in self.listeners:
            cb.on_start(config, net)

    def on_epoch(self, epoch: int, score: float, config, net) -> None:
        for cb in self.listeners:
            cb.on_epoch(epoch, score, config, net)

    def on_completion(self, result) -> None:
        for cb in self.listeners:
            cb.on_completion(result)


class LoggingEarlyStoppingListener(EarlyStoppingListener):
    """Log epoch scores (the ScoreIterationListener analogue for
    early-stopping epochs)."""

    def __init__(self):
        self.epochs = []

    def on_start(self, config, net) -> None:
        import logging

        logging.getLogger(__name__).info("early stopping: start")

    def on_epoch(self, epoch: int, score: float, config, net) -> None:
        import logging

        self.epochs.append((epoch, score))
        logging.getLogger(__name__).info(
            "early stopping: epoch %d score %.6f", epoch, score)

    def on_completion(self, result) -> None:
        import logging

        logging.getLogger(__name__).info(
            "early stopping: done (%s)", result.termination_reason)
