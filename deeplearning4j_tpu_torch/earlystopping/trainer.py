"""Early stopping trainer loop.

Port of ``deeplearning4j_tpu/earlystopping/trainer.py``. Mirror of
reference earlystopping/trainer/BaseEarlyStoppingTrainer.java:
epoch loop over the training iterator with per-iteration and per-epoch
termination checks, best-model tracking through the saver. Works for both
MultiLayerNetwork and ComputationGraph (the reference needs a separate
EarlyStoppingGraphTrainer only because of Java typing).
"""

from __future__ import annotations

import logging
import math
import time

from deeplearning4j_tpu_torch.earlystopping.config import (
    EarlyStoppingConfiguration,
    EarlyStoppingResult,
    TerminationReason,
)

log = logging.getLogger(__name__)


class EarlyStoppingTrainer:
    def __init__(
        self,
        config: EarlyStoppingConfiguration,
        net,
        train_iterator,
        listener=None,
        tracer=None,
    ):
        self.config = config
        self.net = net
        self.train_iterator = train_iterator
        self.listener = listener
        # Optional training Tracer: epoch spans, per-epoch
        # score counters, and a ``train_early_stop`` cumulative counter
        # + ``train.early_stop`` instant at termination — an
        # early-stopped run is diagnosable from the trace alone (which
        # epoch, which condition, what score).
        self.tracer = tracer

    def set_listener(self, listener) -> None:
        """Lifecycle callbacks (reference EarlyStoppingListener SPI)."""
        self.listener = listener

    def _trace_stop(self, reason, details, epoch, score) -> None:
        if self.tracer is None or reason is None:
            return
        self.tracer.incr("train_early_stop")
        self.tracer.instant(
            "train.early_stop", reason=str(getattr(reason, "name",
                                                   reason)),
            details=details, epoch=int(epoch),
            score=None if score is None else float(score))

    def _fit_batch(self, ds) -> None:
        """One training call; distributed trainers override this."""
        self.net.fit(ds)

    def _train_score(self) -> float:
        return float(self.net.score_value)

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        if self.listener is not None:
            self.listener.on_start(cfg, self.net)
        for cond in cfg.epoch_terminations:
            cond.initialize()
        for cond in cfg.iteration_terminations:
            cond.initialize()

        best_score = math.inf
        best_epoch = -1
        score_vs_epoch = {}
        epoch = 0
        start_ms = time.time() * 1000.0
        reason = None
        details = ""
        last_score = math.inf

        try:
            while reason is None:
                epoch_start_us = (self.tracer.now_us()
                                  if self.tracer is not None else 0.0)
                self.train_iterator.reset()
                for ds in self.train_iterator:
                    self._fit_batch(ds)
                    if not cfg.iteration_terminations:
                        continue  # keep device dispatch asynchronous
                    elapsed = time.time() * 1000.0 - start_ms
                    score = self._train_score()
                    for cond in cfg.iteration_terminations:
                        if cond.terminate(elapsed, score):
                            reason = (
                                TerminationReason.ITERATION_TERMINATION_CONDITION
                            )
                            details = f"{type(cond).__name__} at epoch {epoch}"
                            self._trace_stop(reason, details, epoch,
                                             score)
                            break
                    if reason is not None:
                        break

                if reason is not None:
                    # Reference saves the latest model when an iteration
                    # condition fires (BaseEarlyStoppingTrainer.java:147-154).
                    if cfg.save_last_model:
                        cfg.model_saver.save_latest_model(
                            self.net, self._train_score()
                        )
                    break

                if epoch % max(1, cfg.evaluate_every_n_epochs) == 0:
                    if cfg.score_calculator is not None:
                        last_score = cfg.score_calculator.calculate_score(
                            self.net
                        )
                    else:
                        last_score = self._train_score()
                    score_vs_epoch[epoch] = last_score
                    if self.listener is not None:
                        self.listener.on_epoch(epoch, last_score, cfg,
                                               self.net)
                    if last_score < best_score:
                        best_score = last_score
                        best_epoch = epoch
                        cfg.model_saver.save_best_model(self.net, last_score)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(self.net, last_score)
                # Epoch conditions run EVERY epoch with the latest known
                # score (epoch counts, not evaluation counts).
                for cond in cfg.epoch_terminations:
                    if cond.terminate(epoch, last_score):
                        reason = TerminationReason.EPOCH_TERMINATION_CONDITION
                        details = f"{type(cond).__name__} at epoch {epoch}"
                        self._trace_stop(reason, details, epoch,
                                         last_score)
                        break
                if self.tracer is not None:
                    end_us = self.tracer.now_us()
                    self.tracer.complete(
                        "train.epoch", epoch_start_us,
                        end_us - epoch_start_us, epoch=epoch,
                        score=(None if not math.isfinite(last_score)
                               else float(last_score)),
                        best_epoch=best_epoch,
                        terminated=reason is not None)
                    if math.isfinite(last_score):
                        self.tracer.counter("train_epoch_score",
                                            float(last_score))
                if reason is not None:
                    break
                epoch += 1
        except Exception as e:  # return best-so-far (reference :86-126)
            log.exception("Early stopping training failed")
            reason = TerminationReason.ERROR
            details = f"{type(e).__name__}: {e}"
            self._trace_stop(reason, details, epoch, None)

        best = cfg.model_saver.get_best_model()
        if best is None:
            best = self.net
        result = EarlyStoppingResult(
            termination_reason=reason,
            termination_details=details,
            total_epochs=epoch + 1,
            best_model_epoch=best_epoch,
            best_model_score=best_score,
            score_vs_epoch=score_vs_epoch,
            best_model=best,
        )
        if self.listener is not None:
            self.listener.on_completion(result)
        return result


class ParallelEarlyStoppingTrainer(EarlyStoppingTrainer):
    """Early stopping over the data-parallel trainer (JAX's
    ``ParallelEarlyStoppingTrainer``): waits for the parallel trainers
    (ROADMAP Queue 1 item 11)."""

    def __init__(self, config, parallel_trainer, train_iterator,
                 listener=None, tracer=None):
        raise NotImplementedError(
            "ParallelEarlyStoppingTrainer needs the data-parallel trainer, "
            "which is not ported to the torch package yet (ROADMAP Queue 1 "
            "item 11); use EarlyStoppingTrainer")


# Reference-name aliases: the Java API needs a separate graph trainer
# (EarlyStoppingGraphTrainer.java) and trainer interface
# (IEarlyStoppingTrainer.java) only because of typing; here one trainer
# serves both model kinds.
IEarlyStoppingTrainer = EarlyStoppingTrainer
EarlyStoppingGraphTrainer = EarlyStoppingTrainer
