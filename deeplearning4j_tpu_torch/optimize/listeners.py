"""Iteration listeners.

Port of ``deeplearning4j_tpu/optimize/listeners.py`` (reference
optimize/api/IterationListener.java + listeners/*): the
``IterationListener`` SPI, the fused-window cadence ``fire_crossed``,
``ScoreIterationListener``, ``ComposableIterationListener``,
``CollectScoresIterationListener``,
``ParamAndGradientIterationListener``, ``TimeIterationListener``,
``LambdaIterationListener``, ``TracingIterationListener`` (over
``profiler/tracer.py`` and ``optimize/telemetry.py``) and
``BestScoreIterationListener``. Invoked from the host loop after each
optimizer iteration.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional

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


class ComposableIterationListener(IterationListener):
    def __init__(self, *listeners: IterationListener):
        self.listeners: List[IterationListener] = list(listeners)

    def iteration_done(self, model, iteration: int) -> None:
        for listener in self.listeners:
            listener.iteration_done(model, iteration)


class CollectScoresIterationListener(IterationListener):
    """Accumulate (iteration, score) pairs in memory (reference
    CollectScoresIterationListener)."""

    def __init__(self, frequency: int = 1):
        self.invoked_every = max(1, frequency)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration: int) -> None:
        self.scores.append((iteration, float(model.score_value)))


class ParamAndGradientIterationListener(IterationListener):
    """Log parameter norms each iteration (reference
    ParamAndGradientIterationListener.java)."""

    def __init__(self, iterations: int = 1):
        self.invoked_every = max(1, iterations)

    def iteration_done(self, model, iteration: int) -> None:
        for key, p in model.param_table().items():
            p = p.detach().float()
            log.info(
                "iter %d param %s: mean=%.6f l2=%.6f",
                iteration, key, float(p.mean()),
                float(p.reshape(-1).norm()),
            )


class TimeIterationListener(IterationListener):
    """Wall-clock per-iteration logging."""

    def __init__(self):
        self._last: Optional[float] = None

    def iteration_done(self, model, iteration: int) -> None:
        now = time.time()
        if self._last is not None:
            log.info("iteration %d took %.4fs", iteration, now - self._last)
        self._last = now


class LambdaIterationListener(IterationListener):
    def __init__(self, fn: Callable, every: int = 1):
        self._fn = fn
        self.invoked_every = max(1, every)

    def iteration_done(self, model, iteration: int) -> None:
        self._fn(model, iteration)


class TracingIterationListener(IterationListener):
    """Feed the per-step phase breakdown, throughput, and gradient
    health into a :class:`~deeplearning4j_tpu_torch.profiler.tracer.Tracer`
    and/or a JSONL :class:`~deeplearning4j_tpu_torch.optimize.telemetry
    .MetricsLog` through the standard listener SPI.

    The listener OWNS the training histograms (works with
    ``tracer=None`` — a headless JSONL-only run still gets quantiles
    via :meth:`quantile`) and registers them on the tracer by
    reference, the same adopt-by-reference contract the serving engine
    uses. Each fire drains the model's ``train_telemetry`` window:

    - times the score fetch (THE one host sync a training loop has —
      telemetry adds no second one) as the ``sync`` phase,
    - observes ``train_step_s`` / ``train_data_wait_s`` with the
      batched ``observe(value, n=steps)`` form so a fused fit_scan
      window of K steps costs one lock acquisition,
    - fetches the step's gradient-health outputs (computed inside the
      already-run train step; the fetch rides the same sync),
    - emits a ``train.step`` span carrying the full breakdown in its
      args plus contiguous ``train.data_wait`` / ``train.dispatch`` /
      ``train.sync`` child spans for Perfetto,
    - appends one JSONL record to the metrics log.

    Works on fused scan paths through the ``fire_crossed`` cadence: a
    K-step window that crossed the cadence fires once, with all K
    per-step health values observed from the window's stacked arrays.
    """

    def __init__(self, tracer=None, frequency: int = 1,
                 metrics_log=None):
        from deeplearning4j_tpu_torch.optimize import telemetry as T
        from deeplearning4j_tpu_torch.profiler.tracer import Histogram

        self.tracer = tracer
        self.invoked_every = max(1, frequency)
        self.metrics_log = metrics_log
        value_tracks = ("train_grad_norm", "train_update_ratio",
                        "train_param_norm")
        self.hists = {
            name: Histogram(T.VALUE_BOUNDS
                            if name in value_tracks else None)
            for name in T.TRAIN_HISTOGRAMS + (T.TRAIN_SYNC_HISTOGRAM,)
        }
        if tracer is not None:
            for name, hist in self.hists.items():
                tracer.register_histogram(name, hist)
            for name, help_text in T.TRAIN_TRACK_HELP.items():
                tracer.describe(name, help_text)

    def quantile(self, name: str, q: float) -> float:
        """Quantile of one owned histogram track (``train_step_s``,
        ...) — the headless counterpart of a Prometheus query."""
        return self.hists[name].quantile(q)

    def iteration_done(self, model, iteration: int) -> None:
        from deeplearning4j_tpu_torch.optimize import telemetry as T

        t0 = time.perf_counter()
        score = float(model.score_value)  # the existing host sync
        sync_s = time.perf_counter() - t0
        telemetry = getattr(model, "train_telemetry", None)
        snap = telemetry.consume() if telemetry is not None else None
        record = {"iteration": int(iteration), "score": score,
                  "sync_s": sync_s, "time": time.time()}
        self.hists["train_sync_s"].observe(sync_s)
        if snap is not None:
            steps = snap["steps"]
            wall = snap["wall_s"]
            self.hists["train_step_s"].observe(wall / steps, steps)
            self.hists["train_data_wait_s"].observe(
                snap["data_wait_s"] / steps, steps)
            health = T.fetch_health(snap["health"])
            nonfinite = 0.0
            if health:
                for key, track in (
                        ("grad_norm", "train_grad_norm"),
                        ("update_ratio", "train_update_ratio"),
                        ("param_norm", "train_param_norm")):
                    for value in health.get(key, ()):
                        self.hists[track].observe(value)
                nonfinite = sum(health.get("nonfinite_grads", ()))
                for key in ("grad_norm", "update_ratio", "param_norm"):
                    if health.get(key):
                        record[key] = health[key][-1]
                record["nonfinite_grads"] = nonfinite
            record.update(
                steps=steps, wall_s=wall, step_s=wall / steps,
                data_wait_s=snap["data_wait_s"],
                dispatch_s=snap["dispatch_s"],
                examples_per_sec=snap["examples"] / max(wall, 1e-9),
                tokens_per_sec=snap["tokens"] / max(wall, 1e-9),
            )
            if self.tracer is not None:
                self._emit_trace(iteration, score, snap, sync_s,
                                 nonfinite)
        elif self.tracer is not None:
            self.tracer.counter("train_score", score)
        if self.metrics_log is not None:
            self.metrics_log.write(record)

    def _emit_trace(self, iteration, score, snap, sync_s,
                    nonfinite) -> None:
        tracer = self.tracer
        wall_us = snap["wall_s"] * 1e6
        end_us = tracer.now_us()
        start_us = end_us - wall_us
        tracer.complete(
            "train.step", start_us, wall_us, iteration=int(iteration),
            steps=snap["steps"], score=score,
            data_wait_s=snap["data_wait_s"],
            dispatch_s=snap["dispatch_s"], sync_s=sync_s,
            examples=snap["examples"], tokens=snap["tokens"])
        # Contiguous phase child spans: positions are the canonical
        # wait->dispatch->sync order (approximate inside multi-step
        # windows), durations exact — the Perfetto-visible breakdown.
        tracer.complete("train.data_wait", start_us,
                        snap["data_wait_s"] * 1e6)
        tracer.complete("train.dispatch",
                        start_us + snap["data_wait_s"] * 1e6,
                        snap["dispatch_s"] * 1e6)
        tracer.complete("train.sync", end_us - sync_s * 1e6,
                        sync_s * 1e6)
        tracer.counter("train_score", score)
        tracer.rate("train_examples_per_sec", snap["examples"],
                    snap["wall_s"])
        if snap["tokens"]:
            tracer.rate("train_tokens_per_sec", snap["tokens"],
                        snap["wall_s"])
        tracer.incr("train_steps_total", snap["steps"])
        if nonfinite:
            tracer.incr("train_nonfinite_grads", nonfinite)


class BestScoreIterationListener(IterationListener):
    """Track the best (lowest) score seen (reference Spark
    BestScoreAccumulator / BestScoreIterationListener roles)."""

    def __init__(self, frequency: int = 1):
        self.invoked_every = max(1, frequency)
        self.best_score = float("inf")
        self.best_iteration = -1

    def iteration_done(self, model, iteration: int) -> None:
        score = float(model.score_value)
        if score < self.best_score:
            self.best_score = score
            self.best_iteration = iteration
