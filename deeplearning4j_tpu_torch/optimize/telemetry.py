"""Training telemetry: the per-step phase clock
``MultiLayerNetwork.fit`` stamps.

Port of the parts of ``deeplearning4j_tpu/optimize/telemetry.py`` that
fit uses: :class:`TrainTelemetry` (the host-side phase accumulator every
network owns) and the batch/window counters. The gradient-health
scalars, the tracing listener that reads them and the JSONL sink belong
to a later slice.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

class TrainTelemetry:
    """Host-side phase accumulator for one training loop.

    Every network owns one (``net.train_telemetry``). The fit loops add
    disjoint measured intervals — data-wait around the iterator fetch,
    dispatch wall around the step call — plus step/example/token
    counts. A consumer (a tracing
    listener) drains the window with :meth:`consume`; the window wall
    is measured at drain time, AFTER the consumer's score sync, so
    ``data_wait + dispatch + sync <= wall`` is guaranteed by interval
    containment rather than by luck.
    """

    __slots__ = ("wall_start", "data_wait_s", "dispatch_s", "steps",
                 "examples", "tokens", "_active")

    def __init__(self) -> None:
        self._reset(time.perf_counter())

    def _reset(self, now: float) -> None:
        self.wall_start = now
        self.data_wait_s = 0.0
        self.dispatch_s = 0.0
        self.steps = 0
        self.examples = 0
        self.tokens = 0
        self._active = False

    def _anchor(self, elapsed: float) -> None:
        """Re-anchor the wall origin at the START of a window's first
        measured event (``elapsed`` seconds ago). Without this, the
        first window's wall would stretch back to network CONSTRUCTION
        — dataset downloads and conf building between init and the
        first fit would read as step time."""
        if not self._active:
            self.wall_start = time.perf_counter() - elapsed
            self._active = True

    def add_data_wait(self, seconds: float) -> None:
        self._anchor(seconds)
        self.data_wait_s += seconds

    def record_step(self, dispatch_s: float = 0.0, steps: int = 1,
                    examples: int = 0, tokens: int = 0) -> None:
        """Stamp one dispatch: ``steps`` optimizer iterations covered
        (K for a fit_scan window) and batch sizes."""
        self._anchor(dispatch_s)
        self.dispatch_s += dispatch_s
        self.steps += steps
        self.examples += examples
        self.tokens += tokens

    def consume(self) -> Optional[Dict[str, Any]]:
        """Drain the window: returns ``{wall_s, data_wait_s,
        dispatch_s, steps, examples, tokens}`` and starts a new
        window. None when no step landed since the last drain (a
        listener firing twice at one iteration must not emit an empty
        sample) — an empty drain leaves the window UNTOUCHED, so
        accrued data-wait and the wall origin survive into the window
        that finally carries a step (phase sums <= wall stays an
        interval-containment fact)."""
        now = time.perf_counter()
        if self.steps == 0:
            return None
        snap = {
            "wall_s": now - self.wall_start,
            "data_wait_s": self.data_wait_s,
            "dispatch_s": self.dispatch_s,
            "steps": self.steps,
            "examples": self.examples,
            "tokens": self.tokens,
        }
        self._reset(now)
        return snap


def batch_counts(features) -> tuple:
    """(examples, tokens) of one batch: tokens is B*T for EXACTLY
    rank-3 ([B, C, T]) time-series features; any other rank (2-D
    dense, 4-D conv images) counts tokens == examples — a [B, C, H, W]
    image batch must not report B*H as a token rate."""
    shape = getattr(features, "shape", None)
    if not shape:
        return 0, 0
    examples = int(shape[0])
    tokens = examples * int(shape[2]) if len(shape) == 3 else examples
    return examples, tokens


def window_counts(shape) -> tuple:
    """(steps, examples, tokens) of one stacked fit_scan window
    ([K, B, ...]; tokens = K*B*T only for exactly [K, B, C, T] time
    series, mirroring :func:`batch_counts`). Shape-only — never slices
    a device array (a host-side ``feats[0]`` would dispatch a gather
    executable just to read a shape)."""
    k = int(shape[0])
    examples = k * int(shape[1])
    tokens = (examples * int(shape[3]) if len(shape) == 4
              else examples)
    return k, examples, tokens
