"""Training telemetry: the per-step phase clock
``MultiLayerNetwork.fit`` stamps.

Port of the parts of ``deeplearning4j_tpu/optimize/telemetry.py`` that
fit uses: :class:`TrainTelemetry` (the host-side phase accumulator every
network owns), the batch/window counters and the gradient-health
scalars every train step returns (:func:`grad_health`). The tracing
listener that reads them and the JSONL sink belong to a later slice.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

#: Gradient-health leaf names, in the order every producer emits them.
HEALTH_KEYS = ("grad_norm", "update_ratio", "param_norm",
               "nonfinite_grads")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def grad_health(grads, params, new_params) -> Dict[str, torch.Tensor]:
    """Gradient-health scalars of one train step, computed on the device
    inside the step (no host read): ``{grad_norm, update_ratio,
    param_norm, nonfinite_grads}`` as float32 0-dim tensors.
    ``update_ratio`` uses the applied delta (old minus new params), so
    it reflects the normalized, scaled, lr-sized update the step took.
    Every reduction runs in float32, over each tree's leaves at once
    (``torch._foreach_norm``: a few kernels, not a few per leaf); a
    norm is the root of the summed squares of the leaves' norms."""
    def f32(tree):
        return [leaf.float() for leaf in _leaves(tree)]

    def norm(leaves):
        return torch.stack(torch._foreach_norm(leaves)).square().sum().sqrt()

    g = f32(grads)
    old, new = f32(params), f32(new_params)
    finite = torch.stack([torch.isfinite(leaf).sum() for leaf in g]).sum()
    param_norm = norm(new)
    return {
        "grad_norm": norm(g),
        "update_ratio": norm(torch._foreach_sub(old, new))
        / torch.clamp(param_norm, min=1e-12),
        "param_norm": param_norm,
        "nonfinite_grads": (sum(leaf.numel() for leaf in g)
                            - finite).float(),
    }


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
                 "examples", "tokens", "health", "_active")

    def __init__(self) -> None:
        self._reset(time.perf_counter())

    def _reset(self, now: float) -> None:
        self.wall_start = now
        self.data_wait_s = 0.0
        self.dispatch_s = 0.0
        self.steps = 0
        self.examples = 0
        self.tokens = 0
        self.health: Any = None
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
                    examples: int = 0, tokens: int = 0,
                    health=None) -> None:
        """Stamp one dispatch: ``steps`` optimizer iterations covered
        (K for a fit_scan window), batch sizes, and the step's health
        outputs (a dict of device scalars, or of [K] device tensors for
        a window; kept un-fetched until a consumer drains)."""
        self._anchor(dispatch_s)
        self.dispatch_s += dispatch_s
        self.steps += steps
        self.examples += examples
        self.tokens += tokens
        if health is not None:
            self.health = health

    def consume(self) -> Optional[Dict[str, Any]]:
        """Drain the window: returns ``{wall_s, data_wait_s,
        dispatch_s, steps, examples, tokens, health}`` and starts a new
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
            "health": self.health,
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
