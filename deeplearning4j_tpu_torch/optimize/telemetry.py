"""Training telemetry: the per-step phase clock every fit path stamps,
the gradient-health scalars, and the headless JSONL metrics sink.

Port of ``deeplearning4j_tpu/optimize/telemetry.py`` (less the parallel
trainers' span helpers, which wait for ROADMAP Queue 1 item 11):
:class:`TrainTelemetry` (the host-side phase accumulator every network
owns), the batch/window counters, the gradient-health scalars every
train step returns (:func:`grad_health`; :func:`host_grad_health` for
the solvers' host loop), :func:`fetch_health` for the tracing listener,
the training histogram tracks, and :class:`MetricsLog`.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

#: The five training histogram tracks: latency-style phases in seconds
#: plus gradient-health value distributions.
TRAIN_HISTOGRAMS = (
    "train_step_s",
    "train_data_wait_s",
    "train_grad_norm",
    "train_update_ratio",
    "train_param_norm",
)

#: Host-sync wall also keeps a histogram beside the five core tracks.
TRAIN_SYNC_HISTOGRAM = "train_sync_s"

#: ``# HELP`` text per training track, applied via ``Tracer.describe``.
TRAIN_TRACK_HELP: Dict[str, str] = {
    "train_step_s": "per-step wall time (window wall / steps)",
    "train_data_wait_s": "per-step host wait on the data iterator",
    "train_sync_s": "host-sync wall at the listener's score fetch",
    "train_grad_norm": "global L2 norm of the step gradient",
    "train_update_ratio":
        "L2 norm of the applied parameter delta / new param norm",
    "train_param_norm": "global L2 norm of the post-step parameters",
    "train_examples_per_sec": "training throughput over the last window",
    "train_tokens_per_sec":
        "token throughput over the last window (time-series batches)",
    "train_score": "latest training score (loss)",
    "train_steps_total": "cumulative training steps observed",
    "train_nonfinite_grads":
        "cumulative count of non-finite gradient elements seen",
    "train_early_stop": "early-stopping terminations fired",
}

#: Gradient-health leaf names, in the order every producer emits them.
HEALTH_KEYS = ("grad_norm", "update_ratio", "param_norm",
               "nonfinite_grads")

#: Norm-valued histograms span 1e-8 .. 1e4 (4 log buckets/decade): grad
#: and param norms roam far outside the latency default of 100us..100s.
VALUE_BOUNDS = tuple(10.0 ** (e / 4.0) for e in range(-32, 17))


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


def _host(a) -> np.ndarray:
    """A tensor on any device, or anything numpy takes, as float64."""
    if isinstance(a, torch.Tensor):
        return a.detach().double().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def host_grad_health(grad, x_old, x_new) -> Dict[str, float]:
    """Gradient health of one solver iteration (``optimize/solver.py``)
    from its flat vectors, as host floats: the solver loop reads the
    score every iteration anyway."""
    g, new = _host(grad), _host(x_new)
    param_norm = float(np.linalg.norm(new))
    return {
        "grad_norm": float(np.linalg.norm(g)),
        "update_ratio": float(np.linalg.norm(new - _host(x_old))
                              / max(param_norm, 1e-12)),
        "param_norm": param_norm,
        "nonfinite_grads": float(np.count_nonzero(~np.isfinite(g))),
    }


def fetch_health(health) -> Optional[Dict[str, List[float]]]:
    """A recorded health payload as ``{key: [floats]}``: a dict of
    0-dim tensors or floats, a dict of [K] per-step tensors (a
    ``fit_scan`` window), a zero-argument callable producing either, or
    None. The device read happens here, at the consumer's sync."""
    if health is None:
        return None
    if callable(health):
        health = health()
    if health is None:
        return None
    return {key: [float(v) for v in _host(value).ravel()]
            for key, value in health.items()}


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


class MetricsLog:
    """Append-only JSONL metrics sink for headless training runs: one
    JSON object a line; ``write`` is thread-safe and flushes, so a
    crashed run keeps every completed record. ``MetricsLog.read(path)``
    returns the records, skipping a torn final line."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")

    def write(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, sort_keys=True)
        with self._lock:
            if self._f.closed:
                raise ValueError(f"MetricsLog {self.path} is closed")
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self) -> "MetricsLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def read(path: str) -> List[Dict[str, Any]]:
        records = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    break  # torn tail from a hard crash
        return records
