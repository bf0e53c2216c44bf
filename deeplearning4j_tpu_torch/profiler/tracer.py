"""The streaming :class:`Histogram` track type the serving engine's
distributions ride on.

A copy of ``Histogram`` from ``deeplearning4j_tpu/profiler/tracer.py``
(free of JAX there too). The span tracer and its device trace hook are
ported with the gateway.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import List, Optional, Tuple


class Histogram:
    """Streaming histogram over FIXED log-spaced bucket bounds:
    constant memory however many values flow through, thread-safe
    ``observe``, quantile estimation, and Prometheus ``histogram``
    exposition — the track type behind the serving engine's TTFT /
    inter-token-latency distributions (serving/engine.py), where a
    last-value gauge cannot answer "what is p99 under load".

    The default bounds span 100 µs … 100 s at four buckets per decade
    (latency seconds); any strictly-increasing bound list works. A
    value lands in the first bucket whose upper bound is >= it
    (Prometheus ``le`` semantics — a value exactly on a bound belongs
    to that bound's bucket); values above the top bound land in the
    implicit ``+Inf`` bucket. ``quantile`` interpolates linearly
    inside the winning bucket, so its error is bounded by one bucket
    width — the classic HdrHistogram/Prometheus tradeoff."""

    #: 100 µs .. 100 s, four log-spaced buckets per decade (25 bounds
    #: + the implicit +Inf bucket). Wide enough for queue waits under
    #: heavy shedding, fine enough that p50/p99 are meaningful.
    DEFAULT_BOUNDS = tuple(10.0 ** (e / 4.0) for e in range(-16, 9))

    __slots__ = ("bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, bounds=None):
        bounds = tuple(float(b) for b in
                       (self.DEFAULT_BOUNDS if bounds is None
                        else bounds))
        if not bounds or any(b2 <= b1 for b1, b2
                             in zip(bounds, bounds[1:])):
            raise ValueError(
                "histogram bounds must be non-empty and strictly "
                f"increasing; got {bounds!r}")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # [-1] = +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float, n: int = 1) -> None:
        """Record ``value`` (``n`` times — one lock acquisition for a
        round's worth of identical per-token gaps, so the serving hot
        path pays O(1) per round, not O(decode_chunk))."""
        value = float(value)
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += n
            self._sum += value * n
            self._count += n

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def snapshot(self) -> Tuple[List[int], float, int]:
        """Consistent (per-bucket counts, sum, count) triple."""
        with self._lock:
            return list(self._counts), self._sum, self._count

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (0 <= q <= 1): find the bucket
        holding the target rank, interpolate linearly inside it (the
        +Inf bucket clamps to the top bound). NaN with no
        observations."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        counts, _, total = self.snapshot()
        if total == 0:
            return math.nan
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            if c and cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = (self.bounds[i] if i < len(self.bounds)
                      else self.bounds[-1])
                return lo + (hi - lo) * max(rank - cum, 0.0) / c
            cum += c
        return self.bounds[-1]

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s observations into this histogram,
        bucket-wise (the fleet-metrics federation primitive: N
        replicas' ``serving_ttft_s`` families merge into one
        fleet-wide distribution whose quantiles are exact at
        bucket resolution, because histograms with IDENTICAL bounds
        are closed under addition). Raises ``ValueError`` when the
        bound lists differ — adding counts across mismatched buckets
        would silently misplace mass, the one failure mode a
        federation layer must reject rather than absorb. Returns
        ``self``."""
        if not isinstance(other, Histogram):
            raise TypeError(
                f"cannot merge {type(other).__name__} into Histogram")
        if self.bounds != other.bounds:
            raise ValueError(
                "histogram bound mismatch: cannot merge "
                f"{len(other.bounds)} bounds "
                f"[{other.bounds[0]:g}..{other.bounds[-1]:g}] into "
                f"{len(self.bounds)} bounds "
                f"[{self.bounds[0]:g}..{self.bounds[-1]:g}]")
        counts, total_sum, total = other.snapshot()
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._sum += total_sum
            self._count += total
        return self

    def prometheus_lines(self, name: str,
                         help_text: Optional[str] = None,
                         labels: Optional[str] = None,
                         header: bool = True) -> List[str]:
        """Prometheus text-format exposition: cumulative
        ``_bucket{le=...}`` samples (monotone by construction), the
        ``+Inf`` bucket equal to ``_count``, plus ``_sum`` and
        ``_count``. ``labels`` (the per-tenant histogram copies) is a
        brace-less label fragment (``tenant="a"``) prepended to every
        bucket's ``le`` and wrapped around
        ``_sum``/``_count``; ``header=False`` suppresses the
        ``# HELP``/``# TYPE`` comments so several label sets of one
        family can share a single header."""
        counts, total_sum, total = self.snapshot()
        lines = []
        if header:
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} histogram")
        pre = f"{labels}," if labels else ""
        suffix = f"{{{labels}}}" if labels else ""
        cum = 0
        for bound, c in zip(self.bounds, counts):
            cum += c
            lines.append(f'{name}_bucket{{{pre}le='
                         f'"{format(bound, ".6g")}"}} {cum}')
        lines.append(f'{name}_bucket{{{pre}le="+Inf"}} {total}')
        lines.append(f"{name}_sum{suffix} {repr(float(total_sum))}")
        lines.append(f"{name}_count{suffix} {total}")
        return lines
