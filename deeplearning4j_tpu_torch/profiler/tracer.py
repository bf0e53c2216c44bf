"""Host-side span tracer (Chrome trace format), its Prometheus
exposition and fleet federation, the streaming :class:`Histogram` track
type the serving engine's latency distributions ride on, and a device
trace hook.

A copy of ``deeplearning4j_tpu/profiler/tracer.py`` (free of JAX there
too, apart from its device trace) with imports rewritten:
``device_trace`` records the card with ``torch.profiler`` and writes a
Chrome trace into ``log_dir`` instead of calling ``jax.profiler``.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.optimize.listeners import IterationListener


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


def _sanitize_metric_name(name: str) -> str:
    """Prometheus metric-name charset ([a-zA-Z0-9_:], no leading
    digit) — shared by :meth:`Tracer.prometheus_text` and the fleet
    federation (:meth:`Tracer.merge_prometheus`), which must agree on
    sanitization or federated families would silently fork."""
    safe = "".join(c if (c.isalnum() or c in "_:") else "_"
                   for c in name)
    if safe and safe[0].isdigit():
        safe = "_" + safe
    return safe


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _split_labeled_name(name: str
                        ) -> Tuple[str, Optional[str]]:
    """``'fam{a="x",b="y"}'`` → ``('fam', 'a="x",b="y"')``; a plain
    name → ``(name, None)`` — the track-naming convention labeled
    samples ride (per-shard gauges, per-tenant
    histograms)."""
    if "{" in name and name.endswith("}"):
        return (name[:name.index("{")],
                name[name.index("{") + 1:-1])
    return name, None


def _parse_label_pairs(labels: str) -> List[Tuple[str, str]]:
    """``'a="x",le="0.1"'`` → ``[("a", "x"), ("le", "0.1")]``.
    Values keep their escape sequences verbatim (re-serializing a
    pair reproduces the input), so escaped quotes/commas inside a
    label value cannot tear the parse."""
    pairs: List[Tuple[str, str]] = []
    i, n = 0, len(labels)
    while i < n:
        eq = labels.find("=", i)
        if eq < 0:
            break
        key = labels[i:eq].strip().strip(",").strip()
        j = labels.find('"', eq)
        if j < 0:
            break
        j += 1
        buf: List[str] = []
        while j < n:
            c = labels[j]
            if c == "\\" and j + 1 < n:
                buf.append(labels[j:j + 2])
                j += 2
                continue
            if c == '"':
                break
            buf.append(c)
            j += 1
        pairs.append((key, "".join(buf)))
        i = j + 1
        while i < n and labels[i] in ", ":
            i += 1
    return pairs


def _canonical_labels(pairs: List[Tuple[str, str]]
                      ) -> Optional[str]:
    """Sorted, re-serialized label fragment (``le`` excluded by the
    callers) — the stable key labeled histogram series merge
    under."""
    if not pairs:
        return None
    return ",".join(f'{k}="{v}"' for k, v in sorted(pairs))


#: parsed shape of one replica's exposition text (module-level so the
#: fleet tools and tests share it): ``types``/``help`` keyed by family
#: name, ``histograms`` as ``{name: {"les": [str], "cums": [int],
#: "sum": float, "count": int}}``, ``scalars`` as ``{name: float}``.
def parse_exposition(text: str) -> Dict[str, Any]:
    """Parse Prometheus text-format exposition (the subset
    :meth:`Tracer.prometheus_text` emits: unlabeled scalar samples,
    ``# TYPE``/``# HELP`` comments, and histogram families with
    ``le``-labeled buckets) into a merge-friendly structure.

    Histogram families whose buckets carry labels BESIDE ``le``
    (the per-tenant ``family{tenant="..."}`` copies) land
    under the family's ``"labeled"`` sub-dict, keyed by the
    canonical (sorted) label fragment, each with its own
    ``les``/``cums``/``sum``/``count``. Federation satellites whose
    label set includes ``replica`` (the marker
    :meth:`Tracer.merge_prometheus` stamps on per-replica copies)
    are still dropped — the unlabeled fleet family and the fleet's
    per-label-set merges already carry those values."""
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    hists: Dict[str, Dict[str, Any]] = {}
    scalars: Dict[str, float] = {}

    def hist_of(family: str,
                labels: Optional[str] = None) -> Dict[str, Any]:
        fam = hists.setdefault(
            family, {"les": [], "cums": [], "sum": 0.0, "count": 0,
                     "labeled": {}})
        if labels is None:
            return fam
        return fam["labeled"].setdefault(
            labels, {"les": [], "cums": [], "sum": 0.0, "count": 0})

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) >= 4:
                types[parts[2]] = parts[3]
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) >= 4:
                helps[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        name = name.strip()
        if not name:
            continue
        if "{" in name and name.endswith("}"):
            base, labelstr = _split_labeled_name(name)
            pairs = _parse_label_pairs(labelstr or "")
            le = next((v for k, v in pairs if k == "le"), None)
            rest = [(k, v) for k, v in pairs if k != "le"]
            replica_tagged = any(k == "replica" for k, _ in rest)
            restkey = _canonical_labels(rest)
            fam = next((base[:-len(s)] for s in ("_bucket", "_sum",
                                                 "_count")
                        if base.endswith(s)), None)
            is_hist = fam is not None and (
                fam in hists or types.get(fam) == "histogram")
            if (base.endswith("_bucket") and le is not None
                    and not replica_tagged):
                family = base[:-len("_bucket")]
                try:
                    h = hist_of(family, restkey)
                    h["les"].append(le)
                    h["cums"].append(int(float(value)))
                except ValueError:
                    pass
                continue
            if is_hist:
                # histogram satellites: per-label-set `_sum`/`_count`
                # (tenant copies) fold into their labeled
                # series; `replica=`-tagged federation copies drop —
                # the unlabeled fleet family (and the fleet's
                # per-label-set merges) already carry those values
                if restkey is not None and not replica_tagged \
                        and not base.endswith("_bucket"):
                    key = "sum" if base.endswith("_sum") else "count"
                    try:
                        h = hist_of(fam, restkey)
                        h[key] = (float(value) if key == "sum"
                                  else int(float(value)))
                    except ValueError:
                        pass
                continue
            # labeled non-bucket samples: keep gauge-style labeled
            # samples (the per-shard gauges, the
            # per-tenant counters) keyed by their FULL labeled name
            try:
                scalars[name] = float(value)
            except ValueError:
                pass
            continue
        try:
            fval = float(value)
        except ValueError:
            continue
        for suffix, key in (("_sum", "sum"), ("_count", "count")):
            family = name[:-len(suffix)] if name.endswith(suffix) \
                else None
            if family and (family in hists
                           or types.get(family) == "histogram"):
                hist_of(family)[key] = (fval if key == "sum"
                                        else int(fval))
                break
        else:
            scalars[name] = fval
    return {"types": types, "help": helps, "histograms": hists,
            "scalars": scalars}


class Tracer:
    """Record named spans/counters; dump Chrome trace-event JSON.

    Usage::

        tracer = Tracer()
        with tracer.span("load_batch"):
            ...
        tracer.counter("score", 0.42)
        tracer.save("trace.json")
    """

    #: ``max_events=None`` keeps every event (the Chrome-trace use
    #: case: finite runs you dump with ``save``). A long-lived SERVER
    #: (the serving gateway attaches a tracer for /v1/metrics) passes
    #: a cap: when the buffer fills, the oldest half is dropped —
    #: counter tracks stay correct because ``latest_counters`` reads
    #: the O(#tracks) last-value table, not the event log.
    def __init__(self, max_events: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._cum: Dict[str, float] = {}
        self._last: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        self._help: Dict[str, str] = {}
        self.max_events = max_events
        #: events evicted by the cap (or ``clear``) so far: the
        #: absolute sequence number of ``_events[i]`` is
        #: ``_dropped + i`` — a monotone cursor remote scrapers
        #: (the router's incremental trace cache) resume
        #: from without re-downloading the whole window
        self._dropped = 0
        self._t0 = time.perf_counter()

    def _push(self, event: Dict[str, Any]) -> None:
        """Append one event under the caller-held lock, enforcing the
        ``max_events`` cap (drop-oldest-half, amortized O(1))."""
        self._events.append(event)
        if (self.max_events is not None
                and len(self._events) > self.max_events):
            half = len(self._events) // 2
            del self._events[:half]
            self._dropped += half

    def _us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def now_us(self) -> float:
        return self._us()

    def complete(self, name: str, start_us: float, duration_us: float,
                 **args: Any) -> None:
        """Append a completed span recorded by the caller."""
        with self._lock:
            self._push({
                "name": name, "ph": "X", "ts": start_us,
                "dur": duration_us, "pid": os.getpid(),
                "tid": threading.get_ident() % 2 ** 31, "args": args,
            })

    @contextlib.contextmanager
    def span(self, name: str, **args: Any):
        start = self._us()
        try:
            yield
        finally:
            end = self._us()
            with self._lock:
                self._push({
                    "name": name, "ph": "X", "ts": start,
                    "dur": end - start, "pid": os.getpid(),
                    "tid": threading.get_ident() % 2 ** 31,
                    "args": args,
                })

    def instant(self, name: str, scope: str = "t",
                **args: Any) -> None:
        """Zero-duration marker. ``scope`` is the Chrome trace-event
        instant scope: ``"t"`` (thread — the default; renders as a
        tick on the emitting thread's row), ``"p"`` (process — a line
        across the whole lane) or ``"g"`` (global). Lane-wide events
        — breaker transitions, fleet scale decisions —
        pass ``"p"`` so they read against EVERY row of the lane they
        affect, not just the control thread that noticed."""
        if scope not in ("t", "p", "g"):
            raise ValueError(f"instant scope {scope!r} not in t/p/g")
        with self._lock:
            self._push({
                "name": name, "ph": "i", "ts": self._us(),
                "pid": os.getpid(),
                "tid": threading.get_ident() % 2 ** 31, "s": scope,
                "args": args,
            })

    def counter(self, name: str, value: float) -> None:
        with self._lock:
            self._last[name] = value
            self._push({
                "name": name, "ph": "C", "ts": self._us(),
                "pid": os.getpid(), "args": {name: value},
            })

    def gauge(self, name: str, value: float) -> None:
        """Update a track's LAST VALUE without pushing an event. The
        scrape-path counterpart of :meth:`counter`: a ``/v1/metrics``
        handler refreshing per-scrape gauges (serving/gateway.py) must
        not append to the capped event log — a tight scrape loop would
        otherwise evict real span history."""
        with self._lock:
            self._last[name] = float(value)

    def drop_gauge(self, name: str) -> bool:
        """Retire a last-value track: the name stops appearing in
        :meth:`prometheus_text` until something writes it again
        (a tenant whose open-request count
        dropped to zero must not freeze its per-tenant gauges at the
        last sample forever). Returns True when the track existed.
        Event history is untouched — only the scrape table forgets."""
        with self._lock:
            return self._last.pop(name, None) is not None

    def rate(self, name: str, count: float, seconds: float) -> None:
        """Counter expressed as events/sec over a measured window —
        the serving engine's tokens/sec stream
        (serving/engine.py)."""
        self.counter(name, count / max(seconds, 1e-9))

    def incr(self, name: str, delta: float = 1.0) -> float:
        """Cumulative event counter: each call adds ``delta`` to the
        track's running total, emits the new value, and RETURNS it, so
        sparse events (the serving engine's deadline expiries, sheds,
        quarantines, retries — serving/engine.py failure events) read
        as monotone step functions in the trace without the caller
        keeping its own totals — and a caller branching on the total
        (rate limiters, test assertions) needn't re-read the track."""
        with self._lock:
            self._cum[name] = self._cum.get(name, 0.0) + delta
            value = self._cum[name]
        self.counter(name, value)
        return value

    def describe(self, name: str, help_text: str) -> None:
        """Attach a human-readable description to a track;
        :meth:`prometheus_text` emits it as the metric's ``# HELP``
        line (the serving engine describes its tracks at init)."""
        with self._lock:
            self._help[name] = " ".join(str(help_text).split())

    # -- histogram tracks ------------------------------------
    def observe(self, name: str, value: float, n: int = 1,
                bounds=None) -> Histogram:
        """Record one value (``n`` times) into the named
        :class:`Histogram` track, creating it on first use (``bounds``
        applies only then). Unlike :meth:`counter` this pushes no
        event: the histogram IS the aggregate, so high-frequency
        observations (every token's latency) cost O(1) memory."""
        hist = self._hists.get(name)
        if hist is None:
            with self._lock:
                hist = self._hists.setdefault(name, Histogram(bounds))
        hist.observe(value, n)
        return hist

    def register_histogram(self, name: str,
                           hist: Histogram) -> Histogram:
        """Adopt an externally-owned :class:`Histogram` as a track
        (the serving engine owns its latency histograms — works with
        ``tracer=None`` — and registers them here so
        :meth:`prometheus_text` exports them by reference, no double
        bookkeeping)."""
        with self._lock:
            self._hists[name] = hist
        return hist

    def drop_histogram(self, name: str) -> bool:
        """Retire a registered histogram track (the labeled-twin
        counterpart of :meth:`drop_gauge` — a
        retired tenant's ``family{tenant=...}`` histogram families
        must stop scraping, not freeze forever). Returns True when
        the track existed."""
        with self._lock:
            return self._hists.pop(name, None) is not None

    def histogram(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(name)

    def histograms(self) -> Dict[str, Histogram]:
        with self._lock:
            return dict(self._hists)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def events_since(self, seq: int
                     ) -> Tuple[List[Dict[str, Any]], int]:
        """Incremental read: the events at absolute
        sequence >= ``seq`` plus the NEXT cursor to resume from, so a
        periodic scraper (the router's per-replica trace cache) pays
        only for what is new instead of re-serializing the whole
        window each tick. A cursor from before the cap dropped events
        resumes at the oldest retained event; a cursor from a
        different tracer lifetime (``seq`` beyond the end — the
        server restarted or ``clear``ed) restarts from 0."""
        with self._lock:
            end = self._dropped + len(self._events)
            if seq > end:
                seq = 0  # foreign/stale cursor: full window
            lo = max(int(seq) - self._dropped, 0)
            return list(self._events[lo:]), end

    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [e for e in self.events()
                if e["ph"] == "X" and (name is None or e["name"] == name)]

    def counter_values(self, name: str) -> List[float]:
        """All values recorded for one counter track, in order — the
        in-process assertion hook for serving observability (e.g. the
        chunked-admission stall bound: every
        ``serving_round_prefill_chunks`` sample must stay within the
        scheduler's budget)."""
        return [e["args"][name] for e in self.events()
                if e["ph"] == "C" and e["name"] == name]

    def latest_counters(self) -> Dict[str, float]:
        """Final value of every counter track (a serving run's
        end-state snapshot: admitted, evicted, prefix hits/misses,
        chunks scheduled, tokens decoded, ...). Reads the O(#tracks)
        last-value table, NOT the event log — a /v1/metrics scrape
        stays cheap however long the server has been up."""
        with self._lock:
            return dict(self._last)

    def prometheus_text(self, prefix: Optional[str] = None) -> str:
        """Prometheus exposition-format text for every counter track
        (the serving gateway's ``GET /v1/metrics`` body). Cumulative
        tracks fed through :meth:`incr` (the serving failure events)
        are typed ``counter``; everything else (occupancy, rates,
        budgets) is a ``gauge``. ``prefix`` filters track names (e.g.
        ``"serving_"``). Names are sanitized to the metric charset
        ([a-zA-Z0-9_:]); tracks sharing a sanitized name keep their
        latest value. Tracks with a :meth:`describe` description get a
        ``# HELP`` line; :class:`Histogram` tracks render as
        Prometheus ``histogram`` families
        (``_bucket``/``_sum``/``_count``)."""
        latest = self.latest_counters()
        with self._lock:
            cumulative = set(self._cum)
            hists = dict(self._hists)
            helps = dict(self._help)

        sanitize = _sanitize_metric_name

        # histogram tracks group into FAMILIES keyed by sanitized
        # base name: a track named ``family{tenant="a"}`` (the
        # the per-tenant latency copies) is a LABELED series of the
        # ``family`` metric, sharing one TYPE/HELP header with the
        # unlabeled series and any sibling label sets
        hist_fams: Dict[str, Dict[Optional[str],
                                  Tuple[str, Histogram]]] = {}
        for name in sorted(hists):
            if prefix is None or name.startswith(prefix):
                base, labels = _split_labeled_name(name)
                hist_fams.setdefault(sanitize(base), {})[labels] = (
                    name, hists[name])
        # collapse tracks whose names sanitize to the same metric name
        # (sorted order ⇒ the lexically-last raw name wins): Prometheus
        # rejects an entire scrape over one duplicate sample. A track
        # named ``family{label="v"}`` (the per-shard gauges:
        # ``serving_blocks_free{shard="0"}``) emits as a LABELED sample
        # of the ``family`` metric — the same labeling scheme the fleet
        # federation uses for ``{replica=...}`` — so one family carries
        # several samples and HELP/TYPE render once.
        merged: Dict[str, Dict[Optional[str],
                               Tuple[str, float, Optional[str]]]] = {}
        for name in sorted(latest):
            if prefix is not None and not name.startswith(prefix):
                continue
            base, labels = name, None
            if "{" in name and name.endswith("}"):
                base = name[:name.index("{")]
                labels = name[name.index("{"):]
            safe = sanitize(base)
            if safe in hist_fams:  # the histogram family owns the name
                continue
            kind = "counter" if name in cumulative else "gauge"
            merged.setdefault(safe, {})[labels] = (
                kind, latest[name], helps.get(name, helps.get(base)))
        lines: List[str] = []
        for safe in sorted(merged):
            samples = merged[safe]
            kind, _, help_text = next(iter(samples.values()))
            if help_text:
                lines.append(f"# HELP {safe} {help_text}")
            lines.append(f"# TYPE {safe} {kind}")
            for labels in sorted(samples, key=lambda v: v or ""):
                _, value, _ = samples[labels]
                text = ("%d" % value if float(value).is_integer()
                        else repr(float(value)))
                lines.append(f"{safe}{labels or ''} {text}")
        for safe in sorted(hist_fams):
            series = hist_fams[safe]
            raw0 = next(iter(series.values()))[0]
            base0 = _split_labeled_name(raw0)[0]
            help_text = helps.get(base0, helps.get(raw0))
            first = True
            # unlabeled series first, then label sets in sorted order
            for labels in sorted(series,
                                 key=lambda v: (v is not None,
                                                v or "")):
                _, hist = series[labels]
                lines.extend(hist.prometheus_lines(
                    safe, help_text if first else None,
                    labels=labels, header=first))
                first = False
        return "\n".join(lines) + ("\n" if lines else "")

    @staticmethod
    def merge_prometheus(sources: Dict[str, str]) -> str:
        """Federate N replicas' exposition texts (``{replica_id:
        prometheus_text}``) into ONE fleet exposition (
        tentpole — the router's ``GET /v1/fleet/metrics`` body):

        - **histogram** families merge bucket-wise into an unlabeled
          fleet family (quantiles over the merged family answer
          "fleet p99", exactly what one replica's family answers for
          one replica), PLUS per-replica ``{replica="<id>"}``-labeled
          bucket/sum/count samples so one scrape carries both views.
          Families whose ``le`` bound lists differ across replicas
          raise ``ValueError`` — bucket-wise addition across
          mismatched bounds would silently misplace mass
          (:meth:`Histogram.merge` enforces the same contract
          in-process).
        - **counter** families sum to one unlabeled fleet total
          (counters are rates-in-waiting; sums are meaningful).
        - **gauge** (and untyped) families emit ONLY per-replica
          ``{replica="<id>"}``-labeled samples: a summed queue depth
          across replicas is occasionally meaningful, a summed round
          time never is — and before this existed, same-named gauges
          from different replicas collided after name sanitization
          into last-writer-wins.

        ``# HELP`` survives (first replica's text wins); names are
        sanitized with the same rule :meth:`prometheus_text` uses, so
        a federated family can never fork from its per-replica
        original."""
        parsed = {rid: parse_exposition(text)
                  for rid, text in sources.items()}
        # family name -> kind/help, first-seen order preserved
        kinds: Dict[str, str] = {}
        helps: Dict[str, str] = {}
        order: List[str] = []

        def note(name: str, kind: str, p: Dict[str, Any]) -> None:
            safe = _sanitize_metric_name(name)
            if safe not in kinds:
                kinds[safe] = kind
                order.append(safe)
            if safe not in helps and name in p["help"]:
                helps[safe] = p["help"][name]

        # histogram families first (they own their names, same as
        # prometheus_text), then scalars
        hist_parts: Dict[str, Dict[str, Dict[str, Any]]] = {}
        scalar_parts: Dict[str, Dict[str, float]] = {}
        for rid, p in parsed.items():
            for name, h in p["histograms"].items():
                note(name, "histogram", p)
                hist_parts.setdefault(
                    _sanitize_metric_name(name), {})[rid] = h
            for name, value in p["scalars"].items():
                # a labeled sample (`family{shard="0"}`) rides under
                # its base family's TYPE/HELP; the label string stays
                # verbatim on the federated sample
                base, labels = name, ""
                if "{" in name and name.endswith("}"):
                    base = name[:name.index("{")]
                    labels = name[name.index("{") + 1:-1]
                safe = _sanitize_metric_name(base)
                if safe in hist_parts:
                    continue
                kind = p["types"].get(base, "gauge")
                note(base, kind, p)
                scalar_parts.setdefault(safe, {})[(rid, labels)] = value
        lines: List[str] = []
        for safe in order:
            kind = kinds[safe]
            if safe in helps:
                lines.append(f"# HELP {safe} {helps[safe]}")
            lines.append(f"# TYPE {safe} {kind}")
            if kind == "histogram":
                parts = hist_parts[safe]
                # every series — the unlabeled one plus each labeled
                # set (the per-tenant copies) — must share ONE
                # bound list before any bucket-wise addition
                les = None
                for rid, h in parts.items():
                    for series in ([h]
                                   + list(h.get("labeled",
                                                {}).values())):
                        if not series["les"]:
                            continue
                        if les is None:
                            les = list(series["les"])
                        elif list(series["les"]) != les:
                            raise ValueError(
                                f"histogram {safe!r}: replica "
                                f"{rid!r} bounds "
                                f"{series['les'][:3]}.."
                                f"x{len(series['les'])} mismatch "
                                f"the fleet's {les[:3]}..x{len(les)}"
                                " — refusing a bucket-wise merge "
                                "across mismatched bounds")

                def emit_series(cums, total_sum, total, labels):
                    pre = f"{labels}," if labels else ""
                    suffix = f"{{{labels}}}" if labels else ""
                    for le, cum in zip(les or (), cums):
                        lines.append(
                            f'{safe}_bucket{{{pre}le="{le}"}} {cum}')
                    lines.append(
                        f"{safe}_sum{suffix} "
                        f"{repr(float(total_sum))}")
                    lines.append(f"{safe}_count{suffix} {total}")

                def folded(series_list):
                    cums = [0] * len(les or ())
                    s, n = 0.0, 0
                    for series in series_list:
                        for i, c in enumerate(series["cums"]):
                            cums[i] += c
                        s += series["sum"]
                        n += series["count"]
                    return cums, s, n

                # fleet-wide: the unlabeled merge, then one merged
                # series PER label set (so "premium's fleet p99" is
                # one histogram_quantile away, same as the fleet's)
                if any(h["les"] for h in parts.values()):
                    emit_series(*folded([h for h in parts.values()
                                         if h["les"]]), labels=None)
                labelsets = sorted({
                    ls for h in parts.values()
                    for ls in h.get("labeled", {})})
                for ls in labelsets:
                    emit_series(*folded(
                        [h["labeled"][ls] for h in parts.values()
                         if ls in h.get("labeled", {})]), labels=ls)
                # per-replica copies: ``{replica=...}`` for the
                # unlabeled series, ``{replica=...,<labels>}`` for
                # each labeled set
                for rid, h in parts.items():
                    lab = f'replica="{_escape_label(rid)}"'
                    if h["les"]:
                        emit_series(h["cums"], h["sum"], h["count"],
                                    labels=lab)
                    for ls in sorted(h.get("labeled", {})):
                        series = h["labeled"][ls]
                        emit_series(series["cums"], series["sum"],
                                    series["count"],
                                    labels=f"{lab},{ls}")
            elif kind == "counter":
                # sum per label set: an unlabeled counter sums to one
                # fleet total; labeled counters sum within each label
                # combination
                by_labels: Dict[str, float] = {}
                for (rid, labels), value in (
                        scalar_parts[safe].items()):
                    by_labels[labels] = by_labels.get(labels, 0.0) \
                        + value
                for labels in sorted(by_labels):
                    total = by_labels[labels]
                    text = ("%d" % total if float(total).is_integer()
                            else repr(float(total)))
                    suffix = f"{{{labels}}}" if labels else ""
                    lines.append(f"{safe}{suffix} {text}")
            else:
                for (rid, labels), value in (
                        scalar_parts[safe].items()):
                    text = ("%d" % value
                            if float(value).is_integer()
                            else repr(float(value)))
                    lab = f'replica="{_escape_label(rid)}"'
                    if labels:
                        lab += f",{labels}"
                    lines.append(f"{safe}{{{lab}}} {text}")
        return "\n".join(lines) + ("\n" if lines else "")

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events()}, f)

    def clear(self) -> None:
        with self._lock:
            self._dropped += len(self._events)  # cursors stay monotone
            self._events.clear()
            self._cum.clear()
            self._last.clear()
            self._hists.clear()  # descriptions survive: they are
            #                      registrations, not measurements


class ProfilerIterationListener(IterationListener):
    """Feeds iteration timing + score into a Tracer via the standard
    listener hook (the reference's only observability channel,
    BaseOptimizer.java:218)."""

    def __init__(self, tracer: Tracer, frequency: int = 1):
        self.tracer = tracer
        self.invoked_every = frequency
        self._last_ts: Optional[float] = None

    def iteration_done(self, model, iteration: int) -> None:
        now = self.tracer.now_us()
        if self._last_ts is not None:
            self.tracer.complete("iteration", self._last_ts,
                                 now - self._last_ts, iteration=iteration)
        self._last_ts = now
        self.tracer.counter("score", float(model.score_value))


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Device-level profiling of the block with ``torch.profiler``
    (CPU and, when the card is present, CUDA activities), written as a
    Chrome trace (``trace.json``) into ``log_dir`` on exit; the block's
    ``torch.profiler.profile`` is yielded (``key_averages()`` for a
    table). Where the profiler cannot start (a build without it) the
    block runs unprofiled and ``None`` is yielded."""
    import torch

    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception:
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
