"""Multi-replica serving router: a failure-tolerant, prefix-aware
front door over N :class:`~deeplearning4j_tpu_torch.serving.ServingGateway`
replicas.

A copy of ``deeplearning4j_tpu/serving/router.py`` with imports
rewritten. Its wire surface (the endpoints, the SSE event ids, the
DKV1 warm import, the journal) is the JAX package's, so either
package's gateway can sit behind it, in one fleet.

One gateway owns one engine; millions of users need horizontal scale,
and horizontal scale means replicas DIE — a process crash today loses
every in-flight stream that replica owned. The router lifts the
guarantees proved inside one process (seeded fault recovery,
drain-to-snapshot restore finishing bit-identical ids, per-request
``delta_sent`` high-water dedup) across process boundaries, the same
replay-on-survivor discipline vLLM-style fleets and Orca-style
continuous-batching servers need once they go horizontal:

**Health & liveness.** A background loop scrapes every replica's
``/v1/healthz`` (each tick) and ``/v1/metrics`` (every few ticks),
feeding a per-replica state machine::

        live ──failure──▶ degraded ──threshold──▶ dead
         ▲                   │                      │
         │◀────success───────┘          probe every probe_interval_s
         │                                          ▼
         └──────────probe succeeds────────── half-open

Consecutive failures (health scrapes AND data-plane stream breaks both
count) trip the circuit breaker at ``failure_threshold``; a dead
replica gets one half-open probe per ``probe_interval_s`` and rejoins
on success. A 429 + ``Retry-After`` from a replica is BACKPRESSURE,
not failure: the replica is healthy and said "later" — the router
parks it until the hint expires and routes the request to a sibling
instead of making the client wait.

**Prefix-affinity routing.** Shared-system-prompt traffic only pays
off when it lands where its radix/block cache is warm. The router
hashes the prompt's leading block-aligned tokens
(``affinity_block_tokens``-sized, matching the paged engine's block
granularity) and RENDEZVOUS-hashes (highest-random-weight) that key
against the live replica ids: every replica scores
``hash(prefix_key, replica_id)`` and the max wins, so replica death
remaps ONLY the dead replica's keyspace — survivors keep their warm
sets, unlike modular hashing where one death reshuffles everyone.
Prompts shorter than one block (no reusable prefix worth chasing)
fall back to queue-depth-weighted least-loaded using the scraped
per-replica load.

**The robustness core: journal + replay.** Every proxied request is
journaled (id, prompt, params, owning replica, streamed-token
high-water mark) and relayed through the router as SSE deltas — even
blocking client calls ride an internal stream, so the journal's
high-water mark is always live. When a replica dies mid-request (or a
drain hands its unfinished work back), the relay loop replays the
request onto a survivor: the FULL prompt is resubmitted (recompute
replay, the vLLM-preemption discipline — deterministic greedy decode
regenerates the same ids), the journal's high-water mark dedups the
already-streamed prefix (each regenerated token is CHECKED against the
streamed one, then discarded), and the client's stream resumes
bit-identically past where it stopped. Sampling requests that already
streamed tokens terminate ``finish_reason="fault"`` instead — a
redrawn RNG cannot splice onto a streamed prefix (the exact
snapshot/restore contract, now across processes). Graceful scale-down is the same code
path: ``drain_replica`` routes ``/v1/drain`` through the replica,
whose unfinished streams end without a terminal event, and the relay
loops re-admit those requests on survivors.

**Fleet-wide observability.** The router is the
only place that sees a request's WHOLE life across the fleet, so it
is where the fleet's observability lives:

- every journaled request carries a router-minted trace id
  (``r<rid>``) with per-attempt span ids (``a<n>``), propagated to
  the replica as the ``X-DL4J-Trace`` header + JSON ``trace`` field —
  the engine stamps its spans, flight-recorder record, and terminal
  with it;
- ``GET /v1/trace`` answers the STITCHED fleet trace: each replica's
  Chrome-trace window on its own process lane (live fetch when
  reachable, the health loop's incrementally-scraped cache for dead
  replicas — how a SIGKILLed victim's spans survive), skew-corrected
  onto the router clock by per-replica NTP-style offset estimates
  (healthz ``now_us`` sampled inside a timed scrape, error <= RTT/2),
  interleaved with the router's own ``router.route`` /
  ``router.queue_wait`` / ``router.replay`` spans and
  ``router.breaker`` instants — a failover reads as one request's
  monotone timeline spanning two replicas;
- ``GET /v1/fleet/metrics`` federates the replicas
  (:meth:`profiler.tracer.Tracer.merge_prometheus`): histograms
  merged bucket-wise + labeled per replica, counters summed, gauges
  labeled, plus the router's ``router_replay_gap_s`` histogram
  (stream break -> first post-replay token);
- ``GET /v1/requests/<id>/trace`` proxies the owner's flight record
  via the journal, or serves journal breadcrumbs with a
  ``replayed_to`` pointer when the owner died.

**Durability.** The journal above is also a
crash ledger: with ``journal_path=`` every open/route/progress/done
transition (plus tenant bucket levels, warm-KV beliefs, and stable
replica ids) is appended to a length+CRC framed write-ahead journal
(serving/journal.py) BEFORE the router acts on it. A SIGKILLed
router restarted against the same file replays its open entries
through the very replay path above — full-prompt resubmit on
whichever replicas answer healthz, the recovered high-water mark
dedupping the regenerated prefix — restores bucket levels (a flooder
stays throttled through the crash) and warm beliefs, and emits a
``router.recover`` span on the stitched trace. Streams carry
monotone SSE event ids (= delivered-token count), so a dropped
client resumes via ``GET /v1/requests/<id>/stream`` +
``Last-Event-ID`` with zero duplicated and zero lost tokens;
``resumable: true`` on the generate body turns client disconnects
into detaches instead of cancels.

The router speaks the gateway's own protocol (``/v1/generate``,
``/v1/requests/<id>``, ``/v1/healthz``, ``/v1/metrics``, SSE framing),
so :class:`~deeplearning4j_tpu_torch.serving.GatewayClient` drives a router
exactly like a single gateway — a one-replica router is bit-identical
to direct gateway access. Stdlib-only, on util/httpjson like the
gateway."""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from deeplearning4j_tpu_torch.serving.client import (
    RETRYABLE_ERRORS,
    GatewayClient,
    GatewayError,
)
from deeplearning4j_tpu_torch.serving.journal import (
    WriteAheadJournal,
    recover_state,
)
from deeplearning4j_tpu_torch.util.httpjson import HttpService, JsonHandler

#: every state a replica can be in, as the router sees it:
#: ``live`` (routable), ``degraded`` (recent failures below the
#: breaker threshold — routable only when nothing live remains),
#: ``draining`` (finishing in-flight work, not routable for new
#: requests), ``dead`` (breaker open — not routable, in-flight
#: requests replayed), ``half-open`` (dead, one probe in flight).
REPLICA_STATES = ("live", "degraded", "draining", "dead", "half-open")


class _NoReplica(RuntimeError):
    """No replica can take the request (everyone dead/draining)."""


class _AllBackedOff(RuntimeError):
    """Every candidate replica is parked behind a 429 Retry-After."""

    def __init__(self, wait_s: float):
        super().__init__(f"all replicas backed off for {wait_s:.1f}s")
        self.wait_s = wait_s


class _ClientGone(Exception):
    """The ROUTER's own client vanished mid-relay (failed SSE write).
    Distinct from replica-side read failures on purpose: a client
    disconnect must cancel the request, never charge the replica's
    breaker or trigger a replay."""


class _RouteAround(Exception):
    """This attempt never started streaming — try another replica
    without charging the replay budget. ``deterministic`` carries a
    terminal to deliver instead when retrying elsewhere would just
    repeat the same rejection (bad params)."""

    def __init__(self, deterministic: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.deterministic = deterministic


class _ReplayDiverged(RuntimeError):
    """A replayed greedy stream produced a token that differs from
    the already-streamed prefix — the survivors are not replicas of
    the dead engine (different weights/seed/config). Never expected
    in a correctly deployed fleet; terminates the request ``fault``
    rather than silently splicing wrong tokens."""


class _Replica:
    """Router-side state of one gateway replica. All mutable fields
    are guarded by the router's lock."""

    def __init__(self, address: str):
        self.address = address.split("://", 1)[-1]
        #: stable identity for rendezvous hashing; replaced by the
        #: replica's self-reported id at the first health scrape
        self.replica_id = self.address
        self.state = "live"  # optimistic until the breaker disagrees
        self.failures = 0
        #: disaggregation role, scraped from healthz:
        #: ``prefill`` replicas prefer admission-heavy traffic and
        #: serve as warm-KV donors, ``decode`` replicas prefer
        #: long-decode streams, ``any`` is the role-blind default
        self.role = "any"
        #: whether the replica can speak the KV transfer plane
        #: (paged engine + prefix trie) — scraped from healthz so a
        #: dense fleet never pays a 404 round-trip per affinity miss
        self.kv_capable = False
        #: resident spill-tier payload count, scraped from
        #: the healthz ``kv_tier`` block: a host/disk-tier-warm
        #: replica serves exports straight from the tier (zero device
        #: work), so the donor pick prefers it over a cold one
        self.kv_tier_entries = 0
        self.backoff_until = 0.0  # 429 Retry-After parking
        #: per-TENANT 429 parking: a replica's
        #: tenant-scoped 429 (its payload names the tenant) parks
        #: only that tenant's keyspace on this replica — other
        #: tenants keep routing here. ``backoff_until`` above stays
        #: the replica-wide park for tenant-blind (global queue
        #: full) backpressure.
        self.tenant_backoff: Dict[str, float] = {}
        self.next_probe_t = 0.0   # half-open probe schedule (dead)
        self.decommissioned = False  # drained away: never resurrected
        # scraped load + affinity figures
        self.queue_depth = 0
        self.active_slots = 0
        self.n_slots = 1
        self.prefix_tokens_reused = 0
        self.requests_routed = 0
        self.open_entries = 0  # journal entries currently assigned
        # -- idempotent drain: the fleet
        # controller and a human operator WILL race on scale-down —
        # the first drain owns the work, every later/concurrent drain
        # waits on the event and returns the first drain's summary
        self.drain_started = False
        self.drain_done = threading.Event()
        self.drain_summary: Optional[Dict[str, Any]] = None
        # -- fleet tracing state ----------------------------
        #: estimated ``replica_tracer_now - router_tracer_now`` in µs,
        #: NTP-style: the replica reports its tracer clock inside a
        #: timed healthz scrape and the midpoint of the scrape window
        #: is the sample point, so the estimate's error is bounded by
        #: half the scrape RTT. The stitcher maps a replica event onto
        #: the router timeline as ``ts - clock_offset_us``.
        self.clock_offset_us: Optional[float] = None
        self.clock_rtt_us = float("inf")
        self.clock_age = 0      # scrapes since the estimate updated
        #: the offset that matches ``trace_cache``'s EPOCH: cached
        #: events and the offset that corrects them must come from
        #: the same process lifetime, so the pair is snapshotted
        #: together at scrape time — the live estimate above may be
        #: reset (death, restart detection) while the cache still
        #: holds the dead epoch's events
        self.cache_offset_us: Optional[float] = None
        #: scraped Chrome-trace window (the replica flight recorder's
        #: fleet-side shadow): when a replica is SIGKILLed its own
        #: tracer dies with it — this cache is the only place the
        #: victim's spans survive, and what puts the dead lane in a
        #: stitched failover trace. Filled INCREMENTALLY
        #: (``?since_seq=`` + the resume cursor below), so the
        #: periodic scrape pays for the delta, not the window.
        self.trace_cache: List[Dict[str, Any]] = []
        self.trace_cache_t = 0.0
        self.trace_seq = 0

    def status(self) -> Dict[str, Any]:
        return {
            "replica_id": self.replica_id,
            "address": self.address,
            "state": self.state,
            "consecutive_failures": self.failures,
            "queue_depth": self.queue_depth,
            "active_slots": self.active_slots,
            "n_slots": self.n_slots,
            "prefix_tokens_reused": self.prefix_tokens_reused,
            "requests_routed": self.requests_routed,
            "open_requests": self.open_entries,
            "decommissioned": self.decommissioned,
            "role": self.role,
            "kv_capable": self.kv_capable,
        }


class _JournalEntry:
    """One proxied request's journal record: everything replay needs
    (prompt + params), plus the streamed-token high-water mark that
    makes replay exactly-once from the client's point of view.
    ``tokens`` IS the high-water mark: every token in it has been
    relayed to the client (or accumulated for a blocking reply), and
    a replayed stream's regenerated prefix is checked against it and
    dropped instead of re-delivered."""

    __slots__ = ("rid", "prompt", "params", "temperature", "tokens",
                 "replays", "cancelled", "done", "result",
                 "replica_address", "replica_rid", "affinity",
                 "history", "submit_t", "trace", "done_t",
                 "replay_t0_us", "replay_hwm", "replay_from",
                 "tenant", "resumable", "recovered")

    def __init__(self, rid: int, prompt: List[int],
                 params: Dict[str, Any], submit_t: float):
        self.rid = rid
        self.prompt = prompt
        self.params = params
        self.temperature = float(params.get("temperature") or 0.0)
        #: tenancy identity — rides ``params`` to the
        #: replica (so failover replay re-bills the same tenant) and
        #: keys the router's per-tenant parking/accounting
        self.tenant = str(params.get("tenant") or "default")
        self.tokens: List[int] = []
        self.replays = 0
        self.cancelled = False
        self.done = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.replica_address: Optional[str] = None
        self.replica_rid: Optional[int] = None
        self.affinity = False
        #: (t_s, event) breadcrumbs: routed/replayed/finished — the
        #: journal's audit trail the chaos soak asserts over
        self.history: List[Tuple[float, str]] = []
        self.submit_t = submit_t
        #: fleet trace id: the router-minted identity every
        #: hop stamps its spans with; per-attempt span ids extend it
        self.trace: Optional[str] = None
        self.done_t: Optional[float] = None
        # open replay window: set when a stream broke and the request
        # is being replayed; closed (-> router.replay span + the
        # router_replay_gap_s observation) by the first POST-replay
        # fresh token, or by the terminal/divergence
        self.replay_t0_us: Optional[float] = None
        self.replay_hwm = 0
        self.replay_from: Optional[str] = None
        #: a resumable stream's client disconnect DETACHES
        #: instead of cancelling — the relay keeps running with a
        #: buffering emit and the client reconnects via
        #: ``GET /v1/requests/<rid>/stream`` + ``Last-Event-ID``
        self.resumable = bool(params.get("resumable"))
        #: rebuilt from the write-ahead journal after a router
        #: restart (open entries re-enter the replay path; done
        #: entries serve polls/resumes from their recovered terminal)
        self.recovered = False

    def note(self, t: float, event: str) -> None:
        self.history.append((round(t, 4), event))


def parse_prometheus(text: str) -> Dict[str, float]:
    """Minimal Prometheus text parse: ``name value`` sample lines to a
    dict (comments/HELP/TYPE skipped, label-carrying and unparsable
    samples ignored). Enough for the gauge tracks the gateway
    exports."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, value = line.partition(" ")
        if "{" in name:
            continue
        try:
            out[name] = float(value)
        except ValueError:
            continue
    return out


class _RouterHandler(JsonHandler):
    """One instance per connection; the owning router rides in as the
    ``router`` class attribute (HttpService)."""

    protocol_version = "HTTP/1.1"
    router: "ServingRouter"

    def do_POST(self):
        path, _, query = self.path.partition("?")
        if path == "/v1/generate":
            stream = "stream=1" in query.split("&")
            self.router._handle_generate(self, stream)
        elif path == "/v1/replicas/drain":
            self.router._handle_drain_replica(self)
        else:
            self.send_json({"error": f"no such endpoint {path}"}, 404,
                           close=True)

    def do_GET(self):
        path, _, query = self.path.partition("?")
        if path == "/v1/healthz":
            self.send_json(self.router._health(), 200, close=True)
        elif path == "/v1/metrics":
            self.send_bytes(self.router._metrics_text().encode(),
                            "text/plain; version=0.0.4", 200,
                            close=True)
        elif path == "/v1/fleet/metrics":
            self.router._handle_fleet_metrics(self)
        elif path == "/v1/trace":
            self.router._handle_fleet_trace(self)
        elif (path.startswith("/v1/requests/")
                and path.endswith("/trace")):
            self.router._handle_request_trace(self, path)
        elif (path.startswith("/v1/requests/")
                and path.endswith("/stream")):
            self.router._handle_stream_resume(self, path, query)
        elif path.startswith("/v1/requests/"):
            self.router._handle_poll(self, path)
        else:
            self.send_json({"error": f"no such endpoint {path}"}, 404,
                           close=True)

    def do_DELETE(self):
        path = self.path.partition("?")[0]
        if path.startswith("/v1/requests/"):
            self.router._handle_cancel(self, path)
        else:
            self.send_json({"error": f"no such endpoint {path}"}, 404,
                           close=True)

    # SSE framing (send_event / send_ping) inherited from JsonHandler


class RouterClient(GatewayClient):
    """GatewayClient plus the router-only admin surface. Generation,
    polling, cancel, healthz, and metrics are the plain gateway
    protocol — this subclass only adds what a single gateway does not
    have."""

    def drain_replica(self, replica_id: str,
                      timeout_s: Optional[float] = None
                      ) -> Dict[str, Any]:
        """Graceful scale-down of one replica through the router:
        drains it, fails its unfinished requests over to survivors,
        and decommissions it."""
        body: Dict[str, Any] = {"replica_id": replica_id}
        if timeout_s is not None:
            body["timeout_s"] = timeout_s
        return self._call("POST", "/v1/replicas/drain", body)

    def fleet_metrics(self) -> str:
        """``GET /v1/fleet/metrics`` — the federated Prometheus
        exposition: replica histogram families merged
        bucket-wise into fleet-wide distributions (plus per-replica
        ``{replica=...}``-labeled samples), counters summed, gauges
        labeled per replica, and the router's own tracks
        (``router_*`` including the ``router_replay_gap_s``
        histogram) appended."""
        return self._get_text("/v1/fleet/metrics")

    # ``trace_events()`` (inherited) against a ROUTER returns the
    # STITCHED fleet trace: every replica's window on its own process
    # lane, skew-corrected, with the router's route/replay/breaker
    # spans interleaved.
    fleet_trace = GatewayClient.trace_events


class ServingRouter:
    """Failure-tolerant prefix-aware router over N gateway replicas.

    Parameters:

    - ``replicas`` — gateway addresses (``host:port`` or
      ``http://host:port``). All replicas must serve the SAME model
      with the same seed/config: greedy replay correctness depends on
      every replica producing bit-identical ids for the same request.
    - ``host``/``port`` — the router's own bind address (port 0 =
      ephemeral).
    - ``affinity_block_tokens`` — the affinity hash covers the
      prompt's leading ``floor(len/B)*B`` tokens; prompts shorter than
      one block route least-loaded instead. Match the replicas'
      ``block_tokens`` when they run paged KV.
    - ``health_interval_s`` / ``metrics_every`` — healthz scrape
      period, and how many health ticks between the heavier
      ``/v1/metrics`` scrapes.
    - ``failure_threshold`` — consecutive failures (scrape or
      data-plane) that trip a replica's breaker to ``dead``.
    - ``probe_interval_s`` — half-open probe period for dead replicas.
    - ``max_replays`` — replay budget per request across replica
      deaths; past it the request terminates ``fault``.
    - ``fleet_trace`` — fleet observability master switch (default
      ON; priced >= 0.97x by ``bench_fleet_trace_overhead``):
      trace-context propagation, router spans, the incremental
      per-replica trace cache, and clock-offset estimation.
    - ``kv_transfer`` — KV transfer plane master switch
      (default ON, capability-gated per replica via healthz so a
      dense fleet pays nothing): warm-import on affinity-miss /
      failover picks whose receiver is cold for the key, with
      fallback to full recompute on any fault.
    - ``replica_connect_timeout_s`` / ``replica_timeout_s`` — the
      router→replica connect and read bounds (a dead replica must
      fail fast, a healthy stream may idle up to the replica's
      keep-alive period between events).
    - ``journal_path`` — crash-safe write-ahead journal
      (default None = the memory-only journal). Every
      open/route/progress/done transition, tenant bucket level, and
      warm-KV belief is appended BEFORE the router acts on it; a
      router restarted against the same path replays open entries on
      whichever replicas answer healthz (high-water dedup — zero
      lost, zero double-delivered tokens), restores bucket levels
      (a flooder stays throttled through a crash) and warm beliefs,
      and serves client resumes from the recovered breadcrumbs.
    - ``fsync`` — the WAL durability policy (``per_record`` /
      ``batched`` / ``off``; serving/journal.py). ``batched``
      (default) is SIGKILL-safe and priced >= 0.97x WAL-off by
      ``bench_router_wal_overhead``.
    - ``wal_compact_bytes`` — compaction threshold: past it the live
      state folds into one snapshot record and the file rewrites
      atomically, so the WAL stays bounded like ``journal_cap``.

    ``with ServingRouter([...]) as r: ...`` serves on entry and closes
    on exit; or ``start()``/``close()`` explicitly."""

    def __init__(self, replicas: Sequence[str],
                 host: str = "127.0.0.1", port: int = 0,
                 affinity_block_tokens: int = 16,
                 health_interval_s: float = 0.25,
                 metrics_every: int = 4,
                 failure_threshold: int = 3,
                 probe_interval_s: float = 1.0,
                 max_replays: int = 3,
                 keepalive_s: float = 0.5,
                 handler_timeout_s: float = 30.0,
                 replica_connect_timeout_s: float = 2.0,
                 replica_timeout_s: float = 120.0,
                 journal_cap: int = 4096,
                 fleet_trace: bool = True,
                 tracer=None,
                 tenants=None,
                 kv_transfer: bool = True,
                 journal_path: Optional[str] = None,
                 fsync: str = "batched",
                 wal_compact_bytes: int = 1 << 20,
                 wal_retain_done: int = 64):
        if not replicas:
            raise ValueError("router needs at least one replica")
        if affinity_block_tokens < 1:
            raise ValueError(
                f"affinity_block_tokens {affinity_block_tokens} < 1")
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold {failure_threshold} < 1")
        self._replicas = [_Replica(a) for a in replicas]
        seen: Set[str] = set()
        for r in self._replicas:
            if r.address in seen:
                raise ValueError(f"duplicate replica {r.address}")
            seen.add(r.address)
        self.affinity_block_tokens = int(affinity_block_tokens)
        self.health_interval_s = float(health_interval_s)
        self.metrics_every = max(int(metrics_every), 1)
        self.failure_threshold = int(failure_threshold)
        self.probe_interval_s = float(probe_interval_s)
        self.max_replays = int(max_replays)
        self.keepalive_s = float(keepalive_s)
        self.replica_connect_timeout_s = float(
            replica_connect_timeout_s)
        self.replica_timeout_s = float(replica_timeout_s)
        self.journal_cap = int(journal_cap)
        #: multi-tenant QoS front door (default None = the
        #: tenant-blind router): a
        #: :class:`~deeplearning4j_tpu_torch.serving.tenancy.TenantRegistry`
        #: whose ``rate_rps``/``burst`` specs arm per-tenant token
        #: buckets — a flooder sheds AT THE DOOR with its own
        #: Retry-After (time to the next bucket token) before any
        #: replica sees it, and the ``system`` tenant is never
        #: throttled (warmup must always land)
        self.tenants = tenants
        self._buckets: Dict[str, Any] = {}
        #: fleet observability master switch (default ON —
        #: priced by bench_fleet_trace_overhead): trace-context
        #: propagation to replicas, router route/replay spans, the
        #: per-replica trace cache, and clock-offset estimation. Off,
        #: the router is the span-silent router (the
        #: /v1/trace and /v1/fleet/metrics endpoints still answer,
        #: with router-only lanes / unstamped requests).
        self.fleet_trace = bool(fleet_trace)
        if tracer is None:
            from deeplearning4j_tpu_torch.profiler.tracer import Tracer

            tracer = Tracer(max_events=65536)
        self.tracer = tracer
        from deeplearning4j_tpu_torch.profiler.tracer import Histogram

        #: replay-added latency: stream break -> first POST-replay
        #: token the client had not already seen (the failover cost a
        #: fleet operator actually pays — latency_report's --fleet
        #: ``replay_gap`` row)
        self._replay_gap = Histogram()
        if hasattr(self.tracer, "register_histogram"):
            self.tracer.register_histogram("router_replay_gap_s",
                                           self._replay_gap)
        if hasattr(self.tracer, "describe"):
            self.tracer.describe(
                "router_replay_gap_s",
                "stream-break to first post-replay fresh-token gap "
                "(replay-added latency per failover)")
        #: KV transfer plane master switch (default ON —
        #: capability-gated per replica via healthz ``kv_transfer``,
        #: so a dense fleet pays literally nothing): on an affinity
        #: miss / failover replay whose receiver is cold for the key,
        #: the router pulls the warm peer's exported prefix and
        #: imports it into the receiver BEFORE the attempt; any fault
        #: falls back to full recompute (correctness never depends on
        #: the transfer).
        self.kv_transfer = bool(kv_transfer)
        #: bounded warm-key map: affinity key -> {replica_id: stamp}
        #: — which replicas are believed warm for a key (admissions
        #: routed there, or a completed import). A belief, not a
        #: contract: a wrong entry costs one recompute, nothing else.
        self._warm: "Dict[bytes, Dict[str, float]]" = {}
        self._warm_cap = 1024
        #: end-to-end transfer wall (export fetch + import push) —
        #: the ``serving_kv_transfer_s`` row in latency_report
        #: --fleet (the router appends its own tracks to the
        #: federation)
        self._kv_transfer_hist = Histogram()
        if hasattr(self.tracer, "register_histogram"):
            self.tracer.register_histogram("serving_kv_transfer_s",
                                           self._kv_transfer_hist)
        if hasattr(self.tracer, "describe"):
            self.tracer.describe(
                "serving_kv_transfer_s",
                "cross-replica KV transfer wall (donor export fetch "
                "+ receiver import push, per shipped prefix)")
        self._lock = threading.RLock()
        self._rids = itertools.count()
        self._rid_hwm = 0  # next unminted rid (the WAL snapshot's)
        self._journal: Dict[int, _JournalEntry] = {}
        self._rr = 0  # least-loaded tie-break rotation
        self._t0 = time.monotonic()
        self.stats = {
            "requests": 0, "streams": 0, "affinity_routed": 0,
            "affinity_overflow": 0,
            "load_routed": 0, "replays": 0, "rerouted_429": 0,
            "replica_faults": 0, "request_faults": 0,
            "disconnect_cancels": 0, "drained_replicas": 0,
            "tenant_throttled": 0, "tenant_backoffs": 0,
            "kv_transfers": 0, "kv_transfer_failures": 0,
            "kv_transfer_declined": 0, "kv_transferred_tokens": 0,
            "recovered_entries": 0, "recovered_open": 0,
            "recovered_replayed": 0, "resumed_streams": 0,
            "detached_streams": 0, "wal_compactions": 0,
            "wal_errors": 0,
        }
        #: the crash ledger: None = memory-only
        self._wal: Optional[WriteAheadJournal] = None
        self.wal_retain_done = int(wal_retain_done)
        self._recovered_buckets: Dict[str, Dict[str, float]] = {}
        self._recovery_open: List[_JournalEntry] = []
        self._recover_t0_us: Optional[float] = None
        self._recover_pending = 0
        self._compacting = False
        self._wal_deferred: List[Dict[str, Any]] = []
        self._wal_flush_lock = threading.Lock()
        if journal_path is not None:
            self._wal = WriteAheadJournal(
                journal_path, fsync=fsync,
                compact_bytes=wal_compact_bytes)
            if self._wal.recovered:
                self._restore_from_wal(
                    recover_state(self._wal.recovered))
        self._stopped = False
        self._service = HttpService(_RouterHandler, host, port,
                                    router=self,
                                    timeout=float(handler_timeout_s))
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True,
            name="router-health")

    # -- lifecycle -----------------------------------------------------
    @property
    def address(self) -> str:
        return self._service.address

    def start(self) -> "ServingRouter":
        self._service.start()
        self._health_thread.start()
        if self._recovery_open:
            # re-enter the earlier replay path for every entry the WAL
            # says was open when the previous router died: full-prompt
            # resubmit on whichever replicas answer healthz, the
            # recovered high-water mark dedupping the already-streamed
            # prefix. Off-thread — clients reconnect through the
            # resume endpoint while replay runs.
            replays, self._recovery_open = self._recovery_open, []
            for entry in replays:
                threading.Thread(
                    target=self._recover_entry, args=(entry,),
                    daemon=True,
                    name=f"router-recover-{entry.rid}").start()
        elif self._recover_t0_us is not None:
            # a WAL with nothing open still recovered state (done
            # breadcrumbs, buckets, beliefs): the span records it
            self._emit_recover_span()
        return self

    def __enter__(self) -> "ServingRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop the router tier: health loop joined, HTTP service
        stopped, every still-open journal entry released (their
        handlers answer 503/end-of-stream). Replicas are NOT touched —
        they keep serving direct traffic."""
        self._stopped = True
        if self._health_thread.is_alive():
            self._health_thread.join(
                timeout=5.0 + 2 * self.health_interval_s)
        with self._lock:
            for entry in self._journal.values():
                entry.done.set()
        self._service.stop()
        if self._wal is not None:
            # drain deferred records, then flush + fsync — NO
            # clean-shutdown marker: the recovery path must be the
            # same one a SIGKILL exercises
            self._wal_flush()
            self._wal.close()

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _now_us(self) -> float:
        """The router's trace-event clock (µs) — the timeline every
        replica's events are skew-corrected onto."""
        f = getattr(self.tracer, "now_us", None)
        return float(f()) if f else (time.monotonic() - self._t0) * 1e6

    def _breaker_instant(self, replica: _Replica, frm: str,
                         to: str) -> None:
        """State-transition instant for the stitched trace:
        a failover timeline without the breaker's live→dead /
        dead→half-open→live instants cannot answer WHEN routing
        noticed. Caller holds the lock; the tracer has its own."""
        if frm != to and hasattr(self.tracer, "instant"):
            try:
                self.tracer.instant("router.breaker", scope="p",
                                    replica=replica.replica_id,
                                    frm=frm, to=to,
                                    failures=replica.failures)
            except TypeError:  # duck-typed tracer without scope
                self.tracer.instant("router.breaker",
                                    replica=replica.replica_id,
                                    frm=frm, to=to,
                                    failures=replica.failures)

    def _replica_client(self, replica: _Replica,
                        read_timeout_s: Optional[float] = None,
                        retries: int = 0) -> GatewayClient:
        return GatewayClient(
            replica.address,
            connect_timeout_s=self.replica_connect_timeout_s,
            read_timeout_s=(self.replica_timeout_s
                            if read_timeout_s is None
                            else read_timeout_s),
            retries=retries)

    # -- health / liveness tracking ------------------------------------
    def _health_loop(self) -> None:
        tick = 0
        while not self._stopped:
            tick += 1
            for replica in list(self._replicas):
                if self._stopped:
                    return
                try:
                    self._check_replica(
                        replica,
                        scrape_metrics=(
                            tick % self.metrics_every == 0))
                except Exception:
                    # the breaker thread must NEVER die: an exotic
                    # failure shape from a dying peer (anything the
                    # retryable classification missed) counts as a
                    # failed scrape, not a router outage
                    self._note_failure(replica)
                    self.tracer.incr("router_health_scrape_errors")
            # deferred warm/cold/rep records from lock-held sites
            # drain here at worst (most drain at their caller's seam)
            self._wal_flush()
            time.sleep(self.health_interval_s)

    def _check_replica(self, replica: _Replica,
                       scrape_metrics: bool) -> None:
        if replica.decommissioned:
            return
        now = time.monotonic()
        if replica.state in ("dead", "half-open"):
            if now < replica.next_probe_t:
                return
            with self._lock:
                self._breaker_instant(replica, replica.state,
                                      "half-open")
                replica.state = "half-open"
        # scrape timeouts well under the health interval budget: a
        # hung replica must not stall the whole loop for long
        probe = self._replica_client(
            replica, read_timeout_s=max(
                4 * self.health_interval_s, 1.0))
        t0_us = self._now_us()
        try:
            payload = probe.healthz()
        except (GatewayError, *RETRYABLE_ERRORS):
            self._note_failure(replica)
            return
        self._note_clock(replica, payload, t0_us, self._now_us())
        self._note_alive(replica, payload)
        if scrape_metrics and replica.state == "live":
            try:
                gauges = parse_prometheus(probe.metrics())
            except (GatewayError, *RETRYABLE_ERRORS):
                return  # healthz just succeeded; not a breaker event
            with self._lock:
                if "serving_gateway_queue_depth" in gauges:
                    replica.queue_depth = int(
                        gauges["serving_gateway_queue_depth"])
                if "serving_gateway_active_slots" in gauges:
                    replica.active_slots = int(
                        gauges["serving_gateway_active_slots"])
                if "serving_prefill_tokens_skipped" in gauges:
                    replica.prefix_tokens_reused = int(
                        gauges["serving_prefill_tokens_skipped"])
            if self.fleet_trace:
                self._scrape_trace(replica, probe)

    def _note_clock(self, replica: _Replica,
                    payload: Dict[str, Any], t0_us: float,
                    t1_us: float) -> None:
        """Fold one timed healthz scrape into the replica's clock-
        offset estimate. NTP midpoint: the replica read its tracer
        clock somewhere inside [t0, t1] on the router timeline, so
        ``offset = replica_now - (t0+t1)/2`` with error <= RTT/2. A
        lower-RTT sample always replaces a higher-RTT one (tighter
        bound); an AGED estimate (8 scrapes) is replaced regardless,
        so a one-off fast scrape cannot pin a stale offset while the
        clocks drift."""
        now_us = payload.get("now_us")
        if now_us is None:
            return
        rtt_us = t1_us - t0_us
        candidate = float(now_us) - (t0_us + t1_us) / 2.0
        with self._lock:
            replica.clock_age += 1
            # a candidate a full second away from the stored estimate
            # is not drift (µs between scrapes) — it is a NEW PROCESS
            # epoch on the same address (restart/resurrection):
            # accept immediately, or the stitcher would correct the
            # new epoch's events with the dead process's offset for
            # up to 8 scrapes
            epoch_jump = (replica.clock_offset_us is not None
                          and abs(candidate - replica.clock_offset_us)
                          > 1e6)
            if (rtt_us <= replica.clock_rtt_us or epoch_jump
                    or replica.clock_age >= 8):
                replica.clock_offset_us = candidate
                replica.clock_rtt_us = rtt_us
                replica.clock_age = 0

    #: trace-cache bound per replica (events): past it the oldest
    #: half drops, mirroring the tracer's own cap policy
    TRACE_CACHE_CAP = 65536

    def _scrape_trace(self, replica: _Replica,
                      probe: GatewayClient) -> None:
        """Refresh the replica's cached Chrome-trace window (the
        dead-lane source for stitched failover traces — a SIGKILLed
        replica's spans survive only here). INCREMENTAL: resumes from
        the last ``nextSeq`` cursor, so a busy replica costs one
        delta per scrape instead of a full 64k-event serialization
        (the difference between a free health tick and the 7% tax the
        fleet-overhead bench first measured). Failures are silent:
        the healthz that just succeeded owns liveness accounting, and
        a torn trace fetch must not shadow it."""
        since = replica.trace_seq
        try:
            doc = probe.trace_events(since_seq=since)
        except Exception:
            return
        self._merge_trace_delta(replica, doc, since_seq=since)

    def _merge_trace_delta(self, replica: _Replica,
                           doc: Dict[str, Any],
                           cache_offset_us: Optional[float] = None,
                           since_seq: Optional[int] = None
                           ) -> None:
        """Fold one ``/v1/trace?since_seq=`` delta into the replica's
        cache. ``cache_offset_us`` overrides the epoch-matched offset
        snapshotted alongside the cache — the last-gasp scrape passes
        the PRE-death estimate, because ``_note_failure`` has already
        reset the live one by the time the fetch lands. ``since_seq``
        is the cursor the fetch resumed from: a delta whose base no
        longer matches the cursor lost a race to a concurrent merge
        (periodic scrape vs last-gasp both fetching the same window)
        and is dropped rather than folded twice."""
        events = doc.get("traceEvents", [])
        next_seq = doc.get("nextSeq")
        with self._lock:
            if (since_seq is not None
                    and since_seq != replica.trace_seq):
                return
            if next_seq is None:
                replica.trace_cache = events  # legacy full window
            elif next_seq < replica.trace_seq:
                # the replica's tracer lifetime changed (restart on
                # the same address): its window IS the new truth,
                # and the old process's clock estimate must not
                # correct the new process's epoch
                replica.trace_cache = events
                replica.trace_seq = int(next_seq)
                replica.clock_offset_us = None
                replica.clock_rtt_us = float("inf")
                replica.clock_age = 0
            else:
                replica.trace_cache.extend(events)
                replica.trace_seq = int(next_seq)
            if len(replica.trace_cache) > self.TRACE_CACHE_CAP:
                del replica.trace_cache[
                    :len(replica.trace_cache) // 2]
            # the cache's correcting offset is whatever the clock
            # estimate says NOW — this scrape just talked to the same
            # process the events came from, so they share an epoch
            replica.cache_offset_us = (
                cache_offset_us if cache_offset_us is not None
                else replica.clock_offset_us)
            replica.trace_cache_t = time.monotonic()

    def _last_gasp_scrape(self, replica: _Replica,
                          epoch_offset_us: Optional[float]) -> None:
        """One immediate bounded
        ``/v1/trace?since_seq=`` delta fetch the moment the breaker
        opens, BEFORE giving the replica up: the periodic trace cache
        refreshes on the METRICS tick, so a replica that died within
        one metrics interval of a request's only spans would leave a
        thin dead lane in the stitched trace (the earlier known gap).
        A truly SIGKILLed process refuses the connection in
        milliseconds and we give up; a replica the breaker declared
        dead for softer reasons — wedged healthz, data-plane stream
        breaks, drain-then-die — often still answers its trace
        endpoint, and its final spans land in the cache with the
        pre-death epoch's clock offset."""
        self.tracer.incr("router_last_gasp_scrapes")
        probe = self._replica_client(replica, read_timeout_s=2.0)
        since = replica.trace_seq
        try:
            doc = probe.trace_events(since_seq=since)
        except Exception:
            return  # actually dead: the cache keeps what it had
        self._merge_trace_delta(replica, doc,
                                cache_offset_us=epoch_offset_us,
                                since_seq=since)
        self.tracer.incr("router_last_gasp_hits")

    def _note_alive(self, replica: _Replica,
                    payload: Dict[str, Any]) -> None:
        with self._lock:
            replica.failures = 0
            if replica.decommissioned:
                return
            to = "draining" if payload.get("draining") else "live"
            self._breaker_instant(replica, replica.state, to)
            replica.state = to
            rid = payload.get("replica_id")
            if rid and str(rid) != replica.replica_id:
                replica.replica_id = str(rid)
                # the id→address binding rides the WAL: a
                # restarted router re-seats stable ids BEFORE any
                # scrape, so the rendezvous keyspace holds from the
                # first post-restart pick and a dead-at-recovery
                # replica's breaker opens under the SAME id its
                # restored warm beliefs are keyed by
                self._wal_defer({"t": "rep", "r": str(rid),
                                 "addr": replica.address})
            replica.queue_depth = int(payload.get("queued", 0))
            replica.active_slots = int(
                payload.get("active_slots", 0))
            replica.n_slots = int(payload.get("n_slots", 1)) or 1
            replica.prefix_tokens_reused = int(
                payload.get("prefix_tokens_reused", 0))
            replica.role = str(payload.get("role") or "any")
            replica.kv_capable = bool(payload.get("kv_transfer"))
            replica.kv_tier_entries = int(
                (payload.get("kv_tier") or {}).get("entries", 0))

    def _note_failure(self, replica: _Replica) -> None:
        """One failed health scrape OR data-plane break: the breaker
        counts both, so a dying replica is detected by whichever
        surface hits it first."""
        became_dead = False
        epoch_offset_us: Optional[float] = None
        with self._lock:
            if replica.decommissioned:
                return
            replica.failures += 1
            was = replica.state
            if (replica.failures >= self.failure_threshold
                    or was in ("dead", "half-open")):
                became_dead = was not in ("dead", "half-open")
                epoch_offset_us = replica.clock_offset_us
                self._breaker_instant(replica, was, "dead")
                replica.state = "dead"
                replica.next_probe_t = (time.monotonic()
                                        + self.probe_interval_s)
                # the clock-offset estimate described a process now
                # presumed gone: a resurrected replica on the same
                # port has a FRESH perf_counter epoch, and correcting
                # its events with the dead process's offset would
                # scatter them across the stitched timeline. Drop the
                # estimate so the first post-resurrection scrape
                # always measures anew (a merely-slow replica just
                # re-measures — harmless).
                replica.clock_offset_us = None
                replica.clock_rtt_us = float("inf")
                replica.clock_age = 0
                if was not in ("dead", "half-open"):
                    self.stats["replica_faults"] += 1
                    self.tracer.incr("router_replica_dead")
                # a dead replica's warm-key beliefs die with it: a
                # resurrected process boots cold, and keeping them
                # would skip the one transfer that could re-warm it
                self._forget_warm(replica.replica_id)
            elif was == "live":
                self._breaker_instant(replica, was, "degraded")
                replica.state = "degraded"
        self._wal_flush()  # the cold record from _forget_warm
        if became_dead and self.fleet_trace and not self._stopped:
            # last-gasp trace scrape: off the
            # caller's thread — _note_failure fires from the health
            # loop AND data-plane relays, neither of which may stall
            # on a bounded fetch against a dying peer
            threading.Thread(
                target=self._last_gasp_scrape,
                args=(replica, epoch_offset_us), daemon=True,
                name=f"last-gasp-{replica.replica_id}").start()

    # -- routing -------------------------------------------------------
    def _affinity_key(self, prompt: Sequence[int]) -> Optional[bytes]:
        """The prompt's leading block-aligned tokens as a hash key;
        None when the prompt is shorter than one block (nothing worth
        keeping warm)."""
        b = self.affinity_block_tokens
        n = (len(prompt) // b) * b
        if n < b:
            return None
        return ",".join(str(int(t)) for t in prompt[:n]).encode()

    @staticmethod
    def _rendezvous_score(key: bytes, replica_id: str) -> int:
        return int.from_bytes(
            hashlib.blake2b(key + b"|" + replica_id.encode(),
                            digest_size=8).digest(), "big")

    def _pick(self, prompt: Sequence[int], exclude: Set[str],
              tenant: str = "default"
              ) -> Tuple[_Replica, Dict[str, Any]]:
        """Choose the replica for one (re)submission and claim one
        unit of its in-flight budget (``open_entries`` — the caller
        MUST release it when the attempt ends). Returns ``(replica,
        route_info)`` where ``route_info`` carries the
        ``router.route`` span's args: ``affinity`` (bool), the
        affinity ``key`` digest, and the chosen replica's rendezvous
        ``rank`` (0 = first choice; >0 = bounded-load overflow walked
        down the ranking). Raises :class:`_AllBackedOff` when every
        candidate is parked behind a 429 hint, :class:`_NoReplica`
        when nothing can serve at all.

        Affinity is BOUNDED-LOAD: rendezvous ranks the candidates for
        the prompt's prefix key, and the pick walks DOWN the ranking
        past replicas whose router-side in-flight count has reached
        their slot count. Pure rendezvous splits K distinct keys
        binomially — with 8 concurrent streams over 2 replicas a 6/2
        split is routine, and the overflow requests would queue a full
        generation behind busy slots while the sibling idles (measured
        0.61× direct on the bench before the bound). Walking the
        ranking keeps overflow DETERMINISTIC per key (the second-
        ranked replica, not a random sibling), so a key's overflow
        cache-warms one predictable place. The bound uses the
        router's OWN live accounting (claimed at pick time under the
        lock), not the scraped load — scrapes lag a burst by a whole
        health interval."""
        now = time.monotonic()
        with self._lock:
            def usable(r, state):
                return (r.state == state and not r.decommissioned
                        and r.address not in exclude)

            def parked_until(r):
                # a replica is parked for THIS pick when either its
                # replica-wide backoff or this TENANT's backoff
                # (a tenant-scoped 429 parks only that
                # tenant's keyspace) is still running
                return max(r.backoff_until,
                           r.tenant_backoff.get(tenant, 0.0))

            live = [r for r in self._replicas if usable(r, "live")]
            ready = [r for r in live if now >= parked_until(r)]
            if not ready:
                # degraded replicas are a LAST resort: recent
                # failures, but the breaker hasn't opened
                degraded = [r for r in self._replicas
                            if usable(r, "degraded")
                            and now >= parked_until(r)]
                if degraded:
                    ready = degraded
                elif live:
                    raise _AllBackedOff(
                        min(parked_until(r) for r in live) - now)
                else:
                    raise _NoReplica()
            key = self._affinity_key(prompt)
            if key is not None:
                # role-aware ranking: ``prefill``-role
                # replicas are the warm-KV donor tier — they stay out
                # of the rendezvous ranking for stream OWNERSHIP while
                # any decode-capable replica is ready (their caches
                # warm through the transfer plane's export pulls and
                # direct short-prompt traffic), so long decode streams
                # land on the decode tier. A fleet of ``any`` roles is
                # bit-identical to the role-blind ranking.
                pool = ([r for r in ready if r.role != "prefill"]
                        or ready)
                ranked = sorted(
                    pool, reverse=True,
                    key=lambda r: self._rendezvous_score(
                        key, r.replica_id))
                chosen = next(
                    (r for r in ranked
                     if r.open_entries < max(r.n_slots, 1)),
                    ranked[0])  # all saturated: stay sticky
                info = {
                    "affinity": True,
                    "key": hashlib.blake2b(
                        key, digest_size=4).hexdigest(),
                    "rank": ranked.index(chosen),
                }
                if info["rank"] == 0:
                    self.stats["affinity_routed"] += 1
                else:
                    self.stats["affinity_overflow"] += 1
            else:
                # short prompts (no reusable prefix): least-loaded,
                # preferring the admission-heavy (non-``decode``)
                # tier when one exists — the inverse of the affinity
                # preference above
                pool = ([r for r in ready if r.role != "decode"]
                        or ready)
                self._rr += 1
                order = (self._rr + i for i in range(len(pool)))
                # live in-flight count first (exact, claimed under
                # this very lock), scraped load as the tiebreak,
                # rotation last
                chosen = min(
                    zip(pool, order),
                    key=lambda p: (p[0].open_entries,
                                   p[0].queue_depth
                                   + p[0].active_slots,
                                   p[1] % len(pool)))[0]
                info = {"affinity": False, "key": None, "rank": None}
                self.stats["load_routed"] += 1
            chosen.requests_routed += 1
            chosen.open_entries += 1
            return chosen, info

    # -- KV transfer plane ----------------------------------
    def _note_warm(self, key: bytes, replica_id: str) -> None:
        """Record the belief that ``replica_id`` is (about to be)
        warm for ``key`` — set when an affinity request routes there
        (its admission inserts the prefix) and when an import lands.
        A belief, not a contract: a stale entry (replica restarted,
        trie evicted the key) costs one recompute, never
        correctness. Caller holds the lock."""
        warm = self._warm.get(key)
        if warm is None:
            warm = self._warm[key] = {}
            while len(self._warm) > self._warm_cap:
                self._warm.pop(next(iter(self._warm)))
        warm[replica_id] = time.monotonic()
        self._wal_defer({"t": "warm",
                         "k": key.decode("ascii", "replace"),
                         "r": replica_id,
                         "wall": round(time.time(), 3)})

    def _forget_warm(self, replica_id: str) -> None:
        """Drop every warm belief about a replica the breaker just
        declared dead: a resurrected process boots cold, and a stale
        belief would skip the one transfer that could re-warm it.
        Caller holds the lock."""
        for warm in self._warm.values():
            warm.pop(replica_id, None)
        self._wal_defer({"t": "cold", "r": replica_id})

    #: per-hop read bound for transfer traffic: the plane only buys
    #: admission latency, so a slow donor must cost LESS than the
    #: recompute it would have saved — a wedged peer times out in
    #: seconds, not the data-plane's stream budget
    KV_TRANSFER_TIMEOUT_S = 3.0

    def _fetch_kv_payload(self, donor: _Replica,
                          prompt: List[int]) -> Optional[bytes]:
        """Pull the donor's exported prefix (None = nothing cached).
        Factored out as the soak's fault-injection seam: truncating
        the returned payload models a torn transfer."""
        return self._replica_client(
            donor,
            read_timeout_s=self.KV_TRANSFER_TIMEOUT_S).kv_export(
                prompt)

    def _push_kv_payload(self, receiver_address: str,
                         payload: bytes) -> Dict[str, Any]:
        """Push one payload into the receiver (by address — upgrade
        warmup targets replicas not yet registered). The soak's
        second fault seam."""
        return GatewayClient(
            receiver_address,
            connect_timeout_s=self.replica_connect_timeout_s,
            read_timeout_s=self.KV_TRANSFER_TIMEOUT_S).kv_import(
                payload)

    def _maybe_kv_transfer(self, entry: _JournalEntry,
                           receiver: _Replica,
                           forward_ping=lambda: None,
                           rank: Optional[int] = None) -> None:
        """The warm-import hook: called after
        ``_pick`` and before the attempt, when the chosen replica is
        believed COLD for the prompt's affinity key — an affinity
        miss (bounded-load overflow), a failover replay landing on a
        survivor, or plain cache churn. Pulls the warm peer's export
        and imports it into the receiver so the admission that
        follows splices instead of recomputing. EVERY failure mode —
        no donor, transfer fault, decline — falls through silently:
        the attempt's full-prompt recompute already covers
        correctness (the earlier discipline), the transfer only buys
        admission latency."""
        key = self._affinity_key(entry.prompt)
        if key is None:
            return
        with self._lock:
            warm = self._warm.get(key, {})
            wanted = (receiver.kv_capable
                      and receiver.replica_id not in warm)
            donors: List[_Replica] = []
            if wanted:
                # live/draining donors only: a DEGRADED peer (recent
                # failures, breaker not yet open) is exactly the one
                # whose export would eat the transfer timeout for
                # nothing — recompute is cheaper than probing it
                cands = [r for r in self._replicas
                         if r.kv_capable and not r.decommissioned
                         and r.address != receiver.address
                         and r.state in ("live", "draining")]
                # believed-warm peers first (newest belief first);
                # then the key's rendezvous-top capable replica (its
                # designated owner — warm whenever the key has seen
                # traffic, even if the belief map forgot)
                donors = sorted(
                    (r for r in cands if r.replica_id in warm),
                    key=lambda r: -warm[r.replica_id])
                # tier-warm replicas next: a replica whose
                # spill tier holds payloads serves exports straight
                # from host DRAM/disk with zero device work — a
                # strictly better bet than a believed-cold replica,
                # and the export falls through to the tier even when
                # the TRIE evicted the key (the exact case the
                # belief map cannot see)
                donors += sorted(
                    (r for r in cands
                     if r.kv_tier_entries > 0 and r not in donors),
                    key=lambda r: -r.kv_tier_entries)
                # the rendezvous-top fallback (the key's designated
                # owner, warm whenever the key has seen traffic even
                # if the belief map forgot) only makes sense when the
                # RECEIVER is not that owner: on a rank-0 pick with
                # no warm beliefs, nobody else can be warm — probing
                # the second-ranked replica would pay a guaranteed
                # 404 round-trip per first-touch key
                if rank is None or rank > 0:
                    ranked = sorted(
                        cands, reverse=True,
                        key=lambda r: self._rendezvous_score(
                            key, r.replica_id))
                    for r in ranked[:1]:
                        if r not in donors:
                            donors.append(r)
            # the attempt that follows warms the receiver either way
            # (import, or the admission's own insert)
            self._note_warm(key, receiver.replica_id)
            if wanted and not donors:
                self.stats["kv_transfer_declined"] += 1
        self._wal_flush()  # the warm note deferred under the lock
        if not wanted or not donors:
            return
        t0_us = self._now_us()
        landed = None
        for donor in donors[:2]:
            try:
                # keepalive before each bounded hop: the client sees
                # at most one KV_TRANSFER_TIMEOUT_S of silence, never
                # the whole donor walk
                forward_ping()
                payload = self._fetch_kv_payload(donor, entry.prompt)
                if payload is None:
                    continue  # donor turned out cold: next candidate
                forward_ping()
                out = self._push_kv_payload(receiver.address, payload)
            except Exception:
                # torn payload, timeout, 400 from a geometry
                # mismatch, receiver died — all the same outcome:
                # count it, recompute covers it
                with self._lock:
                    self.stats["kv_transfer_failures"] += 1
                self.tracer.incr("router_kv_transfer_failures")
                continue
            if out.get("imported"):
                landed = (donor, out, len(payload))
                break
            # soft decline (already warm / pool pressure): done —
            # "already warm" needs no second donor
            if out.get("reason") == "already_warm":
                landed = (donor, out, len(payload))
                break
        dur_us = max(self._now_us() - t0_us, 0.0)
        if landed is None:
            return
        donor, out, nbytes = landed
        self._kv_transfer_hist.observe(dur_us / 1e6)
        with self._lock:
            if out.get("imported"):
                self.stats["kv_transfers"] += 1
                self.stats["kv_transferred_tokens"] += int(
                    out.get("tokens") or 0)
            entry.note(self._now(),
                       f"kv_import:{donor.replica_id}"
                       f":{out.get('reason')}")
        if out.get("imported"):
            self.tracer.incr("router_kv_transfers")
        if hasattr(self.tracer, "complete"):
            self.tracer.complete(
                "router.kv_transfer", t0_us, dur_us,
                rid=entry.rid, trace=entry.trace,
                donor=donor.replica_id,
                receiver=receiver.replica_id,
                imported=bool(out.get("imported")),
                reason=out.get("reason"),
                tokens=out.get("tokens"), blocks=out.get("blocks"),
                bytes=nbytes)

    def warm_transfer(self, receiver_address: str,
                      prompts: Sequence[Sequence[int]],
                      receiver_id: Optional[str] = None
                      ) -> Dict[str, Any]:
        """Upgrade-warmup transfer: ship the fleet's warm
        prefixes for ``prompts`` into a BOOTING replica (addressed
        directly — it is not registered yet) instead of regenerating
        them (the earlier ``/v1/warmup`` handshake). Returns
        ``{"imported", "attempted", "failed", "cold"}`` where
        ``cold`` lists the prompts that could not be shipped — the
        controller falls back to greedy warmup generation for
        exactly those. ``receiver_id`` (the stable replica id the
        receiver will register under — the controller knows it)
        records each shipped key in the warm-belief map, so the
        receiver's first affinity request does not pay a redundant
        export+import just to hear ``already_warm``."""
        imported = attempted = failed = 0
        cold: List[List[int]] = []
        for prompt in prompts:
            prompt = [int(t) for t in prompt]
            key = self._affinity_key(prompt)
            with self._lock:
                warm = self._warm.get(key, {}) if key else {}
                cands = [r for r in self._replicas
                         if r.kv_capable and not r.decommissioned
                         and r.address != receiver_address.split(
                             "://", 1)[-1]
                         and r.state in ("live", "degraded",
                                         "draining")]
                donors = sorted(
                    (r for r in cands if r.replica_id in warm),
                    key=lambda r: -warm[r.replica_id])
                # tier-warm before cold: same ladder as
                # the affinity-miss pick — the spill tier answers
                # exports the trie already evicted
                donors += sorted(
                    (r for r in cands
                     if r.kv_tier_entries > 0 and r not in donors),
                    key=lambda r: -r.kv_tier_entries)
                donors += [r for r in cands if r not in donors]
            ok = False
            for donor in donors[:3]:
                attempted += 1
                try:
                    payload = self._fetch_kv_payload(donor, prompt)
                    if payload is None:
                        continue
                    out = self._push_kv_payload(receiver_address,
                                                payload)
                except Exception:
                    failed += 1
                    continue
                if out.get("imported") or out.get(
                        "reason") == "already_warm":
                    ok = True
                    imported += int(bool(out.get("imported")))
                    if receiver_id is not None and key is not None:
                        with self._lock:
                            self._note_warm(key, str(receiver_id))
                    break
            if not ok:
                cold.append(prompt)
        with self._lock:
            self.stats["kv_transfers"] += imported
            self.stats["kv_transfer_failures"] += failed
        self._wal_flush()  # warm notes deferred under the lock
        return {"imported": imported, "attempted": attempted,
                "failed": failed, "cold": cold}

    # -- write-ahead journal -----------------------
    def _wal_append(self, record: Dict[str, Any]) -> None:
        """Append one record to the crash ledger (no-op without a
        ``journal_path``). A failing disk must not take the data
        plane down with it: the error is counted and the stream keeps
        relaying — the operator sees ``router_wal_errors`` climb and
        knows recovery coverage is degrading."""
        wal = self._wal
        if wal is None:
            return
        try:
            wal.append(record)
        except (OSError, ValueError):
            with self._lock:
                self.stats["wal_errors"] += 1
            self.tracer.incr("router_wal_errors")

    def _wal_defer(self, record: Dict[str, Any]) -> None:
        """Queue one record from a LOCK-HELD site (warm/cold/rep
        notes fire inside ``self._lock``): file I/O must not run
        under the router's global lock, so the record is flushed by
        the nearest unlocked seam (:meth:`_wal_flush` — the caller's
        epilogue, or the health tick). These record types are
        advisory state (beliefs, bindings) folded last-wins, so the
        flush latency costs recovery fidelity only in the window a
        crash would anyway."""
        if self._wal is not None:
            self._wal_deferred.append(record)

    def _wal_flush(self) -> None:
        """Append every deferred record (caller must NOT hold the
        router lock). Flushers fully serialize on their own lock —
        two concurrent flushers interleaving their swapped batches
        could otherwise append a warm note AFTER the cold record
        that superseded it, and recovery's last-wins fold would
        resurrect a dead replica's belief."""
        if self._wal is None:
            return
        with self._wal_flush_lock:
            with self._lock:
                if not self._wal_deferred:
                    return
                pending, self._wal_deferred = self._wal_deferred, []
            for record in pending:
                self._wal_append(record)

    def _wal_snapshot(self) -> Dict[str, Any]:
        """The compaction snapshot: every OPEN entry (the crash
        ledger proper — never dropped), the most recent
        ``wal_retain_done`` terminals (resume/poll breadcrumbs),
        refreshed token-bucket levels, and the warm-belief map with
        stamps converted to wall time."""
        wall = time.time()
        mono = time.monotonic()
        with self._lock:
            entries = []
            done_kept = 0
            for rid in sorted(self._journal, reverse=True):
                e = self._journal[rid]
                done = e.done.is_set()
                if done:
                    if done_kept >= self.wal_retain_done:
                        continue
                    done_kept += 1
                entries.append({
                    "rid": e.rid, "prompt": e.prompt,
                    "params": e.params,
                    "tokens": list(e.tokens),
                    "replica": e.replica_address, "done": done,
                    "finish_reason": (e.result or {}).get(
                        "finish_reason"),
                    "status": (e.result or {}).get("status"),
                    "submit_wall": round(
                        wall - (self._now() - e.submit_t), 3),
                })
            buckets = {}
            for tenant, b in self._buckets.items():
                b.try_take(0.0)  # refresh the level to NOW
                buckets[tenant] = {
                    "tokens": round(b.tokens, 6),
                    "capacity": b.capacity, "rate": b.rate,
                    "wall": wall}
            warm = {
                k.decode("ascii", "replace"): {
                    r: round(wall - (mono - s), 3)
                    for r, s in v.items()}
                for k, v in self._warm.items() if v}
            return {"next_rid": self._rid_hwm, "wall": wall,
                    "entries": entries, "buckets": buckets,
                    "warm": warm,
                    "replicas": {r.address: r.replica_id
                                 for r in self._replicas
                                 if r.replica_id != r.address}}

    def _compact_wal(self) -> None:
        """Fold the live state into one snapshot record and rewrite
        the file (bounded WAL — the on-disk twin of ``journal_cap``).
        One compactor at a time; the microsecond window between
        snapshot and rewrite can drop a concurrent progress append,
        which is safe by construction: greedy replay regenerates the
        same tokens and the client's Last-Event-ID dedups delivery."""
        wal = self._wal
        if wal is None:
            return
        with self._lock:
            if self._compacting:
                return
            self._compacting = True
        try:
            # arm the carry-over buffer FIRST: any record appended
            # while the snapshot is being built rides into the
            # rewritten file verbatim (idempotent folds absorb the
            # possible duplication) — the rewrite can lose nothing
            wal.begin_compaction()
            wal.compact(self._wal_snapshot())
            with self._lock:
                self.stats["wal_compactions"] += 1
            self.tracer.incr("router_wal_compactions")
        except (OSError, ValueError):
            with self._lock:
                self.stats["wal_errors"] += 1
            self.tracer.incr("router_wal_errors")
        finally:
            with self._lock:
                self._compacting = False

    def _restore_from_wal(self, state: Dict[str, Any]) -> None:
        """Rebuild the in-memory journal from a recovered WAL fold
        (constructor path, before the HTTP service exists). Done
        entries come back poll/resume-servable; open entries queue
        for the replay pass :meth:`start` launches; bucket levels and
        warm beliefs come back as if the crash were a long GC pause."""
        self._recover_t0_us = self._now_us()
        now = self._now()
        wall = time.time()
        mono = time.monotonic()
        self._rid_hwm = int(state["next_rid"])
        self._rids = itertools.count(self._rid_hwm)
        # re-seat the replicas' stable ids before any health scrape:
        # the rendezvous keyspace holds from the first pick, and a
        # replica that died WITH the old router opens its breaker
        # under the same id its restored warm beliefs are keyed by
        for replica in self._replicas:
            rid_known = state["replica_ids"].get(replica.address)
            if rid_known:
                replica.replica_id = rid_known
        for rid, rec in sorted(state["entries"].items()):
            # the persisted submit WALL time folds back onto the new
            # process's monotonic timeline, so a recovered entry's
            # age (journal_audit, history, e2e) spans the crash
            # instead of resetting to zero
            submit_t = now
            if rec.get("submit_wall") is not None:
                submit_t = now - max(
                    0.0, wall - float(rec["submit_wall"]))
            entry = _JournalEntry(rid, rec["prompt"],
                                  dict(rec["params"]), submit_t)
            entry.recovered = True
            entry.tokens = list(rec["tokens"])
            entry.replica_address = rec.get("replica")
            if self.fleet_trace:
                entry.trace = f"r{rid}"
            entry.note(now, "recovered")
            if rec["done"]:
                entry.result = {
                    "id": rid, "tokens": list(entry.tokens),
                    "finish_reason": rec.get("finish_reason"),
                    "status": rec.get("status") or 200,
                    "prompt_len": len(entry.prompt),
                    "replays": 0, "recovered": True}
                if entry.trace:
                    entry.result["trace"] = entry.trace
                entry.done_t = now
                entry.done.set()
            else:
                self._recovery_open.append(entry)
                self.stats["recovered_open"] += 1
            self._journal[rid] = entry
        self.stats["recovered_entries"] = len(state["entries"])
        # warm-belief recovery: wall stamps back
        # to the monotonic clock `_note_warm` speaks. A replica whose
        # breaker opens during recovery drops these through the same
        # `_forget_warm` a live death fires — a resurrected replica
        # still boots cold.
        for k, beliefs in state["warm"].items():
            self._warm[k.encode()] = {
                r: mono - max(0.0, wall - w)
                for r, w in beliefs.items()}
        # token-bucket recovery: levels refill
        # only for the real wall-clock downtime — a flooded tenant is
        # still throttled the moment the restarted router answers
        self._recovered_buckets = dict(state["buckets"])
        self._arm_recovered_buckets()
        self._recover_pending = len(self._recovery_open)

    def _arm_recovered_buckets(self) -> None:
        if self.tenants is None or not self._recovered_buckets:
            return
        from deeplearning4j_tpu_torch.serving.tenancy import TokenBucket

        wall = time.time()
        for tenant, saved in self._recovered_buckets.items():
            spec = self.tenants.spec_of(tenant)
            if spec.rate_rps is None:
                continue
            bucket = TokenBucket(spec.rate_rps, spec.burst)
            bucket.restore_level(
                saved.get("tokens", 0.0),
                age_s=max(0.0, wall - saved.get("wall", wall)))
            self._buckets[tenant] = bucket

    def _recover_entry(self, entry: _JournalEntry) -> None:
        """Replay one recovered OPEN entry to its terminal. No client
        is attached — the emit is a no-op, because `_relay_tokens`
        already extends ``entry.tokens`` (what resume followers and
        the final terminal serve) and journals the progress."""
        try:
            if entry.temperature > 0 and entry.tokens:
                # the earlier contract across the restart: a redrawn
                # sampling stream cannot splice onto the streamed
                # prefix — terminate ``fault`` with the partials
                entry.note(self._now(), "sampling_fault")
                self._finish(entry, self._fault_terminal(entry))
            else:
                self._run_entry(entry, lambda tokens: None,
                                lambda: None)
                with self._lock:
                    self.stats["recovered_replayed"] += 1
        except Exception:
            if not entry.done.is_set():
                self._finish(entry, self._fault_terminal(entry))
        finally:
            with self._lock:
                self._recover_pending -= 1
                last = self._recover_pending <= 0
            if last:
                self._emit_recover_span()

    def _emit_recover_span(self) -> None:
        """The ``router.recover`` span: one lane-0 span on
        the stitched trace covering WAL restore through the last
        recovered entry's terminal — a restart reads on the fleet
        timeline exactly like a failover reads as ``router.replay``."""
        t0 = self._recover_t0_us
        if t0 is None:
            return
        self._recover_t0_us = None
        now = self._now_us()
        if hasattr(self.tracer, "complete"):
            self.tracer.complete(
                "router.recover", t0, max(now - t0, 0.0),
                entries=self.stats["recovered_entries"],
                open=self.stats["recovered_open"],
                replayed=self.stats["recovered_replayed"],
                buckets=len(self._recovered_buckets),
                warm_keys=len(self._warm))
        self.tracer.incr("router_recoveries")

    # -- journal -------------------------------------------------------
    def _journal_entry(self, prompt: List[int],
                       params: Dict[str, Any]) -> _JournalEntry:
        with self._lock:
            rid = next(self._rids)
            self._rid_hwm = rid + 1
            entry = _JournalEntry(rid, prompt, params, self._now())
            if self.fleet_trace:
                # the fleet-level identity: every hop —
                # router spans, gateway, engine flight recorder —
                # stamps this id, so one grep of a stitched trace
                # yields the request's whole cross-process story
                entry.trace = f"r{rid}"
            entry.note(self._now(), "submitted")
            self._journal[rid] = entry
            # bounded journal: evict oldest DONE entries past the cap
            # (open entries are never evicted — they are the crash
            # ledger)
            if len(self._journal) > self.journal_cap:
                for old_rid in list(self._journal):
                    if len(self._journal) <= self.journal_cap:
                        break
                    old = self._journal[old_rid]
                    if old.done.is_set():
                        del self._journal[old_rid]
            self.stats["requests"] += 1
            self.tracer.incr("router_requests")
        # write-ahead: the open record lands BEFORE the
        # first routing attempt, so a crash a microsecond later still
        # recovers the request
        self._wal_append({"t": "open", "rid": rid,
                          "prompt": entry.prompt,
                          "params": entry.params,
                          "wall": round(time.time(), 3)})
        return entry

    def journal_audit(self) -> Dict[str, Any]:
        """The chaos-soak ledger: per-entry delivery accounting. A
        LOST request is an entry that never reached a terminal; a
        DOUBLE DELIVERY would show as a high-water mark short of the
        token count (some token went out twice without advancing the
        mark — structurally impossible through ``_relay_tokens``, and
        audited anyway)."""
        with self._lock:
            open_rids = [e.rid for e in self._journal.values()
                         if not e.done.is_set()]
            replayed = [e.rid for e in self._journal.values()
                        if e.replays > 0]
            return {
                "entries": len(self._journal),
                "open": open_rids,
                "replayed": replayed,
                "lost": [e.rid for e in self._journal.values()
                         if e.done.is_set() and e.result is None],
            }

    # -- the proxy / replay core ---------------------------------------
    def _result_of(self, entry: _JournalEntry,
                   terminal: Dict[str, Any]) -> Dict[str, Any]:
        """Client-facing terminal: the replica's result re-keyed to
        the ROUTER's request id, tokens replaced by the journal's
        high-water view (identical for healthy terminals — asserted
        by the dedup walk — and the authoritative partial list for
        faults), plus the router's replay accounting."""
        out = dict(terminal)
        out.pop("done", None)
        out["id"] = entry.rid
        out["tokens"] = list(entry.tokens)
        out["replays"] = entry.replays
        if entry.trace:
            out["trace"] = entry.trace
        return out

    def _fault_terminal(self, entry: _JournalEntry,
                        reason: str = "fault",
                        status: int = 500) -> Dict[str, Any]:
        out = {"id": entry.rid, "tokens": list(entry.tokens),
               "finish_reason": reason, "status": status,
               "prompt_len": len(entry.prompt),
               "replays": entry.replays}
        if entry.trace:
            out["trace"] = entry.trace
        return out

    def _finish(self, entry: _JournalEntry,
                result: Dict[str, Any]) -> Dict[str, Any]:
        self._close_replay_window(entry, outcome="terminal")
        with self._lock:
            entry.result = result
            entry.done_t = self._now()
            entry.note(entry.done_t,
                       f"terminal:{result.get('finish_reason')}")
            entry.done.set()
            if result.get("finish_reason") == "fault":
                self.stats["request_faults"] += 1
                self.tracer.incr("router_request_faults")
        self._wal_append({"t": "done", "rid": entry.rid,
                          "reason": result.get("finish_reason"),
                          "status": result.get("status"),
                          "n": len(entry.tokens)})
        if self._wal is not None and self._wal.needs_compaction():
            # off-thread: the relay that happened to trip the
            # threshold must not pay the snapshot + rewrite + fsyncs
            # before its client sees the terminal (_compacting keeps
            # it single-flight)
            threading.Thread(target=self._compact_wal, daemon=True,
                             name="router-wal-compact").start()
        return result

    def _open_replay_window(self, entry: _JournalEntry,
                            from_replica: str) -> None:
        """The stream broke and a replay begins: anchor the
        ``router.replay`` span (and the ``router_replay_gap_s``
        observation) at the BREAK, not at the resubmit — the client's
        dead air starts now."""
        if entry.replay_t0_us is None:
            entry.replay_t0_us = self._now_us()
            entry.replay_hwm = len(entry.tokens)
            entry.replay_from = from_replica

    def _close_replay_window(self, entry: _JournalEntry,
                             outcome: str,
                             overlap_ok: bool = True) -> None:
        """First fresh token after a replay (or the terminal, for a
        replay that only had its tail left / diverged / faulted):
        emit the bridging ``router.replay`` span — break to first
        post-replay delivery, the exact failover gap the client
        experienced — and feed the replay-gap histogram."""
        t0 = entry.replay_t0_us
        if t0 is None:
            return
        entry.replay_t0_us = None
        now = self._now_us()
        gap_s = max(now - t0, 0.0) / 1e6
        self._replay_gap.observe(gap_s)
        if hasattr(self.tracer, "complete"):
            self.tracer.complete(
                "router.replay", t0, max(now - t0, 0.0),
                rid=entry.rid, trace=entry.trace,
                high_water=entry.replay_hwm,
                overlap_ok=overlap_ok, outcome=outcome,
                from_replica=entry.replay_from,
                to_replica=(entry.replica_address or ""),
                replay=entry.replays)

    def _relay_tokens(self, entry: _JournalEntry, tokens: List[int],
                      seen: int) -> Tuple[int, List[int]]:
        """Advance one attempt's stream position through a delta.
        Tokens at positions the client already has are CHECKED against
        the journal (greedy replay must regenerate the exact streamed
        prefix) and dropped; tokens past the high-water mark extend
        the journal and are returned for delivery. This is the
        cross-process version of the engine's ``delta_sent`` dedup."""
        fresh: List[int] = []
        for t in tokens:
            t = int(t)
            seen += 1
            if seen <= len(entry.tokens):
                if t != entry.tokens[seen - 1]:
                    raise _ReplayDiverged(
                        f"request {entry.rid}: replay token {t} at "
                        f"position {seen - 1} != streamed "
                        f"{entry.tokens[seen - 1]}")
            else:
                entry.tokens.append(t)
                fresh.append(t)
        if fresh:
            # write-ahead: the high-water mark advances on disk
            # BEFORE the tokens go out to the client, so a crash
            # between the two can only under-count what was delivered
            # — replay then re-offers tokens the client dedups by
            # Last-Event-ID, and never loses ones it journaled.
            # ``at`` makes the record position-addressed (idempotent
            # under compaction carry-over duplication).
            self._wal_append({"t": "prog", "rid": entry.rid,
                              "at": len(entry.tokens) - len(fresh),
                              "toks": fresh})
        return seen, fresh

    def _ping_sleep(self, total_s: float, forward_ping) -> None:
        """Sleep ``total_s`` in ``keepalive_s`` slices, forwarding a
        keep-alive to the client before each slice — a replay wait
        must not look like a dead connection."""
        end = time.monotonic() + total_s
        while True:
            forward_ping()
            left = end - time.monotonic()
            if left <= 0:
                return
            time.sleep(min(left, self.keepalive_s))

    def _attempt(self, entry: _JournalEntry, replica: _Replica,
                 client: GatewayClient, route_info: Dict[str, Any],
                 emit, forward_ping, attempt_no: int = 0,
                 wait_t0_us: Optional[float] = None
                 ) -> Tuple[Optional[Dict[str, Any]], bool]:
        """One streaming attempt against one replica. Returns
        ``(terminal, diverged)``; ``terminal is None`` means the
        stream ended WITHOUT a terminal event (replica death or drain
        handback — the replay policy in ``_run_entry`` decides what
        that means). Raises :class:`_RouteAround` when the attempt
        never started streaming (submit rejected/unreachable — try a
        sibling, no replay charged) and :class:`_ClientGone` when the
        router's own client vanished mid-relay."""
        by_affinity = bool(route_info.get("affinity"))
        params = entry.params
        if self.fleet_trace and entry.trace:
            # trace id + PER-ATTEMPT span id: a failover's two
            # attempts are two spans of one trace, so the replica
            # each served knows which chapter it was
            params = dict(params,
                          trace=f"{entry.trace}/a{attempt_no}")
        try:
            stream = client.stream(entry.prompt, **params)
        except GatewayError as e:
            if e.status == 429:
                # backpressure, not failure — and the SCOPE of the
                # park follows the reply: a reply naming
                # a tenant ("tenant queue full" from a
                # tenancy-enabled replica) parks only that TENANT's
                # keyspace on this replica, so an at-SLO victim keeps
                # routing here while the flooder waits out its own
                # hint; a tenant-blind 429 (global queue full) parks
                # the whole replica as before
                hinted = (e.payload or {}).get("tenant")
                with self._lock:
                    until = (time.monotonic()
                             + (e.retry_after_s or 1))
                    if hinted:
                        replica.tenant_backoff[str(hinted)] = until
                        # bounded map: drop expired parks once it
                        # grows past a handful of tenants
                        if len(replica.tenant_backoff) > 64:
                            now_m = time.monotonic()
                            replica.tenant_backoff = {
                                t: u for t, u
                                in replica.tenant_backoff.items()
                                if u > now_m}
                        self.stats["tenant_backoffs"] += 1
                        self.tracer.incr(
                            f'router_tenant_backoff{{tenant='
                            f'"{hinted}"}}')
                    else:
                        replica.backoff_until = until
                    self.stats["rerouted_429"] += 1
                    self.tracer.incr("router_rerouted_429")
                raise _RouteAround() from e
            if e.status == 503:
                # draining/closed: the health loop will catch up;
                # route around it meanwhile
                raise _RouteAround() from e
            # a deterministic rejection (400 bad params): replaying
            # elsewhere would just repeat it — relay to the client
            raise _RouteAround(deterministic={
                "id": entry.rid, "tokens": [],
                "finish_reason": "error", "status": e.status,
                "error": e.payload.get("error"),
                "replays": entry.replays}) from e
        except RETRYABLE_ERRORS as e:
            # could not even submit: breaker event, try a sibling
            self._note_failure(replica)
            raise _RouteAround() from e
        with self._lock:
            entry.replica_address = replica.address
            entry.replica_rid = stream.id
            entry.note(self._now(),
                       f"routed:{replica.replica_id}"
                       f"{':affinity' if by_affinity else ''}"
                       f":rid={stream.id}")
        # the ADDRESS, not the id: recovery folds this into
        # ``entry.replica_address`` (the same field the compaction
        # snapshot persists) — the id↔address binding has its own
        # ``rep`` records
        self._wal_append({"t": "route", "rid": entry.rid,
                          "replica": replica.address})
        if (self.fleet_trace and wait_t0_us is not None
                and hasattr(self.tracer, "complete")):
            # pick + backoff + submit handshake: everything between
            # "this attempt became runnable" and "the replica accepted
            # the stream" — the router-side analogue of the engine's
            # queue_wait phase
            now_us = self._now_us()
            self.tracer.complete(
                "router.queue_wait", wait_t0_us,
                max(now_us - wait_t0_us, 0.0), rid=entry.rid,
                trace=entry.trace, attempt=attempt_no,
                replica=replica.replica_id)
        terminal: Optional[Dict[str, Any]] = None
        diverged = False
        seen = 0
        try:
            if entry.cancelled and stream.id is not None:
                # cancel raced the submit: forward it now that the
                # replica-side id exists
                with contextlib.suppress(Exception):
                    client.cancel(stream.id)
            for kind, event in stream.raw_events():
                if kind == "ping":
                    forward_ping()
                    continue
                toks = event.get("tokens")
                if toks and not event.get("done"):
                    seen, fresh = self._relay_tokens(
                        entry, toks, seen)
                    if fresh:
                        emit(fresh)
                        # the first fresh token after a failover ends
                        # the client-visible replay gap: the dedup
                        # walk verified the regenerated prefix, new
                        # content is flowing again
                        self._close_replay_window(
                            entry, outcome="fresh_token")
                    continue
                if event.get("done"):
                    # the terminal may carry committed tokens the
                    # per-delta events did not (flushed tail) — run
                    # them through the same dedup before trusting it
                    if toks and len(toks) >= len(entry.tokens):
                        _, fresh = self._relay_tokens(
                            entry, toks, 0)
                        if fresh:
                            emit(fresh)
                    terminal = event
                    break
        except _ClientGone:
            raise  # _stream_response cancels; not a replica event
        except _ReplayDiverged:
            diverged = True
        except (*RETRYABLE_ERRORS, ValueError):
            # mid-stream death (or a torn frame from a dying peer):
            # the replay policy decides
            terminal = None
        finally:
            stream.close()
        return terminal, diverged

    def _run_entry(self, entry: _JournalEntry, emit,
                   forward_ping) -> Dict[str, Any]:
        """Drive one journaled request to its terminal: route, relay,
        and — on replica death or drain handback — replay onto a
        survivor with high-water dedup. ``emit(tokens)`` delivers
        fresh tokens to the client (SSE event or blocking
        accumulator); ``forward_ping()`` relays replica keep-alives.
        Returns the client-facing terminal dict (also journaled)."""
        exclude: Set[str] = set()
        attempts = 0
        # router-side queue-wait anchor: submit (or the previous
        # attempt's break) -> the replica accepting the stream
        wait_t0_us = self._now_us() if self.fleet_trace else None
        while True:
            if entry.cancelled:
                return self._finish(
                    entry, self._fault_terminal(
                        entry, "cancelled", 499))
            attempts += 1
            if attempts > self.max_replays + 2 * len(self._replicas):
                # absolute bound on the route-submit loop: repeated
                # submit-time connection failures (distinct from
                # replays, which count mid-stream deaths)
                return self._finish(entry,
                                    self._fault_terminal(entry))
            t_route_us = self._now_us() if self.fleet_trace else None
            try:
                replica, route_info = self._pick(entry.prompt,
                                                 exclude,
                                                 tenant=entry.tenant)
            except _AllBackedOff as e:
                if not entry.tokens:
                    wait = max(1, int(e.wait_s + 0.999))
                    shed = {
                        "id": entry.rid, "tokens": [],
                        "finish_reason": "shed", "status": 429,
                        "prompt_len": len(entry.prompt),
                        "retry_after_s": wait,
                        "replays": entry.replays}
                    if self.tenants is not None:
                        # the wait was computed over THIS tenant's
                        # parks — name it, so the caller
                        # knows whose hint this is
                        shed["tenant"] = entry.tenant
                    return self._finish(entry, shed)
                # mid-replay with streamed tokens: waiting is better
                # than faulting — the backoff hints are short. The
                # wait is pinged at keepalive_s cadence: the CLIENT
                # connection sees no replica traffic during this gap,
                # and a silent gap longer than its read timeout would
                # drop a request that was about to complete
                self._ping_sleep(min(max(e.wait_s, 0.05), 2.0),
                                 forward_ping)
                exclude.clear()
                continue
            except _NoReplica:
                if exclude:
                    # every healthy replica is excluded from THIS
                    # request (each failed it once): clear and let the
                    # state machine filter instead
                    exclude.clear()
                    continue
                return self._finish(entry, {
                    "id": entry.rid, "tokens": list(entry.tokens),
                    "finish_reason": ("fault" if entry.tokens
                                      else "shed"),
                    "status": (500 if entry.tokens else 503),
                    "prompt_len": len(entry.prompt),
                    "replays": entry.replays})
            entry.affinity = (entry.affinity
                              or bool(route_info.get("affinity")))
            if (self.fleet_trace and t_route_us is not None
                    and hasattr(self.tracer, "complete")):
                # the routing decision itself, with the evidence:
                # affinity key digest + the chosen replica's
                # rendezvous rank (>0 = bounded-load overflow)
                now_us = self._now_us()
                self.tracer.complete(
                    "router.route", t_route_us,
                    max(now_us - t_route_us, 0.0), rid=entry.rid,
                    trace=entry.trace, attempt=attempts,
                    replica=replica.replica_id,
                    affinity=route_info.get("affinity"),
                    affinity_key=route_info.get("key"),
                    rendezvous_rank=route_info.get("rank"))
            if self.kv_transfer and route_info.get("affinity"):
                # warm import BEFORE the attempt: an
                # affinity miss / failover replay whose receiver is
                # cold pulls the warm peer's KV so the admission
                # splices instead of recomputing; every transfer
                # fault falls through to the recompute the attempt
                # does anyway
                self._maybe_kv_transfer(
                    entry, replica, forward_ping=forward_ping,
                    rank=route_info.get("rank"))
            client = self._replica_client(replica)
            try:
                # _pick claimed one unit of the replica's in-flight
                # budget; the outer finally releases it however this
                # attempt ends (bounded-load affinity reads it live)
                terminal, diverged = self._attempt(
                    entry, replica, client, route_info, emit,
                    forward_ping, attempt_no=attempts,
                    wait_t0_us=wait_t0_us)
            except _RouteAround as ra:
                exclude.add(replica.address)
                if ra.deterministic is not None:
                    return self._finish(entry, ra.deterministic)
                continue
            finally:
                with self._lock:
                    replica.open_entries -= 1
            if terminal is not None:
                return self._finish(entry,
                                    self._result_of(entry, terminal))
            if diverged:
                entry.note(self._now(), "replay_diverged")
                # the overlap check FAILED: the bridging replay span
                # records it (a silent splice is the one thing the
                # dedup walk exists to prevent)
                self._close_replay_window(entry, outcome="diverged",
                                          overlap_ok=False)
                return self._finish(entry,
                                    self._fault_terminal(entry))
            # ---- the stream ended WITHOUT a terminal ---------------
            if entry.cancelled:
                return self._finish(
                    entry, self._fault_terminal(
                        entry, "cancelled", 499))
            draining = replica.state in ("draining", "dead")
            if not draining:
                # unannounced death: charge the breaker so routing
                # reacts before the next health tick
                self._note_failure(replica)
            if entry.temperature > 0 and entry.tokens:
                # the earlier contract, across processes: a redrawn
                # sampling stream cannot splice onto the streamed
                # prefix — terminate "fault" with the partial tokens
                entry.note(self._now(), "sampling_fault")
                return self._finish(entry,
                                    self._fault_terminal(entry))
            with self._lock:
                entry.replays += 1
                self.stats["replays"] += 1
                self.tracer.incr("router_replays")
                entry.note(self._now(),
                           f"replay:{entry.replays}:"
                           f"from={replica.replica_id}")
            if entry.replays > self.max_replays:
                return self._finish(entry,
                                    self._fault_terminal(entry))
            if self.fleet_trace:
                # anchor the bridging router.replay span (and the
                # replay-gap histogram) at the break; the next
                # attempt's queue_wait restarts here too
                self._open_replay_window(entry, replica.replica_id)
                wait_t0_us = self._now_us()
            # keep the client connection warm across the failover
            # gap (route + resubmit + survivor prefill before its
            # first event)
            forward_ping()
            exclude.add(replica.address)

    # -- endpoint bodies -----------------------------------------------
    def _parse_generate(self, body: Dict[str, Any]
                        ) -> Tuple[List[int], Dict[str, Any]]:
        prompt = [int(t) for t in body.get("prompt", [])]
        params: Dict[str, Any] = {
            "max_new_tokens": int(body.get("max_new_tokens", 16))}
        for knob in ("temperature", "top_k", "eos_id", "deadline_s",
                     "queue_timeout_s", "tenant", "priority"):
            if body.get(knob) is not None:
                params[knob] = body[knob]
        if body.get("resumable"):
            # a resumable stream's client disconnect
            # detaches instead of cancelling (resume via
            # GET /v1/requests/<id>/stream + Last-Event-ID). Kept in
            # params so the WAL open record carries it and a
            # recovered entry stays resumable; replicas ignore it.
            params["resumable"] = True
        if params.get("tenant") is not None:
            # validate HERE, inside the caller's 400-mapping
            # try/except: a malformed name must answer 400 like the
            # gateway surface does, not explode the rate-limit path
            # (spec_of builds a TenantSpec) with a connection reset —
            # and the reserved system tenant is never accepted from
            # the wire (it is quota/rate/priority-exempt: one JSON
            # field would otherwise bypass the whole QoS layer)
            from deeplearning4j_tpu_torch.serving.tenancy import (
                validate_tenant,
            )

            params["tenant"] = validate_tenant(params["tenant"])
            if params["tenant"] == "system":
                raise ValueError(
                    "tenant 'system' is reserved for infrastructure "
                    "traffic")
        return prompt, params

    def _tenant_throttle(self, tenant: str) -> float:
        """Per-tenant token-bucket check: 0.0 = admitted,
        else seconds until the tenant's next token accrues — the
        seed of its OWN Retry-After. The reserved ``system`` tenant
        (warmup/boot handshakes) and tenants without a configured
        rate are never throttled."""
        from deeplearning4j_tpu_torch.serving.tenancy import (
            SYSTEM_TENANT,
            TokenBucket,
        )

        if self.tenants is None or tenant == SYSTEM_TENANT:
            return 0.0
        spec = self.tenants.spec_of(tenant)
        if spec.rate_rps is None:
            return 0.0
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets[tenant] = TokenBucket(
                    spec.rate_rps, spec.burst)
            wait = bucket.try_take()
            # the level rides the WAL, so a
            # restarted router refills only for real downtime — a
            # flooder's bucket comes back as empty as it died. The
            # record is DEFERRED from under the lock (build order =
            # level order, and the serialized flushers preserve it —
            # two racing appends could otherwise land a stale fuller
            # level after the newer one) and flushed right below,
            # outside the lock.
            self._wal_defer({"t": "bucket", "tenant": tenant,
                             "tokens": round(bucket.tokens, 6),
                             "capacity": bucket.capacity,
                             "rate": bucket.rate,
                             "wall": round(time.time(), 3)})
        self._wal_flush()
        return wait

    def _tenant_queue_share_s(self, tenant: str) -> float:
        """The tenant's open-request share priced in replica waves —
        folded into its Retry-After so a flooder with a deep
        in-flight backlog hears a longer hint than the bucket alone
        would say."""
        with self._lock:
            open_t = sum(1 for e in self._journal.values()
                         if not e.done.is_set()
                         and e.tenant == tenant)
            slots = sum(max(r.n_slots, 1) for r in self._replicas
                        if r.state == "live"
                        and not r.decommissioned) or 1
        return open_t / slots

    def _handle_generate(self, handler: _RouterHandler,
                         stream: bool) -> None:
        try:
            body = handler.read_json()
            if not isinstance(body, dict):
                raise ValueError(f"expected a JSON object, got "
                                 f"{type(body).__name__}")
            prompt, params = self._parse_generate(body)
            if not prompt:
                raise ValueError("empty prompt")
        except (ValueError, TypeError, UnicodeDecodeError) as e:
            handler.send_json({"error": f"bad JSON body: {e}"}, 400,
                              close=True)
            return
        tenant = str(params.get("tenant") or "default")
        wait = self._tenant_throttle(tenant)
        if wait > 0:
            # the front-door shed: over its rate quota,
            # the tenant is 429'd BEFORE journaling or any replica
            # traffic, with a Retry-After priced from ITS bucket
            # refill plus ITS queue share — never the global hint
            retry = max(1, math.ceil(
                wait + self._tenant_queue_share_s(tenant)))
            with self._lock:
                self.stats["tenant_throttled"] += 1
            self.tracer.incr("router_tenant_429")
            self.tracer.incr(
                f'router_tenant_429{{tenant="{tenant}"}}')
            handler.send_json(
                {"error": "tenant rate limit", "tenant": tenant,
                 "retry_after_s": retry, "finish_reason": "shed",
                 "status": 429},
                429, close=True,
                headers=(("Retry-After", retry),))
            return
        entry = self._journal_entry(prompt, params)
        if stream:
            self._stream_response(handler, entry)
        else:
            self._blocking_response(handler, entry)

    def _blocking_response(self, handler, entry: _JournalEntry
                           ) -> None:
        acc: List[int] = []
        result = self._run_entry(entry, acc.extend, lambda: None)
        headers: Tuple = ()
        if result.get("retry_after_s"):
            headers = (("Retry-After", result["retry_after_s"]),)
        handler.send_json(result, int(result.get("status", 200)),
                          close=True, headers=headers)

    def _stream_response(self, handler, entry: _JournalEntry) -> None:
        with self._lock:
            self.stats["streams"] += 1
        detached = [False]
        try:
            handler.start_stream("text/event-stream")
            handler.send_event({"id": entry.rid,
                                "resumable": entry.resumable},
                               event_id=0)

            # client-facing writes raise _ClientGone so _run_entry
            # can tell "my client left" apart from "the replica
            # died" — EXCEPT on a resumable stream, where
            # a vanished client DETACHES: the relay keeps running
            # with these emits degraded to no-ops, every token still
            # lands in the journal, and the client reconnects via
            # GET /v1/requests/<rid>/stream + Last-Event-ID
            def gone(e: OSError) -> None:
                if not entry.resumable:
                    raise _ClientGone() from e
                if not detached[0]:
                    detached[0] = True
                    with self._lock:
                        self.stats["detached_streams"] += 1
                    self.tracer.incr("router_detached_streams")
                    entry.note(self._now(), "client_detached")

            def emit(tokens: List[int]) -> None:
                if detached[0]:
                    return
                try:
                    # the SSE id is the cumulative delivered-token
                    # count — entry.tokens already includes this
                    # delta (extended by _relay_tokens before emit)
                    handler.send_event({"id": entry.rid,
                                        "tokens": tokens},
                                       event_id=len(entry.tokens))
                except OSError as e:
                    gone(e)

            def ping() -> None:
                if detached[0]:
                    return
                try:
                    handler.send_ping()
                except OSError as e:
                    gone(e)

            result = self._run_entry(entry, emit, ping)
            if not detached[0]:
                out = dict(result)
                out["done"] = True
                handler.send_event(out,
                                   event_id=len(entry.tokens))
                handler.end_stream()
        except (_ClientGone, BrokenPipeError, ConnectionResetError,
                OSError):
            # the ROUTER's client vanished: cancel on the replica and
            # close out the journal entry
            with self._lock:
                self.stats["disconnect_cancels"] += 1
                self.tracer.incr("router_disconnect_cancelled")
                entry.cancelled = True
                addr, rrid = entry.replica_address, entry.replica_rid
            if addr is not None and rrid is not None:
                with contextlib.suppress(Exception):
                    GatewayClient(
                        addr,
                        connect_timeout_s=self.replica_connect_timeout_s,
                        read_timeout_s=5.0).cancel(rrid)
            if not entry.done.is_set():
                self._finish(entry, self._fault_terminal(
                    entry, "cancelled", 499))

    def _handle_stream_resume(self, handler, path: str,
                              query: str) -> None:
        """``GET /v1/requests/<rid>/stream``: a
        dropped client reconnects and resumes its stream from the
        journal — ``Last-Event-ID`` (or ``?from=N``) names the last
        token position it received, and the reply replays everything
        past it from the entry's high-water mark, then FOLLOWS the
        live entry (replay after a replica death, recovery after a
        router restart) until the terminal. Zero duplicated and zero
        lost tokens: the journal is the single source of truth and
        the cursor is an exact token position. Works on any journaled
        entry (a blocking submit's progress is followable too); a
        vanished resume consumer just ends — it never cancels the
        underlying request."""
        parsed = handler.read_resume_cursor(path, query)
        if parsed is None:
            return
        rid, cursor = parsed
        with self._lock:
            entry = self._journal.get(rid)
        if entry is None:
            handler.send_json({"error": f"unknown request {rid}"},
                              404, close=True)
            return
        with self._lock:
            self.stats["resumed_streams"] += 1
        self.tracer.incr("router_resumed_streams")
        entry.note(self._now(), f"resumed:from={cursor}")

        def poll(at):
            with self._lock:
                total = len(entry.tokens)
                tail = ([int(t) for t in entry.tokens[at:]]
                        if total > at else [])
                return (tail, total,
                        entry.done.is_set() or self._stopped,
                        entry.result)

        try:
            handler.follow_stream(rid, cursor, poll,
                                  entry.done.wait, self.keepalive_s)
        except (BrokenPipeError, ConnectionResetError, OSError):
            # the resume consumer vanished: nothing to cancel — the
            # underlying request belongs to its primary stream (or
            # to the recovery replay), and another resume may follow
            pass

    def _handle_cancel(self, handler, path: str) -> None:
        tail = path.rsplit("/", 1)[-1]
        try:
            rid = int(tail)
        except ValueError:
            handler.send_json({"error": f"bad request id {tail!r}"},
                              400, close=True)
            return
        with self._lock:
            entry = self._journal.get(rid)
            if entry is not None:
                entry.cancelled = True
                addr, rrid = entry.replica_address, entry.replica_rid
                done = entry.done.is_set()
        if entry is None:
            handler.send_json({"id": rid, "cancelled": False,
                               "done": False}, 404, close=True)
            return
        if not done and addr is not None and rrid is not None:
            with contextlib.suppress(Exception):
                GatewayClient(
                    addr,
                    connect_timeout_s=self.replica_connect_timeout_s,
                    read_timeout_s=5.0).cancel(rrid)
        handler.send_json({"id": rid, "cancelled": not done,
                           "done": done}, 200, close=True)

    def _handle_poll(self, handler, path: str) -> None:
        tail = path.rsplit("/", 1)[-1]
        try:
            rid = int(tail)
        except ValueError:
            handler.send_json({"error": f"bad request id {tail!r}"},
                              400, close=True)
            return
        with self._lock:
            entry = self._journal.get(rid)
            result = entry.result if entry is not None else None
        if result is not None:
            # poll is ALWAYS 200 for a stored result, whatever its
            # mapped generate-time status — the gateway's contract
            handler.send_json(result, 200, close=True)
        elif entry is not None:
            handler.send_json({"id": rid, "running": True}, 202,
                              close=True)
        else:
            handler.send_json({"error": f"unknown request {rid}"},
                              404, close=True)

    # -- health / metrics / admin --------------------------------------
    def replica_status(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r.status() for r in self._replicas]

    def _health(self) -> Dict[str, Any]:
        with self._lock:
            statuses = [r.status() for r in self._replicas]
            open_n = sum(1 for e in self._journal.values()
                         if not e.done.is_set())
        routable = any(s["state"] in ("live", "degraded")
                       for s in statuses)
        out = {"ok": routable and not self._stopped,
               "state": "stopped" if self._stopped else (
                   "live" if routable else "dead"),
               "replicas": statuses,
               "journal_entries": len(self._journal),
               "journal_open": open_n}
        if self._wal is not None:
            out["wal"] = {"path": self._wal.path,
                          "fsync": self._wal.fsync,
                          "bytes": self._wal.size_bytes,
                          "compactions":
                              self.stats["wal_compactions"],
                          "recovered_entries":
                              self.stats["recovered_entries"],
                          "recovered_open":
                              self.stats["recovered_open"]}
        return out

    def _metrics_text(self) -> str:
        with self._lock:
            gauge = getattr(self.tracer, "gauge", self.tracer.counter)
            for key, value in self.stats.items():
                gauge(f"router_{key}", value)
            by_state = {s: 0 for s in REPLICA_STATES}
            for r in self._replicas:
                by_state[r.state] += 1
            for state, n in by_state.items():
                gauge(f"router_replicas_{state.replace('-', '_')}", n)
            gauge("router_journal_open",
                  sum(1 for e in self._journal.values()
                      if not e.done.is_set()))
            if self.tenants is not None:
                # per-tenant open-request share: what the
                # per-tenant Retry-After prices, exported so an
                # operator can see WHOSE requests fill the fleet
                open_by: Dict[str, int] = {}
                for e in self._journal.values():
                    if not e.done.is_set():
                        open_by[e.tenant] = (
                            open_by.get(e.tenant, 0) + 1)
                for tenant, n in open_by.items():
                    gauge(f'router_journal_open{{tenant='
                          f'"{tenant}"}}', n)
            return self.tracer.prometheus_text()

    # -- fleet observability ------------------------
    def fleet_metrics_text(self) -> str:
        """``GET /v1/fleet/metrics`` body: every reachable replica's
        ``/v1/metrics`` exposition federated through
        :meth:`profiler.tracer.Tracer.merge_prometheus` — histogram
        families merged bucket-wise into fleet-wide distributions
        (plus ``{replica=...}``-labeled per-replica samples), counters
        summed, gauges labeled per replica — with the router's own
        tracks (``router_*`` + the ``router_replay_gap_s`` histogram)
        appended. Replicas that cannot contribute — dead or
        decommissioned (no live scrape exists), or in-state but
        failing the fetch — are skipped and NAMED in a comment line,
        so a fleet-aggregate discontinuity is explained by the scrape
        itself: it must degrade, not 500, while a replica is
        mid-death. Replica fetches run in PARALLEL, so one frozen
        replica costs the scrape one timeout, not one per replica."""
        from deeplearning4j_tpu_torch.profiler.tracer import Tracer

        with self._lock:
            targets = [(r.replica_id, r.address)
                       for r in self._replicas
                       if not r.decommissioned
                       and r.state in ("live", "degraded",
                                       "draining")]
            skipped = [r.replica_id for r in self._replicas
                       if r.decommissioned
                       or r.state not in ("live", "degraded",
                                          "draining")]
        results: Dict[str, str] = {}

        def fetch(rid: str, addr: str) -> None:
            with contextlib.suppress(GatewayError,
                                     *RETRYABLE_ERRORS):
                results[rid] = GatewayClient(
                    addr,
                    connect_timeout_s=self.replica_connect_timeout_s,
                    read_timeout_s=5.0).metrics()

        threads = [threading.Thread(target=fetch, args=t,
                                    daemon=True,
                                    name=f"fleet-metrics-{t[0]}")
                   for t in targets]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
        sources = {rid: results[rid] for rid, _ in targets
                   if rid in results}
        skipped += [rid for rid, _ in targets if rid not in results]
        parts = []
        if skipped:
            parts.append("# fleet: replicas skipped (dead, "
                         "decommissioned, or scrape failed): "
                         + ", ".join(sorted(skipped)))
        parts.append(Tracer.merge_prometheus(sources))
        parts.append(self._metrics_text())
        return "\n".join(p.rstrip("\n") for p in parts if p) + "\n"

    def _handle_fleet_metrics(self, handler) -> None:
        handler.send_bytes(self.fleet_metrics_text().encode(),
                           "text/plain; version=0.0.4", 200,
                           close=True)

    def fleet_trace_events(self) -> List[Dict[str, Any]]:
        """The STITCHED fleet trace: one
        Perfetto-loadable event list where

        - lane (Chrome ``pid``) 0 is the ROUTER — its
          ``router.route`` / ``router.queue_wait`` / ``router.replay``
          spans and ``router.breaker`` instants;
        - lane ``i+1`` is replica ``i`` — its live ``/v1/trace``
          window when reachable, else the health loop's last cached
          window (how a SIGKILLed replica's spans survive onto the
          stitched timeline);
        - every replica event's ``ts`` is skew-corrected onto the
          router's clock by that replica's scrape-RTT offset estimate
          (``ts - clock_offset_us``), so a failover reads MONOTONE:
          the dead lane's spans end, the bridging ``router.replay``
          span runs, the survivor lane's spans begin;
        - ``process_name`` metadata labels every lane, and a final
          ``fleet.stitch`` instant records per-replica offset / RTT /
          source (live vs cache) — the trace describes its own
          stitching."""
        with self._lock:
            snap = [(i, r, r.state, r.decommissioned,
                     list(r.trace_cache), r.clock_offset_us,
                     r.clock_rtt_us, r.cache_offset_us)
                    for i, r in enumerate(self._replicas)]
        events: List[Dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": "router"}},
            {"name": "process_sort_index", "ph": "M", "pid": 0,
             "args": {"sort_index": 0}},
        ]
        if hasattr(self.tracer, "events"):
            for e in self.tracer.events():
                e2 = dict(e)
                e2["pid"] = 0
                events.append(e2)
        # live fetches (window + any missing clock measurement) run
        # in PARALLEL: a frozen replica costs the stitch one timeout,
        # not one per replica — this endpoint exists for incidents,
        # which is exactly when a replica is likely to be sick
        fetched: Dict[int, Tuple[List[Dict[str, Any]],
                                 Optional[float], float]] = {}

        def fetch(i: int, replica: _Replica,
                  offset: Optional[float], rtt: float) -> None:
            probe = self._replica_client(replica, read_timeout_s=5.0)
            evts = None
            with contextlib.suppress(GatewayError,
                                     *RETRYABLE_ERRORS):
                evts = probe.trace_events().get("traceEvents", [])
            if evts is not None and offset is None:
                # replica never completed a clock-bearing scrape
                # (e.g. stitch requested before the first health
                # tick): measure once, inline
                with contextlib.suppress(GatewayError,
                                         *RETRYABLE_ERRORS):
                    t0 = self._now_us()
                    payload = probe.healthz()
                    t1 = self._now_us()
                    if payload.get("now_us") is not None:
                        offset = (float(payload["now_us"])
                                  - (t0 + t1) / 2.0)
                        rtt = t1 - t0
            if evts is not None:
                fetched[i] = (evts, offset, rtt)

        threads = [
            threading.Thread(
                target=fetch, args=(i, replica, offset, rtt),
                daemon=True, name=f"fleet-trace-{replica.replica_id}")
            for i, replica, state, dec, _, offset, rtt, _c in snap
            if not dec and state in ("live", "degraded", "draining")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=12.0)

        stitch: List[Dict[str, Any]] = []
        for (i, replica, state, dec, cache, offset, rtt,
                cache_offset) in snap:
            lane = i + 1
            if i in fetched:
                evts, offset, rtt = fetched[i]
                source = "live"
            else:
                # cached events belong to the epoch the cache was
                # scraped from: correct them with the offset
                # snapshotted ALONGSIDE the cache, not the live
                # estimate (which a death/restart may have reset)
                evts, source = cache, "cache"
                offset = cache_offset
            dead = dec or state in ("dead", "half-open")
            label = (f"replica {replica.replica_id}"
                     + (" (dead)" if dead else ""))
            events.append({"name": "process_name", "ph": "M",
                           "pid": lane, "args": {"name": label}})
            events.append({"name": "process_sort_index", "ph": "M",
                           "pid": lane,
                           "args": {"sort_index": lane}})
            for e in evts:
                e2 = dict(e)
                e2["pid"] = lane
                if offset is not None and "ts" in e2:
                    e2["ts"] = e2["ts"] - offset
                events.append(e2)
            stitch.append({
                "replica_id": replica.replica_id,
                "lane": lane, "state": state,
                "decommissioned": dec, "source": source,
                "events": len(evts),
                "clock_offset_us": offset,
                "clock_rtt_us": (None if rtt == float("inf")
                                 else rtt),
                "skew_corrected": offset is not None,
            })
        events.append({"name": "fleet.stitch", "ph": "i",
                       "ts": self._now_us(), "pid": 0, "tid": 0,
                       "s": "g", "args": {"replicas": stitch}})
        return events

    def _handle_fleet_trace(self, handler) -> None:
        """``GET /v1/trace``: the stitched fleet trace, chunk-streamed
        512 events at a time (``JsonHandler.send_trace_events`` — the
        same framing as the gateway's trace export: one downloads a
        replica, the other the fleet)."""
        handler.send_trace_events(self.fleet_trace_events())

    def _handle_request_trace(self, handler, path: str) -> None:
        """``GET /v1/requests/<id>/trace``:
        resolve the request's owning replica through the journal and
        PROXY its flight-recorder trace — the router id maps to the
        replica-side id the journal recorded. When the owner is dead
        or has evicted the record, answer with the journal's own
        breadcrumbs (routing/replay history + the streamed high-water
        mark) and a ``replayed_to`` pointer instead of a blind 404:
        the router watched every attempt, so it always has SOMETHING
        true to say about a request it journaled."""
        tail = path[len("/v1/requests/"):-len("/trace")]
        try:
            rid = int(tail)
        except ValueError:
            handler.send_json({"error": f"bad request id {tail!r}"},
                              400, close=True)
            return
        with self._lock:
            entry = self._journal.get(rid)
            if entry is None:
                addr = rrid = replica = None
            else:
                addr, rrid = entry.replica_address, entry.replica_rid
                replica = next(
                    (r for r in self._replicas if r.address == addr),
                    None)
                reachable = (replica is not None
                             and not replica.decommissioned
                             and replica.state in ("live", "degraded",
                                                   "draining"))
                router_info = {
                    "trace": entry.trace,
                    "replays": entry.replays,
                    "tokens_high_water": len(entry.tokens),
                    "finish_reason": (entry.result or {}).get(
                        "finish_reason"),
                    "e2e_s": (round(entry.done_t - entry.submit_t, 6)
                              if entry.done_t is not None else None),
                    "history": [list(h) for h in entry.history],
                }
        if entry is None:
            handler.send_json({"error": f"unknown request {rid}"},
                              404, close=True)
            return
        replayed_to = (replica.replica_id
                       if entry.replays and replica is not None
                       else None)
        if reachable and rrid is not None:
            try:
                out = GatewayClient(
                    addr,
                    connect_timeout_s=self.replica_connect_timeout_s,
                    read_timeout_s=5.0).trace(rrid)
                status = 202 if out.get("running") else 200
                out = dict(out)
                out["id"] = rid
                out["replica_id"] = replica.replica_id
                out["replica_rid"] = rrid
                if replayed_to:
                    out["replayed_to"] = replayed_to
                out["router"] = router_info
                handler.send_json(out, status, close=True)
                return
            except (GatewayError, *RETRYABLE_ERRORS):
                pass  # owner died / evicted: journal breadcrumbs
        handler.send_json({
            "id": rid, "source": "journal",
            "replayed_to": replayed_to,
            "owner": (replica.replica_id if replica is not None
                      else None),
            "owner_reachable": bool(rrid is not None and replica
                                    is not None and reachable),
            "router": router_info,
        }, 200, close=True)

    # -- elastic fleet surface -----------------------
    def add_replica(self, address: str,
                    replica_id: Optional[str] = None) -> str:
        """Runtime scale-up: register one more gateway replica and
        atomically swap it into the rendezvous set — the append
        happens under the router lock, the same lock every ``_pick``
        ranks candidates under, so a pick sees either the old set or
        the new set, never a torn one. By the rendezvous property the
        new replica claims ONLY the affinity keys that rank it first;
        every other key keeps its owner, and streams already in
        flight stay pinned to the replica they were picked onto (no
        mid-stream migration — routing is decided per attempt, not
        per token).

        ``replica_id`` should be the replica's configured stable id:
        affinity keys hash against it, and passing it here (instead
        of waiting for the first health scrape to learn it) means the
        keyspace the new replica will own is its FINAL keyspace from
        the first pick. The newcomer joins DEGRADED — routable, but
        ``live`` is earned by its first successful health scrape, so
        a caller that waits for ``replica_status`` to show ``live``
        (the fleet controller does, after its warmup handshake) is
        waiting on a real health round-trip, not the optimistic
        default a dead-on-arrival replica would also show."""
        replica = _Replica(address)
        replica.state = "degraded"
        if replica_id is not None:
            replica.replica_id = str(replica_id)
        with self._lock:
            for r in self._replicas:
                if r.decommissioned:
                    continue
                if r.address == replica.address:
                    raise ValueError(
                        f"replica {replica.address} already "
                        "registered")
                if r.replica_id == replica.replica_id:
                    raise ValueError(
                        f"replica id {replica.replica_id!r} already "
                        "registered (affinity keys hash against ids "
                        "— duplicates would fork one keyspace)")
            self._replicas.append(replica)
            self._breaker_instant(replica, "new", "degraded")
        self.tracer.incr("router_replicas_added")
        return replica.replica_id

    def remove_replica(self, replica_id: str) -> Dict[str, Any]:
        """Forget a replica that is already out of rotation
        (decommissioned or dead): the health loop stops probing it,
        it stops occupying a stitched-trace lane, and its address
        becomes reusable. Removing a live/draining replica is
        refused — drain it first (``drain_replica``), so its
        in-flight work hands off through the replay path instead of
        vanishing with the registration."""
        with self._lock:
            matches = [r for r in self._replicas
                       if replica_id in (r.replica_id, r.address)]
            if not matches:
                raise KeyError(f"unknown replica {replica_id!r}")
            # when a reused address/id matches both a stale
            # decommissioned entry and a live replica, removal means
            # the out-of-rotation one
            removable = [r for r in matches
                         if r.decommissioned or r.state == "dead"]
            replica = (removable or matches)[0]
            if not (replica.decommissioned
                    or replica.state == "dead"):
                raise ValueError(
                    f"replica {replica.replica_id} is "
                    f"{replica.state}; drain it before removing")
            self._replicas.remove(replica)
            status = replica.status()
        self.tracer.incr("router_replicas_removed")
        return status

    def live_affinity_prompts(self, cap: int = 8
                              ) -> List[List[int]]:
        """The fleet's WARM working set, from the journal: the
        block-aligned prompt prefixes of the most recently submitted
        affinity-eligible requests, deduped by affinity key, newest
        first. The fleet controller feeds these to a booting
        replica's ``/v1/warmup`` so a rolling upgrade's replacement
        joins the rendezvous set with its prefix cache already
        holding the keys it is about to own."""
        out: List[List[int]] = []
        seen: Set[bytes] = set()
        with self._lock:
            entries = list(self._journal.values())
        for entry in reversed(entries):
            key = self._affinity_key(entry.prompt)
            if key is None or key in seen:
                continue
            seen.add(key)
            b = self.affinity_block_tokens
            n = (len(entry.prompt) // b) * b
            out.append([int(t) for t in entry.prompt[:n]])
            if len(out) >= cap:
                break
        return out

    def drain_replica(self, replica_id: str,
                      timeout_s: Optional[float] = None
                      ) -> Dict[str, Any]:
        """Graceful scale-down of one replica: stop routing to it,
        ``/v1/drain`` it (in-flight work settles within the budget),
        and decommission it. Requests the drain could NOT settle end
        their relayed streams without a terminal — their relay loops
        fail over to survivors through the normal replay path, so
        from every client's point of view the requests simply
        continue. Returns the replica's drain summary plus the
        journal entries that were still open on it at drain time.

        IDEMPOTENT: the fleet controller and an
        operator will race on this. The first drain owns the work;
        any later or concurrent drain of the same replica waits for
        it and returns the FIRST drain's summary (same
        ``carried_ids``) instead of double-draining or erroring."""
        with self._lock:
            matches = [r for r in self._replicas
                       if replica_id in (r.replica_id, r.address)]
            if not matches:
                raise KeyError(f"unknown replica {replica_id!r}")
            # a reused address/id may leave a RETAINED decommissioned
            # registration alongside the live one (add_replica allows
            # the reuse); the drain the caller means is the active
            # replica's, never the stale entry's already-done summary
            active = [r for r in matches if not r.decommissioned]
            replica = (active or matches)[0]
            # capture the latch under the SAME lock that reads
            # drain_started: the failure path swaps in a fresh Event,
            # and a waiter that saw drain_started must wait on the
            # one that path will set
            done = replica.drain_done
            if replica.drain_started:
                already = True
            else:
                already = False
                replica.drain_started = True
                self._breaker_instant(replica, replica.state,
                                      "draining")
                replica.state = "draining"
                handed_off = [e.rid for e in self._journal.values()
                              if not e.done.is_set()
                              and e.replica_address
                              == replica.address]
        if already:
            done.wait(timeout=600.0)
            with self._lock:
                if replica.drain_summary is not None:
                    return dict(replica.drain_summary)
                owner_failed = not replica.drain_started
            if owner_failed:
                # the owning drain raised and released the latch —
                # retry as the new owner rather than hand the caller
                # a success-shaped dict for a drain that never ran
                return self.drain_replica(replica_id, timeout_s)
            return {"replica_id": replica.replica_id,
                    "address": replica.address, "drained": False,
                    "in_progress": True}
        try:
            try:
                summary = self._replica_client(replica).drain(
                    timeout_s)
            except (GatewayError, *RETRYABLE_ERRORS) as e:
                # failed drain = unplanned death: the breaker path
                # takes over and the same replay machinery rescues
                # the work
                self._note_failure(replica)
                summary = {"drained": False, "error": repr(e)}
        except BaseException:
            # anything unexpected must release the latch retryably —
            # a permanently-armed drain_started with no summary would
            # wedge every later drain of this replica
            with self._lock:
                replica.drain_started = False
                done, replica.drain_done = (replica.drain_done,
                                            threading.Event())
            done.set()
            raise
        with self._lock:
            self._breaker_instant(replica, replica.state, "dead")
            replica.state = "dead"
            replica.decommissioned = True
            self.stats["drained_replicas"] += 1
            self.tracer.incr("router_drained_replicas")
            out = {"replica_id": replica.replica_id,
                   "address": replica.address,
                   "open_requests_handed_off": handed_off,
                   "drain": summary}
            replica.drain_summary = out
            replica.drain_done.set()
        return dict(out)

    def _handle_drain_replica(self, handler) -> None:
        try:
            body = handler.read_json()
            replica_id = body["replica_id"]
            timeout = body.get("timeout_s")
            timeout = None if timeout is None else float(timeout)
        except (ValueError, KeyError, TypeError, AttributeError,
                UnicodeDecodeError) as e:
            handler.send_json({"error": f"bad drain body: {e}"}, 400,
                              close=True)
            return
        try:
            summary = self.drain_replica(replica_id, timeout)
        except KeyError as e:
            handler.send_json({"error": str(e)}, 404, close=True)
            return
        handler.send_json(summary, 200, close=True)
