"""Elastic fleet controller: SLO-driven autoscaling and zero-downtime
rolling upgrades over the multi-replica router ("the fleet
breathes").

A copy of ``deeplearning4j_tpu/serving/controller.py`` with imports
rewritten: the control loop, ``decide`` and the rolling upgrade are
the JAX package's, over the port's router and replica handles.

Every primitive this composes already exists: subprocess replica
lifecycle (serving/replica_proc.py), runtime rendezvous-set swap
(``ServingRouter.add_replica`` / ``remove_replica``), graceful
scale-down with journal-driven in-flight replay
(``ServingRouter.drain_replica`` → the earlier replay path), the
boot-with-warmup handshake (``ServingGateway.warmup``), the federated
metrics scrape (``/v1/fleet/metrics``), and the breaker state machine.
What was missing is the CONTROL LOOP — the thing that reads the
fleet's vital signs and decides, so the fleet is no longer statically
sized and a model upgrade is no longer downtime.

**The loop.** Every ``eval_interval_s`` the controller reads two
signals:

- *pressure* — router-side in-flight requests per live slot
  (``replica_status``: exact, already maintained under the router
  lock; a scrape-lag-free load figure), and
- *TTFT p99 over the last window* — from the federated
  ``serving_ttft_s`` histogram: the scrape keeps the previous
  cumulative bucket counts and differences them, so the quantile
  describes the requests of the LAST window, not the server's whole
  uptime (a cumulative p99 would never recover after one bad burst —
  useless as a control signal).

**Flap damping.** A bursty load must not flap the fleet, so three
mechanisms stack: *hysteresis* (scale-up needs ``pressure_high`` OR a
TTFT-SLO breach, scale-down needs pressure BELOW the much lower
``pressure_low`` — between the thresholds nothing moves), *streaks*
(the breach/idle condition must hold ``breach_evals`` /
``idle_evals`` CONSECUTIVE evaluations; one spiky tick resets to
zero), and a *cooldown* (after any scale event, no further events for
``cooldown_s`` — a fresh replica needs a beat to absorb load before
its effect is judged).

**Scale-up** spawns a replica through the ``replica_factory``
(subprocess or in-process — the controller never knows), warms its
prefix cache with the fleet's live affinity keys
(``ServingRouter.live_affinity_prompts`` → ``/v1/warmup``), and
atomically swaps it into the rendezvous set. **Scale-down** drains
the least-loaded live replica through the idempotent
``drain_replica`` — its unfinished streams hand off to survivors via
the replay path, so scale events inherit the suite's zero-lost-request
discipline — then reaps the process.

**Rolling upgrade** (zero-downtime): for each old replica, one at a
time — boot a replacement under a fresh stable id, warm it, add it
(the rendezvous property shifts ONLY the keys that rank the newcomer
first: the keyspace migrates gradually, one replica's worth per
step), drain the old one through the replay path, decommission, reap.
In-flight greedy streams on the drained replica resume bit-identically
on survivors; the upgrade-under-churn soak
(scripts/upgrade_soak.py) gates ZERO dropped and ZERO double-delivered
requests with a SIGKILL injected mid-upgrade.

**Observability.** Every scale decision is a ``fleet.scale`` span on
the router's tracer — lane 0 of the stitched ``/v1/trace``,
so a scaling timeline reads in the same Perfetto view as the traffic
it reacted to — plus ``fleet_replicas`` / ``fleet_pressure`` gauges
and ``fleet_scale_events`` counters in the federation.

The controller is a sidecar on the router (same process, own thread):
``FleetController(router, factory).start()``; ``close()`` stops the
loop and leaves the fleet as it stands."""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.serving.client import GatewayClient


class FleetController:
    """SLO-driven autoscaler + rolling-upgrade driver over one
    :class:`~deeplearning4j_tpu_torch.serving.ServingRouter`.

    Parameters:

    - ``router`` — a started ServingRouter; the controller shares its
      tracer (``fleet.scale`` spans land on the stitched trace's
      router lane).
    - ``replica_factory`` — ``factory(replica_id) -> handle``
      returning a READY replica handle (``address`` / ``replica_id``
      / ``shutdown()`` — serving/replica_proc.py). None = the
      controller can only observe and drain, never spawn.
    - ``min_replicas`` / ``max_replicas`` — fleet size bounds the
      loop never crosses (manual ``scale_down(replica_id=...)`` may).
    - ``eval_interval_s`` — control-loop period.
    - ``ttft_p99_slo_s`` — the latency SLO: windowed fleet TTFT p99
      above it is a breach. ``None`` disables the federated scrape
      (pressure-only control).
    - ``pressure_high`` / ``pressure_low`` — in-flight-per-slot
      hysteresis band: above high = breach, below low = idle, between
      = hold.
    - ``breach_evals`` / ``idle_evals`` — consecutive evaluations the
      condition must hold before acting (idle is deliberately the
      longer streak: scaling down too eagerly re-pays replica boot on
      the next burst).
    - ``cooldown_s`` — no further scale events for this long after
      any scale event.
    - ``warm_on_scale`` — run the warmup handshake on every spawned
      replica (live affinity keys from the router journal).

    ``events`` is the scale timeline (list of dicts, one per event,
    with ``recovered_after_s`` filled in when the breach that caused
    an up-scale clears); ``last_signals`` the most recent evaluation's
    inputs + verdicts — between them a soak (or an operator) can
    replay every decision the loop made."""

    def __init__(self, router,
                 replica_factory: Optional[
                     Callable[[str], Any]] = None,
                 min_replicas: int = 1, max_replicas: int = 4,
                 eval_interval_s: float = 0.5,
                 ttft_p99_slo_s: Optional[float] = None,
                 pressure_high: float = 2.0,
                 pressure_low: float = 0.25,
                 breach_evals: int = 2, idle_evals: int = 6,
                 cooldown_s: float = 3.0,
                 slo_tenant: Optional[str] = None,
                 warm_on_scale: bool = True,
                 warm_prompts_cap: int = 8,
                 drain_timeout_s: float = 2.0,
                 await_live_timeout_s: float = 60.0,
                 retain_decommissioned: int = 8,
                 id_prefix: str = "auto"):
        if min_replicas < 1:
            raise ValueError(f"min_replicas {min_replicas} < 1")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas {max_replicas} < min_replicas "
                f"{min_replicas}")
        if pressure_low >= pressure_high:
            raise ValueError(
                f"pressure_low {pressure_low} must sit below "
                f"pressure_high {pressure_high} (the hysteresis "
                "band is the flap damper)")
        self.router = router
        self.replica_factory = replica_factory
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.eval_interval_s = float(eval_interval_s)
        self.ttft_p99_slo_s = ttft_p99_slo_s
        self.pressure_high = float(pressure_high)
        self.pressure_low = float(pressure_low)
        self.breach_evals = max(int(breach_evals), 1)
        self.idle_evals = max(int(idle_evals), 1)
        self.cooldown_s = float(cooldown_s)
        #: tenancy-aware SLO accounting: when set, the
        #: windowed TTFT p99 is read from the fleet's
        #: ``serving_ttft_s{tenant="<slo_tenant>"}`` labeled family
        #: instead of the all-traffic one — a rate-throttled
        #: flooder's self-inflicted queueing (its OWN requests
        #: waiting out quota) can no longer page the autoscaler;
        #: the fleet scales for the tenant the SLO was promised to
        self.slo_tenant = slo_tenant
        self.warm_on_scale = bool(warm_on_scale)
        self.warm_prompts_cap = int(warm_prompts_cap)
        self.drain_timeout_s = drain_timeout_s
        self.await_live_timeout_s = float(await_live_timeout_s)
        self.retain_decommissioned = max(int(retain_decommissioned),
                                         0)
        self.id_prefix = str(id_prefix)
        self.tracer = router.tracer
        #: handles the controller owns (spawned or adopted): the ones
        #: it may reap on scale-down/upgrade
        self._handles: Dict[str, Any] = {}
        self._ids = itertools.count()
        #: serializes scale actions (loop, manual calls, upgrade) —
        #: two concurrent spawns would both think they are the one
        #: replica the fleet needed
        self._scale_lock = threading.RLock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="fleet-controller")
        self._breach_streak = 0
        self._idle_streak = 0
        self._cooldown_until = 0.0
        self._reason = ""
        self._prev_ttft: Optional[
            Tuple[List[str], List[int]]] = None
        self._pending_recovery: Optional[
            Tuple[Dict[str, Any], float]] = None
        self._t0 = time.monotonic()
        self.events: List[Dict[str, Any]] = []
        self.last_signals: Dict[str, Any] = {}
        self.stats = {"evals": 0, "errors": 0}

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "FleetController":
        self._thread.start()
        return self

    def __enter__(self) -> "FleetController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop the control loop. The fleet stays as it stands — the
        controller is a pilot, not the airframe."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10.0
                              + 2 * self.eval_interval_s)

    def adopt(self, handle) -> None:
        """Register a pre-existing replica handle (e.g. the seed
        fleet a soak booted itself) so scale-down/upgrade can reap
        its process, not just drain its traffic."""
        self._handles[handle.replica_id] = handle

    def attach(self, router) -> None:
        """Re-attach the controller to a RESTARTED router:
        the control plane must survive the same faults the fleet
        does, and a router recovered from its write-ahead journal is
        a new object on the same fleet. The swap happens under the
        scale lock (no scale action sees a torn router reference),
        the tracer follows the new router (scale spans land on the
        lane the new stitched trace serves), windowed-TTFT deltas
        reset (the new router's counters restart from its own
        scrape epoch — a stale delta would fake a breach or mask
        one), and breach/idle streaks restart: the controller
        re-learns the fleet's state from live scrapes rather than
        acting on pre-crash momentum. Replica handles stay adopted —
        the processes never died."""
        with self._scale_lock:
            self.router = router
            self.tracer = router.tracer
            self._prev_ttft = None
            self._pending_recovery = None
            self._breach_streak = 0
            self._idle_streak = 0
        self.tracer.incr("fleet_controller_reattached")

    def shutdown_fleet(self) -> None:
        """Reap every handle the controller owns (soak/test
        teardown)."""
        from deeplearning4j_tpu_torch.serving.replica_proc import (
            shutdown_all,
        )

        shutdown_all(list(self._handles.values()))
        self._handles.clear()

    def _now_us(self) -> float:
        f = getattr(self.tracer, "now_us", None)
        return float(f()) if f else (
            (time.monotonic() - self._t0) * 1e6)

    # -- signals -------------------------------------------------------
    def signals(self) -> Dict[str, Any]:
        """One evaluation's inputs: live replica count, router-exact
        pressure (in-flight per live slot), queue depth, and the
        windowed fleet TTFT p99 (None when the SLO is off, on the
        first scrape, or when no request finished this window)."""
        status = self.router.replica_status()
        live = [s for s in status
                if s["state"] in ("live", "degraded")]
        slots = sum(max(s["n_slots"], 1) for s in live) or 1
        inflight = sum(s["open_requests"] for s in status)
        queued = sum(s["queue_depth"] for s in live)
        ttft_p99, window_n = self._window_ttft_p99()
        return {
            "n_live": len(live),
            "n_registered": len(status),
            "slots": slots,
            "inflight": inflight,
            "queued": queued,
            "pressure": inflight / slots,
            "ttft_p99_s": ttft_p99,
            "ttft_window_n": window_n,
        }

    def _window_ttft_p99(self
                         ) -> Tuple[Optional[float], int]:
        """Fleet TTFT p99 over the LAST window: scrape the federated
        ``serving_ttft_s`` family and difference its cumulative
        bucket counts against the previous scrape. Cumulative counts
        of a window's observations are still cumulative counts, so
        the p99 read is exact at bucket resolution — and it RECOVERS
        when the fleet does, which an uptime-cumulative quantile
        never would. Degrades to None (no verdict) on the first
        scrape, an empty window, a mid-scrape replica death (counts
        regress), or any scrape failure."""
        if self.ttft_p99_slo_s is None:
            return None, 0
        from deeplearning4j_tpu_torch.profiler.tracer import (
            parse_exposition,
        )

        try:
            text = self.router.fleet_metrics_text()
        except Exception:
            self.tracer.incr("fleet_controller_scrape_errors")
            return None, 0
        h = parse_exposition(text)["histograms"].get(
            "serving_ttft_s")
        if h and self.slo_tenant:
            # the SLO belongs to ONE tenant: difference that
            # tenant's labeled fleet family (merged per label set by
            # merge_prometheus), not the all-traffic one
            h = h.get("labeled", {}).get(
                f'tenant="{self.slo_tenant}"')
        if not h or not h["les"]:
            return None, 0
        les, cums = list(h["les"]), list(h["cums"])
        prev = self._prev_ttft
        self._prev_ttft = (les, cums)
        if prev is None or prev[0] != les:
            return None, 0
        window = [c - p for c, p in zip(cums, prev[1])]
        total = window[-1]  # the +Inf cum is the window count
        if total <= 0 or any(c < 0 for c in window):
            return None, 0  # empty window / replica died mid-window
        rank = 0.99 * total
        for i, (le, c) in enumerate(zip(les, window)):
            if c >= rank:
                if le == "+Inf":  # clamp like Histogram.quantile
                    return (float(les[i - 1]) if i else None), total
                return float(le), total
        return float(les[-2]) if len(les) > 1 else None, total

    # -- the decision (pure w.r.t. the fleet: tests drive it with
    # synthetic signals) -------------------------------------------------
    def decide(self, sig: Dict[str, Any],
               now: Optional[float] = None) -> Optional[str]:
        """Fold one evaluation into the streak/cooldown state and
        return the action: ``"up"``, ``"down"``, or None. The three
        flap dampers in order: hysteresis band (breach above
        ``pressure_high``/SLO, idle below ``pressure_low``, HOLD
        between), consecutive-eval streaks, cooldown after any
        event."""
        now = time.monotonic() if now is None else now
        reasons = []
        if sig["pressure"] > self.pressure_high:
            reasons.append(
                f"pressure {sig['pressure']:.2f} > "
                f"{self.pressure_high:g}")
        ttft = sig.get("ttft_p99_s")
        if (self.ttft_p99_slo_s is not None and ttft is not None
                and ttft > self.ttft_p99_slo_s):
            reasons.append(
                f"ttft_p99 {ttft:.3f}s > SLO "
                f"{self.ttft_p99_slo_s:g}s")
        breach = bool(reasons)
        idle = not breach and sig["pressure"] < self.pressure_low
        self._breach_streak = self._breach_streak + 1 if breach else 0
        self._idle_streak = self._idle_streak + 1 if idle else 0
        if not breach and self._pending_recovery is not None:
            # the breach that caused the last scale-up has cleared:
            # stamp how long the fleet took to absorb it (the
            # diurnal soak gates this against the cooldown budget)
            ev, t_ev = self._pending_recovery
            ev["recovered_after_s"] = round(now - t_ev, 3)
            self._pending_recovery = None
        sig = dict(sig, breach=breach, idle=idle,
                   breach_streak=self._breach_streak,
                   idle_streak=self._idle_streak,
                   reasons=reasons)
        self.last_signals = sig
        if now < self._cooldown_until:
            return None
        if (breach and self._breach_streak >= self.breach_evals
                and sig["n_live"] < self.max_replicas):
            self._reason = "; ".join(reasons)
            return "up"
        if (idle and self._idle_streak >= self.idle_evals
                and sig["n_live"] > self.min_replicas):
            self._reason = (
                f"idle: pressure {sig['pressure']:.2f} < "
                f"{self.pressure_low:g} for "
                f"{self._idle_streak} evals")
            return "down"
        return None

    def _loop(self) -> None:
        while not self._stop.wait(self.eval_interval_s):
            if not self._scale_lock.acquire(blocking=False):
                continue  # an upgrade/manual scale is mid-flight:
                #           judging the fleet now would double-act
            try:
                sig = self.signals()
                self.stats["evals"] += 1
                self.tracer.gauge("fleet_replicas", sig["n_live"])
                self.tracer.gauge("fleet_pressure",
                                  round(sig["pressure"], 4))
                if sig["ttft_p99_s"] is not None:
                    self.tracer.gauge("fleet_ttft_p99_window_s",
                                      sig["ttft_p99_s"])
                action = self.decide(sig)
                if action == "up":
                    self.scale_up(reason=self._reason)
                elif action == "down":
                    self.scale_down(reason=self._reason)
            except Exception:
                # the control loop must never die to one bad scrape
                # or one failed spawn: count it, keep flying — but
                # back off a full cooldown first, or a persistent
                # breach would retry the failed spawn EVERY tick
                self.stats["errors"] += 1
                self.tracer.incr("fleet_controller_errors")
                self._cooldown_until = (time.monotonic()
                                        + self.cooldown_s)
            finally:
                self._scale_lock.release()

    # -- scale actions ---------------------------------------------------
    def _note_event(self, action: str, replica: str, reason: str,
                    t0_us: float, **extra: Any) -> Dict[str, Any]:
        """One scale decision, made visible everywhere at once: the
        ``fleet.scale`` span on the stitched trace's router lane, the
        federated counters, and the controller's own timeline."""
        now_us = self._now_us()
        n_live = sum(1 for s in self.router.replica_status()
                     if s["state"] in ("live", "degraded"))
        if hasattr(self.tracer, "complete"):
            self.tracer.complete(
                "fleet.scale", t0_us, max(now_us - t0_us, 0.0),
                action=action, replica=replica, reason=reason,
                n_replicas=n_live, **extra)
        self.tracer.incr("fleet_scale_events")
        self.tracer.incr(f"fleet_scale_{action}_total")
        now = time.monotonic()
        event = {"t_s": round(now - self._t0, 3), "action": action,
                 "replica": replica, "reason": reason,
                 "n_live": n_live,
                 "dur_s": round((now_us - t0_us) / 1e6, 3), **extra}
        self.events.append(event)
        self._cooldown_until = now + self.cooldown_s
        self._breach_streak = self._idle_streak = 0
        return event

    def _spawn(self) -> Any:
        if self.replica_factory is None:
            raise RuntimeError(
                "no replica_factory configured: this controller can "
                "observe and drain but not spawn")
        rid = f"{self.id_prefix}-{next(self._ids)}"
        handle = self.replica_factory(rid)
        self._handles[handle.replica_id] = handle
        return handle

    def _warm(self, handle) -> Optional[int]:
        """The boot-with-warmup handshake: live affinity keys from
        the router journal into the new replica's prefix cache,
        BEFORE any keyspace shifts onto it.

        warmup now ships KV instead of regenerating it —
        the router's ``warm_transfer`` pulls each key's warm peer
        export and imports it into the newcomer (blocks move, no
        prefill runs). Prompts the transfer plane cannot cover (no
        capable donor, dense newcomer, transfer fault) fall back to
        the earlier greedy-generation ``/v1/warmup`` handshake, so the
        newcomer is never LESS warm than before."""
        prompts = self.router.live_affinity_prompts(
            cap=self.warm_prompts_cap)
        if not prompts:
            return 0
        warmed = 0
        cold = prompts
        transfer = getattr(self.router, "warm_transfer", None)
        if transfer is not None:
            try:
                out = transfer(handle.address, prompts,
                               receiver_id=handle.replica_id)
                warmed += int(out.get("imported", 0))
                cold = out.get("cold", prompts)
            except Exception:
                self.tracer.incr("fleet_warmup_errors")
                cold = prompts
        if not cold:
            return warmed
        try:
            out = GatewayClient(
                handle.address, timeout_s=60.0).warmup(cold)
            return warmed + int(out.get("warmed", 0))
        except Exception:
            # a cold cache is a performance bug, not a correctness
            # one: join anyway
            self.tracer.incr("fleet_warmup_errors")
            return warmed if warmed else None

    def _await_live(self, replica_id: str) -> None:
        """Block until the router's health loop marks the new replica
        live — only then may an upgrade drain the old one (draining
        first would shrink the serving set)."""
        deadline = time.monotonic() + self.await_live_timeout_s
        while time.monotonic() < deadline:
            for s in self.router.replica_status():
                if (s["replica_id"] == replica_id
                        and s["state"] == "live"):
                    return
            if self._stop.is_set():
                raise RuntimeError("controller stopped")
            time.sleep(min(self.router.health_interval_s / 2, 0.05))
        raise RuntimeError(
            f"replica {replica_id} never reached live within "
            f"{self.await_live_timeout_s}s")

    def _join(self, handle) -> None:
        """Atomic rendezvous swap + wait-live, with rollback: a
        replica that never reaches live must not stay registered (a
        zombie lane the health loop probes forever, whose address
        could never re-register) nor keep its process."""
        self.router.add_replica(handle.address,
                                replica_id=handle.replica_id)
        try:
            self._await_live(handle.replica_id)
        except BaseException:
            with contextlib.suppress(Exception):
                self.router.drain_replica(handle.replica_id,
                                          timeout_s=0.1)
            with contextlib.suppress(Exception):
                self.router.remove_replica(handle.replica_id)
            self._handles.pop(handle.replica_id, None)
            with contextlib.suppress(Exception):
                handle.shutdown()
            raise

    def scale_up(self, reason: str = "manual") -> str:
        """Spawn → warm → atomic rendezvous swap → wait live. Returns
        the new replica's id."""
        with self._scale_lock:
            t0 = self._now_us()
            handle = self._spawn()
            warmed = (self._warm(handle) if self.warm_on_scale
                      else None)
            self._join(handle)
            ev = self._note_event("up", handle.replica_id, reason,
                                  t0, warmed=warmed)
            self._pending_recovery = (ev, time.monotonic())
            return handle.replica_id

    def _prune_decommissioned(self) -> None:
        """A fleet that breathes for days accumulates decommissioned
        registrations (each kept for its stitched-trace dead lane
        and breadcrumb history): retain the newest
        ``retain_decommissioned``, forget the rest — recent scale
        events stay debuggable, memory stays bounded."""
        dec = [s["replica_id"]
               for s in self.router.replica_status()
               if s.get("decommissioned")]
        for rid in dec[:max(len(dec)
                            - self.retain_decommissioned, 0)]:
            with contextlib.suppress(Exception):
                self.router.remove_replica(rid)

    def scale_down(self, replica_id: Optional[str] = None,
                   reason: str = "manual") -> Optional[str]:
        """Drain the least-loaded live replica (or the named one)
        through the idempotent replay-backed drain, then reap its
        process if the controller owns it. Returns the drained id,
        or None when the loop-chosen drain would cross
        ``min_replicas``."""
        with self._scale_lock:
            status = self.router.replica_status()
            live = [s for s in status
                    if s["state"] in ("live", "degraded")]
            if replica_id is None:
                if len(live) <= self.min_replicas:
                    return None
                # least loaded first; prefer a replica we can
                # actually reap on a tie
                live.sort(key=lambda s: (
                    s["open_requests"] + s["queue_depth"],
                    s["replica_id"] not in self._handles))
                replica_id = live[0]["replica_id"]
            t0 = self._now_us()
            summary = self.router.drain_replica(
                replica_id, timeout_s=self.drain_timeout_s)
            handle = self._handles.pop(replica_id, None)
            if handle is not None:
                handle.shutdown()
            self._note_event(
                "down", replica_id, reason, t0,
                handed_off=len(summary.get(
                    "open_requests_handed_off") or []))
            self._prune_decommissioned()
            return replica_id

    # -- zero-downtime rolling upgrade -----------------------------------
    def rolling_upgrade(self, replica_factory: Optional[
                            Callable[[str], Any]] = None,
                        drain_timeout_s: Optional[float] = None
                        ) -> Dict[str, Any]:
        """Replace every registered replica, one at a time, with a
        factory-fresh one — zero downtime, zero dropped requests:

        for each old replica:
          1. boot the replacement under a FRESH stable id (never
             reuse the old id: affinity keys hash against ids, and a
             reused id would hand the newcomer a warm-looking
             keyspace it has not earned);
          2. warm its prefix cache from the fleet's live affinity
             keys (``/v1/warmup`` — the boot handshake);
          3. ``add_replica`` — the atomic rendezvous swap shifts
             ONLY the keys that rank the newcomer first (gradual
             keyspace migration, one replica's worth per step);
          4. wait until the router's health loop marks it live;
          5. ``drain_replica(old)`` — in-flight streams hand off to
             survivors through the journal replay path (greedy:
             bit-identical resumption; the drain is idempotent, so
             racing an operator is safe);
          6. reap the old process.

        A replica that DIES mid-upgrade (the injected SIGKILL in the
        churn soak) is simply found dead at its step: the breaker
        already replayed its in-flight work, its drain degrades to a
        decommission, and the upgrade proceeds. Returns the step
        summaries."""
        factory = replica_factory or self.replica_factory
        if factory is None:
            raise RuntimeError("rolling_upgrade needs a "
                               "replica_factory")
        steps: List[Dict[str, Any]] = []
        with self._scale_lock:
            targets = [s["replica_id"]
                       for s in self.router.replica_status()
                       if not s.get("decommissioned")]
            for old_id in targets:
                t0 = self._now_us()
                rid = f"{self.id_prefix}-{next(self._ids)}"
                new = factory(rid)
                self._handles[new.replica_id] = new
                warmed = (self._warm(new) if self.warm_on_scale
                          else None)
                self._join(new)
                try:
                    summary = self.router.drain_replica(
                        old_id,
                        timeout_s=(self.drain_timeout_s
                                   if drain_timeout_s is None
                                   else drain_timeout_s))
                except KeyError:
                    summary = {"replica_id": old_id,
                               "missing": True}
                old_handle = self._handles.pop(old_id, None)
                if old_handle is not None:
                    old_handle.shutdown()
                ev = self._note_event(
                    "upgrade", new.replica_id,
                    f"replace {old_id}", t0,
                    from_replica=old_id, warmed=warmed,
                    handed_off=len(summary.get(
                        "open_requests_handed_off") or []))
                steps.append(dict(ev, drain=summary.get("drain")))
            self._prune_decommissioned()
        return {"upgraded": len(steps), "replaced": targets,
                "steps": steps}
