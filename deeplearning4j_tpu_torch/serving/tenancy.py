"""Multi-tenant QoS: priority classes, per-tenant quotas, and
weighted-fair scheduling under overload (a copy of
``deeplearning4j_tpu/serving/tenancy.py`` over the port's scheduler).

Before this module, overload was one global bounded queue with
shed-oldest/reject-new: every request anonymous and equal, so a single
flooding client could starve everyone. The tenancy subsystem gives
every request an identity (``Request.tenant``) and a service class,
and composes THREE mechanisms — all from in-repo primitives — into
differentiated service:

- :class:`TenantRegistry` / :class:`TenantSpec` — per-tenant priority
  class, fair-share ``weight``, concurrent-slot quota (``max_slots``),
  queue bound (``max_queued``), and router-level token-bucket rate
  limit (``rate_rps``/``burst``). A ``default`` tenant with no quotas
  preserves every existing caller unchanged, and a reserved ``system``
  tenant (warmup handshakes, boot traffic) outranks user
  classes and never bills a user quota.
- :class:`WeightedFairScheduler` — a weighted-fair admission queue
  over the base :class:`~deeplearning4j_tpu_torch.serving.scheduler.
  Scheduler`: per-tenant token accounting with deficit carry-over in
  its numerically robust normalized-service form (stride / start-time
  fair queuing — each tenant's virtual pass is served tokens over
  weight, so a backlogged tenant's unserved entitlement carries over
  as a LOW pass, and a tenant whose backlog empties re-joins at the
  current virtual time instead of hoarding idle credit). Admission
  charges prompt tokens, each decode round charges committed tokens
  (``note_usage``), and the next admission goes to the highest
  ``(priority, underserved-ness)`` tenant with slot budget left.
  ``plan_preemptions`` names the over-quota slots to evict when a
  same-or-higher-priority arrival would otherwise wait behind a
  flooder's decode rounds — the engine preempts them through its
  recompute-preemption path (requeue + re-prefill; greedy ids
  regenerate bit-identically, so preemption is invisible to results).
- :class:`TokenBucket` — the router's per-tenant rate limiter: a
  flooder sheds at the front door with its OWN Retry-After (time to
  the next token + its queue share) while other tenants' keyspace
  stays untouched.

Tenancy is FREE when unused: an engine built without a registry keeps
the seed FIFO scheduler and does zero per-tenant bookkeeping, and a
registry whose only traffic is the ``default`` tenant admits in
arrival order exactly like FIFO (one backlogged tenant's fair order IS
arrival order)."""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.serving.scheduler import (
    Request,
    Scheduler,
    validate_tenant,
)

#: the tenant every unlabeled request belongs to — no quotas, weight
#: 1, priority 0: a fleet that never configures tenancy behaves
#: exactly as before
DEFAULT_TENANT = "default"
#: reserved tenant for INFRASTRUCTURE traffic (the ``/v1/warmup``
#: boot handshake): outranks every user class, exempt from
#: quotas and rate limits, never bills a user's share
SYSTEM_TENANT = "system"
#: the system tenant's priority class — any user-assignable priority
#: sits below it
SYSTEM_PRIORITY = 1_000_000


@dataclasses.dataclass
class TenantSpec:
    """One tenant's service class.

    - ``priority`` — admission class: higher admits first, and a
      waiting higher-priority request may preempt a lower class's
      OVER-QUOTA slot. A request may carry its own ``priority``, but
      it is clamped to the spec's (a tenant cannot self-boost).
    - ``weight`` — fair-share weight for the deficit accounting:
      among backlogged tenants of equal priority, committed tokens
      converge to the weight ratio.
    - ``max_slots`` — concurrent-slot quota (None = unlimited): the
      scheduler never admits the tenant past it while others wait,
      and slots beyond it are preemptible by waiting traffic.
    - ``max_queued`` — per-tenant admission-queue bound (None =
      unlimited): the tenant's own submits shed (429) past it,
      whatever the global queue holds — a flooder fills its own
      bucket, not the shared one.
    - ``rate_rps`` / ``burst`` — router-level token bucket (None =
      unlimited): requests per second with ``burst`` tokens of
      headroom (default ``max(2 * rate, 1)``)."""

    tenant: str
    priority: int = 0
    weight: float = 1.0
    max_slots: Optional[int] = None
    max_queued: Optional[int] = None
    rate_rps: Optional[float] = None
    burst: Optional[float] = None

    def __post_init__(self):
        self.tenant = validate_tenant(self.tenant)
        self.priority = int(self.priority)
        self.weight = float(self.weight)
        if self.weight <= 0:
            raise ValueError(f"weight {self.weight} <= 0")
        for name in ("max_slots", "max_queued"):
            val = getattr(self, name)
            if val is not None:
                val = int(val)
                setattr(self, name, val)
                if val < 1:
                    raise ValueError(
                        f"{name} {val} < 1 (use None for unlimited)")
        if self.rate_rps is not None:
            self.rate_rps = float(self.rate_rps)
            if self.rate_rps <= 0:
                raise ValueError(
                    f"rate_rps {self.rate_rps} <= 0 (use None for "
                    "unlimited)")
        if self.burst is not None:
            self.burst = float(self.burst)
            if self.burst < 1:
                raise ValueError(f"burst {self.burst} < 1")

    @classmethod
    def parse(cls, text: str) -> "TenantSpec":
        """CLI spelling: ``name[:key=value]...`` with keys
        ``priority`` | ``weight`` | ``slots`` | ``queue`` | ``rps`` |
        ``burst`` — e.g. ``premium:priority=2:weight=4:slots=4:rps=50``
        (the ``--tenant`` flag of ``serve``)."""
        parts = str(text).split(":")
        kwargs: Dict[str, Any] = {"tenant": parts[0]}
        keymap = {"priority": "priority", "weight": "weight",
                  "slots": "max_slots", "queue": "max_queued",
                  "rps": "rate_rps", "burst": "burst"}
        for part in parts[1:]:
            key, eq, value = part.partition("=")
            if not eq or key not in keymap:
                raise ValueError(
                    f"tenant spec {text!r}: expected "
                    "name[:key=value]... with keys "
                    f"{sorted(keymap)}; got segment {part!r}")
            kwargs[keymap[key]] = float(value) if "." in value \
                else int(value) if key != "weight" else float(value)
        return cls(**kwargs)


class TenantRegistry:
    """The fleet's tenant table. Always holds ``default`` (the
    unlabeled-caller class: no quotas, so a tenancy-enabled engine
    serves legacy traffic unchanged) and ``system`` (warmup/boot
    traffic: top priority, quota- and rate-exempt). Unknown tenants
    resolve to a default-shaped spec under their own name, so
    accounting stays per-tenant even for names nobody registered."""

    def __init__(self, specs: Tuple[TenantSpec, ...] = ()):
        self._specs: Dict[str, TenantSpec] = {}
        self.register(TenantSpec(DEFAULT_TENANT))
        self.register(TenantSpec(SYSTEM_TENANT,
                                 priority=SYSTEM_PRIORITY,
                                 weight=0.25))
        for spec in specs:
            self.register(spec)

    def register(self, spec: TenantSpec) -> TenantSpec:
        if not isinstance(spec, TenantSpec):
            raise TypeError(
                f"expected TenantSpec, got {type(spec).__name__}")
        if spec.tenant == SYSTEM_TENANT and spec.max_slots is not None:
            raise ValueError(
                "the system tenant is quota-exempt by contract "
                "(warmup must never deadlock behind a user quota)")
        self._specs[spec.tenant] = spec
        return spec

    def spec_of(self, tenant: str) -> TenantSpec:
        spec = self._specs.get(tenant)
        if spec is None:
            # unknown tenants get default-CLASS service under their
            # own name: per-tenant accounting without registration
            default = self._specs[DEFAULT_TENANT]
            spec = dataclasses.replace(default, tenant=tenant)
        return spec

    def effective_priority(self, request: Request) -> int:
        """The priority a request actually admits at: the spec's
        class, lowered (never raised) by an explicit
        ``Request.priority`` — a tenant can de-prioritize its own
        batch traffic but cannot self-boost past its class."""
        spec = self.spec_of(request.tenant)
        if request.priority is None:
            return spec.priority
        return min(int(request.priority), spec.priority)

    def tenants(self) -> List[str]:
        return sorted(self._specs)

    def to_dict(self) -> Dict[str, Any]:
        """Snapshot wire format (plain JSON) — restore rebuilds the
        registry so a drained engine's quotas survive the process."""
        return {"specs": [dataclasses.asdict(s)
                          for s in self._specs.values()]}

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "TenantRegistry":
        reg = cls()
        for spec in data.get("specs", []):
            reg.register(TenantSpec(**spec))
        return reg


class TokenBucket:
    """Deterministic token bucket (the router's per-tenant rate
    limiter): ``rate_rps`` tokens/s up to ``burst`` capacity.
    ``try_take`` either consumes and returns 0.0, or returns the
    seconds until enough tokens accrue — the per-tenant Retry-After
    seed. ``clock`` is injectable for tests."""

    def __init__(self, rate_rps: float, burst: Optional[float] = None,
                 clock=time.monotonic):
        self.rate = float(rate_rps)
        if self.rate <= 0:
            raise ValueError(f"rate_rps {rate_rps} <= 0")
        self.capacity = float(burst if burst is not None
                              else max(2.0 * self.rate, 1.0))
        self.tokens = self.capacity
        self._clock = clock
        self._t = clock()

    def try_take(self, n: float = 1.0) -> float:
        now = self._clock()
        self.tokens = min(self.capacity,
                          self.tokens + (now - self._t) * self.rate)
        self._t = now
        if self.tokens >= n:
            self.tokens -= n
            return 0.0
        return (n - self.tokens) / self.rate

    def restore_level(self, tokens: float,
                      age_s: float = 0.0) -> None:
        """Overwrite the level with a persisted one (the
        router's WAL carries bucket levels through a crash).
        ``tokens`` is the level as of ``age_s`` seconds ago; refill
        accrues for exactly that downtime, capped at capacity — a
        restarted router neither refills a flooder's bucket nor
        forgets real elapsed time."""
        self.tokens = min(
            self.capacity,
            max(0.0, float(tokens))
            + max(0.0, float(age_s)) * self.rate)
        self._t = self._clock()


class WeightedFairScheduler(Scheduler):
    """Deficit-round-robin admission over per-tenant queues.

    The base scheduler's FIFO deque (``_queue``) stays authoritative
    for arrival order — pressure, snapshots, deadline sweeps, and the
    adaptive-prefill machinery read it unchanged — while a per-tenant
    index (``_tq``) drives SELECTION.

    Fair-share accounting is NORMALIZED SERVICE (stride / start-time
    fair queuing — the numerically robust form of deficit
    round-robin): every tenant carries a virtual ``pass``
    (``tokens served / weight``); admission charges the prompt
    tokens and every decode round charges the committed tokens
    (``note_usage``), so among equal-priority backlogged tenants the
    next admission always goes to the most UNDERSERVED one, and
    served tokens converge to the weight ratio. Unused entitlement
    carries over exactly as long as the tenant stays backlogged (a
    low pass IS banked deficit); a tenant whose backlog empties
    drops its pass and re-joins at the current virtual time, so idle
    time can never be hoarded into a later monopoly — the naive
    per-round quantum refill this replaces saturated at its
    carry-over cap under sustained load and degraded to weight-blind
    alternation.

    - ``begin_round(running)`` (engine, once per step): snapshot the
      per-tenant slot occupancy (quota accounting) and align
      joiners/leavers with the virtual time.
    - ``pop_admissible()``: the next request in priority-then-
      most-underserved order among tenants with slot budget left
      (``max_slots`` minus running minus this round's admissions);
      ``None`` when every backlogged tenant is over quota — the
      engine stops admitting rather than admitting unfairly.
    - ``plan_preemptions(running, free_slots)``: the slots to
      recompute-preempt so a blocked same-or-higher-priority waiter
      admits THIS round (over-quota slots first, then strictly
      lower classes).
    - ``shed_victim()``: under shed-oldest overflow, the victim is
      the lowest-priority, deepest-backlog tenant's oldest request —
      the flooder sheds itself before anyone else does.
    - ``tenant_retry_after_s``: the per-tenant 429 hint — the
      tenant's OWN queue depth over its own slot share (quota-capped
      weight share of the engine's slots), so a throttled flooder
      hears a long hint while an at-SLO victim hears the old
      one-wave hint."""

    def __init__(self, max_prompt_len: int,
                 tenants: Optional[TenantRegistry] = None,
                 **kwargs):
        super().__init__(max_prompt_len, **kwargs)
        self.tenants = tenants if tenants is not None \
            else TenantRegistry()
        self._tq: Dict[str, Deque[Request]] = {}
        #: per-tenant virtual pass: served tokens / weight. LOWER =
        #: more underserved = admits first among equal priorities.
        self._pass: Dict[str, float] = {}
        self._running: Dict[str, int] = {}
        self._round_admitted: Dict[str, int] = {}
        #: global arrival stamps (request id -> submit sequence): the
        #: FIFO tie-break when priority AND deficit tie — without it,
        #: two backlogged tenants whose deficits both saturate at the
        #: carry-over cap would tie-break on the tenant NAME forever,
        #: starving the lexically later one
        self._arrival: Dict[int, int] = {}
        self._arrival_seq = 0
        #: ids admitted out of fair order but not yet compacted out
        #: of the base arrival deque: admission takes from the
        #: MIDDLE of ``_queue`` (a victim tenant's head may sit
        #: behind a flooder's backlog), and ``deque.remove`` there is
        #: O(depth) PER ADMISSION — exactly pathological under the
        #: sustained overload tenancy targets. Tombstone instead and
        #: compact lazily from the front (amortized O(1)); the
        #: invariant is that every tombstoned id is still present in
        #: ``_queue``, so ``pending`` stays a subtraction.
        self._taken_ids: set = set()

    # -- queue maintenance (both indexes stay in sync) -----------------
    def _stamp(self, request: Request) -> None:
        self._arrival_seq += 1
        self._arrival[request.id] = self._arrival_seq

    def submit(self, request: Request) -> int:
        rid = super().submit(request)
        self._tq.setdefault(request.tenant,
                            deque()).append(request)
        self._stamp(request)
        return rid

    def requeue(self, request: Request) -> None:
        super().requeue(request)
        self._tq.setdefault(request.tenant,
                            deque()).append(request)
        if request.id not in self._arrival:
            # requeued (preempted/retried/restored) requests re-stamp
            # at the back of the FIFO tie-break; their SERVICE order
            # is still governed by priority and deficit first
            self._stamp(request)

    def _drop_from_tenant(self, request: Request) -> None:
        q = self._tq.get(request.tenant)
        if q is None:
            return
        try:
            q.remove(request)
        except ValueError:
            pass
        if not q:
            self._tq.pop(request.tenant, None)

    def remove(self, request_id: int) -> Optional[Request]:
        # the base scan would also find TOMBSTONED requests (taken by
        # admission, physically still in the deque) — cancelling one
        # of those would mint a second terminal for a request already
        # mid-admission
        for req in self._queue:
            if (req.id == request_id
                    and req.id not in self._taken_ids):
                self._queue.remove(req)
                self._drop_from_tenant(req)
                self._arrival.pop(req.id, None)
                return req
        return None

    # -- tombstone-aware views of the base queue -----------------------
    @property
    def pending(self) -> int:
        return len(self._queue) - len(self._taken_ids)

    @property
    def full(self) -> bool:
        return (self.max_queue is not None
                and self.pending >= self.max_queue)

    def queued_requests(self) -> List[Request]:
        return [r for r in self._queue
                if r.id not in self._taken_ids]

    def pressure(self) -> int:
        return sum(len(r.prompt) for r in self._queue
                   if r.id not in self._taken_ids)

    def retry_after_s(self, n_slots: int,
                      round_time_s: float) -> int:
        waves = math.ceil(max(self.pending, 1) / max(n_slots, 1))
        return max(1, math.ceil(waves * max(round_time_s, 0.0)))

    def _take(self, tenant: str, charge: bool = True) -> Request:
        req = self._tq[tenant].popleft()
        if not self._tq[tenant]:
            del self._tq[tenant]
        self._taken_ids.add(req.id)
        self._compact()
        self._arrival.pop(req.id, None)
        if charge:
            self._round_admitted[tenant] = (
                self._round_admitted.get(tenant, 0) + 1)
            self._charge(tenant, len(req.prompt))
        return req

    def _compact(self) -> None:
        """Pop tombstoned entries off the arrival deque's FRONT —
        each tombstone is popped exactly once, so the per-admission
        cost is amortized O(1) whatever the backlog depth."""
        queue = self._queue
        taken = self._taken_ids
        while queue and queue[0].id in taken:
            taken.discard(queue.popleft().id)

    def _charge(self, tenant: str, tokens: float) -> None:
        weight = max(self.tenants.spec_of(tenant).weight, 1e-9)
        self._pass[tenant] = (self._pass.get(tenant, 0.0)
                              + float(tokens) / weight)

    # -- selection -----------------------------------------------------
    def tenant_depth(self, tenant: str) -> int:
        return len(self._tq.get(tenant, ()))

    def tenant_full(self, tenant: str) -> bool:
        spec = self.tenants.spec_of(tenant)
        return (spec.max_queued is not None
                and self.tenant_depth(tenant) >= spec.max_queued)

    def _slot_budget(self, tenant: str) -> float:
        spec = self.tenants.spec_of(tenant)
        if spec.max_slots is None:
            return math.inf
        used = (self._running.get(tenant, 0)
                + self._round_admitted.get(tenant, 0))
        return spec.max_slots - used

    def _order_key(self, tenant: str):
        head = self._tq[tenant][0]
        prio = self.tenants.effective_priority(head)
        return (-prio, self._pass.get(tenant, 0.0),
                self._arrival.get(head.id, 0), tenant)

    def _pick_tenant(self, respect_quota: bool) -> Optional[str]:
        best, best_key = None, None
        for tenant, q in self._tq.items():
            if not q:
                continue
            if respect_quota and self._slot_budget(tenant) < 1:
                continue
            key = self._order_key(tenant)
            if best_key is None or key < best_key:
                best, best_key = tenant, key
        return best

    def pop(self) -> Request:
        tenant = self._pick_tenant(respect_quota=False)
        if tenant is None:
            raise IndexError("pop from an empty scheduler")
        return self._take(tenant)

    def pop_admissible(self) -> Optional[Request]:
        tenant = self._pick_tenant(respect_quota=True)
        return self._take(tenant) if tenant is not None else None

    def shed_victim(self) -> Request:
        """Overflow victim under shed-oldest: the lowest-priority,
        deepest-backlog tenant's OLDEST request — overflow lands on
        whoever caused it, not on arrival order."""
        worst, worst_key = None, None
        for tenant, q in self._tq.items():
            if not q:
                continue
            prio = self.tenants.effective_priority(q[0])
            key = (prio, -len(q), tenant)
            if worst_key is None or key < worst_key:
                worst, worst_key = tenant, key
        if worst is None:
            raise IndexError("shed from an empty scheduler")
        return self._take(worst, charge=False)

    # -- per-round accounting ------------------------------------------
    def begin_round(self, running: Dict[str, int]) -> None:
        """Engine hook, once per scheduling round: ``running`` is the
        per-tenant slot occupancy (decoding slots + in-flight
        admissions). Aligns the virtual-time bookkeeping with the
        backlog: a tenant whose backlog emptied drops its pass (no
        hoarding), a (re)joining tenant starts at the CURRENT
        virtual time — the minimum pass among backlogged tenants —
        so it competes fairly from now, neither penalized for its
        absence nor armed with banked idle time."""
        self._running = {t: int(n) for t, n in running.items() if n}
        self._round_admitted = {}
        backlogged = ({t for t, q in self._tq.items() if q}
                      | set(self._running))
        for tenant in list(self._pass):
            if tenant not in backlogged:
                del self._pass[tenant]
        if not backlogged:
            return
        vtime = min((p for t, p in self._pass.items()
                     if t in backlogged), default=0.0)
        for tenant in backlogged:
            if tenant not in self._pass:
                self._pass[tenant] = vtime

    def note_usage(self, used: Dict[str, int]) -> None:
        """Engine hook, after a decode round: committed tokens per
        tenant charge the pass, so the fair share tracks decode
        work, not just admissions."""
        for tenant, tokens in used.items():
            if tokens:
                self._charge(tenant, tokens)

    def _admissible_waiters(self, counts: Dict[str, int],
                            cap: int) -> List[int]:
        """Effective priorities of the first ``cap`` queued requests
        that could admit given ``counts`` running slots per tenant —
        a dry run of the fair selection, nothing mutated."""
        budget = {}
        for tenant in self._tq:
            spec = self.tenants.spec_of(tenant)
            budget[tenant] = (math.inf if spec.max_slots is None
                              else spec.max_slots
                              - counts.get(tenant, 0))
        taken: Dict[str, int] = {}
        out: List[int] = []
        while len(out) < cap:
            best, best_key = None, None
            for tenant, q in self._tq.items():
                idx = taken.get(tenant, 0)
                if idx >= len(q):
                    continue
                if budget[tenant] - idx < 1:
                    continue
                prio = self.tenants.effective_priority(q[idx])
                key = (-prio, self._pass.get(tenant, 0.0),
                       self._arrival.get(q[idx].id, 0), tenant)
                if best_key is None or key < best_key:
                    best, best_key = tenant, key
            if best is None:
                break
            out.append(-best_key[0])
            taken[best] = taken.get(best, 0) + 1
        return out

    def plan_preemptions(self,
                         running: List[Tuple[int, str, int]],
                         free_slots: int) -> List[int]:
        """Which running slots to recompute-preempt THIS round so a
        blocked admissible waiter gets a slot NOW instead of waiting
        out a lower class's decode rounds.

        ``running`` is ``[(slot, tenant, effective_priority)]`` for
        every decoding slot; ``free_slots`` the slots already
        available for admission. Two victim tiers, in order:

        1. **over-quota slots** — a tenant's youngest slots beyond
           its ``max_slots`` (possible after a restore under a
           tightened registry, or a live re-registration):
           preemptible by any blocked waiter of EQUAL-or-higher
           priority — reclaiming an entitlement, not jumping a
           class;
        2. **lower-class slots** — any slot whose effective priority
           is STRICTLY below the waiter's: the priority contract
           itself. The lowest-priority tenant's youngest slot goes
           first (highest slot index = youngest, the engine's
           preemption convention — least sunk prefill lost to the recompute).

        One victim per blocked waiter, never more: preemption makes
        room for what is actually waiting, it does not clear-cut the
        batch. Greedy victims requeue and regenerate bit-identical
        ids; tenancy without configured priorities/quotas plans
        nothing."""
        counts: Dict[str, int] = {}
        for _, tenant, _ in running:
            counts[tenant] = counts.get(tenant, 0) + 1
        over_quota: set = set()
        for tenant, count in counts.items():
            max_slots = self.tenants.spec_of(tenant).max_slots
            if max_slots is not None and count > max_slots:
                mine = sorted(slot for slot, t, _ in running
                              if t == tenant)
                over_quota.update(mine[-(count - max_slots):])
        # candidates: lowest-priority first; over-quota slots ahead
        # of in-quota peers at the same priority; youngest first
        cands = sorted(
            ((prio, 0 if slot in over_quota else 1, -slot, slot)
             for slot, _, prio in running))
        # quota budgets judge against the FULL occupancy picture —
        # ``begin_round``'s snapshot includes in-flight admissions,
        # which hold reserved slots but are not preemptible
        budget_counts = dict(self._running)
        for tenant, count in counts.items():
            budget_counts[tenant] = max(
                budget_counts.get(tenant, 0), count)
        waiters = self._admissible_waiters(
            budget_counts, cap=len(cands) + max(free_slots, 0))
        blocked = waiters[max(free_slots, 0):]
        if not blocked:
            return []
        victims: List[int] = []
        taken = [False] * len(cands)
        for wprio in blocked:
            for i, (vprio, in_quota, _, slot) in enumerate(cands):
                if taken[i]:
                    continue
                if (vprio < wprio
                        or (not in_quota and vprio <= wprio)):
                    taken[i] = True
                    victims.append(slot)
                    break
        return victims

    # -- backpressure hints --------------------------------------------
    def tenant_retry_after_s(self, tenant: str, n_slots: int,
                             round_time_s: float) -> int:
        """Per-tenant ``Retry-After``: the tenant's own queue depth
        over its own slot share — quota-capped, weight-proportional
        among backlogged tenants — instead of the global queue over
        all slots. A flooder with 50 queued and a 2-slot quota hears
        a 25-wave hint; a victim with 1 queued hears one wave."""
        depth = self.tenant_depth(tenant)
        spec = self.tenants.spec_of(tenant)
        backlogged = ({t for t, q in self._tq.items() if q}
                      | set(self._running) | {tenant})
        wsum = sum(self.tenants.spec_of(t).weight
                   for t in backlogged)
        share = spec.weight / max(wsum, 1e-9)
        slots = max(1, int(n_slots * share))
        if spec.max_slots is not None:
            slots = min(slots, spec.max_slots)
        waves = math.ceil(max(depth, 1) / max(slots, 1))
        return max(1, math.ceil(waves * max(round_time_s, 0.0)))
