"""Request queue + admission policy for the continuous-batching engine
(a copy of ``deeplearning4j_tpu/serving/scheduler.py``).

The scheduler owns everything host-side about a request's lifecycle
BEFORE it holds a slot: validation against the cache window, FIFO
ordering, the pow2 prompt-length bucketing that bounds prefill
compilations (one XLA executable per bucket, O(log window) buckets
total, instead of one per distinct prompt length), and — with chunked
prefill enabled — the per-round token budget that decides how much
prefill work may run between two decode rounds (the Sarathi-Serve
stall-vs-TTFT tradeoff, Agrawal et al. 2024)."""

from __future__ import annotations

import dataclasses
import itertools
import math
import re
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.nn.streaming import scan_length_bucket

_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


def validate_tenant(name: str) -> str:
    """A tenant name usable as a metrics label value and a stable
    accounting key — raises ``ValueError`` otherwise."""
    name = str(name)
    if not _TENANT_RE.match(name):
        raise ValueError(
            f"tenant {name!r}: expected 1-64 chars of "
            "[A-Za-z0-9._-] starting alphanumeric")
    return name


@dataclasses.dataclass
class Request:
    """One decode request. ``temperature == 0`` means greedy (the
    default — bit-identical to ``MultiLayerNetwork.generate``);
    ``top_k=None`` means unfiltered. ``eos_id`` optionally ends the
    request early (the eos token is included in the output).

    ``deadline_s`` is an END-TO-END budget: measured from submit, a
    request past it is terminated wherever it is (queued, mid-
    admission, or mid-decode) with ``finish_reason="deadline"`` and
    whatever tokens it produced. ``queue_timeout_s`` bounds QUEUE WAIT
    only: a request that has not started admission within it is shed
    (``finish_reason="shed"``) — the backpressure contract that a
    request which waited too long is cheaper to drop than to start."""

    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    eos_id: Optional[int] = None
    id: Optional[int] = None
    deadline_s: Optional[float] = None
    queue_timeout_s: Optional[float] = None
    #: fleet-level trace context: an opaque
    #: ``<trace_id>/<span_id>`` string minted by an upstream tier
    #: (the router's journaled request id + per-attempt span id) and
    #: carried through the engine so every span, flight-recorder
    #: record, and ``serving.request_done`` instant this request
    #: produces is stitchable into one cross-process trace. Pure
    #: host metadata — never touches device work, RNG, or ids.
    trace: Optional[str] = None
    #: multi-tenant QoS identity: which tenant's quotas,
    #: priority class, and fair share this request bills against.
    #: ``"default"`` = the unlabeled-caller class — engines without a
    #: TenantRegistry ignore the field entirely, so existing callers
    #: are unchanged. Rides the snapshot wire format and the router
    #: journal, so failover replay and drain/restore preserve it.
    tenant: str = "default"
    #: optional per-request priority override: CLAMPED to
    #: the tenant's class — a request can de-prioritize itself (batch
    #: traffic under an interactive tenant) but never self-boost.
    #: None = the tenant spec's priority.
    priority: Optional[int] = None

    def __post_init__(self):
        if len(self.prompt) == 0:
            raise ValueError("empty prompt")
        # tenant names ride Prometheus labels and accounting keys
        # verbatim — validate here so EVERY submit surface (engine,
        # gateway, router) rejects a malformed one identically
        self.tenant = validate_tenant(self.tenant)
        if self.priority is not None:
            self.priority = int(self.priority)
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens {self.max_new_tokens} < 1")
        if self.temperature < 0:
            raise ValueError(f"temperature {self.temperature} < 0")
        if self.top_k is not None and self.top_k < 1:
            # top_k=0 would otherwise fall through `top_k or vocab`
            # as unfiltered sampling — the opposite of the caller's
            # plausible intent
            raise ValueError(
                f"top_k {self.top_k} < 1 (use None for unfiltered)")
        for name in ("deadline_s", "queue_timeout_s"):
            val = getattr(self, name)
            if val is not None and val <= 0:
                raise ValueError(
                    f"{name} {val} <= 0 (use None for no limit)")


#: every terminal state a request can reach. 'length'/'eos' are the
#: healthy outcomes; the rest are the failure-handling layer's:
#: 'deadline' (end-to-end budget blown, partial tokens returned),
#: 'cancelled' (engine.cancel, partial tokens returned), 'shed'
#: (admission-queue backpressure or queue timeout, no tokens), 'fault'
#: (an injected/detected fault exhausted the retry cap).
FINISH_REASONS = ("length", "eos", "deadline", "cancelled", "shed",
                  "fault")


@dataclasses.dataclass
class GenerationResult:
    """A finished request: generated ids (prompt excluded) and why it
    stopped (one of :data:`FINISH_REASONS`). ``prefix_tokens_reused``
    counts prompt tokens served from the radix prefix cache instead of
    prefilled; ``ttft_s`` is submit-to-first-token wall time (None when
    the engine predates the request's submit, e.g. hand-built results,
    or the request never produced a token); ``retries`` counts fault
    re-admissions the request survived before this terminal state."""

    id: int
    tokens: List[int]
    finish_reason: str
    prompt_len: int
    prefix_tokens_reused: int = 0
    ttft_s: Optional[float] = None
    retries: int = 0
    #: speculative-decoding counters (``spec_draft_len > 0`` engines):
    #: tokens the n-gram table proposed for this request, and how many
    #: of them verification accepted — acceptance rate per request is
    #: ``spec_accepted / spec_drafted`` (0/0 when the request never
    #: drafted, e.g. spec-off engines; sampling requests draft too —
    #: stochastic acceptance)
    spec_drafted: int = 0
    spec_accepted: int = 0
    #: per-request phase breakdown from the engine's phase clock
    #: (``record_timing=True`` engines): a plain JSON-able
    #: dict — ``queue_wait_s``, ``admission_s`` (+ its cold / chunked /
    #: splice split), ``decode_s``, ``verify_s``, ``stall_s``,
    #: ``ttft_s`` (identical to the top-level field), ``e2e_s``,
    #: ``attempts``, ``rounds``, ``tokens``. The disjoint-interval
    #: attribution guarantees the phase sums never exceed ``e2e_s``.
    #: None when timing was off or the engine predates the request.
    timing: Optional[Dict[str, Any]] = None
    #: the fleet trace context the request carried in —
    #: echoed on the terminal so an upstream tier can correlate the
    #: result with the stitched cross-process trace. None for
    #: requests submitted without one.
    trace: Optional[str] = None
    #: the tenant the request billed against — echoed on
    #: the terminal ONLY by tenancy-enabled engines (None otherwise,
    #: so non-tenant deployments' wire format is unchanged); the
    #: gateway's per-tenant Retry-After and the router's per-tenant
    #: parking read it back.
    tenant: Optional[str] = None


class Scheduler:
    """FIFO admission queue with pow2 prompt-length bucketing.

    ``max_prompt_len`` is the engine's cache window: a prompt longer
    than the window cannot prefill losslessly (its oldest tokens would
    slide out before decoding starts), so it is rejected at submit
    time rather than silently truncated."""

    #: valid chunked-prefill scheduling policies (see ``plan_chunks``)
    POLICIES = ("ttft", "decode")

    #: speculative K-adaptation policy (see ``record_acceptance``):
    #: acceptance is averaged over this many verify rounds before K
    #: moves, so one unlucky round cannot whipsaw the draft length
    SPEC_ADAPT_ROUNDS = 8
    #: mean acceptance below this halves K (floor 1 — at K=1 a round
    #: with no n-gram match at all already IS plain decode)
    SPEC_ACCEPT_LOW = 0.4
    #: mean acceptance above this doubles K back toward the ceiling
    SPEC_ACCEPT_HIGH = 0.8

    def __init__(self, max_prompt_len: int, min_bucket: int = 8,
                 prefill_chunk: int = 0,
                 prefill_budget: Optional[int] = None,
                 policy: str = "ttft",
                 max_queue: Optional[int] = None,
                 pressure_high: Optional[int] = None,
                 pressure_low: Optional[int] = None,
                 spec_draft_len: int = 0):
        self.max_prompt_len = int(max_prompt_len)
        self.min_bucket = int(min_bucket)
        if policy not in self.POLICIES:
            raise ValueError(
                f"admission policy {policy!r}: expected one of "
                f"{self.POLICIES}")
        if prefill_chunk < 0:
            raise ValueError(f"prefill_chunk {prefill_chunk} < 0")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue {max_queue} < 1")
        self.policy = policy
        self.prefill_chunk = int(prefill_chunk)
        if prefill_budget is None:
            # decode-priority: ONE chunk between decode rounds — the
            # minimum that still makes admission progress, so a running
            # slot never stalls longer than one chunk. ttft-priority:
            # 4 chunks' worth, front-loaded on the oldest admission.
            prefill_budget = (self.prefill_chunk if policy == "decode"
                              else 4 * self.prefill_chunk)
        self.prefill_budget = int(prefill_budget)
        # adaptive-degradation bounds (see adapt_budget): the budget
        # never adapts above its configured value or below one chunk
        self._budget_ceiling = self.prefill_budget
        self.pressure_high = (int(pressure_high)
                              if pressure_high is not None
                              else 4 * max(self._budget_ceiling, 1))
        self.pressure_low = (int(pressure_low)
                             if pressure_low is not None
                             else max(self._budget_ceiling, 1))
        self.max_queue = None if max_queue is None else int(max_queue)
        if spec_draft_len < 0:
            raise ValueError(f"spec_draft_len {spec_draft_len} < 0")
        #: speculative drafting: ``spec_ceiling`` is the configured K;
        #: ``draft_len`` is the CURRENT K the engine drafts with, which
        #: ``record_acceptance`` adapts inside [1, spec_ceiling]
        self.spec_ceiling = int(spec_draft_len)
        self.draft_len = self.spec_ceiling
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_rounds = 0
        self._queue: Deque[Request] = deque()
        self._ids = itertools.count()
        self._issued = set()

    def bucket_of(self, prompt_len: int) -> int:
        """Compiled-prefill bucket for a prompt length: next pow2,
        clamped to the window (the pad past the prompt is masked, so a
        clamped bucket still fits any admissible prompt)."""
        return min(scan_length_bucket(prompt_len, self.min_bucket),
                   self.max_prompt_len)

    def validate(self, request: Request) -> None:
        """Reject prompts the engine could never serve losslessly."""
        if len(request.prompt) > self.max_prompt_len:
            raise ValueError(
                f"prompt of {len(request.prompt)} tokens exceeds the "
                f"cache window ({self.max_prompt_len}): raise "
                "stream_max_t or shorten the prompt")

    def assign_id(self, request: Request) -> int:
        """Issue (or verify) the request's id WITHOUT enqueueing — the
        engine uses this for requests it must answer at submit time
        (e.g. shed under the reject-new policy), so even a rejected
        request has a stable id its result can be keyed by."""
        if request.id is None:
            request.id = next(self._ids)
        elif request.id in self._issued:
            # results are keyed by id: a duplicate (e.g. the same
            # Request object submitted twice) would silently overwrite
            # the earlier request's output
            raise ValueError(
                f"request id {request.id} already submitted; construct "
                "a new Request (or leave id=None)")
        self._issued.add(request.id)
        return request.id

    def submit(self, request: Request) -> int:
        self.validate(request)
        rid = self.assign_id(request)
        self._queue.append(request)
        return rid

    def requeue(self, request: Request) -> None:
        """Put an already-issued request back in line (fault retry,
        snapshot restore): no re-validation, no duplicate check — the
        id stays issued across its whole retry lifetime."""
        self._issued.add(request.id)
        self._queue.append(request)

    def pop(self) -> Request:
        return self._queue.popleft()

    # -- tenancy hooks: the base scheduler is tenant-blind;
    # -- these defaults keep the engine/gateway call sites unconditional
    # -- while WeightedFairScheduler (serving/tenancy.py) overrides them
    def pop_admissible(self) -> Optional[Request]:
        """Next request the admission loop may start, or None when
        every queued request is quota-blocked. FIFO base: the front
        of the queue, always (no quotas exist to block it)."""
        return self.pop() if self._queue else None

    def shed_victim(self) -> Request:
        """Overflow victim under the shed-oldest policy. FIFO base:
        the oldest queued request (the pre-tenancy behavior);
        weighted-fair picks the flooder's oldest instead."""
        return self.pop()

    def tenant_full(self, tenant: str) -> bool:
        """Per-tenant queue-bound check — never full without tenancy
        (only the global ``max_queue`` sheds)."""
        return False

    def tenant_retry_after_s(self, tenant: str, n_slots: int,
                             round_time_s: float) -> int:
        """Per-tenant Retry-After hint — the global hint without
        tenancy, so the gateway's 429 path is tenancy-agnostic."""
        return self.retry_after_s(n_slots, round_time_s)

    def remove(self, request_id: int) -> Optional[Request]:
        """Pull a specific queued request out of line (cancellation,
        deadline expiry). Returns it, or None if not queued."""
        for req in self._queue:
            if req.id == request_id:
                self._queue.remove(req)
                return req
        return None

    def queued_requests(self) -> List[Request]:
        """Snapshot of the queue, oldest first (deadline sweeps and
        engine snapshots; mutating the list does not touch the
        queue)."""
        return list(self._queue)

    def reserve_ids_through(self, max_id: int) -> None:
        """Advance the id counter past ``max_id`` (snapshot restore:
        replayed requests keep their original ids, and future submits
        must not collide with them)."""
        self._ids = itertools.count(int(max_id) + 1)

    def release(self, request_id: int) -> None:
        """Forget a finished request's id: ``_issued`` then tracks only
        queued/in-flight requests (bounded memory over a long-lived
        engine) while still rejecting concurrent duplicate ids."""
        self._issued.discard(request_id)

    def plan_chunks(self, remaining: Sequence[int],
                    verify_tokens: int = 0) -> List[int]:
        """Grant prefill chunks for one scheduling round.

        ``remaining`` is the suffix-tokens-left count per in-flight
        admission, oldest first. Returns indices into ``remaining``,
        one entry per granted chunk, in execution order. Grants go to
        the oldest admission until its suffix is done, then the next
        (finishing one TTFT beats starting many), each grant costing a
        full ``prefill_chunk`` of budget (a padded partial chunk costs
        chunk-shaped compute — budget tracks the stall, not the
        tokens). The budget floors at one chunk so a round always makes
        admission progress:

        - ``decode`` priority: budget == one chunk — between two decode
          rounds at most ONE prefill chunk runs, so the decode stall of
          any admission is bounded by one chunk (the engine's
          non-blocking-admission guarantee).
        - ``ttft`` priority: budget defaults to 4 chunks — admissions
          reach their first token up to 4x sooner per round at the cost
          of a longer decode gap.

        ``verify_tokens`` is the round's speculative-verify width (the
        draft length + the current token, when the engine will run a
        verify pass this round): the verify pass grows the round's
        device work just like an extra prefill chunk would, so it
        bills against the SAME budget — a speculative engine under
        ttft priority grants fewer chunks per round rather than
        silently stretching the round past what the policy promised.
        The one-chunk floor survives the charge, so admissions always
        progress and the decode-priority stall bound (<= 1 chunk/round)
        is unchanged."""
        if not remaining or self.prefill_chunk < 1:
            return []
        budget = max(self.prefill_budget - max(int(verify_tokens), 0),
                     self.prefill_chunk)
        grants: List[int] = []
        for i, left in enumerate(remaining):
            while left > 0 and budget >= self.prefill_chunk:
                grants.append(i)
                left -= min(self.prefill_chunk, left)
                budget -= self.prefill_chunk
            if budget < self.prefill_chunk:
                break
        return grants

    @property
    def pending(self) -> int:
        return len(self._queue)

    def decision_pending(self) -> bool:
        """True when the NEXT scheduling round needs a per-round
        decision from this scheduler — queued arrivals to admit (and,
        in the weighted-fair subclass, the preemption planning that
        only ever fires for queued arrivals). The fused multi-round
        decode path asks this before dispatching a K-round
        scan: while it is False, K rounds of pure decode can run as
        one device program without the scheduler's input; the moment
        it turns True the engine falls back to per-round stepping so
        admission/QoS keep their per-round cadence. Tombstone-aware
        in the subclass via the ``pending`` property."""
        return bool(self.pending)

    @property
    def full(self) -> bool:
        """Bounded-admission check: True when the queue has reached
        ``max_queue`` and the next submit must shed (engine policy
        decides whom). ``max_queue=None`` never sheds."""
        return (self.max_queue is not None
                and len(self._queue) >= self.max_queue)

    def pressure(self) -> int:
        """Backpressure signal: total estimated suffix-prefill tokens
        queued (= queue depth x mean prompt tokens; the prompt length
        is an upper bound per request — prefix-cache hits only lower
        it). This is the prefill work the engine owes before the queue
        drains."""
        return sum(len(r.prompt) for r in self._queue)

    def retry_after_s(self, n_slots: int, round_time_s: float) -> int:
        """Whole-seconds backpressure hint for a shedding front door's
        ``Retry-After`` header: with ``depth`` requests
        queued ahead of a would-be arrival and ``n_slots`` of them
        admitted per drain wave, capacity is roughly
        ``ceil(depth / n_slots)`` scheduling rounds away; scaled by the
        measured per-round wall time and floored at 1 s (the header's
        useful minimum — a sub-second hint just invites an immediate
        re-shed). The estimate is deliberately coarse: its job is to
        spread retries out, not to promise a slot."""
        waves = math.ceil(max(len(self._queue), 1) / max(n_slots, 1))
        return max(1, math.ceil(waves * max(round_time_s, 0.0)))

    def record_acceptance(self, drafted: int, accepted: int) -> int:
        """Feed one speculative verify round's outcome into the
        K-adaptation policy and return the draft length the engine
        should use next (the adaptive scheduler: K steps
        DOWN when acceptance is poor — wasted verify lanes are wasted
        decode-gap budget — and recovers when acceptance improves).

        Acceptance is averaged over ``SPEC_ADAPT_ROUNDS`` verify rounds
        (rounds that drafted nothing don't count — they already ran as
        plain decode); mean rate below ``SPEC_ACCEPT_LOW`` halves
        ``draft_len`` (floor 1 = one drafted token, the minimum that is
        still speculative; no-match rounds below that are plain
        decode), above ``SPEC_ACCEPT_HIGH`` doubles it back toward the
        configured ``spec_ceiling``."""
        if self.spec_ceiling < 1 or drafted < 1:
            return self.draft_len
        self._spec_drafted += int(drafted)
        self._spec_accepted += int(accepted)
        self._spec_rounds += 1
        if self._spec_rounds >= self.SPEC_ADAPT_ROUNDS:
            rate = self._spec_accepted / self._spec_drafted
            if rate < self.SPEC_ACCEPT_LOW:
                self.draft_len = max(1, self.draft_len // 2)
            elif rate > self.SPEC_ACCEPT_HIGH:
                self.draft_len = min(self.spec_ceiling,
                                     2 * self.draft_len)
            self._spec_drafted = 0
            self._spec_accepted = 0
            self._spec_rounds = 0
        return self.draft_len

    def adapt_budget(self) -> int:
        """Graceful-degradation step (engine calls once per round when
        ``adaptive_prefill`` is on): pressure above ``pressure_high``
        steps the per-round prefill budget DOWN one chunk (decode
        latency stays smooth while admissions slow), pressure below
        ``pressure_low`` steps it back UP toward the configured
        ceiling. The budget never leaves [one chunk, ceiling], so
        admission always progresses and recovery is automatic."""
        if self.prefill_chunk < 1:
            return self.prefill_budget
        p = self.pressure()
        if p > self.pressure_high:
            self.prefill_budget = max(
                self.prefill_chunk,
                self.prefill_budget - self.prefill_chunk)
        elif p < self.pressure_low:
            self.prefill_budget = min(
                self._budget_ceiling,
                self.prefill_budget + self.prefill_chunk)
        return self.prefill_budget
