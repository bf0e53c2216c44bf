"""Continuous-batching decode engine over a dense slot pool or the paged
KV block pool.

Port of the core of ``deeplearning4j_tpu/serving/engine.py:
DecodeEngine``, in both of its KV layouts. A fixed set of ``n_slots``
decode slots is multiplexed across many requests:

- ``paged_kv=False`` (the default, as in JAX): the dense slot pool, per
  attention layer ``{k, v: [n_slots, H, window, dh], filled:
  [n_slots]}`` at the master dtype, one row per slot, attended by
  ``AttentionImpl._stream_attend``. Eviction zeroes the slot's rows
  (``nn.streaming.clear_state_rows``: a zeroed row is the empty cache).
- ``paged_kv=True``: one block pool per attention layer
  (``[kv_blocks + 1, block_tokens, H, dh]``, the master dtype; the last
  block, named ``scratch`` in each layer's pool dict, is the scratch
  block of the fixed-shape K/V scatter, which no table maps), addressed
  through per-slot host block tables (serving/block_pool.py) and
  attended by ``AttentionImpl._paged_attend`` (K2 on the card).

One scheduling round (``step()``):

1. **Admit** — while a slot is free and requests are queued, start the
   next request's admission. With a prefix cache
   (``prefix_cache_rows``, serving/prefix_cache.py) the longest cached
   prefix of the prompt is reused and only the suffix prefills: dense,
   the matched state is fetched (a copy) from a second pool of rows;
   paged, the trie entry's blocks are SPLICED into the slot's new
   block table (zero-copy, refcounts only) and the suffix streams
   through that table (``AttentionImpl._paged_attend``, K2 on the
   card). A cold prompt prefills at batch 1, right-padded to its pow2
   length bucket and masked (``AttentionImpl._prefill_cache``: a padded
   prefill streams exactly like an unpadded one); later cold segments
   continue on the carried dense state (``_stream_attend`` with a chunk
   mask). Blocking mode (``prefill_chunk=0``) prefills the whole suffix
   at once; with ``prefill_chunk > 0`` the suffix splits into fixed
   chunks scheduled BETWEEN decode rounds under the scheduler's
   per-round budget (``Scheduler.plan_chunks``; ``admission_policy``
   "ttft" or "decode", ``prefill_budget``; with ``adaptive_prefill`` the
   budget follows queue pressure, ``Scheduler.adapt_budget`` between
   ``pressure_low`` and ``pressure_high``), the slot reserved meanwhile.
   A completed admission writes its window of K/V into the slot's pool
   rows (dense) or, cold, into freshly allocated blocks at their
   absolute positions (paged, ``_scatter_row``), stores the prompt in
   the prefix cache (dense: a copy into a row; paged: references to
   the slot's blocks) and takes the first token.
2. **Reserve** (paged) — make every running slot's table writable for
   the round's ``decode_chunk`` appends, allocating blocks as ``filled``
   crosses block boundaries; under pool pressure the youngest slot is
   preempted and its request requeued (greedy ids regenerate
   identically), after LRU trie entries have been dropped. A block
   shared with the trie or another slot (refcount > 1) is copied before
   anything writes into it (``BlockPool.copy_block_device``): the pool
   is one tensor that the trie, every slot and the decode graph read.
3. **Decode** — ``decode_chunk`` batched steps over all slots (one-hot,
   forward, ``sample_tokens``), JAX's ``decode`` scan. On the card the
   round is ONE captured CUDA graph per engine (``nn/cuda_graphs.py``):
   the pool and the token vector are its static buffers, and what moves
   from round to round (the paged tables, base, floor and filled; the
   temperatures and top-k) is copied into its static buffers without a
   host sync before each replay. Temperatures and top-k ride as device
   tensors, so the graph always carries the sampled branch; greedy rows
   stay ``argmax``. On the CPU the same round body runs eagerly. The
   round's tokens are fetched once, the round's one host sync.
   **Fused rounds** (``fused_rounds=K``, JAX's ``fused_decode``): when
   no host decision is pending (nothing queued, requeued or part-way
   through a chunked admission), up to K
   rounds (the pow2 bucket covering the widest live request's remaining
   rounds) run as ONE captured graph per bucket, with each slot's
   committed prefix ``n_valid`` (eos and ``max_new_tokens``) found on
   the device; slots that finish inside the window ride it as dead rows
   and their overshoot is dropped at landing. Ids are bit-identical to
   K stepped rounds, greedy and sampled: the window's sampler calls
   advance the generator exactly as K round replays do.
   **Speculative decoding** (``spec_draft_len=K``, JAX's verify pass):
   each slot's host-side n-gram table (serving/spec.py) proposes up to
   K next tokens; a round where any slot drafted puts ONE batched
   verify pass in front of the decode round. The pass feeds every row
   ``[current token | draft]``, right-padded to the round's pow2 width
   and masked, through one forward (dense: ``_stream_attend``'s masked
   chunk continuation; paged: ``_paged_attend``, K2 at t = width + 1 on
   the card), accepts each row's draft prefix on the device
   (``stochastic_acceptance``: the equality rule on greedy rows, the
   Leviathan rejection rule on sampled ones), draws the token after it
   (``residual_sample``), rewinds each row's rejected tail
   (``drop_newest_tokens``: dense, the rows rolled and copied back into
   the pool; paged, the round's ``filled`` buffer moved back in place)
   and writes the new current token; the decode round then chains onto
   that state. On the card the pass is one captured graph per pow2
   width (``compile_counts()["verify"]``) in the decode graphs' runner
   and memory pool; both outputs are copied to the host behind one
   event, so a speculative round still has one host sync and commits
   ``accepted + 1 + decode_chunk`` tokens a slot. Greedy ids are
   exactly the spec-off engine's; rounds with no draft run the plain
   decode graph (``spec_fallback_rounds``); acceptance feeds
   ``Scheduler.record_acceptance``, which steps the live K.
4. **Land** — advance the host tables and free blocks that slid out of
   every window (paged), append tokens, and finish requests that reached
   ``max_new_tokens`` or their ``eos_id``. With ``async_rounds=True``
   the dispatched round's tokens are copied into pinned host memory
   behind an event, and the round lands at the START of the next
   ``step()``, before any scheduling decision (so ids stay identical to
   the synchronous engine's), letting the host's time between steps
   overlap the device's round.

The pools are updated in place (the JAX engine threads a new pool
through each executable). ``compile_counts()`` has the JAX engine's keys
for the layout, each the number of graphs captured for that path: the
decode round's is 1 once a round has run on the card, and the eager
paths read 0; with ``fused_rounds`` it adds ``fused_decode``, the
number of fused graphs (one per pow2 K dispatched, all of one engine's
graphs in one memory pool); with ``spec_draft_len`` it adds
``verify``, the verify graphs (one per pow2 width dispatched); a dense
prefix cache adds its
``prefix_fetch`` and ``prefix_store`` (0: eager), a paged one nothing.
Admission (prefill, chunk continuations, the prefix movers, CoW
copies) always runs eagerly. ``histograms`` holds, with
``record_timing``, JAX's engine histograms (``ENGINE_HISTOGRAMS``),
among them ``serving_fused_rounds`` (K at each fused dispatch) and
``serving_host_step_s`` (from the last round's token sync to the next
dispatch).

**Failure handling** (JAX's "Failure-handling knobs"; every knob
defaults off, and the engine is then the one described above, its ids,
graphs and host syncs unchanged): ``Request.deadline_s`` and
``queue_timeout_s`` end a request wherever it is (``_sweep_deadlines``,
once a round after the requeue drain and the fault injection);
``cancel(rid)`` ends a queued, requeued, admitting or running request;
``max_queue`` with ``shed_policy`` bounds the queue; ``fault_plan``
(serving/faults.py) injects NaN'd slots, failed admissions, stalls and
corrupted prefix entries at chosen rounds, writing NaN into the pools
IN PLACE (they are the graphs' static inputs); ``paranoid`` runs ONE
health check per landed round over the pool and the current tokens
(paged: a finiteness verdict per block of the first ``kv_blocks``, the
scratch block never judged; dense: one per slot; both: the token range),
on the card one captured graph (``compile_counts()["health_check"]``)
whose verdict comes back through one pinned host copy, and quarantines
each slot it condemns before any of the round's tokens is appended
(its blocks released, a poisoned block scrubbed with its last
reference, its prefix entries invalidated, its draft table dropped),
requeueing the victim with exponential backoff up to ``max_retries``
(then ``finish_reason="fault"``); ``stall_threshold_s`` counts slow
rounds; ``clock`` is the time source. While a fault plan is set or a
live request carries a deadline, no round is fused (a plan is indexed
by round, and a deadline must be able to expire between rounds). An
async round's landing commits only the rows whose slot still holds the
request it was dispatched for. ``snapshot()`` returns the JAX engine's
version-1 plain-JSON dict and ``DecodeEngine.restore`` rebuilds an
engine from it (either package's) by re-prefilling recorded tokens; see
their docstrings for the RNG.

**Incremental delivery** (``on_delta=callback``, or ``emit_deltas=True``
with ``drain_deltas()``; JAX's): every COMMITTED token surfaces in the
step that commits it, through a per-request high-water mark
(``_delta_sent``, snapshotted as ``delta_sent``): a decode chunk, a
fused window (up to K * ``decode_chunk`` tokens), a verify pass's
accepted draft and new token (never a rejected tail: deltas are taken
after the landing and after the paranoid sweep), the admission's first
token (with its first round) and a restore's resumed stream. A greedy
retry reproduces its streamed prefix, so nothing is sent twice; a
SAMPLED request that already streamed ends ``"fault"`` when quarantine
or preemption would retry it (a redraw could not be spliced onto what
was sent). This is what the gateway (serving/gateway.py) fans out.

**Request-scoped observability** (JAX's; pure host bookkeeping: ids,
the generator's draws and the captured graphs are the same with it on
or off, and no stamp adds a host sync): ``record_timing`` (default on)
stamps a :class:`_PhaseClock` on every request, read where the round
already syncs (the token fetch, an async round's landing) and, for a
fused window or a verify pass, from the host's view of the dispatch;
its breakdown fills ``GenerationResult.timing`` and the histograms of
``ENGINE_HISTOGRAMS``. ``flight_recorder`` keeps the last N terminal
requests' timelines (``request_trace``). A ``tracer``
(``profiler.tracer.Tracer``) gets JAX's spans (``serving.admit``,
``prefill``, ``prefill_chunk``, ``decode_chunk``, ``spec_verify``,
``prefix_fetch``, ``prefix_splice``, ``cow_copy``, each with its
request ids), the per-round counters, the failure events as cumulative
``serving_<key>`` tracks and the histograms (``describe_metrics``).

Knobs of the JAX engine that this port does not carry yet (tenancy, KV
tiers, tensor parallelism) raise ``NotImplementedError`` when set to
anything but their default.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.layers import BaseRecurrentLayer
from deeplearning4j_tpu_torch.nn.cuda_graphs import GraphRunner
from deeplearning4j_tpu_torch.nn.layers.attention import ATTENTION_BEANS
from deeplearning4j_tpu_torch.nn.streaming import (
    clear_state_rows,
    drop_newest_tokens,
    scan_length_bucket,
    tree_leaves,
    tree_map,
)
from deeplearning4j_tpu_torch.profiler.tracer import Histogram
from deeplearning4j_tpu_torch.serving.block_pool import BlockPool, BlockTable
from deeplearning4j_tpu_torch.serving.faults import (
    FaultEvent,
    FaultPlan,
    poison_rows,
)
from deeplearning4j_tpu_torch.serving.prefix_cache import (
    PagedPrefixCache,
    PrefixHit,
    RadixPrefixCache,
)
from deeplearning4j_tpu_torch.serving.sampler import (
    residual_sample,
    sample_tokens,
    stochastic_acceptance,
)
from deeplearning4j_tpu_torch.serving.scheduler import (
    GenerationResult,
    Request,
    Scheduler,
)
from deeplearning4j_tpu_torch.serving.spec import NgramDraftTable

#: knobs of the JAX engine this port does not carry yet, with the only
#: value it accepts for each (the JAX engine's default)
_UNPORTED = {
    "tp": 1, "tenants": None, "kv_host_tier_bytes": 0,
    "kv_disk_tier_path": None, "kv_disk_tier_bytes": None,
}

#: restore() keyword sentinel: None is a meaningful ``use_flash_paged``
_UNSET = object()

#: the histograms a ``record_timing`` engine owns, JAX's names: the
#: five of the phase clock, the admission split, and the fused and
#: async paths' two. The JAX engine also owns those of tensor
#: parallelism and KV transfer and tiers; they come with those knobs
#: (ROADMAP item 8)
ENGINE_HISTOGRAMS = ("serving_ttft_s", "serving_itl_s",
                     "serving_queue_wait_s", "serving_round_s",
                     "serving_e2e_s", "serving_admission_warm_s",
                     "serving_admission_cold_s", "serving_host_step_s",
                     "serving_fused_rounds")


class _PhaseClock:
    """Host-side per-request phase clock: every
    request accumulates a monotone, DISJOINT-interval phase breakdown
    — queue wait, admission (split cold-prefill / chunked-suffix /
    prefix-splice / prefix-fetch), per-round decode / verify / stall —
    plus an ordered event timeline, one entry per phase transition
    (capped: a pathological million-round request cannot grow the
    recorder without bound). Because every attributed interval is a
    sub-interval of [submit, terminal] and no two overlap, the phase
    sums can never exceed the request's end-to-end wall time — the
    invariant the gateway soak gates over HTTP.

    Fault retries and paged preemptions open a NEW attempt (the
    timeline keeps absolute ``t_s`` offsets from submit, so attempts
    read as consecutive chapters of one request), and ``enqueue_t``
    resets so each attempt's queue wait is its own."""

    #: ordered-event cap PER ATTEMPT; past it, events are counted
    #: (``events_dropped``) instead of stored — phase totals stay exact
    MAX_EVENTS = 512

    __slots__ = ("submit_t", "enqueue_t", "attempts", "ttft_s",
                 "last_commit_t", "rounds")

    def __init__(self, submit_t: float):
        self.submit_t = submit_t
        self.enqueue_t = submit_t
        self.attempts: List[Dict[str, Any]] = [self._attempt()]
        self.ttft_s: Optional[float] = None
        self.last_commit_t: Optional[float] = None
        self.rounds = 0

    @staticmethod
    def _attempt() -> Dict[str, Any]:
        return {"phases": {}, "events": [], "events_dropped": 0}

    def add(self, now: float, phase: str, dur_s: float,
            **detail: Any) -> None:
        """Accumulate ``dur_s`` into ``phase`` and append a timeline
        event at ``now`` (offsets are relative to submit)."""
        att = self.attempts[-1]
        phases = att["phases"]
        phases[phase] = phases.get(phase, 0.0) + dur_s
        if len(att["events"]) < self.MAX_EVENTS:
            event = {"t_s": now - self.submit_t, "phase": phase,
                     "dur_s": dur_s}
            if detail:
                event.update(detail)
            att["events"].append(event)
        else:
            att["events_dropped"] += 1

    def event(self, now: float, phase: str, **detail: Any) -> None:
        self.add(now, phase, 0.0, **detail)

    def new_attempt(self, now: float, reason: str) -> None:
        """A retry/preemption/defer requeued the request: close the
        current attempt and start the next (distinct attempts in the
        timeline — the soak's retried-request gate)."""
        self.event(now, "requeue", reason=reason)
        self.attempts.append(self._attempt())
        self.enqueue_t = now

    def phase_totals(self) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        for att in self.attempts:
            for phase, dur in att["phases"].items():
                totals[phase] = totals.get(phase, 0.0) + dur
        return totals

    def summary(self, now: float, tokens: int) -> Dict[str, Any]:
        """The terminal timing breakdown (``GenerationResult.timing``
        + the flight-recorder record)."""
        p = self.phase_totals()
        admission = (p.get("admit_cold", 0.0)
                     + p.get("admit_chunk", 0.0)
                     + p.get("admit_splice", 0.0)
                     + p.get("admit_fetch", 0.0))
        return {
            "queue_wait_s": p.get("queue_wait", 0.0),
            "admission_s": admission,
            "admission_cold_s": p.get("admit_cold", 0.0),
            "admission_chunked_s": p.get("admit_chunk", 0.0),
            "admission_splice_s": (p.get("admit_splice", 0.0)
                                   + p.get("admit_fetch", 0.0)),
            "decode_s": p.get("decode", 0.0),
            "verify_s": p.get("verify", 0.0),
            "stall_s": p.get("stall", 0.0),
            "ttft_s": self.ttft_s,
            "e2e_s": now - self.submit_t,
            "attempts": len(self.attempts),
            "rounds": self.rounds,
            "tokens": int(tokens),
        }


#: one-line HELP text per serving track, emitted on /v1/metrics via
#: ``Tracer.describe`` (registered by ``DecodeEngine`` at init)
SERVING_TRACK_HELP = {
    "serving_ttft_s": "submit-to-first-token latency distribution",
    "serving_itl_s": "inter-token latency distribution (per-round "
                     "commit gap / tokens committed)",
    "serving_queue_wait_s": "queue-entry-to-admission-start wait "
                            "distribution (per attempt)",
    "serving_round_s": "scheduling-round wall-time distribution",
    "serving_e2e_s": "submit-to-terminal latency distribution",
    "serving_tokens_generated": "tokens committed across all requests",
    "serving_admitted": "requests admitted into a slot",
    "serving_evicted": "slots freed (finish, cancel, quarantine)",
    "serving_tokens_per_sec": "per-round decode throughput",
    "serving_prefill_tokens": "prompt tokens prefilled",
    "serving_prefill_tokens_skipped": "prompt tokens served from the "
                                      "prefix cache instead",
    "serving_deadline_expired": "requests past their end-to-end "
                                "deadline",
    "serving_shed": "requests shed by backpressure",
    "serving_cancelled": "requests cancelled by the caller",
    "serving_quarantined": "slots quarantined by the paranoid sweep",
    "serving_retries": "fault-retry re-admissions",
    "serving_retry_failures": "requests that exhausted the retry cap",
    "serving_tp_shards": "tensor-parallel shard count (1 = "
                         "single-chip engine)",
    "serving_blocks_free": "free KV pool blocks (per-shard "
                           "{shard=...} copies under tp > 1 — block "
                           "ids are shard-invariant, so every shard "
                           "reports the same count over its own "
                           "head-sliced bytes)",
    "serving_blocks_used": "used KV pool blocks (per-shard copies "
                           "under tp > 1, as serving_blocks_free)",
    "serving_frag_tokens": "allocated-but-masked pool tokens "
                           "(per-shard copies under tp > 1)",
    "serving_admission_warm_s": "admission device-work wall for "
                                "requests that reused a cached "
                                "prefix (splice/fetch + suffix "
                                "prefill) — the warm half of the "
                                "warm-vs-recompute comparison",
    "serving_admission_cold_s": "admission device-work wall for "
                                "requests prefilled from scratch — "
                                "the recompute half of the "
                                "warm-vs-recompute comparison",
    "serving_host_step_s": "inter-dispatch host wall (previous "
                           "round's token sync to the next decode "
                           "dispatch) — the per-round host-loop cost "
                           "fused decode amortizes over K rounds",
    "serving_fused_rounds": "rounds fused per decode scan dispatch "
                            "(the pow2 K-bucket actually run; "
                            "fused_rounds > 0 engines only)",
}


def _targs(req: Request) -> Dict[str, Any]:
    """Span-args fragment carrying the request's fleet trace context
    (empty for untraced requests, so local traffic adds nothing)."""
    return {"trace": req.trace} if req.trace else {}


@dataclasses.dataclass
class _Slot:
    request: Request
    tokens: List[int]
    ttft_s: Optional[float] = None
    prefix_reused: int = 0
    #: prefix-cache row this admission fetched from (quarantine
    #: invalidates it if the slot turns out poisoned), or None
    hit_row: Optional[int] = None
    #: tokens drafted for / accepted by this request (speculative)
    spec_drafted: int = 0
    spec_accepted: int = 0


@dataclasses.dataclass
class _Pending:
    """An admission in flight (JAX's ``_Pending``): the slot is
    reserved and the suffix part-way through (chunked) prefill. ``rnn``
    is the B=1 dense streaming state carried so far (None before the
    first cold segment; the fetched prefix state on a dense hit); ``tok``
    the last segment's sampled token [1]; ``done`` the suffix tokens
    prefilled; ``matched`` the prompt tokens reused from the cache;
    ``hit`` the lease to release (or None); ``seq`` the sequence being
    prefilled (the prompt of a live admission; prompt plus generated
    ids for a restore's rebuild); ``tab`` (paged) the slot's block table
    on a warm hit (spliced trie blocks; the suffix streams THROUGH it),
    None until a cold admission scatters."""

    request: Request
    slot: int
    rnn: Any
    tok: Optional[torch.Tensor]
    done: int
    matched: int
    hit: Optional[PrefixHit]
    tab: Optional[BlockTable] = None
    seq: Sequence[int] = ()

    def __post_init__(self):
        if not len(self.seq):
            self.seq = [int(t) for t in self.request.prompt]

    @property
    def remaining(self) -> int:
        return len(self.seq) - self.matched - self.done


@dataclasses.dataclass
class _InflightRound:
    """One dispatched decode round (stepped or fused) whose tokens have
    not landed: what the landing needs to commit them. ``seq`` [B, T]
    and ``n_valid`` [B] (fused only) are host tensors, pinned copies
    that ``event`` (None on the CPU) completes; ``decode_tokens`` is
    what the device wrote per slot (K * chunk for a fused window). A
    speculative round also carries its ``drafts`` (slot -> draft) and ``verify`` = (lens
    [B] host array, emitted [B, W+1], acc [B], host tensors behind the
    same event), so the landing commits the verify pass first. ``rids``
    maps each active slot to the request it held at dispatch: a slot
    cancelled before the landing (async rounds) is skipped, its rows
    discarded. ``td0`` and ``dispatch_end`` are the engine clock's
    readings around the decode dispatch, ``ver_dt`` the verify pass's
    dispatch wall and ``n_rounds`` the rounds the dispatch ran (K for a
    fused window): the phase clocks' share of the round (0.0 with
    ``record_timing`` off)."""

    active: List[int]
    rids: Dict[int, int]
    seq: torch.Tensor
    n_valid: Optional[torch.Tensor]
    event: Any
    t0: float
    decode_tokens: int
    drafts: Optional[Dict[int, List[int]]] = None
    verify: Optional[tuple] = None
    td0: float = 0.0
    dispatch_end: float = 0.0
    ver_dt: float = 0.0
    n_rounds: int = 1


def _request_dict(req: Request) -> Dict[str, Any]:
    """Plain-dict form of a Request (the snapshot wire format)."""
    return {
        "prompt": [int(t) for t in req.prompt],
        "max_new_tokens": int(req.max_new_tokens),
        "temperature": float(req.temperature),
        "top_k": None if req.top_k is None else int(req.top_k),
        "eos_id": None if req.eos_id is None else int(req.eos_id),
        "id": req.id,
        "deadline_s": req.deadline_s,
        "queue_timeout_s": req.queue_timeout_s,
        "trace": req.trace,
        "tenant": req.tenant,
        "priority": req.priority,
    }


def _jax_key_words(seed: int) -> List[int]:
    """The two uint32 words ``jax.random.PRNGKey(seed)`` holds in JAX's
    default 32-bit mode (``[0, seed mod 2**32]``), computed without JAX:
    what a snapshot's ``rng_key`` carries so that the JAX package's
    ``restore`` accepts it."""
    return [0, int(seed) & 0xFFFFFFFF]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _pinned_empty(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _host_copies(bufs: Dict[tuple, torch.Tensor],
                 outputs: Dict[str, torch.Tensor],
                 alloc=_pinned_empty) -> Dict[str, torch.Tensor]:
    """Copies of a dispatch's named outputs into the host buffers
    ``bufs``, keyed by output name, shape and dtype (so two outputs of
    one round never share a buffer: a verify pass's ``emitted`` and a
    decode chunk's ``seq`` may have one shape), made by ``alloc`` on
    first use (pinned memory) and enqueued without a sync."""
    outs = {}
    for name, t in outputs.items():
        key = (name, tuple(t.shape), t.dtype)
        buf = bufs.get(key)
        if buf is None:
            buf = bufs[key] = alloc(t)
        buf.copy_(t, non_blocking=True)
        outs[name] = buf
    return outs


def _one_hot(tok: torch.Tensor, vocab: int, dtype) -> torch.Tensor:
    """[B, V] one-hot rows of ``tok`` as a comparison (``F.one_hot``
    checks its range with a host read on the CPU)."""
    return (tok.long()[:, None] == torch.arange(
        vocab, device=tok.device)).to(dtype)


class DecodeEngine:
    """Slot-multiplexed batched decoding for one LM-shaped
    ``MultiLayerNetwork`` (first layer ``n_in`` == output ``n_out`` ==
    vocab, one-hot io), on the net's device.

    ``submit`` requests, then ``run()`` drains queue and slots and
    returns ``{request_id: GenerationResult}``, or drive one round at a
    time with ``step()``. ``decode_chunk`` tokens are decoded per round.
    ``paged_kv`` picks the KV layout (dense slot pool by default, as in
    JAX); ``block_tokens`` and ``kv_blocks`` size the paged pool.
    ``use_flash_paged`` selects the paged attention path (see
    ``nn.layers.attention._should_use_flash_paged``); like the JAX
    engine, a non-None value is stamped onto the net's attention beans.
    ``seed`` seeds the ``torch.Generator`` sampled requests draw from.
    ``fused_rounds`` (0: off) caps the rounds one fused dispatch runs;
    ``async_rounds`` defers each round's landing to the next ``step()``.
    ``prefix_cache_rows`` (0: off) caps the prefix cache's entries;
    ``prefill_chunk`` (0: blocking admission) and ``admission_policy``,
    ``prefill_budget``, ``adaptive_prefill``, ``pressure_high`` and
    ``pressure_low`` pace chunked admission (``Scheduler``; module
    docstring). ``spec_draft_len`` (0: off) is the most tokens a slot
    drafts a round for the verify pass, ``draft_source`` where drafts
    come from (``DRAFT_SOURCES``). ``max_queue`` (None: unbounded) and
    ``shed_policy`` (``SHED_POLICIES``) bound the queue; ``paranoid``
    turns on the per-round health check and quarantine; ``fault_plan``
    injects faults (serving/faults.py); ``max_retries`` and
    ``retry_backoff_rounds`` cap and space a fault victim's retries;
    ``stall_threshold_s`` (None: off) is the round wall past which a
    round counts as a ``slow_steps`` event; ``clock`` (default
    ``time.perf_counter``) is the time deadlines, stalls and the phase
    clocks are read on. ``on_delta`` (a callable ``(rid, tokens)``) or
    ``emit_deltas`` turn on incremental delivery; ``record_timing``,
    ``flight_recorder`` (terminal traces kept, 0: none) and ``tracer``
    the request-scoped observability (module docstring)."""

    #: valid shed policies for a full admission queue: reject the new
    #: arrival, or shed the oldest queued request in its favour
    SHED_POLICIES = ("reject-new", "shed-oldest")

    #: where speculative drafts come from: prompt-lookup n-gram tables
    #: (serving/spec.py), the only source the JAX engine has
    DRAFT_SOURCES = ("ngram",)

    #: stats keys that count failure events (all present from the start)
    FAILURE_KEYS = ("deadline_expired", "queue_timeouts", "cancelled",
                    "shed", "faults_injected", "faults_detected",
                    "quarantined", "retries", "retry_failures",
                    "slow_steps")

    def __init__(self, net, n_slots: int = 8, decode_chunk: int = 8,
                 min_prompt_bucket: int = 8, seed: int = 0,
                 paged_kv: bool = False, block_tokens: int = 16,
                 kv_blocks: Optional[int] = None, use_flash_paged=None,
                 fused_rounds: int = 0, async_rounds: bool = False,
                 prefix_cache_rows: int = 0, prefill_chunk: int = 0,
                 admission_policy: str = "ttft",
                 prefill_budget: Optional[int] = None,
                 adaptive_prefill: bool = False,
                 pressure_high: Optional[int] = None,
                 pressure_low: Optional[int] = None,
                 spec_draft_len: int = 0, draft_source: str = "ngram",
                 max_queue: Optional[int] = None,
                 shed_policy: str = "reject-new", paranoid: bool = False,
                 fault_plan: Optional[FaultPlan] = None,
                 max_retries: int = 2, retry_backoff_rounds: int = 1,
                 stall_threshold_s: Optional[float] = None, clock=None,
                 tracer=None, on_delta=None, emit_deltas: bool = False,
                 record_timing: bool = True, flight_recorder: int = 256,
                 **unported):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(
                    f"DecodeEngine got an unexpected keyword {name!r}")
            if value != _UNPORTED[name]:
                raise NotImplementedError(
                    f"DecodeEngine({name}={value!r}) is not ported to the "
                    f"torch package yet (only {_UNPORTED[name]!r})")
        if n_slots < 1:
            raise ValueError(f"n_slots {n_slots} < 1")
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk {decode_chunk} < 1")
        if fused_rounds < 0:
            raise ValueError(f"fused_rounds {fused_rounds} < 0")
        if shed_policy not in self.SHED_POLICIES:
            raise ValueError(
                f"shed_policy {shed_policy!r}: expected one of "
                f"{self.SHED_POLICIES}")
        if spec_draft_len < 0:
            raise ValueError(f"spec_draft_len {spec_draft_len} < 0")
        if draft_source not in self.DRAFT_SOURCES:
            raise ValueError(
                f"draft_source {draft_source!r}: expected one of "
                f"{self.DRAFT_SOURCES}")
        if max_retries < 0:
            raise ValueError(f"max_retries {max_retries} < 0")
        if retry_backoff_rounds < 0:
            raise ValueError(
                f"retry_backoff_rounds {retry_backoff_rounds} < 0")
        if flight_recorder < 0:
            raise ValueError(f"flight_recorder {flight_recorder} < 0")
        self.device = resolve_device(net.device)
        net.init()
        self.net = net
        self.n_slots = int(n_slots)
        self.decode_chunk = int(decode_chunk)
        self.fused_rounds = int(fused_rounds)
        self.async_rounds = bool(async_rounds)
        confs = net.conf.confs
        self.vocab = confs[0].layer.n_in
        out_n = getattr(confs[-1].layer, "n_out", None)
        if self.vocab != out_n:
            raise ValueError(
                "DecodeEngine requires an LM-shaped net (first-layer n_in "
                f"== output n_out; got {self.vocab} vs {out_n})")
        windows = []
        attn = []
        for i, c in enumerate(confs):
            bean = c.layer
            if getattr(bean, "ring_axis", None):
                raise ValueError(
                    f"layer {i} is configured with ring_axis="
                    f"{bean.ring_axis!r} and cannot stream; rebuild the "
                    "conf with ring_axis=None for serving")
            if not isinstance(bean, BaseRecurrentLayer):
                continue
            if not isinstance(bean, ATTENTION_BEANS):
                raise ValueError(
                    f"DecodeEngine streams through the attention KV cache; "
                    f"layer {i} ({type(bean).__name__}) carries a recurrent "
                    "state this engine does not support")
            windows.append(bean.stream_max_t)
            attn.append(bean)
        if not windows:
            raise ValueError(
                "DecodeEngine requires at least one attention layer")
        self.window = min(windows)
        self._wmax = max(windows)
        self.use_flash_paged = use_flash_paged
        if use_flash_paged is not None:
            for bean in attn:
                bean.use_flash_paged = use_flash_paged
        self.spec_draft_len = int(spec_draft_len)
        if self.spec_draft_len >= self.window:
            raise ValueError(
                f"spec_draft_len {spec_draft_len} must stay below the "
                f"cache window ({self.window}): a verify chunk carries "
                "the draft plus the current token, and a rejected tail "
                "can only be rewound while nothing slid out of the "
                "window")
        self.prefill_chunk = int(prefill_chunk)
        self.adaptive_prefill = bool(adaptive_prefill)
        self.scheduler = Scheduler(
            self.window, min_bucket=min_prompt_bucket,
            prefill_chunk=self.prefill_chunk,
            prefill_budget=prefill_budget, policy=admission_policy,
            max_queue=max_queue, pressure_high=pressure_high,
            pressure_low=pressure_low, spec_draft_len=self.spec_draft_len)
        self.paged_kv = bool(paged_kv)
        self.block_tokens = int(block_tokens)
        self.kv_blocks = None
        self.block_pool = None
        if self.paged_kv:
            self._size_block_pool(kv_blocks, int(prefix_cache_rows))
        self.prefix_cache: Optional[RadixPrefixCache] = None
        if prefix_cache_rows and self.paged_kv:
            # entries lease pool BLOCKS (zero-copy); the row count caps
            # entries, the block pool caps bytes
            self.prefix_cache = PagedPrefixCache(
                prefix_cache_rows, self.block_tokens,
                ref_block=self.block_pool.ref,
                release_block=self._release_block)
        elif prefix_cache_rows:
            self.prefix_cache = RadixPrefixCache(prefix_cache_rows)
        self._kv_tabs: List[Optional[BlockTable]] = [None] * self.n_slots
        #: per-slot n-gram draft tables (None: speculation off)
        self.spec: Optional[NgramDraftTable] = (
            NgramDraftTable() if self.spec_draft_len else None)
        self.draft_source = draft_source
        self.shed_policy = shed_policy
        self.paranoid = bool(paranoid)
        self.fault_plan = fault_plan
        self.max_retries = int(max_retries)
        self.retry_backoff_rounds = int(retry_backoff_rounds)
        self.stall_threshold_s = stall_threshold_s
        self._clock = clock if clock is not None else time.perf_counter
        #: JAX's attributes of the refused tenancy and KV-tier knobs,
        #: read by the gateway
        self.tenants = None
        self.kv_tier = None
        self.tracer = tracer
        #: incremental delivery: per-request high-water mark of the
        #: delivered tokens, and the deltas buffered for drain_deltas()
        self.on_delta = on_delta
        self.emit_deltas = bool(emit_deltas)
        self._delta_sent: Dict[int, int] = {}
        self._delta_buf: Dict[int, List[int]] = {}
        self.record_timing = bool(record_timing)
        self.flight_recorder = int(flight_recorder)
        #: per-live-request phase clocks (popped at terminal), and the
        #: ring of the last ``flight_recorder`` terminal traces by id
        self._clocks: Dict[int, _PhaseClock] = {}
        self._flight: "OrderedDict[int, Dict[str, Any]]" = OrderedDict()
        self._seed = int(seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        #: the decode round's captured graph, the fused windows' (one
        #: per pow2 K) and the verify passes' (one per pow2 width), in
        #: one memory pool (None: eager rounds, a private switch for
        #: checks on the card)
        self._graphs: Optional[GraphRunner] = GraphRunner([self._gen])
        self._graphs_version = net.params_version
        self._slots: List[Optional[_Slot]] = [None] * self.n_slots
        #: admissions part-way through (chunked) prefill, oldest first,
        #: and the slots they hold
        self._pending: List[_Pending] = []
        self._reserved: set = set()
        self._submit_t: Dict[int, float] = {}
        self._pool: Optional[Dict[str, Dict[str, Any]]] = None
        self._toks: Optional[torch.Tensor] = None   # [B] current tokens
        self._temps = np.zeros(self.n_slots, np.float32)
        self._top_ks = np.full(self.n_slots, self.vocab, np.int64)
        #: the round's static device inputs besides the pool and tokens,
        #: written from the host arrays before each round
        self._round_bufs: Dict[str, torch.Tensor] = {}
        self._round = 0
        self._terminal: Dict[int, GenerationResult] = {}
        #: (ready_round, request): fault victims waiting out a backoff,
        #: preempted and deferred admissions waiting one round
        self._requeue: List[Tuple[int, Request]] = []
        self._retries: Dict[int, int] = {}
        self._admit_fail_pending = 0
        self._has_deadlines = False
        #: ids whose admission has started at least once (a queue
        #: timeout bounds the wait for the FIRST admission only)
        self._started: set = set()
        #: the dispatched round not landed yet (async rounds)
        self._inflight: Optional[_InflightRound] = None
        #: pinned host buffers the rounds' outputs are copied into, by
        #: output name, shape and dtype (two outputs of one round never
        #: share one); reused only after the landing waited on their
        #: event
        self._pinned: Dict[tuple, torch.Tensor] = {}
        #: engine-clock stamp of the last token sync
        #: (serving_host_step_s)
        self._last_sync_end: Optional[float] = None
        #: the round's phase-clock anchors, set by step(): its start and
        #: the (slot, rid) pairs running when it began
        self._rt0 = 0.0
        self._running_at_start: Sequence[Tuple[int, int]] = ()
        #: engine-owned histograms (registered into the tracer)
        self.histograms: Dict[str, Histogram] = (
            {name: Histogram() for name in ENGINE_HISTOGRAMS}
            if self.record_timing else {})
        self.stats: Dict[str, Any] = {
            "tokens_generated": 0, "requests_finished": 0,
            "decode_time_s": 0.0, "chunks": 0, "decode_steps": 0,
            "occupancy_sum": 0.0, "admitted": 0, "evicted": 0,
            "prefill_tokens": 0, "prefill_tokens_skipped": 0,
            "chunks_scheduled": 0, "blocks_free": self.kv_blocks or 0,
            "blocks_used": 0, "cow_copies": 0, "prefix_blocks_spliced": 0,
            "frag_tokens": 0, "preempted": 0, "paged_admit_deferred": 0,
            "spec_rounds": 0, "spec_fallback_rounds": 0,
            "spec_drafted": 0, "spec_accepted": 0,
        }
        for key in self.FAILURE_KEYS:
            self.stats[key] = 0
        self.describe_metrics()

    def _size_block_pool(self, kv_blocks: Optional[int],
                         prefix_rows: int) -> None:
        """Block pool sizing (the JAX engine's): by default the dense
        layout's device bytes, ``n_slots`` window rows plus the dense
        prefix pool's ``prefix_rows``, with per-slot append slack for
        one dispatch's writes (a round's verify pass and decode chunk,
        or a fused window)."""
        bt = self.block_tokens
        if bt < 1 or (bt & (bt - 1)):
            raise ValueError(f"block_tokens {bt} must be a power of two")
        if bt > self.window:
            raise ValueError(
                f"block_tokens {bt} exceeds the cache window "
                f"({self.window}) — a block must fit inside it")
        # a speculative round writes its verify chunk (the draft and the
        # current token) and then its decode chunk, a fused window K
        # rounds of decode tokens, before the host sees any: the ring
        # covers the widest single dispatch
        round_write = max(self.decode_chunk + self.spec_draft_len + 1,
                          self.fused_rounds * self.decode_chunk)
        # ring width: the window, plus the widest single write (a whole
        # window at admission) plus one dispatch's decode writes — a
        # logical block is never recycled while a query can reach it
        self._ring_slots = (_ceil_div(self._wmax, bt)
                            + _ceil_div(self.window, bt)
                            + _ceil_div(round_write, bt) + 3)
        slot_worst = (_ceil_div(self._wmax, bt)
                      + _ceil_div(round_write, bt) + 3)
        if kv_blocks is None:
            kv_blocks = max(
                _ceil_div(self._wmax, bt) * (self.n_slots + prefix_rows)
                + self.n_slots * (_ceil_div(round_write, bt) + 2),
                slot_worst)
        self.kv_blocks = int(kv_blocks)
        if self.kv_blocks < slot_worst:
            raise ValueError(
                f"kv_blocks {self.kv_blocks} cannot hold one slot's window "
                f"+ one round of writes ({slot_worst} blocks of {bt} "
                "tokens)")
        self.block_pool = BlockPool(self.kv_blocks, bt)

    # -- forward -------------------------------------------------------
    def _forward(self, x, mask, rnn):
        """(out [B, V, T], new_rnn) of the net's streaming forward."""
        out, _, new_rnn = self.net._forward_fn(
            self.net.params, self.net.state, x, None, False,
            feature_mask=mask, rnn_state=rnn)
        return out, new_rnn

    # -- request lifecycle ---------------------------------------------
    def submit(self, request: Request) -> int:
        """Queue a request; returns its id (``run()`` drains). With a
        bounded queue (``max_queue``) a full queue sheds per
        ``shed_policy``: the result of the shed request (this one under
        "reject-new", the oldest queued one under "shed-oldest") is
        delivered with ``finish_reason="shed"`` at the next
        ``run()``/``step()`` drain."""
        bad = [t for t in request.prompt if not 0 <= int(t) < self.vocab]
        if bad:
            raise ValueError(
                f"prompt ids {bad[:4]} outside vocab [0, {self.vocab})")
        self.scheduler.validate(request)
        if self.scheduler.full:
            if self.shed_policy == "reject-new":
                rid = self.scheduler.assign_id(request)
                self._mint_clock(rid)
                self._shed(request)
                return rid
            self._shed(self.scheduler.shed_victim())
        rid = self.scheduler.submit(request)
        self._submit_t[rid] = self._clock()
        self._mint_clock(rid, self._submit_t[rid])
        if (request.deadline_s is not None
                or request.queue_timeout_s is not None):
            self._has_deadlines = True
        return rid

    def cancel(self, request_id: int) -> bool:
        """Terminate a request wherever it is: queued, waiting out a
        retry backoff, mid-admission (its prefix lease and reserved
        slot released), or decoding in a slot (its partial tokens
        returned). The result (``finish_reason="cancelled"``) is
        delivered at the next ``run()``/``step()`` drain. False when the
        id is unknown or already terminal."""
        req = self.scheduler.remove(request_id)
        if req is not None:
            self._record_terminal(req, [], "cancelled")
            self._failure_event("cancelled")
            return True
        for i, (_, queued) in enumerate(self._requeue):
            if queued.id == request_id:
                del self._requeue[i]
                self._record_terminal(queued, [], "cancelled")
                self._failure_event("cancelled")
                return True
        for pending in list(self._pending):
            if pending.request.id == request_id:
                self._abort_pending(pending)
                self._record_terminal(pending.request, [], "cancelled")
                self._failure_event("cancelled")
                return True
        for slot, state in enumerate(self._slots):
            if state is not None and state.request.id == request_id:
                self._record_slot_terminal(state, "cancelled")
                self._failure_event("cancelled")
                self._evict_slot(slot)
                return True
        return False

    def has_work(self) -> bool:
        """True while anything is queued, admitting, requeued,
        decoding, or dispatched but not landed (async rounds)."""
        return bool(self.scheduler.pending or self._pending
                    or self._requeue
                    or self._inflight is not None
                    or any(s is not None for s in self._slots))

    def run(self) -> Dict[int, GenerationResult]:
        """Drain the queue: admit, decode in chunks, evict finished
        requests, until no work remains."""
        results: Dict[int, GenerationResult] = {}
        self._drain_terminal(results)
        while self.has_work():
            self.step(results)
        return results

    def _drain_terminal(self, results):
        if self._terminal:
            results.update(self._terminal)
            self._terminal.clear()

    # -- request-scoped observability -----------------------------------
    def _span(self, name, **args):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, **args)

    def _traces_of(self, slots) -> Dict[str, Any]:
        """Span-args fragment mapping request id -> fleet trace context
        for a span over several slots (empty when none is traced)."""
        traces = {
            str(self._slots[s].request.id): self._slots[s].request.trace
            for s in slots
            if self._slots[s] is not None and self._slots[s].request.trace}
        return {"traces": traces} if traces else {}

    def describe_metrics(self) -> None:
        """Register the engine's histograms and the HELP text of its
        tracks with the attached tracer (nothing without one).
        Idempotent; the gateway calls it again after attaching its
        own tracer."""
        if self.tracer is None:
            return
        if hasattr(self.tracer, "register_histogram"):
            for name, hist in self.histograms.items():
                self.tracer.register_histogram(name, hist)
        if hasattr(self.tracer, "describe"):
            for name, help_text in SERVING_TRACK_HELP.items():
                self.tracer.describe(name, help_text)

    def _mint_clock(self, rid: int,
                    submit_t: Optional[float] = None) -> None:
        if self.record_timing:
            self._clocks[rid] = _PhaseClock(
                self._clock() if submit_t is None else submit_t)

    def _clock_of(self, rid) -> Optional[_PhaseClock]:
        return self._clocks.get(rid) if self.record_timing else None

    def _observe(self, name: str, value, n: int = 1) -> None:
        hist = self.histograms.get(name)
        if hist is not None and value is not None:
            hist.observe(value, n)

    def request_trace(self, rid: int) -> Optional[Dict[str, Any]]:
        """The flight recorder's record of one TERMINAL request: its
        timing breakdown and its per-attempt phase timeline. None once
        evicted from the ring, for an unknown or live id, or with
        ``record_timing`` off (the gateway maps that to 404 / 202).
        Host values only."""
        return self._flight.get(rid)

    def _note_progress(self, state: _Slot) -> None:
        """Surface a slot's newly committed tokens as a delta. Called
        only where tokens COMMIT (after a round's appends, which
        post-date the paranoid sweep and hold only accepted speculative
        tokens), so a consumer never sees a token the engine later
        disowns."""
        self._emit_delta(state.request.id, state.tokens)

    def _emit_delta(self, rid: int, tokens: List[int]) -> None:
        cb = self.on_delta
        if cb is None and not self.emit_deltas:
            return
        sent = self._delta_sent.get(rid, 0)
        fresh = tokens[sent:]
        if not fresh:
            return
        self._delta_sent[rid] = len(tokens)
        if cb is not None:
            cb(rid, [int(t) for t in fresh])
        else:
            self._delta_buf.setdefault(rid, []).extend(
                int(t) for t in fresh)

    def drain_deltas(self) -> Dict[int, List[int]]:
        """Return (and clear) the committed-token deltas accumulated
        since the last drain (``emit_deltas=True`` engines without an
        ``on_delta`` callback), by request id, in order."""
        buf = self._delta_buf
        self._delta_buf = {}
        return buf

    def _record_terminal(self, request: Request, tokens, reason: str,
                         prefix_reused: int = 0,
                         ttft: Optional[float] = None,
                         spec_drafted: int = 0,
                         spec_accepted: int = 0) -> None:
        """Write a request's terminal result (drained into the caller's
        dict by the next ``step()``) with the retries it survived, its
        phase-clock breakdown and its flight record, and drop every
        piece of host bookkeeping keyed by its id. A committed tail not
        yet streamed flushes as a last delta first, so the deltas
        concatenate to the terminal's tokens (a capped-retry ``"fault"``
        terminal delivers none: its streamed attempts were disowned)."""
        self._emit_delta(request.id, list(tokens))
        timing = None
        clock = self._clocks.pop(request.id, None)
        if clock is not None:
            now = self._clock()
            clock.ttft_s = ttft
            clock.event(now, "terminal", reason=reason)
            timing = clock.summary(now, len(tokens))
            self._observe("serving_e2e_s", timing["e2e_s"])
            if self.flight_recorder:
                self._flight[request.id] = {
                    "id": request.id, "finish_reason": reason,
                    "timing": timing, "attempts": clock.attempts,
                    **_targs(request)}
                while len(self._flight) > self.flight_recorder:
                    self._flight.popitem(last=False)
            if self.tracer is not None:
                self.tracer.instant("serving.request_done",
                                    rid=request.id, reason=reason,
                                    timing=timing, **_targs(request))
        self._terminal[request.id] = GenerationResult(
            id=request.id, tokens=list(tokens), finish_reason=reason,
            prompt_len=len(request.prompt),
            prefix_tokens_reused=prefix_reused, ttft_s=ttft,
            retries=self._retries.pop(request.id, 0),
            spec_drafted=spec_drafted, spec_accepted=spec_accepted,
            timing=timing, trace=request.trace)
        self.stats["requests_finished"] += 1
        self._submit_t.pop(request.id, None)
        self._started.discard(request.id)
        self._delta_sent.pop(request.id, None)
        self.scheduler.release(request.id)

    def _record_slot_terminal(self, state: _Slot, reason: str) -> None:
        """:meth:`_record_terminal` of a running slot's request, with
        its partial tokens and counters."""
        self._record_terminal(state.request, state.tokens, reason,
                              state.prefix_reused, state.ttft_s,
                              state.spec_drafted, state.spec_accepted)

    def _failure_event(self, kind: str) -> None:
        """Count one failure event (a ``FAILURE_KEYS`` stat), mirrored
        into the tracer's cumulative ``serving_<kind>`` track."""
        self.stats[kind] += 1
        if self.tracer is not None:
            self.tracer.incr(f"serving_{kind}")

    def _shed(self, request: Request) -> None:
        self._record_terminal(request, [], "shed")
        self._failure_event("shed")

    def _abort_pending(self, pending: _Pending) -> None:
        """Drop an admission in flight (cancel, deadline): release the
        prefix-cache lease and any spliced or written blocks, and free
        the reserved slot."""
        if pending.hit is not None and self.prefix_cache is not None:
            self.prefix_cache.release(pending.hit)
        self._free_table(pending.tab)
        pending.tab = None
        self._reserved.discard(pending.slot)
        self._pending.remove(pending)

    @staticmethod
    def _hit_eos(state: _Slot) -> bool:
        req = state.request
        return bool(req.eos_id is not None and state.tokens
                    and state.tokens[-1] == req.eos_id)

    def _finished(self, state: _Slot) -> bool:
        return (len(state.tokens) >= state.request.max_new_tokens
                or self._hit_eos(state))

    def _finish(self, state: _Slot, slot: int) -> None:
        # eos wins even on the max_new_tokens-th token
        self._record_slot_terminal(state, "eos" if self._hit_eos(state)
                                   else "length")
        self._evict_slot(slot)

    def _evict_slot(self, slot: int) -> None:
        """Free the slot: paged, its block references are released (its
        blocks return to the free list); dense, its pool rows are zeroed
        in place, the whole-pool analogue of
        ``rnn_clear_previous_state(slots=[slot])``, so stale K/V is
        never observable."""
        if self.paged_kv:
            tab = self._kv_tabs[slot]
            self._kv_tabs[slot] = None
            self._free_table(tab)
        else:
            clear_state_rows(self._pool, [slot])
        self._slots[slot] = None
        self._temps[slot] = 0.0
        self._top_ks[slot] = self.vocab
        if self.spec is not None:
            self.spec.drop(slot)
        self.stats["evicted"] += 1

    # -- paged block-pool plumbing -------------------------------------
    def _release_block(self, bid: int) -> None:
        """Drop one reference to a pool block (the block returns to the
        free list with its last reference, scrubbed in place first if
        the health check found it poisoned: never while a sharer still
        reads it); the one seam through which slots, admissions and the
        prefix trie release blocks."""
        if (self.block_pool.deref(bid) and bid in self.block_pool.poisoned
                and self._pool is not None):
            self.block_pool.scrub_block_device(self._pool, bid)

    def _free_table(self, tab: Optional[BlockTable]) -> None:
        if tab is None:
            return
        for bid in list(tab.blocks.values()):
            self._release_block(bid)
        tab.blocks.clear()

    def _paged_reserve(self, n: int, protect=()) -> bool:
        """Make ``n`` blocks allocatable: first drop LRU prefix-trie
        entries (references only: a block a slot still reads stays),
        then preempt the youngest unprotected slot(s)."""
        pool = self.block_pool
        while pool.free_blocks < n and self.prefix_cache is not None:
            if not self.prefix_cache.evict_one():
                break
        while pool.free_blocks < n:
            victim = next((s for s in range(self.n_slots - 1, -1, -1)
                           if self._slots[s] is not None
                           and s not in protect), None)
            if victim is None:
                return False
            self._preempt_slot(victim)
        return True

    def _preempt_slot(self, slot: int) -> None:
        """Release a running slot's blocks under pool pressure and
        requeue its request for the next round (it prefills again from
        scratch, or from the trie; a greedy request regenerates
        identical ids, and the delta high-water mark keeps them from
        streaming twice). Blocks it shares with the trie stay. A SAMPLED
        request that already streamed ends ``"fault"`` instead (a
        redraw would splice two sequences), as in quarantine."""
        state = self._slots[slot]
        self.stats["preempted"] += 1
        if self.tracer is not None:
            self.tracer.incr("serving_preempted")
        tab = self._kv_tabs[slot]
        self._kv_tabs[slot] = None
        self._free_table(tab)
        self._slots[slot] = None
        self._temps[slot] = 0.0
        self._top_ks[slot] = self.vocab
        if self.spec is not None:
            self.spec.drop(slot)
        if self._streamed_sampled(state):
            self._record_slot_terminal(state, "fault")
            return
        clock = self._clock_of(state.request.id)
        if clock is not None:
            clock.new_attempt(self._clock(), "preempted")
        self._requeue.append((self._round + 1, state.request))

    def _streamed_sampled(self, state: _Slot) -> bool:
        """Whether ``state``'s request samples and has already streamed
        tokens to a delta consumer: a retry's redraw could not be
        spliced onto what was sent."""
        return bool((self.on_delta is not None or self.emit_deltas)
                    and state.request.temperature > 0
                    and self._delta_sent.get(state.request.id, 0) > 0)

    def _drain_requeue(self) -> None:
        """Move the requeued requests whose round has come back to the
        queue (behind the requests already queued)."""
        ready = [q for r, q in self._requeue if r <= self._round]
        if not ready:
            return
        self._requeue = [(r, q) for r, q in self._requeue
                         if r > self._round]
        for req in ready:
            self.scheduler.requeue(req)

    def _ensure_tab(self, tab: BlockTable, n_tokens: int,
                    protect=(), rid: Optional[int] = None) -> bool:
        """Make ``tab`` writable for the next ``n_tokens`` appends:
        copy-on-write the partial tail block if the trie or another slot
        still references it (one block copied in place, then swapped
        into the table), and allocate the fresh blocks the appends cross
        into. False = the pool could not be relieved."""
        pool = self.block_pool
        tail = tab.tail_block() if n_tokens > 0 else None
        cow = tail is not None and pool.refcount(tail[1]) > 1
        need = len(tab.new_logical_blocks(n_tokens)) + (1 if cow else 0)
        if need and not self._paged_reserve(need, protect):
            return False
        if cow:
            g, src = tab.tail_block()
            dst = pool.alloc()
            with self._span("serving.cow_copy", rid=rid, src=src,
                            dst=dst):
                pool.copy_block_device(self._pool, src, dst)
            tab.blocks[g] = dst
            self._release_block(src)
        for g in tab.new_logical_blocks(n_tokens):
            old = g - self._ring_slots
            if old in tab.blocks:   # safety: expired ring predecessor
                self._release_block(tab.blocks.pop(old))
            bid = self.block_pool.alloc()
            if bid is None:
                raise AssertionError("reserved allocation failed")
            tab.blocks[g] = bid
        return True

    def _free_expired_blocks(self, tab: BlockTable) -> None:
        """Release blocks that slid entirely out of every layer's
        window."""
        for g in sorted(tab.blocks):
            if (g + 1) * self.block_tokens <= tab.length - self._wmax:
                self._release_block(tab.blocks.pop(g))
            else:
                break

    def _alloc_window_tab(self, length: int) -> Optional[BlockTable]:
        """A fresh BlockTable covering the last ``min(length, wmax)``
        absolute positions (what a B=1 prefill row holds); None when the
        pool cannot be relieved."""
        bt = self.block_tokens
        floor = max(0, length - self._wmax)
        gs = list(range(floor // bt, (length - 1) // bt + 1))
        if not self._paged_reserve(len(gs)):
            return None
        tab = BlockTable(bt, length=length, floor=floor)
        for g in gs:
            tab.blocks[g] = self.block_pool.alloc()
        return tab

    def _round_buffer(self, name: str, host: np.ndarray) -> torch.Tensor:
        """The round's static device buffer ``name``, written from
        ``host`` without a host sync (an asynchronous copy; pageable
        host memory is staged before the copy returns)."""
        buf = self._round_bufs.get(name)
        if buf is None:
            buf = self._round_bufs[name] = torch.empty(
                host.shape, dtype=torch.from_numpy(host).dtype,
                device=self.device)
        buf.copy_(torch.from_numpy(host), non_blocking=True)
        return buf

    def _table_arrays(self, tabs) -> Dict[str, np.ndarray]:
        """Every row's ring-projected block table, base, floor and
        filled as host arrays (None rows — idle slots — map nothing;
        their writes drop and their keys all mask)."""
        b, s_ring = len(tabs), self._ring_slots
        table = np.full((b, s_ring), -1, np.int32)
        base = np.full((b, s_ring), -1, np.int32)
        floor = np.zeros(b, np.int32)
        filled = np.zeros(b, np.int32)
        for i, tab in enumerate(tabs):
            if tab is None:
                continue
            table[i], base[i] = tab.arrays(s_ring)
            floor[i] = tab.floor
            filled[i] = tab.length
        return {"table": table, "base": base, "floor": floor,
                "filled": filled}

    def _paged_rnn_rows(self, tabs):
        """The paged rnn-state operand for a decode dispatch: each
        layer's pool tensors plus the rows' tables
        (:meth:`_table_arrays`) in the round's static buffers, shared by
        every layer."""
        ops = {name: self._round_buffer(name, arr)
               for name, arr in self._table_arrays(tabs).items()}
        return {name: dict(st, **ops) for name, st in self._pool.items()}

    def _paged_chunk_rows(self, tab: BlockTable):
        """The paged rnn-state operand for one admission's B=1 suffix
        chunk: the pool tensors plus ``tab``'s table operands in FRESH
        device tensors. Never the round's static buffers: those are
        keyed by name and sized ``[n_slots, S]``, and the decode graph
        reads them, so a B=1 copy into them would broadcast over every
        row of the graph's tables."""
        ops = {name: torch.as_tensor(arr).to(self.device)
               for name, arr in self._table_arrays([tab]).items()}
        return {name: dict(st, **ops) for name, st in self._pool.items()}

    def _ensure_pool(self, rnn1) -> None:
        """Create the device pool and token vector lazily from the first
        B=1 prefill state, in the state's dtype (the net's master dtype).
        Dense: per layer ``{k, v: [n_slots, H, W, dh], filled:
        [n_slots]}``, zeros (every slot empty). Paged: per layer
        ``[kv_blocks + 1, block_tokens, H, dh]``; the last block is the
        scratch block that fixed-shape scatters send dropped rows to
        (``AttentionImpl._paged_attend``), named by the layer's
        ``scratch`` entry: ``block_pool`` never hands it out, so no table
        maps it."""
        if self._pool is not None:
            return
        self._toks = torch.zeros(self.n_slots, dtype=torch.int32,
                                 device=self.device)
        if not self.paged_kv:
            self._pool = tree_map(
                lambda a: torch.zeros((self.n_slots,) + a.shape[1:],
                                      dtype=a.dtype, device=a.device), rnn1)
            return
        bt = self.block_tokens

        def make(st):
            k = st["k"]                          # [1, H, W, dh]
            shape = (self.kv_blocks + 1, bt, k.shape[1], k.shape[3])
            return {"pk": torch.zeros(shape, dtype=k.dtype, device=k.device),
                    "pv": torch.zeros(shape, dtype=st["v"].dtype,
                                      device=k.device),
                    "scratch": int(self.kv_blocks)}

        self._pool = {name: make(st) for name, st in rnn1.items()}

    def _scatter_row(self, rnn1, table_row: np.ndarray, length: int):
        """Cold admission: write a B=1 prefill row's valid window tokens
        to their absolute positions in the slot's freshly allocated
        blocks, IN PLACE. A fixed-shape scatter, as in
        ``AttentionImpl._paged_attend``: every window position is
        written, those outside the row's ``filled`` span or in an
        unmapped block to the pool's scratch block (``scratch``), so no
        boolean selection syncs the host (JAX's ``mode="drop"`` scatter
        has no torch counterpart)."""
        bt, s_ring = self.block_tokens, self._ring_slots
        tr = torch.as_tensor(table_row).to(self.device)
        for name, st in self._pool.items():
            k1, v1 = rnn1[name]["k"], rnn1[name]["v"]
            fd = rnn1[name]["filled"][0]
            w = k1.shape[2]
            nbk, _, h, dh = st["pk"].shape
            absp = length - w + torch.arange(w, device=self.device)
            safe = torch.clamp(absp, min=0)
            blk = tr[((safe // bt) % s_ring).long()]
            sel = (absp >= length - fd) & (blk >= 0)
            idx = torch.where(sel, blk * bt + safe % bt,
                              st["scratch"] * bt + safe % bt).long()
            kt = k1[0].permute(1, 0, 2)          # [W, H, dh]
            vt = v1[0].permute(1, 0, 2)
            st["pk"].view(nbk * bt, h, dh).index_put_(
                (idx,), kt.to(st["pk"].dtype))
            st["pv"].view(nbk * bt, h, dh).index_put_(
                (idx,), vt.to(st["pv"].dtype))

    # -- admission -----------------------------------------------------
    def _one_hot_prompt(self, prompt, bucket):
        x = torch.zeros((1, self.vocab, bucket), dtype=torch.float32)
        x[0, torch.as_tensor(list(prompt)), torch.arange(len(prompt))] = 1.0
        mask = torch.zeros((1, bucket), dtype=torch.float32)
        mask[0, :len(prompt)] = 1.0
        return x.to(self.device), mask.to(self.device)

    def _sample_one(self, probs, request: Request) -> torch.Tensor:
        """The request's token [1] from B=1 class probabilities."""
        return sample_tokens(
            probs, np.asarray([request.temperature], np.float32),
            np.asarray([request.top_k or self.vocab]), self._gen)

    def _start_admission(self, request: Request, slot: int) -> None:
        """Begin admitting ``request`` into ``slot`` (JAX's
        ``_start_admission``): look up the prefix cache (dense: fetch a
        copy of the matched state; paged: splice the entry's blocks
        below the matched length into a new table), then prefill the
        whole suffix now (blocking mode) or queue the admission for
        chunks between decode rounds (``prefill_chunk > 0``)."""
        self._started.add(request.id)
        clock = self._clock_of(request.id)
        if clock is not None:
            now = self._clock()
            self._observe("serving_queue_wait_s", now - clock.enqueue_t)
            clock.add(now, "queue_wait", now - clock.enqueue_t, slot=slot)
        rnn, matched, hit, tab = None, 0, None, None
        if self.prefix_cache is not None:
            hit = self.prefix_cache.lookup(request.prompt)
            if hit is not None and self.paged_kv:
                payload = self.prefix_cache.payload(hit.row)
                if hit.matched > payload.floor:
                    # zero-copy: reference the entry's blocks below the
                    # matched length (the dense one-token rewind is
                    # referencing no block past it; the suffix's first
                    # write copies a still-shared boundary block)
                    matched = hit.matched
                    bt = self.block_tokens
                    tab = BlockTable(bt, length=matched,
                                     floor=payload.floor)
                    spliced = 0
                    for g, bid in payload.blocks.items():
                        if (g * bt < matched
                                and (g + 1) * bt > payload.floor):
                            tab.blocks[g] = bid
                            self.block_pool.ref(bid)
                            spliced += 1
                    self.block_pool.stats["spliced"] += spliced
                    self.stats["prefill_tokens_skipped"] += matched
                    with self._span("serving.prefix_splice",
                                    rid=request.id, row=hit.row,
                                    matched=matched, blocks=spliced,
                                    **_targs(request)):
                        pass
                    if clock is not None:
                        clock.event(self._clock(), "admit_splice",
                                    matched=matched, blocks=spliced)
                else:
                    self.prefix_cache.release(hit)
                    hit = None
            elif hit is not None:
                matched = hit.matched
                t_fetch = self._clock()
                with self._span("serving.prefix_fetch", rid=request.id,
                                row=hit.row, matched=matched,
                                drop=hit.drop, **_targs(request)):
                    rnn = self.prefix_cache.fetch(hit)
                if clock is not None:
                    now = self._clock()
                    clock.add(now, "admit_fetch", now - t_fetch,
                              matched=matched)
                self.stats["prefill_tokens_skipped"] += matched
        pending = _Pending(request, slot, rnn, None, 0, matched, hit,
                           tab=tab)
        if self.prefill_chunk:
            self._reserved.add(slot)
            self._pending.append(pending)
            return
        # blocking mode: the whole suffix in one pow2-bucketed prefill
        # (cold: the original admission, bit for bit; warm: one
        # continuation at the suffix's bucket)
        if not self._advance_prefill(pending, pending.remaining):
            self._defer_admission(pending)
            return
        self._complete_admission(pending)

    def _defer_admission(self, pending: _Pending) -> None:
        """Back out an admission the block pool cannot hold now (paged
        only): release the trie lease and any spliced or written blocks,
        free the reserved slot and requeue the request for the next
        round."""
        if pending.hit is not None:
            self.prefix_cache.release(pending.hit)
            pending.hit = None
        self._free_table(pending.tab)
        pending.tab = None
        self._reserved.discard(pending.slot)
        if pending in self._pending:
            self._pending.remove(pending)
        self.stats["paged_admit_deferred"] += 1
        clock = self._clock_of(pending.request.id)
        if clock is not None:
            clock.new_attempt(self._clock(), "admit_deferred")
        self._requeue.append((self._round + 1, pending.request))

    def _advance_prefill(self, pending: _Pending, max_tokens: int) -> bool:
        """Prefill the next ``<= max_tokens`` tokens of a pending
        admission, padded and masked to ``prefill_chunk`` (chunked) or
        to the segment's pow2 bucket (blocking), and sample at its last
        token. Paged warm: the segment streams through the slot's table
        (its K/V scattered into the pool, K2 attending on the card)
        after the table is made writable (CoW of a shared tail block);
        False when the pool cannot be relieved. Otherwise the dense
        carried state: a cold prefill first, then continuations."""
        req = pending.request
        lo = pending.matched + pending.done
        seg = pending.seq[lo:lo + max_tokens]
        width = self.prefill_chunk or self.scheduler.bucket_of(len(seg))
        x, mask = self._one_hot_prompt(seg, width)
        if pending.tab is not None:
            if not self._ensure_tab(pending.tab, len(seg), rid=req.id):
                return False
            rnn_in = self._paged_chunk_rows(pending.tab)
            phase, span = "admit_chunk", "serving.prefill_chunk"
            args = dict(width=width, tokens=len(seg), done=pending.done,
                        paged=True)
        elif pending.rnn is None:
            # the first cold segment establishes the carried state
            rnn_in, phase, span = None, "admit_cold", "serving.prefill"
            args = dict(bucket=width, tokens=len(seg))
        else:
            rnn_in, phase, span = pending.rnn, "admit_chunk", (
                "serving.prefill_chunk")
            args = dict(width=width, tokens=len(seg), done=pending.done)
        t0 = self._clock()
        with self._span(span, rid=req.id, **args, **_targs(req)):
            out, rnn = self._forward(x, mask, rnn_in)
            pending.tok = self._sample_one(out[:, :, len(seg) - 1], req)
        if pending.tab is not None:
            pending.tab.length += len(seg)
        else:
            pending.rnn = rnn
        clock = self._clock_of(req.id)
        if clock is not None:
            now = self._clock()
            clock.add(now, phase, now - t0, tokens=len(seg))
        pending.done += len(seg)
        self.stats["prefill_tokens"] += len(seg)
        self.stats["chunks_scheduled"] += 1
        return True

    def _complete_admission(self, pending: _Pending) -> None:
        """Suffix fully prefilled: write the state into the slot (dense:
        the slot's pool rows; paged cold: a scatter into freshly
        allocated blocks, deferred when the pool cannot hold it; paged
        warm: the table already holds it), store the prompt in the
        prefix cache after releasing the hit's lease, and take the first
        token (its value fetch is the sync that makes TTFT honest)."""
        request, slot = pending.request, pending.slot
        hit_row = None if pending.hit is None else pending.hit.row
        if self.paged_kv:
            if pending.tab is None:
                self._ensure_pool(pending.rnn)
                tab = self._alloc_window_tab(len(pending.seq))
                if tab is None:
                    self._defer_admission(pending)
                    return
                table_row, _ = tab.arrays(self._ring_slots)
                with self._span("serving.admit", rid=request.id,
                                slot=slot, paged=True, **_targs(request)):
                    self._scatter_row(pending.rnn, table_row, tab.length)
            else:
                tab, pending.tab = pending.tab, None
            if self.prefix_cache is not None:
                if pending.hit is not None:
                    self.prefix_cache.release(pending.hit)
                # the trie references the slot's own blocks; the slot's
                # next append copies the shared tail block first
                self.prefix_cache.insert_blocks(request.prompt, tab)
            self._kv_tabs[slot] = tab
        else:
            self._ensure_pool(pending.rnn)
            with self._span("serving.admit", rid=request.id, slot=slot,
                            **_targs(request)):
                tree_map(lambda p, o: p[slot].copy_(o[0]), self._pool,
                         pending.rnn)
            if self.prefix_cache is not None:
                # release BEFORE insert: on a tight cache the freed row
                # lets the insert evict the stale ancestor
                if pending.hit is not None:
                    self.prefix_cache.release(pending.hit)
                self.prefix_cache.insert(request.prompt, pending.rnn)
        self._reserved.discard(slot)
        self._toks[slot] = pending.tok[0]
        first = int(pending.tok[0])
        submit_t = self._submit_t.get(request.id)
        ttft = (self._clock() - submit_t
                if submit_t is not None else None)
        clock = self._clock_of(request.id)
        if clock is not None:
            now = self._clock()
            clock.event(now, "first_token", ttft_s=ttft,
                        prefix_reused=pending.matched)
            clock.last_commit_t = now   # ITL starts after this token
            self._observe("serving_ttft_s", ttft)
            # warm-against-cold admission: the attempt's admission work,
            # split by whether a cached prefix was reused
            phases = clock.attempts[-1]["phases"]
            adm = (phases.get("admit_cold", 0.0)
                   + phases.get("admit_chunk", 0.0)
                   + phases.get("admit_fetch", 0.0))
            self._observe("serving_admission_warm_s" if pending.matched
                          else "serving_admission_cold_s", adm)
        state = _Slot(request, [first], ttft_s=ttft,
                      prefix_reused=pending.matched, hit_row=hit_row)
        self._slots[slot] = state
        self._temps[slot] = request.temperature
        self._top_ks[slot] = request.top_k or self.vocab
        if self.spec is not None:
            self.spec.seed(slot, [int(t) for t in request.prompt]
                           + state.tokens)
        self.stats["tokens_generated"] += 1
        self.stats["admitted"] += 1
        if self._finished(state):
            # a request finishing at admission never reaches a round's
            # health check: probe its row before its terminal drains
            if self.paranoid and not self._row_healthy(slot):
                self._quarantine_victim(slot, state)
                return
            self._finish(state, slot)

    # -- failure handling ----------------------------------------------
    def _elapsed(self, request_id: int, now: float) -> Optional[float]:
        t0 = self._submit_t.get(request_id)
        return None if t0 is None else now - t0

    def _sweep_deadlines(self) -> None:
        """Expire deadlines and queue timeouts wherever the request is
        (JAX's ``_sweep_deadlines``). Queued: removed before any device
        work (a queue timeout sheds, and only before the first
        admission). Requeued or mid-admission: dropped, the lease and
        the reserved slot released. Running: the slot is evicted (its
        neighbours keep decoding) and its partial tokens returned.
        Nothing to do unless a live request carries a time budget."""
        if not self._has_deadlines:
            return
        now = self._clock()
        for req in self.scheduler.queued_requests():
            el = self._elapsed(req.id, now)
            if el is None:
                continue
            if req.deadline_s is not None and el > req.deadline_s:
                self.scheduler.remove(req.id)
                self._record_terminal(req, [], "deadline")
                self._failure_event("deadline_expired")
            elif (req.queue_timeout_s is not None
                  and req.id not in self._started
                  and el > req.queue_timeout_s):
                self.scheduler.remove(req.id)
                self._shed(req)
                self._failure_event("queue_timeouts")
        for ready, req in list(self._requeue):
            el = self._elapsed(req.id, now)
            if (el is not None and req.deadline_s is not None
                    and el > req.deadline_s):
                self._requeue.remove((ready, req))
                self._record_terminal(req, [], "deadline")
                self._failure_event("deadline_expired")
        for pending in list(self._pending):
            el = self._elapsed(pending.request.id, now)
            if (el is not None and pending.request.deadline_s is not None
                    and el > pending.request.deadline_s):
                self._abort_pending(pending)
                self._record_terminal(pending.request, [], "deadline")
                self._failure_event("deadline_expired")
        for slot, state in enumerate(self._slots):
            if state is None:
                continue
            el = self._elapsed(state.request.id, now)
            if (el is not None and state.request.deadline_s is not None
                    and el > state.request.deadline_s):
                self._record_slot_terminal(state, "deadline")
                self._failure_event("deadline_expired")
                self._evict_slot(slot)

        # the flag also gates fused rounds: drop it once no live request
        # carries a time budget
        def timed(req: Request) -> bool:
            return (req.deadline_s is not None
                    or req.queue_timeout_s is not None)

        self._has_deadlines = (
            any(timed(r) for r in self.scheduler.queued_requests())
            or any(timed(r) for _, r in self._requeue)
            or any(timed(p.request) for p in self._pending)
            or any(s is not None and timed(s.request)
                   for s in self._slots))

    def _inject_faults(self) -> None:
        if self.fault_plan is None:
            return
        for event in self.fault_plan.events_at(self._round):
            self._inject(event)

    def _inject(self, event: FaultEvent) -> None:
        """Apply one scheduled fault (JAX's ``_inject``), writing NaN
        into the pools in place (:func:`faults.poison_rows`). An event
        whose target does not exist this round (no active slot to NaN,
        no stored entry to corrupt) is skipped and not recorded."""
        if event.kind == "stall":
            if hasattr(self._clock, "advance"):
                self._clock.advance(event.seconds)
            else:
                time.sleep(event.seconds)
        elif event.kind == "admit_fail":
            self._admit_fail_pending += 1
        elif event.kind == "nan":
            slot = event.slot
            if slot is None:
                active = [i for i, s in enumerate(self._slots)
                          if s is not None]
                slot = active[0] if active else None
            if (slot is None or slot >= self.n_slots
                    or self._slots[slot] is None or self._pool is None):
                return
            if self.paged_kv:
                # the slot's exclusively owned blocks (those its own
                # decode writes touch); shared prefix blocks are the
                # cache_corrupt fault's
                tab = self._kv_tabs[slot]
                excl = [b for b in (tab.blocks.values() if tab else [])
                        if self.block_pool.refcount(b) == 1]
                if not excl:
                    return
                poison_rows(self._pool, excl)
            else:
                poison_rows(self._pool, [slot])
        elif event.kind == "cache_corrupt":
            if self.prefix_cache is None:
                return
            if self.paged_kv and self._pool is None:
                return
            if not self.paged_kv and self.prefix_cache.pool is None:
                return
            rows = self.prefix_cache.stored_rows()
            row = event.row if event.row is not None else (
                rows[0] if rows else None)
            if row is None or row not in rows:
                return
            if self.paged_kv:
                # one block of the stored entry, inside the shared pool
                blocks = self.prefix_cache.payload(row).blocks
                if not blocks:
                    return
                poison_rows(self._pool, [blocks[min(blocks)]])
            else:
                poison_rows(self.prefix_cache.pool, [row])
        self.fault_plan.record(event)
        self._failure_event("faults_injected")

    def _requeue_victim(self, request: Request) -> None:
        """Schedule a fault victim's re-admission: capped retries with
        exponential backoff in rounds; past the cap the request ends
        with ``finish_reason="fault"``."""
        attempts = self._retries.get(request.id, 0) + 1
        if attempts > self.max_retries:
            self._retries[request.id] = attempts - 1
            self._record_terminal(request, [], "fault")
            self._failure_event("retry_failures")
            return
        self._retries[request.id] = attempts
        self._failure_event("retries")
        clock = self._clock_of(request.id)
        if clock is not None:
            clock.new_attempt(self._clock(), "fault_retry")
        ready = self._round + max(
            1, self.retry_backoff_rounds * (2 ** (attempts - 1)))
        self._requeue.append((ready, request))

    def _health_body(self, ops) -> Dict[str, torch.Tensor]:
        """The paranoid health check, JAX's ``paged_health``/``health``:
        ``ops`` = {"pool": the pool, "toks": [B] current tokens}.
        Returns {"ok": bool}: paged, ``[kv_blocks + B]``, each of the
        first ``kv_blocks`` blocks finite in every layer's K and V (the
        scratch block, which dropped rows of any slot may reach, is not
        judged), then each current token inside the vocabulary; dense,
        ``[B]``, each slot's rows finite and its token in range. A row
        is finite when its minimum and maximum are (one ``aminmax``
        pass: a NaN propagates into both, an infinity into one). Plain
        torch ops with no host read: on the card the graph of
        ``"health_check"``."""
        def finite(a, n):
            lo, hi = torch.aminmax(a.reshape(n, -1), dim=1)
            return torch.isfinite(lo) & torch.isfinite(hi)

        pool, toks = ops["pool"], ops["toks"]
        ok = (toks >= 0) & (toks < self.vocab)
        if self.paged_kv:
            nb = self.kv_blocks
            blocks = None
            for st in pool.values():
                for name in ("pk", "pv"):
                    fin = finite(st[name][:nb], nb)
                    blocks = fin if blocks is None else blocks & fin
            return {"ok": torch.cat([blocks, ok])}
        for leaf in tree_leaves(pool):
            if leaf.is_floating_point():
                ok = ok & finite(leaf, leaf.shape[0])
        return {"ok": ok}

    def _health(self) -> np.ndarray:
        """Run the health check (:meth:`_health_body`, a graph replay on
        the card) and bring its verdict to the host: one pinned copy
        behind one event, the paranoid round's second host sync."""
        out = self._run_graph("health_check", self._health_body,
                              {"pool": self._pool, "toks": self._toks})
        host = self._to_host({"health": out["ok"]})["health"]
        event = self._round_event()
        if event is not None:
            event.synchronize()
        return host.numpy().copy()

    def _paged_health(self):
        """The health verdict folded back through the host block tables
        (JAX's ``_paged_health``): ``(bad_blocks, toks_ok [B])``, the
        bad blocks being those a table or the trie still references.
        They join the pool's ``poisoned`` set, so each is scrubbed when
        its last reference drops."""
        ok = self._health()
        blocks_ok, toks_ok = ok[:self.kv_blocks], ok[self.kv_blocks:]
        bad = {b for b in np.nonzero(~blocks_ok)[0].tolist()
               if self.block_pool.refcount(b) > 0}
        self.block_pool.poisoned.update(bad)
        return bad, toks_ok

    def _slot_blocks_bad(self, slot: int, bad: set) -> bool:
        tab = self._kv_tabs[slot]
        return bool(tab and (set(tab.blocks.values()) & bad))

    def _row_healthy(self, slot: int) -> bool:
        """One slot's verdict: the at-admission probe of a request that
        finishes before any round could check it."""
        if self.paged_kv:
            bad, toks_ok = self._paged_health()
            return bool(toks_ok[slot]) and not self._slot_blocks_bad(
                slot, bad)
        return bool(self._health()[slot])

    def _quarantine_victim(self, slot: int, state: _Slot) -> None:
        """Quarantine one poisoned slot (JAX's ``_quarantine_victim``):
        invalidate its prefix-cache footprint (the row its admission
        fetched, if that row still holds the matched prefix, and the
        entry it inserted: either end may carry the corruption), evict
        it (dense rows zeroed, paged blocks released, a poisoned one
        scrubbed with its last reference; its draft table dropped) and
        requeue the request with backoff. A sampled request that already
        streamed tokens ends ``"fault"`` with the tokens it streamed
        (the poisoned round never appended): a retry's redraw could not
        be spliced onto them."""
        self._failure_event("faults_detected")
        self._failure_event("quarantined")
        if self.prefix_cache is not None:
            if state.hit_row is not None:
                held = self.prefix_cache.row_prefix(state.hit_row)
                prompt = tuple(int(t) for t in state.request.prompt)
                m = state.prefix_reused
                if (held is not None and len(held) >= m
                        and held[:m] == prompt[:m]):
                    self.prefix_cache.invalidate_row(state.hit_row)
            self.prefix_cache.invalidate(state.request.prompt)
        self._evict_slot(slot)
        if self._streamed_sampled(state):
            self._record_slot_terminal(state, "fault")
            self._failure_event("retry_failures")
            return
        self._requeue_victim(state.request)

    def _quarantine(self, active: List[int]) -> List[int]:
        """The paranoid sweep of a landed round (JAX's ``_quarantine``):
        one health check over the pool and the current tokens; every
        condemned slot goes to :meth:`_quarantine_victim`, and paged,
        every trie entry still holding a poisoned block is invalidated.
        Returns the healthy subset of ``active``: the poisoned round's
        tokens never reach a result."""
        if self.paged_kv:
            bad, toks_ok = self._paged_health()
            healthy, victims = [], []
            for slot in active:
                if bool(toks_ok[slot]) and not self._slot_blocks_bad(
                        slot, bad):
                    healthy.append(slot)
                else:
                    victims.append(slot)
            for slot in victims:
                self._quarantine_victim(slot, self._slots[slot])
            if bad and self.prefix_cache is not None:
                for row in list(self.prefix_cache.stored_rows()):
                    payload = self.prefix_cache.payload(row)
                    if set(payload.blocks.values()) & bad:
                        self.prefix_cache.invalidate_row(row)
                        self._failure_event("faults_detected")
            return healthy
        ok = self._health()
        healthy = [s for s in active if bool(ok[s])]
        for slot in active:
            if not bool(ok[slot]):
                self._quarantine_victim(slot, self._slots[slot])
        return healthy

    # -- the scheduling round ------------------------------------------
    def _decode_steps(self, ops, n: int) -> torch.Tensor:
        """``n`` decode steps of one-hot, forward and ``sample_tokens``
        over every slot, from ``ops`` = {"rnn": the rnn state (the dense
        pool, or the paged pool with the dispatch's tables), "toks": [B]
        int32, "temps": [B] f32, "top_ks": [B] int64}. Writes the dense
        pool (the paged pool is written by each step's scatter) and the
        token vector back in place and returns the tokens [B, n]. No
        step reads a value back to the host."""
        rnn, tok = ops["rnn"], ops["toks"]
        steps = []
        for _ in range(n):
            x = _one_hot(tok, self.vocab, self.net._dtype)[:, :, None]
            out, rnn = self._forward(x, None, rnn)
            tok = sample_tokens(out[:, :, -1], ops["temps"], ops["top_ks"],
                                self._gen)
            steps.append(tok)
        if not self.paged_kv:
            tree_map(lambda dst, src: dst.copy_(src), ops["rnn"], rnn)
        ops["toks"].copy_(tok)
        return torch.stack(steps, dim=1)

    def _round_body(self, ops) -> Dict[str, torch.Tensor]:
        """The decode round, JAX's ``decode`` scan: ``decode_chunk``
        steps (:meth:`_decode_steps`); returns {"seq": [B, chunk]}. The
        graph the engine captures on the card, and what runs on the
        CPU."""
        return {"seq": self._decode_steps(ops, self.decode_chunk)}

    def _fused_body(self, ops, k: int) -> Dict[str, torch.Tensor]:
        """``k`` rounds as one window, JAX's ``fused_decode``: k *
        ``decode_chunk`` steps, then each slot's committed prefix on the
        device from ``ops["eos_ids"]`` [B] (-1: none) and
        ``ops["remaining"]`` [B] (``max_new_tokens`` headroom): up to and
        including its first eos, at most its headroom. Returns {"seq":
        [B, k * chunk], "n_valid": [B] int32}."""
        seq = self._decode_steps(ops, k * self.decode_chunk)
        t = seq.shape[1]
        pos = torch.arange(t, device=seq.device)[None, :]
        eos_pos = torch.where(seq == ops["eos_ids"][:, None], pos,
                              torch.full_like(pos, t)).amin(dim=1)
        n_valid = torch.minimum(torch.clamp(eos_pos + 1, max=t),
                                torch.clamp(ops["remaining"], 0, t))
        return {"seq": seq, "n_valid": n_valid.to(torch.int32)}

    def _verify_body(self, ops, width: int) -> Dict[str, torch.Tensor]:
        """One batched verify pass, JAX's ``verify``: every row's
        ``[current token | draft]`` (``ops["draft"]`` [B, width] int32,
        right-padded; ``ops["lens"]`` [B] its valid lengths) through ONE
        forward masked to ``pos <= lens`` (each row's pad stays out of
        attention and out of the cache), the accepted draft prefix
        (``stochastic_acceptance`` on the first ``width`` positions), the
        token after it (``residual_sample`` at position ``acc``: the
        model's own token at the first divergence, or one more past a
        fully accepted draft), and the rejected tails rewound
        (``drop_newest_tokens(rnn, lens - acc)``). The state is written
        back IN PLACE where the decode round reads it: the dense pool's
        rows, or the round's paged ``filled`` buffer (the pool's K/V
        were scattered in place; a rewound tail stays there, masked and
        overwritten by the next append); the new current token into
        ``ops["toks"]``. Returns {"emitted": [B, width + 1] int32 (the
        accepted draft, then the new token, then zeros), "acc": [B]
        int32}. No step reads a value back to the host: on the card this
        is the graph of ``("verify", width)``."""
        rnn, toks = ops["rnn"], ops["toks"]
        draft, lens = ops["draft"], ops["lens"]
        temps, top_ks = ops["temps"], ops["top_ks"]
        seq = torch.cat([toks[:, None], draft], dim=1)       # [B, w + 1]
        b, t = seq.shape
        x = _one_hot(seq.reshape(-1), self.vocab, self.net._dtype)
        x = x.reshape(b, t, self.vocab).transpose(1, 2)      # [B, V, w + 1]
        pos = torch.arange(t, device=seq.device)
        mask = (pos[None, :] <= lens[:, None]).to(torch.float32)
        out, new_rnn = self._forward(x, mask, rnn)           # [B, V, w + 1]
        acc = stochastic_acceptance(out.transpose(1, 2)[:, :-1], draft,
                                    lens, temps, top_ks, self._gen)
        probs = torch.gather(
            out, 2, acc.long()[:, None, None].expand(b, self.vocab, 1)
        )[:, :, 0]
        rej_tok = torch.gather(
            draft, 1, torch.clamp(acc, max=width - 1).long()[:, None])[:, 0]
        bonus = residual_sample(probs, rej_tok, acc < lens, temps, top_ks,
                                self._gen)
        new_rnn = drop_newest_tokens(new_rnn, lens - acc)
        if self.paged_kv:
            for name, st in rnn.items():
                st["filled"].copy_(new_rnn[name]["filled"])
        else:
            tree_map(lambda dst, src: dst.copy_(src), rnn, new_rnn)
        dpad = torch.cat([draft, torch.zeros_like(draft[:, :1])], dim=1)
        emitted = torch.where(
            pos[None, :] < acc[:, None], dpad,
            torch.where(pos[None, :] == acc[:, None], bonus[:, None],
                        torch.zeros_like(dpad)))
        toks.copy_(bonus)
        return {"emitted": emitted, "acc": acc}

    def _run_graph(self, key, body, ops) -> Dict[str, torch.Tensor]:
        """``body(ops)``: a replay of the graph of ``key`` on the card
        (captured at its first dispatch, and again after a move of the
        net's ``params_version``), the eager body on the CPU."""
        if self._graphs is None:
            return body(ops)
        if self._graphs_version != self.net.params_version:
            self._graphs.drop()
            self._graphs_version = self.net.params_version
        return self._graphs.run(key, body, ops)

    def _plan_fused(self, active: List[int], spec_round: bool) -> int:
        """Rounds to fuse into this dispatch (JAX's ``_plan_fused``): 0
        = a stepped round; K >= 1 = one K-round window, only when no
        host decision is pending (no queued arrival, no admission
        part-way through its chunks, no requeued victim, no draft this
        round: a verify pass needs its per-round host lookup; no fault
        plan: its events are indexed by round; no live deadline: it
        must be able to expire between rounds). K is the
        pow2 bucket covering the widest live
        request's remaining rounds, capped at ``fused_rounds``, so at
        most log2(fused_rounds) + 1 windows are ever captured."""
        if (not self.fused_rounds or spec_round or self._pending
                or self._requeue or self.fault_plan is not None
                or self._has_deadlines
                or self.scheduler.decision_pending()):
            return 0
        max_rem = max(self._slots[s].request.max_new_tokens
                      - len(self._slots[s].tokens) for s in active)
        need = _ceil_div(max_rem, self.decode_chunk)
        k = 1
        while k < need and k * 2 <= self.fused_rounds:
            k *= 2
        return k

    def _to_host(self, outputs: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Host copies of a dispatch's named outputs: on the card,
        copies into the engine's pinned buffers (:func:`_host_copies`)
        enqueued behind the dispatch, completed by the round's
        :meth:`_round_event`; on the CPU the tensors themselves. A
        graph's outputs live until the next replay of any graph of the
        runner, so the copy is enqueued before the next dispatch."""
        if self.device.type != "cuda":
            return dict(outputs)
        return _host_copies(self._pinned, outputs)

    def _round_event(self):
        """The event that completes every host copy enqueued for the
        round (the round's one host sync waits on it); None on the
        CPU."""
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    # -- speculative draft and verify ----------------------------------
    def _plan_drafts(self, active: List[int]) -> Dict[int, List[int]]:
        """Each slot's draft for this round from its n-gram table (JAX's
        ``_plan_drafts``; sampled slots draft too), capped at the live K
        (``Scheduler.draft_len``), at the tokens the round's decode
        chunk will not already deliver, and at the slot's window
        headroom (a rejected tail can only be rewound while nothing
        slid out of the window, so a slot near the brim drafts less,
        down to nothing)."""
        k = self.scheduler.draft_len
        drafts: Dict[int, List[int]] = {}
        for slot in active:
            state = self._slots[slot]
            req = state.request
            filled = min(len(req.prompt) + len(state.tokens) - 1,
                         self.window)
            cap = min(k,
                      req.max_new_tokens - len(state.tokens)
                      - self.decode_chunk,
                      self.window - filled - 1)
            drafts[slot] = self.spec.draft(slot, cap) if cap > 0 else []
        return drafts

    def _dispatch_verify(self, drafts: Dict[int, List[int]], ops):
        """Dispatch the round's verify pass (JAX's ``_dispatch_verify``):
        the drafts padded to the round's pow2 width (at most the window
        less one) in round buffers, one replay of the width's graph
        (:meth:`_verify_body`), its outputs' host copies enqueued.
        Nothing syncs: the decode round chains onto the state the pass
        leaves, and the round's event covers both. Returns (lens [B]
        host array, host outputs)."""
        max_len = max(len(d) for d in drafts.values())
        width = min(scan_length_bucket(max_len, minimum=1),
                    self.window - 1)
        draft = np.zeros((self.n_slots, width), np.int32)
        lens = np.zeros(self.n_slots, np.int32)
        for slot, toks in drafts.items():
            toks = list(toks)[:width]
            if toks:
                draft[slot, :len(toks)] = toks
            lens[slot] = len(toks)
        vops = dict(ops, draft=self._round_buffer(f"draft{width}", draft),
                    lens=self._round_buffer("lens", lens))
        live = [s for s, d in drafts.items() if d]
        with self._span("serving.spec_verify", width=width,
                        drafted=int(lens.sum()),
                        rids=[self._slots[s].request.id for s in live],
                        **self._traces_of(live)):
            out = self._run_graph(
                ("verify", width),
                lambda o, _w=width: self._verify_body(o, _w), vops)
        return lens, self._to_host({"verify_emitted": out["emitted"],
                                    "verify_acc": out["acc"]})

    def _land_verify(self, drafts: Dict[int, List[int]], lens,
                     emitted: np.ndarray, acc: np.ndarray) -> np.ndarray:
        """The verify pass's accounting once the round's sync has landed
        it (JAX's ``_land_verify``): the cumulative and per-slot
        counters, and the K-adaptation feedback. Returns each slot's count
        of speculative tokens, ``acc + 1``."""
        drafted = int(sum(int(lens[s]) for s in drafts))
        accepted = int(sum(int(acc[s]) for s in drafts))
        self.stats["spec_rounds"] += 1
        self.stats["spec_drafted"] += drafted
        self.stats["spec_accepted"] += accepted
        for slot in drafts:
            state = self._slots[slot]
            state.spec_drafted += int(lens[slot])
            state.spec_accepted += int(acc[slot])
        self.scheduler.record_acceptance(drafted, accepted)
        if self.tracer is not None:
            self.tracer.counter("serving_spec_accept_rate",
                                accepted / max(drafted, 1))
            self.tracer.counter("serving_spec_draft_len",
                                self.scheduler.draft_len)
        return acc + 1

    def _decode_round(self, active: List[int]) -> None:
        """Plan the drafts (speculative), plan, reserve (paged) and
        dispatch one stepped round (behind a verify pass when a slot
        drafted) or fused window; land it now, or at the next
        ``step()`` (async)."""
        drafts = (self._plan_drafts(active) if self.spec is not None
                  else None)
        spec_round = drafts is not None and any(drafts.values())
        fuse_k = self._plan_fused(active, spec_round)
        n_tok = max(fuse_k, 1) * self.decode_chunk
        if self.paged_kv:
            ensured: set = set()
            for slot in list(active):
                if self._slots[slot] is None:
                    continue   # preempted by an earlier reservation
                # the verify pass writes the draft and the current token
                # before the decode chunk's appends
                need = n_tok + (len(drafts.get(slot, ())) + 1
                                if spec_round else 0)
                if self._ensure_tab(self._kv_tabs[slot], need,
                                    protect=ensured | {slot},
                                    rid=self._slots[slot].request.id):
                    ensured.add(slot)
                else:
                    self._preempt_slot(slot)
            active = [s for s in active if self._slots[s] is not None]
            if drafts is not None:
                drafts = {s: d for s, d in drafts.items() if s in active}
                spec_round = any(drafts.values())
            if fuse_k and self._requeue:
                # a preemption is a scheduling decision: step instead
                # (the extra reserved blocks serve the next rounds)
                fuse_k, n_tok = 0, self.decode_chunk
            if not active:
                return
        t0 = time.perf_counter()
        timing = self.record_timing
        if timing:
            # stall phase: round start to decode dispatch, for the slots
            # running the whole time (disjoint from their own decode and
            # verify shares below)
            t_pre = self._clock()
            if t_pre > self._rt0:
                for slot, rid0 in self._running_at_start:
                    state = self._slots[slot]
                    if state is None or state.request.id != rid0:
                        continue
                    clock = self._clocks.get(rid0)
                    if clock is not None:
                        clock.add(t_pre, "stall", t_pre - self._rt0)
        rnn = (self._paged_rnn_rows(self._kv_tabs) if self.paged_kv
               else self._pool)
        ops = {"rnn": rnn, "toks": self._toks,
               "temps": self._round_buffer("temps", self._temps),
               "top_ks": self._round_buffer("top_ks", self._top_ks)}
        verify = None
        ver_dt = 0.0
        if spec_round:
            # the verify pass first; the decode round below chains onto
            # the state it leaves (the pool, ``filled``, the tokens)
            tv0 = self._clock() if timing else 0.0
            verify = self._dispatch_verify(drafts, ops)
            if timing:
                ver_dt = self._clock() - tv0
        elif self.spec is not None:
            # no slot drafted: the plain decode graph alone
            self.stats["spec_fallback_rounds"] += 1
        td0 = self._clock() if timing else 0.0
        if timing and self._last_sync_end is not None:
            self._observe("serving_host_step_s", td0 - self._last_sync_end)
        with self._span("serving.decode_chunk", active=len(active),
                        fused=fuse_k,
                        rids=[self._slots[s].request.id for s in active],
                        **self._traces_of(active)):
            if fuse_k:
                eos_ids = np.full(self.n_slots, -1, np.int64)
                remaining = np.zeros(self.n_slots, np.int64)
                for s in active:
                    req = self._slots[s].request
                    if req.eos_id is not None:
                        eos_ids[s] = int(req.eos_id)
                    remaining[s] = req.max_new_tokens - len(
                        self._slots[s].tokens)
                ops["eos_ids"] = self._round_buffer("eos_ids", eos_ids)
                ops["remaining"] = self._round_buffer("remaining",
                                                      remaining)
                out = self._run_graph(
                    ("fused", fuse_k),
                    lambda o, _k=fuse_k: self._fused_body(o, _k), ops)
                host = self._to_host({"seq": out["seq"],
                                      "n_valid": out["n_valid"]})
                self._observe("serving_fused_rounds", fuse_k)
            else:
                out = self._run_graph("decode", self._round_body, ops)
                host = self._to_host({"seq": out["seq"]})
        inf = _InflightRound(
            active=list(active),
            rids={s: self._slots[s].request.id for s in active},
            seq=host["seq"],
            n_valid=host.get("n_valid"), event=self._round_event(), t0=t0,
            decode_tokens=n_tok,
            drafts=drafts if spec_round else None,
            verify=(None if verify is None else
                    (verify[0], verify[1]["verify_emitted"],
                     verify[1]["verify_acc"])),
            td0=td0, dispatch_end=self._clock() if timing else 0.0,
            ver_dt=ver_dt, n_rounds=max(fuse_k, 1))
        if self.async_rounds:
            # the round lands at the next step(); the round histogram
            # reads the dispatch wall (the landing belongs to the next
            # round's timeline)
            self._inflight = inf
            if timing:
                self._observe("serving_round_s",
                              inf.dispatch_end - self._rt0)
        else:
            self._land_round(inf)
            if timing:
                self._observe("serving_round_s", self._clock() - self._rt0)

    def _land_round(self, inf: _InflightRound) -> None:
        """Commit a dispatched round (JAX's ``_land_round``): wait for
        its tokens (the round's one host sync), keep only the slots
        that still hold the request they were dispatched for (a cancel
        between an async round's dispatch and its landing discards the
        slot's rows), land a verify pass's accounting first
        (:meth:`_land_verify`), advance the host tables by the tokens
        the device wrote (the decode chunk, plus a verify pass's ``acc
        + 1``) and free blocks that slid out of every window (paged),
        run the paranoid sweep (:meth:`_quarantine`) before any token
        is appended, append each healthy slot's committed tokens (a
        verify pass's accepted draft and new token, then the decode
        chunk; a fused window's ``n_valid`` prefix; overshoot past it is
        dropped), stream each slot's committed tokens as a delta, stamp
        the phase clocks (the dispatch walls plus this sync's, read
        here, where the round syncs anyway), finish requests and extend
        the n-gram tables of those that go on."""
        timing = self.record_timing
        t_sync0 = self._clock() if timing else 0.0
        if inf.event is not None:
            inf.event.synchronize()
        seq = inf.seq.numpy()
        n_valid = None if inf.n_valid is None else inf.n_valid.numpy()
        # decode attribution: the dispatch wall plus the sync's (an
        # async round's gap between steps belongs to no phase)
        dec_dt = ((inf.dispatch_end - inf.td0) + (self._clock() - t_sync0)
                  if timing else 0.0)
        if timing:
            self._last_sync_end = self._clock()
        dt = time.perf_counter() - inf.t0
        active = [s for s in inf.active
                  if self._slots[s] is not None
                  and self._slots[s].request.id == inf.rids.get(s)]
        v_emitted = v_n = None
        if inf.verify is not None:
            lens, v_emitted, v_acc = inf.verify
            v_emitted = v_emitted.numpy()
            v_n = self._land_verify(
                {s: d for s, d in inf.drafts.items() if s in active},
                lens, v_emitted, v_acc.numpy())
        if self.paged_kv:
            for slot in active:
                tab = self._kv_tabs[slot]
                tab.length += inf.decode_tokens + (
                    0 if v_n is None else int(v_n[slot]))
                self._free_expired_blocks(tab)
        if self.paranoid:
            active = self._quarantine(active)
        emitted = 0
        for slot in active:
            state = self._slots[slot]
            if v_n is not None:
                row = (list(v_emitted[slot][:int(v_n[slot])])
                       + list(seq[slot]))
            elif n_valid is not None:
                row = seq[slot][:int(n_valid[slot])]
            else:
                row = seq[slot]
            appended = []
            for t in row:
                state.tokens.append(int(t))
                appended.append(int(t))
                emitted += 1
                if self._finished(state):
                    break
            # after the paranoid sweep: a quarantined slot's round never
            # streams; the admission's first token goes with this one
            self._note_progress(state)
            clock = (self._clocks.get(state.request.id)
                     if timing and appended else None)
            if clock is not None:
                now_c = self._clock()
                if inf.ver_dt:
                    clock.add(now_c, "verify", inf.ver_dt)
                clock.add(now_c, "decode", dec_dt)
                if clock.last_commit_t is not None:
                    gap = (now_c - clock.last_commit_t) / len(appended)
                    self._observe("serving_itl_s", gap, n=len(appended))
                clock.last_commit_t = now_c
                clock.rounds += inf.n_rounds
                clock.event(now_c, "commit", n=len(appended))
            if self._finished(state):
                self._finish(state, slot)
            elif self.spec is not None:
                # committed ids extend the slot's n-gram context (a
                # finished slot dropped its table at eviction)
                self.spec.extend(slot, appended)
        self.stats["tokens_generated"] += emitted
        self.stats["decode_time_s"] += dt
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += inf.decode_tokens
        occ = len(active) / self.n_slots
        self.stats["occupancy_sum"] += occ
        if self.tracer is not None:
            self.tracer.counter("slot_occupancy", occ)
            self.tracer.rate("serving_tokens_per_sec", emitted, dt)
            self._emit_counters()

    def _paged_stats_refresh(self) -> None:
        """Mirror the block pool's gauges into ``stats``."""
        pool = self.block_pool
        self.stats["blocks_free"] = pool.free_blocks
        self.stats["blocks_used"] = pool.used_blocks
        self.stats["cow_copies"] = pool.stats["cow_copies"]
        self.stats["prefix_blocks_spliced"] = pool.stats["spliced"]
        tabs = list(self._kv_tabs) + [p.tab for p in self._pending]
        if self.prefix_cache is not None:
            tabs.extend(self.prefix_cache.tables())
        self.stats["frag_tokens"] = pool.fragmentation_tokens(tabs)

    def _emit_counters(self) -> None:
        """Mirror the engine's cumulative counters into the tracer, one
        track each (JAX's tracks; the failure events mirror when they
        happen, in :meth:`_failure_event`)."""
        for key in ("admitted", "evicted", "chunks_scheduled",
                    "tokens_generated", "prefill_tokens",
                    "prefill_tokens_skipped", "spec_rounds",
                    "spec_fallback_rounds", "spec_drafted",
                    "spec_accepted"):
            self.tracer.counter(f"serving_{key}", self.stats[key])
        if self.paged_kv:
            self._paged_stats_refresh()
            for key in ("blocks_free", "blocks_used", "cow_copies",
                        "prefix_blocks_spliced", "frag_tokens",
                        "preempted", "paged_admit_deferred"):
                self.tracer.counter(f"serving_{key}", self.stats[key])
        if self.prefix_cache is not None:
            for key in ("hits", "misses", "evictions"):
                self.tracer.counter(f"serving_prefix_{key}",
                                    self.prefix_cache.stats[key])
        # JAX's shard gauge: one shard (tensor parallelism is refused)
        self.tracer.gauge("serving_tp_shards", 1)

    @property
    def mean_occupancy(self) -> float:
        chunks = self.stats["chunks"]
        return self.stats["occupancy_sum"] / chunks if chunks else 0.0

    def compile_counts(self) -> Dict[str, int]:
        """The JAX engine's ``compile_counts`` keys for this layout and
        knobs, each the number of CUDA graphs captured for that path:
        ``decode`` is 1 once a round has run on the card and stays 1 (the
        JAX engine's no-retrace guarantee); ``fused_decode`` (present
        only with ``fused_rounds``) counts the fused windows, one per
        pow2 K dispatched; ``verify`` (present only with
        ``spec_draft_len``) the verify passes, one per pow2 draft width
        dispatched; ``health_check`` (present only with ``paranoid``)
        the health check's graph, 1 once it has run; the paths that run eagerly (prefill, chunk
        continuations, admission, the paged movers, the dense prefix
        cache's ``prefix_fetch`` and ``prefix_store``) and every path on
        the CPU read 0. A paged prefix cache adds no key."""
        keys = self._graphs.keys() if self._graphs else []

        def n(kind):
            return sum(1 for k in keys if isinstance(k, tuple)
                       and k[0] == kind)

        counts = {"prefill": 0, "chunk_prefill": 0, "admit": 0,
                  "decode": keys.count("decode")}
        if self.fused_rounds:
            counts["fused_decode"] = n("fused")
        if self.spec_draft_len:
            counts["verify"] = n("verify")
        if self.paranoid:
            counts["health_check"] = keys.count("health_check")
        if self.paged_kv:
            counts.update(paged_scatter=0, paged_tok=0, kv_import=0,
                          kv_gather=0, paged_copy=0, paged_zero=0)
        if self.prefix_cache is not None:
            counts.update(self.prefix_cache.compile_counts())
        return counts

    def _advance_pending(self) -> None:
        """The round's chunk block (JAX ``step()``'s): adapt the budget
        (``adaptive_prefill``), grant chunks oldest first
        (``Scheduler.plan_chunks``; a verify pass, the live K and the
        current token, bills the same budget while a slot is live), run
        them (an admission the block pool cannot hold is deferred to
        the next round), and complete the admissions whose suffix is
        done."""
        if self.adaptive_prefill:
            budget = self.scheduler.adapt_budget()
            if self.tracer is not None:
                self.tracer.counter("serving_prefill_budget", budget)
                self.tracer.counter("serving_pressure",
                                    self.scheduler.pressure())
        verify_reserve = 0
        if self.spec is not None and any(s is not None
                                         for s in self._slots):
            verify_reserve = self.scheduler.draft_len + 1
        grants = self.scheduler.plan_chunks(
            [p.remaining for p in self._pending],
            verify_tokens=verify_reserve)
        targets = [self._pending[i] for i in grants]
        deferred: set = set()
        for p in targets:
            if id(p) in deferred:
                continue
            if not self._advance_prefill(p, self.prefill_chunk):
                self._defer_admission(p)
                deferred.add(id(p))
        if self.tracer is not None:
            self.tracer.counter("serving_round_prefill_chunks",
                                len(grants))
        for p in [p for p in self._pending if p.remaining == 0]:
            self._complete_admission(p)
            if p in self._pending:
                self._pending.remove(p)

    def step(self, results: Optional[Dict[int, GenerationResult]] = None
             ) -> Dict[int, GenerationResult]:
        """One scheduling round: land the round in flight (async),
        requeue, inject the fault plan's events for this round, expire
        deadlines, start admissions into free slots (an injected
        admission failure requeues the request it pops instead),
        advance chunked admissions under the round's prefill budget and
        complete those whose suffix is done, one decode chunk or fused
        window (its reservation and CoW first, paged; the paranoid sweep
        at its landing), evictions. Public so a caller can interleave
        ``cancel()`` and ``snapshot()`` with progress. Terminal results
        accumulate into (and are returned via) ``results``."""
        if results is None:
            results = {}
        with torch.no_grad():
            if self._inflight is not None:
                # async rounds: land the round the previous step
                # dispatched before any of this round's decisions
                inf, self._inflight = self._inflight, None
                self._land_round(inf)
            # the phase clocks' round anchors: the gap before the decode
            # dispatch is the stall of every slot already running
            if self.record_timing:
                self._rt0 = self._clock()
                self._running_at_start = [
                    (i, s.request.id) for i, s in enumerate(self._slots)
                    if s is not None]
            t_start = (self._clock()
                       if self.stall_threshold_s is not None else None)
            # an admit_fail is scoped to its round: one no admission
            # consumed expires
            self._admit_fail_pending = 0
            self._drain_requeue()
            self._inject_faults()
            self._sweep_deadlines()
            for slot in range(self.n_slots):
                if (self._slots[slot] is None
                        and slot not in self._reserved
                        and self.scheduler.pending):
                    if self._admit_fail_pending > 0:
                        # injected admission failure: the request it
                        # pops counts as started and is requeued with
                        # backoff; no device work ran
                        self._admit_fail_pending -= 1
                        victim = self.scheduler.pop()
                        self._started.add(victim.id)
                        self._failure_event("faults_detected")
                        self._requeue_victim(victim)
                        continue
                    nxt = self.scheduler.pop_admissible()
                    if nxt is None:
                        break
                    self._start_admission(nxt, slot)
            if self._pending:
                self._advance_pending()
            active = [i for i, s in enumerate(self._slots)
                      if s is not None]
            if active:
                self._decode_round(active)
        if self.block_pool is not None:
            self._paged_stats_refresh()
        self._round += 1
        if (t_start is not None
                and self._clock() - t_start > self.stall_threshold_s):
            self._failure_event("slow_steps")
        self._drain_terminal(results)
        return results

    # -- snapshot and restore --------------------------------------------
    def _prefill_sequence(self, seq: Sequence[int],
                          temperature: float = 0.0,
                          top_k: Optional[int] = None):
        """Prefill a token sequence to a B=1 dense streaming state
        through the regular admission path (segments of
        ``prefill_chunk``, or of the window in blocking mode, so a
        sequence longer than the window rolls exactly as live decoding
        rolled it): the rebuild primitive of ``restore``. Returns
        ``(rnn, tok)``."""
        probe = Request(list(seq), 1, temperature=temperature, top_k=top_k)
        pending = _Pending(probe, -1, None, None, 0, 0, None,
                           seq=[int(t) for t in seq])
        step_max = min(self.prefill_chunk or self.window, self.window)
        while pending.remaining:
            self._advance_prefill(pending, min(step_max, pending.remaining))
        return pending.rnn, pending.tok

    def _prime_prefix(self, prefix) -> None:
        """Recompute one snapshotted prefix-cache entry (prefill is
        deterministic, so the entry holds what the lost one held).
        Paged: written into fresh blocks that the trie then owns; an
        entry the pool cannot hold is skipped (the cache is a cache, not
        state)."""
        if self.prefix_cache is None or not len(prefix):
            return
        prefix = [int(t) for t in prefix]
        rnn, _ = self._prefill_sequence(prefix)
        if self.paged_kv:
            self._ensure_pool(rnn)
            tab = self._alloc_window_tab(len(prefix))
            if tab is None:
                return
            table_row, _ = tab.arrays(self._ring_slots)
            self._scatter_row(rnn, table_row, tab.length)
            self.prefix_cache.insert_blocks(prefix, tab)
            self._free_table(tab)
            return
        self.prefix_cache.insert(prefix, rnn)

    def _rebuild_slot(self, slot: int, request: Request, tokens: List[int],
                      prefix_reused: int, spec_drafted: int = 0,
                      spec_accepted: int = 0,
                      delta_sent: Optional[int] = None) -> None:
        """Rebuild a snapshotted running slot: re-prefill the prompt and
        the generated ids less the last (exactly the cache a slot holds
        between rounds: its newest id is the current token, not yet in
        the cache), write that state into the slot (dense: its pool
        rows; paged: a scatter into fresh blocks), set the current token,
        the delta high-water mark (``delta_sent``, default every token:
        the resumed stream re-sends only what never left) and rebuild
        the n-gram table from the same ids."""
        tokens = [int(t) for t in tokens]
        seq = [int(t) for t in request.prompt] + tokens[:-1]
        rnn, _ = self._prefill_sequence(seq, request.temperature,
                                        request.top_k)
        self._ensure_pool(rnn)
        if self.paged_kv:
            tab = self._alloc_window_tab(len(seq))
            if tab is None:
                raise RuntimeError(
                    "paged restore could not allocate blocks for a "
                    "snapshotted slot: kv_blocks is smaller than the "
                    "snapshot's working set")
            table_row, _ = tab.arrays(self._ring_slots)
            with self._span("serving.admit", rid=request.id, slot=slot,
                            paged=True, **_targs(request)):
                self._scatter_row(rnn, table_row, tab.length)
            self._kv_tabs[slot] = tab
        else:
            with self._span("serving.admit", rid=request.id, slot=slot,
                            **_targs(request)):
                tree_map(lambda p, o: p[slot].copy_(o[0]), self._pool,
                         rnn)
        self._toks[slot] = tokens[-1]
        self._slots[slot] = _Slot(request, tokens,
                                  prefix_reused=prefix_reused,
                                  spec_drafted=spec_drafted,
                                  spec_accepted=spec_accepted)
        self._delta_sent[request.id] = (len(tokens) if delta_sent is None
                                        else int(delta_sent))
        self._started.add(request.id)
        self._temps[slot] = request.temperature
        self._top_ks[slot] = request.top_k or self.vocab
        if self.spec is not None:
            self.spec.seed(slot, [int(t) for t in request.prompt] + tokens)

    def snapshot(self) -> Dict[str, Any]:
        """Everything needed to finish this engine's work in a fresh
        process, as the JAX engine's version-1 plain (JSON-serialisable)
        dict, key for key: config, RNG, queue, each running slot's
        request and generated ids, admissions in flight (restored as
        queued), requeued requests with their remaining delay, retries,
        the prefix trie's prefixes and undelivered terminal results. No
        device tensor is captured: ``restore`` rebuilds the KV state by
        re-prefilling recorded tokens. An async round in flight lands
        first.

        ``config`` carries the knobs this port refuses at their only
        accepted values, so the JAX package's ``restore`` accepts the
        dict. A slot's ``delta_sent`` counts the tokens already streamed
        to a consumer (buffered, undrained deltas count as not
        streamed). ``paged`` lists the slots' block tables and the refcounts
        of the first ``kv_blocks`` blocks (the pool's scratch block is
        never named). The RNG: ``rng_key`` holds what
        ``jax.random.PRNGKey(seed)`` holds for this engine's seed (a
        torch generator cannot seed JAX's key), and ``torch_rng_state``,
        a key of the port's own that the JAX package ignores, holds the
        engine's generator state as ints (read after the captured
        graphs' replays advanced it)."""
        if self._inflight is not None:
            inf, self._inflight = self._inflight, None
            with torch.no_grad():
                self._land_round(inf)
        now = self._clock()

        def entry(req: Request) -> Dict[str, Any]:
            return {"request": _request_dict(req),
                    "elapsed_s": self._elapsed(req.id, now),
                    "started": req.id in self._started}

        slots: List[Optional[Dict[str, Any]]] = []
        for state in self._slots:
            if state is None:
                slots.append(None)
                continue
            slots.append({
                "request": _request_dict(state.request),
                "tokens": list(state.tokens),
                "prefix_reused": state.prefix_reused,
                "elapsed_s": self._elapsed(state.request.id, now),
                "spec_drafted": state.spec_drafted,
                "spec_accepted": state.spec_accepted,
                "delta_sent": (
                    self._delta_sent.get(state.request.id,
                                         len(state.tokens))
                    - len(self._delta_buf.get(state.request.id, []))),
            })
        sched = self.scheduler
        paged = None
        if self.paged_kv:
            pool = self.block_pool
            paged = {
                "block_tokens": self.block_tokens,
                "kv_blocks": self.kv_blocks,
                "tables": {
                    str(slot): {"length": tab.length, "floor": tab.floor,
                                "blocks": {str(g): int(b)
                                           for g, b in tab.blocks.items()}}
                    for slot, tab in enumerate(self._kv_tabs)
                    if tab is not None},
                "refcounts": {str(b): pool.refcount(b)
                              for b in range(self.kv_blocks)
                              if pool.refcount(b) > 0},
            }
        return {
            "version": 1,
            "config": {
                "n_slots": self.n_slots,
                "decode_chunk": self.decode_chunk,
                "min_prompt_bucket": sched.min_bucket,
                "prefix_cache_rows": (self.prefix_cache.rows
                                      if self.prefix_cache else 0),
                "prefill_chunk": self.prefill_chunk,
                "admission_policy": sched.policy,
                "prefill_budget": sched._budget_ceiling,
                "max_queue": sched.max_queue,
                "shed_policy": self.shed_policy,
                "adaptive_prefill": self.adaptive_prefill,
                "paranoid": self.paranoid,
                "max_retries": self.max_retries,
                "retry_backoff_rounds": self.retry_backoff_rounds,
                "stall_threshold_s": self.stall_threshold_s,
                "spec_draft_len": self.spec_draft_len,
                "draft_source": self.draft_source,
                "paged_kv": self.paged_kv,
                "block_tokens": self.block_tokens,
                "kv_blocks": self.kv_blocks or 0,
                "record_timing": self.record_timing,
                "flight_recorder": self.flight_recorder,
                "tp": _UNPORTED["tp"],
                "use_flash_paged": self.use_flash_paged,
                "async_rounds": self.async_rounds,
                "fused_rounds": self.fused_rounds,
                "kv_host_tier_bytes": _UNPORTED["kv_host_tier_bytes"],
                "kv_disk_tier_path": _UNPORTED["kv_disk_tier_path"],
                "kv_disk_tier_bytes": _UNPORTED["kv_disk_tier_bytes"],
            },
            "paged": paged,
            "tenants": None,
            "spec": ({"draft_len": sched.draft_len,
                      "drafted": sched._spec_drafted,
                      "accepted": sched._spec_accepted,
                      "rounds": sched._spec_rounds}
                     if self.spec is not None else None),
            "rng_key": _jax_key_words(self._seed),
            "torch_rng_state": self._gen.get_state().tolist(),
            "round": self._round,
            "slots": slots,
            "pending": [entry(p.request) for p in self._pending],
            "queue": [entry(r) for r in sched.queued_requests()],
            "requeue": [dict(entry(req),
                             delay_rounds=max(0, ready - self._round))
                        for ready, req in self._requeue],
            "retries": {str(k): v for k, v in self._retries.items()},
            "prefix_prompts": (
                [list(p) for p in self.prefix_cache.cached_prefixes()]
                if self.prefix_cache is not None else []),
            "terminal": [dataclasses.asdict(r)
                         for r in self._terminal.values()],
        }

    @classmethod
    def restore(cls, net, snapshot: Dict[str, Any], tracer=None,
                fault_plan: Optional[FaultPlan] = None, clock=None,
                seed: int = 0, use_flash_paged=_UNSET) -> "DecodeEngine":
        """Rebuild an engine from a ``snapshot()`` dict of either
        package (JAX's ``restore``): the same config, the prefix trie
        re-primed by re-prefill, every running slot's KV state
        re-prefilled from its recorded ids (the prompt and the ids less
        the last, through the chunked path; paged, scattered into fresh
        blocks), the queue (admissions that were in flight first), the
        requeue with its remaining delays, retries, terminals, issued
        ids and deadlines' elapsed time. ``run()`` then finishes the
        same greedy ids a crash-free engine would. Rounds count from 0
        again, as in JAX (a ``fault_plan`` given here is indexed from
        the restore).

        The RNG: the engine's generator takes the snapshot's
        ``torch_rng_state`` when it has one (a port snapshot), after the
        re-prefill, so two restores of one snapshot draw the same
        samples; otherwise it keeps ``seed`` (a JAX key cannot seed a
        torch generator). Sampled streams across the two packages match
        only in distribution.

        Each restored request gets a fresh phase clock back-dated by its
        elapsed time, its timeline marked ``restored``; ``tracer`` is
        attached to the new engine. ``use_flash_paged`` overrides the
        snapshot's toggle (a value the
        port does not know, such as JAX's ``"interpret"``, reads as
        None). A snapshot with tenants, ``tp > 1`` or KV tiers is
        refused as ``__init__`` refuses them."""
        cfg = snapshot["config"]
        if use_flash_paged is _UNSET:
            use_flash_paged = cfg.get("use_flash_paged")
            if use_flash_paged not in (None, True, False):
                use_flash_paged = None
        eng = cls(
            net, n_slots=cfg["n_slots"], decode_chunk=cfg["decode_chunk"],
            min_prompt_bucket=cfg["min_prompt_bucket"], seed=seed,
            tracer=tracer,
            record_timing=cfg.get("record_timing", True),
            flight_recorder=cfg.get("flight_recorder", 256),
            prefix_cache_rows=cfg["prefix_cache_rows"],
            prefill_chunk=cfg["prefill_chunk"],
            admission_policy=cfg["admission_policy"],
            prefill_budget=cfg["prefill_budget"],
            max_queue=cfg["max_queue"], shed_policy=cfg["shed_policy"],
            adaptive_prefill=cfg["adaptive_prefill"],
            paranoid=cfg["paranoid"], fault_plan=fault_plan,
            max_retries=cfg["max_retries"],
            retry_backoff_rounds=cfg["retry_backoff_rounds"],
            stall_threshold_s=cfg["stall_threshold_s"], clock=clock,
            spec_draft_len=cfg.get("spec_draft_len", 0),
            draft_source=cfg.get("draft_source", "ngram"),
            paged_kv=cfg.get("paged_kv", False),
            block_tokens=cfg.get("block_tokens", 16),
            kv_blocks=cfg.get("kv_blocks") or None,
            use_flash_paged=use_flash_paged,
            async_rounds=cfg.get("async_rounds", False),
            fused_rounds=cfg.get("fused_rounds", 0),
            tp=int(cfg.get("tp", 1)), tenants=snapshot.get("tenants"),
            kv_host_tier_bytes=cfg.get("kv_host_tier_bytes", 0),
            kv_disk_tier_path=cfg.get("kv_disk_tier_path"),
            kv_disk_tier_bytes=cfg.get("kv_disk_tier_bytes"))
        spec_state = snapshot.get("spec")
        if spec_state and eng.spec is not None:
            eng.scheduler.draft_len = int(spec_state["draft_len"])
            eng.scheduler._spec_drafted = int(spec_state.get("drafted", 0))
            eng.scheduler._spec_accepted = int(
                spec_state.get("accepted", 0))
            eng.scheduler._spec_rounds = int(spec_state.get("rounds", 0))
        now = eng._clock()
        max_id = -1

        def arm(req: Request, elapsed) -> None:
            nonlocal max_id
            eng._submit_t[req.id] = now - (elapsed or 0.0)
            # e2e keeps the elapsed time; the timeline marks the restore
            # and the queue wait restarts here
            eng._mint_clock(req.id, eng._submit_t[req.id])
            clock = eng._clock_of(req.id)
            if clock is not None:
                clock.event(now, "restored",
                            elapsed_s=float(elapsed or 0.0))
                clock.enqueue_t = now
            if (req.deadline_s is not None
                    or req.queue_timeout_s is not None):
                eng._has_deadlines = True
            max_id = max(max_id, req.id)

        with torch.no_grad():
            for prefix in snapshot.get("prefix_prompts", []):
                eng._prime_prefix(prefix)
            for slot, sd in enumerate(snapshot["slots"]):
                if sd is None:
                    continue
                req = Request(**sd["request"])
                eng._rebuild_slot(slot, req, list(sd["tokens"]),
                                  int(sd.get("prefix_reused", 0)),
                                  int(sd.get("spec_drafted", 0)),
                                  int(sd.get("spec_accepted", 0)),
                                  delta_sent=sd.get("delta_sent"))
                eng.scheduler._issued.add(req.id)
                arm(req, sd.get("elapsed_s"))
        # admissions in flight were the oldest waiters: they re-enter at
        # the front of the queue
        for entry in (list(snapshot.get("pending", []))
                      + list(snapshot["queue"])):
            req = Request(**entry["request"])
            eng.scheduler.requeue(req)
            arm(req, entry.get("elapsed_s"))
            if entry.get("started"):
                eng._started.add(req.id)
        for entry in snapshot.get("requeue", []):
            req = Request(**entry["request"])
            eng._requeue.append(
                (eng._round + int(entry.get("delay_rounds", 0)), req))
            eng.scheduler._issued.add(req.id)
            arm(req, entry.get("elapsed_s"))
            if entry.get("started"):
                eng._started.add(req.id)
        eng._retries = {int(k): int(v)
                        for k, v in snapshot.get("retries", {}).items()}
        for rd in snapshot.get("terminal", []):
            eng._terminal[rd["id"]] = GenerationResult(**rd)
            max_id = max(max_id, rd["id"])
        if max_id >= 0:
            eng.scheduler.reserve_ids_through(max_id)
        state = snapshot.get("torch_rng_state")
        if state is not None:
            eng._gen.set_state(torch.tensor(state, dtype=torch.uint8))
        return eng
