"""Serving gateway: the streaming HTTP front door for the decode
engine.

A copy of ``deeplearning4j_tpu/serving/gateway.py`` over the port's
:class:`DecodeEngine`, with imports rewritten; the wire format (paths,
status codes, SSE framing and event ids, JSON keys) is the JAX
gateway's. What the port adds: the stepping thread, and every handler
that touches the engine under the lock, runs on the CUDA stream the
gateway was built on (the stream the engine's pools and graphs were
made on; a thread's current stream is its own); the KV transfer
handlers, which gather from and write into the pool, are among them.
Handlers that answer without the lock (``/v1/healthz``,
``/v1/metrics``, ``/v1/trace``) read host values only: the stepping
thread may be capturing a CUDA graph, and a capture fails when another
thread launches CUDA work meanwhile.

The :class:`~deeplearning4j_tpu_torch.serving.DecodeEngine` is
a complete serving runtime — continuous batching, prefix cache, chunked
admission, deadlines/cancel/shedding, fault quarantine, speculative
decoding, crash-safe snapshot — but purely in-process: a Python caller
drives ``run()``/``step()`` and sees tokens only at request terminal.
This module is the network surface that turns it into a deployable
server, pairing the engine with a threaded stdlib HTTP frontend the way
production stacks pair an iteration-level scheduler with a streaming
RPC layer (Orca, Yu et al. OSDI'22; vLLM's OpenAI-style frontend,
Kwon et al. SOSP'23). Everything rides the existing machinery: the
gateway owns ONE background engine-stepping thread, translates engine
semantics into HTTP semantics, and adds no device work of its own —
gateway off, the engine is bit-identical to before.

Endpoints (see :class:`GatewayClient` in serving/client.py for the
matching stdlib client):

==========================================  =========================
``POST /v1/generate``                       blocking JSON generation
``POST /v1/generate?stream=1``              chunked/SSE per-token
                                            streaming
``DELETE /v1/requests/<id>``                ``engine.cancel``
``GET /v1/requests/<id>``                   poll a result by id
                                            (200 done / 202 running /
                                            404 unknown)
``GET /v1/requests/<id>/trace``             flight-recorder timeline
                                            + phase breakdown for one
                                            terminal request
``GET /v1/trace``                           Chrome trace-event JSON of
                                            the tracer's event window
                                            (Perfetto-loadable)
``GET /v1/metrics``                         Prometheus-style text
                                            (counter/gauge tracks +
                                            latency histograms)
``GET /v1/healthz``                         liveness + occupancy
``POST /v1/drain``                          stop admission, settle
                                            in-flight, snapshot
``POST /v1/warmup``                         prime the prefix cache
                                            (the ``system`` tenant)
``GET|POST /v1/kv/export``                  a cached prefix as a DKV1
                                            payload (serving/
                                            kv_transfer.py)
``POST /v1/kv/import``                      splice a DKV1 payload
                                            into the pool and trie
==========================================  =========================

Request lifecycle (the failure mappings are the engine's terminal
states wearing HTTP status codes):

- connection → **queue**: a full admission queue (``max_queue`` +
  "reject-new") answers **429** with a ``Retry-After`` hint derived
  from queue depth × measured round time
  (``Scheduler.retry_after_s``); a drained gateway answers **503**.
- queue → **slot** → **deltas**: the engine streams committed-token
  deltas (``DecodeEngine.on_delta`` — decode-chunk tokens, accepted
  speculative tokens, chunked-admission first tokens; never a rejected
  draft tail) which the gateway fans out to each request's connection
  as SSE ``data:`` events.
- client disconnect → **cancel**: a failed stream write (or a failed
  keep-alive ping while the request is still queued) cancels the
  request, freeing its slot for the next admission.
- terminal: ``length``/``eos`` → **200**; ``shed`` → **429**;
  ``deadline``/queue timeout → **504** (partial tokens included);
  ``fault`` (retries exhausted) → **500**; ``cancelled`` → **499**
  (the de-facto client-closed-request code). Streaming responses have
  already sent 200 headers, so the mapped status rides the final SSE
  event's ``status`` field instead.
- drain → snapshot → restore: ``POST /v1/drain`` stops admission,
  lets in-flight work settle (bounded by ``timeout_s``), pauses the
  stepping loop, and writes ``engine.snapshot()`` to
  ``snapshot_path``; :meth:`ServingGateway.boot` on the next process
  restores it and finishes the same ids
  (``DecodeEngine.restore`` semantics — greedy: bit-identical).

Threading model: HTTP handler threads (one per connection,
``ThreadingHTTPServer`` with bounded socket timeouts — util/httpjson)
NEVER touch the engine directly except under ``self._lock``; the
stepping thread holds the same lock for exactly one ``step()`` at a
time. Delta fan-out crosses threads through per-request
``queue.Queue``s, so a slow-reading client backs up only its own
stream, never the engine. All socket writes happen OUTSIDE the lock.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from queue import Empty, Queue
from typing import Any, Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.serving.engine import DecodeEngine
from deeplearning4j_tpu_torch.serving.kv_transfer import (
    DEFAULT_CAP_BYTES,
    KVTransferError,
    KVTransferTooLarge,
)
from deeplearning4j_tpu_torch.serving.scheduler import (
    GenerationResult,
    Request,
)
from deeplearning4j_tpu_torch.util.httpjson import HttpService, JsonHandler

#: disaggregation roles a replica can declare: advisory
#: placement labels the router folds into its pick + transfer policy
ROLES = ("any", "prefill", "decode")

#: engine terminal state → HTTP status for the one-shot JSON endpoint
#: (streaming responses carry the status in the final SSE event)
STATUS_OF_REASON = {
    "length": 200, "eos": 200,
    "shed": 429,        # backpressure: queue full or queue timeout
    "deadline": 504,    # end-to-end budget blown; partial tokens ride
    "fault": 500,       # quarantine retries exhausted
    "cancelled": 499,   # client closed request (nginx convention)
}


def _result_dict(res: GenerationResult) -> Dict[str, Any]:
    out = {
        "id": res.id,
        "tokens": [int(t) for t in res.tokens],
        "finish_reason": res.finish_reason,
        "prompt_len": res.prompt_len,
        "prefix_tokens_reused": res.prefix_tokens_reused,
        "ttft_s": res.ttft_s,
        "retries": res.retries,
        "spec_drafted": res.spec_drafted,
        "spec_accepted": res.spec_accepted,
        "timing": res.timing,
        "status": STATUS_OF_REASON.get(res.finish_reason, 200),
    }
    if res.trace is not None:  # fleet trace context echo
        out["trace"] = res.trace
    if res.tenant is not None:  # tenancy echo: the router
        out["tenant"] = res.tenant  # parks per-tenant keyspace by it
    return out


class _Live:
    """Gateway-side state of one in-flight request: the bridge between
    the stepping thread (producer: deltas, terminal) and the handler
    thread serving its connection (consumer)."""

    __slots__ = ("events", "result", "done", "tokens")

    def __init__(self):
        #: delta token lists and, last, the GenerationResult terminal
        self.events: Queue = Queue()
        self.result: Optional[GenerationResult] = None
        self.done = threading.Event()
        #: cumulative generated tokens: the stream-resume
        #: endpoint follows this list by exact token position, so a
        #: reconnecting client's ``Last-Event-ID`` resumes gap- and
        #: duplicate-free while the request is still running
        self.tokens: List[int] = []


class _GatewayHandler(JsonHandler):
    """One instance per connection (ThreadingHTTPServer). The owning
    :class:`ServingGateway` is attached as the ``gateway`` class
    attribute by HttpService."""

    protocol_version = "HTTP/1.1"  # chunked transfer for streaming
    gateway: "ServingGateway"

    # -- routing -------------------------------------------------------
    def do_POST(self):
        path, _, query = self.path.partition("?")
        if path == "/v1/generate":
            stream = "stream=1" in query.split("&")
            self.gateway._handle_generate(self, stream)
        elif path == "/v1/drain":
            self.gateway._handle_drain(self)
        elif path == "/v1/warmup":
            self.gateway._handle_warmup(self)
        elif path == "/v1/kv/import":
            self.gateway._handle_kv_import(self)
        elif path == "/v1/kv/export":
            self.gateway._handle_kv_export_post(self)
        else:
            self.send_json({"error": f"no such endpoint {path}"}, 404,
                           close=True)

    def do_GET(self):
        path, _, query = self.path.partition("?")
        if path == "/v1/healthz":
            self.send_json(self.gateway._health(), 200, close=True)
        elif path == "/v1/kv/export":
            self.gateway._handle_kv_export(self, query)
        elif path == "/v1/metrics":
            self.send_bytes(self.gateway._metrics_text().encode(),
                            "text/plain; version=0.0.4", 200,
                            close=True)
        elif path == "/v1/trace":
            self.gateway._handle_trace_export(self, query)
        elif (path.startswith("/v1/requests/")
                and path.endswith("/trace")):
            self.gateway._handle_request_trace(self, path)
        elif (path.startswith("/v1/requests/")
                and path.endswith("/stream")):
            self.gateway._handle_stream_resume(self, path, query)
        elif path.startswith("/v1/requests/"):
            self.gateway._handle_poll(self, path)
        else:
            self.send_json({"error": f"no such endpoint {path}"}, 404,
                           close=True)

    def do_DELETE(self):
        path = self.path.partition("?")[0]
        if path.startswith("/v1/requests/"):
            self.gateway._handle_cancel(self, path)
        else:
            self.send_json({"error": f"no such endpoint {path}"}, 404,
                           close=True)

    # SSE framing (send_event / send_ping) is inherited from
    # JsonHandler — one wire-format definition shared with the router


class ServingGateway:
    """Streaming HTTP front door over one :class:`DecodeEngine`.

    The gateway takes ownership of the engine: it attaches the
    ``on_delta`` hook, ensures a tracer (so ``/v1/metrics`` always has
    counter tracks to export), and drives all progress from ONE
    background stepping thread — callers must not call
    ``engine.run()/step()`` themselves while the gateway is live.

    Parameters:

    - ``engine`` — a configured DecodeEngine (any knob combination:
      prefix cache, chunked admission, speculation, fault plan, ...).
    - ``host``/``port`` — bind address (port 0 = ephemeral).
    - ``snapshot_path`` — where ``/v1/drain`` persists
      ``engine.snapshot()``; :meth:`boot` restores from it.
    - ``keepalive_s`` — idle-stream ping interval: bounds how long a
      vanished streaming client can hold a slot before the failed ping
      cancels it.
    - ``request_timeout_s`` — cap on a BLOCKING generate's wait
      (streaming requests are bounded by disconnect-cancel instead);
      None = wait for the engine terminal however long it takes.
    - ``admission_grace_s`` — batch-formation window (default 0 =
      off): when requests start arriving at an IDLE engine, the
      stepper holds the first round up to this long (or until a full
      slate of ``n_slots`` is queued) so a burst of near-simultaneous
      arrivals shares round 1 instead of the first arrival monopolizing
      a whole decode round at 1/B occupancy. Never delays an engine
      that is already decoding, draining terminals, or retrying.

    ``with ServingGateway(engine) as gw: ...`` serves on entry and
    closes on exit; or ``start()``/``close()`` explicitly."""

    def __init__(self, engine: DecodeEngine, host: str = "127.0.0.1",
                 port: int = 0, snapshot_path: Optional[str] = None,
                 keepalive_s: float = 0.5,
                 request_timeout_s: Optional[float] = None,
                 handler_timeout_s: float = 30.0,
                 admission_grace_s: float = 0.0,
                 results_cap: int = 4096,
                 replica_id: Optional[str] = None,
                 role: str = "any",
                 kv_transfer_cap_bytes: Optional[int] = None):
        if engine.on_delta is not None:
            raise ValueError(
                "engine already has an on_delta consumer; the gateway "
                "must own delta delivery")
        self.engine = engine
        if engine.tracer is None:
            from deeplearning4j_tpu_torch.profiler.tracer import Tracer

            # a SERVER tracer must not grow with uptime: cap the event
            # log (latest_counters reads the last-value table, so
            # /v1/metrics is unaffected by the drop-oldest policy)
            engine.tracer = Tracer(max_events=65536)
        elif getattr(engine.tracer, "max_events", 0) is None:
            # same reasoning for a caller-supplied uncapped Tracer:
            # the gateway turns it into a server-lifetime object
            engine.tracer.max_events = 65536
        # (re-)register the engine's latency histograms + HELP text
        # with whichever tracer the gateway just ensured, so
        # /v1/metrics exports serving_ttft_s/serving_itl_s/... even
        # when the engine was built with tracer=None
        engine.describe_metrics()
        self.snapshot_path = snapshot_path
        self.keepalive_s = float(keepalive_s)
        self.request_timeout_s = request_timeout_s
        self.admission_grace_s = float(admission_grace_s)
        self._grace_t0: Optional[float] = None
        #: guards ALL engine access (stepping thread + handler threads)
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        #: handler threads queued for the lock: the stepping loop
        #: re-acquires the lock the instant it releases it, and Python
        #: locks are not fair, so without an explicit yield a busy
        #: engine can starve submits/cancels/drains for entire
        #: workloads. Guarded by its own mutex — `+=` is not atomic,
        #: and a torn increment would leave the count skewed FOREVER
        #: (a permanent -1 reads truthy and taxes every round with the
        #: yield sleep)
        self._waiters = 0
        self._waiters_lock = threading.Lock()
        self._live: Dict[int, _Live] = {}
        #: terminal results retained for GET /v1/requests/<id> —
        #: BOUNDED (insertion-ordered dict, oldest evicted past
        #: ``results_cap``): a long-running server must not grow by
        #: one token list per finished request forever. Streaming and
        #: blocking clients receive their result through ``_Live``
        #: regardless; this store only serves late polls (restored
        #: requests, retries of the poll endpoint).
        self._results: Dict[int, GenerationResult] = {}
        self.results_cap = int(results_cap)
        self._draining = False
        self._paused = False
        self._stopped = False
        # idempotent drain: the first drain owns
        # the work; later/concurrent drains wait and return ITS
        # summary (same carried_ids) instead of double-draining
        self._drain_lock = threading.Lock()
        self._drain_started = False
        self._drain_done = threading.Event()
        self._drain_summary: Optional[Dict[str, Any]] = None
        self._round_s = 0.01  # EMA of step wall time (Retry-After)
        self._step_sink: Dict[int, GenerationResult] = {}
        self.stats = {"connections": 0, "streams": 0,
                      "disconnect_cancels": 0, "rejected_429": 0,
                      "rejected_503": 0, "resumed_streams": 0}
        self._service = HttpService(_GatewayHandler, host, port,
                                    gateway=self,
                                    timeout=float(handler_timeout_s))
        #: stable identity a router tier keys replica state by
        #: defaults to the bound host:port — unique per
        #: live process on one machine, and survives the gateway
        #: restarting on the same address (so affinity hashing stays
        #: put across a replica bounce)
        self.replica_id = (replica_id if replica_id is not None
                           else f"{self._service.host}:"
                                f"{self._service.port}")
        #: disaggregation role: advisory placement label
        #: the router reads from healthz. ``prefill`` = prefers
        #: admission-heavy traffic and serves as a warm-KV donor;
        #: ``decode`` = prefers long-decode streams and pulls KV on
        #: miss; ``any`` (default) = the role-blind behavior.
        if role not in ROLES:
            raise ValueError(
                f"role {role!r}: expected one of {ROLES}")
        self.role = role
        #: bounded-binary cap for the KV transfer endpoints: an
        #: oversized import answers 413 before buffering, an export
        #: larger than this answers 413 instead of shipping
        if kv_transfer_cap_bytes is None:
            kv_transfer_cap_bytes = DEFAULT_CAP_BYTES
        self.kv_transfer_cap_bytes = int(kv_transfer_cap_bytes)
        #: the CUDA stream engine work runs on from every thread (None
        #: for a CPU engine): the building thread's current stream
        self._stream = (torch.cuda.current_stream(engine.device)
                        if engine.device.type == "cuda" else None)
        # claim the engine's delta hook only AFTER the bind succeeded:
        # a port-in-use OSError above must not leave the engine
        # permanently marked as owned by a gateway that never existed
        engine.on_delta = self._on_delta
        self._stepper = threading.Thread(target=self._loop,
                                         daemon=True,
                                         name="gateway-stepper")

    # -- lifecycle -----------------------------------------------------
    @property
    def address(self) -> str:
        return self._service.address

    def start(self) -> "ServingGateway":
        self._service.start()
        self._stepper.start()
        return self

    def __enter__(self) -> "ServingGateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop serving: wake and join the stepping thread, stop the
        HTTP service, release waiting blocking handlers (503). Does NOT
        drain or snapshot — call :meth:`drain` first for a graceful
        shutdown."""
        with self._wake:
            self._stopped = True
            self._wake.notify_all()
        if self._stepper.is_alive():
            self._stepper.join(timeout=10.0)
        # unblock every handler still waiting on a terminal
        for live in list(self._live.values()):
            live.done.set()
        self._service.stop()
        # release the engine: it can be wrapped by a fresh gateway
        # (or driven in-process again) after this one is gone
        self.engine.on_delta = None

    def hard_kill(self) -> None:
        """Chaos helper: die like a SIGKILL from the
        network's perspective — stop stepping immediately (in-flight
        requests freeze mid-decode), close the listening socket so
        new connections are refused, and end every open stream
        WITHOUT a terminal event. No drain, no snapshot, no engine
        release: the wreck stays exactly as the crash left it, the
        way a killed process's state would. The tier-1 router soak
        uses this to rehearse replica death without paying a
        subprocess; the full soak (scripts/router_soak.py) sends a
        real SIGKILL.

        Acquires the lock through ``_engine_access`` (the
        waiter-counted path) on purpose: a busy stepper re-grabs the
        unfair lock every round, and a plain ``with self._wake:``
        here would not run until the engine ran OUT of work — the
        opposite of a kill."""
        with self._engine_access():
            self._stopped = True
            self._wake.notify_all()
        if self._stepper.is_alive():
            self._stepper.join(timeout=10.0)
        self._service.hard_stop()

    @classmethod
    def boot(cls, engine_factory, snapshot_path: Optional[str] = None,
             net_factory=None,
             restore_kwargs: Optional[Dict[str, Any]] = None,
             **gateway_kwargs) -> "ServingGateway":
        """Build-or-restore on process start: when ``snapshot_path``
        holds a drain snapshot, the engine is rebuilt around the net
        with ``DecodeEngine.restore`` (same config, same ids — the
        restored gateway finishes exactly what the drained one left)
        and the file is consumed (renamed ``.restored`` so a crash
        during restore cannot half-replay it twice); otherwise
        ``engine_factory()`` builds a fresh engine.

        ``engine_factory`` is a zero-arg callable returning a
        configured DecodeEngine. On restore, the net to rebuild around
        comes from ``net_factory()`` when given, else from the fresh
        engine's ``.net`` (the snapshot's config wins over the fresh
        engine's knobs; the discarded engine is host-cheap — KV pools
        allocate lazily at first admission, so nothing device-side is
        wasted). ``restore_kwargs`` forwards to
        ``DecodeEngine.restore`` (``tracer``, ``fault_plan``,
        ``clock``, ``seed``)."""
        if snapshot_path and os.path.exists(snapshot_path):
            with open(snapshot_path) as f:
                snap = json.load(f)
            net = (net_factory() if net_factory is not None
                   else engine_factory().net)
            engine = DecodeEngine.restore(net, snap,
                                          **(restore_kwargs or {}))
            os.replace(snapshot_path, snapshot_path + ".restored")
        else:
            engine = engine_factory()
            if not isinstance(engine, DecodeEngine):
                raise TypeError(
                    "engine_factory must return a DecodeEngine; got "
                    f"{type(engine).__name__}")
        return cls(engine, snapshot_path=snapshot_path,
                   **gateway_kwargs)

    # -- the stepping loop ---------------------------------------------
    @contextlib.contextmanager
    def _engine_access(self):
        """Handler-thread engine access: same lock as the stepper,
        plus a waiter count the stepper checks so it yields between
        rounds instead of starving the control plane."""
        with self._waiters_lock:
            self._waiters += 1
        try:
            with self._wake, self._on_stream():
                yield
        finally:
            with self._waiters_lock:
                self._waiters -= 1

    def _on_stream(self):
        """The gateway's CUDA stream as the calling thread's current
        stream (nothing for a CPU engine)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _hold_for_grace(self) -> bool:
        """True while the batch-formation window is open: the engine's
        ONLY work is freshly queued admissions, fewer than a full
        slate, and the window hasn't elapsed (see
        ``admission_grace_s``). Lock held by the caller."""
        if self.admission_grace_s <= 0 or self._grace_t0 is None:
            return False
        eng = self.engine
        if (eng._terminal or eng._pending or eng._requeue
                or any(s is not None for s in eng._slots)):
            self._grace_t0 = None
            return False
        if eng.scheduler.pending >= eng.n_slots:
            self._grace_t0 = None
            return False
        if time.monotonic() - self._grace_t0 > self.admission_grace_s:
            self._grace_t0 = None
            return False
        return True

    def _loop(self) -> None:
        while True:
            if self._waiters:
                # hand the lock to queued submits/cancels/drains
                # before the next round grabs it again
                time.sleep(0.001)
            with self._wake:
                # terminals minted while idle (cancel of a queued
                # request, shed-oldest victims) must drain without
                # waiting for new work — ``step()`` with an empty
                # engine is exactly the drain
                while not self._stopped and (
                        self._paused
                        or not (self.engine.has_work()
                                or self.engine._terminal)
                        or self._hold_for_grace()):
                    self._wake.wait(timeout=0.005
                                    if self._grace_t0 is not None
                                    else 0.05)
                if self._stopped:
                    return
                t0 = time.perf_counter()
                with self._on_stream():
                    self.engine.step(self._step_sink)
                self._round_s = (0.8 * self._round_s
                                 + 0.2 * (time.perf_counter() - t0))
                for rid, res in self._step_sink.items():
                    self._deliver_terminal(rid, res)
                self._step_sink.clear()

    def _bump(self, key: str) -> None:
        # handler threads increment concurrently; '+=' is not atomic
        # and a torn increment skews the exported stat forever (same
        # reason _waiters has a lock — reuse it, contention is nil)
        with self._waiters_lock:
            self.stats[key] += 1

    def _on_delta(self, rid: int, tokens: List[int]) -> None:
        # called inside engine.step() (stepping thread, lock held);
        # Queue.put hands off to the handler thread without blocking
        live = self._live.get(rid)
        if live is not None:
            live.tokens.extend(int(t) for t in tokens)
            live.events.put(list(tokens))

    def _deliver_terminal(self, rid: int,
                          res: GenerationResult) -> None:
        # lock already held (stepping loop / drain); no socket writes
        # happen here — handlers pick the result up on their side
        self._results[rid] = res
        while len(self._results) > self.results_cap:
            self._results.pop(next(iter(self._results)))
        live = self._live.get(rid)
        if live is not None:
            live.result = res
            live.events.put(res)
            live.done.set()

    def _forget(self, rid: int) -> None:
        with self._engine_access():
            self._live.pop(rid, None)

    # -- request plumbing ----------------------------------------------
    def _submit(self, body: Dict[str, Any],
                trace: Optional[str] = None):
        """Parse + admit one generate body under the lock. Returns
        ``(rid, live, None)`` or ``(None, None, (code, payload,
        headers))`` for an immediate rejection. ``trace`` is the
        ``X-DL4J-Trace`` header value; the JSON ``trace``
        field wins when both carriers are present (it is what a
        body-level relay forwards)."""
        if body.get("trace") is not None:
            trace = str(body["trace"])[:256]
        try:
            req = Request(
                prompt=[int(t) for t in body.get("prompt", [])],
                max_new_tokens=int(body.get("max_new_tokens", 16)),
                temperature=float(body.get("temperature", 0.0)),
                top_k=(None if body.get("top_k") is None
                       else int(body["top_k"])),
                eos_id=(None if body.get("eos_id") is None
                        else int(body["eos_id"])),
                deadline_s=(None if body.get("deadline_s") is None
                            else float(body["deadline_s"])),
                queue_timeout_s=(
                    None if body.get("queue_timeout_s") is None
                    else float(body["queue_timeout_s"])),
                trace=trace,
                tenant=str(body.get("tenant") or "default"),
                priority=(None if body.get("priority") is None
                          else int(body["priority"])))
        except (TypeError, ValueError) as e:
            return None, None, (400, {"error": str(e)}, ())
        if req.tenant == "system":
            # the reserved infrastructure tenant is quota-, rate-,
            # and priority-exempt BY DESIGN (warmup handshakes) — an
            # external caller claiming it would bypass the whole QoS
            # layer with one JSON field. Only in-process callers
            # (warmup(), the boot handshake) may bill it.
            return None, None, (
                400, {"error": "tenant 'system' is reserved for "
                               "infrastructure traffic"}, ())
        with self._engine_access():
            if self._draining or self._stopped:
                self._bump("rejected_503")
                return None, None, (503, {"error": "draining"}, ())
            sched = self.engine.scheduler
            tenancy = self.engine.tenants is not None
            tenant_full = tenancy and sched.tenant_full(req.tenant)
            if tenant_full or (sched.full
                               and self.engine.shed_policy
                               == "reject-new"):
                # answer the shed synchronously, BEFORE the engine
                # would mint a terminal for it: the client gets 429 +
                # Retry-After — per-TENANT when tenancy is on (the
                # tenant's own queue share prices the hint, and the
                # payload names the tenant so a router parks only
                # that tenant's keyspace)
                retry = sched.tenant_retry_after_s(
                    req.tenant, self.engine.n_slots, self._round_s)
                self._bump("rejected_429")
                payload = {"error": ("tenant queue full"
                                     if tenant_full
                                     else "queue full"),
                           "retry_after_s": retry}
                if tenancy:
                    payload["tenant"] = req.tenant
                if self.engine.tracer is not None:
                    self.engine.tracer.incr("serving_gateway_429")
                    if tenancy:
                        self.engine.tracer.incr(
                            f'serving_gateway_429{{tenant='
                            f'"{req.tenant}"}}')
                return None, None, (
                    429, payload, (("Retry-After", retry),))
            try:
                rid = self.engine.submit(req)
            except ValueError as e:
                return None, None, (400, {"error": str(e)}, ())
            live = _Live()
            self._live[rid] = live
            if (self.admission_grace_s > 0 and self._grace_t0 is None
                    and not any(s is not None
                                for s in self.engine._slots)):
                # first arrival at an idle engine opens the
                # batch-formation window (_hold_for_grace)
                self._grace_t0 = time.monotonic()
            # under shed-oldest a full queue just evicted someone
            # else; their terminal flows through the normal drain
            self._wake.notify_all()
        return rid, live, None

    def cancel(self, rid: int) -> bool:
        with self._engine_access():
            ok = self.engine.cancel(rid)
            if ok:
                self._wake.notify_all()
        return ok

    # -- endpoint bodies (called from handler threads) ------------------
    def _handle_generate(self, handler: _GatewayHandler,
                         stream: bool) -> None:
        self._bump("connections")
        try:
            body = handler.read_json()
            if not isinstance(body, dict):
                raise ValueError(
                    f"expected a JSON object, got "
                    f"{type(body).__name__}")
        except (ValueError, UnicodeDecodeError) as e:
            handler.send_json({"error": f"bad JSON body: {e}"}, 400,
                              close=True)
            return
        rid, live, reject = self._submit(body,
                                         trace=handler.trace_context())
        if reject is not None:
            code, payload, headers = reject
            handler.send_json(payload, code, close=True,
                              headers=headers)
            return
        if stream:
            self._stream_response(handler, rid, live)
        else:
            self._blocking_response(handler, rid, live)

    def _blocking_response(self, handler, rid: int,
                           live: _Live) -> None:
        deadline = (None if self.request_timeout_s is None
                    else time.monotonic() + self.request_timeout_s)
        try:
            while not live.done.is_set():
                if self._stopped:
                    handler.send_json(
                        {"error": "gateway closed", "id": rid}, 503,
                        close=True)
                    return
                if deadline is not None and time.monotonic() > deadline:
                    self.cancel(rid)
                    live.done.wait(timeout=5.0)
                    break
                live.done.wait(timeout=0.05)
            res = live.result
            if res is None:  # gateway closed or drained mid-request
                handler.send_json(
                    {"error": "gateway closed or drained; poll "
                              "/v1/requests/<id> after the next boot",
                     "id": rid}, 503, close=True)
                return
            headers = ()
            if res.finish_reason == "shed":
                # shed-oldest victims and queue timeouts learn when to
                # come back, same as the synchronous reject-new 429 —
                # priced per tenant when the result names one
                with self._engine_access():
                    headers = (("Retry-After",
                                self.engine.scheduler
                                .tenant_retry_after_s(
                                    res.tenant or "default",
                                    self.engine.n_slots,
                                    self._round_s)),)
            handler.send_json(_result_dict(res),
                              STATUS_OF_REASON.get(res.finish_reason,
                                                   200),
                              close=True, headers=headers)
        finally:
            self._forget(rid)

    def _stream_response(self, handler, rid: int, live: _Live) -> None:
        """Chunked SSE: an initial ``{"id": ...}`` event (so the client
        can DELETE /v1/requests/<id> mid-stream), one ``{"id",
        "tokens"}`` event per engine delta, keep-alive comment pings
        while idle, and a final ``{"done": true, ...}`` event carrying
        the full result + mapped status. Any write failure means the
        client vanished: the request is cancelled and its slot freed."""
        self._bump("streams")
        sent = 0  # delivered-token count = the SSE event id
        try:
            handler.start_stream("text/event-stream")
            handler.send_event({"id": rid}, event_id=0)
            while True:
                try:
                    item = live.events.get(timeout=self.keepalive_s)
                except Empty:
                    if self._stopped:
                        break
                    handler.send_ping()
                    continue
                if item is None:
                    # drained mid-request: the stream ends without a
                    # terminal event (the request finishes after the
                    # next boot — poll GET /v1/requests/<id> there)
                    break
                if isinstance(item, GenerationResult):
                    out = _result_dict(item)
                    out["done"] = True
                    handler.send_event(out,
                                       event_id=len(item.tokens))
                    break
                sent += len(item)
                handler.send_event({"id": rid, "tokens": item},
                                   event_id=sent)
            handler.end_stream()
        except (BrokenPipeError, ConnectionResetError, OSError):
            # the peer is gone: release its compute immediately
            self._bump("disconnect_cancels")
            if self.engine.tracer is not None:
                self.engine.tracer.incr(
                    "serving_gateway_disconnect_cancelled")
            self.cancel(rid)
        finally:
            self._forget(rid)

    def _handle_stream_resume(self, handler, path: str,
                              query: str = "") -> None:
        """``GET /v1/requests/<rid>/stream``: resume a
        stream by exact token position — ``Last-Event-ID: N`` (or
        ``?from=N``) replays everything past token N. A terminal
        request replays from its stored result; a running one whose
        connection-era ``_Live`` still exists is FOLLOWED live (the
        cumulative token list is position-exact); a running request
        with no ``_Live`` (drain-restored: its pre-restore deltas
        never reached this process) answers 202 — poll for the
        terminal, which always carries the full token list. The
        resume consumer never cancels the request when it vanishes;
        cancel-on-disconnect stays the PRIMARY stream's contract
        (the router's relay depends on it)."""
        parsed = handler.read_resume_cursor(path, query)
        if parsed is None:
            return
        rid, cursor = parsed
        with self._engine_access():
            res = self._results.get(rid)
            live = self._live.get(rid)
            running = (live is not None
                       or rid in self.engine.scheduler._issued)
        if res is None and live is None and not running:
            handler.send_json({"error": f"unknown request {rid}"},
                              404, close=True)
            return
        if res is None and live is None:
            handler.send_json(
                {"id": rid, "running": True,
                 "resume": "no live stream state in this process; "
                           "poll /v1/requests/<id> for the terminal"},
                202, close=True)
            return
        self._bump("resumed_streams")
        if self.engine.tracer is not None:
            self.engine.tracer.incr("serving_gateway_resumes")

        def poll(at):
            r = (live.result
                 if live is not None and live.result is not None
                 else res)
            if r is not None:
                total = len(r.tokens)
                tail = ([int(t) for t in r.tokens[at:]]
                        if total > at else [])
                return tail, total, True, _result_dict(r)
            # live is non-None here: the res-and-live-both-None case
            # answered 404/202 above
            tokens = live.tokens
            total = len(tokens)
            tail = ([int(t) for t in tokens[at:]]
                    if total > at else [])
            return (tail, total,
                    live.done.is_set() or self._stopped, None)

        wait = (live.done.wait if live is not None
                else (lambda t: None))
        try:
            handler.follow_stream(rid, cursor, poll, wait,
                                  self.keepalive_s)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # a vanished resume consumer cancels nothing

    def _handle_cancel(self, handler, path: str) -> None:
        rid = self._rid_of(handler, path)
        if rid is None:
            return
        ok = self.cancel(rid)
        with self._engine_access():
            done = rid in self._results
        handler.send_json({"id": rid, "cancelled": ok, "done": done},
                          200 if (ok or done) else 404, close=True)

    def _handle_poll(self, handler, path: str) -> None:
        rid = self._rid_of(handler, path)
        if rid is None:
            return
        with self._engine_access():
            res = self._results.get(rid)
            # a request is "running" if a connection still owns it OR
            # the engine still tracks its id (restored requests have
            # no connection: their results become pollable when done)
            running = (rid in self._live
                       or rid in self.engine.scheduler._issued)
        if res is not None:
            handler.send_json(_result_dict(res), 200, close=True)
        elif running:
            handler.send_json({"id": rid, "running": True}, 202,
                              close=True)
        else:
            handler.send_json({"error": f"unknown request {rid}"},
                              404, close=True)

    # -- flight-recorder / trace endpoints --------------------
    def _handle_request_trace(self, handler, path: str) -> None:
        """``GET /v1/requests/<id>/trace``: the flight recorder's
        per-request timeline + timing breakdown — 200 with the trace,
        202 while the request is still in flight, 404 once evicted
        from the ring (or unknown, or ``record_timing=False``)."""
        tail = path[len("/v1/requests/"):-len("/trace")]
        try:
            rid = int(tail)
        except ValueError:
            handler.send_json({"error": f"bad request id {tail!r}"},
                              400, close=True)
            return
        with self._engine_access():
            trace = self.engine.request_trace(rid)
            running = trace is None and (
                rid in self._live
                or rid in self.engine.scheduler._issued)
            if trace is not None:
                trace = dict(trace)  # detach before leaving the lock
        if trace is not None:
            handler.send_json(trace, 200, close=True)
        elif running:
            handler.send_json({"id": rid, "running": True}, 202,
                              close=True)
        else:
            handler.send_json(
                {"error": f"no trace for request {rid} (unknown, "
                          "evicted from the flight recorder, or "
                          "record_timing off)"}, 404, close=True)

    def _handle_trace_export(self, handler, query: str = "") -> None:
        """``GET /v1/trace``: the tracer's current event window as
        Chrome trace-event JSON (Perfetto/chrome://tracing loadable),
        streamed with the chunked helpers so a large window never
        materializes as one giant bytes object. The tracer snapshot
        is taken under ITS lock (``Tracer.events`` copies); no
        gateway lock is held while writing the socket.

        ``?since_seq=<n>`` returns only events at absolute
        tracer sequence >= n, plus a ``nextSeq`` cursor — the
        incremental protocol the router's per-replica trace cache
        scrapes with, so a periodic scrape pays for the DELTA instead
        of re-serializing a 64k-event window every tick."""
        tracer = self.engine.tracer
        since: Optional[int] = None
        for part in query.split("&"):
            if part.startswith("since_seq="):
                with contextlib.suppress(ValueError):
                    since = int(part[len("since_seq="):])
        next_seq = None
        if tracer is None:
            events = []
        elif since is not None and hasattr(tracer, "events_since"):
            events, next_seq = tracer.events_since(since)
        else:
            events = tracer.events()
        handler.send_trace_events(events, next_seq=next_seq)

    @staticmethod
    def _rid_of(handler, path: str) -> Optional[int]:
        tail = path.rsplit("/", 1)[-1]
        try:
            return int(tail)
        except ValueError:
            handler.send_json({"error": f"bad request id {tail!r}"},
                              400, close=True)
            return None

    def _health(self) -> Dict[str, Any]:
        # deliberately LOCK-FREE: a liveness probe answered
        # under the engine lock stalls for the whole current step —
        # which can be SECONDS while an executable compiles — and a
        # router's short-timeout scrape then reads a busy-but-healthy
        # replica as dead. Every field here is a GIL-atomic read
        # (ints, len, fixed-size list scan); slight staleness is the
        # correct trade for a probe that always answers instantly.
        eng = self.engine
        # one-word lifecycle state: before this,
        # a DRAINING gateway looked healthy to a naive probe (``ok``
        # stayed true) until a request bounced with 503 — a router
        # must see the transition in the payload itself, together
        # with the live load figures its least-loaded fallback weighs
        state = ("stopped" if self._stopped
                 else "draining" if self._draining else "live")
        tracer = self.engine.tracer
        return {
            "ok": not self._stopped,
            "state": state,
            "replica_id": self.replica_id,
            # this replica's tracer clock, in trace-event µs: a
            # router samples it inside a timed scrape to estimate
            # the per-replica clock offset (NTP-style midpoint) that
            # skew-corrects stitched fleet traces. Reads
            # one perf_counter — as lock-free as the rest.
            "now_us": (tracer.now_us()
                       if hasattr(tracer, "now_us") else None),
            "draining": self._draining,
            "round": eng._round,
            "queued": eng.scheduler.pending,
            "active_slots": sum(s is not None for s in eng._slots),
            "n_slots": eng.n_slots,
            "requests_finished": eng.stats["requests_finished"],
            # prompt tokens served from the prefix cache instead of
            # prefilled: the router's affinity gate reads this per
            # replica to prove warm traffic landed warm
            "prefix_tokens_reused":
                eng.stats["prefill_tokens_skipped"],
            # disaggregation surface: the role this
            # replica declared, and whether its engine can speak the
            # KV transfer plane (paged + trie — the router reads
            # this instead of paying a 404 round-trip per miss)
            "role": self.role,
            "kv_transfer": bool(eng.paged_kv
                                and eng.prefix_cache is not None),
            # spill-tier block: entry counts + budgets so
            # the router's donor pick can prefer a tier-warm replica
            # over a cold one. KVTierStore.health() is lock-free by
            # contract (GIL-atomic ints), preserving this probe's
            # answer-instantly property.
            "kv_tier": (eng.kv_tier.health()
                        if eng.kv_tier is not None else None),
        }

    def _metrics_text(self) -> str:
        # refresh gateway gauges right before export so the text
        # reflects this instant, not the last decode round — via
        # ``Tracer.gauge`` (last-value table only), NOT ``counter``:
        # a scrape must never append to the capped event log, or a
        # tight scrape loop evicts real span history (regression-
        # tested). Duck-typed tracers without gauge() fall back to
        # counter() — the earlier behavior.
        # Like ``_health`` this runs WITHOUT the engine lock:
        # every read is GIL-atomic and the tracer carries
        # its own lock, so a scrape answers promptly even while the
        # stepper is deep in a long compile.
        tracer = self.engine.tracer
        gauge = getattr(tracer, "gauge", tracer.counter)
        gauge("serving_gateway_queue_depth",
              self.engine.scheduler.pending)
        gauge("serving_gateway_active_slots",
              sum(s is not None for s in self.engine._slots))
        gauge("serving_gateway_round_time_s", self._round_s)
        for key, value in self.stats.items():
            gauge(f"serving_gateway_{key}", value)
        return tracer.prometheus_text()

    # -- KV transfer plane ----------------------------------------------
    def _handle_kv_export(self, handler, query: str) -> None:
        """``GET /v1/kv/export?tokens=1,2,3``: the longest cached
        prefix of the given prompt as a framed binary payload
        (serving/kv_transfer.py wire format). 404 when nothing
        reusable is cached (or the engine is not paged — the caller
        recomputes), 413 when the payload would exceed the transfer
        cap, 400 on a malformed query."""
        tokens: Optional[List[int]] = None
        for part in query.split("&"):
            if part.startswith("tokens="):
                try:
                    tokens = [int(t)
                              for t in part[len("tokens="):].split(",")
                              if t != ""]
                except ValueError:
                    tokens = None
        if not tokens:
            handler.send_json(
                {"error": "tokens=<comma-separated ids> required"},
                400, close=True)
            return
        self._kv_export_reply(handler, tokens)

    def _handle_kv_export_post(self, handler) -> None:
        """``POST /v1/kv/export`` with ``{"tokens": [...]}`` in the
        JSON body: same export as the GET form, without the GET
        query-string length ceiling (http.server caps the request
        line at 64 KiB, which clamps GET to ~8000 token ids)."""
        try:
            body = handler.read_json()
        except Exception:
            handler.send_json({"error": "malformed JSON body"}, 400,
                              close=True)
            return
        tokens = body.get("tokens") if isinstance(body, dict) else None
        if (not isinstance(tokens, list) or not tokens
                or not all(isinstance(t, int) for t in tokens)):
            handler.send_json(
                {"error": 'body must be {"tokens": [<ids>]} with a '
                          "non-empty integer list"}, 400, close=True)
            return
        self._kv_export_reply(handler, tokens)

    def _kv_export_reply(self, handler, tokens: List[int]) -> None:
        """Shared export body for the GET and POST forms: engine
        export under the transfer cap (under the lock, on the
        gateway's stream: the gather reads the pool), mapped to 200
        binary / 404 cold / 413 over-cap / 503 stopped."""
        with self._engine_access():
            # a DRAINING replica still exports: the drain-handback
            # receiver pulling the victim's warm prefix is exactly
            # the scale-down case the transfer plane exists for —
            # export is read-only, so it cannot delay the drain
            if self._stopped:
                handler.send_json({"error": "stopped"}, 503,
                                  close=True)
                return
            try:
                # the cap is enforced from block arithmetic BEFORE
                # any device gather
                payload = self.engine.export_kv(
                    tokens, cap_bytes=self.kv_transfer_cap_bytes)
            except KVTransferTooLarge as e:
                handler.send_json({"error": str(e)}, 413, close=True)
                return
        if payload is None:
            handler.send_json(
                {"error": "no cached prefix to export (cold, or "
                          "not a paged engine)"}, 404, close=True)
            return
        handler.send_binary(payload)

    def _handle_kv_import(self, handler) -> None:
        """``POST /v1/kv/import`` (binary body, content-length capped
        — util/httpjson ``read_binary``): splice a peer's exported
        prefix into this engine's pool + trie, under the lock and on
        the gateway's stream (the scatter writes the pool in place).
        200 with the import summary (``imported`` False = soft
        decline, stay cold), 400 on a malformed frame or geometry
        mismatch, 411 / 413 from ``read_binary``, 503 draining."""
        payload = handler.read_binary(self.kv_transfer_cap_bytes)
        if payload is None:
            return  # read_binary already answered 411/413/400
        with self._engine_access():
            if self._draining or self._stopped:
                handler.send_json({"error": "draining"}, 503,
                                  close=True)
                return
            try:
                out = self.engine.import_kv(payload)
            except KVTransferError as e:
                handler.send_json({"error": str(e)}, 400, close=True)
                return
            self._wake.notify_all()
        handler.send_json(out, 200, close=True)

    # -- boot-with-warmup handshake --------------------------
    #: warmup request cap per call: the handshake primes a cache, it
    #: is not a bulk-generation backdoor
    WARMUP_CAP = 64
    #: warmup generation-length clamp: one token is enough to drive
    #: the admission path (and the cache insert); a handful is the
    #: most a boot handshake could justify
    WARMUP_MAX_NEW_TOKENS = 8

    def warmup(self, prompts: List[List[int]],
               max_new_tokens: int = 1,
               timeout_s: float = 60.0) -> Dict[str, Any]:
        """Boot-with-warmup handshake: run each prompt through a
        short greedy generation so admission inserts its prefix into
        the engine's prefix cache BEFORE the router shifts any
        rendezvous keyspace here. A rolling upgrade's replacement
        replica calls this with the fleet's live affinity keys
        (``ServingRouter.live_affinity_prompts``), so the first real
        request for a moved key lands warm instead of paying a cold
        prefill. One generated token per prompt: enough to drive the
        full admission path (and the cache insert); cheap enough that
        a warmup cannot meaningfully delay the replica joining."""
        prompts = list(prompts)
        requested = len(prompts)
        prompts = prompts[:self.WARMUP_CAP]
        # the cap on generation length is what actually keeps warmup
        # from being a bulk-generation backdoor around /v1/generate's
        # admission accounting — the prompt-count cap alone would not
        max_new_tokens = min(max(int(max_new_tokens), 1),
                             self.WARMUP_MAX_NEW_TOKENS)
        # validate EVERY prompt before submitting ANY: a malformed
        # prompt mid-batch must reject the whole call, not leak the
        # already-submitted half into the engine with no consumer
        reqs = []
        for p in prompts:
            toks = [int(t) for t in p]
            bad = [t for t in toks
                   if not 0 <= t < self.engine.vocab]
            if bad:
                raise ValueError(
                    f"warmup prompt ids {bad[:4]} outside vocab "
                    f"[0, {self.engine.vocab})")
            # warmup is INFRASTRUCTURE traffic: it bills
            # the reserved system tenant — top priority, quota- and
            # rate-exempt — never a user quota, so a boot handshake
            # can neither starve behind a flooder's backlog nor eat
            # a user's slot entitlement
            req = Request(prompt=toks,
                          max_new_tokens=int(max_new_tokens),
                          tenant="system")
            self.engine.scheduler.validate(req)
            reqs.append(req)
        lives: List = []
        with self._engine_access():
            if self._draining or self._stopped:
                raise RuntimeError("gateway draining/stopped")
            reused_before = self.engine.stats[
                "prefill_tokens_skipped"]
            for req in reqs:
                if self.engine.scheduler.full:
                    # warmup primes a cache on a BOOTING replica; it
                    # must never shed real traffic off a full queue —
                    # whatever fits is warm enough
                    break
                rid = self.engine.submit(req)
                live = _Live()
                self._live[rid] = live
                lives.append((rid, live))
            if lives:
                self._wake.notify_all()
        deadline = time.monotonic() + timeout_s
        warmed = 0
        for rid, live in lives:
            live.done.wait(timeout=max(deadline - time.monotonic(),
                                       0.0))
            if live.result is not None:
                warmed += 1
            self._forget(rid)
        if self.engine.tracer is not None:
            self.engine.tracer.incr("serving_gateway_warmups",
                                    warmed)
        return {"warmed": warmed, "requested": requested,
                "submitted": len(lives),
                "prefix_tokens_reused":
                    self.engine.stats["prefill_tokens_skipped"]
                    - reused_before}

    def _handle_warmup(self, handler) -> None:
        """``POST /v1/warmup`` body ``{"prompts": [[tok, ...], ...],
        "max_new_tokens"?: n}`` — the HTTP face of :meth:`warmup`
        (503 while draining, 400 on a malformed body)."""
        try:
            body = handler.read_json()
            prompts = body["prompts"]
            if not isinstance(prompts, list) or not all(
                    isinstance(p, list) for p in prompts):
                raise ValueError("prompts must be a list of token "
                                 "lists")
            max_new = int(body.get("max_new_tokens", 1))
        except (ValueError, TypeError, KeyError, AttributeError,
                UnicodeDecodeError) as e:
            handler.send_json({"error": f"bad warmup body: {e}"},
                              400, close=True)
            return
        try:
            out = self.warmup(prompts, max_new_tokens=max_new)
        except RuntimeError as e:
            handler.send_json({"error": str(e)}, 503, close=True)
            return
        except (ValueError, TypeError) as e:
            # rejected prompt, or a token that int() cannot coerce
            # (e.g. a nested list): still a malformed body → 400
            handler.send_json({"error": str(e)}, 400, close=True)
            return
        handler.send_json(out, 200, close=True)

    # -- drain / snapshot ----------------------------------------------
    def drain(self, timeout_s: Optional[float] = None
              ) -> Dict[str, Any]:
        """Graceful-shutdown phase 1: stop admitting (new generates get
        503), let the stepping loop settle in-flight work for up to
        ``timeout_s`` seconds (None = until idle), then PAUSE stepping
        and persist ``engine.snapshot()`` to ``snapshot_path`` (when
        configured). Whatever had not finished inside the budget is in
        the snapshot — :meth:`boot` on the next process finishes those
        very ids. Returns a summary: requests finished here, requests
        carried in the snapshot, the snapshot path.

        IDEMPOTENT: a second drain — concurrent
        (a fleet controller racing an operator) or later — returns
        the FIRST drain's summary, ``carried_ids`` included, instead
        of re-running the settle loop against a paused engine."""
        with self._drain_lock:
            first = not self._drain_started
            self._drain_started = True
            # capture the latch under the SAME lock: the failure path
            # swaps in a fresh Event, and a waiter that saw
            # drain_started must wait on the event that failure path
            # will set, not the replacement
            done = self._drain_done
        if not first:
            done.wait(timeout=600.0)
            if self._drain_summary is not None:
                return dict(self._drain_summary)
            with self._drain_lock:
                owner_failed = not self._drain_started
            if owner_failed:
                # the owning drain raised and released the latch: a
                # success-shaped in_progress dict would make the
                # caller (a controller about to reap the process)
                # believe the drain happened — retry as the new owner
                return self.drain(timeout_s)
            return {"drained": False, "carried": None,
                    "carried_ids": None, "snapshot": None,
                    "in_progress": True}
        try:
            return self._drain_owner(timeout_s)
        except BaseException:
            # a failed drain must stay retryable: release the latch
            # (waiters wake with no summary) and hand the NEXT drain
            # a fresh one, instead of wedging every later drain
            # behind a summary that will never land
            with self._drain_lock:
                self._drain_started = False
                done, self._drain_done = (self._drain_done,
                                          threading.Event())
            done.set()
            raise

    def _drain_owner(self, timeout_s: Optional[float]
                     ) -> Dict[str, Any]:
        with self._engine_access():
            self._draining = True
        t0 = time.monotonic()
        while True:
            with self._engine_access():
                idle = not self.engine.has_work()
            if idle:
                break
            if (timeout_s is not None
                    and time.monotonic() - t0 > timeout_s):
                break
            time.sleep(0.005)
        with self._engine_access():
            self._paused = True
            eng = self.engine
            # the drain HANDOFF surface: which request ids
            # ride the snapshot instead of finishing here — a router
            # scaling this replica down replays exactly these onto a
            # survivor (and cross-checks its journal against the list)
            carried_ids = sorted(
                [r.id for r in eng.scheduler.queued_requests()]
                + [p.request.id for p in eng._pending]
                + [q.id for _, q in eng._requeue]
                + [s.request.id for s in eng._slots
                   if s is not None])
            carried = len(carried_ids)
            snap_path = None
            if self.snapshot_path is not None:
                snap = self.engine.snapshot()
                tmp = self.snapshot_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(snap, f)
                os.replace(tmp, self.snapshot_path)
                snap_path = self.snapshot_path
            # carried requests will finish in the NEXT process — their
            # still-connected handlers must not ping/spin until this
            # one exits: end their streams (no terminal event) and
            # release their blocking waits (result None → 503)
            for live in self._live.values():
                if live.result is None:
                    live.events.put(None)
                    live.done.set()
        if self.engine.tracer is not None:
            self.engine.tracer.incr("serving_gateway_drained")
        summary = {
            "drained": carried == 0, "carried": carried,
            "carried_ids": carried_ids,
            "snapshot": snap_path,
            "finished": self.engine.stats["requests_finished"]}
        self._drain_summary = summary
        self._drain_done.set()
        return dict(summary)

    def _handle_drain(self, handler) -> None:
        try:
            body = handler.read_json()
            timeout = body.get("timeout_s")
            timeout = None if timeout is None else float(timeout)
        except (ValueError, UnicodeDecodeError, AttributeError) as e:
            handler.send_json({"error": f"bad drain body: {e}"}, 400,
                              close=True)
            return
        summary = self.drain(timeout)
        handler.send_json(summary, 200, close=True)
