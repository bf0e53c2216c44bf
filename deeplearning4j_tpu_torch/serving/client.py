"""Stdlib client for the serving gateway (serving/gateway.py).

A copy of ``deeplearning4j_tpu/serving/client.py`` with imports
rewritten: it speaks to either package's gateway. Against the port's
gateway ``kv_export`` and ``kv_import`` raise :class:`GatewayError`
with status 501 (KV transfer is not ported yet).

``GatewayClient`` speaks the gateway's endpoints over plain
``http.client`` — no dependencies, so the same class serves tests, the
soak harness (scripts/gateway_soak.py), benches, examples, and the
multi-replica router (serving/router.py). The streaming call returns a
:class:`GatewayStream`: an iterator of per-delta token lists that
exposes the request id immediately (so the caller can cancel
mid-stream) and the full terminal result after exhaustion. Closing the
stream early — or just dropping the connection — is the
disconnect-cancel path: the gateway notices the dead socket and frees
the request's slot.

Failure-tolerance knobs (the router needs them and
so does any bare client talking to a replica that might die):

- ``connect_timeout_s`` bounds the TCP connect separately from reads —
  a DEAD host (SYN black hole) fails in bounded time instead of
  hanging the caller on the socket default;
- ``read_timeout_s`` bounds each blocking read once connected — a
  replica that accepted the request and then froze surfaces as
  ``socket.timeout`` instead of a forever-stalled caller;
- ``retries`` + ``backoff_s`` add bounded, jittered-backoff retry on
  connection-refused/reset — but ONLY for the idempotent GETs
  (``healthz``/``metrics``/``poll``/``trace``): a generate POST is
  never retried here, because blind resubmission could double-run a
  request (that replay discipline lives in the router's journal,
  where dedup is possible).
"""

from __future__ import annotations

import http.client
import json
import random
import socket
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from deeplearning4j_tpu_torch.util.httpjson import TRACE_HEADER

#: connection-level failures worth a retry for idempotent calls: the
#: peer was unreachable or vanished BEFORE a full response arrived.
#: (socket.timeout subclasses OSError; HTTPException covers a peer
#: that accepted then died mid-exchange — BadStatusLine and
#: RemoteDisconnected at the handshake, IncompleteRead when a
#: Content-Length body is cut short by a SIGKILL.)
RETRYABLE_ERRORS = (ConnectionRefusedError, ConnectionResetError,
                    ConnectionAbortedError, BrokenPipeError,
                    socket.timeout, http.client.HTTPException,
                    OSError)


class GatewayError(RuntimeError):
    """Non-2xx gateway reply. ``status`` is the HTTP code;
    ``payload`` the decoded JSON body (when there was one);
    ``retry_after_s`` the Retry-After hint on 429s (None
    otherwise)."""

    def __init__(self, status: int, payload: Dict[str, Any],
                 retry_after_s: Optional[int] = None):
        super().__init__(f"gateway returned {status}: {payload}")
        self.status = status
        self.payload = payload
        self.retry_after_s = retry_after_s


def _split(address: str):
    address = address.split("://", 1)[-1]
    host, _, port = address.partition(":")
    return host, int(port or 80)


class GatewayStream:
    """One live SSE generation stream. Iterate for per-delta token
    lists; after iteration ends, ``result`` holds the terminal dict
    (tokens, finish_reason, status, ...). ``close()`` abandons the
    stream — the server cancels the request when it notices."""

    def __init__(self, conn: http.client.HTTPConnection, resp):
        self._conn = conn
        self._resp = resp
        self.id: Optional[int] = None
        self.result: Optional[Dict[str, Any]] = None
        #: the server's last SSE ``id:`` field: the
        #: serving streams use the cumulative delivered-token count,
        #: so after a connection drop this is exactly the
        #: ``Last-Event-ID`` to resume from. Committed only when the
        #: event's DATA arrives (the SSE dispatch rule) — an ``id:``
        #: line whose event was torn off by the disconnect must not
        #: advance the cursor past tokens never received.
        self.last_event_id: Optional[int] = None
        self._pending_event_id: Optional[int] = None
        self._read_head()

    def _read_head(self) -> None:
        # the gateway's first event carries the request id before any
        # token exists, so cancellation needs no token to have flowed
        first = self._next_event()
        if first is not None:
            self.id = first.get("id")
            if first.get("done"):
                self.result = first

    def _read_frame(self) -> Tuple[str, Optional[Dict[str, Any]]]:
        """Lowest-level SSE read: one ``("event", dict)``,
        ``("ping", None)`` keep-alive comment, or ``("eof", None)``
        when the stream/connection ended."""
        data_lines: List[bytes] = []
        while True:
            line = self._resp.readline()
            if not line:  # connection/stream ended
                return "eof", None
            line = line.rstrip(b"\r\n")
            if not line:  # blank line = event boundary
                if data_lines:
                    if self._pending_event_id is not None:
                        # SSE dispatch rule: the id commits WITH its
                        # event, never before its data landed
                        self.last_event_id = self._pending_event_id
                        self._pending_event_id = None
                    return "event", json.loads(b"".join(data_lines))
                continue  # boundary after a comment ping
            if line.startswith(b":"):
                return "ping", None  # keep-alive comment
            if line.startswith(b"id:"):
                # SSE event id: token-position cursor for
                # Last-Event-ID resumption; staged until the event's
                # data line(s) complete the frame
                try:
                    self._pending_event_id = int(line[3:].strip())
                except ValueError:
                    pass
                continue
            if line.startswith(b"data:"):
                data_lines.append(line[5:].strip())

    def _next_event(self) -> Optional[Dict[str, Any]]:
        """Next ``data:`` event (comment pings skipped), or None at
        end of stream."""
        while True:
            kind, event = self._read_frame()
            if kind == "eof":
                return None
            if kind == "event":
                return event

    def raw_events(self) -> Iterator[Tuple[str,
                                           Optional[Dict[str, Any]]]]:
        """Relay-mode iterator (the router's view of a replica
        stream): yields ``("ping", None)`` for every keep-alive the
        server sends — so a proxy can forward liveness to ITS client —
        and ``("event", dict)`` for data events, ending at stream end.
        A stream that ends without a ``done`` event means the server
        died or drained mid-request; the CALLER decides what that
        means (the router replays, a bare client raises)."""
        if self.result is not None:
            yield "event", self.result
            return
        while True:
            kind, event = self._read_frame()
            if kind == "eof":
                return
            yield kind, event
            if kind == "event" and event.get("done"):
                self.result = event
                return

    def __iter__(self) -> Iterator[List[int]]:
        if self.result is not None:
            return
        while True:
            event = self._next_event()
            if event is None:
                raise GatewayError(
                    0, {"error": "stream ended without terminal "
                                 f"event (request {self.id})"})
            if event.get("done"):
                self.result = event
                self.close()
                return
            tokens = event.get("tokens")
            if tokens is not None:
                yield [int(t) for t in tokens]

    def close(self) -> None:
        # close the RESPONSE too: its ``makefile`` holds a reference
        # to the socket fd, so ``conn.close()`` alone would never send
        # FIN and the server would keep streaming into the void
        # instead of noticing the disconnect
        try:
            self._resp.close()
        except OSError:
            pass
        try:
            self._conn.close()
        except OSError:
            pass


class GatewayClient:
    """Blocking + streaming client for one gateway address.

    Every call opens its own connection (the gateway closes one-shot
    responses anyway — util/httpjson ``Connection: close``), so one
    client instance is safe to share across threads.

    ``timeout_s`` is the legacy single knob (connect AND read);
    ``connect_timeout_s``/``read_timeout_s`` override it separately.
    ``retries > 0`` retries the idempotent GET endpoints on
    connection-level failures with jittered exponential backoff
    (``backoff_s * 2^attempt``, capped at ``backoff_cap_s``, each
    sleep scaled by a uniform [0.5, 1.0) jitter so a fleet of callers
    does not reconverge on the dead peer in lockstep)."""

    def __init__(self, address: str, timeout_s: float = 60.0,
                 connect_timeout_s: Optional[float] = None,
                 read_timeout_s: Optional[float] = None,
                 retries: int = 0, backoff_s: float = 0.05,
                 backoff_cap_s: float = 2.0):
        self.host, self.port = _split(address)
        self.timeout_s = timeout_s
        self.connect_timeout_s = (timeout_s if connect_timeout_s is None
                                  else float(connect_timeout_s))
        self.read_timeout_s = (timeout_s if read_timeout_s is None
                               else float(read_timeout_s))
        if retries < 0:
            raise ValueError(f"retries {retries} < 0")
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._rng = random.Random()

    # -- plumbing ------------------------------------------------------
    def _connect(self) -> http.client.HTTPConnection:
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.connect_timeout_s)
        conn.connect()
        # once connected, every blocking read (status line, body,
        # stream deltas) is bounded by the READ timeout instead
        conn.sock.settimeout(self.read_timeout_s)
        return conn

    def _with_retry(self, fn):
        """Run ``fn`` (an IDEMPOTENT call), retrying connection-level
        failures up to ``self.retries`` times with jittered backoff.
        GatewayError (a real HTTP reply) is never retried here — the
        peer is alive and said no."""
        attempt = 0
        while True:
            try:
                return fn()
            except GatewayError:
                raise
            except RETRYABLE_ERRORS:
                if attempt >= self.retries:
                    raise
                delay = min(self.backoff_s * (2 ** attempt),
                            self.backoff_cap_s)
                time.sleep(delay * (0.5 + self._rng.random() / 2))
                attempt += 1

    def _call(self, method: str, path: str,
              body: Optional[Dict[str, Any]] = None,
              ok=(200,),
              headers: Optional[Dict[str, str]] = None
              ) -> Dict[str, Any]:
        conn = self._connect()
        try:
            payload = (None if body is None
                       else json.dumps(body).encode())
            if headers is None:
                headers = ({"Content-Type": "application/json"}
                           if payload is not None else {})
            conn.request(method, path, body=payload, headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
            data = json.loads(raw) if raw else {}
            if resp.status not in ok:
                retry = resp.getheader("Retry-After")
                raise GatewayError(
                    resp.status, data,
                    retry_after_s=(int(retry) if retry else None))
            return data
        finally:
            conn.close()

    # -- endpoints -----------------------------------------------------
    @staticmethod
    def _generate_body(prompt: List[int], max_new_tokens: int,
                       kwargs: Dict[str, Any]
                       ) -> Tuple[Dict[str, Any], Dict[str, str]]:
        """(body, extra headers) for one generate call. A ``trace=``
        kwarg (the fleet trace context) rides BOTH carriers:
        the ``X-DL4J-Trace`` header (the Dapper-style wire position a
        sidecar proxy can read without parsing bodies) and the JSON
        ``trace`` field (which survives body-level relays).
        ``tenant=`` / ``priority=`` ride the body to a
        tenancy-enabled gateway/router: the tenant's quotas, rate
        limits, and priority class then govern the request — a 429
        carries that tenant's OWN ``Retry-After`` and names the
        tenant in the payload."""
        body = dict(prompt=list(prompt),
                    max_new_tokens=int(max_new_tokens), **kwargs)
        headers = {"Content-Type": "application/json"}
        if body.get("trace") is not None:
            body["trace"] = str(body["trace"])
            headers[TRACE_HEADER] = body["trace"]
        return body, headers

    def generate(self, prompt: Optional[List[int]] = None,
                 max_new_tokens: int = 16,
                 resume: Optional[int] = None,
                 last_event_id: int = 0,
                 **kwargs: Any) -> Dict[str, Any]:
        """Blocking generation. Returns the terminal result dict on
        any 2xx; raises :class:`GatewayError` carrying the mapped
        failure status (429 shed, 504 deadline, 500 fault) — partial
        tokens, when the engine produced any, ride
        ``err.payload["tokens"]``. NEVER retried on connection
        failure: resubmitting a generate is a replay decision the
        caller must make (see serving/router.py for the journaled
        version). ``trace=`` attaches a fleet trace context.

        ``resume=<request_id>`` re-attaches to an
        EXISTING request instead of submitting a new one — follow
        its journaled stream from ``last_event_id`` (a token
        position) to the terminal and return the terminal dict,
        whose ``tokens`` is always the complete list. The blocking
        way back after a dropped connection or a router restart;
        ``resumable=True`` on the original call keeps a router-side
        stream alive across client disconnects."""
        if resume is not None:
            s = self.resume(resume, last_event_id=last_event_id)
            try:
                for _ in s:
                    pass
            finally:
                s.close()
            if s.result is None:
                raise GatewayError(
                    0, {"error": "resumed stream ended without a "
                                 f"terminal (request {resume})"})
            return s.result
        body, headers = self._generate_body(prompt, max_new_tokens,
                                            kwargs)
        return self._call("POST", "/v1/generate", body,
                          headers=headers)

    def stream(self, prompt: List[int], max_new_tokens: int,
               **kwargs: Any) -> GatewayStream:
        """Start a streaming generation; returns the live
        :class:`GatewayStream` (its ``id`` is already populated).
        ``trace=`` attaches a fleet trace context."""
        body, headers = self._generate_body(prompt, max_new_tokens,
                                            kwargs)
        conn = self._connect()
        conn.request("POST", "/v1/generate?stream=1",
                     body=json.dumps(body).encode(),
                     headers=headers)
        resp = conn.getresponse()
        if resp.status != 200:
            raw = resp.read()
            conn.close()
            data = json.loads(raw) if raw else {}
            retry = resp.getheader("Retry-After")
            raise GatewayError(
                resp.status, data,
                retry_after_s=(int(retry) if retry else None))
        return GatewayStream(conn, resp)

    def resume(self, request_id: int,
               last_event_id: int = 0) -> GatewayStream:
        """``GET /v1/requests/<id>/stream`` with ``Last-Event-ID``: reconnect to a journaled stream and resume at an
        exact token position — everything past ``last_event_id``
        replays first (journal breadcrumbs), then the stream follows
        live progress (failover replay, router-restart recovery) to
        the terminal. Event ids keep counting delivered tokens, so a
        resume can itself be resumed. Raises :class:`GatewayError`
        on 404 (unknown/evicted id) and 202 (the server has no
        followable stream state — poll for the terminal instead)."""
        conn = self._connect()
        try:
            conn.request(
                "GET", f"/v1/requests/{int(request_id)}/stream",
                headers={"Last-Event-ID": str(int(last_event_id))})
            resp = conn.getresponse()
        except BaseException:
            conn.close()
            raise
        if resp.status != 200:
            raw = resp.read()
            conn.close()
            data = json.loads(raw) if raw else {}
            raise GatewayError(resp.status, data)
        return GatewayStream(conn, resp)

    def cancel(self, request_id: int) -> Dict[str, Any]:
        return self._call("DELETE", f"/v1/requests/{request_id}",
                          ok=(200, 404))

    def poll(self, request_id: int) -> Dict[str, Any]:
        """Result by id: terminal dict (done), ``{"running": true}``
        while in flight, raises 404 for unknown ids. Idempotent —
        retried per the client's retry policy."""
        return self._with_retry(lambda: self._call(
            "GET", f"/v1/requests/{request_id}", ok=(200, 202)))

    def trace(self, request_id: int) -> Dict[str, Any]:
        """Flight-recorder trace for one terminal request:
        ``{"id", "finish_reason", "timing": {...phase breakdown...},
        "attempts": [{"events": [...]}, ...]}``; ``{"running": true}``
        while in flight; raises 404 once evicted/unknown."""
        return self._with_retry(lambda: self._call(
            "GET", f"/v1/requests/{request_id}/trace", ok=(200, 202)))

    def trace_events(self,
                     since_seq: Optional[int] = None
                     ) -> Dict[str, Any]:
        """``GET /v1/trace`` — the server tracer's current event
        window as a Chrome trace-event document
        (``{"traceEvents": [...]}``), ready to save and load into
        Perfetto/chrome://tracing. ``since_seq`` requests the
        INCREMENTAL delta: only events at absolute tracer
        sequence >= it, plus a ``nextSeq`` cursor to resume from —
        what the router's periodic trace-cache scrape rides."""
        path = ("/v1/trace" if since_seq is None
                else f"/v1/trace?since_seq={int(since_seq)}")
        return self._call("GET", path)

    def healthz(self) -> Dict[str, Any]:
        return self._with_retry(
            lambda: self._call("GET", "/v1/healthz"))

    def _get_text(self, path: str) -> str:
        """Idempotent text GET (retried per the client's policy) —
        the metrics-scrape shape, shared by the gateway's
        ``/v1/metrics`` and the router's ``/v1/fleet/metrics``."""
        def once() -> str:
            conn = self._connect()
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                body = resp.read().decode()
                if resp.status != 200:
                    raise GatewayError(resp.status, {"body": body})
                return body
            finally:
                conn.close()

        return self._with_retry(once)

    def metrics(self) -> str:
        return self._get_text("/v1/metrics")

    # -- KV transfer plane ----------------------------------
    #: GET query-string token cap: http.server rejects request lines
    #: over 64 KiB with 414. Prompts past the cap now ship via
    #: ``POST /v1/kv/export`` (token list in the JSON body — no
    #: request-line limit;); against a pre-POST
    #: server the 404/405 falls back to a truncated GET, which is
    #: SAFE: any cached prefix of a truncated prompt is a cached
    #: prefix of the full prompt (the radix-trie prefix property),
    #: and real exports are window-bounded far below this anyway
    KV_EXPORT_QUERY_TOKENS = 8000

    def kv_export(self, tokens: List[int]) -> Optional[bytes]:
        """The replica's longest cached prefix of ``tokens`` as a
        framed binary payload (serving/kv_transfer.py wire format),
        or ``None`` on 404 (nothing cached / not a paged engine — the
        soft miss the router's recompute fallback absorbs). Other
        non-200s raise. Short prompts use the original
        ``GET /v1/kv/export?tokens=...``; prompts past
        :data:`KV_EXPORT_QUERY_TOKENS` use the POST JSON-body form,
        falling back to a truncated GET when the server predates it
        (see the cap's note)."""
        if len(tokens) > self.KV_EXPORT_QUERY_TOKENS:
            try:
                return self._kv_export_post(tokens)
            except GatewayError as e:
                if e.status not in (404, 405):
                    raise
                # 405 = pre-POST server; 404 from such a server is
                # ambiguous (missing route vs cold) — the truncated
                # GET below disambiguates at the cost of one
                # round-trip on genuinely cold long prompts
        path = ("/v1/kv/export?tokens="
                + ",".join(str(int(t)) for t
                           in tokens[:self.KV_EXPORT_QUERY_TOKENS]))
        conn = self._connect()
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status == 404:
                return None
            if resp.status != 200:
                try:
                    data = json.loads(raw) if raw else {}
                except ValueError:
                    data = {"body": raw[:256].decode("latin-1")}
                raise GatewayError(resp.status, data)
            return raw
        finally:
            conn.close()

    def _kv_export_post(self, tokens: List[int]) -> bytes:
        """``POST /v1/kv/export`` with ``{"tokens": [...]}`` — the
        full token list rides the body, so nothing is truncated.
        Raises :class:`GatewayError` on every non-200 (404 included:
        the caller maps it to the truncated-GET fallback)."""
        body = json.dumps(
            {"tokens": [int(t) for t in tokens]}).encode()
        conn = self._connect()
        try:
            conn.request(
                "POST", "/v1/kv/export", body=body,
                headers={"Content-Type": "application/json",
                         "Content-Length": str(len(body))})
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status != 200:
                try:
                    data = json.loads(raw) if raw else {}
                except ValueError:
                    data = {"body": raw[:256].decode("latin-1")}
                raise GatewayError(resp.status, data)
            return raw
        finally:
            conn.close()

    def kv_import(self, payload: bytes) -> Dict[str, Any]:
        """``POST /v1/kv/import`` (raw binary body) — splice a peer's
        exported prefix into this replica's pool + trie. Returns the
        import summary (``imported`` False = soft decline); raises
        :class:`GatewayError` on 400/413/503."""
        conn = self._connect()
        try:
            conn.request(
                "POST", "/v1/kv/import", body=payload,
                headers={"Content-Type": "application/octet-stream",
                         "Content-Length": str(len(payload))})
            resp = conn.getresponse()
            raw = resp.read()
            data = json.loads(raw) if raw else {}
            if resp.status != 200:
                raise GatewayError(resp.status, data)
            return data
        finally:
            conn.close()

    def drain(self, timeout_s: Optional[float] = None
              ) -> Dict[str, Any]:
        body = {} if timeout_s is None else {"timeout_s": timeout_s}
        return self._call("POST", "/v1/drain", body)

    def warmup(self, prompts: List[List[int]],
               max_new_tokens: int = 1) -> Dict[str, Any]:
        """``POST /v1/warmup``: the boot-with-warmup
        handshake — prime a booting replica's prefix cache with the
        fleet's live affinity keys before the router shifts any
        rendezvous keyspace onto it. Returns ``{"warmed", "requested",
        "prefix_tokens_reused"}``."""
        return self._call("POST", "/v1/warmup", {
            "prompts": [[int(t) for t in p] for p in prompts],
            "max_new_tokens": int(max_new_tokens)})
