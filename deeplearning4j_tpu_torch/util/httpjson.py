"""Shared JSON-over-HTTP scaffolding for control-plane services.

A copy of ``deeplearning4j_tpu/util/httpjson.py`` (standard library
only), the base of the serving gateway (serving/gateway.py): a silenced
BaseHTTPRequestHandler with JSON helpers, chunked-transfer streaming,
and a threaded server lifecycle wrapper. Handlers must compute their
response payload first (holding any state lock) and only then call
``send_json`` — never write the socket while holding a lock, or one
slow-reading client stalls every other request (including heartbeats).

Connection lifetime is BOUNDED: every handler
carries a socket ``timeout`` (class attribute, overridable per service
via ``HttpService(..., timeout=...)``), so a half-open client that
connects and never sends a request — or stops reading mid-response —
cannot pin a ``ThreadingHTTPServer`` thread forever: the blocked read
times out, ``BaseHTTPRequestHandler`` flags ``close_connection``, and
the thread exits. One-shot responses can additionally advertise
``Connection: close`` (``send_json(..., close=True)``) so well-behaved
clients don't hold keep-alive sockets the service will never reuse.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

#: Dapper-style trace-context carrier: the router mints
#: ``<trace_id>/<span_id>`` per request attempt and every hop
#: (router → gateway → engine) forwards it, so one fleet-level id
#: stitches a request's spans across processes. One definition here —
#: the client sends it, every JSON service reads it — so the wire
#: name can never drift between the two sides.
TRACE_HEADER = "X-DL4J-Trace"


class JsonHandler(BaseHTTPRequestHandler):
    """Request handler base: JSON body parsing + JSON/bytes replies +
    chunked-transfer streaming (``start_stream``/``send_chunk``/
    ``end_stream`` — requires ``protocol_version = "HTTP/1.1"`` on the
    subclass; under HTTP/1.0 the stream falls back to
    read-until-close framing)."""

    #: per-connection socket timeout in seconds (socketserver applies
    #: it in ``setup()``): bounds how long a stalled or vanished client
    #: can hold a server thread between reads. None = unbounded (the
    #: earlier behavior; no service uses it).
    timeout: Optional[float] = 30.0

    def log_message(self, fmt: str, *args: Any) -> None:  # silence
        pass

    def trace_context(self) -> Optional[str]:
        """The request's :data:`TRACE_HEADER` value (None when the
        caller sent no trace context). Bounded: a hostile header
        cannot grow server-side bookkeeping past 256 chars."""
        value = self.headers.get(TRACE_HEADER)
        if value is None:
            return None
        value = value.strip()
        return value[:256] or None

    def read_json(self) -> Dict[str, Any]:
        n = int(self.headers.get("Content-Length", 0))
        if n == 0:
            return {}
        return json.loads(self.rfile.read(n))

    # -- bounded binary request/response ----------
    def read_binary(self, max_bytes: int) -> Optional[bytes]:
        """Read a raw (non-JSON) request body with a HARD size cap —
        the KV-transfer import endpoint rides this. The cap is checked
        against ``Content-Length`` BEFORE any byte is read, so an
        oversized payload answers **413** without ever buffering (no
        base64 round-trip, no OOM from a hostile length); a missing
        length answers **411** (chunked uploads are not accepted — the
        cap must be checkable up front). Returns the body, or ``None``
        when a rejection was already sent (the caller just returns).
        A body shorter than its declared length (peer died mid-send)
        answers **400**."""
        length = self.headers.get("Content-Length")
        if length is None:
            self.send_json({"error": "Content-Length required for "
                                     "binary uploads"}, 411,
                           close=True)
            return None
        try:
            n = int(length)
        except ValueError:
            self.send_json({"error": f"bad Content-Length "
                                     f"{length!r}"}, 400, close=True)
            return None
        if n < 0 or n > max_bytes:
            self.send_json(
                {"error": f"payload {n} bytes exceeds the "
                          f"{max_bytes}-byte cap", "max_bytes":
                 int(max_bytes)}, 413, close=True)
            return None
        body = self.rfile.read(n)
        if len(body) != n:
            self.send_json(
                {"error": f"truncated body: {len(body)} of {n} "
                          "declared bytes arrived"}, 400, close=True)
            return None
        return body

    def send_binary(self, body: bytes, code: int = 200) -> None:
        """Raw-bytes response (``application/octet-stream``) — the
        export half of the bounded binary path. One-shot by design
        (``Connection: close``): a transfer payload is fetched once,
        never pipelined."""
        self.send_bytes(body, "application/octet-stream", code,
                        close=True)

    def send_json(self, obj: Dict[str, Any], code: int = 200,
                  close: bool = False,
                  headers: Tuple[Tuple[str, str], ...] = ()) -> None:
        self.send_bytes(json.dumps(obj).encode(), "application/json",
                        code, close=close, headers=headers)

    def send_bytes(self, body: bytes, content_type: str,
                   code: int = 200, close: bool = False,
                   headers: Tuple[Tuple[str, str], ...] = ()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for name, value in headers:
            self.send_header(name, str(value))
        if close:
            # explicit is kinder than implicit: the client learns the
            # socket is one-shot instead of discovering it at EOF
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        self.wfile.write(body)

    # -- incremental (chunked-transfer) responses ----------------------
    def start_stream(self, content_type: str = "text/event-stream",
                     code: int = 200,
                     headers: Tuple[Tuple[str, str], ...] = ()) -> None:
        """Open an incremental response: headers go out now, the body
        arrives in ``send_chunk`` pieces, ``end_stream`` terminates it.
        When BOTH sides speak HTTP/1.1 the body is
        chunked-transfer-encoded (each piece is a delimited chunk a
        client can act on as it lands); for an HTTP/1.0 peer — where
        chunked framing does not exist and RFC 7230 forbids sending
        it — the pieces stream raw and end-of-body is the connection
        closing."""
        self._stream_chunked = (self.protocol_version >= "HTTP/1.1"
                                and self.request_version >= "HTTP/1.1")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Cache-Control", "no-cache")
        for name, value in headers:
            self.send_header(name, str(value))
        if self._stream_chunked:
            self.send_header("Transfer-Encoding", "chunked")
        else:
            self.send_header("Connection", "close")
        # a stream monopolizes its connection until it ends; never
        # leave it open for a pipelined follow-up request
        self.close_connection = True
        self.end_headers()

    def send_chunk(self, data: bytes) -> None:
        if not data:
            return  # a zero-length chunk would terminate the stream
        if self._stream_chunked:
            self.wfile.write(b"%X\r\n" % len(data) + data + b"\r\n")
        else:
            self.wfile.write(data)
        self.wfile.flush()

    def end_stream(self) -> None:
        if self._stream_chunked:
            self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    def send_trace_events(self, events, next_seq=None) -> None:
        """Stream a Chrome trace-event document in 512-event chunks
        (one wire format for every trace export: the gateway's
        ``/v1/trace`` and the router's stitched fleet variant must
        never drift). A large window never materializes as one giant
        bytes object; ``next_seq`` prefixes the incremental-scrape
        cursor. A vanished client is swallowed — there is
        nothing to release on a read-only export."""
        try:
            self.start_stream("application/json")
            if next_seq is not None:
                self.send_chunk(b'{"nextSeq":%d,"traceEvents":['
                                % int(next_seq))
            else:
                self.send_chunk(b'{"traceEvents":[')
            for lo in range(0, len(events), 512):
                piece = ",".join(json.dumps(e)
                                 for e in events[lo:lo + 512])
                if lo:
                    piece = "," + piece
                self.send_chunk(piece.encode())
            self.send_chunk(b"]}")
            self.end_stream()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass

    # -- SSE framing (one definition for every streaming service:
    # the gateway and the router must never drift on the wire format)
    def send_event(self, obj: Dict[str, Any],
                   event_id: Optional[int] = None) -> None:
        """One SSE data event. ``event_id`` rides as the
        standard ``id:`` field — the serving streams use the
        cumulative delivered-token count, so a client that
        reconnects with ``Last-Event-ID: N`` resumes at exactly
        token N: monotone, gap-free, duplicate-free by the SSE
        contract itself."""
        frame = b""
        if event_id is not None:
            frame += b"id: %d\n" % int(event_id)
        self.send_chunk(frame + b"data: "
                        + json.dumps(obj).encode() + b"\n\n")

    def send_ping(self) -> None:
        # SSE comment line: ignored by clients, but the write probes
        # whether the peer is still there (a vanished client surfaces
        # as a send error)
        self.send_chunk(b": ping\n\n")

    def read_resume_cursor(self, path: str, query: str
                           ) -> Optional[Tuple[int, int]]:
        """Parse a ``GET /v1/requests/<rid>/stream`` resume request
        into ``(rid, cursor)`` — the cursor from ``Last-Event-ID``
        (the SSE-standard reconnect carrier) or the ``?from=``
        query fallback, defaulting to 0. ONE definition:
        the request-side twin of :meth:`send_event`'s ``id:``
        framing, shared by the gateway's and the router's resume
        endpoints so the two cannot drift. Sends the **400** itself
        and returns ``None`` on a malformed id/cursor — the caller
        just returns."""
        tail = path[len("/v1/requests/"):-len("/stream")]
        try:
            rid = int(tail)
        except ValueError:
            self.send_json({"error": f"bad request id {tail!r}"},
                           400, close=True)
            return None
        last_id = self.headers.get("Last-Event-ID")
        if last_id is None:
            for part in query.split("&"):
                if part.startswith("from="):
                    last_id = part[len("from="):]
        try:
            cursor = int(last_id) if last_id is not None else 0
        except ValueError:
            self.send_json(
                {"error": f"bad Last-Event-ID {last_id!r}"}, 400,
                close=True)
            return None
        if cursor < 0:
            self.send_json(
                {"error": f"negative resume cursor {cursor}"}, 400,
                close=True)
            return None
        return rid, cursor

    def follow_stream(
            self, rid: int, cursor: int,
            poll: Callable[[], Tuple[List[int], bool,
                                     Optional[Dict[str, Any]]]],
            wait: Callable[[float], Any],
            keepalive_s: float) -> None:
        """The response half of a stream resume, shared by
        the gateway's and the router's endpoints so the cursor math,
        event-id monotonicity, and keepalive cadence cannot drift —
        the body-side twin of :meth:`read_resume_cursor`.

        ``poll(cursor) -> (tail, total, done, terminal)``: the
        delivered tokens PAST the cursor (never the whole list — a
        long stream's follower must not copy O(n) per tick), the
        total delivered count, whether the request is finished, and
        the terminal dict to emit (None = end WITHOUT a terminal:
        the underlying request was dropped or the server stopped).
        ``wait(timeout_s)`` blocks until progress may have happened
        (typically the entry's done-Event wait). Emits the head event
        at ``cursor``, replays/follows everything past it — each
        event's ``id:`` is the cumulative token count, so a resumed
        stream is itself resumable — pings at ``keepalive_s`` cadence
        while idle (waking on a shorter quantum so followed tokens
        flow per-delta), and finishes with the terminal. The usual
        OSError family propagates when the consumer vanishes; the
        caller decides what that means."""
        self.start_stream("text/event-stream")
        self.send_event({"id": rid, "resumed": True,
                         "from": cursor}, event_id=cursor)
        last_ping = time.monotonic()
        quantum = min(keepalive_s, 0.05)
        while True:
            tail, total, done, terminal = poll(cursor)
            if tail:
                # a cursor AHEAD of the tokens (the client saw
                # tokens a crash window lost) yields an empty tail
                # and waits below: deterministic replay regrows the
                # list past it
                self.send_event({"id": rid, "tokens": tail},
                                event_id=cursor + len(tail))
                cursor += len(tail)
                continue
            if done:
                if terminal is not None:
                    out = dict(terminal)
                    out["done"] = True
                    self.send_event(out, event_id=total)
                self.end_stream()
                return
            now = time.monotonic()
            if now - last_ping >= keepalive_s:
                self.send_ping()
                last_ping = now
            wait(quantum)


class _QuietThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that treats a vanished peer as routine.

    The stock ``handle_error`` dumps a full traceback to stderr for
    EVERY connection-level failure — but a client that disconnects
    mid-response (health scraper timing out, streaming consumer
    closing early, a killed process's half-open socket) is normal
    operation for a long-lived service, not an error worth a dump.
    Handler-code bugs still print."""

    def handle_error(self, request, client_address):  # noqa: N802
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError,
                            ConnectionAbortedError, socket.timeout)):
            return
        super().handle_error(request, client_address)


class HttpService:
    """Threaded HTTP server lifecycle: build, start, address, stop.

    Subclasses (or callers) provide a concrete handler class; extra
    attributes are attached to a per-instance handler subclass so one
    process can run several services (e.g. ``timeout=5.0`` to tighten
    the per-connection read timeout for a test)."""

    def __init__(self, handler_cls, host: str = "127.0.0.1", port: int = 0,
                 **handler_attrs: Any):
        handler = type(handler_cls.__name__, (handler_cls,), handler_attrs)
        self._httpd = _QuietThreadingHTTPServer((host, port), handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"http-{self.port}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5.0)

    def hard_stop(self) -> None:
        """Chaos helper: die the way a SIGKILL'd process
        looks from the network — close the LISTENING socket first so
        new connections are refused immediately, then stop the serve
        loop without any graceful notice to in-flight handlers (their
        next socket write hits a dead/raw fd and raises, exactly like
        writing into a killed process's half of a connection). Used by
        the router chaos soak to simulate replica death in-process;
        production shutdown is :meth:`stop` (or the gateway's
        drain-then-close)."""
        try:
            self._httpd.socket.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # already closed / never connected
        self._httpd.server_close()
        self._httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5.0)
