"""Crash-safe write-ahead journal for the serving router.

A copy of ``deeplearning4j_tpu/serving/journal.py`` (standard library
only): the on-disk frames are byte for byte the same, so a journal
written by either package is recovered by the other.

The router made every *replica* expendable — SIGKILL one and the
router's in-memory journal replays its streams bit-identically on a
survivor. The router itself was the last memory-only component: its
journal, warm-belief map, and per-tenant token buckets all evaporated
with the process. This module is the durable half of that bookkeeping:
an append-only on-disk log the router writes BEFORE acting, so a
SIGKILLed router restarted against the same file recovers every open
stream, every delivered-token high-water mark, every tenant's bucket
level, and every warm-KV belief.

**Wire format.** The file opens with an 8-byte header
(``b"DWJ1" + u32 version``); every record after it is framed
``u32 length | u32 crc32(payload) | payload`` with the payload a
compact-JSON object. A crash can only tear the TAIL of the file
(appends are sequential), so recovery reads records until the first
short frame or CRC mismatch and treats everything before it as truth —
``recover_state`` reports the torn bytes and the next append truncates
them away. A record is bounded (:data:`MAX_RECORD_BYTES`); a framed
length past the bound means the frame itself is garbage (not a torn
tail but a corrupt file) and recovery stops there just the same.

**Record types** (the ``"t"`` key):

- ``open``  — a request was journaled: rid, prompt, params, submit
  wall time. Written BEFORE the first routing attempt.
- ``route`` — an attempt was accepted by a replica: rid, replica
  ADDRESS (the field recovery restores; the id↔address binding has
  its own ``rep`` records).
- ``prog``  — tokens crossed the high-water mark: rid, the fresh
  token list, and ``at`` — the absolute token position the delta
  starts at. The fold of a rid's ``prog`` records IS its delivered
  high-water mark — replay after recovery dedups the regenerated
  prefix against it, so a restarted router neither loses nor
  double-delivers a token. Position-addressed writes make the
  record IDEMPOTENT: a delta folded twice (compaction carry-over
  below can duplicate) lands on the same positions.
- ``done``  — terminal: rid, finish_reason, status, total tokens.
- ``bucket`` — one tenant token-bucket level:
  tenant, tokens, capacity, rate, wall stamp. Folded newest-wins, so
  a restarted router refills a bucket only for the real wall-clock
  downtime — a flooder does not get a fresh burst out of a crash.
- ``warm``/``cold`` — warm-belief delta: the
  router believes replica R is (no longer) warm for affinity key K.
  Restored beliefs keep KV transfers flowing after a restart; a
  replica whose breaker opens during recovery drops its restored
  beliefs exactly like a live death would.
- ``rep`` — a replica's stable id→address binding, learned from its
  first health scrape. Recovery re-seats the ids before any scrape,
  so the rendezvous keyspace holds from the restarted router's first
  pick and a dead-at-recovery replica's breaker opens under the same
  id its restored beliefs are keyed by.
- ``snap``  — a compaction snapshot: the complete live state (open
  entries with their high-water tokens, recent terminals, bucket
  levels, warm beliefs, the next rid). Compaction rewrites the file
  as header + one ``snap`` + every record appended while the
  snapshot was being built (the CARRY-OVER buffer — see
  :meth:`WriteAheadJournal.begin_compaction`; nothing appended
  concurrently is ever lost), and keeps appending, so the WAL stays
  bounded like the in-memory ``journal_cap``. Carry-over can
  DUPLICATE a record that also made it into the snapshot, which is
  why every record type folds idempotently (``open`` never clobbers
  a known rid, ``prog`` writes absolute positions, the rest are
  last-wins).

**Fsync policy** (the ``fsync`` knob): ``per_record`` fsyncs every
append (strongest: survives power loss at per-record latency),
``batched`` (default) flushes to the OS on every append and fsyncs at
most once per ``batch_fsync_s`` (survives process SIGKILL exactly like
per_record — the OS has the bytes — and loses at most one batch window
to a kernel panic), ``off`` never fsyncs (still flushes, still
SIGKILL-safe; for tests and throwaway fleets). The acceptance bench
(``bench_router_wal_overhead``) prices ``batched`` at >= 0.97x WAL-off
throughput.

The journal is the ROUTER's: replicas have their own drain/restore
snapshots and the two layers compose — a router recovery
replays full prompts through whatever replicas answer healthz, exactly
like a replica-death replay would.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

JOURNAL_MAGIC = b"DWJ1"
JOURNAL_VERSION = 1
_HEADER = JOURNAL_MAGIC + struct.pack("<I", JOURNAL_VERSION)
_FRAME = struct.Struct("<II")  # length, crc32(payload)

#: every fsync policy the WAL speaks (the CLI's ``--fsync`` choices)
FSYNC_POLICIES = ("per_record", "batched", "off")

#: one framed record may not exceed this; a framed length past it is
#: corruption, not a big record (open records carry prompts, prog
#: records carry deltas — both orders of magnitude below this)
MAX_RECORD_BYTES = 8 << 20


class JournalError(RuntimeError):
    """The journal file is not a journal (bad magic/version) — a
    TORN TAIL is never an error (recovery truncates it), but a file
    that was never ours must not be silently overwritten."""


def _encode(record: Dict[str, Any]) -> bytes:
    payload = json.dumps(record, separators=(",", ":")).encode()
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def read_records(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Read every intact record: ``(records, torn_tail_bytes)``.
    Stops at the first short frame, CRC mismatch, oversized length,
    or undecodable payload — everything after that point is the torn
    tail a crash mid-append leaves behind (``torn_tail_bytes`` > 0
    reports it; the caller decides whether to truncate). Raises
    :class:`JournalError` for a file that is not a journal at all."""
    with open(path, "rb") as f:
        header = f.read(len(_HEADER))
        if len(header) < len(_HEADER) or header[:4] != JOURNAL_MAGIC:
            raise JournalError(
                f"{path} is not a router journal (bad magic "
                f"{header[:4]!r})")
        version = struct.unpack("<I", header[4:])[0]
        if version != JOURNAL_VERSION:
            raise JournalError(
                f"{path}: journal version {version} != "
                f"{JOURNAL_VERSION}")
        records: List[Dict[str, Any]] = []
        good_end = f.tell()
        size = os.fstat(f.fileno()).st_size
        while True:
            frame = f.read(_FRAME.size)
            if len(frame) < _FRAME.size:
                break
            length, crc = _FRAME.unpack(frame)
            if length > MAX_RECORD_BYTES:
                break
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                break
            try:
                rec = json.loads(payload)
            except ValueError:
                break
            records.append(rec)
            good_end = f.tell()
        return records, size - good_end


class WriteAheadJournal:
    """Append-only framed record log with bounded-size compaction.

    Thread-safe: appends from the router's relay threads serialize on
    an internal lock (per-rid ordering is free — one relay thread owns
    one stream). ``compact_bytes`` bounds the file: once the log grows
    past it the OWNER folds its live state into one ``snap`` record
    via :meth:`compact` (atomic: tmp file + ``os.replace``, fsync'd
    regardless of policy — a compaction that can vanish would lose
    everything it folded)."""

    def __init__(self, path: str, fsync: str = "batched",
                 compact_bytes: int = 1 << 20,
                 batch_fsync_s: float = 0.05):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync {fsync!r} not in {FSYNC_POLICIES}")
        self.path = str(path)
        self.fsync = fsync
        self.compact_bytes = int(compact_bytes)
        self.batch_fsync_s = float(batch_fsync_s)
        self._lock = threading.Lock()
        self._last_sync = 0.0
        self._closed = False
        #: armed by :meth:`begin_compaction`: encoded frames appended
        #: while the owner builds its snapshot, spliced into the
        #: compacted file so the rewrite cannot lose a concurrent
        #: append
        self._carry: Optional[List[bytes]] = None
        #: records recovered from an existing file at open (the
        #: router folds them through :func:`recover_state`); a torn
        #: tail is truncated HERE so appends extend intact state
        self.recovered: List[Dict[str, Any]] = []
        self.torn_tail_bytes = 0
        if os.path.exists(self.path) and os.path.getsize(self.path):
            self.recovered, self.torn_tail_bytes = read_records(
                self.path)
            if self.torn_tail_bytes:
                good = os.path.getsize(self.path) \
                    - self.torn_tail_bytes
                with open(self.path, "rb+") as f:
                    f.truncate(good)
            self._f = open(self.path, "ab")
        else:
            self._f = open(self.path, "wb")
            self._f.write(_HEADER)
            self._f.flush()
            self._sync(force=True)
            self._sync_dir()  # the file's CREATION must survive too

    # -- write path ----------------------------------------------------
    def _sync(self, force: bool = False) -> None:
        """Apply the fsync policy after a flushed write. The file is
        ALWAYS flushed to the OS first (process SIGKILL loses
        nothing); fsync buys kernel-crash durability per policy."""
        if self.fsync == "off" and not force:
            return
        now = time.monotonic()
        if (not force and self.fsync == "batched"
                and now - self._last_sync < self.batch_fsync_s):
            return
        os.fsync(self._f.fileno())
        self._last_sync = now

    def append(self, record: Dict[str, Any]) -> None:
        """Frame + write one record (no-op after close: the router's
        relay threads may race shutdown; a lost tail record after
        close() is indistinguishable from dying a moment earlier,
        which the recovery path already handles). A record past
        :data:`MAX_RECORD_BYTES` raises ``ValueError`` instead of
        being written: the reader treats an oversized frame as
        corruption and stops there, so writing one would silently
        poison every record journaled after it."""
        data = _encode(record)
        if len(data) - _FRAME.size > MAX_RECORD_BYTES:
            raise ValueError(
                f"record of {len(data) - _FRAME.size} bytes exceeds "
                f"the {MAX_RECORD_BYTES}-byte journal frame bound")
        with self._lock:
            if self._closed:
                return
            self._f.write(data)
            self._f.flush()
            if self._carry is not None:
                # a compaction snapshot is being built: this record
                # may or may not be reflected in it, so it is carried
                # into the rewritten file verbatim (idempotent folds
                # make the possible duplication harmless)
                self._carry.append(data)
            self._sync()

    @property
    def size_bytes(self) -> int:
        with self._lock:
            if self._closed:
                return 0
            return self._f.tell()

    def needs_compaction(self) -> bool:
        return self.size_bytes > self.compact_bytes

    def begin_compaction(self) -> None:
        """Arm the carry-over buffer BEFORE building the compaction
        snapshot: every record appended from this call until
        :meth:`compact` is also retained in memory and spliced after
        the snap record, so an append racing the snapshot build can
        never be lost to the rewrite (it may be duplicated when the
        snapshot already reflects it — the record types fold
        idempotently on purpose)."""
        with self._lock:
            if self._carry is None:
                self._carry = []

    def _sync_dir(self) -> None:
        """fsync the journal's DIRECTORY so a rename/creation is
        itself durable — without it, a power loss after ``os.replace``
        can resurrect the pre-compaction inode and silently drop
        every post-compaction record, defeating ``per_record``'s
        power-loss promise."""
        dirname = os.path.dirname(os.path.abspath(self.path)) or "."
        try:
            dirfd = os.open(dirname, os.O_RDONLY)
        except OSError:
            return  # platform without directory fds: best effort
        try:
            os.fsync(dirfd)
        except OSError:
            pass
        finally:
            os.close(dirfd)

    def compact(self, snapshot: Dict[str, Any]) -> None:
        """Rewrite the file as header + one ``snap`` record holding
        ``snapshot`` (the owner's complete live state) + any
        carried-over concurrent appends (see
        :meth:`begin_compaction`). Atomic (tmp + ``os.replace`` +
        directory fsync) and fsync'd regardless of policy: the
        rename must never land with the snap still in a volatile
        cache, or a crash could lose every folded record at once."""
        record = dict(snapshot)
        record["t"] = "snap"
        encoded = _encode(record)
        if len(encoded) - _FRAME.size > MAX_RECORD_BYTES:
            # an unreadable snap would poison the WHOLE file; better
            # to skip this compaction (the log keeps growing but
            # stays recoverable) and let the owner count the error.
            # The carry buffer MUST disarm on this path — every
            # carried record is already in the live file, and an
            # armed buffer with no compaction coming would grow with
            # each append for the rest of the process lifetime.
            with self._lock:
                self._carry = None
            raise ValueError(
                f"compaction snapshot of "
                f"{len(encoded) - _FRAME.size} bytes exceeds the "
                f"{MAX_RECORD_BYTES}-byte journal frame bound")
        tmp = self.path + ".compact"
        with self._lock:
            if self._closed:
                self._carry = None
                return
            carried = self._carry or []
            self._carry = None
            data = _HEADER + encoded + b"".join(carried)
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            try:
                os.replace(tmp, self.path)
            finally:
                # reopen WHATEVER the path now names — the new file,
                # or (replace failed) the old one, which already
                # holds every record the carry buffer duplicated
                self._f = open(self.path, "ab")
            self._last_sync = time.monotonic()
            self._sync_dir()

    def close(self) -> None:
        """Flush + fsync + close. Deliberately NO clean-shutdown
        marker: recovery must behave identically whether the previous
        router exited politely or was SIGKILLed — the one code path
        that matters is the one that always runs."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass
            self._f.close()


def recover_state(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold a record sequence (as :func:`read_records` returns, or
    ``WriteAheadJournal.recovered``) into the router-shaped recovery
    state::

        {"entries": {rid: {"prompt", "params", "tokens", "replica",
                           "done", "finish_reason", "status",
                           "submit_wall"}},
         "buckets": {tenant: {"tokens", "capacity", "rate", "wall"}},
         "warm": {key_hex: {replica_id: wall_stamp}},
         "replica_ids": {address: stable_id},
         "next_rid": int,
         "snap_wall": float | None}

    A ``snap`` record REPLACES all folded state (compaction rewrote
    the file; a snap mid-stream means records before it were already
    folded into it). Unknown record types are skipped — an older
    router reading a newer journal recovers what it understands
    rather than refusing to boot."""
    entries: Dict[int, Dict[str, Any]] = {}
    buckets: Dict[str, Dict[str, float]] = {}
    warm: Dict[str, Dict[str, float]] = {}
    replica_ids: Dict[str, str] = {}
    next_rid = 0
    snap_wall: Optional[float] = None
    for rec in records:
        t = rec.get("t")
        if t == "snap":
            entries = {int(e["rid"]): {
                "prompt": [int(x) for x in e["prompt"]],
                "params": dict(e.get("params") or {}),
                "tokens": [int(x) for x in e.get("tokens") or []],
                "replica": e.get("replica"),
                "done": bool(e.get("done")),
                "finish_reason": e.get("finish_reason"),
                "status": e.get("status"),
                "submit_wall": e.get("submit_wall"),
            } for e in rec.get("entries") or []}
            buckets = {str(k): dict(v) for k, v
                       in (rec.get("buckets") or {}).items()}
            warm = {str(k): {str(r): float(s)
                             for r, s in v.items()}
                    for k, v in (rec.get("warm") or {}).items()}
            replica_ids = {str(a): str(r) for a, r
                           in (rec.get("replicas") or {}).items()}
            next_rid = int(rec.get("next_rid") or 0)
            snap_wall = rec.get("wall")
        elif t == "open":
            rid = int(rec["rid"])
            if rid not in entries:
                # rids are never reused, so an open for a known rid
                # can only be a compaction carry-over duplicate — it
                # must not clobber the snapshot's folded progress
                entries[rid] = {
                    "prompt": [int(x) for x in rec["prompt"]],
                    "params": dict(rec.get("params") or {}),
                    "tokens": [], "replica": None, "done": False,
                    "finish_reason": None, "status": None,
                    "submit_wall": rec.get("wall"),
                }
            next_rid = max(next_rid, rid + 1)
        elif t == "route":
            e = entries.get(int(rec["rid"]))
            if e is not None:
                e["replica"] = rec.get("replica")
        elif t == "prog":
            e = entries.get(int(rec["rid"]))
            if e is not None and not e["done"]:
                toks = [int(x) for x in rec["toks"]]
                tokens = e["tokens"]
                # position-addressed (idempotent under carry-over
                # duplication); a record without "at" is the legacy
                # append form. A record PAST a positional gap (a
                # mid-journal append failure swallowed upstream) is
                # DROPPED: the gap already bounds recovery fidelity
                # there, and splicing its tokens at wrong absolute
                # positions would serve wrong tokens to a resuming
                # client — replay regenerates the real ones instead.
                at = int(rec.get("at", len(tokens)))
                if 0 <= at <= len(tokens):
                    tokens[at:at + len(toks)] = toks
        elif t == "done":
            e = entries.get(int(rec["rid"]))
            if e is not None:
                e["done"] = True
                e["finish_reason"] = rec.get("reason")
                e["status"] = rec.get("status")
                n = rec.get("n")
                if n is not None and len(e["tokens"]) != int(n):
                    # the done record is authoritative about the
                    # delivered count: a prog append racing the crash
                    # may have landed after the terminal was sealed
                    e["tokens"] = e["tokens"][:int(n)]
        elif t == "bucket":
            buckets[str(rec["tenant"])] = {
                "tokens": float(rec["tokens"]),
                "capacity": float(rec["capacity"]),
                "rate": float(rec["rate"]),
                "wall": float(rec.get("wall") or 0.0),
            }
        elif t == "warm":
            warm.setdefault(str(rec["k"]), {})[str(rec["r"])] = \
                float(rec.get("wall") or 0.0)
        elif t == "rep":
            replica_ids[str(rec["addr"])] = str(rec["r"])
        elif t == "cold":
            k = rec.get("k")
            if k is None:
                # replica-wide cold (breaker opened): drop the
                # replica from every key's belief set
                for beliefs in warm.values():
                    beliefs.pop(str(rec["r"]), None)
            else:
                beliefs = warm.get(str(k))
                if beliefs is not None:
                    beliefs.pop(str(rec["r"]), None)
    return {"entries": entries, "buckets": buckets,
            "warm": {k: v for k, v in warm.items() if v},
            "replica_ids": replica_ids,
            "next_rid": next_rid, "snap_wall": snap_wall}
