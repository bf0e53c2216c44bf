"""Async prefetch iterator over the native ring buffer.

The reference's AsyncDataSetIterator (datasets/iterator/
AsyncDataSetIterator.java) runs a producer thread pushing DataSets into a
LinkedBlockingQueue. Here the blocking queue is the native MPMC ring
(native_rt/lib.RingBuffer): the producer thread pulls batches from the
base iterator, parks them in a token table, and pushes the token; the
consumer pops tokens — so the queue discipline (bounded, blocking,
close-wakes-waiters) runs in C++ while batch payloads stay in Python.

A copy of ``deeplearning4j_tpu/native_rt/iterator.py``.

Exactly-once checkpointing: the producer's cursor
runs up to ``queue_size`` batches AHEAD of what training consumed, so
snapshotting the base iterator's position (the old behaviour) silently
skipped every in-ring batch on resume. The wrapper instead anchors the
base's state at the start of counting (epoch start or last restore) and
counts CONSUMED batches; ``state_dict`` is ``(anchor, consumed)`` and
``load_state_dict`` rewinds the base to the anchor and replays
``consumed`` batches via ``skip_batches`` (O(1) arithmetic for
seekable iterators, read-and-discard otherwise) — the resumed stream
continues at exactly the first untrained batch.
"""

from __future__ import annotations

import copy
import threading
from typing import Dict, Optional

from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
from deeplearning4j_tpu_torch.native_rt.lib import RingBuffer


class NativeAsyncDataSetIterator(DataSetIterator):
    def __init__(self, base: DataSetIterator, queue_size: int = 4):
        super().__init__(batch_size=getattr(base, "batch", 0))
        self.base = base
        self.queue_size = queue_size
        self._ring: Optional[RingBuffer] = None
        self._table: Dict[int, object] = {}
        self._table_lock = threading.Lock()
        # Guards base-iterator access: the producer thread advances it
        # while checkpoint code snapshots/restores it (same role as
        # AsyncDataSetIterator._base_lock, datasets/iterator.py).
        self._base_lock = threading.Lock()
        self._producer: Optional[threading.Thread] = None
        self._producer_error: Optional[BaseException] = None
        # exactly-once position: base state at the point counting
        # started, plus batches CONSUMED (not produced) since then
        self._anchor: dict = {}
        self._consumed = 0
        self._start()

    # -- producer -------------------------------------------------------
    def _start(self, reset: bool = True) -> None:
        self._stop_producer()
        if reset:
            # reset + anchor capture under the SAME lock hold: a stale
            # producer that outlived the join timeout may still be
            # inside base.next() — serializing on the lock means the
            # reset applies after that in-flight advance and the
            # anchor matches the true epoch start (never one batch in)
            with self._base_lock:
                self.base.reset()
                self._anchor = copy.deepcopy(self.base.state_dict())
            self._consumed = 0
        self._ring = RingBuffer(self.queue_size)
        self._table = {}
        self._producer_error = None

        # The closure binds THIS generation's ring/table, so a stale
        # producer that outlives a reset() (join timeout on a blocked
        # base.next()) can only touch its own discarded generation —
        # never the new ring/table.
        ring, table = self._ring, self._table

        def produce():
            token = 0
            try:
                while True:
                    with self._base_lock:
                        ds = self.base.next()
                    if ds is None:
                        break
                    with self._table_lock:
                        table[token] = ds
                    if not ring.push(token):  # closed underneath us
                        with self._table_lock:
                            table.pop(token, None)
                        return
                    token += 1
            except BaseException as e:  # surfaced on next()
                if ring is self._ring:
                    self._producer_error = e
            finally:
                ring.close()

        self._producer = threading.Thread(target=produce, daemon=True)
        self._producer.start()

    def _stop_producer(self) -> None:
        if self._ring is not None:
            self._ring.close()
        producer_alive = False
        if self._producer is not None:
            self._producer.join(timeout=5.0)
            producer_alive = self._producer.is_alive()
        if self._ring is not None:
            # drain so nothing is left referencing parked tokens
            while self._ring.pop() is not None:
                pass
            if not producer_alive:
                self._ring.destroy()
            # else: the stale producer still holds the (closed) ring; its
            # next push returns False and it exits, after which GC frees
            # the native side — destroying now would be a use-after-free.
            self._ring = None
        self._producer = None

    # -- DataSetIterator contract --------------------------------------
    def next(self, num: Optional[int] = None):
        token = self._ring.pop()
        if token is None:
            if self._producer_error is not None:
                err, self._producer_error = self._producer_error, None
                raise err
            return None
        with self._table_lock:
            ds = self._table.pop(token)
        self._consumed += 1
        return self._post(ds)

    def reset(self) -> None:
        self._start()

    def total_examples(self) -> int:
        return self.base.total_examples()

    def input_columns(self) -> int:
        return self.base.input_columns()

    def total_outcomes(self) -> int:
        return self.base.total_outcomes()

    def state_dict(self) -> dict:
        """Exactly-once position: the base state where counting began
        plus the consumed-batch count. Deliberately NOT the base's
        live cursor — the producer has prefetched up to ``queue_size``
        batches past what training consumed, and those in-ring batches
        must be replayed after resume, not skipped."""
        return {"anchor": copy.deepcopy(self._anchor),
                "consumed": self._consumed}

    def load_state_dict(self, state: dict) -> None:
        # Stop the producer BEFORE touching base state so an in-flight
        # next() cannot overwrite the restored cursor.
        self._stop_producer()
        with self._base_lock:
            if "consumed" in state:
                # rewind to the anchor, replay exactly what training
                # consumed: the next delivered batch is the first one
                # it never saw
                self._anchor = copy.deepcopy(state["anchor"])
                self.base.load_state_dict(
                    copy.deepcopy(state["anchor"]))
                self.base.skip_batches(int(state["consumed"]))
                self._consumed = int(state["consumed"])
            else:  # legacy checkpoint (pre-fix): raw base state
                self.base.load_state_dict(state)
                self._anchor = copy.deepcopy(self.base.state_dict())
                self._consumed = 0
        self._start(reset=False)  # keep the restored position
