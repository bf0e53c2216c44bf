"""DataSetIterator SPI and the iterators the CNN slice uses.

Copy of ``DataSetIterator``, ``BaseDataSetIterator``,
``ListDataSetIterator`` and ``AsyncDataSetIterator`` from
``deeplearning4j_tpu/datasets/iterator.py`` (numpy only): the reference
DataSetIterator.java:54 contract (next(num), totalExamples,
inputColumns, reset, preprocessor hook), a cursor over in-memory
arrays, a list of DataSets, and a background prefetch thread with a
bounded blocking queue.

Iterators are Python iterables of :class:`DataSet`; ``reset()`` rewinds.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, List, Optional

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class DataSetIterator:
    """Base contract (reference DataSetIterator.java:54)."""

    def __init__(self, batch_size: int = 10):
        self.batch = batch_size
        self.preprocessor: Optional[Callable[[DataSet], DataSet]] = None

    # -- iteration ------------------------------------------------------
    def __iter__(self) -> "DataSetIterator":
        self.reset()
        return self

    def __next__(self) -> DataSet:
        ds = self.next()
        if ds is None:
            raise StopIteration
        return ds

    def next(self, num: Optional[int] = None) -> Optional[DataSet]:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    # -- metadata -------------------------------------------------------
    def total_examples(self) -> int:
        raise NotImplementedError

    def input_columns(self) -> int:
        raise NotImplementedError

    def total_outcomes(self) -> int:
        raise NotImplementedError

    def set_preprocessor(self, fn: Callable[[DataSet], DataSet]) -> None:
        self.preprocessor = fn

    def _post(self, ds: Optional[DataSet]) -> Optional[DataSet]:
        if ds is not None and self.preprocessor is not None:
            ds = self.preprocessor(ds)
        return ds

    # -- resumable position (improvement over the reference, which never
    # checkpoints iterator position — SURVEY.md §5.4) -------------------
    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass

    def skip_batches(self, n: int) -> int:
        """Advance past ``n`` batches without delivering them — the
        replay primitive async wrappers use to restore an exactly-once
        position (native_rt/iterator.py): rewind the base to a known
        point, then skip what the consumer already trained on.
        Default reads and discards; iterators with a seekable cursor
        override with O(1) arithmetic (datasets/streaming.py). Returns
        the number of batches actually skipped (short at end of
        data)."""
        skipped = 0
        for _ in range(int(n)):
            if self.next() is None:
                break
            skipped += 1
        return skipped


class BaseDataSetIterator(DataSetIterator):
    """Cursor-over-in-memory-arrays base (reference BaseDatasetIterator +
    fetcher split)."""

    def __init__(self, batch_size: int, dataset: DataSet):
        super().__init__(batch_size)
        self._data = dataset
        self._cursor = 0

    def next(self, num: Optional[int] = None) -> Optional[DataSet]:
        n = num or self.batch
        if self._cursor >= self._data.num_examples():
            return None
        ds = self._data.get_range(
            self._cursor, min(self._cursor + n, self._data.num_examples())
        )
        self._cursor += n
        return self._post(ds)

    def reset(self) -> None:
        self._cursor = 0

    def state_dict(self) -> dict:
        return {"cursor": self._cursor}

    def load_state_dict(self, state: dict) -> None:
        self._cursor = int(state["cursor"])

    def total_examples(self) -> int:
        return self._data.num_examples()

    def input_columns(self) -> int:
        return self._data.num_inputs()

    def total_outcomes(self) -> int:
        return self._data.num_outcomes()


class ListDataSetIterator(DataSetIterator):
    """Iterate a pre-built list of DataSets (reference
    ListDataSetIterator)."""

    def __init__(self, datasets: Iterable[DataSet], batch_size: int = 0):
        datasets = list(datasets)
        if batch_size and batch_size > 0:
            merged = DataSet.merge(datasets)
            datasets = merged.batch_by(batch_size)
        super().__init__(batch_size or (len(datasets) and datasets[0].num_examples()) or 1)
        self._list: List[DataSet] = datasets
        self._idx = 0

    def next(self, num: Optional[int] = None) -> Optional[DataSet]:
        if self._idx >= len(self._list):
            return None
        ds = self._list[self._idx]
        self._idx += 1
        return self._post(ds)

    def reset(self) -> None:
        self._idx = 0

    def state_dict(self) -> dict:
        return {"idx": self._idx}

    def load_state_dict(self, state: dict) -> None:
        self._idx = int(state["idx"])

    def total_examples(self) -> int:
        return sum(d.num_examples() for d in self._list)

    def input_columns(self) -> int:
        return self._list[0].num_inputs()

    def total_outcomes(self) -> int:
        return self._list[0].num_outcomes()


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch with a bounded blocking queue (reference
    AsyncDataSetIterator). Overlaps host-side batch preparation with device
    compute — the 2015 pattern that anticipates tf.data/grain prefetch."""

    _SENTINEL = object()

    def __init__(self, base: DataSetIterator, queue_size: int = 4):
        super().__init__(base.batch)
        self._base = base
        self._queue_size = queue_size
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # Serializes base.next() against state_dict() snapshots so a
        # checkpoint never observes the base iterator mid-advance.
        self._base_lock = threading.Lock()

    def _start(self, reset: bool = True) -> None:
        self._stop()
        if reset:
            self._base.reset()
        # The queue and stop-event are bound into the worker closure, so a
        # stale worker from before a reset() can never feed the new epoch's
        # queue. (It does still share self._base: a worker surviving the
        # join timeout — base.next() blocked >5s — could race the new
        # worker's cursor, a limitation shared with the reference's
        # AsyncDataSetIterator thread shutdown.)
        q: queue.Queue = queue.Queue(maxsize=self._queue_size)
        stop = threading.Event()
        self._queue = q
        self._stop_event = stop
        self._error = None

        def worker():
            try:
                while not stop.is_set():
                    with self._base_lock:
                        ds = self._base.next()
                    if ds is None:
                        break
                    while not stop.is_set():
                        try:
                            q.put(ds, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # surfaced on the consumer side
                self._error = e
            finally:
                # Deliver the sentinel unless we were told to stop (in which
                # case the consumer is draining, not reading).
                while not stop.is_set():
                    try:
                        q.put(self._SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _stop(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._stop_event.set()
            # Drain so a producer blocked on put() can observe the event.
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
        self._thread = None
        self._queue = None

    def next(self, num: Optional[int] = None) -> Optional[DataSet]:
        if self._queue is None:
            self._start()
        item = self._queue.get()
        if item is self._SENTINEL:
            self._queue = None
            self._thread = None
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            return None
        return self._post(item)

    def reset(self) -> None:
        self._start()

    def state_dict(self) -> dict:
        # Prefetched-but-unconsumed batches count as consumed: resume
        # position is the base cursor, which is at most queue_size batches
        # ahead of the consumer. The lock guarantees the snapshot is
        # internally consistent (never mid-next()).
        with self._base_lock:
            return {"base": self._base.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self._stop()
        self._base.load_state_dict(state["base"])
        self._start(reset=False)

    def total_examples(self) -> int:
        return self._base.total_examples()

    def input_columns(self) -> int:
        return self._base.input_columns()

    def total_outcomes(self) -> int:
        return self._base.total_outcomes()
