"""DataSetIterator SPI + combinators.

A copy of ``deeplearning4j_tpu/datasets/iterator.py`` (numpy only): the
reference DataSetIterator.java:54 contract (next(num), totalExamples,
inputColumns, reset, preprocessor hook), a cursor over in-memory
arrays, a list of DataSets, a background prefetch thread with a bounded
blocking queue, MultipleEpochsIterator, SamplingDataSetIterator, the
TestDataSetIterator wrapper (datasets/test/TestDataSetIterator.java),
ReconstructionDataSetIterator and MovingWindowDataSetIterator.

Iterators are Python iterables of :class:`DataSet`; ``reset()`` rewinds.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, List, Optional

import numpy as np

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


class MultipleEpochsIterator(DataSetIterator):
    """Replay a base iterator N times (reference MultipleEpochsIterator)."""

    def __init__(self, num_epochs: int, base: DataSetIterator):
        super().__init__(base.batch)
        self._base = base
        self.num_epochs = num_epochs
        self._epoch = 0

    def next(self, num: Optional[int] = None) -> Optional[DataSet]:
        ds = self._base.next(num)
        if ds is None:
            self._epoch += 1
            if self._epoch >= self.num_epochs:
                return None
            self._base.reset()
            ds = self._base.next(num)
        return self._post(ds)

    def reset(self) -> None:
        self._epoch = 0
        self._base.reset()

    def state_dict(self) -> dict:
        return {"epoch": self._epoch, "base": self._base.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self._epoch = int(state["epoch"])
        self._base.load_state_dict(state["base"])

    def total_examples(self) -> int:
        return self._base.total_examples() * self.num_epochs

    def input_columns(self) -> int:
        return self._base.input_columns()

    def total_outcomes(self) -> int:
        return self._base.total_outcomes()


class SamplingDataSetIterator(DataSetIterator):
    """Sample batches with replacement from one DataSet (reference
    SamplingDataSetIterator)."""

    def __init__(
        self,
        dataset: DataSet,
        batch_size: int,
        total_num_samples: int,
        seed: int = 123,
    ):
        super().__init__(batch_size)
        self._data = dataset
        self._total = total_num_samples
        self._given = 0
        self._rng = np.random.default_rng(seed)

    def next(self, num: Optional[int] = None) -> Optional[DataSet]:
        n = num or self.batch
        if self._given >= self._total:
            return None
        idx = self._rng.integers(0, self._data.num_examples(), size=n)
        self._given += n
        return self._post(self._data.get_examples(idx))

    def reset(self) -> None:
        self._given = 0

    def state_dict(self) -> dict:
        return {"given": self._given, "rng": self._rng.bit_generator.state}

    def load_state_dict(self, state: dict) -> None:
        self._given = int(state["given"])
        self._rng.bit_generator.state = state["rng"]

    def total_examples(self) -> int:
        return self._total

    def input_columns(self) -> int:
        return self._data.num_inputs()

    def total_outcomes(self) -> int:
        return self._data.num_outcomes()


class TestDataSetIterator(DataSetIterator):
    """Wrapper that tracks call counts for iterator-contract tests
    (reference datasets/test/TestDataSetIterator.java)."""

    def __init__(self, base: DataSetIterator):
        super().__init__(base.batch)
        self._base = base
        self.next_calls = 0
        self.reset_calls = 0

    def next(self, num: Optional[int] = None) -> Optional[DataSet]:
        self.next_calls += 1
        return self._post(self._base.next(num))

    def reset(self) -> None:
        self.reset_calls += 1
        self._base.reset()

    def state_dict(self) -> dict:
        return self._base.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self._base.load_state_dict(state)

    def total_examples(self) -> int:
        return self._base.total_examples()

    def input_columns(self) -> int:
        return self._base.input_columns()

    def total_outcomes(self) -> int:
        return self._base.total_outcomes()


class ReconstructionDataSetIterator(DataSetIterator):
    """Wraps an iterator, replacing labels with the features themselves —
    autoencoder/reconstruction training (reference datasets/iterator/
    ReconstructionDataSetIterator.java)."""

    def __init__(self, base: DataSetIterator):
        super().__init__(base.batch)
        self.base = base

    def next(self, num: Optional[int] = None) -> Optional[DataSet]:
        ds = self.base.next(num)
        if ds is None:
            return None
        return self._post(
            DataSet(ds.features, ds.features,
                    ds.features_mask, ds.features_mask)
        )

    def reset(self) -> None:
        self.base.reset()

    def total_examples(self) -> int:
        return self.base.total_examples()

    def input_columns(self) -> int:
        return self.base.input_columns()

    def total_outcomes(self) -> int:
        return self.base.input_columns()

    def state_dict(self) -> dict:
        return self.base.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.base.load_state_dict(state)


class MovingWindowDataSetIterator(BaseDataSetIterator):
    """Slides a (rows x cols) window over each example matrix, emitting
    each window as one flattened feature row (reference
    datasets/iterator/MovingWindowBaseDataSetIterator.java backed by
    util/MovingWindowMatrix)."""

    def __init__(self, data: DataSet, window_rows: int, window_cols: int,
                 batch_size: int = 10, rotate: int = 0):
        from deeplearning4j_tpu_torch.util.moving_window import (
            moving_window_matrices,
        )

        rows = []
        labels = []
        for i in range(data.num_examples()):
            mat = np.asarray(data.features[i])
            if mat.ndim == 1:
                side = int(np.sqrt(mat.shape[0]))
                if side * side != mat.shape[0]:
                    raise ValueError(
                        f"1-D feature rows must have square length to "
                        f"window over; got {mat.shape[0]}"
                    )
                mat = mat.reshape(side, side)
            elif mat.ndim != 2:
                raise ValueError(
                    f"windowing needs [rows, cols] examples; got "
                    f"shape {mat.shape}"
                )
            for w in moving_window_matrices(
                mat, window_rows, window_cols, rotate=rotate
            ):
                rows.append(w.reshape(-1))
                if data.labels is not None:
                    labels.append(data.labels[i])
        feats = np.asarray(rows, np.float32)
        labs = np.asarray(labels, np.float32) if labels else None
        super().__init__(batch_size, DataSet(feats, labs))

    def total_outcomes(self) -> int:
        return (
            0 if self._data.labels is None else self._data.num_outcomes()
        )
