"""Disk-streaming DataSetIterators: batches read from on-disk binaries
at next() time, never materializing the dataset in memory.

The reference's L3 design feeds ``fit()`` from iterators backed by
files (datasets/iterator/impl/*DataSetIterator.java pulling from
fetchers/Canova readers), with AsyncDataSetIterator overlapping the
reads with training. These iterators are the disk half of that story — wrap
them in ``native_rt.NativeAsyncDataSetIterator`` (C++ prefetch ring) and
feed ``MultiLayerNetwork.fit_stream`` for the full host-fed pipeline:

    disk -> producer thread -> C++ ring -> window stack into pinned
    memory -> one H2D copy on a copy stream -> captured fit_scan
    replays

A copy of ``deeplearning4j_tpu/datasets/streaming.py`` (numpy only);
the DL4JTOK1 files are byte for byte the JAX package's.

Formats:
- CIFAR-10 binary batches (rows of [label u8][3072 px u8]) — the same
  files ``fetchers.load_cifar`` loads whole; here streamed by row range.
- Token-sequence files: ``DL4JTOK1`` header + u8/u16 token-id rows
  [n_seq, seq_len + 1] — the LM wire format (ids on disk and on the
  wire; one-hot only on device).
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator

_TOK_MAGIC = b"DL4JTOK1"


class StorageDataSetIterator(DataSetIterator):
    """Stream batches from shard files in a ``storage.backends``
    backend (S3/GCS/HDFS/local) into ``fit()`` — the reference's
    BaseS3DataSetIterator/BaseHdfsDataSetIterator role
    (deeplearning4j-aws BaseS3DataSetIterator.java:1): one shard is
    downloaded at a time, parsed, and batched; the next shard is
    fetched only when the current one drains, so the working set
    stays one shard regardless of dataset size.

    ``fmt``:
    - ``"cifar"`` — shards are CIFAR-10 binary batch files
      (u8 [B,3,32,32] features, one-hot labels),
    - ``"tokens"`` — DL4JTOK1 token files (LM id pairs),
    - ``"npz"`` — ``np.savez`` archives with ``features``/``labels``
      (+ optional ``features_mask``/``labels_mask``) arrays.

    Wrap in ``native_rt.NativeAsyncDataSetIterator`` to overlap the
    downloads with training (the reference pairs its S3 iterator with
    AsyncDataSetIterator the same way)."""

    def __init__(self, backend, prefix: str, batch_size: int,
                 fmt: str = "npz", num_classes: int = 10):
        super().__init__(batch_size)
        if fmt not in ("cifar", "tokens", "npz"):
            raise ValueError(f"unknown shard format {fmt!r}")
        self.backend = backend
        self.prefix = prefix
        self.fmt = fmt
        self.num_classes = num_classes
        self.keys = sorted(backend.list(prefix))
        if not self.keys:
            raise ValueError(
                f"no shards under prefix {prefix!r}")
        self._key_idx = 0
        self._inner: Optional[DataSetIterator] = None
        self._tmpdir = None
        self._current_local: Optional[str] = None
        self._schema: dict = {}

    def _local_copy(self, key: str) -> str:
        import tempfile

        if self._tmpdir is None:
            self._tmpdir = tempfile.mkdtemp(prefix="dl4j_storage_it_")
        local = os.path.join(
            self._tmpdir, os.path.basename(key) or "shard")
        return self.backend.get(key, local)

    def _drop_current(self) -> None:
        """Delete the drained shard's local copy — the working set is
        ONE shard, so an epoch over a dataset larger than local disk
        cannot fill it."""
        self._inner = None
        if self._current_local is not None:
            try:
                os.unlink(self._current_local)
            except OSError:
                pass
            self._current_local = None

    def close(self) -> None:
        import shutil

        self._drop_current()
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _open(self, key: str) -> DataSetIterator:
        local = self._current_local = self._local_copy(key)
        return self._open_local(local)

    def _open_local(self, local: str) -> DataSetIterator:
        if self.fmt == "cifar":
            return CifarBinStreamIterator(
                [local], self.batch, num_classes=self.num_classes)
        if self.fmt == "tokens":
            return TokenSequenceFileIterator(local, self.batch)
        z = np.load(local)
        from deeplearning4j_tpu_torch.datasets.iterator import (
            BaseDataSetIterator,
        )

        ds = DataSet(z["features"], z["labels"],
                     z["features_mask"] if "features_mask" in z else None,
                     z["labels_mask"] if "labels_mask" in z else None)
        return BaseDataSetIterator(self.batch, ds)

    def next(self, num: Optional[int] = None) -> Optional[DataSet]:
        while True:
            if self._inner is None:
                if self._key_idx >= len(self.keys):
                    return None
                self._inner = self._open(self.keys[self._key_idx])
            ds = self._inner.next(num)
            if ds is not None:
                return self._post(ds)
            self._drop_current()
            self._key_idx += 1

    def reset(self) -> None:
        self._drop_current()
        self._key_idx = 0

    def total_examples(self) -> int:
        # would require opening every shard; the reference's S3
        # iterator returns the configured total as well
        raise NotImplementedError(
            "total_examples requires scanning every remote shard")

    def _schema_val(self, name: str) -> int:
        """Schema queries, cached after the first answer. A LIVE
        reader answers for free (its schema accessors are pure — safe
        even while a producer thread drives next()); with no shard
        open, the first shard is probed into a PRIVATE temp dir so
        nothing here mutates iterator state (an async producer may be
        mid-_open concurrently)."""
        if name not in self._schema:
            inner = self._inner  # snapshot: producer may swap it
            if inner is not None:
                schema = {"input_columns": inner.input_columns(),
                          "total_outcomes": inner.total_outcomes()}
            else:
                import tempfile

                with tempfile.TemporaryDirectory(
                        prefix="dl4j_storage_meta_") as d:
                    local = self.backend.get(
                        self.keys[0], os.path.join(d, "meta_shard"))
                    reader = self._open_local(local)
                    schema = {
                        "input_columns": reader.input_columns(),
                        "total_outcomes": reader.total_outcomes(),
                    }
            self._schema.update(schema)
        return self._schema[name]

    def input_columns(self) -> int:
        if self.fmt == "cifar":
            return 3 * 32 * 32
        return self._schema_val("input_columns")

    def total_outcomes(self) -> int:
        if self.fmt == "cifar":
            return self.num_classes
        return self._schema_val("total_outcomes")

    def state_dict(self) -> dict:
        return {
            "key_idx": self._key_idx,
            "inner": (None if self._inner is None
                      else self._inner.state_dict()),
        }

    def load_state_dict(self, state: dict) -> None:
        self._drop_current()  # unlink the open shard's local copy
        self._key_idx = int(state["key_idx"])
        if state.get("inner") is not None and self._key_idx < len(
                self.keys):
            self._inner = self._open(self.keys[self._key_idx])
            self._inner.load_state_dict(state["inner"])


class CifarBinStreamIterator(DataSetIterator):
    """Stream [label u8][3072 px u8] rows from CIFAR-binary files.

    Yields DataSet(features u8 [B, 3, 32, 32], labels one-hot f32
    [B, num_classes]); features stay u8 (the wire-minimal form —
    normalize on device, e.g. via ``fit_stream``'s ingest hook).
    Batches never span files (the on-disk batches are independent
    shards, like the reference's data_batch_1..5)."""

    def __init__(self, paths: Sequence[str], batch_size: int,
                 num_classes: int = 10):
        super().__init__(batch_size)
        self.paths: List[str] = list(paths)
        self.num_classes = num_classes
        self._rows_per_file = []
        for p in self.paths:
            size = os.path.getsize(p)
            if size == 0 or size % 3073:
                raise ValueError(
                    f"{p}: not a CIFAR-10 binary batch file")
            self._rows_per_file.append(size // 3073)
        self._file_idx = 0
        self._row = 0

    def next(self, num: Optional[int] = None) -> Optional[DataSet]:
        n = num or self.batch
        while self._file_idx < len(self.paths):
            avail = self._rows_per_file[self._file_idx] - self._row
            if avail > 0:
                take = min(n, avail)
                mm = np.memmap(self.paths[self._file_idx],
                               dtype=np.uint8, mode="r")
                lo, hi = self._row * 3073, (self._row + take) * 3073
                rows = np.asarray(mm[lo:hi]).reshape(take, 3073)
                del mm
                self._row += take
                feats = rows[:, 1:].reshape(take, 3, 32, 32)
                labels = np.zeros((take, self.num_classes), np.float32)
                labels[np.arange(take), rows[:, 0]] = 1.0
                return self._post(DataSet(feats, labels))
            self._file_idx += 1
            self._row = 0
        return None

    def reset(self) -> None:
        self._file_idx = 0
        self._row = 0

    def skip_batches(self, n: int) -> int:
        """Seek-based skip: batches never span files, so the cursor
        advances with row arithmetic — no pixel is read (the async
        wrapper's exactly-once replay stays O(1) per batch)."""
        skipped = 0
        for _ in range(int(n)):
            while (self._file_idx < len(self.paths)
                   and self._row >= self._rows_per_file[self._file_idx]):
                self._file_idx += 1
                self._row = 0
            if self._file_idx >= len(self.paths):
                break
            avail = self._rows_per_file[self._file_idx] - self._row
            self._row += min(self.batch, avail)
            skipped += 1
        return skipped

    def total_examples(self) -> int:
        return int(sum(self._rows_per_file))

    def input_columns(self) -> int:
        return 3 * 32 * 32

    def total_outcomes(self) -> int:
        return self.num_classes

    def state_dict(self) -> dict:
        return {"file_idx": self._file_idx, "row": self._row}

    def load_state_dict(self, state: dict) -> None:
        self._file_idx = int(state["file_idx"])
        self._row = int(state["row"])


def write_token_file(path: str, tokens: np.ndarray, vocab: int) -> None:
    """Write [n_seq, row_len] token ids as a DL4JTOK1 binary (u8 rows
    for vocab <= 256, u16 otherwise)."""
    tokens = np.asarray(tokens)
    if tokens.ndim != 2:
        raise ValueError("tokens must be [n_seq, row_len]")
    if tokens.min() < 0 or tokens.max() >= vocab:
        raise ValueError(f"token ids outside [0, {vocab})")
    dtype = np.uint8 if vocab <= 256 else np.uint16
    with open(path, "wb") as f:
        f.write(_TOK_MAGIC)
        f.write(struct.pack("<IIII", tokens.shape[0], tokens.shape[1],
                            vocab, dtype().itemsize))
        f.write(np.ascontiguousarray(tokens, dtype).tobytes())


def read_token_file_header(path: str) -> Tuple[int, int, int, int]:
    """-> (n_seq, row_len, vocab, itemsize)."""
    with open(path, "rb") as f:
        if f.read(8) != _TOK_MAGIC:
            raise ValueError(f"{path}: not a DL4JTOK1 token file")
        return struct.unpack("<IIII", f.read(16))


class TokenSequenceFileIterator(DataSetIterator):
    """Stream next-token LM batches from a DL4JTOK1 file.

    Each row of [n_seq, T + 1] ids becomes (features = ids[:-1],
    labels = ids[1:]), both [B, T] integer arrays — the minimal wire
    form. One-hot/embedding happens on device (``fit_stream``'s
    ingest/ingest_labels hooks)."""

    def __init__(self, path: str, batch_size: int):
        super().__init__(batch_size)
        self.path = path
        (self.n_seq, self.row_len, self.vocab,
         self._itemsize) = read_token_file_header(path)
        self._dtype = np.uint8 if self._itemsize == 1 else np.uint16
        self._cursor = 0

    def next(self, num: Optional[int] = None) -> Optional[DataSet]:
        n = num or self.batch
        if self._cursor >= self.n_seq:
            return None
        take = min(n, self.n_seq - self._cursor)
        offset = 24 + self._cursor * self.row_len * self._itemsize
        rows = np.fromfile(self.path, dtype=self._dtype,
                           count=take * self.row_len, offset=offset
                           ).reshape(take, self.row_len)
        self._cursor += take
        return self._post(DataSet(rows[:, :-1], rows[:, 1:]))

    def reset(self) -> None:
        self._cursor = 0

    def skip_batches(self, n: int) -> int:
        """Seek-based skip: pure cursor arithmetic over the fixed-row
        file — no token is read."""
        skipped = 0
        for _ in range(int(n)):
            if self._cursor >= self.n_seq:
                break
            self._cursor = min(self.n_seq, self._cursor + self.batch)
            skipped += 1
        return skipped

    def total_examples(self) -> int:
        return self.n_seq

    def input_columns(self) -> int:
        return self.row_len - 1

    def total_outcomes(self) -> int:
        return self.vocab

    def state_dict(self) -> dict:
        return {"cursor": self._cursor}

    def load_state_dict(self, state: dict) -> None:
        self._cursor = int(state["cursor"])
