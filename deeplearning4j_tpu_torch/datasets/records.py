"""Record readers: file → records → DataSet iterators.

Stand-in for the external Canova library (SURVEY.md §2.9 —
the reference bridges RecordReader→DataSet in datasets/canova/
RecordReaderDataSetIterator.java and SequenceRecordReaderDataSetIterator
.java). Readers yield records (lists of values); the adapter iterators
batch them into DataSets, with sequence variants producing padded
[N, T, F] tensors + masks so every batch has one static shape.
A copy of ``deeplearning4j_tpu/datasets/records.py`` (numpy only).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator


class RecordReader:
    """Canova RecordReader equivalent: iterate records, resettable."""

    def next_record(self) -> Optional[List[str]]:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def num_records(self) -> int:
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_record()


class CSVRecordReader(RecordReader):
    """One record per CSV line (reference Canova CSVRecordReader)."""

    def __init__(self, path: str, skip_lines: int = 0,
                 delimiter: str = ","):
        self.path = path
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._lines: List[List[str]] = []
        self._pos = 0
        self._load()

    def _load(self) -> None:
        with open(self.path) as f:
            raw = [ln.strip() for ln in f]
        rows = [ln.split(self.delimiter) for ln in raw[self.skip_lines:]
                if ln and not ln.startswith("#")]
        self._lines = [[v.strip() for v in row] for row in rows]
        self._pos = 0

    def next_record(self) -> Optional[List[str]]:
        if self._pos >= len(self._lines):
            return None
        rec = self._lines[self._pos]
        self._pos += 1
        return rec

    def num_records(self) -> int:
        return len(self._lines)

    def has_next(self) -> bool:
        return self._pos < len(self._lines)

    def reset(self) -> None:
        self._pos = 0


class CSVSequenceRecordReader(RecordReader):
    """One sequence per FILE, one timestep per line (reference
    CSVSequenceRecordReader over csvsequence_*.txt fixtures). Records
    returned by next_record() are whole sequences: List[List[str]]."""

    def __init__(self, paths: Sequence[str], skip_lines: int = 0,
                 delimiter: str = ","):
        self.paths = list(paths)
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._pos = 0

    def next_record(self):
        if self._pos >= len(self.paths):
            return None
        reader = CSVRecordReader(self.paths[self._pos], self.skip_lines,
                                 self.delimiter)
        self._pos += 1
        return list(reader)

    def num_records(self) -> int:
        return len(self.paths)

    def has_next(self) -> bool:
        return self._pos < len(self.paths)

    def reset(self) -> None:
        self._pos = 0


class ImageRecordReader(RecordReader):
    """Images under class-named subdirectories → (pixels..., label_idx)
    records (reference Canova ImageRecordReader; labels from parent dir).
    Decodes via PIL; grayscale [h, w] flattened row-major."""

    def __init__(self, root: str, height: int, width: int,
                 extensions: Sequence[str] = (".png", ".jpg", ".jpeg",
                                              ".bmp")):
        self.root = root
        self.height = height
        self.width = width
        self.labels = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        self._files: List[tuple] = []
        for li, label in enumerate(self.labels):
            folder = os.path.join(root, label)
            for fn in sorted(os.listdir(folder)):
                if os.path.splitext(fn)[1].lower() in extensions:
                    self._files.append((os.path.join(folder, fn), li))
        self._pos = 0

    def next_record(self) -> Optional[List[str]]:
        if self._pos >= len(self._files):
            return None
        path, label = self._files[self._pos]
        self._pos += 1
        from PIL import Image

        img = Image.open(path).convert("L").resize(
            (self.width, self.height))
        pixels = np.asarray(img, np.float32).ravel() / 255.0
        return [str(v) for v in pixels] + [str(label)]

    def num_records(self) -> int:
        return len(self._files)

    def has_next(self) -> bool:
        return self._pos < len(self._files)

    def reset(self) -> None:
        self._pos = 0


class RecordReaderDataSetIterator(DataSetIterator):
    """records → batched DataSets (reference datasets/canova/
    RecordReaderDataSetIterator.java). The ``label_index`` column (default
    -1 = last) becomes a one-hot label; ``label_index=None`` yields
    feature-only batches; ``regression=True`` keeps the raw label value
    instead of one-hot encoding."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: Optional[int] = -1,
                 num_classes: Optional[int] = None,
                 regression: bool = False):
        super().__init__(batch_size)
        self.reader = reader
        self.num_classes = num_classes
        self.regression = regression
        self._records = [
            [float(v) for v in rec] for rec in reader]
        if not self._records:
            raise ValueError(
                "record reader produced no records (empty input?)")
        ncol = len(self._records[0])
        if label_index is not None:
            if not -ncol <= label_index < ncol:
                raise ValueError(
                    f"label_index {label_index} out of range for "
                    f"{ncol}-column records")
            label_index %= ncol
        self.label_index = label_index
        if (label_index is not None and not regression
                and num_classes is None):
            self.num_classes = int(
                max(r[label_index] for r in self._records)) + 1
        self._pos = 0

    def next(self, num: Optional[int] = None) -> Optional[DataSet]:
        n = num or self.batch
        if self._pos >= len(self._records):
            return None
        chunk = self._records[self._pos:self._pos + n]
        self._pos += len(chunk)
        arr = np.asarray(chunk, np.float32)
        if self.label_index is None:
            return self._post(DataSet(arr, None))
        col = self.label_index
        feats = np.delete(arr, col, axis=1)
        if self.regression:
            labels = arr[:, col:col + 1]
        else:
            from deeplearning4j_tpu_torch.native_rt import one_hot

            labels = one_hot(arr[:, col].astype(int), self.num_classes)
        return self._post(DataSet(feats, labels))

    def reset(self) -> None:
        self._pos = 0

    def total_examples(self) -> int:
        return len(self._records)

    def input_columns(self) -> int:
        ncol = len(self._records[0]) if self._records else 0
        return ncol - (0 if self.label_index is None else 1)

    def total_outcomes(self) -> int:
        return self.num_classes or 0

    def state_dict(self) -> dict:
        return {"pos": self._pos}

    def load_state_dict(self, state: dict) -> None:
        self._pos = state["pos"]


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Paired feature/label sequence readers → padded [N, T, F] DataSets
    with masks (reference SequenceRecordReaderDataSetIterator; padding +
    masks keep shapes static, SURVEY.md §5.7)."""

    def __init__(self, features_reader: CSVSequenceRecordReader,
                 labels_reader: CSVSequenceRecordReader, batch_size: int,
                 num_classes: int):
        super().__init__(batch_size)
        self.num_classes = num_classes
        feats = [np.asarray([[float(v) for v in step] for step in seq],
                            np.float32)
                 for seq in features_reader]
        labels = [np.asarray([[float(v) for v in step] for step in seq],
                             np.float32)
                  for seq in labels_reader]
        if len(feats) != len(labels):
            raise ValueError("feature/label sequence counts differ")
        self._seqs = list(zip(feats, labels))
        self._pos = 0

    def next(self, num: Optional[int] = None) -> Optional[DataSet]:
        n = num or self.batch
        if self._pos >= len(self._seqs):
            return None
        chunk = self._seqs[self._pos:self._pos + n]
        self._pos += len(chunk)
        max_t = max(f.shape[0] for f, _ in chunk)
        nf = chunk[0][0].shape[1]
        bf = np.zeros((len(chunk), max_t, nf), np.float32)
        bl = np.zeros((len(chunk), max_t, self.num_classes), np.float32)
        mask = np.zeros((len(chunk), max_t), np.float32)
        for i, (f, l) in enumerate(chunk):
            t = f.shape[0]
            bf[i, :t] = f
            if l.shape[1] == 1:
                cls = l[:, 0].astype(int)
                if cls.min() < 0 or cls.max() >= self.num_classes:
                    raise ValueError(
                        f"sequence label outside [0, {self.num_classes})")
                bl[i, np.arange(t), cls] = 1.0
            else:
                bl[i, :t, :l.shape[1]] = l
            mask[i, :t] = 1.0
        return self._post(
            DataSet(bf, bl, features_mask=mask, labels_mask=mask))

    def reset(self) -> None:
        self._pos = 0

    def total_examples(self) -> int:
        return len(self._seqs)

    def input_columns(self) -> int:
        return self._seqs[0][0].shape[1] if self._seqs else 0

    def total_outcomes(self) -> int:
        return self.num_classes

    def state_dict(self) -> dict:
        return {"pos": self._pos}

    def load_state_dict(self, state: dict) -> None:
        self._pos = state["pos"]


class RecordReaderMultiDataSetIterator(DataSetIterator):
    """Multi-reader → MultiDataSet adapter (reference datasets/canova/
    RecordReaderMultiDataSetIterator.java): named readers supply columns,
    declared input/output slices assemble each MultiDataSet batch.

    Builder-style use::

        it = (RecordReaderMultiDataSetIterator.Builder(batch_size=32)
              .add_reader("csv", reader)
              .add_input("csv", 0, 3)
              .add_output_one_hot("csv", 4, num_classes=3)
              .build())
    """

    class Builder:
        def __init__(self, batch_size: int):
            self.batch_size = batch_size
            self.readers: dict = {}
            self.inputs: list = []    # (reader, col_from, col_to)
            self.outputs: list = []   # (reader, col_from, col_to, n_cls)

        def add_reader(self, name: str, reader: RecordReader):
            self.readers[name] = reader
            return self

        def add_input(self, name: str, col_from: int, col_to: int):
            self.inputs.append((name, col_from, col_to, None))
            return self

        def add_output(self, name: str, col_from: int, col_to: int):
            self.outputs.append((name, col_from, col_to, None))
            return self

        def add_output_one_hot(self, name: str, col: int,
                               num_classes: int):
            self.outputs.append((name, col, col, num_classes))
            return self

        def build(self) -> "RecordReaderMultiDataSetIterator":
            return RecordReaderMultiDataSetIterator(self)

    def __init__(self, builder: "RecordReaderMultiDataSetIterator.Builder"):
        super().__init__(builder.batch_size)
        self._b = builder
        if not builder.readers or not builder.inputs:
            raise ValueError("need at least one reader and one input")

    def _slice(self, rows: np.ndarray, col_from: int, col_to: int,
               n_cls: Optional[int]) -> np.ndarray:
        block = rows[:, col_from:col_to + 1].astype(np.float32)
        if n_cls is not None:
            from deeplearning4j_tpu_torch.native_rt import one_hot

            return one_hot(block[:, 0].astype(int), n_cls)
        return block

    def next(self, num: Optional[int] = None):
        from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet

        n = num or self.batch
        per_reader = {}
        for name, reader in self._b.readers.items():
            rows = []
            while len(rows) < n and reader.has_next():
                rows.append([float(v) for v in reader.next_record()])
            per_reader[name] = np.asarray(rows, np.float32)
        counts = {v.shape[0] for v in per_reader.values()}
        if counts == {0}:
            return None
        if len(counts) > 1:
            # Readers of unequal length would silently lose the rows
            # already consumed from the longer ones; refuse instead.
            raise ValueError(
                "readers returned unequal row counts "
                + str({k: int(v.shape[0]) for k, v in per_reader.items()})
                + " — all readers must cover the same examples"
            )
        feats = [
            self._slice(per_reader[r], cf, ct, nc)
            for r, cf, ct, nc in self._b.inputs
        ]
        labels = [
            self._slice(per_reader[r], cf, ct, nc)
            for r, cf, ct, nc in self._b.outputs
        ]
        return self._post(MultiDataSet(feats, labels))

    def reset(self) -> None:
        for reader in self._b.readers.values():
            reader.reset()

    def total_examples(self) -> int:
        return min(
            r.num_records() for r in self._b.readers.values()
        )

    def input_columns(self) -> int:
        return sum(ct - cf + 1 for _, cf, ct, _ in self._b.inputs)

    def total_outcomes(self) -> int:
        return sum(
            (nc if nc is not None else ct - cf + 1)
            for _, cf, ct, nc in self._b.outputs
        )
