"""Classification evaluation via confusion matrix.

Mirror of reference eval/Evaluation.java:38 (830 LoC with ConfusionMatrix):
eval(labels, predictions) :85, per-class precision :329 / recall :374 /
f1 :419, accuracy :447, time-series + masked variants :171-226, distributed
``merge()`` :551 (the reduction used by Spark evaluation map/reduce —
impl/multilayer/evaluation/EvaluationReduceFunction.java), stats() report
:266.

Copy of ``deeplearning4j_tpu/eval/evaluation.py`` (numpy only): the
confusion matrix accumulates on the host from numpy labels and
predictions, one bincount per batch.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class ConfusionMatrix:
    """Counts[actual][predicted] (reference berkeley-backed
    ConfusionMatrix)."""

    def __init__(self, num_classes: int):
        self.matrix = np.zeros((num_classes, num_classes), np.int64)

    def add(self, actual: int, predicted: int, count: int = 1) -> None:
        self.matrix[actual, predicted] += count

    def add_matrix(self, other: "ConfusionMatrix") -> None:
        self.matrix += other.matrix

    def get_count(self, actual: int, predicted: int) -> int:
        return int(self.matrix[actual, predicted])

    def total(self) -> int:
        return int(self.matrix.sum())


class Evaluation:
    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None):
        self._num_classes = num_classes
        self.label_names = labels
        self.confusion: Optional[ConfusionMatrix] = None

    # ------------------------------------------------------------------
    def _ensure(self, n: int) -> None:
        if self.confusion is None:
            self._num_classes = self._num_classes or n
            self.confusion = ConfusionMatrix(self._num_classes)

    def eval(self, labels, predictions) -> None:
        """Accumulate a batch: one-hot labels [N, C] (or int class vector)
        vs network output [N, C] (reference eval :85)."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 1:
            n_cls = predictions.shape[1]
            onehot = np.zeros((len(labels), n_cls), np.float32)
            onehot[np.arange(len(labels)), labels.astype(int)] = 1.0
            labels = onehot
        self._ensure(labels.shape[1])
        actual = labels.argmax(axis=1)
        predicted = predictions.argmax(axis=1)
        # Vectorized confusion accumulation (bincount over flat index).
        n = self._num_classes
        flat = actual * n + predicted
        self.confusion.matrix += np.bincount(
            flat, minlength=n * n
        ).reshape(n, n)

    def eval_time_series(self, labels, predictions, mask=None) -> None:
        """[N, C, T] labels/predictions with optional [N, T] mask
        (reference evalTimeSeries :171-226)."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        lab2 = np.transpose(labels, (0, 2, 1)).reshape(-1, labels.shape[1])
        pred2 = np.transpose(predictions, (0, 2, 1)).reshape(
            -1, predictions.shape[1]
        )
        if mask is not None:
            keep = np.asarray(mask).reshape(-1) > 0
            lab2, pred2 = lab2[keep], pred2[keep]
        self.eval(lab2, pred2)

    # ------------------------------------------------------------------
    def merge(self, other: "Evaluation") -> "Evaluation":
        """Distributed reduction (reference merge :551)."""
        if other.confusion is None:
            return self
        if self.confusion is None:
            self._num_classes = other._num_classes
            self.confusion = ConfusionMatrix(other._num_classes)
        self.confusion.add_matrix(other.confusion)
        return self

    # ------------------------------------------------------------------
    def _tp(self, c: int) -> int:
        return self.confusion.get_count(c, c)

    def _fp(self, c: int) -> int:
        return int(self.confusion.matrix[:, c].sum()) - self._tp(c)

    def _fn(self, c: int) -> int:
        return int(self.confusion.matrix[c, :].sum()) - self._tp(c)

    def accuracy(self) -> float:
        total = self.confusion.total()
        if total == 0:
            return 0.0
        return float(np.trace(self.confusion.matrix)) / total

    def precision(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            d = self._tp(cls) + self._fp(cls)
            return self._tp(cls) / d if d else 0.0
        vals = [self.precision(c) for c in range(self._num_classes)]
        return float(np.mean(vals))

    def recall(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            d = self._tp(cls) + self._fn(cls)
            return self._tp(cls) / d if d else 0.0
        vals = [self.recall(c) for c in range(self._num_classes)]
        return float(np.mean(vals))

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def false_positive_rate(self, cls: int) -> float:
        neg = self.confusion.total() - int(self.confusion.matrix[cls, :].sum())
        return self._fp(cls) / neg if neg else 0.0

    def class_count(self, cls: int) -> int:
        return int(self.confusion.matrix[cls, :].sum())

    # ------------------------------------------------------------------
    def stats(self) -> str:
        """Human-readable report (reference stats() :266)."""
        if self.confusion is None:
            return "Evaluation: no data"
        lines = ["==========================Scores========================="]
        lines.append(f" Accuracy:  {self.accuracy():.4f}")
        lines.append(f" Precision: {self.precision():.4f}")
        lines.append(f" Recall:    {self.recall():.4f}")
        lines.append(f" F1 Score:  {self.f1():.4f}")
        lines.append("=========================================================")
        lines.append("Confusion matrix (rows=actual, cols=predicted):")
        lines.append(str(self.confusion.matrix))
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"Evaluation(accuracy={self.accuracy():.4f})" if self.confusion else "Evaluation()"
