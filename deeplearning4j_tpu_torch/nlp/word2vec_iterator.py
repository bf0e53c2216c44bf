"""DataSet iterator over word windows vectorized with a trained Word2Vec.

Equivalent of the reference
models/word2vec/iterator/Word2VecDataSetIterator.java: a label-aware
sentence iterator feeds a moving window over each sentence; every window
becomes one example whose features are the concatenated word vectors of
the window (WindowConverter) and whose label is the one-hot of the
sentence's label. Homogenization and label tagging mirror the reference's
sentence pre-processors. Windows spill across sentence boundaries into a
cache so every batch except the final remainder has the full static
``batch`` rows.

A copy of ``deeplearning4j_tpu/nlp/word2vec_iterator.py`` over the port's ``datasets``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..datasets.dataset import DataSet
from ..datasets.iterator import DataSetIterator
from .moving_window import Window, WindowConverter, input_homogenization, windows
from .sentence_iterator import LabelAwareSentenceIterator


class Word2VecDataSetIterator(DataSetIterator):
    def __init__(
        self,
        vec,
        iterator: LabelAwareSentenceIterator,
        labels: List[str],
        batch: int = 10,
        homogenization: bool = True,
        add_labels: bool = True,
        normalize: bool = False,
    ):
        super().__init__(batch_size=batch)
        self.vec = vec
        self.iter = iterator
        self.labels = list(labels)
        self.batch = batch
        self.homogenization = homogenization
        self.add_labels = add_labels
        self.normalize = normalize
        self._cached: List[Window] = []

    def _sentence_windows(self) -> List[Window]:
        sentence = self.iter.next_sentence()
        label = self.iter.current_label() if self.add_labels else None
        if self.homogenization:
            sentence = input_homogenization(sentence)
        if not sentence.strip():
            return []
        ws = windows(sentence, window_size=self.vec.window)
        if label is not None:
            for w in ws:
                w.label = label
        return ws

    def _fill_cache(self, num: int) -> None:
        while len(self._cached) < num and self.iter.has_next():
            self._cached.extend(self._sentence_windows())

    def _to_dataset(self, ws: List[Window]) -> DataSet:
        feats = WindowConverter.as_example_matrix(ws, self.vec, self.normalize)
        n_out = max(len(self.labels), 1)
        labels = np.zeros((len(ws), n_out), dtype=np.float32)
        for i, w in enumerate(ws):
            if w.label in self.labels:
                labels[i, self.labels.index(w.label)] = 1.0
        return DataSet(feats, labels)

    def next(self, num: Optional[int] = None) -> Optional[DataSet]:
        num = num or self.batch
        self._fill_cache(num)
        if not self._cached:
            return None
        take, self._cached = self._cached[:num], self._cached[num:]
        return self._post(self._to_dataset(take))

    def reset(self) -> None:
        self.iter.reset()
        self._cached = []

    def input_columns(self) -> int:
        return self.vec.layer_size * self.vec.window

    def total_outcomes(self) -> int:
        return max(len(self.labels), 1)
