"""Vectorizers: raw inputs → DataSet (reference datasets/vectorizer/*).

The reference's Vectorizer SPI turns one unstructured input (an image
file) into a labeled DataSet row (ImageVectorizer.java); kept here with
the same tiny contract plus a matrix moving-window helper used by the
vision pipeline (util/MovingWindowMatrix.java's role).

A copy of ``deeplearning4j_tpu/datasets/vectorizer.py`` (numpy only), imports
rewritten to this package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class Vectorizer:
    """SPI: ``vectorize() -> DataSet`` (reference Vectorizer.java)."""

    def vectorize(self) -> DataSet:
        raise NotImplementedError


class ImageVectorizer(Vectorizer):
    """One image file + label → one-row DataSet (reference
    datasets/vectorizer/ImageVectorizer.java)."""

    def __init__(self, path: str, label: int, num_labels: int,
                 height: Optional[int] = None, width: Optional[int] = None):
        self.path = path
        self.label = label
        self.num_labels = num_labels
        self.height = height
        self.width = width

    def vectorize(self) -> DataSet:
        from PIL import Image

        img = Image.open(self.path).convert("L")
        if self.height and self.width:
            img = img.resize((self.width, self.height))
        feats = np.asarray(img, np.float32).ravel()[None, :] / 255.0
        labels = np.zeros((1, self.num_labels), np.float32)
        labels[0, self.label] = 1.0
        return DataSet(feats, labels)


def moving_window_matrix(arr: np.ndarray, window_rows: int,
                         window_cols: int, rotate: int = 0) -> np.ndarray:
    """All dense sliding windows of a 2-D array, flattened per window →
    [num_windows, window_rows*window_cols] (reference
    util/MovingWindowMatrix.java; ``rotate`` appends 90°-rotated copies
    of each window like the reference's addRotate)."""
    h, w = arr.shape
    if window_rows > h or window_cols > w:
        raise ValueError("window larger than matrix")
    if rotate > 0 and window_rows != window_cols:
        raise ValueError("rotate requires square windows")
    views = np.lib.stride_tricks.sliding_window_view(
        arr, (window_rows, window_cols))
    windows = views.reshape(-1, window_rows, window_cols)
    out = [windows]
    current = windows
    for _ in range(rotate):
        current = np.rot90(current, axes=(1, 2))
        out.append(current)
    stacked = np.concatenate(out) if len(out) > 1 else windows
    return stacked.reshape(stacked.shape[0], -1).copy()
