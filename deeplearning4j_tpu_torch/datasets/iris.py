"""Iris dataset iterator.

Mirror of reference datasets/fetchers/IrisDataFetcher + iterator/impl/
IrisDataSetIterator.java. Loads the classic 150-example Iris data from
sklearn when available or from a CSV at ``$DL4J_TPU_DATA_DIR/iris.csv``;
otherwise generates a deterministic 3-Gaussian-cluster stand-in with the
same shape (150 x 4 features, 3 classes) that is linearly separable enough
for the reference's convergence-style tests.

A copy of ``deeplearning4j_tpu/datasets/iris.py`` (numpy only), imports
rewritten to this package.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import BaseDataSetIterator


def _load_iris_arrays():
    try:
        from sklearn.datasets import load_iris  # type: ignore

        data = load_iris()
        return data.data.astype(np.float32), data.target.astype(int)
    except Exception:
        pass
    csv = os.path.join(
        os.environ.get(
            "DL4J_TPU_DATA_DIR",
            os.path.join(os.path.expanduser("~"), ".cache", "deeplearning4j_tpu"),
        ),
        "iris.csv",
    )
    if os.path.exists(csv):
        raw = np.loadtxt(csv, delimiter=",")
        return raw[:, :4].astype(np.float32), raw[:, 4].astype(int)
    # Deterministic stand-in: 3 Gaussian clusters in 4-d.
    rng = np.random.default_rng(42)
    centers = np.array(
        [[5.0, 3.4, 1.5, 0.2], [5.9, 2.8, 4.3, 1.3], [6.6, 3.0, 5.6, 2.0]],
        np.float32,
    )
    feats, targets = [], []
    for c in range(3):
        feats.append(
            centers[c] + 0.3 * rng.normal(size=(50, 4)).astype(np.float32)
        )
        targets.extend([c] * 50)
    return np.concatenate(feats), np.asarray(targets)


def iris_dataset(shuffle_seed: Optional[int] = 12345) -> DataSet:
    x, t = _load_iris_arrays()
    y = np.zeros((len(t), 3), np.float32)
    y[np.arange(len(t)), t] = 1.0
    ds = DataSet(x, y)
    if shuffle_seed is not None:
        ds.shuffle(shuffle_seed)
    return ds


class IrisDataSetIterator(BaseDataSetIterator):
    def __init__(self, batch_size: int = 150, num_examples: int = 150):
        ds = iris_dataset()
        super().__init__(batch_size, ds.get_range(0, num_examples))
