"""DataSet: (features, labels, feature mask, label mask).

Mirror of ND4J's DataSet as used throughout the reference (merge at
IterativeReduceFlatMap.java:84, masks through MultiLayerNetwork.fit :1152).
Numpy-backed on host; ``MultiLayerNetwork.fit`` moves each batch to the
net's device. A numpy-only copy of deeplearning4j_tpu/datasets/dataset.py.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


class DataSet:
    def __init__(
        self,
        features,
        labels,
        features_mask=None,
        labels_mask=None,
    ):
        self.features = np.asarray(features)
        # feature-only datasets (e.g. predict inputs) carry labels=None;
        # np.asarray(None) would silently make a 0-d object array
        self.labels = None if labels is None else np.asarray(labels)
        self.features_mask = (
            None if features_mask is None else np.asarray(features_mask)
        )
        self.labels_mask = (
            None if labels_mask is None else np.asarray(labels_mask)
        )

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def num_inputs(self) -> int:
        return int(self.features.shape[1])

    def num_outcomes(self) -> int:
        return int(self.labels.shape[1])

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        """Concatenate along the example axis (reference DataSet.merge)."""

        def cat(parts):
            parts = [p for p in parts if p is not None]
            return np.concatenate(parts, axis=0) if parts else None

        return DataSet(
            cat([d.features for d in datasets]),
            cat([d.labels for d in datasets]),
            cat([d.features_mask for d in datasets]),
            cat([d.labels_mask for d in datasets]),
        )

    def split_test_and_train(
        self, n_train: int
    ) -> Tuple["DataSet", "DataSet"]:
        return self.get_range(0, n_train), self.get_range(
            n_train, self.num_examples()
        )

    def get_range(self, start: int, end: int) -> "DataSet":
        sl = slice(start, end)
        return DataSet(
            self.features[sl],
            None if self.labels is None else self.labels[sl],
            None if self.features_mask is None else self.features_mask[sl],
            None if self.labels_mask is None else self.labels_mask[sl],
        )

    def sample(self, n: int, rng: Optional[np.random.Generator] = None) -> "DataSet":
        rng = rng or np.random.default_rng()
        idx = rng.choice(self.num_examples(), size=n, replace=False)
        return self.get_examples(idx)

    def get_examples(self, idx) -> "DataSet":
        return DataSet(
            self.features[idx],
            None if self.labels is None else self.labels[idx],
            None if self.features_mask is None else self.features_mask[idx],
            None if self.labels_mask is None else self.labels_mask[idx],
        )

    def shuffle(self, seed: Optional[int] = None) -> None:
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        self.features = self.features[idx]
        if self.labels is not None:
            self.labels = self.labels[idx]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[idx]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[idx]

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        return [
            self.get_range(i, min(i + batch_size, self.num_examples()))
            for i in range(0, self.num_examples(), batch_size)
        ]

    def scale_0_1(self) -> None:
        mn, mx = self.features.min(), self.features.max()
        if mx > mn:
            self.features = (self.features - mn) / (mx - mn)

    def normalize_zero_mean_unit_variance(self) -> None:
        mu = self.features.mean(axis=0, keepdims=True)
        sd = self.features.std(axis=0, keepdims=True) + 1e-8
        self.features = (self.features - mu) / sd

    def __repr__(self) -> str:
        labels = None if self.labels is None else self.labels.shape
        return (
            f"DataSet(features={self.features.shape}, labels={labels})"
        )


class MultiDataSet:
    """Multi-input / multi-output example container for ComputationGraph
    training (reference: nd4j MultiDataSet as consumed by
    ComputationGraph.fit, produced by
    datasets/canova/RecordReaderMultiDataSetIterator.java).

    ``features`` / ``labels`` are lists of arrays ordered like the graph's
    ``network_inputs`` / ``network_outputs``; masks are parallel lists
    (entries may be None).
    """

    def __init__(self, features, labels, features_masks=None,
                 labels_masks=None):
        as_list = lambda xs: [np.asarray(x) for x in xs]
        self.features = as_list(features)
        self.labels = as_list(labels)
        self.features_masks = (
            None if features_masks is None
            else [None if m is None else np.asarray(m)
                  for m in features_masks]
        )
        self.labels_masks = (
            None if labels_masks is None
            else [None if m is None else np.asarray(m)
                  for m in labels_masks]
        )

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])

    def num_feature_arrays(self) -> int:
        return len(self.features)

    def num_labels_arrays(self) -> int:
        return len(self.labels)

    def get_range(self, start: int, end: int) -> "MultiDataSet":
        sl = slice(start, end)
        cut = lambda ms: (
            None if ms is None
            else [None if m is None else m[sl] for m in ms]
        )
        return MultiDataSet(
            [f[sl] for f in self.features],
            [y[sl] for y in self.labels],
            cut(self.features_masks),
            cut(self.labels_masks),
        )

    @staticmethod
    def merge(datasets: Sequence["MultiDataSet"]) -> "MultiDataSet":
        first = datasets[0]

        def cat_arrays(get, n):
            return [
                np.concatenate([get(d)[i] for d in datasets], axis=0)
                for i in range(n)
            ]

        def cat_masks(get, ref_get, n):
            # A dataset without masks means "all timesteps valid": mixing
            # masked and unmasked datasets must not drop the masks
            # (padded steps would train as real data), so absent masks
            # are expanded to ones of the matching shape.
            if all(get(d) is None for d in datasets):
                return None
            out = []
            for i in range(n):
                protos = [
                    get(d)[i] for d in datasets
                    if get(d) is not None and get(d)[i] is not None
                ]
                if not protos:
                    out.append(None)
                    continue
                proto = protos[0]
                cols = []
                for d in datasets:
                    ms = get(d)
                    m = None if ms is None else ms[i]
                    if m is None:
                        n_ex = ref_get(d)[i].shape[0]
                        m = np.ones((n_ex,) + proto.shape[1:],
                                    proto.dtype)
                    cols.append(m)
                out.append(np.concatenate(cols, axis=0))
            return out

        n_f, n_l = len(first.features), len(first.labels)
        for d in datasets[1:]:
            if len(d.features) != n_f or len(d.labels) != n_l:
                raise ValueError(
                    "cannot merge MultiDataSets with differing array counts"
                )
        return MultiDataSet(
            cat_arrays(lambda d: d.features, n_f),
            cat_arrays(lambda d: d.labels, n_l),
            cat_masks(lambda d: d.features_masks, lambda d: d.features, n_f),
            cat_masks(lambda d: d.labels_masks, lambda d: d.labels, n_l),
        )

    def __repr__(self) -> str:
        return (
            f"MultiDataSet(features={[f.shape for f in self.features]}, "
            f"labels={[y.shape for y in self.labels]})"
        )


def to_multi_data_set(ds: "DataSet") -> "MultiDataSet":
    """DataSet -> single-input/single-output MultiDataSet (reference
    ComputationGraphUtil.toMultiDataSet / spark DataSetToMultiDataSetFn)."""
    return MultiDataSet(
        features=[ds.features],
        labels=[ds.labels] if ds.labels is not None else [],
        features_masks=(
            [ds.features_mask] if ds.features_mask is not None else None),
        labels_masks=(
            [ds.labels_mask] if ds.labels_mask is not None else None),
    )
