"""Vantage-point tree for metric nearest-neighbor search.

Capability mirror of reference clustering/vptree/VPTree.java — the
structure behind the UI's Word2Vec nearest-neighbors view
(deeplearning4j-ui nearestneighbors/word2vec, SURVEY.md §2.8). Host-side
recursive structure with vectorized distance evaluation per node split.
Supports euclidean and cosine-similarity orderings like the reference.

A copy of ``deeplearning4j_tpu/clustering/vptree.py`` (numpy only).
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np


class _VPNode:
    __slots__ = ("idx", "threshold", "inside", "outside")

    def __init__(self, idx: int, threshold: float):
        self.idx = idx
        self.threshold = threshold
        self.inside: Optional["_VPNode"] = None
        self.outside: Optional["_VPNode"] = None


class VPTree:
    def __init__(
        self,
        items,
        labels: Optional[Sequence[str]] = None,
        similarity: str = "euclidean",
        seed: int = 0,
    ):
        self.items = np.asarray(items, np.float64)
        if similarity == "cosine":
            norms = np.linalg.norm(self.items, axis=1, keepdims=True)
            self._unit = self.items / np.maximum(norms, 1e-12)
        self.similarity = similarity
        self.labels = list(labels) if labels is not None else None
        self._rng = np.random.default_rng(seed)
        self.root = self._build(list(range(self.items.shape[0])))

    # -- metric ---------------------------------------------------------
    # Cosine mode searches with EUCLIDEAN distance on the pre-normalized
    # vectors: 1-cos violates the triangle inequality (it is ||u-v||²/2 on
    # unit vectors), which breaks the tau pruning, while euclidean on unit
    # vectors is a true metric with the identical neighbor ordering.
    # Reported distances are converted back to 1-cos in knn().
    def _dist(self, i: int, idxs) -> np.ndarray:
        base = self._unit if self.similarity == "cosine" else self.items
        diff = base[idxs] - base[i]
        return np.sqrt(np.sum(diff * diff, axis=1))

    def _dist_q(self, q: np.ndarray, idxs) -> np.ndarray:
        if self.similarity == "cosine":
            qn = q / max(np.linalg.norm(q), 1e-12)
            diff = self._unit[idxs] - qn
        else:
            diff = self.items[idxs] - q
        return np.sqrt(np.sum(diff * diff, axis=1))

    # -- build ----------------------------------------------------------
    def _build(self, idxs: List[int]) -> Optional[_VPNode]:
        if not idxs:
            return None
        vp = idxs[self._rng.integers(0, len(idxs))]
        rest = [i for i in idxs if i != vp]
        if not rest:
            return _VPNode(vp, 0.0)
        dists = self._dist(vp, rest)
        threshold = float(np.median(dists))
        node = _VPNode(vp, threshold)
        inside = [i for i, d in zip(rest, dists) if d <= threshold]
        outside = [i for i, d in zip(rest, dists) if d > threshold]
        node.inside = self._build(inside)
        node.outside = self._build(outside)
        return node

    # -- query ----------------------------------------------------------
    def knn(self, query, k: int) -> List[Tuple[float, int]]:
        q = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap of (-d, idx)
        tau = [np.inf]

        def walk(node: Optional[_VPNode]):
            if node is None:
                return
            d = float(self._dist_q(q, [node.idx])[0])
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.idx))
                if len(heap) == k:
                    tau[0] = -heap[0][0]
            elif d < tau[0]:
                heapq.heapreplace(heap, (-d, node.idx))
                tau[0] = -heap[0][0]
            if d <= node.threshold:
                walk(node.inside)
                if d + tau[0] > node.threshold:
                    walk(node.outside)
            else:
                walk(node.outside)
                if d - tau[0] <= node.threshold:
                    walk(node.inside)

        walk(self.root)
        out = sorted((-nd, i) for nd, i in heap)
        if self.similarity == "cosine":
            out = [(d * d / 2.0, i) for d, i in out]  # back to 1-cos
        return out

    def words_nearest(self, query, k: int) -> List[str]:
        """Nearest labels (the UI nearest-neighbors use case)."""
        if self.labels is None:
            raise ValueError("VPTree built without labels")
        return [self.labels[i] for _, i in self.knn(query, k)]
