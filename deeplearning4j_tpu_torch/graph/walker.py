"""Random-walk generation.

Capability mirror of reference graph iterator/{RandomWalkIterator,
WeightedRandomWalkIterator,GraphWalkIterator}.java + the parallel
providers. Inverted for batched arrays: instead of one Java iterator stepping a
single walker vertex-by-vertex, ALL walks advance in lockstep — each step
is one vectorized gather into the padded neighbor table + one batched
categorical draw, so generating the corpus for DeepWalk is O(walk_length)
numpy ops regardless of vertex count.

A copy of ``deeplearning4j_tpu/graph/walker.py`` (numpy only).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.api import Graph, NoEdgeHandling, NoEdgesException


def generate_walks(
    graph: Graph,
    walk_length: int,
    walks_per_vertex: int = 1,
    weighted: bool = False,
    no_edge_handling: NoEdgeHandling = (
        NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED
    ),
    seed: int = 12345,
) -> np.ndarray:
    """All walks as one [n_walks, walk_length+1] int array. Starts cover
    every vertex ``walks_per_vertex`` times in shuffled order."""
    nbr, wgt, deg = graph.neighbor_table()
    n = graph.num_vertices()
    rng = np.random.default_rng(seed)

    if (deg == 0).any():
        if no_edge_handling == NoEdgeHandling.EXCEPTION_ON_DISCONNECTED:
            bad = int(np.argmax(deg == 0))
            raise NoEdgesException(
                f"vertex {bad} has no edges "
                "(NoEdgeHandling.EXCEPTION_ON_DISCONNECTED)"
            )

    starts = np.concatenate(
        [rng.permutation(n) for _ in range(walks_per_vertex)]
    )
    cur = starts.copy()
    out = np.empty((len(starts), walk_length + 1), np.int64)
    out[:, 0] = cur
    max_deg = nbr.shape[1]
    for t in range(1, walk_length + 1):
        d = deg[cur]  # [W]
        if weighted:
            w = wgt[cur].astype(np.float64)  # [W, max_deg]
            valid = np.arange(max_deg)[None, :] < d[:, None]
            w = np.where(valid, w, 0.0)
            tot = w.sum(1, keepdims=True)
            probs = np.where(tot > 0, w / np.maximum(tot, 1e-300), 0.0)
            # Batched categorical via inverse-CDF on uniform draws.
            u = rng.random(len(cur))[:, None]
            choice = (probs.cumsum(1) < u).sum(1)
            choice = np.minimum(choice, np.maximum(d - 1, 0))
        else:
            choice = rng.integers(0, np.maximum(d, 1))
        nxt = nbr[cur, choice]
        nxt = np.where(d > 0, nxt, cur)  # self-loop on disconnected
        out[:, t] = nxt
        cur = nxt
    return out


class RandomWalkIterator:
    """Iterator facade over :func:`generate_walks` (reference
    RandomWalkIterator API: next()/hasNext()/reset())."""

    def __init__(
        self,
        graph: Graph,
        walk_length: int,
        seed: int = 12345,
        no_edge_handling: NoEdgeHandling = (
            NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED
        ),
        weighted: bool = False,
    ):
        self.graph = graph
        self.walk_length = walk_length
        self.seed = seed
        self.no_edge_handling = no_edge_handling
        self.weighted = weighted
        self._walks: Optional[np.ndarray] = None
        self._pos = 0

    def _ensure(self):
        if self._walks is None:
            self._walks = generate_walks(
                self.graph, self.walk_length, 1, self.weighted,
                self.no_edge_handling, self.seed,
            )

    def has_next(self) -> bool:
        self._ensure()
        return self._pos < len(self._walks)

    def next(self) -> np.ndarray:
        self._ensure()
        if self._pos >= len(self._walks):
            raise StopIteration
        w = self._walks[self._pos]
        self._pos += 1
        return w

    def reset(self) -> None:
        self._walks = None
        self._pos = 0
        self.seed += 1  # fresh walks per epoch, like re-seeded reference

    def __iter__(self) -> Iterator[np.ndarray]:
        self._ensure()
        while self.has_next():
            yield self.next()


class WeightedRandomWalkIterator(RandomWalkIterator):
    """Transition probability proportional to edge weight (reference
    WeightedRandomWalkIterator)."""

    def __init__(self, graph: Graph, walk_length: int, seed: int = 12345,
                 no_edge_handling: NoEdgeHandling = (
                     NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED
                 )):
        super().__init__(
            graph, walk_length, seed, no_edge_handling, weighted=True
        )
