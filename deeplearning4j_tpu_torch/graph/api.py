"""Graph API: vertices, edges, adjacency graph.

Capability mirror of reference deeplearning4j-graph api/{IGraph,Vertex,
Edge,NoEdgeHandling}.java + graph/Graph.java (adjacency-list store).
The adjacency is ALSO materialized as padded numpy arrays
(``neighbor_table``) so random-walk generation can run vectorized over
all walkers at once instead of the reference's per-vertex object walk.

A copy of ``deeplearning4j_tpu/graph/api.py`` (numpy only).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Generic, List, Optional, Sequence, Tuple, TypeVar

import numpy as np

V = TypeVar("V")


class NoEdgeHandling(enum.Enum):
    SELF_LOOP_ON_DISCONNECTED = "SELF_LOOP_ON_DISCONNECTED"
    EXCEPTION_ON_DISCONNECTED = "EXCEPTION_ON_DISCONNECTED"


class NoEdgesException(Exception):
    pass


@dataclass
class Vertex(Generic[V]):
    idx: int
    value: Optional[V] = None


@dataclass
class Edge:
    frm: int
    to: int
    weight: float = 1.0
    directed: bool = False


class Graph:
    """Adjacency-list graph over integer-indexed vertices (reference
    graph/Graph.java)."""

    def __init__(
        self,
        n_vertices: int,
        allow_multiple_edges: bool = True,
        vertex_values: Optional[Sequence[Any]] = None,
    ):
        self._n = n_vertices
        self.allow_multiple_edges = allow_multiple_edges
        self.vertices = [
            Vertex(i, vertex_values[i] if vertex_values else None)
            for i in range(n_vertices)
        ]
        self._adj: List[List[Tuple[int, float]]] = [
            [] for _ in range(n_vertices)
        ]
        self._edges: List[Edge] = []
        self._table_dirty = True
        self._nbr_table: Optional[np.ndarray] = None
        self._wgt_table: Optional[np.ndarray] = None
        self._degrees: Optional[np.ndarray] = None

    # -- construction ---------------------------------------------------
    def add_edge(
        self, frm: int, to: int, weight: float = 1.0, directed: bool = False
    ) -> None:
        if not (0 <= frm < self._n and 0 <= to < self._n):
            raise IndexError(f"edge ({frm},{to}) out of range 0..{self._n}")
        if not self.allow_multiple_edges and any(
            t == to for t, _ in self._adj[frm]
        ):
            return
        self._edges.append(Edge(frm, to, weight, directed))
        self._adj[frm].append((to, weight))
        if not directed:
            self._adj[to].append((frm, weight))
        self._table_dirty = True

    # -- queries --------------------------------------------------------
    def num_vertices(self) -> int:
        return self._n

    def num_edges(self) -> int:
        return len(self._edges)

    def get_vertex(self, idx: int) -> Vertex:
        return self.vertices[idx]

    def get_connected_vertex_indices(self, idx: int) -> List[int]:
        return [t for t, _ in self._adj[idx]]

    def get_vertex_degree(self, idx: int) -> int:
        return len(self._adj[idx])

    def degrees(self) -> np.ndarray:
        self._build_tables()
        return self._degrees

    # -- vectorized adjacency ------------------------------------------
    def _build_tables(self) -> None:
        if not self._table_dirty:
            return
        deg = np.array([len(a) for a in self._adj], np.int64)
        max_deg = max(1, int(deg.max(initial=0)))
        nbr = np.zeros((self._n, max_deg), np.int64)
        wgt = np.zeros((self._n, max_deg), np.float64)
        for i, a in enumerate(self._adj):
            for j, (t, w) in enumerate(a):
                nbr[i, j] = t
                wgt[i, j] = w
        self._nbr_table, self._wgt_table, self._degrees = nbr, wgt, deg
        self._table_dirty = False

    def neighbor_table(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(neighbors [N, max_deg], weights [N, max_deg], degrees [N]) —
        the padded arrays all vectorized walkers index into."""
        self._build_tables()
        return self._nbr_table, self._wgt_table, self._degrees
