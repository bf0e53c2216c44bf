"""Graph loaders: delimited edge lists, optionally weighted.

Capability mirror of reference graph data/{GraphLoader,
impl/DelimitedEdgeLineProcessor, impl/WeightedEdgeLineProcessor,
impl/DelimitedVertexLoader}.java.

A copy of ``deeplearning4j_tpu/graph/loader.py`` (pure Python).
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.graph.api import Graph


class ParseException(Exception):
    pass


def load_undirected_graph(
    path: str, n_vertices: int, delimiter: str = ",",
) -> Graph:
    """Edge list "from<delim>to" per line (reference
    GraphLoader.loadUndirectedGraphEdgeListFile)."""
    g = Graph(n_vertices)
    with open(path) as f:
        for ln, line in enumerate(f):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(delimiter)
            if len(parts) != 2:
                raise ParseException(f"line {ln}: expected 2 fields: {line!r}")
            g.add_edge(int(parts[0]), int(parts[1]))
    return g


def load_weighted_edge_list(
    path: str,
    n_vertices: int,
    delimiter: str = ",",
    directed: bool = False,
) -> Graph:
    """Edge list "from<delim>to<delim>weight" (reference
    WeightedEdgeLineProcessor)."""
    g = Graph(n_vertices)
    with open(path) as f:
        for ln, line in enumerate(f):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(delimiter)
            if len(parts) != 3:
                raise ParseException(f"line {ln}: expected 3 fields: {line!r}")
            g.add_edge(
                int(parts[0]), int(parts[1]), float(parts[2]), directed
            )
    return g


def load_vertex_values(path: str, delimiter: Optional[str] = None):
    """"idx<delim>value" per line -> list of values ordered by idx
    (reference DelimitedVertexLoader)."""
    pairs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            idx, val = line.split(delimiter or ",", 1)
            pairs.append((int(idx), val))
    pairs.sort()
    return [v for _, v in pairs]
