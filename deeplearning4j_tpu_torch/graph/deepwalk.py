"""DeepWalk: skip-gram embeddings over random walks.

Capability mirror of reference graph models/deepwalk/DeepWalk.java:37 +
GraphHuffman.java (Huffman codes over vertex DEGREES) +
InMemoryGraphLookupTable. Rides the framework's SequenceVectors engine
(nlp/sequence_vectors.py): walks become token sequences of vertex ids, so
the batched hierarchical-softmax update — the replacement for the
reference's per-pair iterateSample loop — is shared with Word2Vec.

A copy of ``deeplearning4j_tpu/graph/deepwalk.py`` over the port's
``SequenceVectors``, on ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.api import Graph, NoEdgeHandling
from deeplearning4j_tpu_torch.graph.walker import generate_walks
from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, assign_huffman_codes


class DeepWalk:
    """Builder-style API mirroring reference DeepWalk.Builder:
    vectorSize/windowSize/learningRate/seed, then
    ``initialize(graph)`` + ``fit(graph, walk_length)``."""

    def __init__(
        self,
        vector_size: int = 100,
        window_size: int = 5,
        learning_rate: float = 0.025,
        walks_per_vertex: int = 10,
        epochs: int = 1,
        weighted_walks: bool = False,
        no_edge_handling: NoEdgeHandling = (
            NoEdgeHandling.SELF_LOOP_ON_DISCONNECTED
        ),
        seed: int = 12345,
        batch_size: int = 2048,
        device="cuda",
    ):
        self.vector_size = vector_size
        self.window_size = window_size
        self.learning_rate = learning_rate
        self.walks_per_vertex = walks_per_vertex
        self.epochs = epochs
        self.weighted_walks = weighted_walks
        self.no_edge_handling = no_edge_handling
        self.seed = seed
        self.batch_size = batch_size
        self.device = device
        self._sv: Optional[SequenceVectors] = None
        self._graph: Optional[Graph] = None

    # ------------------------------------------------------------------
    def initialize(self, graph: Graph) -> None:
        """Build the degree-weighted Huffman vocab (reference
        GraphHuffman: code lengths follow vertex degree, so hub vertices
        get short paths) and init weights."""
        self._graph = graph
        sv = SequenceVectors(
            layer_size=self.vector_size,
            window=self.window_size,
            learning_rate=self.learning_rate,
            min_word_frequency=0,
            subsampling=0.0,  # every vertex matters; no frequency cut
            epochs=1,  # epoch loop is ours (fresh walks each epoch)
            batch_size=self.batch_size,
            seed=self.seed,
            device=self.device,
        )
        vocab = VocabCache()
        deg = graph.degrees()
        for i in range(graph.num_vertices()):
            vocab.add_token(str(i), count=max(1, int(deg[i])))
        vocab.finalize_indices()
        assign_huffman_codes(vocab)
        sv.vocab = vocab
        sv._reset_weights()
        self._sv = sv

    def fit(self, graph: Optional[Graph] = None, walk_length: int = 40):
        if graph is not None and self._graph is not graph:
            self.initialize(graph)
        if self._sv is None:
            raise RuntimeError("call initialize(graph) first")
        g = self._graph
        for epoch in range(self.epochs):
            walks = generate_walks(
                g, walk_length, self.walks_per_vertex,
                self.weighted_walks, self.no_edge_handling,
                self.seed + epoch,
            )
            seqs = [[str(int(v)) for v in walk] for walk in walks]
            self._sv.fit(seqs)
        return self

    # ------------------------------------------------------------------
    # GraphVectors API (reference models/GraphVectors.java)
    # ------------------------------------------------------------------
    def get_vertex_vector(self, idx: int) -> np.ndarray:
        return self._sv.get_word_vector(str(idx))

    def similarity(self, a: int, b: int) -> float:
        return self._sv.similarity(str(a), str(b))

    def verts_nearest(self, idx: int, top_n: int = 10) -> List[int]:
        return [int(w) for w in self._sv.words_nearest(str(idx), top_n)]

    def num_vertices(self) -> int:
        return self._graph.num_vertices() if self._graph else 0

    # -- serde (reference models/loader/GraphVectorSerializer) ----------
    def save_vectors(self, path: str) -> None:
        from deeplearning4j_tpu_torch.nlp.serializer import write_word_vectors

        write_word_vectors(self._sv, path)
