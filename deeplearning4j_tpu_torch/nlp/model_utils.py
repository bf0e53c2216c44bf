"""Nearest-neighbor / similarity utilities over trained word vectors.

Equivalent of the reference ModelUtils SPI (reference
deeplearning4j-nlp/.../models/embeddings/reader/impl/
{BasicModelUtils,FlatModelUtils,TreeModelUtils}.java): pluggable
``words_nearest``/``similarity`` strategies over a fitted embedding model
(anything with ``vocab``, ``syn0`` and ``get_word_vector`` — SequenceVectors,
Word2Vec, GloVe, ParagraphVectors).

- BasicModelUtils: cosine similarity with mean-subtraction for multi-word
  positive/negative queries (the king-queen analogy form).
- FlatModelUtils: brute-force over a pre-normalized matrix — one [V,D]@[D]
  matvec, exact.
- TreeModelUtils: VPTree-indexed search — sublinear queries, the structure
  the reference borrows from the UI's nearest-neighbors view.

A copy of ``deeplearning4j_tpu/nlp/model_utils.py`` (numpy only; the VP
tree is the port's copy; ``syn0`` is read through the host).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np


def _syn0(model) -> np.ndarray:
    """The model's ``syn0`` on the host as float64 (a torch tensor on
    any device, or an array)."""
    t = model.syn0
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64)


Query = Union[str, Sequence[str], np.ndarray]


class ModelUtils:
    """``init(model)`` then ``words_nearest``/``similarity``."""

    def __init__(self):
        self.model = None

    def init(self, model) -> "ModelUtils":
        self.model = model
        return self

    # -- shared helpers --------------------------------------------------
    def _vector_of(self, query: Query, exclude: set) -> Optional[np.ndarray]:
        if isinstance(query, str):
            exclude.add(query)
            v = self.model.get_word_vector(query)
            return None if v is None else np.asarray(v, np.float64)
        if isinstance(query, np.ndarray):
            return query.astype(np.float64)
        vecs = []
        for w in query:
            exclude.add(w)
            v = self.model.get_word_vector(w)
            if v is not None:
                vecs.append(np.asarray(v, np.float64))
        return np.mean(vecs, axis=0) if vecs else None

    def similarity(self, a: str, b: str) -> float:
        va = self.model.get_word_vector(a)
        vb = self.model.get_word_vector(b)
        if va is None or vb is None:
            return float("nan")
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        return float(np.dot(va, vb) / denom) if denom else 0.0

    def words_nearest(self, query: Query, top_n: int = 10) -> List[str]:
        raise NotImplementedError


class BasicModelUtils(ModelUtils):
    """Cosine brute force; supports positive/negative word-algebra via
    ``words_nearest(positive, negative, top_n)`` (reference
    BasicModelUtils.wordsNearest)."""

    def words_nearest(self, query: Query, top_n: int = 10,
                      negative: Sequence[str] = ()) -> List[str]:
        exclude: set = set()
        v = self._vector_of(query, exclude)
        if v is None:
            return []
        for w in negative:
            exclude.add(w)
            nv = self.model.get_word_vector(w)
            if nv is not None:
                v = v - np.asarray(nv, np.float64)
        m = _syn0(self.model)
        sims = (m @ v) / (
            np.linalg.norm(m, axis=1) * (np.linalg.norm(v) + 1e-12) + 1e-12)
        out = []
        for i in np.argsort(-sims):
            w = self.model.vocab.word_at_index(int(i))
            if w not in exclude:
                out.append(w)
            if len(out) >= top_n:
                break
        return out


class FlatModelUtils(ModelUtils):
    """Pre-normalized flat matrix: query = one matvec (reference
    FlatModelUtils — "the fastest exact" variant)."""

    def init(self, model) -> "FlatModelUtils":
        super().init(model)
        m = _syn0(model)
        self._norm = m / (np.linalg.norm(m, axis=1, keepdims=True) + 1e-12)
        return self

    def words_nearest(self, query: Query, top_n: int = 10) -> List[str]:
        exclude: set = set()
        v = self._vector_of(query, exclude)
        if v is None:
            return []
        v = v / (np.linalg.norm(v) + 1e-12)
        sims = self._norm @ v
        out = []
        for i in np.argsort(-sims):
            w = self.model.vocab.word_at_index(int(i))
            if w not in exclude:
                out.append(w)
            if len(out) >= top_n:
                break
        return out


class TreeModelUtils(ModelUtils):
    """VPTree-indexed nearest neighbors (reference TreeModelUtils over the
    same VPTree the nearest-neighbors UI uses)."""

    def init(self, model) -> "TreeModelUtils":
        from deeplearning4j_tpu_torch.clustering.vptree import VPTree

        super().init(model)
        self._words = model.vocab.words()
        self._tree = VPTree(_syn0(model),
                            similarity="cosine")
        return self

    def words_nearest(self, query: Query, top_n: int = 10) -> List[str]:
        exclude: set = set()
        v = self._vector_of(query, exclude)
        if v is None:
            return []
        # over-fetch to survive excluded query words
        hits = self._tree.knn(v, min(top_n + len(exclude),
                                     len(self._words)))
        out = [self._words[i] for _, i in hits
               if self._words[i] not in exclude]
        return out[:top_n]
