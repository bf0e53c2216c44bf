"""Vocabulary: VocabWord, cache, constructor, Huffman coding.

Mirror of reference nlp models/word2vec/{VocabWord,Huffman}.java,
models/word2vec/wordstore/inmemory/InMemoryLookupCache.java and
models/sequencevectors' VocabConstructor. The Huffman tree assigns each
word a binary code + inner-node path for hierarchical softmax; codes are
padded into fixed [V, max_code_len] arrays so the HS loss is one dense
batched computation (no per-word Java object walks).

A copy of ``deeplearning4j_tpu/nlp/vocab.py`` (numpy only): its Huffman
codes and their tie-breaking are the JAX package's, since the
hierarchical-softmax tables are indexed by them.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import Counter
from typing import Dict, Iterable, List, Optional

import numpy as np


@dataclasses.dataclass
class VocabWord:
    word: str
    count: int = 1
    index: int = -1
    # Hierarchical-softmax coding (reference VocabWord codes/points).
    codes: List[int] = dataclasses.field(default_factory=list)
    points: List[int] = dataclasses.field(default_factory=list)


class VocabCache:
    """Word <-> index/count store (reference InMemoryLookupCache)."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []

    def add_token(self, word: str, count: int = 1) -> VocabWord:
        vw = self._words.get(word)
        if vw is None:
            vw = VocabWord(word=word, count=0)
            self._words[word] = vw
        vw.count += count
        return vw

    def finalize_indices(self) -> None:
        """Assign indices by descending frequency (reference behavior)."""
        self._by_index = sorted(
            self._words.values(), key=lambda w: (-w.count, w.word)
        )
        for i, vw in enumerate(self._by_index):
            vw.index = i

    def contains_word(self, word: str) -> bool:
        return word in self._words

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return -1 if vw is None else vw.index

    def word_at_index(self, index: int) -> str:
        return self._by_index[index].word

    def num_words(self) -> int:
        return len(self._words)

    def total_word_occurrences(self) -> int:
        return sum(w.count for w in self._words.values())

    def vocab_words(self) -> List[VocabWord]:
        return list(self._by_index)

    def words(self) -> List[str]:
        return [w.word for w in self._by_index]


def build_vocab(
    token_streams: Iterable[List[str]],
    min_word_frequency: int = 5,
) -> VocabCache:
    """Scan a corpus once counting tokens (reference VocabConstructor)."""
    counts: Counter = Counter()
    for tokens in token_streams:
        counts.update(tokens)
    cache = VocabCache()
    for word, c in counts.items():
        if c >= min_word_frequency:
            cache.add_token(word, c)
    cache.finalize_indices()
    return cache


def assign_huffman_codes(cache: VocabCache) -> None:
    """Build the Huffman tree over word frequencies and assign each word
    its binary code + inner-node path (reference Huffman.java)."""
    words = cache.vocab_words()
    if not words:
        return
    if len(words) == 1:
        words[0].codes = [0]
        words[0].points = [0]
        return
    heap: list = []
    for i, vw in enumerate(words):
        heapq.heappush(heap, (vw.count, i, ("leaf", i)))
    next_inner = 0
    nodes = {}  # inner id -> (left, right)
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        nid = next_inner
        next_inner += 1
        nodes[nid] = (n1, n2)
        heapq.heappush(heap, (c1 + c2, len(words) + nid, ("inner", nid)))
    _, _, root = heap[0]

    # Iterative walk to dodge recursion limits for big vocabularies.
    stack = [(root, [], [])]
    while stack:
        node, code, path = stack.pop()
        kind, idx = node
        if kind == "leaf":
            words[idx].codes = code
            words[idx].points = path
            continue
        left, right = nodes[idx]
        stack.append((left, code + [0], path + [idx]))
        stack.append((right, code + [1], path + [idx]))


def huffman_arrays(cache: VocabCache):
    """Pack codes/points into dense padded arrays for the batched HS loss:
    returns (codes [V, L], points [V, L], mask [V, L]) with L = max code
    length; points index the syn1 inner-node table."""
    words = cache.vocab_words()
    if not words:
        return (np.zeros((0, 1), np.int32),) * 3
    max_len = max(len(w.codes) for w in words)
    v = len(words)
    codes = np.zeros((v, max_len), np.int32)
    points = np.zeros((v, max_len), np.int32)
    mask = np.zeros((v, max_len), np.float32)
    for w in words:
        n = len(w.codes)
        codes[w.index, :n] = w.codes
        points[w.index, :n] = w.points
        mask[w.index, :n] = 1.0
    return codes, points, mask


def unigram_table_probs(cache: VocabCache, power: float = 0.75) -> np.ndarray:
    """Negative-sampling distribution ~ count^0.75 (reference
    InMemoryLookupTable's negative table, as probabilities instead of the
    100M-slot sampling array)."""
    counts = np.array([w.count for w in cache.vocab_words()], np.float64)
    p = counts**power
    return (p / p.sum()).astype(np.float32)
