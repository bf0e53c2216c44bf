"""Bounded-memory co-occurrence counting with binary spill shards.

Mirror of reference models/glove/AbstractCoOccurrences.java: the
reference counts into an in-memory CountMap while a ShadowCopyThread
dumps it to a binary spill file whenever the memory threshold is crossed
(:51 memory_threshold, :53 shadowThread, ShadowCopyThread.run), merging
successive dumps so corpora larger than RAM can be counted; the final
pair stream is read back from the merged file (:135 iterator()).

Here the same design is synchronous and explicit: counts accumulate in a
dict keyed by (row, col); when the dict exceeds ``max_pairs_in_memory``
it is flushed to a sorted .npy shard; ``iter_batches`` k-way-merges the
shards (heapq over mmap-backed chunk readers, summing duplicate keys)
and yields bounded-size (rows, cols, weights) batches — so peak memory
is O(max_pairs_in_memory + batch), never O(distinct pairs).

A copy of ``deeplearning4j_tpu/nlp/cooccurrence.py`` (numpy only).
"""

from __future__ import annotations

import heapq
import os
import shutil
import tempfile
from typing import Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np

_CHUNK = 1 << 16


class DiskBackedCoOccurrences:
    """Co-occurrence counter spilling to disk shards.

    ``max_pairs_in_memory`` bounds the distinct (row, col) pairs held in
    the in-memory map at once — the analogue of the reference's
    ``maxMemory`` builder knob (AbstractCoOccurrences.java:224).
    """

    def __init__(
        self,
        vocab,
        window: int = 15,
        symmetric: bool = True,
        max_pairs_in_memory: int = 1 << 22,
        spill_dir: Optional[str] = None,
    ):
        if max_pairs_in_memory < 1:
            raise ValueError("max_pairs_in_memory must be >= 1")
        self.vocab = vocab
        self.window = window
        self.symmetric = symmetric
        self.max_pairs = int(max_pairs_in_memory)
        self._own_dir = spill_dir is None
        self.spill_dir = spill_dir or tempfile.mkdtemp(prefix="dl4j_cooc_")
        os.makedirs(self.spill_dir, exist_ok=True)
        self._counts: Dict[int, float] = {}  # key = row * V + col
        self._shards = []
        self._n_spills = 0

    # -- counting ------------------------------------------------------
    def count_sequences(self, sequences: Iterable[Sequence[str]]) -> None:
        v = self.vocab.num_words()
        counts = self._counts
        for tokens in sequences:
            idxs = [
                self.vocab.index_of(t)
                for t in tokens
                if self.vocab.contains_word(t)
            ]
            for pos, center in enumerate(idxs):
                for off in range(1, self.window + 1):
                    j = pos + off
                    if j >= len(idxs):
                        break
                    w = 1.0 / off
                    other = idxs[j]
                    k = center * v + other
                    counts[k] = counts.get(k, 0.0) + w
                    if self.symmetric:
                        k2 = other * v + center
                        counts[k2] = counts.get(k2, 0.0) + w
            if len(counts) > self.max_pairs:
                self._spill()

    def _spill(self) -> None:
        if not self._counts:
            return
        keys = np.fromiter(self._counts.keys(), np.int64,
                           count=len(self._counts))
        vals = np.fromiter(self._counts.values(), np.float64,
                           count=len(self._counts))
        order = np.argsort(keys, kind="stable")
        path = os.path.join(self.spill_dir, f"shard{self._n_spills:05d}")
        np.save(path + ".keys.npy", keys[order])
        np.save(path + ".vals.npy", vals[order])
        self._shards.append(path)
        self._n_spills += 1
        # clear() (not reassignment): count_sequences holds a local
        # alias to this dict across spills.
        self._counts.clear()

    # -- merged streaming ---------------------------------------------
    @staticmethod
    def _shard_iter(path: str) -> Iterator[Tuple[int, float]]:
        keys = np.load(path + ".keys.npy", mmap_mode="r")
        vals = np.load(path + ".vals.npy", mmap_mode="r")
        for start in range(0, len(keys), _CHUNK):
            kc = np.asarray(keys[start:start + _CHUNK])
            vc = np.asarray(vals[start:start + _CHUNK])
            yield from zip(kc.tolist(), vc.tolist())

    def iter_batches(
        self, batch_size: int = 65536
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """K-way merge of the spill shards, duplicate keys summed,
        yielding (rows, cols, weights) batches in key order."""
        self._spill()  # flush the in-memory remainder
        if not self._shards:
            return
        v = self.vocab.num_words()
        merged = heapq.merge(*(self._shard_iter(p) for p in self._shards))
        rows: list = []
        cols: list = []
        vals: list = []
        cur_key, cur_val = None, 0.0

        def emit(k, val):
            rows.append(k // v)
            cols.append(k % v)
            vals.append(val)

        for k, val in merged:
            if k == cur_key:
                cur_val += val
                continue
            if cur_key is not None:
                emit(cur_key, cur_val)
                if len(rows) >= batch_size:
                    yield (np.asarray(rows, np.int32),
                           np.asarray(cols, np.int32),
                           np.asarray(vals, np.float32))
                    rows, cols, vals = [], [], []
            cur_key, cur_val = k, val
        if cur_key is not None:
            emit(cur_key, cur_val)
        if rows:
            yield (np.asarray(rows, np.int32),
                   np.asarray(cols, np.int32),
                   np.asarray(vals, np.float32))

    def n_shards(self) -> int:
        return len(self._shards) + (1 if self._counts else 0)

    def cleanup(self) -> None:
        if self._own_dir and os.path.isdir(self.spill_dir):
            shutil.rmtree(self.spill_dir, ignore_errors=True)
        self._shards = []
        self._counts = {}
