"""GloVe: co-occurrence counting + weighted least-squares factorization,
on the card.

The port of ``deeplearning4j_tpu/nlp/glove.py`` (a mirror of reference
nlp models/glove/{Glove.java:31, AbstractCoOccurrences,
GloveWeightLookupTable}). Counting is the JAX module's host-side dict
pass (1/distance weighting, symmetric window) for in-RAM corpora, or the
disk-spill counter (``nlp/cooccurrence.py`` DiskBackedCoOccurrences)
when ``max_pairs_in_memory`` is set. Training is the batched AdaGrad
scatter update of :func:`glove_step` on tables that live on the device
and are updated in place: the accumulators take their adds first and
each row's update then reads them (``glove.py:101-108`` of the JAX
package, that order kept). A pass's shuffled triples go up in one copy;
its loss stays a device scalar until the pass ends. The tables' initial
numbers come from a ``torch.Generator`` seeded with ``seed``
(``load_tables`` carries JAX's); the shuffle is the JAX module's numpy
permutation.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.vocab import build_vocab


def glove_step(w, wt, b, bt, gw, gwt, gb, gbt, rows, cols, xij, lr,
               x_max: float, alpha: float):
    """One AdaGrad batch over co-occurrence triples (rows, cols, xij), in
    place on the eight tables; returns the batch's loss (a device
    scalar). ``wi``/``wj`` are read before any write; the accumulators
    are added to before the rows' updates read them."""
    wi = w[rows]
    wj = wt[cols]
    diff = torch.sum(wi * wj, dim=-1) + b[rows] + bt[cols] - torch.log(xij)
    fx = torch.clamp((xij / x_max) ** alpha, max=1.0)
    g = fx * diff                                        # [B]
    loss = 0.5 * torch.mean(fx * diff * diff)
    dwi = g[:, None] * wj
    dwj = g[:, None] * wi
    # AdaGrad accumulators (reference GloveWeightLookupTable's
    # per-element historical gradient)
    gw.index_add_(0, rows, dwi * dwi)
    gwt.index_add_(0, cols, dwj * dwj)
    gb.index_add_(0, rows, g * g)
    gbt.index_add_(0, cols, g * g)
    w.index_add_(0, rows, -lr * dwi / torch.sqrt(gw[rows] + 1e-8))
    wt.index_add_(0, cols, -lr * dwj / torch.sqrt(gwt[cols] + 1e-8))
    b.index_add_(0, rows, -lr * g / torch.sqrt(gb[rows] + 1e-8))
    bt.index_add_(0, cols, -lr * g / torch.sqrt(gbt[cols] + 1e-8))
    return loss


class Glove(SequenceVectors):
    def __init__(
        self,
        layer_size: int = 100,
        window: int = 15,
        learning_rate: float = 0.05,
        min_word_frequency: int = 5,
        epochs: int = 25,
        x_max: float = 100.0,
        alpha: float = 0.75,
        batch_size: int = 65536,
        symmetric: bool = True,
        seed: int = 12345,
        device="cuda",
    ):
        super().__init__(
            layer_size=layer_size,
            window=window,
            learning_rate=learning_rate,
            min_word_frequency=min_word_frequency,
            epochs=epochs,
            batch_size=batch_size,
            seed=seed,
            use_hierarchic_softmax=False,
            device=device,
        )
        self.x_max = x_max
        self.alpha = alpha
        self.symmetric = symmetric

    # ------------------------------------------------------------------
    def _count_cooccurrences(
        self, sequences: Iterable[Sequence[str]]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        counts: Dict[Tuple[int, int], float] = {}
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
                    a, b = center, idxs[j]
                    counts[(a, b)] = counts.get((a, b), 0.0) + w
                    if self.symmetric:
                        counts[(b, a)] = counts.get((b, a), 0.0) + w
        if not counts:
            raise ValueError("Empty co-occurrence matrix")
        ij = np.asarray(list(counts.keys()), np.int32)
        x = np.asarray(list(counts.values()), np.float32)
        return ij[:, 0], ij[:, 1], x

    # ------------------------------------------------------------------
    TABLE_NAMES = ("w", "wt", "b", "bt", "gw", "gwt", "gb", "gbt")

    def init_tables(self) -> None:
        """Allocate factorization tables + AdaGrad accumulators on the
        device so training can proceed incrementally (the distributed
        performer trains co-occurrence shards between table averages)."""
        v, d = self.vocab.num_words(), self.layer_size
        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        self.w = (torch.rand((v, d), generator=gen, device=dev) - 0.5) / d
        self.wt = (torch.rand((v, d), generator=gen, device=dev) - 0.5) / d
        self.b = torch.zeros((v,), device=dev)
        self.bt = torch.zeros((v,), device=dev)
        self.gw = torch.zeros((v, d), device=dev)
        self.gwt = torch.zeros((v, d), device=dev)
        self.gb = torch.zeros((v,), device=dev)
        self.gbt = torch.zeros((v,), device=dev)
        self.losses: List[float] = []
        # fresh shuffle stream: repeated fit() runs stay seed-reproducible
        self._glove_rng = np.random.default_rng(self.seed)

    def load_tables(self, **tables) -> None:
        """Carry tables across by name (``TABLE_NAMES``; JAX's numpy
        arrays, say), each to the device at float32."""
        for name, t in tables.items():
            if name not in self.TABLE_NAMES:
                raise ValueError(f"unknown GloVe table {name!r}")
            setattr(self, name, torch.from_numpy(
                np.array(t, np.float32)).to(self.device))
        self.syn0 = self.w + self.wt

    def train_cooccurrences(self, rows, cols, xij,
                            learning_rate=None) -> float:
        """One shuffled pass over the given co-occurrence triples at a
        fixed lr; returns the pair-weighted mean batch loss over the
        pass — the incremental granularity the distributed
        GlovePerformer dispatches at
        (reference scaleout/perform/models/glove/GlovePerformer.java)."""
        if not hasattr(self, "w"):
            raise ValueError("init_tables() (or fit) must run first")
        lr = float(learning_rate if learning_rate is not None
                   else self.learning_rate)
        rows = np.asarray(rows, np.int32)
        cols = np.asarray(cols, np.int32)
        xij = np.asarray(xij, np.float32)
        if len(rows) == 0:
            return 0.0  # empty shard: no work, a real (non-NaN) loss
        if not hasattr(self, "_glove_rng"):
            self._glove_rng = np.random.default_rng(self.seed)
        order = self._glove_rng.permutation(len(rows))
        dev = self.device
        r = torch.from_numpy(rows[order]).to(dev)
        c = torch.from_numpy(cols[order]).to(dev)
        x = torch.from_numpy(xij[order]).to(dev)
        lr_t = torch.full((), lr, device=dev)
        tables = [getattr(self, n) for n in self.TABLE_NAMES]
        loss_sum = torch.zeros((), device=dev)
        for start in range(0, len(rows), self.batch_size):
            sl = slice(start, start + self.batch_size)
            n = len(rows[sl])
            loss = glove_step(*tables, r[sl], c[sl], x[sl], lr_t,
                              self.x_max, self.alpha)
            loss_sum = loss_sum + loss * n
        # Final embedding = w + wt (standard GloVe practice).
        self.syn0 = self.w + self.wt
        return float(loss_sum) / len(rows)

    def train_cooccurrence_batches(self, batches, learning_rate=None,
                                   shuffle_window: int = 8) -> float:
        """One pass over an iterable of (rows, cols, xij) batches at a
        fixed lr — the disk-streaming counterpart of
        ``train_cooccurrences``: ``shuffle_window`` consecutive batches
        of the merged (sorted) spill stream are buffered and shuffled
        together before their steps. Returns the pair-weighted mean
        loss over the pass."""
        if not hasattr(self, "w"):
            raise ValueError("init_tables() (or fit) must run first")
        loss_weighted_sum = 0.0
        total_pairs = 0
        window: list = []

        def flush():
            nonlocal loss_weighted_sum, total_pairs
            if not window:
                return
            rows = np.concatenate([b[0] for b in window])
            cols = np.concatenate([b[1] for b in window])
            xij = np.concatenate([b[2] for b in window])
            flush_loss = self.train_cooccurrences(
                rows, cols, xij, learning_rate)
            loss_weighted_sum += flush_loss * len(rows)
            total_pairs += len(rows)
            window.clear()

        for batch in batches:
            window.append(batch)
            if len(window) >= shuffle_window:
                flush()
        flush()
        self.syn0 = self.w + self.wt
        return loss_weighted_sum / total_pairs if total_pairs else 0.0

    def fit(
        self,
        sequences_factory,
        max_pairs_in_memory: int | None = None,
        spill_dir: str | None = None,
    ) -> None:
        """``max_pairs_in_memory`` bounds counting memory: co-occurrence
        counts spill to sorted disk shards past that many distinct pairs
        and training streams the k-way merge per epoch (reference
        AbstractCoOccurrences maxMemory knob)."""
        from deeplearning4j_tpu_torch.nlp.cooccurrence import (
            DiskBackedCoOccurrences,
        )

        seqs = (
            sequences_factory()
            if callable(sequences_factory)
            else sequences_factory
        )
        seqs = list(seqs)
        if self.vocab is None:
            self.vocab = build_vocab(seqs, self.min_word_frequency)
        self.init_tables()
        if max_pairs_in_memory is None:
            rows, cols, xij = self._count_cooccurrences(seqs)
            for _ in range(self.epochs):
                self.losses.append(
                    self.train_cooccurrences(rows, cols, xij))
            return
        counter = DiskBackedCoOccurrences(
            self.vocab, window=self.window, symmetric=self.symmetric,
            max_pairs_in_memory=max_pairs_in_memory, spill_dir=spill_dir,
        )
        try:
            counter.count_sequences(seqs)
            if counter.n_shards() == 0:
                raise ValueError("Empty co-occurrence matrix")
            for _ in range(self.epochs):
                self.losses.append(self.train_cooccurrence_batches(
                    counter.iter_batches(self.batch_size)))
        finally:
            counter.cleanup()
