"""SequenceVectors: the generic embedding training engine, on the card.

The port of ``deeplearning4j_tpu/nlp/sequence_vectors.py``, itself a
mirror of reference nlp models/sequencevectors/SequenceVectors.java (fit
:100-176), the learning-algorithm SPI (ElementsLearningAlgorithm ->
SkipGram, learning/impl/elements/SkipGram.java) and the
InMemoryLookupTable hot loop (iterateSample).

As in the JAX package, the reference's Hogwild threads become batched
synchronous updates: each epoch mines (center, context) index pairs on
the host (the C++ miner of ``native_rt/lib.py``, numpy as its plain
version, with the same draws), and a batch's skip-gram update is one
gather -> dense HS/NS loss -> scatter-add over the tables ``syn0``,
``syn1`` and ``syn1neg``, which live on the device and are updated in
place. Every gather of a step reads the tables before any of its writes,
and every scatter is ``index_add_``, so duplicate indices sum as JAX's
``.at[].add`` does.

Where JAX scans ``_DISPATCH_CHUNK`` batches in one executable, the port
runs a chunk of that many batches as one CUDA graph, captured once per
chunk shape (objective, batches, batch size, code-length slice) in
:attr:`SequenceVectors.graphs`; the tables are the graph's static
inputs. A class's tail chunk (fewer batches) runs the same body eagerly,
never padded: extra batches would change what is trained. A window of
staged chunks (indices and learning rates) goes up in one copy on a copy
stream. Negative-sampling draws come from a device generator registered
with the graphs, so they match JAX's only in distribution; the step
functions :func:`hs_batch` and :func:`ns_batch` take every input,
negatives' raw draws included, so the tests feed them JAX's. Losses stay
device scalars until read (``pass_losses``): nothing in a window waits
for the device.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nlp.vocab import (
    VocabCache,
    assign_huffman_codes,
    build_vocab,
    huffman_arrays,
    unigram_table_probs,
)
from deeplearning4j_tpu_torch.nn.cuda_graphs import GraphRunner

#: the exp-table range of the reference: updates whose logit falls
#: outside it are skipped (the brake that keeps batched scatter-adds on
#: hot rows finite; the JAX module explains the measurements)
MAX_EXP = 6.0


def hs_batch(syn0, syn1, codes, points, cmask, centers, contexts, lr):
    """One hierarchical-softmax skip-gram batch, in place on ``syn0`` and
    ``syn1``; returns the batch's mean loss (a device scalar).

    ``codes``/``points``/``cmask`` are the Huffman tables sliced to the
    batch's code-length class, ``centers``/``contexts`` [B] indices, ``lr``
    a scalar tensor. The context word's vector is trained against the
    center's Huffman path (word2vec's skip-gram)."""
    h = syn0[contexts]                                   # [B, D]
    pts = points[centers]                                # [B, L]
    cds = codes[centers].to(torch.float32)
    msk = cmask[centers]
    w = syn1[pts]                                        # [B, L, D]
    dot = torch.einsum("bld,bd->bl", w, h)
    g = (1.0 - cds - torch.sigmoid(dot)) * msk
    g = g * (dot.abs() < MAX_EXP)
    dh = torch.einsum("bl,bld->bd", g, w)
    dw = torch.einsum("bl,bd->bld", g, h)
    syn0.index_add_(0, contexts, lr * dh)
    syn1.index_add_(0, pts.reshape(-1), (lr * dw).reshape(-1, dw.shape[-1]))
    return -torch.sum(
        torch.log(torch.sigmoid(torch.where(cds > 0, -dot, dot)) + 1e-10)
        * msk) / max(1, centers.shape[0])


def ns_batch(syn0, syn1neg, neg_table, centers, contexts, lr, draws):
    """One negative-sampling skip-gram batch, in place on ``syn0`` and
    ``syn1neg``; returns the batch's mean loss (a device scalar).
    ``draws`` [B, K] index the unigram table (the negatives are
    ``neg_table[draws]``); a negative equal to its center is skipped, as
    the reference's iterateSample skips it."""
    h = syn0[contexts]                                   # [B, D]
    pos = syn1neg[centers]                               # [B, D]
    negs = neg_table[draws]                              # [B, K]
    wneg = syn1neg[negs]                                 # [B, K, D]
    dot_pos = torch.sum(pos * h, dim=-1)
    dot_neg = torch.einsum("bkd,bd->bk", wneg, h)
    g_pos = (1.0 - torch.sigmoid(dot_pos)) * (dot_pos.abs() < MAX_EXP)
    g_neg = -torch.sigmoid(dot_neg) * (dot_neg.abs() < MAX_EXP)
    g_neg = g_neg * (negs != centers[:, None]).to(g_neg.dtype)
    dh = g_pos[:, None] * pos + torch.einsum("bk,bkd->bd", g_neg, wneg)
    syn0.index_add_(0, contexts, lr * dh)
    syn1neg.index_add_(0, centers, lr * g_pos[:, None] * h)
    syn1neg.index_add_(0, negs.reshape(-1),
                       (lr * (g_neg[..., None] * h[:, None, :]))
                       .reshape(-1, h.shape[-1]))
    return -(torch.sum(torch.log(torch.sigmoid(dot_pos) + 1e-10))
             + torch.sum(torch.log(torch.sigmoid(-dot_neg) + 1e-10))
             ) / max(1, centers.shape[0])


class SequenceVectors:
    """Trains element embeddings over an iterable of token sequences, on
    ``device`` (default ``"cuda"``; pass ``device="cpu"`` off the card)."""

    def __init__(
        self,
        layer_size: int = 100,
        window: int = 5,
        learning_rate: float = 0.025,
        min_learning_rate: float = 1e-4,
        negative: int = 0,
        use_hierarchic_softmax: bool = True,
        min_word_frequency: int = 5,
        subsampling: float = 0.0,  # reference default: disabled (SequenceVectors.java:206)
        epochs: int = 1,
        batch_size: int = 4096,
        seed: int = 12345,
        device="cuda",
    ):
        self.layer_size = layer_size
        self.window = window
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.negative = negative
        self.use_hs = use_hierarchic_softmax
        self.min_word_frequency = min_word_frequency
        self.subsampling = subsampling
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.device = resolve_device(device)

        self.vocab: Optional[VocabCache] = None
        self.syn0: Optional[torch.Tensor] = None  # [V, D] word vectors
        self.syn1: Optional[torch.Tensor] = None  # [V, D] HS inner nodes
        self.syn1neg: Optional[torch.Tensor] = None  # [V, D] NS contexts
        self._native_vocab = None  # C++ tokenizer hash (lazy)
        self._native_vocab_tried = False
        #: the negative-sampling draws (seeded from ``seed``), registered
        #: with every captured chunk so a replay draws fresh numbers
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.seed + 1)
        #: one captured chunk per (objective, S, B, l_max)
        self.graphs = GraphRunner(generators=(self._gen,))
        #: each pass's mean batch loss per objective, device scalars
        #: (``pass_losses`` reads them); each chunk's of the last pass,
        #: with its key, in training order
        self._pass_losses: List[dict] = []
        self.chunk_losses: List[tuple] = []

    # ------------------------------------------------------------------
    # Vocab + weights
    # ------------------------------------------------------------------
    def build_vocab_from(self, sequences: Iterable[Sequence[str]]) -> None:
        self.vocab = build_vocab(
            (s.split() if isinstance(s, str) else s for s in sequences),
            self.min_word_frequency)
        if self.use_hs:
            assign_huffman_codes(self.vocab)
        self._native_vocab = None  # rebuilt lazily for the new vocab
        self._native_vocab_tried = False
        self._reset_weights()

    def _reset_weights(self) -> None:
        v = self.vocab.num_words()
        d = self.layer_size
        dev = self.device
        # captured chunks read the old tables and Huffman arrays
        self.graphs.drop()
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        # syn0 ~ U(-0.5, 0.5)/D (reference InMemoryLookupTable.resetWeights);
        # the numbers are torch's, not JAX's (load_tables carries JAX's)
        self.syn0 = (torch.rand((v, d), generator=gen, device=dev) - 0.5) / d
        self.syn1 = torch.zeros((v, d), device=dev)
        self.syn1neg = torch.zeros((v, d), device=dev)
        if self.use_hs:
            codes, points, mask = huffman_arrays(self.vocab)
            self._codes = torch.as_tensor(codes, device=dev)
            self._points = torch.as_tensor(points, device=dev)
            self._code_mask = torch.as_tensor(mask, device=dev)
            # host copies for the mining path
            self._code_len_np = mask.sum(axis=1)
            self._code_lmax = int(codes.shape[1])
        # Negative sampling draws from a precomputed unigram table
        # (reference InMemoryLookupTable's table): slot i holds the word
        # whose cumulative p^0.75 mass covers fraction i/tsize.
        probs = np.asarray(unigram_table_probs(self.vocab), np.float64)
        tsize = int(min(2 ** 24, max(2 ** 20, 16 * v)))
        cum = np.cumsum(probs / probs.sum())
        self._neg_table = torch.as_tensor(np.searchsorted(
            cum, (np.arange(tsize) + 0.5) / tsize).astype(np.int32),
            device=dev)

    def load_tables(self, syn0, syn1=None, syn1neg=None) -> None:
        """Carry tables across (JAX's numpy arrays, say): each given
        table replaces the current one on the device, at float32."""
        self.graphs.drop()
        for name, t in (("syn0", syn0), ("syn1", syn1),
                        ("syn1neg", syn1neg)):
            if t is not None:
                setattr(self, name, torch.from_numpy(
                    np.array(t, np.float32)).to(self.device))

    # ------------------------------------------------------------------
    # Pair mining (host side; the JAX module's code and draws)
    # ------------------------------------------------------------------
    def _keep_probs(self) -> np.ndarray:
        """Frequent-word subsampling keep-probability per vocab index
        (word2vec formula, reference iterateSample's sampling branch)."""
        total = max(1, self.vocab.total_word_occurrences())
        counts = np.array(
            [w.count for w in self.vocab.vocab_words()], np.float64
        )
        if self.subsampling <= 0:
            return np.ones_like(counts)
        f = counts / total
        keep = (np.sqrt(f / self.subsampling) + 1) * self.subsampling / f
        return np.minimum(1.0, keep)

    def _tokenize_corpus(self, sequences: Iterable[Sequence[str]]):
        """Corpus -> (flat vocab-index array, sequence-id array): the C++
        vocab-hash tokenizer over one newline-joined buffer, or the dict
        lookup below (the same arrays). Sequences are token lists
        (whitespace-free tokens) or whitespace-separated strings."""
        from deeplearning4j_tpu_torch.native_rt.lib import NativeVocab

        if self._native_vocab is None and self._native_vocab_tried is False:
            self._native_vocab_tried = True
            words = self.vocab.vocab_words()
            self._native_vocab = NativeVocab.create(
                [w.word for w in words],
                np.asarray([w.index for w in words], np.int32))
        if self._native_vocab is not None:
            if not isinstance(sequences, (list, tuple)):
                sequences = list(sequences)
            text = "\n".join(
                s.replace("\n", " ") if isinstance(s, str)
                else " ".join(s)
                for s in sequences)
            out = self._native_vocab.tokenize(text.encode("utf-8"))
            if out is not None:
                return out
        word_to_idx = {
            w.word: w.index for w in self.vocab.vocab_words()
        }
        flat_parts: List[np.ndarray] = []
        seq_parts: List[np.ndarray] = []
        for sid, tokens in enumerate(sequences):
            if isinstance(tokens, str):
                tokens = tokens.split()
            idxs = [word_to_idx[t] for t in tokens if t in word_to_idx]
            if idxs:
                arr = np.asarray(idxs, np.int32)
                flat_parts.append(arr)
                seq_parts.append(np.full(len(arr), sid, np.int32))
        if not flat_parts:
            return np.empty(0, np.int32), np.empty(0, np.int32)
        return np.concatenate(flat_parts), np.concatenate(seq_parts)

    def _mine_pairs(
        self, sequences: Iterable[Sequence[str]], rng: np.random.Generator
    ):
        flat, seq_id = self._tokenize_corpus(sequences)
        yield from self._mine_pairs_from_ids(flat, seq_id, rng)

    def _mine_pairs_from_ids(
        self, flat: np.ndarray, seq_id: np.ndarray,
        rng: np.random.Generator,
    ):
        """Yield (center_idx, context_idx) int32 arrays in batches, with
        frequent-word subsampling and the word2vec per-center random
        window shrink: the C++ miner, or the vectorized numpy below with
        the same semantics."""
        if len(flat) == 0:
            return
        keep_prob = self._keep_probs()
        from deeplearning4j_tpu_torch.native_rt.lib import (
            mine_pairs as _native,
            native_available,
        )

        kp_tok = keep_prob[flat]
        if native_available():
            native = _native(
                flat, seq_id, self.window,
                kp_tok.astype(np.float32) if self.subsampling > 0 else None,
                int(rng.integers(2 ** 63)))
            if native is not None:
                centers, contexts = native
                if len(centers) == 0:
                    return
                yield from self._pad_and_batch(centers, contexts, rng)
                return
        keep = rng.random(len(flat)) < kp_tok
        flat, seq_id = flat[keep], seq_id[keep]
        if len(flat) == 0:
            return
        b = rng.integers(1, self.window + 1, size=len(flat))
        cen_parts: List[np.ndarray] = []
        ctx_parts: List[np.ndarray] = []
        for d in range(1, self.window + 1):
            if d >= len(flat):
                break
            same = seq_id[:-d] == seq_id[d:]
            m1 = same & (d <= b[:-d])
            m2 = same & (d <= b[d:])
            cen_parts.append(flat[:-d][m1])
            ctx_parts.append(flat[d:][m1])
            cen_parts.append(flat[d:][m2])
            ctx_parts.append(flat[:-d][m2])
        if not cen_parts:
            return
        centers = np.concatenate(cen_parts)
        contexts = np.concatenate(ctx_parts)
        if len(centers) == 0:
            return
        order = rng.permutation(len(centers))
        centers, contexts = centers[order], contexts[order]
        yield from self._pad_and_batch(centers, contexts, rng)

    # Short-path class bound: centers whose Huffman code fits in this
    # many levels run through a step sliced to [:, :L].
    _HS_SHORT_LEN = 8

    def _pad_and_batch(self, centers, contexts, rng):
        """Pad each class's tail to a full batch by resampling its pairs
        (one batch shape a class) and yield (centers, contexts, l_max,
        pair_offset): l_max is the Huffman slice of the HS step (0 with
        HS off), pair_offset the batch's position in the pre-split
        shuffled order, which the lr anneal reads."""
        total = len(centers)
        if self.use_hs:
            short = self._code_len_np[centers] <= self._HS_SHORT_LEN
            splits = [
                (centers[short], contexts[short],
                 min(self._HS_SHORT_LEN, self._code_lmax)),
                (centers[~short], contexts[~short], self._code_lmax),
            ]
        else:
            splits = [(centers, contexts, 0)]
        for cen, ctx, lmax in splits:
            n = len(cen)
            if n == 0:
                continue
            rem = n % self.batch_size
            if rem and n > self.batch_size:
                extra = rng.integers(0, n, size=self.batch_size - rem)
                cen = np.concatenate([cen, cen[extra]])
                ctx = np.concatenate([ctx, ctx[extra]])
            n_batches = max(1, len(cen) // self.batch_size)
            for j, s in enumerate(range(0, len(cen), self.batch_size)):
                offset = int((j + 0.5) / n_batches * total)
                yield (
                    cen[s:s + self.batch_size],
                    ctx[s:s + self.batch_size],
                    lmax,
                    offset,
                )

    # ------------------------------------------------------------------
    # Chunks of batched skip-gram updates
    # ------------------------------------------------------------------
    def _hs_tables(self, l_max: Optional[int]):
        codes, points, cmask = self._codes, self._points, self._code_mask
        if l_max is not None and l_max < codes.shape[1]:
            codes = codes[:, :l_max]
            points = points[:, :l_max]
            cmask = cmask[:, :l_max]
        return codes, points, cmask

    def hs_chunk(self, centers, contexts, lrs, l_max=None, tables=None):
        """``len(lrs)`` HS batches in order (centers/contexts [S, B]) on
        ``tables`` (syn0, syn1; default the model's), in place; returns
        the chunk's mean batch loss."""
        syn0, syn1 = tables or (self.syn0, self.syn1)
        codes, points, cmask = self._hs_tables(l_max)
        loss = torch.zeros((), device=syn0.device)
        for s in range(centers.shape[0]):
            loss = loss + hs_batch(syn0, syn1, codes, points, cmask,
                                   centers[s], contexts[s], lrs[s])
        return loss / centers.shape[0]

    def ns_chunk(self, centers, contexts, lrs, draws=None, tables=None):
        """``len(lrs)`` NS batches in order on ``tables`` (syn0,
        syn1neg; default the model's), in place; ``draws`` [S, B, K]
        index the unigram table, or None to draw them from the model's
        generator. Returns the chunk's mean batch loss."""
        syn0, syn1neg = tables or (self.syn0, self.syn1neg)
        loss = torch.zeros((), device=syn0.device)
        s_n, b = centers.shape
        for s in range(s_n):
            if draws is None:
                d = torch.randint(0, self._neg_table.shape[0],
                                  (b, self.negative), generator=self._gen,
                                  device=syn0.device)
            else:
                d = draws[s]
            loss = loss + ns_batch(syn0, syn1neg, self._neg_table,
                                   centers[s], contexts[s], lrs[s], d)
        return loss / s_n

    def _run_chunk(self, kind: str, cen, ctx, lrs, l_max):
        """One staged chunk: a full chunk replays its captured graph (or
        runs eagerly on the CPU), a tail chunk runs eagerly. Returns the
        chunk's mean loss as a device scalar the next replay does not
        overwrite."""
        s, b = cen.shape
        if kind == "hs":
            names = ("syn0", "syn1")

            def body(o):
                return {"loss": self.hs_chunk(o["cen"], o["ctx"], o["lrs"],
                                              l_max,
                                              (o["syn0"], o["syn1"]))}
        else:
            names = ("syn0", "syn1neg")

            def body(o):
                return {"loss": self.ns_chunk(o["cen"], o["ctx"], o["lrs"],
                                              None,
                                              (o["syn0"], o["syn1neg"]))}
        ops = {"cen": cen, "ctx": ctx, "lrs": lrs}
        ops.update((n, getattr(self, n)) for n in names)
        if s < self._DISPATCH_CHUNK:
            return body(ops)["loss"]
        key = (kind, s, b, l_max)
        if key not in self.graphs:
            # the graph keeps its first inputs as its static buffers: give
            # it its own, not views of the staged window
            ops.update(cen=cen.clone(), ctx=ctx.clone(), lrs=lrs.clone())
        return self.graphs.run(key, body, ops)["loss"].clone()

    # ------------------------------------------------------------------
    def fit(self, sequences_factory) -> None:
        """Train. ``sequences_factory`` is a zero-arg callable returning a
        fresh iterable of token sequences (one pass per epoch), or a list.
        """
        if not self.use_hs and self.negative <= 0:
            raise ValueError(
                "No training objective: enable hierarchical softmax "
                "(use_hierarchic_softmax=True) and/or negative sampling "
                "(negative > 0)"
            )
        if self.vocab is None:
            seqs = (
                sequences_factory()
                if callable(sequences_factory)
                else sequences_factory
            )
            self.build_vocab_from(seqs)
        rng = np.random.default_rng(self.seed)
        pairs_done = 0
        # Rough anneal denominator: total occurrences * window * epochs.
        denom = max(
            1,
            self.vocab.total_word_occurrences() * self.window * self.epochs,
        )

        def annealed_lrs(pair_offsets):
            fracs = np.asarray(pair_offsets, np.float64) / denom
            return np.maximum(
                self.min_learning_rate,
                self.learning_rate * (1.0 - np.minimum(1.0, fracs)),
            ).astype(np.float32)

        # Tokenize once and reuse the id corpus across epochs when the
        # corpus is a materialized iterable and _mine_pairs is not
        # overridden (ParagraphVectors mines from the sequences).
        plain_miner = type(self)._mine_pairs is SequenceVectors._mine_pairs
        id_corpus = None
        for epoch in range(self.epochs):
            if id_corpus is not None:
                batches = self._mine_pairs_from_ids(*id_corpus, rng)
            else:
                seqs = (
                    sequences_factory()
                    if callable(sequences_factory)
                    else sequences_factory
                )
                if plain_miner and not callable(sequences_factory):
                    id_corpus = self._tokenize_corpus(seqs)
                    batches = self._mine_pairs_from_ids(*id_corpus, rng)
                else:
                    batches = self._mine_pairs(seqs, rng)
            pairs_done = self._dispatch_chunks(batches, annealed_lrs,
                                               pairs_done)
        self._pairs_trained = pairs_done

    # batches a chunk (one captured graph)
    _DISPATCH_CHUNK = 64
    # chunks staged and uploaded together before their compute
    _STAGE_WINDOW = 128

    def _dispatch_chunks(self, batches, lr_fn, pairs_done=0) -> int:
        """Group mined batches into chunks of ``_DISPATCH_CHUNK`` per
        (batch size, l_max), upload them a window at a time and train
        them; ``lr_fn(pair_offsets)`` maps each batch's pair offset
        (pre-split epoch position + prior passes) to its learning rate.
        Returns the updated pair count. Chunk order is mining order, so
        the pairs a run trains are reproducible.

        The tables are copied once a pass on the device and put back in
        place if anything raises (a failed capture, Ctrl-C), so the model
        stays readable at its pass-entry state and the captured graphs
        keep their inputs."""
        names = [n for n in ("syn0", "syn1", "syn1neg")
                 if getattr(self, n) is not None]
        self.chunk_losses = []
        backup = [getattr(self, n).clone() for n in names]
        sums = {"hs": torch.zeros((), device=self.device),
                "ns": torch.zeros((), device=self.device)}
        try:
            pairs_done, n_batches = self._dispatch_chunks_inner(
                batches, lr_fn, pairs_done, sums)
        except BaseException:
            for n, b in zip(names, backup):
                getattr(self, n).copy_(b)
            raise
        self._pass_losses.append({
            k: v / max(1, n_batches) for k, v in sums.items()
            if (k == "hs" and self.use_hs) or (k == "ns" and self.negative)})
        return pairs_done

    def _dispatch_chunks_inner(self, batches, lr_fn, pairs_done, sums):
        chunk = self._DISPATCH_CHUNK
        pass_base = pairs_done
        n_batches = 0

        def stage(group, lmax):
            offsets = pass_base + np.asarray(
                [off for _, _, off in group], np.float64)
            return (np.stack([c for c, _, _ in group]).astype(np.int32),
                    np.stack([x for _, x, _ in group]).astype(np.int32),
                    lr_fn(offsets), lmax)

        def run(staged, pairs_done):
            nonlocal n_batches
            for cen, ctx, lrs, lmax in self._upload(staged):
                s, b = cen.shape
                if self.use_hs:
                    loss = self._run_chunk("hs", cen, ctx, lrs, lmax)
                    sums["hs"] += loss * s
                    self.chunk_losses.append((("hs", s, b, lmax), loss))
                if self.negative > 0:
                    loss = self._run_chunk("ns", cen, ctx, lrs, lmax)
                    sums["ns"] += loss * s
                    self.chunk_losses.append((("ns", s, b, lmax), loss))
                pairs_done += s * b
                n_batches += s
            return pairs_done

        staged = []
        pending: dict = {}
        for c, x, lmax, offset in batches:
            buf = pending.setdefault((len(c), lmax), [])
            buf.append((c, x, offset))
            if len(buf) >= chunk:
                staged.append(stage(buf, lmax))
                pending[(len(c), lmax)] = []
                if len(staged) >= self._STAGE_WINDOW:
                    pairs_done = run(staged, pairs_done)
                    staged = []
        for (_, lmax), buf in pending.items():
            if buf:
                staged.append(stage(buf, lmax))
        return run(staged, pairs_done), n_batches

    def _upload(self, staged):
        """A window's chunks on the device: every chunk's centers,
        contexts and learning rates (their float32 bits) packed into one
        int32 host buffer that goes up in one copy, on a copy stream on
        the card (pinned memory; the current stream waits on an event,
        the host does not). Yields (centers [S, B], contexts [S, B], lrs
        [S], l_max) views of it."""
        parts = []
        for cen, ctx, lrs, _ in staged:
            parts += [cen.reshape(-1), ctx.reshape(-1), lrs.view(np.int32)]
        if not parts:
            return
        on_card = self.device.type == "cuda"
        host = torch.empty(sum(len(p) for p in parts), dtype=torch.int32,
                           pin_memory=on_card)
        np.concatenate(parts, out=host.numpy())
        if on_card:
            stream = getattr(self, "_copy_stream", None)
            if stream is None:
                stream = self._copy_stream = torch.cuda.Stream(
                    device=self.device)
            with torch.cuda.stream(stream):
                dev = host.to(self.device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            dev.record_stream(current)
        else:
            dev = host
        o = 0
        for cen, ctx, lrs, lmax in staged:
            s, b = cen.shape
            c = dev[o:o + s * b].view(s, b)
            o += s * b
            x = dev[o:o + s * b].view(s, b)
            o += s * b
            lr = dev[o:o + s].view(torch.float32)
            o += s
            yield c, x, lr, lmax

    @property
    def pass_losses(self) -> List[dict]:
        """Each training pass's mean batch loss per objective (``"hs"``,
        ``"ns"``) as floats; reading them waits for the device."""
        return [{k: float(v) for k, v in d.items()}
                for d in self._pass_losses]

    def train_sequences(self, sequences, learning_rate=None) -> int:
        """One incremental pass over the given token sequences at a fixed
        learning rate — the ``trainSentence`` granularity the param-server
        performers dispatch at (reference scaleout/perform/.../
        Word2VecPerformer.java:232), vs ``fit``'s full annealed epochs.
        Returns the number of (center, context) pairs trained. Its
        negatives come from the model's one generator."""
        if self.vocab is None:
            raise ValueError("build_vocab_from must run before training")
        lr = float(learning_rate if learning_rate is not None
                   else self.learning_rate)
        if not hasattr(self, "_stream_rng"):
            self._stream_rng = np.random.default_rng(self.seed + 7)
        return self._dispatch_chunks(
            self._mine_pairs(sequences, self._stream_rng),
            lambda offsets: np.full((len(offsets),), lr, np.float32),
        )

    # ------------------------------------------------------------------
    # WordVectors API (reference wordvectors/WordVectors.java)
    # ------------------------------------------------------------------
    def syn0_numpy(self) -> np.ndarray:
        """``syn0`` on the host as float32."""
        return self.syn0.detach().float().cpu().numpy()

    def get_word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        if i < 0:
            return None
        return self.syn0[i].detach().float().cpu().numpy()

    def has_word(self, word: str) -> bool:
        return self.vocab is not None and self.vocab.contains_word(word)

    def similarity(self, a: str, b: str) -> float:
        va, vb = self.get_word_vector(a), self.get_word_vector(b)
        if va is None or vb is None:
            return float("nan")
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        if denom == 0:
            return 0.0
        return float(np.dot(va, vb) / denom)

    def words_nearest(self, word_or_vec, top_n: int = 10) -> List[str]:
        if isinstance(word_or_vec, str):
            v = self.get_word_vector(word_or_vec)
            exclude = {word_or_vec}
            if v is None:
                return []
        else:
            v = np.asarray(word_or_vec)
            exclude = set()
        m = self.syn0_numpy()
        norms = np.linalg.norm(m, axis=1) * (np.linalg.norm(v) + 1e-12)
        sims = m @ v / np.maximum(norms, 1e-12)
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.vocab.word_at_index(int(i))
            if w in exclude:
                continue
            out.append(w)
            if len(out) >= top_n:
                break
        return out
