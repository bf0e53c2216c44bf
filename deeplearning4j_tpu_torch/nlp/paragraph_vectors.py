"""ParagraphVectors: document embeddings (PV-DBOW), on the card.

The port of ``deeplearning4j_tpu/nlp/paragraph_vectors.py`` (a mirror
of reference nlp models/paragraphvectors/ParagraphVectors.java):
document labels are added to the vocabulary and trained like words —
the DBOW sequence-learning algorithm (learning/impl/sequence/DBOW.java)
trains the label vector to predict each word of its document through the
same HS/NS objective, so a document's row rides in ``syn0``. Inference
for unseen text trains a fresh vector against the frozen word tables
(:func:`infer_steps`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import (
    assign_huffman_codes,
    build_vocab,
)


def infer_steps(vec, idxs, syn1, syn1neg, codes, points, cmask, neg_table,
                lr0: float, steps: int, use_hs: bool, draws=None):
    """``steps`` updates of a document vector ``vec`` [D] against frozen
    tables for its word indices ``idxs`` [T], at ``lr0 * (1 - s /
    steps)``: the HS path gradient over ``codes``/``points``/``cmask``
    [T, L] when ``use_hs``, and with ``draws`` [steps, T, K] (unigram
    table indices) the negative-sampling gradient. Returns the new
    vector; ``vec`` is not written."""
    for s in range(steps):
        lr = lr0 * (1.0 - s / steps)
        dvec = torch.zeros_like(vec)
        if use_hs:
            w = syn1[points]                                 # [T, L, D]
            dot = torch.einsum("tld,d->tl", w, vec)
            g = (1.0 - codes - torch.sigmoid(dot)) * cmask
            dvec = dvec + torch.einsum("tl,tld->d", g, w)
        if draws is not None:
            pos = syn1neg[idxs]                              # [T, D]
            negs = neg_table[draws[s]]                       # [T, K]
            wneg = syn1neg[negs]                             # [T, K, D]
            g_pos = 1.0 - torch.sigmoid(pos @ vec)
            g_neg = -torch.sigmoid(torch.einsum("tkd,d->tk", wneg, vec))
            g_neg = g_neg * (negs != idxs[:, None]).to(g_neg.dtype)
            dvec = dvec + g_pos @ pos + torch.einsum("tk,tkd->d", g_neg,
                                                     wneg)
        vec = vec + lr * dvec
    return vec


class ParagraphVectors(SequenceVectors):
    LABEL_PREFIX = "DOC_"

    def __init__(self, tokenizer_factory: Optional[TokenizerFactory] = None,
                 **kwargs):
        kwargs.setdefault("min_word_frequency", 1)
        super().__init__(**kwargs)
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.labels: List[str] = []

    # ------------------------------------------------------------------
    def fit_documents(
        self, docs: Sequence[str], labels: Optional[Sequence[str]] = None
    ) -> None:
        if labels is None:
            labels = [f"{self.LABEL_PREFIX}{i}" for i in range(len(docs))]
        self.labels = list(labels)
        token_docs = [
            self.tokenizer_factory.create(d).get_tokens() for d in docs
        ]
        # Vocab over words only; labels appended after (reference adds
        # labels to the vocab with count ~ document length).
        self.vocab = build_vocab(token_docs, self.min_word_frequency)
        for lbl, toks in zip(labels, token_docs):
            self.vocab.add_token(lbl, max(1, len(toks)))
        self.vocab.finalize_indices()
        if self.use_hs:
            assign_huffman_codes(self.vocab)
        self._reset_weights()

        # DBOW pairs: (center=word, context=label) — the label vector
        # learns to predict every word of its document.
        def factory():
            return self._label_sequences(token_docs, labels)

        super().fit(factory)

    def _label_sequences(self, token_docs, labels):
        """Each 'sequence' = (label, kept words): label-word pairs are
        mined explicitly (the DBOW objective), not by the window miner."""
        out = []
        for lbl, toks in zip(labels, token_docs):
            kept = [t for t in toks if self.vocab.contains_word(t)]
            out.append((lbl, kept))
        return out

    # Override pair mining: every (word, label) pair of each doc.
    def _mine_pairs(self, sequences, rng):
        # mixed code lengths per batch: the full padded Huffman slice
        lmax = self._code_lmax if self.use_hs else 0
        centers: List[int] = []
        contexts: List[int] = []
        emitted = 0
        for lbl, toks in sequences:
            li = self.vocab.index_of(lbl)
            if li < 0:
                continue
            for t in toks:
                centers.append(self.vocab.index_of(t))
                contexts.append(li)
                if len(centers) >= self.batch_size:
                    yield (
                        np.asarray(centers, np.int32),
                        np.asarray(contexts, np.int32),
                        lmax,
                        emitted,
                    )
                    emitted += len(centers)
                    centers, contexts = [], []
        if centers:
            yield (
                np.asarray(centers, np.int32),
                np.asarray(contexts, np.int32),
                lmax,
                emitted,
            )

    # ------------------------------------------------------------------
    def doc_vector(self, label: str) -> Optional[np.ndarray]:
        return self.get_word_vector(label)

    def infer_vector(self, text: str, steps: int = 50, lr: float = 0.025,
                     generator: Optional[torch.Generator] = None
                     ) -> np.ndarray:
        """Train a fresh vector for unseen text against frozen tables
        (reference inferVector).

        The initial vector, U(-0.5, 0.5)/D, and the negatives' draws come
        from ``generator`` (a ``torch.Generator`` on the model's device;
        default one seeded with the model's seed). The JAX package seeds
        them from ``hash(text)``, which varies with ``PYTHONHASHSEED``,
        so the two agree only in distribution; :func:`infer_steps` takes
        the initial vector and the draws for an exact comparison."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.seed)
        toks = [
            t
            for t in self.tokenizer_factory.create(text).get_tokens()
            if self.vocab.contains_word(t)
        ]
        d = self.layer_size
        dev = self.device
        vec = (torch.rand((d,), generator=generator, device=dev) - 0.5) / d
        if not toks:
            return vec.cpu().numpy()
        idxs = torch.as_tensor(
            [self.vocab.index_of(t) for t in toks], dtype=torch.int64,
            device=dev)
        t = idxs.shape[0]
        if self.use_hs:
            codes = self._codes[idxs].to(torch.float32)
            points = self._points[idxs]
            cmask = self._code_mask[idxs]
        else:
            codes = torch.zeros((t, 1), device=dev)
            points = torch.zeros((t, 1), dtype=torch.int64, device=dev)
            cmask = torch.zeros((t, 1), device=dev)
        draws = None
        if self.negative > 0:
            draws = torch.randint(0, self._neg_table.shape[0],
                                  (steps, t, self.negative),
                                  generator=generator, device=dev)
        with torch.no_grad():
            vec = infer_steps(vec, idxs, self.syn1, self.syn1neg, codes,
                              points, cmask, self._neg_table, lr, steps,
                              self.use_hs, draws)
        return vec.cpu().numpy()

    def similarity_to_label(self, text: str, label: str) -> float:
        v = self.infer_vector(text)
        u = self.doc_vector(label)
        if u is None:
            return float("nan")
        return float(
            np.dot(v, u)
            / (np.linalg.norm(v) * np.linalg.norm(u) + 1e-12)
        )
