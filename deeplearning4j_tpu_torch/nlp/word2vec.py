"""Word2Vec: skip-gram over sentences.

Mirror of reference nlp models/word2vec/Word2Vec.java:30 (+Builder :68) on
top of the SequenceVectors engine, fed by a SentenceIterator + Tokenizer
(reference SentenceTransformer pipeline).

A copy of ``deeplearning4j_tpu/nlp/word2vec.py`` over the port's
``SequenceVectors`` (which takes ``device``, default ``"cuda"``; the
builder's ``device``).
"""

from __future__ import annotations

from typing import List, Optional

from deeplearning4j_tpu_torch.nlp.sentence_iterator import SentenceIterator
from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)


class Word2Vec(SequenceVectors):
    def __init__(
        self,
        sentence_iterator: Optional[SentenceIterator] = None,
        tokenizer_factory: Optional[TokenizerFactory] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.sentence_iterator = sentence_iterator
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()

    class Builder:
        """Fluent builder (reference Word2Vec.Builder)."""

        def __init__(self):
            self._kw = {}
            self._iter = None
            self._tok = None

        def iterate(self, sentence_iterator) -> "Word2Vec.Builder":
            self._iter = sentence_iterator
            return self

        def tokenizer_factory(self, tf) -> "Word2Vec.Builder":
            self._tok = tf
            return self

        def layer_size(self, n: int) -> "Word2Vec.Builder":
            self._kw["layer_size"] = n
            return self

        def window_size(self, n: int) -> "Word2Vec.Builder":
            self._kw["window"] = n
            return self

        def learning_rate(self, lr: float) -> "Word2Vec.Builder":
            self._kw["learning_rate"] = lr
            return self

        def min_learning_rate(self, lr: float) -> "Word2Vec.Builder":
            self._kw["min_learning_rate"] = lr
            return self

        def min_word_frequency(self, n: int) -> "Word2Vec.Builder":
            self._kw["min_word_frequency"] = n
            return self

        def negative_sample(self, n: int) -> "Word2Vec.Builder":
            self._kw["negative"] = n
            if n > 0:
                self._kw.setdefault("use_hierarchic_softmax", False)
            return self

        def use_hierarchic_softmax(self, flag: bool) -> "Word2Vec.Builder":
            self._kw["use_hierarchic_softmax"] = flag
            return self

        def sampling(self, s: float) -> "Word2Vec.Builder":
            self._kw["subsampling"] = s
            return self

        def epochs(self, n: int) -> "Word2Vec.Builder":
            self._kw["epochs"] = n
            return self

        def batch_size(self, n: int) -> "Word2Vec.Builder":
            self._kw["batch_size"] = n
            return self

        def seed(self, n: int) -> "Word2Vec.Builder":
            self._kw["seed"] = n
            return self

        def device(self, device) -> "Word2Vec.Builder":
            self._kw["device"] = device
            return self

        def build(self) -> "Word2Vec":
            return Word2Vec(self._iter, self._tok, **self._kw)

    # ------------------------------------------------------------------
    def _sentences(self) -> List[List[str]]:
        out = []
        self.sentence_iterator.reset()
        for sentence in self.sentence_iterator:
            tokens = self.tokenizer_factory.create(sentence).get_tokens()
            if tokens:
                out.append(tokens)
        return out

    def fit(self, sequences=None) -> None:
        if sequences is not None:
            super().fit(sequences)
        else:
            if self.sentence_iterator is None:
                raise ValueError("No sentence iterator configured")
            super().fit(self._sentences)
