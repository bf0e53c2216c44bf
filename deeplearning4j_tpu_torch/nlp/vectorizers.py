"""Text vectorizers: bag-of-words + TF-IDF.

Mirror of reference nlp bagofwords/vectorizer/{BagOfWordsVectorizer,
TfidfVectorizer}.java (which back the text-classification pipeline and the
reference's Lucene inverted index statistics).

A copy of ``deeplearning4j_tpu/nlp/vectorizers.py`` over the port's ``datasets``.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, build_vocab


class BaseTextVectorizer:
    def __init__(
        self,
        tokenizer_factory: Optional[TokenizerFactory] = None,
        min_word_frequency: int = 1,
    ):
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.vocab: Optional[VocabCache] = None
        self._doc_freq: Optional[np.ndarray] = None
        self._n_docs = 0

    def _tokenize(self, text: str) -> List[str]:
        return self.tokenizer_factory.create(text).get_tokens()

    def fit(self, texts: Iterable[str]) -> "BaseTextVectorizer":
        token_docs = [self._tokenize(t) for t in texts]
        self.vocab = build_vocab(token_docs, self.min_word_frequency)
        v = self.vocab.num_words()
        df = np.zeros((v,), np.float64)
        for toks in token_docs:
            for i in {self.vocab.index_of(t) for t in toks if self.vocab.contains_word(t)}:
                df[i] += 1
        self._doc_freq = df
        self._n_docs = len(token_docs)
        return self

    def transform(self, texts: Sequence[str]) -> np.ndarray:
        raise NotImplementedError

    def fit_transform(
        self, texts: Sequence[str], labels: Optional[np.ndarray] = None
    ):
        self.fit(texts)
        x = self.transform(texts)
        if labels is None:
            return x
        return DataSet(x, labels)

    def _counts(self, texts: Sequence[str]) -> np.ndarray:
        v = self.vocab.num_words()
        out = np.zeros((len(texts), v), np.float32)
        for r, t in enumerate(texts):
            for tok in self._tokenize(t):
                i = self.vocab.index_of(tok)
                if i >= 0:
                    out[r, i] += 1.0
        return out


class BagOfWordsVectorizer(BaseTextVectorizer):
    def transform(self, texts: Sequence[str]) -> np.ndarray:
        return self._counts(texts)


class TfidfVectorizer(BaseTextVectorizer):
    def transform(self, texts: Sequence[str]) -> np.ndarray:
        tf = self._counts(texts)
        idf = np.log(
            (1.0 + self._n_docs) / (1.0 + self._doc_freq)
        ).astype(np.float32) + 1.0
        return tf * idf[None, :]
