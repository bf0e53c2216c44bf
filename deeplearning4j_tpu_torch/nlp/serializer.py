"""Word-vector serialization: text + Google word2vec binary formats.

Mirror of reference nlp models/embeddings/loader/WordVectorSerializer.java
(writeWordVectors text format; loadGoogleModel binary compat).

A copy of ``deeplearning4j_tpu/nlp/serializer.py``: the same vectors give
the same bytes in both packages, and each reads the other's files. The
loaders take ``device`` (default ``"cuda"``) for the returned model's
tables.
"""

from __future__ import annotations

import struct
from typing import TextIO

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


def _host(syn0) -> np.ndarray:
    if isinstance(syn0, torch.Tensor):
        return syn0.detach().cpu().numpy()
    return np.asarray(syn0)


def write_word_vectors(vectors: SequenceVectors, path: str) -> None:
    """Text format: one `word v1 v2 ... vD` line per word (reference
    writeWordVectors)."""
    syn0 = _host(vectors.syn0)
    with open(path, "w", encoding="utf-8") as f:
        for vw in vectors.vocab.vocab_words():
            vec = " ".join(f"{x:.6g}" for x in syn0[vw.index])
            f.write(f"{vw.word} {vec}\n")


def load_txt_vectors(path: str, device="cuda") -> SequenceVectors:
    words = []
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(" ")
            if len(parts) < 2:
                continue
            words.append(parts[0])
            rows.append([float(x) for x in parts[1:]])
    return _assemble(words, np.asarray(rows, np.float32), device)


def write_google_binary(vectors: SequenceVectors, path: str) -> None:
    """Google word2vec binary format: header `V D\\n`, then per word:
    `word `, D float32s (reference loadGoogleModel's inverse)."""
    syn0 = _host(vectors.syn0).astype(np.float32, copy=False)
    v, d = syn0.shape
    with open(path, "wb") as f:
        f.write(f"{v} {d}\n".encode())
        for vw in vectors.vocab.vocab_words():
            f.write(vw.word.encode("utf-8") + b" ")
            f.write(syn0[vw.index].astype("<f4").tobytes())
            f.write(b"\n")


def load_google_binary(path: str, device="cuda") -> SequenceVectors:
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").strip().split()
        v, d = int(header[0]), int(header[1])
        words = []
        rows = np.empty((v, d), np.float32)
        for i in range(v):
            chars = []
            while True:
                ch = f.read(1)
                if ch == b" " or ch == b"":
                    break
                if ch != b"\n":
                    chars.append(ch)
            words.append(b"".join(chars).decode("utf-8"))
            rows[i] = np.frombuffer(f.read(4 * d), dtype="<f4")
            nl = f.read(1)
            if nl not in (b"\n", b""):
                f.seek(-1, 1)
    return _assemble(words, rows, device)


def _assemble(words, syn0: np.ndarray, device) -> SequenceVectors:
    sv = SequenceVectors(layer_size=syn0.shape[1], min_word_frequency=1,
                         device=device)
    cache = VocabCache()
    for w in words:
        cache.add_token(w, 1)
    # Preserve file order as index order.
    cache._by_index = [cache._words[w] for w in words]
    for i, vw in enumerate(cache._by_index):
        vw.index = i
    sv.vocab = cache
    sv.syn0 = torch.as_tensor(syn0).to(sv.device)
    return sv
