"""Word-level moving-window contexts for window-classification models.

Equivalent of the reference text/movingwindow package
(reference deeplearning4j-scaleout/deeplearning4j-nlp/.../text/movingwindow/
{Window,Windows,WindowConverter,ContextLabelRetriever,Util}.java and
text/inputsanitation/InputHomogenization.java): fixed-size word windows
around each focus word, padded with begin/end markers, converted to dense
example rows by concatenating embedding vectors — producing batches of
one static shape.

A copy of ``deeplearning4j_tpu/nlp/moving_window.py`` (numpy only).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

BEGIN_LABEL = "<{}>"
END_LABEL = "</{}>"
PAD_START = "<s>"
PAD_END = "</s>"
NONE_LABEL = "NONE"


def input_homogenization(sentence: str, preserve_case: bool = False) -> str:
    """Normalize a sentence the way the reference InputHomogenization does:
    strip punctuation/special characters, optionally lower-case."""
    # keep label tags like <LABEL> ... </LABEL> intact (case included)
    parts = re.split(r"(</?[A-Za-z0-9_]+>)", sentence)
    out = []
    for part in parts:
        if re.fullmatch(r"</?[A-Za-z0-9_]+>", part or ""):
            out.append(part)
        else:
            cleaned = re.sub(r"[^\w\s]", "", part)
            out.append(cleaned if preserve_case else cleaned.lower())
    return " ".join(" ".join(out).split())


class Window:
    """One window of words with a focus word in the middle
    (reference movingwindow/Window.java)."""

    def __init__(
        self,
        words: Sequence[str],
        window_size: int,
        median: Optional[int] = None,
        label: str = NONE_LABEL,
    ):
        self.words = list(words)
        self.window_size = window_size
        self.median = len(self.words) // 2 if median is None else median
        self.label = label

    def focus_word(self) -> str:
        return self.words[self.median]

    def as_tokens(self) -> List[str]:
        return list(self.words)

    def __repr__(self) -> str:
        return f"Window({self.words}, focus={self.focus_word()!r}, label={self.label!r})"


def windows(
    sentence_or_tokens,
    window_size: int = 5,
    tokenizer=None,
    label: str = NONE_LABEL,
) -> List[Window]:
    """All windows of ``window_size`` words centred on each token, padded
    with ``<s>``/``</s>`` at the edges (reference movingwindow/Windows.java)."""
    if isinstance(sentence_or_tokens, str):
        if tokenizer is not None:
            tokens = tokenizer.create(sentence_or_tokens).get_tokens()
        else:
            tokens = sentence_or_tokens.split()
    else:
        tokens = list(sentence_or_tokens)
    if not tokens:
        return []
    half = window_size // 2
    padded = [PAD_START] * half + tokens + [PAD_END] * half
    out = []
    for i in range(len(tokens)):
        out.append(Window(padded[i:i + window_size], window_size, label=label))
    return out


def context_label_retriever(sentence: str) -> Tuple[str, List[Tuple[str, str]]]:
    """Split a ``<LABEL> words </LABEL>``-annotated sentence into plain text
    plus (word, label) pairs (reference movingwindow/ContextLabelRetriever.java)."""
    token_re = re.compile(r"<(/?)([A-Za-z0-9_]+)>")
    pairs: List[Tuple[str, str]] = []
    current = NONE_LABEL
    plain: List[str] = []
    for tok in sentence.split():
        m = token_re.fullmatch(tok)
        if m:
            current = NONE_LABEL if m.group(1) else m.group(2)
            continue
        plain.append(tok)
        pairs.append((tok, current))
    return " ".join(plain), pairs


class WindowConverter:
    """Windows → dense example rows using an embedding model as the lookup
    table (reference movingwindow/WindowConverter.java): each example is the
    concatenation of the window's word vectors."""

    @staticmethod
    def as_example_array(window: Window, vec, normalize: bool = False) -> np.ndarray:
        dim = vec.layer_size
        row = np.zeros(dim * window.window_size, dtype=np.float32)
        for i, word in enumerate(window.as_tokens()):
            v = vec.get_word_vector(word)
            if v is None:
                continue
            v = np.asarray(v, dtype=np.float32)
            if normalize:
                n = np.linalg.norm(v)
                if n > 0:
                    v = v / n
            row[i * dim:(i + 1) * dim] = v
        return row

    @staticmethod
    def as_example_matrix(
        windows_list: Sequence[Window], vec, normalize: bool = False
    ) -> np.ndarray:
        if not windows_list:
            return np.zeros((0, 0), dtype=np.float32)
        return np.stack(
            [WindowConverter.as_example_array(w, vec, normalize) for w in windows_list]
        )
