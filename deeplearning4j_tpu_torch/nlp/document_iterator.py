"""Document iterators + moving-window context.

Mirror of reference text/documentiterator (DocumentIterator,
FileDocumentIterator, label-aware variants) and text/movingwindow
(Window/Windows — fixed-size context windows with edge padding, the
input representation for windowed classifiers like the MNER example).

A copy of ``deeplearning4j_tpu/nlp/document_iterator.py`` (pure Python).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence

PAD = "<PAD>"


class DocumentIterator:
    """Stream of documents (raw strings); resettable."""

    def next_document(self) -> Optional[str]:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.has_next():
            doc = self.next_document()
            if doc is None:
                return
            yield doc


class CollectionDocumentIterator(DocumentIterator):
    def __init__(self, docs: Sequence[str]):
        self._docs = list(docs)
        self._pos = 0

    def next_document(self) -> Optional[str]:
        if self._pos >= len(self._docs):
            return None
        doc = self._docs[self._pos]
        self._pos += 1
        return doc

    def has_next(self) -> bool:
        return self._pos < len(self._docs)

    def reset(self) -> None:
        self._pos = 0


class FileDocumentIterator(DocumentIterator):
    """One document per file under a directory tree (reference
    FileDocumentIterator)."""

    def __init__(self, root: str, extensions: Sequence[str] = (".txt",)):
        self.paths: List[str] = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fn in sorted(files):
                if os.path.splitext(fn)[1].lower() in extensions:
                    self.paths.append(os.path.join(dirpath, fn))
        self._pos = 0

    def next_document(self) -> Optional[str]:
        if self._pos >= len(self.paths):
            return None
        path = self.paths[self._pos]
        self._pos += 1
        with open(path, encoding="utf-8", errors="replace") as f:
            return f.read()

    def has_next(self) -> bool:
        return self._pos < len(self.paths)

    def reset(self) -> None:
        self._pos = 0


class LabelAwareDocumentIterator(CollectionDocumentIterator):
    """Documents with labels (reference LabelAwareDocumentIterator —
    feeds ParagraphVectors supervised training)."""

    def __init__(self, docs: Sequence[str], labels: Sequence[str]):
        if len(docs) != len(labels):
            raise ValueError("docs/labels length mismatch")
        super().__init__(docs)
        self.labels = list(labels)

    def current_label(self) -> str:
        """Label of the most recently returned document."""
        if self._pos == 0:
            raise RuntimeError("no document returned yet")
        return self.labels[self._pos - 1]


# ---------------------------------------------------------------------------
# moving-window context (reference text/movingwindow/Window(s).java)
# ---------------------------------------------------------------------------

class Window:
    """A fixed-size token window with a focus position."""

    def __init__(self, tokens: Sequence[str], focus: int,
                 label: Optional[str] = None):
        self.tokens = list(tokens)
        self.focus = focus
        self.label = label

    def focus_word(self) -> str:
        return self.tokens[self.focus]

    def __repr__(self) -> str:
        marked = [f"[{t}]" if i == self.focus else t
                  for i, t in enumerate(self.tokens)]
        return "Window(" + " ".join(marked) + ")"


def windows(tokens: Sequence[str], window_size: int = 5,
            label: Optional[str] = None) -> List[Window]:
    """One window per token, PAD-extended at the edges (reference
    Windows.windows: every word becomes the focus of a size-k window)."""
    if window_size % 2 == 0 or window_size < 1:
        raise ValueError("window_size must be odd and positive")
    half = window_size // 2
    padded = [PAD] * half + list(tokens) + [PAD] * half
    return [
        Window(padded[i:i + window_size], half, label)
        for i in range(len(tokens))
    ]
