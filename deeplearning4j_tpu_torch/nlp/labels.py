"""Label-aware document iteration for ParagraphVectors-style training.

Equivalent of the reference labelaware iterator stack
(reference deeplearning4j-nlp/.../text/documentiterator/
{LabelAwareIterator,LabelledDocument,LabelsSource,BasicLabelAwareIterator,
FileLabelAwareIterator,FilenamesLabelAwareIterator}.java): documents
paired with stable label strings, with LabelsSource generating and
tracking the label universe so doc-labels can live in the same vocab as
words (PV-DBOW labels-in-vocab).

A copy of ``deeplearning4j_tpu/nlp/labels.py`` (pure Python).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional


class LabelsSource:
    """Generates and stores document labels (reference LabelsSource.java):
    either a fixed template ``DOC_%d`` or user-supplied labels."""

    def __init__(self, template: str = "DOC_%d",
                 labels: Optional[List[str]] = None):
        self.template = template
        self._labels: List[str] = list(labels or [])
        self._counter = 0
        self._fixed = labels is not None

    def next_label(self) -> str:
        if self._fixed:
            if self._counter >= len(self._labels):
                raise IndexError(
                    "LabelsSource exhausted: %d fixed labels but document "
                    "#%d requested one — the corpus has more documents "
                    "than labels (the reference errors here too)"
                    % (len(self._labels), self._counter))
            label = self._labels[self._counter]
        else:
            label = self.template % self._counter
            self._labels.append(label)
        self._counter += 1
        return label

    def get_labels(self) -> List[str]:
        return list(self._labels)

    def store_label(self, label: str) -> None:
        if label not in self._labels:
            self._labels.append(label)

    def reset(self) -> None:
        self._counter = 0
        if not self._fixed:
            self._labels = []


@dataclass
class LabelledDocument:
    """One document + its labels (reference LabelledDocument.java)."""

    content: str
    labels: List[str] = field(default_factory=list)

    @property
    def label(self) -> Optional[str]:
        return self.labels[0] if self.labels else None


class LabelAwareIterator:
    """Iterator of LabelledDocuments (reference LabelAwareIterator.java)."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next_document(self) -> LabelledDocument:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def get_labels_source(self) -> LabelsSource:
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_document()


class BasicLabelAwareIterator(LabelAwareIterator):
    """Wrap a sentence iterator, generating a label per document
    (reference BasicLabelAwareIterator.java Builder)."""

    def __init__(self, sentence_iterator, labels_source: Optional[LabelsSource] = None):
        self.sentences = sentence_iterator
        self.labels_source = labels_source or LabelsSource()

    def has_next(self) -> bool:
        return self.sentences.has_next()

    def next_document(self) -> LabelledDocument:
        content = self.sentences.next_sentence()
        label = getattr(self.sentences, "current_label", None)
        if callable(label):
            lab = label()
            self.labels_source.store_label(lab)
        else:
            lab = self.labels_source.next_label()
        return LabelledDocument(content=content, labels=[lab])

    def reset(self) -> None:
        self.sentences.reset()
        self.labels_source.reset()

    def get_labels_source(self) -> LabelsSource:
        return self.labels_source


class FileLabelAwareIterator(LabelAwareIterator):
    """Directory-per-label corpus layout (reference
    FileLabelAwareIterator.java): ``root/<label>/<doc>.txt`` — each file
    is one document labelled with its parent directory name."""

    def __init__(self, root: str):
        self.root = root
        self.labels_source = LabelsSource(labels=[])
        self._files: List[tuple] = []
        for label in sorted(os.listdir(root)):
            d = os.path.join(root, label)
            if not os.path.isdir(d):
                continue
            self.labels_source.store_label(label)
            for fn in sorted(os.listdir(d)):
                path = os.path.join(d, fn)
                if os.path.isfile(path):
                    self._files.append((label, path))
        self._i = 0

    def has_next(self) -> bool:
        return self._i < len(self._files)

    def next_document(self) -> LabelledDocument:
        label, path = self._files[self._i]
        self._i += 1
        with open(path, encoding="utf-8", errors="replace") as f:
            return LabelledDocument(content=f.read(), labels=[label])

    def reset(self) -> None:
        self._i = 0

    def get_labels_source(self) -> LabelsSource:
        return self.labels_source


class FilenamesLabelAwareIterator(LabelAwareIterator):
    """Flat directory; each file's (base)name is its label (reference
    FilenamesLabelAwareIterator.java)."""

    def __init__(self, root: str, absolute_labels: bool = False):
        self.root = root
        self.labels_source = LabelsSource(labels=[])
        self._files: List[str] = [
            os.path.join(root, fn) for fn in sorted(os.listdir(root))
            if os.path.isfile(os.path.join(root, fn))
        ]
        self.absolute_labels = absolute_labels
        for p in self._files:
            self.labels_source.store_label(self._label_of(p))
        self._i = 0

    def _label_of(self, path: str) -> str:
        return path if self.absolute_labels else os.path.basename(path)

    def has_next(self) -> bool:
        return self._i < len(self._files)

    def next_document(self) -> LabelledDocument:
        path = self._files[self._i]
        self._i += 1
        with open(path, encoding="utf-8", errors="replace") as f:
            return LabelledDocument(content=f.read(),
                                    labels=[self._label_of(path)])

    def reset(self) -> None:
        self._i = 0

    def get_labels_source(self) -> LabelsSource:
        return self.labels_source
