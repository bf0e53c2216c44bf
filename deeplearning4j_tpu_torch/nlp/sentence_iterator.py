"""Sentence/document iterators.

Mirror of reference nlp text/sentenceiterator/** (BasicLineIterator,
CollectionSentenceIterator, FileSentenceIterator, LineSentenceIterator,
preprocessors, label-aware variants).

A copy of ``deeplearning4j_tpu/nlp/sentence_iterator.py`` (pure Python).
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Iterator, List, Optional


class SentencePreProcessor:
    def pre_process(self, sentence: str) -> str:
        raise NotImplementedError


class SentenceIterator:
    def __init__(self):
        self.preprocessor: Optional[Callable[[str], str]] = None

    def _apply(self, s: str) -> str:
        return self.preprocessor(s) if self.preprocessor else s

    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.has_next():
            yield self.next_sentence()

    def next_sentence(self) -> str:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Iterable[str]):
        super().__init__()
        self._list: List[str] = list(sentences)
        self._i = 0

    def next_sentence(self) -> str:
        s = self._list[self._i]
        self._i += 1
        return self._apply(s)

    def has_next(self) -> bool:
        return self._i < len(self._list)

    def reset(self) -> None:
        self._i = 0


class LineSentenceIterator(SentenceIterator):
    """One sentence per line of a file (reference LineSentenceIterator /
    BasicLineIterator)."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._f = None
        self._next: Optional[str] = None
        self.reset()

    def _advance(self) -> None:
        line = self._f.readline()
        while line and not line.strip():
            line = self._f.readline()
        self._next = line.strip() if line else None

    def next_sentence(self) -> str:
        s = self._next
        self._advance()
        return self._apply(s)

    def has_next(self) -> bool:
        return self._next is not None

    def reset(self) -> None:
        if self._f:
            self._f.close()
        self._f = open(self.path, "r", encoding="utf-8", errors="replace")
        self._advance()


class FileSentenceIterator(SentenceIterator):
    """Every line of every file under a directory (reference
    FileSentenceIterator)."""

    def __init__(self, directory: str):
        super().__init__()
        self.directory = directory
        self.reset()

    def _files(self) -> List[str]:
        out = []
        for root, _, files in os.walk(self.directory):
            for f in sorted(files):
                out.append(os.path.join(root, f))
        return out

    def reset(self) -> None:
        self._lines: List[str] = []
        for path in self._files():
            with open(path, "r", encoding="utf-8", errors="replace") as f:
                self._lines.extend(
                    line.strip() for line in f if line.strip()
                )
        self._i = 0

    def next_sentence(self) -> str:
        s = self._lines[self._i]
        self._i += 1
        return self._apply(s)

    def has_next(self) -> bool:
        return self._i < len(self._lines)


class LabelAwareSentenceIterator(SentenceIterator):
    """Sentence + current label, for ParagraphVectors (reference
    labelaware variants)."""

    def current_label(self) -> str:
        raise NotImplementedError


class LabelledCollectionSentenceIterator(LabelAwareSentenceIterator):
    def __init__(self, sentences: List[str], labels: List[str]):
        super().__init__()
        assert len(sentences) == len(labels)
        self._sentences = sentences
        self._labels = labels
        self._i = 0

    def next_sentence(self) -> str:
        s = self._sentences[self._i]
        self._i += 1
        return self._apply(s)

    def current_label(self) -> str:
        return self._labels[max(0, self._i - 1)]

    def has_next(self) -> bool:
        return self._i < len(self._sentences)

    def reset(self) -> None:
        self._i = 0


class AggregatingSentenceIterator(SentenceIterator):
    """Chain several sentence iterators into one stream (reference
    sentenceiterator/AggregatingSentenceIterator.java)."""

    def __init__(self, *iterators: SentenceIterator):
        super().__init__()
        self._iterators = list(iterators)
        self._cur = 0

    def _advance(self) -> None:
        while (self._cur < len(self._iterators)
               and not self._iterators[self._cur].has_next()):
            self._cur += 1

    def has_next(self) -> bool:
        self._advance()
        return self._cur < len(self._iterators)

    def next_sentence(self) -> str:
        self._advance()
        return self._apply(self._iterators[self._cur].next_sentence())

    def reset(self) -> None:
        for it in self._iterators:
            it.reset()
        self._cur = 0


class StreamLineIterator(SentenceIterator):
    """Sentences from a text stream/file-like object, ``batch_of`` lines
    joined per sentence (reference sentenceiterator/StreamLineIterator.java
    over a DocumentIterator's InputStream)."""

    def __init__(self, stream, batch_of: int = 1):
        super().__init__()
        self._stream = stream
        self.batch_of = max(1, batch_of)
        self._head: Optional[str] = None
        self._advance()

    def _advance(self) -> None:
        """Lazily read the next non-blank line (no full materialization)."""
        for line in self._stream:
            if line.strip():
                self._head = line.rstrip("\n")
                return
        self._head = None

    def has_next(self) -> bool:
        return self._head is not None

    def next_sentence(self) -> str:
        chunk = []
        for _ in range(self.batch_of):
            if self._head is None:
                break
            chunk.append(self._head)
            self._advance()
        return self._apply(" ".join(chunk))

    def reset(self) -> None:
        self._stream.seek(0)
        self._advance()


class PrefetchingSentenceIterator(SentenceIterator):
    """Background-thread prefetch into a bounded queue (reference
    sentenceiterator/PrefetchingSentenceIterator.java): hides tokenizer/IO
    latency from the training loop the way AsyncDataSetIterator hides
    host->device feed latency."""

    def __init__(self, base: SentenceIterator, fetch_size: int = 100):
        super().__init__()
        self.base = base
        self.fetch_size = fetch_size
        self._queue = None
        self._thread = None
        self._stop = None
        self._done = False
        self._start()

    def _start(self) -> None:
        import queue
        import threading

        q = self._queue = queue.Queue(maxsize=self.fetch_size)
        stop = self._stop = threading.Event()
        self._done = False
        sentinel = self._sentinel = object()
        base = self.base

        # The worker binds q/stop/sentinel locally: after reset() swaps in
        # a new queue, a lingering old thread can only touch its own.
        def worker():
            try:
                while base.has_next() and not stop.is_set():
                    s = base.next_sentence()
                    while not stop.is_set():
                        try:
                            q.put(s, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            finally:
                # normal end: block until the consumer makes room; stopped
                # end: best effort only (reset() is draining, nobody waits)
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                else:
                    try:
                        q.put_nowait(sentinel)
                    except queue.Full:
                        pass

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        self._head = None
        self._pull()

    def _pull(self) -> None:
        item = self._queue.get()
        if item is self._sentinel:
            self._head = None
            self._done = True
        else:
            self._head = item

    def has_next(self) -> bool:
        return not self._done

    def next_sentence(self) -> str:
        s = self._head
        self._pull()
        return self._apply(s)

    def reset(self) -> None:
        import queue

        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            # drain so a put()-blocked worker can observe the stop flag
            while self._thread.is_alive():
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    pass
                self._thread.join(timeout=0.05)
        self.base.reset()
        self._start()


class SynchronizedSentenceIterator(SentenceIterator):
    """Lock-guarded wrapper for sharing one iterator across threads
    (reference sentenceiterator/SynchronizedSentenceIterator.java)."""

    def __init__(self, base: SentenceIterator):
        super().__init__()
        import threading

        self.base = base
        self._lock = threading.Lock()

    def has_next(self) -> bool:
        with self._lock:
            return self.base.has_next()

    def next_sentence(self) -> str:
        with self._lock:
            return self._apply(self.base.next_sentence())

    def next_sentence_if_any(self):
        """Atomic has_next+next, the race-free form threads should use."""
        with self._lock:
            if not self.base.has_next():
                return None
            return self._apply(self.base.next_sentence())

    def reset(self) -> None:
        with self._lock:
            self.base.reset()
