"""Sentence / document iterators.

Parity: reference nlp/text/sentenceiterator/ — `SentenceIterator`
(nextSentence/hasNext/reset + SentencePreProcessor),
CollectionSentenceIterator, FileSentenceIterator (every file under a dir),
LineSentenceIterator, and the label-aware variants used by
ParagraphVectors (LabelAwareSentenceIterator).

Host code: the port's own copy of the JAX package's
`nlp/sentence_iterator.py`, the same behaviour line for line.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, List, Optional, Tuple


class SentenceIterator:
    def __init__(self, pre_processor: Optional[Callable[[str], str]] = None):
        self.pre_processor = pre_processor

    def _prep(self, s: str) -> str:
        return self.pre_processor(s) if self.pre_processor else s

    def next_sentence(self) -> str:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_sentence()


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Iterable[str], **kw):
        super().__init__(**kw)
        self.sentences: List[str] = list(sentences)
        self._pos = 0

    def next_sentence(self) -> str:
        s = self.sentences[self._pos]
        self._pos += 1
        return self._prep(s)

    def has_next(self) -> bool:
        return self._pos < len(self.sentences)

    def reset(self) -> None:
        self._pos = 0


class LineSentenceIterator(SentenceIterator):
    """One sentence per line of a file (reference LineSentenceIterator)."""

    def __init__(self, path: str, **kw):
        super().__init__(**kw)
        self.path = path
        self._file = None

    def reset(self) -> None:
        if self._file:
            self._file.close()
        self._file = open(self.path, "r", encoding="utf-8", errors="replace")
        self._next = self._file.readline()

    def has_next(self) -> bool:
        if self._file is None:
            self.reset()
        return bool(self._next)

    def next_sentence(self) -> str:
        if self._file is None:
            self.reset()
        s, self._next = self._next, self._file.readline()
        return self._prep(s.rstrip("\n"))


class FileSentenceIterator(SentenceIterator):
    """Every line of every file under a directory
    (reference FileSentenceIterator)."""

    def __init__(self, root: str, **kw):
        super().__init__(**kw)
        self.root = root
        self._lines: Optional[List[str]] = None
        self._pos = 0

    def reset(self) -> None:
        lines: List[str] = []
        if os.path.isfile(self.root):
            paths = [self.root]
        else:
            paths = sorted(
                os.path.join(dp, f)
                for dp, _, fs in os.walk(self.root) for f in fs)
        for p in paths:
            with open(p, "r", encoding="utf-8", errors="replace") as f:
                lines.extend(line.rstrip("\n") for line in f)
        self._lines = lines
        self._pos = 0

    def has_next(self) -> bool:
        if self._lines is None:
            self.reset()
        return self._pos < len(self._lines)

    def next_sentence(self) -> str:
        if self._lines is None:
            self.reset()
        s = self._lines[self._pos]
        self._pos += 1
        return self._prep(s)


class LabelAwareSentenceIterator(SentenceIterator):
    """(label, sentence) pairs for ParagraphVectors
    (reference LabelAwareListSentenceIterator)."""

    def __init__(self, pairs: Iterable[Tuple[str, str]], **kw):
        super().__init__(**kw)
        self.pairs: List[Tuple[str, str]] = list(pairs)
        self._pos = 0

    def current_label(self) -> str:
        return self.pairs[max(0, self._pos - 1)][0]

    def next_sentence(self) -> str:
        label, s = self.pairs[self._pos]
        self._pos += 1
        return self._prep(s)

    def has_next(self) -> bool:
        return self._pos < len(self.pairs)

    def reset(self) -> None:
        self._pos = 0
