"""Document iteration + inverted index.

Parity: reference nlp text pipeline —
- `DocumentIterator` (text/documentiterator/DocumentIterator.java:28-48:
  nextDocument/hasNext/reset over input streams), `FileDocumentIterator`
  (FileDocumentIterator.java — recurse a root dir, one doc per file),
  `LabelAwareDocumentIterator` (currentLabel from the parent directory).
- `InvertedIndex` (text/invertedindex/InvertedIndex.java:34-160: word↔doc
  index with addWordsToDoc/document/documents/numDocuments/allDocs/
  batchIter/miniBatches + frequency subsampling) whose reference
  implementation is Lucene-backed (LuceneInvertedIndex.java, 927 LoC:
  Lucene Directory + IndexReader storing the word list per doc, and a
  mini-batch builder that subsamples frequent words with the word2vec
  `(sqrt(f/(sample*N)) + 1) * sample*N/f` keep-probability,
  LuceneInvertedIndex.java:517-535).

Design: no Lucene, no external index server. Documents are
token-index arrays packed into ONE contiguous int32 buffer with offsets
(the same flat layout the Word2Vec pair-miner and RNTN tree encoder use),
postings are plain int32 arrays per word — the whole index is
numpy-mmap-friendly and batches lower straight onto the device. Sampling
uses explicit numpy RNG (seeded, reproducible) instead of the reference's
racy shared-queue mini-batch thread.

Host code: the port's own copy of the JAX package's
`nlp/documents.py`, the same behaviour line for line.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nlp.vocab import VocabCache

__all__ = [
    "DocumentIterator",
    "FileDocumentIterator",
    "LabelAwareDocumentIterator",
    "InvertedIndex",
]


class DocumentIterator:
    """Iterate whole documents (reference DocumentIterator.java:28-48).

    Where the reference yields `InputStream`s, this yields `str` — the
    framework is host-side Python and every consumer immediately read and
    decoded the stream anyway."""

    def next_document(self) -> str:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.has_next():
            yield self.next_document()


class FileDocumentIterator(DocumentIterator):
    """One document per file under a root directory, recursively
    (reference FileDocumentIterator.java)."""

    def __init__(self, root: str, encoding: str = "utf-8"):
        if not os.path.isdir(root):
            raise ValueError(f"not a directory: {root}")
        self.root = root
        self.encoding = encoding
        self._paths = self._scan()
        self._pos = 0

    def _scan(self) -> List[str]:
        out = []
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for name in sorted(filenames):
                out.append(os.path.join(dirpath, name))
        out.sort()
        return out

    def next_document(self) -> str:
        if not self.has_next():
            raise StopIteration
        path = self._paths[self._pos]
        self._pos += 1
        with open(path, encoding=self.encoding, errors="replace") as f:
            return f.read()

    def has_next(self) -> bool:
        return self._pos < len(self._paths)

    def reset(self) -> None:
        self._pos = 0


class LabelAwareDocumentIterator(FileDocumentIterator):
    """FileDocumentIterator that exposes the current document's label as
    its parent directory name (reference LabelAwareDocumentIterator —
    the imdb/20news-style directory-per-class corpus layout)."""

    def __init__(self, root: str, encoding: str = "utf-8"):
        super().__init__(root, encoding)
        self._current_label: Optional[str] = None

    def next_document(self) -> str:
        path = self._paths[self._pos]  # peek before advancing
        doc = super().next_document()
        self._current_label = os.path.basename(os.path.dirname(path))
        return doc

    def current_label(self) -> Optional[str]:
        return self._current_label


class InvertedIndex:
    """In-memory word↔document index with subsampled mini-batching
    (reference InvertedIndex.java contract / LuceneInvertedIndex.java
    implementation).

    Documents are stored as one flat int32 token buffer + offsets;
    postings (word → doc ids) are built lazily and cached as int32
    arrays. `sample` is the word2vec-style subsampling threshold used by
    `mini_batches` (reference LuceneInvertedIndex.java:521-527)."""

    def __init__(self, cache: Optional[VocabCache] = None,
                 sample: float = 0.0, seed: int = 0):
        self.cache = cache or VocabCache()
        self._sample = float(sample)
        self._rng = np.random.RandomState(seed)
        self._tokens: List[np.ndarray] = []  # per-doc token-index arrays
        self._labels: Dict[int, List[str]] = {}
        self._postings: Optional[Dict[int, np.ndarray]] = None

    # ------------------------------------------------------------- build
    def _invalidate(self) -> None:
        self._postings = None

    def add_words_to_doc(self, doc: int, words: Sequence[str],
                         label: Optional[str] = None) -> None:
        """reference addWordsToDoc :124 (+label overload :150). Words not
        in the vocab cache are added with frequency counts."""
        idx = np.empty(len(words), dtype=np.int32)
        for i, w in enumerate(words):
            self.cache.add_token(w)  # creates on first sight, counts always
            idx[i] = self.cache.add_word_to_index(w)
        while doc >= len(self._tokens):
            self._tokens.append(np.empty(0, dtype=np.int32))
        self._tokens[doc] = np.concatenate([self._tokens[doc], idx])
        if label is not None:
            self.add_label_for_doc(doc, label)
        self._invalidate()

    def add_label_for_doc(self, doc: int, label: str) -> None:
        self._labels.setdefault(doc, [])
        if label not in self._labels[doc]:
            self._labels[doc].append(label)

    # ------------------------------------------------------------- reads
    def num_documents(self) -> int:
        return len(self._tokens)

    def all_docs(self) -> np.ndarray:
        """reference allDocs — every document id."""
        return np.arange(len(self._tokens), dtype=np.int32)

    def document(self, index: int) -> List[str]:
        """Words of one document (reference document :74)."""
        return [self.cache.word_at(int(i))
                for i in self._tokens[index]]

    def document_indices(self, index: int) -> np.ndarray:
        """Device-friendly variant: the raw int32 token-index array."""
        return self._tokens[index]

    def document_with_label(self, index: int) -> Tuple[List[str], Optional[str]]:
        labels = self._labels.get(index, [])
        return self.document(index), (labels[0] if labels else None)

    def document_with_labels(self, index: int) -> Tuple[List[str], List[str]]:
        return self.document(index), list(self._labels.get(index, []))

    def documents(self, word: str) -> np.ndarray:
        """Doc ids containing `word` (reference documents :98)."""
        if self._postings is None:
            postings: Dict[int, list] = {}
            for doc, toks in enumerate(self._tokens):
                for w in np.unique(toks):
                    postings.setdefault(int(w), []).append(doc)
            self._postings = {w: np.asarray(d, dtype=np.int32)
                              for w, d in postings.items()}
        widx = self.cache.index_of(word)
        return self._postings.get(widx, np.empty(0, dtype=np.int32))

    def sample(self) -> float:
        """Subsampling threshold (reference sample :62)."""
        return self._sample

    # ------------------------------------------------------------ batches
    def docs(self) -> Iterator[List[str]]:
        """Iterate documents as word lists (reference docs :45)."""
        for i in range(len(self._tokens)):
            yield self.document(i)

    def batch_iter(self, batch_size: int) -> Iterator[List[List[str]]]:
        """Iterate documents in batches (reference batchIter :40)."""
        batch: List[List[str]] = []
        for doc in self.docs():
            batch.append(doc)
            if len(batch) >= batch_size:
                yield batch
                batch = []
        if batch:
            yield batch

    def _keep_prob(self, counts: np.ndarray) -> np.ndarray:
        """Word2vec subsampling keep-probability per token (reference
        LuceneInvertedIndex.java:521-527: `(sqrt(f/(sample*N)) + 1) *
        sample*N/f`, clipped to [0, 1])."""
        n = max(1, self.num_documents())
        thresh = self._sample * n
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = (np.sqrt(counts / thresh) + 1.0) * thresh / counts
        return np.clip(np.nan_to_num(ratio, nan=1.0, posinf=1.0), 0.0, 1.0)

    def mini_batches(self, batch_size: int = 128) -> Iterator[List[str]]:
        """Subsampled word mini-batches for embedding training (reference
        miniBatches :68 + the builder at LuceneInvertedIndex.java:507-540).
        Frequent words are dropped with the word2vec subsampling formula
        when `sample > 0`; with sample == 0 every token passes."""
        counts = np.asarray(
            [self.cache.word_frequency(self.cache.word_at(i))
             for i in range(self.cache.num_words())], dtype=np.float64)
        batch: List[str] = []
        for toks in self._tokens:
            if len(toks) == 0:
                continue
            if self._sample > 0:
                keep = self._keep_prob(counts[toks])
                mask = self._rng.random_sample(len(toks)) < keep
                kept = toks[mask]
            else:
                kept = toks
            for widx in kept:
                batch.append(self.cache.word_at(int(widx)))
                if len(batch) >= batch_size:
                    yield batch
                    batch = []
        if batch:
            yield batch

    # ----------------------------------------------------------- lifecycle
    def unlock(self) -> None:
        """reference unlock :50 — Lucene write-lock release; no-op here."""

    def cleanup(self) -> None:
        """reference cleanup :55 — drop the index contents."""
        self._tokens.clear()
        self._labels.clear()
        self._invalidate()
