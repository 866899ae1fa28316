"""Word2Vec → classification-DataSet bridge with Viterbi smoothing.

Parity: reference nlp/models/word2vec/iterator/ —
`Word2VecDataSetIterator` (mine moving windows from a label-aware sentence
stream, featurize each window by concatenating the pretrained word vectors
of its tokens, one-hot the sentence label; Word2VecDataSetIterator.java:
next(num) window-cache loop :128-151, fromCached :153-197, inputColumns =
layerSize * window :208) and `Word2VecDataFetcher`. The reference pairs
this moving-window classifier with `Viterbi` smoothing of the predicted
label sequence (core/util/Viterbi.java:31-192).

Design: windows are featurized in blocks into one dense
(batch, window*dim) host matrix — the batch crosses to the device once,
at fit time. For corpora whose
window stream outgrows RAM, the window cache spills through
`DiskBasedQueue` (core/util/DiskBasedQueue.java parity) instead of the
reference's unbounded in-memory CopyOnWriteArrayList.

Host code: the port's own copy of the JAX package's
`nlp/word2vec_iterator.py`, the same behaviour line for line.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.windows import Window, window_as_vector, windows
from deeplearning4j_tpu_torch.utils.disk_based_queue import DiskBasedQueue
from deeplearning4j_tpu_torch.utils.viterbi import Viterbi

__all__ = ["Word2VecDataSetIterator", "Word2VecDataFetcher",
           "viterbi_smooth"]


class Word2VecDataSetIterator(DataSetIterator):
    """Moving-window classification datasets over pretrained word vectors
    (reference Word2VecDataSetIterator.java).

    `vec` is a fitted `WordVectors`/`Word2Vec` (needs `syn0`,
    `get_word_vector`, and a `window` size); `sentence_iter` is a
    LabelAwareSentenceIterator; `labels` fixes the outcome order."""

    def __init__(self, vec, sentence_iter, labels: Sequence[str],
                 batch: int = 10,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 window_size: Optional[int] = None,
                 spill_to_disk: bool = False):
        self.vec = vec
        self.sentence_iter = sentence_iter
        self.labels = list(labels)
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        w = window_size if window_size is not None else getattr(
            vec, "window", 5)
        self.window_size = w if w % 2 == 1 else w + 1
        self.spill_to_disk = spill_to_disk
        self._cache = DiskBasedQueue() if spill_to_disk else None
        self._mem_cache: List[Window] = []
        # streaming source: totals unknowable up front (reference
        # totalExamples throws UnsupportedOperationException)
        super().__init__(batch_size=batch, num_examples=-1)

    # ------------------------------------------------------------ windows
    def _cache_size(self) -> int:
        return (self._cache.size() if self._cache is not None
                else len(self._mem_cache))

    def _cache_push(self, win: Window) -> None:
        if self._cache is not None:
            # windows serialize as JSON-able dicts (no pickle on disk)
            self._cache.add({"words": win.words, "focus": win.focus_index,
                             "label": win.label})
        else:
            self._mem_cache.append(win)

    def _cache_pop(self) -> Window:
        if self._cache is not None:
            rec = self._cache.remove()
            return Window(rec["words"], int(rec["focus"]),
                          label=rec["label"])
        return self._mem_cache.pop(0)

    def _mine_more(self, need: int) -> None:
        while self._cache_size() < need and self.sentence_iter.has_next():
            sentence = self.sentence_iter.next_sentence()
            if not sentence.strip():
                continue
            label = self.sentence_iter.current_label()
            tokens = self.tokenizer_factory.tokenize(sentence)
            for win in windows(tokens, self.window_size, label=label):
                self._cache_push(win)

    # ----------------------------------------------- DataSetIterator api
    def input_columns(self) -> int:
        """reference inputColumns :208: layerSize * window."""
        return int(self.vec.syn0.shape[1]) * self.window_size

    def total_outcomes(self) -> int:
        return len(self.labels)

    def total_examples(self) -> int:
        raise NotImplementedError(
            "streaming sentence source; total window count unknown "
            "(reference totalExamples throws UnsupportedOperationException)")

    num_examples = total_examples

    def has_next(self) -> bool:
        return self._cache_size() > 0 or self.sentence_iter.has_next()

    def reset(self) -> None:
        self.sentence_iter.reset()
        if self._cache is not None:
            self._cache.clear()
        self._mem_cache.clear()

    def next(self, num: Optional[int] = None) -> DataSet:
        n = num or self.batch_size
        self._mine_more(n)
        take = min(n, self._cache_size())
        if take == 0:
            raise StopIteration
        x = np.empty((take, self.input_columns()), np.float32)
        y = np.zeros((take, len(self.labels)), np.float32)
        for i in range(take):
            win = self._cache_pop()
            x[i] = window_as_vector(win, self.vec)
            if win.label is not None:
                try:
                    y[i, self.labels.index(win.label)] = 1.0
                except ValueError:
                    raise ValueError(
                        f"window label {win.label!r} not in labels "
                        f"{self.labels}") from None
        ds = DataSet(x, y)
        if self.pre_processor is not None:
            ds = self.pre_processor(ds)
        return ds


class Word2VecDataFetcher(Word2VecDataSetIterator):
    """File-corpus variant (reference Word2VecDataFetcher.java: iterate
    text files, window each line, featurize through the trained
    vectors). Labels come from each file's parent directory (the
    directory-per-class layout `LabelAwareDocumentIterator` reads);
    every non-empty line is one sentence."""

    def __init__(self, vec, corpus_root: str, labels=None, batch: int = 10,
                 **kw):
        from deeplearning4j_tpu_torch.nlp.documents import (
            LabelAwareDocumentIterator)
        from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
            LabelAwareSentenceIterator)

        docs = LabelAwareDocumentIterator(corpus_root)
        pairs = []
        while docs.has_next():
            text = docs.next_document()
            label = docs.current_label()
            for line in text.splitlines():
                if line.strip():
                    pairs.append((label, line))
        if labels is None:
            labels = sorted({label for label, _ in pairs})
        super().__init__(vec, LabelAwareSentenceIterator(pairs),
                         labels=labels, batch=batch, **kw)


def viterbi_smooth(predictions: np.ndarray,
                   meta_stability: float = 0.9,
                   p_correct: float = 0.99, device=None) -> np.ndarray:
    """Smooth a sentence's per-window label predictions with Viterbi
    decoding (the reference's moving-window + Viterbi pairing,
    core/util/Viterbi.java:31-192): label flips between adjacent windows
    are penalized by the transition prior, so isolated one-window
    misclassifications snap to their neighborhood.

    `predictions`: (windows, classes) probabilities or one-hot — the
    per-window classifier output for ONE sentence, in order. Returns the
    smoothed label-index sequence. The decode runs on `device` (None =
    the card, raising without one)."""
    predictions = np.asarray(predictions)
    if predictions.ndim != 2:
        raise ValueError("predictions must be (windows, classes)")
    v = Viterbi(np.arange(predictions.shape[1]),
                meta_stability=meta_stability, p_correct=p_correct,
                device=device)
    _, path = v.decode(predictions, binary_label_matrix=True)
    return path
