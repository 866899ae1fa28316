"""Text vectorizers: bag-of-words and TF-IDF.

Parity: reference nlp/bagofwords/vectorizer/ — `BagOfWordsVectorizer` /
`TfidfVectorizer` over a VocabCache (BaseTextVectorizer.java:278: tokenize,
count, emit document vectors + label). Emits dense numpy document-term
matrices ready to feed MultiLayerNetwork.

Host code: the port's own copy of the JAX package's
`nlp/vectorizers.py`, the same behaviour line for line.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache, build_vocab
from deeplearning4j_tpu_torch.utils import math_utils


class BagOfWordsVectorizer:
    def __init__(self, min_word_frequency: float = 1.0,
                 tokenizer_factory: Optional[TokenizerFactory] = None):
        self.min_word_frequency = min_word_frequency
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.vocab = VocabCache()

    def fit(self, documents: Iterable[str]) -> "BagOfWordsVectorizer":
        build_vocab(documents, self.tokenizer_factory,
                    self.min_word_frequency, self.vocab)
        return self

    def _weight(self, count: float, word: str) -> float:
        return count

    def transform(self, documents: Sequence[str]) -> np.ndarray:
        v = self.vocab.num_words()
        out = np.zeros((len(documents), v), np.float32)
        for row, doc in enumerate(documents):
            for t in self.tokenizer_factory.tokenize(doc):
                i = self.vocab.index_of(t)
                if i >= 0:
                    out[row, i] += 1.0
            for i in np.nonzero(out[row])[0]:
                out[row, i] = self._weight(out[row, i],
                                           self.vocab.word_at(int(i)))
        return out

    def fit_transform(self, documents: Sequence[str]) -> np.ndarray:
        return self.fit(documents).transform(documents)


class TfidfVectorizer(BagOfWordsVectorizer):
    """TF-IDF weighting via the MathUtils-parity helpers, matching the
    reference exactly: `MathUtils.tfidf(tf, idf)` with log10-scaled term
    frequency and `log10(numDocs / (1 + docFreq))` inverse document
    frequency (reference TfidfVectorizer.java:63-73 → MathUtils.java)."""

    def _weight(self, count: float, word: str) -> float:
        return math_utils.tfidf(
            math_utils.tf(int(count)),
            math_utils.idf(self.vocab.num_docs,
                           self.vocab.doc_frequency(word)))
