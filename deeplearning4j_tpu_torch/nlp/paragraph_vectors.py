"""ParagraphVectors (doc2vec, PV-DBOW flavor).

Parity: reference nlp/models/paragraphvectors/ParagraphVectors.java:53-61 —
extends Word2Vec by adding label "words" trained on every window of their
document, so each label gets an embedding in the same space as the words.

Design: labels are appended to the vocab as pseudo-words; pair mining
emits (label, context-word) pairs for every word of the labeled sentence
alongside the normal skip-gram pairs, label chunks interleaved with the
base stream in the JAX package's order; training reuses the Word2Vec
device step unchanged, on the device `Word2Vec` resolves (`device=`,
None = the card). The port's counterpart of the JAX package's
`nlp/paragraph_vectors.py`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.nlp.sentence_iterator import LabelAwareSentenceIterator
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec


class ParagraphVectors(Word2Vec):
    def __init__(self, labeled_sentences=None, **kw):
        """`labeled_sentences`: iterable of (label, sentence) pairs or a
        LabelAwareSentenceIterator."""
        if isinstance(labeled_sentences, LabelAwareSentenceIterator):
            pairs = list(labeled_sentences.pairs)
        else:
            pairs = list(labeled_sentences or [])
        self.labeled = pairs
        super().__init__([s for _, s in pairs], **kw)
        self.labels = sorted({lb for lb, _ in pairs})

    def _extend_vocab(self) -> None:
        # labels enter the vocab as pseudo-words with doc-level counts
        # AFTER truncation (so min_word_frequency can't drop them) and
        # BEFORE the single Huffman build in Word2Vec.build_vocab
        for label in self.labels:
            n_docs = sum(1 for lb, _ in self.labeled if lb == label)
            vw = self.vocab.add_token(self._label_token(label), by=n_docs)
            self.vocab.add_word_to_index(vw.word)

    @staticmethod
    def _label_token(label: str) -> str:
        return f"__label__{label}"

    def _iter_pair_chunks(self, rng: np.random.RandomState,
                          chunk_tokens: int = 1 << 18):
        # PV-DBOW: each doc's label predicts every word of the doc
        # (reference trains the label word in every window, :61).
        # Label chunks are INTERLEAVED with the base skip-gram stream —
        # yielding them all at the end would train every label pair at
        # the fully-decayed learning rate (words_seen ≈ total by then),
        # which measurably wrecked label quality at corpus scale (topic
        # retrieval 0.40 tail-trained vs ~1.0 interleaved on a 2M-token
        # 20-topic corpus). Label pairs carry no new corpus words
        # (n_words = 0: the base chunks own the alpha decay).
        base = super()._iter_pair_chunks(rng, chunk_tokens)
        labels = self._iter_label_chunks(chunk_tokens)
        while True:
            stop = True
            for stream in (base, labels):
                chunk = next(stream, None)
                if chunk is not None:
                    stop = False
                    yield chunk
            if stop:
                return

    def _iter_label_chunks(self, chunk_tokens: int):
        # chunked like the base stream so a corpus-scale labeled set
        # never materializes all label pairs at once
        lab_centers: List[np.ndarray] = []
        lab_contexts: List[np.ndarray] = []
        buffered = 0
        for label, sentence in self.labeled:
            li = self.vocab.index_of(self._label_token(label))
            if li < 0:
                continue
            words = self._tokens_to_indices(sentence)
            if words.size:
                lab_centers.append(words)   # predict word via its codes
                lab_contexts.append(        # from the label's vector
                    np.full(words.size, li, np.int32))
                buffered += words.size
            if buffered >= chunk_tokens:
                yield (np.concatenate(lab_centers),
                       np.concatenate(lab_contexts), 0)
                lab_centers, lab_contexts, buffered = [], [], 0
        if lab_centers:
            yield (np.concatenate(lab_centers),
                   np.concatenate(lab_contexts), 0)

    # ---------------------------------------------------------------- query
    def label_vector(self, label: str) -> Optional[np.ndarray]:
        return self.get_word_vector(self._label_token(label))

    def similarity_to_label(self, word: str, label: str) -> float:
        return self.similarity(word, self._label_token(label))

    def nearest_labels(self, word: str, n: int = 5):
        i = self.vocab.index_of(word)
        if i < 0:
            return []
        out = []
        for label in self.labels:
            out.append((label, self.similarity(word,
                                               self._label_token(label))))
        out.sort(key=lambda t: -t[1])
        return out[:n]
