"""Native part-of-speech tagging.

Parity target: reference `text/annotator/PoStagger.java:246` — a UIMA
AnalysisEngine wrapping OpenNLP's pre-trained maxent tagger. The wrapper
itself is third-party glue (scoped out, README), but the CAPABILITY it
gave the moving-window pipeline — per-token PoS tags as context
features — is a framework feature, provided here natively: a trainable
bigram HMM decoded with the shared Viterbi machinery
(`utils/viterbi.py::viterbi_path`, the general-table form of the
reference's own `core/util/Viterbi.java` chain).

Training is closed-form counting (no gradient loop): tag-bigram
transition counts and word|tag emission counts with add-k smoothing;
unknown words fall back to suffix-signature emissions (the classic
HMM-tagger recipe), so the tagger generalizes beyond its training
vocabulary.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.utils.viterbi import viterbi_path

_SUFFIXES = ("ing", "ed", "ly", "s", "tion", "ity", "ous", "ful", "est",
             "er", "al", "ive")


def _signature(word: str) -> str:
    """Unknown-word bucket: digits / capitalization / suffix shape."""
    if any(c.isdigit() for c in word):
        return "<num>"
    for suf in _SUFFIXES:
        if len(word) > len(suf) + 1 and word.lower().endswith(suf):
            return f"<suf:{suf}>"
    if word[:1].isupper():
        return "<cap>"
    return "<unk>"


class HmmPosTagger:
    """Bigram HMM tagger: train on (word, tag) sentences, tag new
    token sequences via Viterbi decoding."""

    def __init__(self, smoothing: float = 0.1):
        self.smoothing = smoothing
        self.tags: List[str] = []
        self._tag_index: Dict[str, int] = {}
        self._log_trans: np.ndarray | None = None
        self._log_init: np.ndarray | None = None
        #: word -> (n_tags,) emission log-prob columns; includes the
        #: <unk>/signature buckets trained from singleton words
        self._log_emit: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------- train
    def train(self, tagged_sentences: Sequence[Sequence[Tuple[str, str]]]
              ) -> "HmmPosTagger":
        if not tagged_sentences:
            raise ValueError("need at least one tagged sentence")
        tag_set = sorted({t for sent in tagged_sentences for _, t in sent})
        if len(tag_set) < 2:
            raise ValueError("need at least 2 distinct tags")
        # retraining replaces the model wholesale — stale emission rows
        # from a previous corpus would carry the OLD tag alphabet
        self._log_emit = {}
        self.tags = tag_set
        self._tag_index = {t: i for i, t in enumerate(tag_set)}
        n = len(tag_set)
        k = self.smoothing

        trans = np.full((n, n), k)
        init = np.full((n,), k)
        emit: Dict[str, Counter] = defaultdict(Counter)
        word_freq: Counter = Counter()
        for sent in tagged_sentences:
            prev = None
            for word, tag in sent:
                ti = self._tag_index[tag]
                w = word.lower()
                emit[w][ti] += 1
                word_freq[w] += 1
                if prev is None:
                    init[ti] += 1
                else:
                    trans[prev, ti] += 1
                prev = ti
        # rare words (freq 1) ALSO train their signature bucket, so an
        # unseen word inherits the tag distribution of its shape class
        for sent in tagged_sentences:
            for word, tag in sent:
                if word_freq[word.lower()] <= 1:
                    emit[_signature(word)][self._tag_index[tag]] += 1

        self._log_trans = np.log(trans / trans.sum(axis=1, keepdims=True))
        self._log_init = np.log(init / init.sum())
        tag_totals = np.full((n,), k * (len(emit) + 1))
        for counts in emit.values():
            for ti, c in counts.items():
                tag_totals[ti] += c
        for w, counts in emit.items():
            col = np.full((n,), k)
            for ti, c in counts.items():
                col[ti] += c
            self._log_emit[w] = np.log(col / tag_totals)
        self._fallback = np.log(np.full((n,), k) / tag_totals)
        return self

    # --------------------------------------------------------------- tag
    def _emission_row(self, word: str) -> np.ndarray:
        w = word.lower()
        if w in self._log_emit:
            return self._log_emit[w]
        sig = _signature(word)
        return self._log_emit.get(sig, self._fallback)

    def tag(self, tokens: Sequence[str]) -> List[str]:
        """Most likely tag sequence for `tokens`."""
        if self._log_trans is None:
            raise RuntimeError("tagger is untrained; call train() first")
        if not tokens:
            return []
        emits = np.stack([self._emission_row(t) for t in tokens])
        _, path = viterbi_path(self._log_init, self._log_trans, emits)
        return [self.tags[i] for i in path]

    def tag_sentence(self, tokens: Sequence[str]
                     ) -> List[Tuple[str, str]]:
        return list(zip(tokens, self.tag(tokens)))


__all__ = ["HmmPosTagger"]
