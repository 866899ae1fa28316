"""Vocabulary cache.

Parity: reference nlp/models/word2vec/wordstore/ — `VocabWord` (word +
count + Huffman codes/points), `VocabCache`/`InMemoryLookupCache` (word ->
index, counts, doc frequencies) and the vocab-building pass of
`TextVectorizer`/`VocabActor` (tokenize sentences, count, apply
min-word-frequency). The actor-based parallel counting collapses to a
single host pass — counting is IO-bound, not the card's job.

Host code: the port's own copy of the JAX package's
`nlp/vocab.py`, the same behaviour line for line.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional


@dataclass
class VocabWord:
    word: str
    count: float = 1.0
    index: int = -1
    codes: List[int] = field(default_factory=list)
    points: List[int] = field(default_factory=list)

    def code_length(self) -> int:
        return len(self.codes)


class VocabCache:
    """Word store (reference InMemoryLookupCache)."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._index: List[str] = []
        self.total_word_count = 0.0
        self.num_docs = 0
        self._doc_freq: Counter = Counter()

    # ------------------------------------------------------------ building
    def add_token(self, word: str, by: float = 1.0) -> VocabWord:
        vw = self._words.get(word)
        if vw is None:
            vw = VocabWord(word=word, count=0.0)
            self._words[word] = vw
        vw.count += by
        self.total_word_count += by
        return vw

    def add_word_to_index(self, word: str) -> int:
        vw = self._words[word]
        if vw.index < 0:
            vw.index = len(self._index)
            self._index.append(word)
        return vw.index

    def increment_doc_count(self, words: Iterable[str]) -> None:
        self.num_docs += 1
        self._doc_freq.update(set(words))

    def doc_frequency(self, word: str) -> int:
        return self._doc_freq[word]

    # ------------------------------------------------------------- queries
    def contains(self, word: str) -> bool:
        return word in self._words

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def word_at(self, index: int) -> str:
        return self._index[index]

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.index if vw else -1

    def word_frequency(self, word: str) -> float:
        vw = self._words.get(word)
        return vw.count if vw else 0.0

    def num_words(self) -> int:
        return len(self._index)

    def words(self) -> List[str]:
        return list(self._index)

    def vocab_words(self) -> List[VocabWord]:
        return [self._words[w] for w in self._index]

    # -------------------------------------------------------- serialization
    def to_dict(self) -> Dict:
        """JSON-able snapshot (index order, counts, Huffman codes/points) —
        the distributed wire format for shipping a built vocab to worker
        processes (reference Word2VecWork carries the vocab words)."""
        return {
            "words": [{"w": vw.word, "c": vw.count,
                       "codes": list(vw.codes), "points": list(vw.points)}
                      for vw in self.vocab_words()],
            "total_word_count": self.total_word_count,
            "num_docs": self.num_docs,
        }

    @classmethod
    def from_dict(cls, data: Dict) -> "VocabCache":
        cache = cls()
        for i, rec in enumerate(data["words"]):
            vw = VocabWord(word=rec["w"], count=rec["c"], index=i,
                           codes=[int(c) for c in rec["codes"]],
                           points=[int(p) for p in rec["points"]])
            cache._words[vw.word] = vw
            cache._index.append(vw.word)
        cache.total_word_count = data.get("total_word_count", 0.0)
        cache.num_docs = data.get("num_docs", 0)
        return cache

    def truncate(self, min_word_frequency: float) -> None:
        """Drop words below the frequency floor and re-index by descending
        count (word2vec convention: index 0 = most frequent)."""
        kept = {w: vw for w, vw in self._words.items()
                if vw.count >= min_word_frequency}
        self._words = kept
        ordered = sorted(kept.values(), key=lambda v: -v.count)
        self._index = []
        for vw in ordered:
            vw.index = len(self._index)
            self._index.append(vw.word)


def build_vocab(sentences, tokenizer_factory, min_word_frequency: float = 1.0,
                cache: Optional[VocabCache] = None) -> VocabCache:
    """Tokenize + count + truncate (reference Word2Vec.buildVocab :257)."""
    cache = cache or VocabCache()
    for sentence in sentences:
        toks = tokenizer_factory.tokenize(sentence)
        if not toks:
            continue
        cache.increment_doc_count(toks)
        for t in toks:
            cache.add_token(t)
    cache.truncate(min_word_frequency)
    return cache
