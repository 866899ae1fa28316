"""Tokenizers + factories.

Parity: reference nlp/text/tokenization/ — `Tokenizer`/`TokenizerFactory`
with DefaultTokenizer (whitespace/punct), NGramTokenizer, and pluggable
token pre-processing (EndingPreProcessor etc.). UIMA-backed tokenizers are
out of scope (external UIMA dependency); the factory interface accepts any
callable pre-processor, which covers their role.

Host code: the port's own copy of the JAX package's
`nlp/tokenization.py`, the same behaviour line for line.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional


class Tokenizer:
    def tokens(self) -> List[str]:
        raise NotImplementedError


class DefaultTokenizer(Tokenizer):
    """Lowercased word tokens, punctuation-stripped (DefaultTokenizer)."""

    _WORD = re.compile(r"[\w']+")

    def __init__(self, text: str,
                 pre_processor: Optional[Callable[[str], str]] = None):
        self.text = text
        self.pre_processor = pre_processor

    def tokens(self) -> List[str]:
        toks = self._WORD.findall(self.text.lower())
        if self.pre_processor is not None:
            toks = [self.pre_processor(t) for t in toks]
        return [t for t in toks if t]


class TokenizerFactory:
    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError

    def tokenize(self, text: str) -> List[str]:
        return self.create(text).tokens()


class DefaultTokenizerFactory(TokenizerFactory):
    def __init__(self, pre_processor: Optional[Callable[[str], str]] = None):
        self.pre_processor = pre_processor

    def create(self, text: str) -> DefaultTokenizer:
        return DefaultTokenizer(text, self.pre_processor)


class WhitespaceTokenizer(Tokenizer):
    """Plain whitespace tokenization — the reference's ACTUAL
    DefaultTokenizer (text/tokenization/tokenizer/DefaultTokenizer.java:
    a java.util.StringTokenizer: no lowercasing, no punctuation strip).
    ~5x faster than the regex tokenizer; the right choice for
    pre-cleaned/space-separated corpora (text8-style) where tokenization
    is the Word2Vec pipeline's bottleneck."""

    def __init__(self, text: str,
                 pre_processor: Optional[Callable[[str], str]] = None):
        self.text = text
        self.pre_processor = pre_processor

    def tokens(self) -> List[str]:
        toks = self.text.split()
        if self.pre_processor is not None:
            toks = [t for t in (self.pre_processor(t) for t in toks) if t]
        return toks


class WhitespaceTokenizerFactory(TokenizerFactory):
    def __init__(self, pre_processor: Optional[Callable[[str], str]] = None):
        self.pre_processor = pre_processor

    def create(self, text: str) -> WhitespaceTokenizer:
        return WhitespaceTokenizer(text, self.pre_processor)


class NGramTokenizerFactory(TokenizerFactory):
    """Emit n-grams (joined by '_') over the base tokens
    (reference NGramTokenizerFactory)."""

    def __init__(self, n_min: int = 1, n_max: int = 2,
                 base: Optional[TokenizerFactory] = None):
        self.n_min, self.n_max = n_min, n_max
        self.base = base or DefaultTokenizerFactory()

    def create(self, text: str) -> Tokenizer:
        words = self.base.tokenize(text)
        grams: List[str] = []
        for n in range(self.n_min, self.n_max + 1):
            for i in range(len(words) - n + 1):
                grams.append("_".join(words[i:i + n]))
        tok = Tokenizer()
        tok.tokens = lambda: grams  # type: ignore[assignment]
        return tok


def stem_ending_preprocessor(token: str) -> str:
    """Light suffix-stripping normalizer (reference EndingPreProcessor)."""
    for suffix in ("ies", "s", "ed", "ing", "ly"):
        if token.endswith(suffix) and len(token) > len(suffix) + 2:
            return token[: -len(suffix)]
    return token
