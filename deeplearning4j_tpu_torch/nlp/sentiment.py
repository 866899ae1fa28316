"""Sentiment-lexicon scoring.

Parity: reference `text/corpora/sentiwordnet/SWN3.java` — a
SentiWordNet-backed polarity scorer used to label moving-window text:
per-word score = sense-rank-weighted (pos − neg) average
(weight 1/rank, normalized by the harmonic sum over all slots up to
the max rank, SWN3.java:106-118),
sentence score = sum of token scores with a sign flip when any negation
word is present (scoreTokens :174-190), and score -> class bands
(classForScore :149-165). The UIMA tokenizer plumbing is replaced by
plain token lists; the band comparisons are implemented as MONOTONE
intervals — the reference's chain (`score > 0 && score >= 0.25` for
"weak_positive", overlapping "positive" bounds) drops/garbles
conditions the same way its Viterbi dropped parentheses; the intended
banding is reproduced, not the bug.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Sequence

#: SWN3.java:50 — presence of any of these flips the sentence polarity
NEGATION_WORDS = frozenset([
    "could", "would", "should", "not", "isn't", "aren't", "wasn't",
    "weren't", "haven't", "doesn't", "didn't", "don't",
])


def class_for_score(score: float) -> str:
    """Monotone banding of the reference's classForScore intent."""
    if score >= 0.75:
        return "strong_positive"
    if score >= 0.25:
        return "positive"
    if score > 0:
        return "weak_positive"
    if score == 0:
        return "neutral"
    if score > -0.25:
        return "weak_negative"
    if score > -0.75:
        return "negative"
    return "strong_negative"


class SentimentLexicon:
    """word -> polarity score in [-1, 1]; scores/classifies token
    sequences with the SWN3 negation-flip rule."""

    def __init__(self, scores: Dict[str, float],
                 negation_words: Iterable[str] = NEGATION_WORDS):
        self.scores = {w.lower(): float(s) for w, s in scores.items()}
        self.negation_words = frozenset(negation_words)

    # ------------------------------------------------------------ lookup
    def extract(self, word: str) -> float:
        """Score for one token; 0 for out-of-lexicon words. Keys of the
        form `word#pos` (SentiWordNet) are aggregated across PoS at
        load time, so bare-token lookup works."""
        return self.scores.get(word.lower(), 0.0)

    # ----------------------------------------------------------- scoring
    def score_tokens(self, tokens: Sequence[str]) -> float:
        """Sum of token scores; sign flipped when any negation word
        appears (reference scoreTokens: 'flip for context')."""
        s = sum(self.extract(t) for t in tokens)
        if any(t.lower() in self.negation_words for t in tokens):
            s = -s
        return s

    def classify_tokens(self, tokens: Sequence[str]) -> str:
        return class_for_score(self.score_tokens(tokens))

    # ----------------------------------------------------------- loading
    @classmethod
    def from_sentiwordnet(cls, path: str) -> "SentimentLexicon":
        """Parse the SentiWordNet 3.0 TSV format the reference shipped:
        `pos \\t id \\t posScore \\t negScore \\t word#rank [word#rank...]`.
        Per (word, pos): score = sum_i (1/(rank_i)) * (pos-neg)_i
        normalized by the harmonic sum over ranks (SWN3.java:106-118);
        the bare word's score averages its per-PoS scores so token-level
        lookup needs no tagger."""
        per_sense: Dict[str, Dict[int, float]] = defaultdict(dict)
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split("\t")
                if len(parts) < 5 or not parts[2] or not parts[3]:
                    continue
                pos = parts[0]
                score = float(parts[2]) - float(parts[3])
                for token in parts[4].split(" "):
                    if not token or "#" not in token:
                        continue
                    word, rank = token.rsplit("#", 1)
                    try:
                        r = int(rank)
                    except ValueError:
                        continue
                    if r < 1:  # rank-0 would divide by zero below;
                        continue  # skip like other malformed entries
                    per_sense[f"{word}#{pos}"][r] = score

        scores: Dict[str, float] = {}
        by_word: Dict[str, List[float]] = defaultdict(list)
        for key, senses in per_sense.items():
            num = sum(s / r for r, s in senses.items())
            # the reference normalizes by the harmonic sum over ALL
            # slots up to the max rank — absent senses score 0 but
            # still count in the denominator (SWN3.java:112-116)
            den = sum(1.0 / i for i in range(1, max(senses) + 1))
            val = num / den if den else 0.0
            scores[key] = val
            by_word[key.rsplit("#", 1)[0]].append(val)
        for word, vals in by_word.items():
            scores.setdefault(word, sum(vals) / len(vals))
        return cls(scores)


__all__ = ["SentimentLexicon", "class_for_score", "NEGATION_WORDS"]
