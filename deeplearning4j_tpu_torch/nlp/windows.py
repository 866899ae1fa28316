"""Moving-window featurization for word-level classification.

Parity: reference nlp/text/movingwindow/ — `Window` (tokens + focus word +
label), `Windows.windows(text, windowSize)` (pad with <s>/</s>, slide over
tokens), `WindowConverter.asExampleMatrix` (concatenate the word
vectors of the window into one input row), and
`ContextLabelRetriever.stringWithLabels` (strip inline <LABEL>…</LABEL>
span markup into (tokens, span->label)). Feeds the Word2Vec-based
classification pipeline (Word2VecDataSetIterator).

Round 5 adds the annotator capabilities the reference got from UIMA
wrappers, natively: `annotate_windows` labels each window with the
focus token's PoS tag (nlp/pos.py HmmPosTagger) and/or the window's
sentiment class (nlp/sentiment.py SentimentLexicon) — the roles
PoStagger.java and SWN3.java played for ContextLabel features.

Host code: the port's own copy of the JAX package's
`nlp/windows.py`, the same behaviour line for line.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

BEGIN, END = "<s>", "</s>"

#: superset of the reference's `<([A-Za-z]+|\d+)>` pattern
#: (ContextLabelRetriever.java:35-36): also admits B-LOC / X_2 style
#: labels so common span markup can't silently leak into the tokens
_BEGIN_LABEL = re.compile(r"<([A-Za-z0-9_.-]+)>$")
_END_LABEL = re.compile(r"</([A-Za-z0-9_.-]+)>$")


class Window:
    def __init__(self, words: Sequence[str], focus_index: int,
                 label: Optional[str] = None,
                 tags: Optional[Sequence[str]] = None):
        self.words = list(words)
        self.focus_index = focus_index
        self.label = label
        #: optional per-word annotations (PoS tags), aligned with words
        self.tags = list(tags) if tags is not None else None

    def focus_word(self) -> str:
        return self.words[self.focus_index]

    def focus_tag(self) -> Optional[str]:
        return self.tags[self.focus_index] if self.tags else None

    def __repr__(self):
        return f"Window({self.words}, focus={self.focus_word()!r})"


def windows(tokens: Sequence[str], window_size: int = 5,
            label: Optional[str] = None) -> List[Window]:
    """Slide a centered window over tokens, padding the edges
    (reference Windows.windows)."""
    if window_size % 2 == 0:
        raise ValueError("window_size must be odd")
    half = window_size // 2
    padded = [BEGIN] * half + list(tokens) + [END] * half
    out = []
    for i in range(len(tokens)):
        out.append(Window(padded[i:i + window_size], half, label=label))
    return out


def window_as_vector(window: Window, word_vectors) -> np.ndarray:
    """Concatenate the window's word vectors into one example row
    (reference WindowConverter.asExampleMatrix). Unknown/pad words get
    zero vectors."""
    d = word_vectors.syn0.shape[1]
    parts = []
    for w in window.words:
        vec = word_vectors.get_word_vector(w)
        parts.append(np.zeros(d, np.float32) if vec is None
                     else np.asarray(vec, np.float32))
    return np.concatenate(parts)


def string_with_labels(sentence: str, tokenizer=None
                       ) -> Tuple[List[str], Dict[Tuple[int, int], str]]:
    """Strip inline <LABEL>...</LABEL> markup from a sentence
    (reference ContextLabelRetriever.stringWithLabels:50-118): returns
    (tokens without markup, {(start, end): label}) where the span is a
    half-open token range into the returned list. Raises on unbalanced
    markup like the reference."""
    tokens = (tokenizer(sentence) if tokenizer is not None
              else sentence.split())
    out: List[str] = []
    spans: Dict[Tuple[int, int], str] = {}
    label: Optional[str] = None
    start = 0
    for tok in tokens:
        m = _BEGIN_LABEL.match(tok)
        if m:
            if label is not None:
                raise ValueError(
                    f"nested begin label <{m.group(1)}> inside <{label}>")
            label = m.group(1)
            start = len(out)
            continue
        m = _END_LABEL.match(tok)
        if m:
            if label is None:
                raise ValueError(
                    f"end label </{m.group(1)}> with no begin label")
            if m.group(1) != label:
                raise ValueError(
                    f"end label </{m.group(1)}> does not match <{label}>")
            spans[(start, len(out))] = label
            label = None
            continue
        out.append(tok)
    if label is not None:
        raise ValueError(f"begin label <{label}> was never closed")
    return out, spans


def annotate_windows(tokens: Sequence[str], window_size: int = 5,
                     tagger=None, lexicon=None,
                     span_labels: Optional[Dict[Tuple[int, int], str]]
                     = None) -> List[Window]:
    """Moving windows with native annotations: per-word PoS tags from
    `tagger` (HmmPosTagger.tag interface), window label precedence
    span_labels > lexicon sentiment class > None. This is the
    end-to-end path the reference assembled from ContextLabel +
    PoStagger + SWN3."""
    wins = windows(tokens, window_size)
    half = window_size // 2
    tags = list(tagger.tag(tokens)) if tagger is not None else None
    for i, w in enumerate(wins):
        if tags is not None:
            # align tags with the padded window; pads have no tag
            w.tags = [
                tags[j] if 0 <= (j := i - half + k) < len(tokens) else None
                for k in range(window_size)]
        label = None
        if span_labels:
            for (s, e), lab in span_labels.items():
                if s <= i < e:
                    label = lab
                    break
        if label is None and lexicon is not None:
            label = lexicon.classify_tokens(
                [t for t in w.words if t not in (BEGIN, END)])
        w.label = label
    return wins
