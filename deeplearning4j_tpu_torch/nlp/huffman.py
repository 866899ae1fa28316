"""Huffman coding over the vocabulary.

Parity: reference nlp/models/word2vec/Huffman.java — build the binary
Huffman tree over word frequencies; each VocabWord gets `codes` (the 0/1
path bits) and `points` (the inner-node indices along the path), consumed
by hierarchical softmax. Inner nodes are numbered so syn1 rows can be
indexed directly by `point` (word2vec convention: inner node i -> row i).

Host code: the port's own copy of the JAX package's
`nlp/huffman.py`, the same behaviour line for line.
"""

from __future__ import annotations

import heapq
from itertools import count
from typing import List

from deeplearning4j_tpu_torch.nlp.vocab import VocabCache

MAX_CODE_LENGTH = 40


def build_huffman(cache: VocabCache) -> None:
    """Assign codes/points to every indexed word, in place."""
    words = cache.vocab_words()
    n = len(words)
    if n == 0:
        return
    if n == 1:
        words[0].codes, words[0].points = [0], [0]
        return

    tie = count()
    # heap items: (count, tiebreak, node); leaf nodes are VocabWord indices,
    # inner nodes get ids n, n+1, ... (word2vec convention)
    heap = [(vw.count, next(tie), ("leaf", vw.index)) for vw in words]
    heapq.heapify(heap)
    next_inner = 0
    children = {}  # inner id -> (left node, right node)
    while len(heap) > 1:
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        inner = ("inner", next_inner)
        next_inner += 1
        children[inner[1]] = (n1, n2)
        heapq.heappush(heap, (c1 + c2, next(tie), inner))
    root = heap[0][2]

    # Walk down, accumulating (codes, points). points are inner-node ids.
    stack = [(root, [], [])]
    while stack:
        node, codes, points = stack.pop()
        kind, idx = node
        if kind == "leaf":
            vw = words[idx]  # words list is ordered by index (vocab_words())
            vw.codes = codes[:MAX_CODE_LENGTH]
            vw.points = points[:MAX_CODE_LENGTH]
            continue
        left, right = children[idx]
        stack.append((left, codes + [0], points + [idx]))
        stack.append((right, codes + [1], points + [idx]))


def max_code_length(cache: VocabCache) -> int:
    return max((vw.code_length() for vw in cache.vocab_words()), default=0)
