"""Labeled parse trees for recursive models (RNTN).

Parity: reference Tree structure
(deeplearning4j-core/.../models/featuredetectors/autoencoder/recursive/
Tree.java:30-484 — label/value/children/goldLabel/vector/prediction/error,
isLeaf/isPreTerminal, depth, getLeaves, errorSum, clone) plus a
Penn-treebank-style s-expression parser so labeled trees can be built
without the reference's UIMA/treebank stack.

The port's copy of the JAX package's `nlp/tree.py` (host code, the
same behaviour). The Python Tree is a host-side construction/inspection
structure only; `encode_trees` lowers a batch of trees to padded
post-order index arrays (children always before parents) from which the
RNTN (`nlp/rntn.py`) builds its level schedule on the device — the
batched replacement for the reference's per-node Java recursion.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np


class Tree:
    """A node: leaves carry a token in `value`; internal nodes carry an
    optional integer `gold_label` (sentiment class; -1 = unlabeled) and a
    string `label` (syntactic category; '' under the simplified model)."""

    def __init__(self, value: Optional[str] = None,
                 children: Optional[List["Tree"]] = None,
                 gold_label: int = -1, label: str = ""):
        self.value = value
        self.children: List[Tree] = children or []
        self.gold_label = gold_label
        self.label = label
        # set by RNTN.forward_propagate_tree (reference setVector/
        # setPrediction/setError)
        self.vector = None
        self.prediction = None
        self.error = 0.0

    # ------------------------------------------------------------ structure
    def is_leaf(self) -> bool:
        return not self.children

    def is_preterminal(self) -> bool:
        """One child which is a leaf (reference isPreTerminal :160)."""
        return len(self.children) == 1 and self.children[0].is_leaf()

    def first_child(self) -> "Tree":
        return self.children[0]

    def last_child(self) -> "Tree":
        return self.children[-1]

    def depth(self) -> int:
        if self.is_leaf():
            return 0
        return 1 + max(c.depth() for c in self.children)

    def leaves(self) -> List["Tree"]:
        if self.is_leaf():
            return [self]
        out: List[Tree] = []
        for c in self.children:
            out.extend(c.leaves())
        return out

    def tokens(self) -> List[str]:
        """The yield: left-to-right leaf values (reference yield() :92)."""
        return [leaf.value for leaf in self.leaves()]

    def error_sum(self) -> float:
        """Total error over the subtree (reference errorSum :271)."""
        return self.error + sum(c.error_sum() for c in self.children)

    def clone(self) -> "Tree":
        t = Tree(self.value, [c.clone() for c in self.children],
                 self.gold_label, self.label)
        return t

    def __repr__(self):
        if self.is_leaf():
            return f"Tree({self.value!r})"
        head = self.label or self.gold_label
        return f"Tree({head}, {len(self.children)} children)"

    def to_sexpr(self) -> str:
        if self.is_leaf():
            return str(self.value)
        head = self.label if self.label else str(self.gold_label)
        return f"({head} " + " ".join(c.to_sexpr()
                                      for c in self.children) + ")"


def parse_tree(text: str) -> Tree:
    """Parse an s-expression like ``(2 (1 bad) (3 movie))`` — integer heads
    become gold labels, non-integer heads become category labels."""
    tokens = text.replace("(", " ( ").replace(")", " ) ").split()
    pos = 0

    def parse() -> Tree:
        nonlocal pos
        if tokens[pos] != "(":
            word = tokens[pos]
            pos += 1
            return Tree(value=word)
        pos += 1  # consume '('
        head = tokens[pos]
        pos += 1
        node = Tree()
        try:
            node.gold_label = int(head)
        except ValueError:
            node.label = head
        while tokens[pos] != ")":
            node.children.append(parse())
        pos += 1  # consume ')'
        return node

    tree = parse()
    if pos != len(tokens):
        raise ValueError(f"Trailing tokens in tree text: {tokens[pos:]!r}")
    return tree


def binarize(tree: Tree) -> Tree:
    """Left-binarize n-ary nodes and collapse unary chains above
    preterminals so every internal node is preterminal or binary — the
    shape RNTN requires (reference BinarizeTreeTransformer +
    CollapseUnaries, nlp/text/corpora/treeparser/). Returns a new tree;
    the input is never mutated or aliased."""
    if tree.is_leaf() or tree.is_preterminal():
        return tree.clone()
    children = [binarize(c) for c in tree.children]
    while len(children) > 2:
        merged = Tree(gold_label=-1, label=tree.label,
                      children=children[:2])
        children = [merged] + children[2:]
    if len(children) == 1:
        child = children[0]
        # collapse unary: keep the outermost gold label if child unlabeled
        if child.gold_label < 0:
            child.gold_label = tree.gold_label
        return child
    return Tree(gold_label=tree.gold_label, label=tree.label,
                children=children)


class EncodedTrees(NamedTuple):
    """Batch of padded topological tree encodings (device-ready).

    All arrays have shape (n_trees, max_nodes); slot order is post-order so
    a scan from slot 0 upward always sees children computed first.
    kind: 0=pad, 1=preterminal/word, 2=binary.
    """

    kind: np.ndarray
    word: np.ndarray   # word id (kind 1)
    left: np.ndarray   # child slot index (kind 2)
    right: np.ndarray
    cat: np.ndarray    # transform-parameter index (category pair)
    ccat: np.ndarray   # classification-parameter index
    gold: np.ndarray   # gold label, -1 = unlabeled
    root: np.ndarray   # (n_trees,) slot index of each root

    @property
    def n_trees(self) -> int:
        return self.kind.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.kind.shape[1]


def _count_internal(tree: Tree) -> int:
    if tree.is_leaf():
        return 0
    if tree.is_preterminal():
        return 1
    return 1 + sum(_count_internal(c) for c in tree.children)


def encode_trees(trees: List[Tree], word_index: Dict[str, int],
                 unk_index: int = 0,
                 cat_index=None, ccat_index=None,
                 max_nodes: Optional[int] = None,
                 word_transform=None) -> EncodedTrees:
    """Lower Python trees to padded post-order index arrays.

    `cat_index`/`ccat_index` map (left_label, right_label) pairs / labels to
    parameter indices; None = simplified model (single shared index 0,
    reference simplifiedModel/combineClassification defaults).
    `word_transform` (e.g. str.lower) is applied to each token before the
    word_index lookup.
    """
    sizes = [_count_internal(t) for t in trees]
    width = max_nodes or max(sizes)
    if max(sizes) > width:
        raise ValueError(f"Tree with {max(sizes)} nodes exceeds "
                         f"max_nodes={width}")
    n = len(trees)
    enc = EncodedTrees(
        kind=np.zeros((n, width), np.int32),
        word=np.zeros((n, width), np.int32),
        left=np.zeros((n, width), np.int32),
        right=np.zeros((n, width), np.int32),
        cat=np.zeros((n, width), np.int32),
        ccat=np.zeros((n, width), np.int32),
        gold=np.full((n, width), -1, np.int32),
        root=np.zeros((n,), np.int32),
    )

    for ti, tree in enumerate(trees):
        slot = [0]

        def visit(node: Tree) -> int:
            if node.is_leaf():
                raise ValueError(
                    "encode_trees visits internal nodes only; got a bare "
                    "leaf — wrap tokens in preterminals (binarize() helps)")
            if not (node.is_preterminal() or len(node.children) == 2):
                raise ValueError(
                    f"RNTN trees must be binary (or preterminal); node has "
                    f"{len(node.children)} children — call binarize() first")
            if node.is_preterminal():
                s = slot[0]
                slot[0] += 1
                enc.kind[ti, s] = 1
                word = node.first_child().value
                if word_transform is not None:
                    word = word_transform(word)
                enc.word[ti, s] = word_index.get(word, unk_index)
                enc.ccat[ti, s] = (ccat_index[node.label]
                                   if ccat_index else 0)
                enc.gold[ti, s] = node.gold_label
                return s
            li = visit(node.first_child())
            ri = visit(node.last_child())
            s = slot[0]
            slot[0] += 1
            enc.kind[ti, s] = 2
            enc.left[ti, s] = li
            enc.right[ti, s] = ri
            pair = (node.first_child().label, node.last_child().label)
            enc.cat[ti, s] = cat_index[pair] if cat_index else 0
            enc.ccat[ti, s] = (ccat_index[node.label]
                               if ccat_index else 0)
            enc.gold[ti, s] = node.gold_label
            return s

        enc.root[ti] = visit(tree)
    return enc
