"""Recursive Neural Tensor Network (sentiment-style classification over
binary parse trees).

Parity: reference nlp/models/rntn/RNTN.java:68 (1,345 LoC) —
`forwardPropagateTree` (:717: preterminal vector = f(wordvec); binary
vector = f(W·[l;r;1] + [l;r]ᵀ·T·[l;r])), `backpropDerivativesAndError`
(:577-684: class-weighted softmax cross-entropy at every labeled node,
deltas recursed down through W and the tensor), per-category-pair
parameter maps (binaryTransform/binaryINd4j/binaryClassification/
unaryClassification), AdaGrad with periodic reset (adagradResetFrequency),
and the four regularization costs (regTransformMatrix, regTransformINDArray,
regClassification, regWordVector). Builder surface mirrors RNTN.Builder.
The port's counterpart of the JAX package's `nlp/rntn.py`, with the same
names, parameter shapes, loss and update.

Design: a LEVEL SCHEDULE, not a scan over slots. The JAX package scans
every post-order slot of every tree (computing both branches a slot).
Here a batch of trees is lowered by `encode_trees` and then grouped by
height (`level_schedule`: preterminals 0, a binary node 1 + the larger
height of its children), and the forward runs one batched step a level
over every node of that height in every tree:
- level 0 gathers `E[word]` and applies the activation;
- each binary level gathers its children's vectors from the levels
  below (a tensor a level, concatenated; nothing is written in place, so
  autograd's saved tensors stay valid) and computes `W[cat]·[l; r; 1]`,
  plus, with tensors on, the bilinear term as a `(B, 2d) × (2d, d·2d)`
  matmul and a batched dot. Within a level, nodes are ordered by
  category, so a per-category model runs one product a category a level.
The sequential steps are the tallest tree's depth, not `max_nodes`.
Autograd through this forward gives the gradient. `fit` takes one
full-batch AdaGrad step an epoch (`h += g²`, `p -= lr·g/(√h + 1e-6)`),
the history reset every `adagrad_reset_frequency` epochs counted within
one call; it uploads the schedule from pinned memory and reads nothing
back from the device until its final loss. Each step reads `lr`, the
`reg_*` costs and `use_tensors` from the model as they are then (the JAX
package's jitted step keeps the values of its first trace).

Parameters are drawn from a `torch.Generator` seeded with `seed` (on the
host, then moved), with the JAX package's shapes, scales and `[I/2, I/2,
0]` offset; the values differ from its `jax.random` streams.
`weights.rntn_state_from_jax` carries a JAX model's parameters and
indexes across. `device=None` is the card and raises without one.
"""

from __future__ import annotations

import logging
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.nlp.tree import EncodedTrees, Tree, encode_trees
from deeplearning4j_tpu_torch.ops.activations import apply_activation

log = logging.getLogger(__name__)

ADAGRAD_EPS = 1e-6
UNK = "UNK"


def _append_one(v: torch.Tensor) -> torch.Tensor:
    return torch.cat([v, v.new_ones(v.shape[:-1] + (1,))], -1)


def _transform_offset(d: int) -> torch.Tensor:
    """[I/2, I/2, 0] near-averaging init offset for the binary transform
    (reference randomTransformMatrix): the initial composition of children
    [l; r; 1] is their average."""
    eye = torch.eye(d)
    return torch.cat([eye, eye, torch.zeros(d, 1)], dim=1) / 2.0


def upload(a, device: torch.device) -> torch.Tensor:
    """A host array or tensor on `device`; to a CUDA device through pinned
    memory with a non-blocking copy, so the host does not wait."""
    t = torch.as_tensor(np.ascontiguousarray(a)) if isinstance(
        a, np.ndarray) else a
    if device.type != "cuda" or t.is_cuda:
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class Level(NamedTuple):
    """One binary level: its rows in the schedule's child arrays
    [start, stop) and its category segments (cat, begin, end), relative
    to the level."""
    start: int
    stop: int
    segments: Tuple[Tuple[int, int, int], ...]


class LevelSchedule(NamedTuple):
    """A batch of encoded trees as device-ready levels. Nodes sit in
    level order (level, then category, then tree-major slot); `left` /
    `right` hold each binary node's children as positions in that order,
    which always lie in lower levels."""
    n_trees: int
    n_pre: int                  # preterminals: level 0, the first rows
    word: torch.Tensor          # (n_pre,) word ids
    left: torch.Tensor          # (N - n_pre,) child positions
    right: torch.Tensor
    cat: torch.Tensor           # (N,) transform / binary-class index
    ccat: torch.Tensor          # (N,) unary-class index
    gold: torch.Tensor          # (N,) gold label, 0 where unlabeled
    labeled: torch.Tensor       # (N,) bool
    roots: torch.Tensor         # (n_trees,) each root's position
    levels: Tuple[Level, ...]   # the binary levels, bottom up
    position: np.ndarray        # (n_trees, max_nodes) slot -> position

    @property
    def n_levels(self) -> int:
        """Sequential steps: the preterminal level and the binary ones
        (the tallest tree's depth)."""
        return 1 + len(self.levels)


def node_heights(enc: EncodedTrees) -> np.ndarray:
    """(n_trees, max_nodes) height of each slot: preterminals 0, a binary
    node 1 + the larger height of its children, pads -1. Post-order puts
    children first, so one pass over the slots fills it."""
    n, m = enc.kind.shape
    height = np.full((n, m), -1, np.int64)
    rows = np.arange(n)
    for s in range(m):
        kind = enc.kind[:, s]
        below = np.maximum(height[rows, enc.left[:, s]],
                           height[rows, enc.right[:, s]])
        height[:, s] = np.where(kind == 1, 0,
                                np.where(kind == 2, 1 + below, -1))
    return height


def level_schedule(enc: EncodedTrees, device) -> LevelSchedule:
    """Group `enc`'s nodes by height and upload the index arrays (host
    numpy, one pinned upload an array)."""
    n, m = enc.kind.shape
    height = node_heights(enc)
    trees, slots = np.nonzero(enc.kind > 0)
    level = height[trees, slots]
    cat = enc.cat[trees, slots].astype(np.int64)
    order = np.lexsort((trees * m + slots, np.where(level > 0, cat, 0),
                        level))
    trees, slots, level, cat = (trees[order], slots[order], level[order],
                                cat[order])
    position = np.full((n, m), -1, np.int64)
    position[trees, slots] = np.arange(trees.size)
    n_pre = int((level == 0).sum())
    bt, bs = trees[n_pre:], slots[n_pre:]
    left = position[bt, enc.left[bt, bs]]
    right = position[bt, enc.right[bt, bs]]
    levels = []
    bounds = np.searchsorted(level, np.arange(1, level.max() + 2)) - n_pre
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        cats = cat[n_pre + lo:n_pre + hi]
        cuts = np.flatnonzero(np.diff(cats)) + 1
        edges = [0, *cuts.tolist(), int(hi - lo)]
        levels.append(Level(int(lo), int(hi), tuple(
            (int(cats[a]), a, b) for a, b in zip(edges[:-1], edges[1:]))))
    gold = enc.gold[trees, slots].astype(np.int64)

    def on(a):
        return upload(np.asarray(a, np.int64), device)

    return LevelSchedule(
        n_trees=n, n_pre=n_pre,
        word=on(enc.word[trees[:n_pre], slots[:n_pre]]),
        left=on(left), right=on(right), cat=on(cat),
        ccat=on(enc.ccat[trees, slots]), gold=on(np.maximum(gold, 0)),
        labeled=upload(gold >= 0, device),
        roots=on(position[np.arange(n), enc.root]),
        levels=tuple(levels), position=position)


def _classify(h1: torch.Tensor, w: torch.Tensor, idx: torch.Tensor):
    """Logits of each row of h1 under its own classifier w[idx]."""
    n, c, _ = w.shape
    if n == 1:
        return h1 @ w[0].T
    every = (h1 @ w.reshape(n * c, -1).T).view(-1, n, c)
    return every.gather(1, idx.view(-1, 1, 1).expand(-1, 1, c))[:, 0]


class RNTN:
    """See module docstring. Numbers default to the reference's
    (RNTN.java:70-100): 25 hidden units, 3 output classes, tanh, tensors
    on, combined classification, simplified (shared-parameter) model."""

    def __init__(self, *, num_hidden: int = 25, num_outs: int = 3,
                 use_tensors: bool = True, combine_classification: bool = True,
                 simplified_model: bool = True,
                 activation_function: str = "tanh",
                 lr: float = 0.01,
                 scaling_for_init: float = 1.0,
                 adagrad_reset_frequency: int = 1,
                 reg_transform_matrix: float = 0.001,
                 reg_transform_tensor: float = 0.001,
                 reg_classification: float = 0.0001,
                 reg_word_vector: float = 0.0001,
                 class_weights: Optional[Dict[int, float]] = None,
                 feature_vectors: Optional[Dict[str, np.ndarray]] = None,
                 lower_case_feature_names: bool = False,
                 seed: int = 123, device=None):
        self.num_hidden = num_hidden
        self.num_outs = num_outs
        self.use_tensors = use_tensors
        self.combine_classification = combine_classification
        self.simplified_model = simplified_model
        self.activation_function = activation_function
        self.lr = lr
        self.scaling_for_init = scaling_for_init
        self.adagrad_reset_frequency = adagrad_reset_frequency
        self.reg_transform_matrix = reg_transform_matrix
        self.reg_transform_tensor = reg_transform_tensor
        self.reg_classification = reg_classification
        self.reg_word_vector = reg_word_vector
        self.class_weights = dict(class_weights or {})
        self.lower_case_feature_names = lower_case_feature_names
        self._feature_vectors_init = feature_vectors
        self.device = default_device(device)
        self._gen = torch.Generator().manual_seed(seed)

        self.word_index: Dict[str, int] = {}
        self.cat_index: Optional[Dict[tuple, int]] = None
        self.ccat_index: Optional[Dict[str, int]] = None
        self._params: Optional[Dict[str, torch.Tensor]] = None
        self._adagrad_hist: Optional[Dict[str, torch.Tensor]] = None
        self.value = 0.0  # last training loss (reference `value`)

    # ------------------------------------------------------------- builder
    class Builder:
        """Fluent builder mirroring reference RNTN.Builder."""

        def __init__(self):
            self._kw = {}

        def __getattr__(self, name):
            def setter(value):
                self._kw[name] = value
                return self

            return setter

        def build(self) -> "RNTN":
            return RNTN(**self._kw)

    @classmethod
    def builder(cls) -> "RNTN.Builder":
        return cls.Builder()

    # ------------------------------------------------------------ vocab/init
    def _norm_word(self, w: str) -> str:
        return w.lower() if self.lower_case_feature_names else w

    def _build_vocab(self, trees: List[Tree]) -> None:
        if not self.word_index:
            self.word_index = {UNK: 0}
        for t in trees:
            for tok in t.tokens():
                tok = self._norm_word(tok)
                if tok not in self.word_index:
                    self.word_index[tok] = len(self.word_index)

    def _build_categories(self, trees: List[Tree]) -> None:
        """Non-simplified model: assign parameter indices per category pair
        (reference binaryTransform keyed by (leftCategory, rightCategory))."""
        if self.simplified_model:
            return
        self.cat_index = self.cat_index or {}
        self.ccat_index = self.ccat_index or {}

        def visit(node: Tree):
            if node.is_leaf():
                return
            self.ccat_index.setdefault(node.label, len(self.ccat_index))
            if not node.is_preterminal():
                pair = (node.first_child().label, node.last_child().label)
                self.cat_index.setdefault(pair, len(self.cat_index))
            for c in node.children:
                visit(c)

        for t in trees:
            visit(t)

    def _normal(self, shape) -> torch.Tensor:
        """Standard normal draws for the initial and grown parameters."""
        return torch.randn(tuple(shape), generator=self._gen)

    def _pretrained_rows(self, emb: np.ndarray, first: int) -> int:
        """Copy the lookup table's vectors into rows >= first of emb;
        the number found."""
        d = self.num_hidden
        found = 0
        for word, idx in self.word_index.items():
            if idx >= first:
                vec = self._feature_vectors_init.get(word)
                if vec is not None:
                    emb[idx] = np.asarray(vec, np.float32)[:d]
                    found += 1
        return found

    def _grow_params(self) -> None:
        """Resize parameter stacks after vocab/categories grew on a later
        fit() call (the reference mutates its maps in place; here the
        stacked arrays must grow or gathers go out of range)."""
        p = self._params
        d = self.num_hidden

        def grow(name, n_new, init_scale, offset=None):
            arr = p[name]
            n_old = arr.shape[0]
            if n_new <= n_old:
                return
            extra = torch.as_tensor(self._normal(
                (n_new - n_old,) + tuple(arr.shape[1:]))) * init_scale
            if offset is not None:
                extra = extra + offset[None]
            extra = upload(extra, self.device)
            p[name] = torch.cat([arr, extra], dim=0)
            if self._adagrad_hist is not None:
                self._adagrad_hist[name] = torch.cat(
                    [self._adagrad_hist[name], torch.zeros_like(extra)],
                    dim=0)

        n_emb_old = p["E"].shape[0]
        grow("E", len(self.word_index), self.scaling_for_init / d)
        if self._feature_vectors_init and p["E"].shape[0] > n_emb_old:
            # words first seen on a later fit() still get their pretrained
            # vectors when the lookup table has them, like _init_params
            emb = p["E"].cpu().numpy().copy()
            self._pretrained_rows(emb, n_emb_old)
            p["E"] = upload(emb, self.device)
        n_cat = len(self.cat_index) if self.cat_index else 1
        n_ccat = len(self.ccat_index) if self.ccat_index else 1
        # categories first seen on a later fit() get the same [I/2, I/2, 0]
        # near-averaging offset as _init_params (randomTransformMatrix)
        grow("W", n_cat, self.scaling_for_init / (2 * d),
             offset=_transform_offset(d))
        grow("Wu", n_ccat, self.scaling_for_init / d)
        if "T" in p:
            grow("T", n_cat, self.scaling_for_init / (4 * d * d))
        if "Wb" in p:
            grow("Wb", n_cat, self.scaling_for_init / d)

    def _init_params(self) -> None:
        if self._params is not None:
            self._grow_params()
            return
        d, c = self.num_hidden, self.num_outs
        n_cat = len(self.cat_index) if self.cat_index else 1
        n_ccat = len(self.ccat_index) if self.ccat_index else 1
        v = len(self.word_index)
        scale = self.scaling_for_init
        normal = lambda *s: torch.as_tensor(self._normal(s))  # noqa: E731
        # reference init: randn scaled by scalingForInit; identity added to
        # the transform's square blocks so the initial composition is
        # near-averaging (RNTN randomTransformMatrix)
        w = normal(n_cat, d, 2 * d + 1) * scale / (2 * d)
        params = {"W": w + _transform_offset(d)[None],
                  "Wu": normal(n_ccat, c, d + 1) * scale / d}
        if self.use_tensors:
            params["T"] = (normal(n_cat, d, 2 * d, 2 * d)
                           * scale / (4 * d * d))
        if not self.combine_classification:
            params["Wb"] = normal(n_cat, c, d + 1) * scale / d
        rand = normal(v, d) * scale / d
        if self._feature_vectors_init:
            emb = np.zeros((v, d), np.float32)
            found = self._pretrained_rows(emb, 0)
            missing = emb.sum(-1) == 0
            emb[missing] = rand.numpy()[missing]
            log.info("RNTN: %d/%d word vectors from lookup table", found, v)
            params["E"] = torch.from_numpy(emb)
        else:
            params["E"] = rand
        self._params = {k: upload(t.float().contiguous(), self.device)
                        for k, t in params.items()}

    # ------------------------------------------------------------- forward
    def schedule(self, trees: List[Tree],
                 max_nodes: Optional[int] = None) -> LevelSchedule:
        """`trees` encoded and grouped into levels on this model's
        device."""
        return level_schedule(self.encode(trees, max_nodes=max_nodes),
                              self.device)

    def node_vectors(self, params, sched: LevelSchedule) -> torch.Tensor:
        """(N, d) node vectors in level order: one batched step a level."""
        act = self.activation_function
        d = self.num_hidden
        levels = [apply_activation(
            act, params["E"].index_select(0, sched.word))]
        w = params["W"]
        if self.use_tensors:
            t = params["T"]
            # [cat, i, d, j] flattened: child @ t_mat[c] is (B, d·2d)
            t_mat = t.permute(0, 2, 1, 3).reshape(t.shape[0], 2 * d,
                                                   d * 2 * d)
        for lv in sched.levels:
            below = levels[0] if len(levels) == 1 else torch.cat(levels)
            child = torch.cat(
                [below.index_select(0, sched.left[lv.start:lv.stop]),
                 below.index_select(0, sched.right[lv.start:lv.stop])], 1)
            parts = []
            for c, a, b in lv.segments:
                ch = child if b - a == child.shape[0] else child[a:b]
                pre = _append_one(ch) @ w[c].T
                if self.use_tensors:
                    v = (ch @ t_mat[c]).view(-1, d, 2 * d)
                    pre = pre + torch.bmm(v, ch.unsqueeze(2))[:, :, 0]
                parts.append(pre)
            levels.append(apply_activation(
                act, parts[0] if len(parts) == 1 else torch.cat(parts)))
        return levels[0] if len(levels) == 1 else torch.cat(levels)

    def logits(self, params, sched: LevelSchedule,
               vecs: torch.Tensor) -> torch.Tensor:
        """Per-node class logits: unary classification for preterminals (and
        everything when combineClassification), else binary classification."""
        vecs1 = _append_one(vecs)
        if self.combine_classification or "Wb" not in params:
            return _classify(vecs1, params["Wu"], sched.ccat)
        n = sched.n_pre
        return torch.cat([
            _classify(vecs1[:n], params["Wu"], sched.ccat[:n]),
            _classify(vecs1[n:], params["Wb"], sched.cat[n:])])

    def node_errors(self, sched: LevelSchedule, logits: torch.Tensor,
                    class_weights: torch.Tensor) -> torch.Tensor:
        """Per-node class-weighted cross-entropy (0 where unlabeled)."""
        logp = F.log_softmax(logits, dim=-1)
        ce = -logp.gather(1, sched.gold[:, None])[:, 0]
        return torch.where(sched.labeled, ce * class_weights[sched.gold],
                           torch.zeros_like(ce))

    def _class_weight_vec(self) -> torch.Tensor:
        w = np.ones((self.num_outs,), np.float32)
        for k, v in self.class_weights.items():
            w[k] = v
        return upload(w, self.device)

    def schedule_loss(self, params, sched: LevelSchedule,
                      class_weights: torch.Tensor) -> torch.Tensor:
        """Mean per-tree node error + the four L2 costs
        (reference scaleAndRegularize, RNTN.java:550-575), a 0-d tensor."""
        vecs = self.node_vectors(params, sched)
        errors = self.node_errors(sched, self.logits(params, sched, vecs),
                                  class_weights)
        loss = errors.sum() / sched.n_trees
        loss = loss + self.reg_transform_matrix / 2 * torch.sum(
            params["W"] ** 2)
        if "T" in params:
            loss = loss + self.reg_transform_tensor / 2 * torch.sum(
                params["T"] ** 2)
        loss = loss + self.reg_classification / 2 * torch.sum(
            params["Wu"] ** 2)
        if "Wb" in params:
            loss = loss + self.reg_classification / 2 * torch.sum(
                params["Wb"] ** 2)
        loss = loss + self.reg_word_vector / 2 * torch.sum(params["E"] ** 2)
        return loss

    def loss_fn(self, params, enc: EncodedTrees) -> torch.Tensor:
        """The loss of `params` on encoded trees (the JAX package's
        `loss_fn`)."""
        return self.schedule_loss(params, level_schedule(enc, self.device),
                                  self._class_weight_vec())

    def loss_and_grads(self, params, sched: LevelSchedule,
                       class_weights: torch.Tensor):
        """(loss, {name: gradient}) by autograd through the levels."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss = self.schedule_loss(leaves, sched, class_weights)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    # ------------------------------------------------------------- training
    def step(self, sched: LevelSchedule, class_weights: torch.Tensor):
        """One full-batch AdaGrad step on the model's params and history;
        the loss before it, a 0-d device tensor."""
        loss, grads = self.loss_and_grads(self._params, sched, class_weights)
        with torch.no_grad():
            for k, g in grads.items():
                h = self._adagrad_hist[k] + g * g
                self._adagrad_hist[k] = h
                self._params[k] = self._params[k] - self.lr * g / (
                    torch.sqrt(h) + ADAGRAD_EPS)
        return loss

    def prepare(self, trees: List[Tree],
                max_nodes: Optional[int] = None) -> LevelSchedule:
        """Vocab, categories and parameters (grown as needed), AdaGrad
        history, and the trees' schedule on the device."""
        self._build_vocab(trees)
        self._build_categories(trees)
        self._init_params()
        if self._adagrad_hist is None:
            self._adagrad_hist = {k: torch.zeros_like(v)
                                  for k, v in self._params.items()}
        return self.schedule(trees, max_nodes=max_nodes)

    def run_epochs(self, sched: LevelSchedule, epochs: int) -> torch.Tensor:
        """`epochs` AdaGrad steps with the history reset every
        `adagrad_reset_frequency` epochs (0 = never, reference
        adagradResetFrequency); each epoch's loss (before its step), an
        (epochs,) device tensor. Reads nothing from the device."""
        cw = self._class_weight_vec()
        losses = []
        for epoch in range(epochs):
            if (self.adagrad_reset_frequency
                    and epoch and epoch % self.adagrad_reset_frequency == 0):
                self._adagrad_hist = {k: torch.zeros_like(v)
                                      for k, v in self._params.items()}
            losses.append(self.step(sched, cw))
        return torch.stack(losses)

    def fit(self, trees: List[Tree], epochs: int = 1,
            max_nodes: Optional[int] = None) -> float:
        """Train on labeled trees; returns the final loss, the one value
        read from the device."""
        losses = self.run_epochs(self.prepare(trees, max_nodes), epochs)
        self.value = float(losses[-1])
        return self.value

    # ------------------------------------------------------------ inference
    def encode(self, trees: List[Tree],
               max_nodes: Optional[int] = None) -> EncodedTrees:
        # word_index keys are already normalized at vocab-build time; the
        # same normalization must apply to looked-up tree tokens
        return encode_trees(trees, self.word_index,
                            unk_index=self.word_index.get(UNK, 0),
                            cat_index=self.cat_index,
                            ccat_index=self.ccat_index, max_nodes=max_nodes,
                            word_transform=self._norm_word)

    def _check_fitted(self, what: str) -> None:
        if self._params is None:
            raise RuntimeError(f"fit() the RNTN before {what}")

    def forward_propagate_tree(self, tree: Tree) -> None:
        """Annotate every internal node with vector/prediction/error
        (reference forwardPropagateTree :717 contract: after the call each
        non-leaf node carries its node vector and class predictions)."""
        self._check_fitted("forward propagation")
        sched = self.schedule([tree])
        with torch.no_grad():
            vecs = self.node_vectors(self._params, sched)
            logits = self.logits(self._params, sched, vecs)
            errors = self.node_errors(sched, logits,
                                      self._class_weight_vec())
            preds = F.softmax(logits, dim=-1)
        vecs, preds, errors = (vecs.cpu().numpy(), preds.cpu().numpy(),
                               errors.cpu().numpy())
        position = sched.position[0]
        slot = [0]

        def visit(node: Tree):
            if node.is_leaf():
                return
            if not node.is_preterminal():
                for c in node.children:
                    visit(c)
            i = position[slot[0]]
            slot[0] += 1
            node.vector = vecs[i]
            node.prediction = preds[i]
            node.error = float(errors[i])

        visit(tree)

    def predict(self, tree: Tree) -> int:
        """Predicted class of the root node."""
        self.forward_propagate_tree(tree)
        return int(np.argmax(tree.prediction))

    def output(self, trees: List[Tree]) -> np.ndarray:
        """Root-node class probabilities for a batch of trees — one
        encode + one batched forward, not a per-tree Python loop."""
        self._check_fitted("inference")
        sched = self.schedule(trees)
        with torch.no_grad():
            vecs = self.node_vectors(self._params, sched)
            logits = self.logits(self._params, sched, vecs)
            return F.softmax(logits[sched.roots], dim=-1).cpu().numpy()

    # ----------------------------------------------------------- Model-ish
    def params(self):
        return self._params

    def set_params(self, params) -> None:
        """Install a {name: array or tensor} table, as float32 tensors on
        this model's device."""
        self._params = {k: upload(torch.as_tensor(np.array(v, np.float32))
                                  if not isinstance(v, torch.Tensor)
                                  else v.detach().float().contiguous(),
                                  self.device)
                        for k, v in params.items()}

    def score(self, trees: List[Tree]) -> float:
        with torch.no_grad():
            return float(self.loss_fn(self._params, self.encode(trees)))

    def num_parameters(self) -> int:
        return sum(int(t.numel()) for t in self._params.values())
