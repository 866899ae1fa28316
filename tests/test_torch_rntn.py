"""The PyTorch port's trees and RNTN (deeplearning4j_tpu_torch/nlp/tree.py,
nlp/rntn.py) held against the JAX package's, on the CPU.

The port's forward is a level schedule (one batched step a tree level);
the JAX package's a scan over post-order slots. From the same parameters
(JAX's, carried with `weights.rntn_state_from_jax`) and the same trees:

- the loss and every gradient within STEP_TOL (1e-5) of the largest
  |entry|, in every configuration (tensors on and off, per-category,
  binary classification, class weights, feature vectors);
- one AdaGrad step, given JAX's gradient, within 1e-6: the update's
  arithmetic alone;
- a 5-epoch `fit` with a reset frequency of 2: the final loss within
  STEP_TOL, every parameter and AdaGrad history within FIT_TOL. FIT_TOL
  is 5e-3, not 1e-5, from this reading: AdaGrad's first update after a
  reset is `lr·g/(|g| + 1e-6)`, so an entry whose gradient is below
  1e-6 (T's, W's: products of small child vectors) moves by an amount
  that the gradient's own rounding shifts up to lr/1e-6 = 1e5 times.
  Measured at num_hidden 8, lr 0.1, on the six sentiment trees: T's
  entry (0, 2, 10, 13) has |g| 3.79e-7 with JAX and the port 1.6e-10
  apart, and ends 7.4e-5 of max |T| off after the first step, 1.4e-4
  after five. Over the configurations below (num_hidden 6): per-category
  T 9.1e-4 and W 5.1e-4, every other T at most 3.8e-4, everything else
  at most 5.6e-5, the loss at most 5.7e-7. Scaling lr by 0.999 in the
  port alone moves T by 0.24 and the loss by 6e-4, so the loss bound
  and FIT_TOL still catch a wrong update;
- a refit that grows every stack, with JAX's draws for the new rows
  handed to the port's `_normal`;
- `output`, and `forward_propagate_tree`'s per-node vectors,
  predictions and errors, within STEP_TOL.

The level schedule is also held against a slot-by-slot loop written
here (the JAX package's order) on tall left-chained trees, where every
binary level holds one node a tree. The cases of `tests/test_rntn.py`
then run on the port, the seed-sensitive ones from JAX's initial
parameters for the same seed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import rntn as jrntn
from deeplearning4j_tpu.nlp import tree as jtree
from deeplearning4j_tpu_torch.nlp import RNTN, binarize, parse_tree
from deeplearning4j_tpu_torch.nlp.rntn import (level_schedule, node_heights,
                                               upload)
from deeplearning4j_tpu_torch.ops.activations import apply_activation
from deeplearning4j_tpu_torch.weights import (rntn_params_from_jax,
                                              rntn_params_to_numpy,
                                              rntn_state_from_jax)

STEP_TOL = 1e-5   # of the largest |entry|: a loss, a gradient, a forward
UPDATE_TOL = 1e-6  # one AdaGrad update from the same gradient
FIT_TOL = 5e-3    # parameters after a 5-epoch fit (see the docstring)
CPU = "cpu"

TEXTS = [
    "(0 (0 (0 bad) (0 movie)) (0 (0 truly) (0 awful)))",
    "(1 (1 (1 good) (1 movie)) (1 (1 truly) (1 great)))",
    "(0 (0 (0 awful) (0 film)) (0 (0 very) (0 bad)))",
    "(1 (1 (1 great) (1 film)) (1 (1 very) (1 good)))",
    "(0 (0 (0 boring) (0 plot)) (0 (0 bad) (0 acting)))",
    "(1 (1 (1 brilliant) (1 plot)) (1 (1 good) (1 acting)))",
]
#: ragged shapes: an unlabeled inner node, a right-heavy tree, one token
RAGGED = ["(1 (-1 (1 good) (1 show)) (1 (1 very) (1 fun)))",
          "(0 (1 x) (0 (1 (1 y) (1 z)) (0 w)))",
          "(1 q)"]
SYNTAX = ["(S (NP (DT the) (NN cat)) (VP (VB sat)))",
          "(S (NP (DT a) (NN dog)) (VP (VB ran) (RB fast)))",
          "(S (NP (DT the) (JJ big) (NN bird)) (VP (VB sang)))"]


def sentiment_trees(mod=None):
    """Tiny synthetic sentiment corpus (tests/test_rntn.py's): class 0 =
    negative, 1 = positive, every node labelled (SST's convention);
    parsed by `mod` (the JAX package's tree module) or the port."""
    parse = mod.parse_tree if mod is not None else parse_tree
    return [parse(t) for t in TEXTS]


def both(texts, syntax=False):
    """The same trees parsed by each package (syntactic trees binarized
    with gold label 1 at the root)."""
    out = []
    for mod in (jtree, None):
        parse = mod.parse_tree if mod else parse_tree
        bin_ = mod.binarize if mod else binarize
        trees = [parse(t) for t in texts]
        if syntax:
            for t in trees:
                t.gold_label = 1
            trees = [bin_(t) for t in trees]
        out.append(trees)
    return out


CONFIGS = {
    "simplified": dict(),
    "no_tensors": dict(use_tensors=False),
    "binary_classes": dict(combine_classification=False),
    "per_category": dict(simplified_model=False,
                         combine_classification=False),
    "class_weights": dict(class_weights={0: 3.0, 1: 0.5}),
    "feature_vectors": dict(feature_vectors={
        "bad": np.linspace(-1, 1, 6).astype(np.float32),
        "good": -np.ones(6, np.float32)}),
}


def config_trees(name):
    if name == "per_category":
        return both(SYNTAX, syntax=True)
    return both(TEXTS + RAGGED)


def jax_params(m) -> dict:
    return {k: np.asarray(v) for k, v in m.params().items()}


def pair(jtrees, **kw):
    """A JAX RNTN with its vocab, categories and initial parameters for
    `jtrees`, and a port RNTN on the CPU carrying all of them."""
    kw = {"num_hidden": 6, "num_outs": 2, "lr": 0.1, "seed": 0, **kw}
    jm = jrntn.RNTN(**kw)
    jm._build_vocab(jtrees)
    jm._build_categories(jtrees)
    jm._init_params()
    tm = RNTN(device=CPU, **kw)
    rntn_state_from_jax(tm, jax_params(jm), jm.word_index, jm.cat_index,
                        jm.ccat_index)
    return jm, tm


def rel_err(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30))


def table_errs(ref: dict, got: dict) -> dict:
    assert set(ref) == set(got)
    return {k: rel_err(np.asarray(ref[k]), got[k]) for k in ref}


def jax_grads(jm, jtrees):
    enc = jm.encode(jtrees)
    loss, grads = jax.value_and_grad(jm.loss_fn)(jm._params, enc)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def jax_normals(key):
    """The draws the JAX package's `_grow_params` makes from `key`, one
    split a call, as the port's `_normal` takes them."""
    state = {"key": key}

    def draw(shape):
        state["key"], sub = jax.random.split(state["key"])
        return np.asarray(jax.random.normal(sub, tuple(shape)))

    return draw


# ------------------------------------------------------------ the trees
class TestTree:
    def test_parse_round_trip(self):
        t = parse_tree("(2 (1 bad) (3 movie))")
        assert t.gold_label == 2
        assert [c.gold_label for c in t.children] == [1, 3]
        assert t.tokens() == ["bad", "movie"]
        assert t.children[0].is_preterminal()
        assert not t.is_leaf() and t.depth() == 2
        assert t.to_sexpr() == "(2 (1 bad) (3 movie))"

    def test_category_labels(self):
        t = parse_tree("(S (NP (DT the) (NN cat)) (VP (VB sat)))")
        assert t.label == "S"
        assert t.children[0].label == "NP"
        assert t.tokens() == ["the", "cat", "sat"]

    def test_clone_independent(self):
        t = parse_tree("(1 (1 a) (1 b))")
        c = t.clone()
        c.children[0].gold_label = 0
        assert t.children[0].gold_label == 1

    def test_binarize_nary(self):
        t = parse_tree("(1 (1 a) (1 b) (1 c))")
        b = binarize(t)
        assert len(b.children) == 2
        assert b.tokens() == ["a", "b", "c"]

    def test_binarize_collapses_unary_chain(self):
        t = parse_tree("(2 (1 (0 word)))")
        b = binarize(t)
        assert b.is_preterminal()
        assert b.gold_label == 0  # innermost label kept

    def test_error_sum(self):
        t = parse_tree("(1 (1 a) (1 b))")
        t.error = 1.0
        t.children[0].error = 0.5
        assert t.error_sum() == pytest.approx(1.5)

    def test_binarize_does_not_mutate_input(self):
        t = parse_tree("(2 (-1 (-1 word)))")
        b = binarize(t)
        assert t.children[0].gold_label == -1  # input untouched
        assert t.children[0].children[0].gold_label == -1
        assert b.gold_label == 2  # unlabeled collapsed chain takes outer
        assert b is not t.children[0]

    @pytest.mark.parametrize("texts", [TEXTS + RAGGED, SYNTAX])
    def test_parse_binarize_encode_match_jax(self, texts):
        """s-expressions, binarized shapes and every encoded array
        (post-order slots) equal to the JAX package's."""
        jt, tt = both(texts, syntax=texts is SYNTAX)
        assert [t.to_sexpr() for t in tt] == [t.to_sexpr() for t in jt]
        assert [t.depth() for t in tt] == [t.depth() for t in jt]
        words = {w: i for i, w in enumerate(
            sorted({w for t in jt for w in t.tokens()}), start=1)}
        cats = {}
        ccats = {}
        for t in jt:
            for node in _internal(t):
                ccats.setdefault(node.label, len(ccats))
                if not node.is_preterminal():
                    cats.setdefault((node.children[0].label,
                                     node.children[-1].label), len(cats))
        je = jtree.encode_trees(jt, words, cat_index=cats, ccat_index=ccats,
                                max_nodes=16)
        from deeplearning4j_tpu_torch.nlp.tree import encode_trees
        te = encode_trees(tt, words, cat_index=cats, ccat_index=ccats,
                          max_nodes=16)
        for f in je._fields:
            np.testing.assert_array_equal(getattr(te, f), getattr(je, f))
        with pytest.raises(ValueError, match="exceeds"):
            encode_trees(tt, words, max_nodes=2)


def _internal(t):
    if t.is_leaf():
        return []
    out = [t]
    if not t.is_preterminal():
        for c in t.children:
            out.extend(_internal(c))
    return out


# --------------------------------------------------- parity with the JAX
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_loss_and_every_gradient_match_jax(config):
    jt, tt = config_trees(config)
    jm, tm = pair(jt, **CONFIGS[config])
    jl, jg = jax_grads(jm, jt)
    sched = tm.schedule(tt)
    tl, tg = tm.loss_and_grads(tm.params(), sched, tm._class_weight_vec())
    assert abs(float(tl) - jl) <= STEP_TOL * abs(jl)
    errs = table_errs(jg, tg)
    assert max(errs.values()) <= STEP_TOL, errs
    assert abs(tm.score(tt) - jm.score(jt)) <= STEP_TOL * abs(jl)


@pytest.mark.parametrize("config", ["simplified", "per_category"])
def test_one_adagrad_step_matches_jax(config, monkeypatch):
    """JAX's jitted step against the port's `step` handed JAX's gradient:
    params and history within UPDATE_TOL (the gradients themselves are
    held in test_loss_and_every_gradient_match_jax)."""
    jt, tt = config_trees(config)
    jm, tm = pair(jt, **CONFIGS[config])
    jl, jg = jax_grads(jm, jt)
    enc = {k: jnp.asarray(v) for k, v in jm.encode(jt)._asdict().items()}
    hist0 = jax.tree_util.tree_map(jnp.zeros_like, jm._params)
    params1, hist1, _ = jm._get_step()(jm._params, hist0, enc)
    sched = tm.prepare(tt)
    monkeypatch.setattr(tm, "loss_and_grads", lambda *a: (
        torch.tensor(jl), {k: torch.tensor(g) for k, g in jg.items()}))
    assert float(tm.step(sched, tm._class_weight_vec())) == \
        pytest.approx(jl)
    for ref, got in ((params1, tm.params()), (hist1, tm._adagrad_hist)):
        errs = table_errs({k: np.asarray(v) for k, v in ref.items()}, got)
        assert max(errs.values()) <= UPDATE_TOL, errs


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_five_epoch_fit_matches_jax(config):
    jt, tt = config_trees(config)
    kw = {**CONFIGS[config], "adagrad_reset_frequency": 2}
    jm, tm = pair(jt, **kw)
    jl = jm.fit(jt, epochs=5)
    tl = tm.fit(tt, epochs=5)
    assert abs(tl - jl) <= STEP_TOL * abs(jl)
    errs = table_errs(jax_params(jm), tm.params())
    errs.update({f"hist_{k}": v for k, v in table_errs(
        {k: np.asarray(v) for k, v in jm._adagrad_hist.items()},
        tm._adagrad_hist).items()})
    assert max(errs.values()) <= FIT_TOL, errs


def test_refit_growing_every_stack_matches_jax():
    """A second fit meets new words and new category pairs: E, W, Wu, T
    and Wb grow (with the AdaGrad history), from JAX's draws."""
    (jt1, tt1), (jt2, tt2) = both(SYNTAX[:2], True), both(
        ["(S (NP (DT the) (NN cow)) (VP (VB ate) (NP (DT the) (NN hay))))",
         "(S (PP (IN in) (NP (NN time))) (VP (VB went)))"], True)
    kw = dict(CONFIGS["per_category"], adagrad_reset_frequency=2)
    jm, tm = pair(jt1, **kw)
    jm.fit(jt1, epochs=2)
    tm.fit(tt1, epochs=2)
    shapes = {k: v.shape for k, v in jm.params().items()}
    tm._normal = jax_normals(jm.key)
    jl = jm.fit(jt2, epochs=3)
    tl = tm.fit(tt2, epochs=3)
    assert all(jm.params()[k].shape[0] > shapes[k][0] for k in shapes)
    assert {k: tuple(v.shape) for k, v in tm.params().items()} == \
        {k: tuple(v.shape) for k, v in jm.params().items()}
    assert tm.word_index == jm.word_index
    assert tm.cat_index == jm.cat_index and tm.ccat_index == jm.ccat_index
    assert abs(tl - jl) <= STEP_TOL * abs(jl)
    errs = table_errs(jax_params(jm), tm.params())
    errs.update({f"hist_{k}": v for k, v in table_errs(
        {k: np.asarray(v) for k, v in jm._adagrad_hist.items()},
        tm._adagrad_hist).items()})
    assert max(errs.values()) <= FIT_TOL, errs


@pytest.mark.parametrize("config", ["simplified", "per_category",
                                    "class_weights"])
def test_output_and_forward_propagate_tree_match_jax(config):
    jt, tt = config_trees(config)
    jm, tm = pair(jt, **CONFIGS[config])
    jm.fit(jt, epochs=3)
    rntn_state_from_jax(tm, jax_params(jm), jm.word_index, jm.cat_index,
                        jm.ccat_index)
    assert rel_err(jm.output(jt), tm.output(tt)) <= STEP_TOL
    for a, b in zip(jt, tt):
        jm.forward_propagate_tree(a)
        tm.forward_propagate_tree(b)
        assert tm.predict(b) == jm.predict(a)
        for na, nb in zip(_internal(a), _internal(b)):
            assert rel_err(na.vector, nb.vector) <= STEP_TOL
            assert rel_err(na.prediction, nb.prediction) <= STEP_TOL
            assert abs(na.error - nb.error) <= STEP_TOL * max(
                1.0, abs(na.error))


def test_params_cross_both_ways():
    jt, _ = config_trees("binary_classes")
    jm, tm = pair(jt, **CONFIGS["binary_classes"])
    back = rntn_params_to_numpy(tm.params())
    for k, v in jax_params(jm).items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == np.float32
    on = rntn_params_from_jax(back, CPU)
    assert all(t.device.type == "cpu" for t in on.values())
    with pytest.raises(ValueError, match="RNTN parameters"):
        rntn_params_from_jax({"W": back["W"]}, CPU)
    with pytest.raises(ValueError, match="AdaGrad history"):
        rntn_state_from_jax(tm, back, jm.word_index,
                            adagrad_hist={"W": back["W"]})


# ----------------------------------------------------- the level schedule
def left_chain(n_tokens, label=1):
    node = f"({label} w0)"
    for i in range(1, n_tokens):
        node = f"({label} {node} ({label} w{i}))"
    return node


def slot_by_slot(model, params, enc):
    """Node vectors in the JAX package's order: one slot a step, both
    branches computed, the one the slot's kind names kept."""
    d = model.num_hidden
    out = []
    for row in range(enc.n_trees):
        vecs = [torch.zeros(d) for _ in range(enc.max_nodes)]
        for s in range(enc.max_nodes):
            kind = enc.kind[row, s]
            if kind == 1:
                vecs[s] = apply_activation(
                    model.activation_function,
                    params["E"][int(enc.word[row, s])])
            elif kind == 2:
                child = torch.cat([vecs[enc.left[row, s]],
                                   vecs[enc.right[row, s]]])
                c = int(enc.cat[row, s])
                pre = params["W"][c] @ torch.cat([child, torch.ones(1)])
                if model.use_tensors:
                    pre = pre + torch.einsum("dij,i,j->d", params["T"][c],
                                             child, child)
                vecs[s] = apply_activation(model.activation_function, pre)
        out.append(torch.stack(vecs))
    return torch.stack(out)


@pytest.mark.parametrize("use_tensors", [True, False])
def test_level_schedule_matches_slot_loop_on_left_chains(use_tensors):
    texts = [left_chain(n) for n in (1, 2, 5, 9)]
    jt, tt = both(texts)
    jm, tm = pair(jt, use_tensors=use_tensors)
    enc = tm.encode(tt)
    sched = level_schedule(enc, torch.device(CPU))
    heights = node_heights(enc)
    # every binary level holds one node a tree: binary levels = binary
    # slots of the tallest tree, and the steps = its depth, not max_nodes
    assert len(sched.levels) == int((enc.kind[-1] == 2).sum()) == 8
    assert sched.n_levels == max(t.depth() for t in tt) == 9
    assert enc.max_nodes == 17
    assert [lv.stop - lv.start for lv in sched.levels] == \
        [3, 2, 2, 2, 1, 1, 1, 1]
    assert heights[enc.kind == 0].tolist() == [-1] * int(
        (enc.kind == 0).sum())
    with torch.no_grad():
        vecs = tm.node_vectors(tm.params(), sched)
        ref = slot_by_slot(tm, tm.params(), enc)
    rows, slots = np.nonzero(enc.kind > 0)
    got = vecs[torch.from_numpy(sched.position[rows, slots])]
    assert rel_err(ref[rows, slots].numpy(), got) <= 1e-6
    # and the JAX package's scan, one tree at a time
    jvecs = [np.asarray(jm._forward_slots(jm._params, {
        k: jnp.asarray(v[r]) for k, v in jm.encode(jt)._asdict().items()
        if k != "root"})) for r in range(len(jt))]
    assert rel_err(np.stack(jvecs)[rows, slots], got) <= STEP_TOL


def test_schedule_orders_categories_within_a_level():
    jt, tt = config_trees("per_category")
    _, tm = pair(jt, **CONFIGS["per_category"])
    enc = tm.encode(tt)
    sched = level_schedule(enc, torch.device(CPU))
    cats = sched.cat.numpy()[sched.n_pre:]
    for lv in sched.levels:
        seg_cats = [c for c, _, _ in lv.segments]
        assert seg_cats == sorted(set(seg_cats))
        for c, a, b in lv.segments:
            assert (cats[lv.start + a:lv.start + b] == c).all()
    roots = sched.roots.numpy()
    assert (sched.position[np.arange(enc.n_trees), enc.root] == roots).all()


# --------------------------------------- the JAX package's lr, observed
def test_lr_is_read_at_each_step_where_jax_keeps_its_first_trace():
    """JAX's `_get_step` jits a closure over the model once: after one
    epoch at lr 0.1, `lr = 0.0` still moves its params by ~0.1, until a
    refit that grows the vocabulary retraces and picks the new value up.
    The port reads `lr` at each step: at 0.0 nothing moves."""
    trees = sentiment_trees(jtree)
    jm, tm = pair(trees, num_hidden=4, lr=0.1)
    jm.fit(trees, epochs=1)
    tm.fit(sentiment_trees(), epochs=1)
    jm.lr = tm.lr = 0.0
    before_j, before_t = jax_params(jm), rntn_params_to_numpy(tm.params())
    jm.fit(trees, epochs=1)
    tm.fit(sentiment_trees(), epochs=1)
    moved_j = max(np.abs(np.asarray(jm.params()[k]) - v).max()
                  for k, v in before_j.items())
    assert moved_j == pytest.approx(0.1, rel=1e-3)  # the first trace's lr
    after_t = rntn_params_to_numpy(tm.params())
    for k, v in before_t.items():
        np.testing.assert_array_equal(after_t[k], v)
    # new words change E's shape: JAX retraces and now reads lr 0.0
    before_j = jax_params(jm)
    jm.fit([jtree.parse_tree("(1 (1 novel) (1 words))")], epochs=1)
    for k, v in before_j.items():
        np.testing.assert_array_equal(np.asarray(jm.params()[k])[:len(v)],
                                      v)
    assert jm.params()["E"].shape[0] == before_j["E"].shape[0] + 2


# ------------------------------------------ tests/test_rntn.py on the port
class TestRNTN:
    def test_training_reduces_loss(self):
        jm, model = pair(sentiment_trees(jtree), num_hidden=8)
        first = model.fit(sentiment_trees(), epochs=1)
        final = model.fit(sentiment_trees(), epochs=30)
        assert final < first

    def test_predicts_above_chance(self):
        trees = sentiment_trees()
        _, model = pair(sentiment_trees(jtree), num_hidden=8)
        model.fit(trees, epochs=60)
        preds = [model.predict(t) for t in trees]
        gold = [t.gold_label for t in trees]
        acc = np.mean([p == g for p, g in zip(preds, gold)])
        assert acc >= 0.8  # 6 trees, chance = 0.5

    def test_forward_propagate_annotates_nodes(self):
        trees = sentiment_trees()
        _, model = pair(sentiment_trees(jtree), num_hidden=8, lr=0.01)
        model.fit(trees, epochs=1)
        t = trees[0]
        model.forward_propagate_tree(t)

        def check(node):
            if node.is_leaf():
                assert node.vector is None
                return
            assert node.vector.shape == (8,)
            assert node.prediction.shape == (2,)
            assert np.isclose(node.prediction.sum(), 1.0, atol=1e-5)
            assert node.error >= 0
            for c in node.children:
                check(c)

        check(t)
        assert t.error_sum() > 0

    def test_no_tensors_mode(self):
        _, model = pair(sentiment_trees(jtree), use_tensors=False)
        first = model.fit(sentiment_trees(), epochs=1)
        final = model.fit(sentiment_trees(), epochs=30)
        assert final < first
        assert "T" not in model.params()

    def test_per_category_model(self):
        # non-simplified: parameters stacked per category pair
        texts = [
            "(S (NP (DT the) (NN cat)) (VP (VB sat)))",
            "(S (NP (DT a) (NN dog)) (VP (VB ran)))",
        ]
        trees = [parse_tree(t) for t in texts]
        for t in trees:
            t.gold_label = 1
        trees = [binarize(t) for t in trees]
        model = RNTN(num_hidden=6, num_outs=2, simplified_model=False,
                     combine_classification=False, lr=0.1, seed=0,
                     device=CPU)
        model.fit(trees, epochs=5)
        assert len(model.cat_index) >= 2
        assert model.params()["W"].shape[0] == len(model.cat_index)
        assert "Wb" in model.params()

    def test_unlabeled_nodes_ignored(self):
        t = parse_tree("(1 (-1 (1 good) (1 show)) (1 (1 very) (1 fun)))")
        model = RNTN(num_hidden=6, num_outs=2, lr=0.1, seed=0, device=CPU)
        loss = model.fit([t], epochs=10)
        assert np.isfinite(loss)

    def test_builder_surface(self):
        model = (RNTN.builder().num_hidden(10).num_outs(4)
                 .use_tensors(False).lr(0.05).device(CPU).build())
        assert model.num_hidden == 10 and model.num_outs == 4
        assert model.use_tensors is False

    def test_class_weights_applied(self):
        trees = sentiment_trees()
        _, m1 = pair(sentiment_trees(jtree))
        _, m2 = pair(sentiment_trees(jtree), class_weights={0: 10.0})
        l1 = m1.fit(trees, epochs=1)
        l2 = m2.fit(trees, epochs=1)
        assert l2 > l1  # upweighted class-0 errors dominate

    def test_feature_vector_init(self):
        trees = sentiment_trees()
        fv = {"bad": np.ones(8, np.float32), "good": -np.ones(8, np.float32)}
        model = RNTN(num_hidden=8, num_outs=2, feature_vectors=fv, seed=0,
                     device=CPU)
        model.fit(trees, epochs=1)
        e = model.params()["E"].numpy()
        # initialized rows survived into E (training moved them slightly)
        assert np.allclose(e[model.word_index["bad"]], 1.0, atol=0.1)
        assert np.allclose(e[model.word_index["good"]], -1.0, atol=0.1)

    def test_unknown_word_maps_to_unk(self):
        trees = sentiment_trees()
        model = RNTN(num_hidden=6, num_outs=2, seed=0, device=CPU)
        model.fit(trees, epochs=2)
        unseen = parse_tree("(1 (1 zzz) (1 qqq))")
        pred = model.predict(unseen)  # must not raise
        assert pred in (0, 1)

    def test_lowercase_feature_names(self):
        model = RNTN(num_hidden=6, num_outs=2, seed=0, device=CPU,
                     lower_case_feature_names=True)
        model.fit([parse_tree("(1 (1 Good) (0 Bad))")], epochs=1)
        enc = model.encode([parse_tree("(1 (1 good) (0 BAD))")])
        # mixed-case tokens resolve to the same (non-UNK) vocab rows
        words = enc.word[0][enc.kind[0] == 1]
        assert set(words) == {model.word_index["good"],
                              model.word_index["bad"]}
        assert 0 not in words  # nothing fell back to UNK

    def test_refit_with_new_words_grows_embeddings(self):
        model = RNTN(num_hidden=6, num_outs=2, lr=0.1, seed=0, device=CPU)
        model.fit([parse_tree("(1 (1 aa) (0 bb))")], epochs=2)
        v1 = model.params()["E"].shape[0]
        model.fit([parse_tree("(0 (1 cc) (0 dd))")], epochs=2)
        assert model.params()["E"].shape[0] == v1 + 2
        assert model._adagrad_hist["E"].shape[0] == v1 + 2
        enc = model.encode([parse_tree("(0 (1 cc) (0 dd))")])
        assert enc.word.max() == model.params()["E"].shape[0] - 1

    def test_refit_new_words_use_pretrained_vectors(self):
        fv = {"cc": np.full(6, 2.0, np.float32)}
        model = RNTN(num_hidden=6, num_outs=2, lr=0.1, seed=0,
                     feature_vectors=fv, device=CPU)
        model.fit([parse_tree("(1 (1 aa) (0 bb))")], epochs=1)
        model.fit([parse_tree("(0 (1 cc) (0 dd))")], epochs=1)
        e = model.params()["E"].numpy()
        # cc first appeared on the second fit() but still gets its
        # pretrained vector (random init would be ~N(0, scale/d)), like
        # words present at the first fit(); one epoch moves it slightly
        assert np.allclose(e[model.word_index["cc"]], 2.0, atol=0.3)

    def test_batched_output_matches_predict(self):
        trees = sentiment_trees()
        _, model = pair(sentiment_trees(jtree))
        model.fit(trees, epochs=20)
        probs = model.output(trees)
        assert probs.shape == (len(trees), 2)
        for row, t in zip(probs, trees):
            assert int(np.argmax(row)) == model.predict(t)

    def test_inference_before_fit_raises(self):
        model = RNTN(num_hidden=4, num_outs=2, device=CPU)
        with pytest.raises(RuntimeError, match="fit"):
            model.output(sentiment_trees())
        with pytest.raises(RuntimeError, match="fit"):
            model.predict(sentiment_trees()[0])


def test_device_none_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RNTN(num_hidden=4)


def test_upload_keeps_host_arrays_on_the_cpu():
    a = np.arange(5)
    t = upload(a, torch.device(CPU))
    assert t.device.type == "cpu" and t.tolist() == list(range(5))


# ------------------------------------------------------------ on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["simplified", "per_category"])
def test_fit_on_the_card_matches_the_cpu(card, config):
    """The port alone (the card's lane has no JAX): a CPU model's initial
    parameters carried to the card, three epochs on each."""
    _, tt = config_trees(config)
    kw = dict(num_hidden=6, num_outs=2, lr=0.1, seed=0, **CONFIGS[config])
    cpu = RNTN(device=CPU, **kw)
    cpu.prepare(tt)
    gpu = RNTN(device=card, **kw)
    gpu.word_index = dict(cpu.word_index)
    gpu.cat_index, gpu.ccat_index = cpu.cat_index, cpu.ccat_index
    gpu.set_params(cpu.params())
    a = cpu.fit(tt, epochs=3)
    b = gpu.fit(tt, epochs=3)
    assert abs(a - b) <= STEP_TOL * abs(a)
    errs = table_errs(rntn_params_to_numpy(cpu.params()), gpu.params())
    assert max(errs.values()) <= FIT_TOL, errs
