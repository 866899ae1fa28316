"""The PyTorch port's batch solvers (deeplearning4j_tpu_torch/optimize/)
held against the JAX package's: terminations, step functions, the
backtracking line search, listeners, the five optimizers behind
`Solver`, and their wiring into MultiLayerNetwork (the line-search and
Hessian-free algorithms of `fit`, `finetune` / `backprop=False`,
listener dispatch).

Inputs and parameters are made with numpy from a seed and given to both
packages, which run float32 on the CPU. The losses here draw nothing at
random (no dropout), so both packages take the same steps. Tolerances:
- the quadratic: final params within 1e-5 of the JAX package's;
- the MLP and LeNet stacks: params after N iterations within 5e-5 +
  1e-4 * |p| (GD, CG, L-BFGS: the line search's accept/reject decisions
  must agree, so one flipped decision would show as a gross error;
  IGD and HF the same bound), scores within 1e-5 + 1e-5 * |s|.
  Hessian-free on the whole stack starts from damping 10 rather than
  1: at 1 the MLP's Hessian plus damping is indefinite, CG meets a tiny
  positive curvature after negative ones, and its step multiplies
  float32 rounding by ~1e4 in both packages alike (2.4e-7 between their
  Hessian-vector products becomes 3e-2 in the params);
- the line search's chosen steps: within 1e-6 relative (every step is
  the initial step halved a whole number of times, so agreeing steps
  are equal);
- the two paths of the port's own `optimize()` (sync-free and
  listener-driven): identical params.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from deeplearning4j_tpu.config import MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import preprocessors as jax_pp
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.optimize import line_search as jax_ls
from deeplearning4j_tpu.optimize import listeners as jax_listeners
from deeplearning4j_tpu.optimize import solvers as jax_solvers
from deeplearning4j_tpu.optimize import stepfunctions as jax_steps
from deeplearning4j_tpu.optimize import terminations as jax_terms
from deeplearning4j_tpu.optimize.solver import Solver as JSolver
from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import line_search, listeners
from deeplearning4j_tpu_torch.optimize import solvers, stepfunctions
from deeplearning4j_tpu_torch.optimize import terminations
from deeplearning4j_tpu_torch.optimize.solver import Solver
from deeplearning4j_tpu_torch.weights import (multilayer_params_from_jax,
                                              multilayer_params_to_numpy)

ALGOS = ["iteration_gradient_descent", "gradient_descent",
         "conjugate_gradient", "lbfgs", "hessian_free"]
QUAD_TOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 5e-5, 1e-4
SCORE_ATOL, SCORE_RTOL = 1e-5, 1e-5
STEP_RTOL = 1e-6

TARGET = np.array([1.0, -2.0, 3.0, 0.5], np.float32)


def _np(t):
    return t.detach().cpu().numpy()


def _quadratic_jax(vec):
    return jnp.sum(jnp.square(vec - jnp.asarray(TARGET)))


def _quadratic(vec):
    return torch.square(vec - torch.from_numpy(TARGET)).sum()


# -------------------------------------------------------- the quadratic
@pytest.mark.parametrize("algo,iters,tol", [
    ("iteration_gradient_descent", 400, 0.5),
    ("gradient_descent", 100, 1e-2),
    ("conjugate_gradient", 50, 1e-2),
    ("lbfgs", 50, 1e-2),
    ("hessian_free", 20, 1e-3),
])
def test_solvers_minimize_the_quadratic_as_jax_does(algo, iters, tol):
    """tests/test_optimize.py's quadratic for all five algorithms."""
    kw = dict(optimization_algo=algo, num_iterations=iters, lr=0.2,
              momentum=0.0, use_adagrad=True, num_line_search_iterations=10)
    out, score = Solver(NeuralNetConfiguration(**kw), _quadratic,
                        terminations=[]).optimize(torch.zeros(4))
    ref, ref_score = JSolver(JConf(**kw), _quadratic_jax,
                             terminations=[]).optimize(jnp.zeros(4))
    np.testing.assert_allclose(_np(out), TARGET, atol=tol)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=QUAD_TOL)
    assert isinstance(score, float) and score < tol * 10
    assert score == pytest.approx(ref_score, abs=QUAD_TOL)


# ---------------------------------------------------------- the stacks
def _mlp_conf(algo, iters, builder=JConf.builder):
    return (builder().lr(0.1).n_in(12).activation_function("tanh")
            .optimization_algo(algo).num_iterations(iters)
            .use_adagrad(False).momentum(0.5)
            .list(3).hidden_layer_sizes([16, 8])
            .override(2, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=4)
            .pretrain(False).build()), (12,)


def _lenet_conf(algo, iters):
    return (JConf.builder().lr(0.1).activation_function("relu")
            .optimization_algo(algo).num_iterations(iters)
            .use_adagrad(False).momentum(0.5)
            .list(4)
            .override(0, layer="conv", filter_size=[3, 3], stride=[2, 2],
                      num_in_feature_maps=1, num_feature_maps=3)
            .override(1, layer="conv", filter_size=[2, 2], stride=[2, 2],
                      num_in_feature_maps=3, num_feature_maps=4)
            .override(2, layer="dense", n_in=2 * 2 * 4, n_out=10)
            .override(3, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_in=10, n_out=4)
            .input_preprocessor(0, jax_pp.ConvolutionInputPreProcessor(
                12, 12, 1))
            .input_preprocessor(2, jax_pp.ConvolutionPostProcessor())
            .pretrain(False).build()), (144,)


def _attention_conf(algo, iters):
    return (JConf.builder().lr(0.1).optimization_algo(algo)
            .num_iterations(iters).use_adagrad(False)
            .list(2)
            .override(0, layer="self_attention", n_in=8, n_out=16,
                      n_heads=2)
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_in=48, n_out=4)
            .input_preprocessor(0, jax_pp.ReshapePreProcessor([6, 8]))
            .input_preprocessor(1, jax_pp.ConvolutionPostProcessor())
            .pretrain(False).build()), (48,)


STACKS = {"mlp": _mlp_conf, "lenet": _lenet_conf}


def _pair(conf, seed=0):
    """(port net, JAX net) on the same parameters (the JAX net's init,
    biases nudged off zero)."""
    jnet = JNet(JMLC.from_json(conf.to_json()))
    rng = np.random.default_rng(seed)
    jnet._params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        jnet._params)
    net = MultiLayerNetwork.from_config_json(conf.to_json(), device="cpu")
    net.param_table = multilayer_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet._params), device="cpu")
    return net, jnet


def _data(feat, n, seed=1, classes=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, *feat)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _flat_losses(net, jnet):
    """The two packages' losses of the whole net as functions of the
    packed vector, and the packed start point."""
    x0, unravel = solvers.ravel_table(net.param_table)
    _, junravel = ravel_pytree(jnet._params)

    def loss(vec, bx, by):
        return net.loss_fn(unravel(vec), bx, by)

    def jloss(vec, bx, by):
        return jnet.loss_fn(junravel(vec), bx, by)

    return loss, jloss, x0


def _close_params(got, ref):
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=PARAM_ATOL,
                               rtol=PARAM_RTOL)


def _close_tables(table, jtable):
    got = multilayer_params_to_numpy(table)
    for k in jtable:
        for name in jtable[k]:
            np.testing.assert_allclose(got[k][name],
                                       np.asarray(jtable[k][name]),
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       err_msg=f"{k}/{name}")


@pytest.mark.parametrize("stack", sorted(STACKS))
@pytest.mark.parametrize("algo", ALGOS)
def test_optimizer_on_a_stack_matches_jax(algo, stack):
    """4 iterations of each optimizer over the whole net's loss, from the
    same packed vector and batch."""
    conf, feat = STACKS[stack](algo, 4)
    net, jnet = _pair(conf)
    loss, jloss, x0 = _flat_losses(net, jnet)
    x, y = _data(feat, 16)
    kw = {"initial_lambda": 10.0} if algo == "hessian_free" else {}
    out, score = Solver(net.layers[-1].conf, loss, terminations=[],
                        **kw).optimize(
        x0, torch.from_numpy(x), torch.from_numpy(y))
    ref, ref_score = JSolver(jnet.layers[-1].conf, jloss, terminations=[],
                             **kw).optimize(
        jnp.asarray(_np(x0)), jnp.asarray(x), jnp.asarray(y))
    _close_params(out, ref)
    assert score == pytest.approx(float(ref_score), abs=SCORE_ATOL,
                                  rel=SCORE_RTOL)
    assert score < float(loss(x0, torch.from_numpy(x), torch.from_numpy(y)))


class _StepRecorder:
    """Wraps a package's backtrack_line_search, recording each chosen
    step."""

    def __init__(self, fn):
        self.fn, self.steps = fn, []

    def __call__(self, *args, **kwargs):
        res = self.fn(*args, **kwargs)
        self.steps.append(float(res.step))
        return res


@pytest.mark.parametrize("stack", sorted(STACKS))
@pytest.mark.parametrize("algo", ["conjugate_gradient", "lbfgs"])
def test_line_search_chooses_the_same_step_every_iteration(algo, stack,
                                                           monkeypatch):
    conf, feat = STACKS[stack](algo, 6)
    net, jnet = _pair(conf, seed=3)
    loss, jloss, x0 = _flat_losses(net, jnet)
    x, y = _data(feat, 16, seed=4)
    rec = _StepRecorder(solvers.backtrack_line_search)
    jrec = _StepRecorder(jax_solvers.backtrack_line_search)
    monkeypatch.setattr(solvers, "backtrack_line_search", rec)
    monkeypatch.setattr(jax_solvers, "backtrack_line_search", jrec)
    scores = listeners.CollectScoresListener()
    jscores = jax_listeners.CollectScoresListener()
    Solver(net.layers[-1].conf, loss, listeners=[scores],
           terminations=[]).optimize(x0, torch.from_numpy(x),
                                     torch.from_numpy(y))
    with jax.disable_jit():  # the eager step, so each step is concrete
        JSolver(jnet.layers[-1].conf, jloss, listeners=[jscores],
                terminations=[]).optimize(
            jnp.asarray(_np(x0)), jnp.asarray(x), jnp.asarray(y))
    assert len(rec.steps) == len(jrec.steps) == 6
    np.testing.assert_allclose(rec.steps, jrec.steps, rtol=STEP_RTOL)
    assert any(s > 0 for s in rec.steps)
    assert [i for i, _ in scores.scores] == [i for i, _ in jscores.scores]
    np.testing.assert_allclose([s for _, s in scores.scores],
                               [s for _, s in jscores.scores],
                               atol=SCORE_ATOL, rtol=SCORE_RTOL)


@pytest.mark.parametrize("algo", ALGOS)
def test_sync_free_and_listener_paths_give_identical_params(algo):
    """The port's two optimize() paths, on the MLP: no listener (the
    sync-free loop, score a 0-d tensor with sync=False) and a listener
    (the eager loop, score read back each iteration)."""
    conf, feat = _mlp_conf(algo, 4)
    net, jnet = _pair(conf)
    loss, _, x0 = _flat_losses(net, jnet)
    data = tuple(torch.from_numpy(a) for a in _data(feat, 16))
    c = net.layers[-1].conf
    out, score = Solver(c, loss).optimize(x0, *data, sync=False)
    assert isinstance(score, torch.Tensor) and score.shape == ()
    collect = listeners.CollectScoresListener()
    out2, score2 = Solver(c, loss, listeners=[collect]).optimize(x0, *data)
    assert torch.equal(out, out2)
    assert float(score) == score2
    assert [i for i, _ in collect.scores] == list(range(4))


@pytest.mark.parametrize("algo", ["gradient_descent", "lbfgs"])
def test_eps_termination_stops_early_on_both_paths(algo):
    """tests/test_optimize.py's early stop: the listener path stops at
    the JAX package's iteration; the sync-free path freezes there, so
    both end on the same params."""
    kw = dict(optimization_algo=algo, num_iterations=500,
              num_line_search_iterations=10, lr=0.2)
    terms = [terminations.EpsTermination(eps=1e-10),
             terminations.Norm2Termination(1e-8)]
    jterms = [jax_terms.EpsTermination(eps=1e-10),
              jax_terms.Norm2Termination(1e-8)]
    collect = listeners.CollectScoresListener()
    jcollect = jax_listeners.CollectScoresListener()
    eager, _ = Solver(NeuralNetConfiguration(**kw), _quadratic,
                      listeners=[collect], terminations=terms).optimize(
        torch.zeros(4))
    free, _ = Solver(NeuralNetConfiguration(**kw), _quadratic,
                     terminations=terms).optimize(torch.zeros(4))
    JSolver(JConf(**kw), _quadratic_jax, listeners=[jcollect],
            terminations=jterms).optimize(jnp.zeros(4))
    assert len(collect.scores) == len(jcollect.scores) < 500
    assert torch.equal(eager, free)


def test_lbfgs_history_after_it_wraps_past_m():
    """history m = 3 over 7 steps on the MLP's loss: the ring buffer
    (S, Y, rho), the step count and x after every step, against the JAX
    package's step function."""
    conf, feat = _mlp_conf("lbfgs", 1)
    net, jnet = _pair(conf, seed=5)
    loss, jloss, x0 = _flat_losses(net, jnet)
    x, y = _data(feat, 16, seed=6)
    c, jc = net.layers[-1].conf, jnet.layers[-1].conf
    opt = solvers.LBFGS(c, loss, history=3)
    jopt = jax_solvers.LBFGS(jc, jloss, history=3)
    jstep = jax.jit(jopt._step_fn())
    data = (torch.from_numpy(x), torch.from_numpy(y))
    jdata = (jnp.asarray(x), jnp.asarray(y))
    xv, jx = x0, jnp.asarray(_np(x0))
    state, jstate = opt.init_state(xv), jopt.init_state(jx)
    key = jax.random.PRNGKey(0)
    for _ in range(7):
        xv, state, score, _ = opt._step(xv, state, *data)
        jx, jstate, jscore, _ = jstep(jx, jstate, key, *jdata)
        _close_params(xv, jx)
        for a, b in zip(state[:3], jstate[:3]):  # S, Y, rho
            _close_params(a, b)
        assert int(state[3]) == int(jstate[3])
    assert int(state[3]) == 7
    assert bool((state[2] != 0).all())  # every row of the ring was filled


def test_hessian_free_refuses_self_attention():
    """The flash attention is differentiable once (K2/K3, as the JAX
    package's custom_vjp), so there is no curvature product through it:
    the network refuses the combination up front, and the optimizer on
    such a loss raises rather than returning a partial product."""
    conf, feat = _attention_conf("hessian_free", 2)
    net, _ = _pair(conf)
    x, y = _data(feat, 8)
    with pytest.raises(ValueError, match="hessian_free"):
        net.fit(x, y)
    loss, _, x0 = _flat_losses(net, JNet(JMLC.from_json(conf.to_json())))
    with pytest.raises(RuntimeError, match="differentiable once"):
        Solver(net.layers[-1].conf, loss, terminations=[]).optimize(
            x0, torch.from_numpy(x), torch.from_numpy(y))


# ------------------------------------------------- MultiLayerNetwork wiring
@pytest.mark.parametrize("algo", ["gradient_descent", "conjugate_gradient",
                                  "lbfgs", "hessian_free"])
def test_fit_with_a_batch_solver_over_a_ragged_iterator_matches_jax(algo):
    """fit() over an iterator of 16 + 16 + 8 rows through the device
    feed: the batch solver takes the padded last batch with its row
    mask; 2 iterations a batch. (Over more calls CG's and L-BFGS's
    float32 rounding differences grow: 5e-7 after one call, 3e-4 after
    six, in both directions, with every line-search step equal.)
    Hessian-free runs on a softmax layer alone, whose loss is convex:
    on the MLP at damping 1 its CG step is chaotic (see the module
    docstring)."""
    conf, feat = _mlp_conf(algo, 2)
    if algo == "hessian_free":
        conf = (JConf.builder().lr(0.1).n_in(12).optimization_algo(algo)
                .num_iterations(2).list(1)
                .override(0, layer="output", loss_function="mcxent",
                          activation_function="softmax", n_out=4)
                .pretrain(False).build())
    net, jnet = _pair(conf, seed=7)
    x, y = _data(feat, 40, seed=8)
    from deeplearning4j_tpu.datasets import ListDataSetIterator as JIter
    from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
    net.fit(ListDataSetIterator(DataSet(x, y), 16))
    jnet.fit(JIter(JDataSet(x, y), 16))
    _close_tables(net.param_table, jnet._params)


@pytest.mark.parametrize("algo", ["iteration_gradient_descent",
                                  "conjugate_gradient"])
def test_listeners_see_the_jax_sequence_of_iteration_and_score(algo):
    """set_listeners + fit over arrays, then fit_scan: the IGD path
    reports once a batch (after its num_iterations steps) and once a
    fit_scan call; a batch solver reports every iteration."""
    conf, feat = _mlp_conf(algo, 3)
    net, jnet = _pair(conf, seed=9)
    collect = listeners.CollectScoresListener()
    jcollect = jax_listeners.CollectScoresListener()
    net.set_listeners([collect])
    jnet.set_listeners([jcollect])
    for seed in (10, 11):
        x, y = _data(feat, 16, seed=seed)
        net.fit(x, y)
        jnet.fit(x, y)
    if algo == "iteration_gradient_descent":
        x, y = _data(feat, 32, seed=12)
        net.fit_scan(x, y, 16, sync=False)
        jnet.fit_scan(x, y, 16)
    assert [i for i, _ in collect.scores] == [i for i, _ in jcollect.scores]
    assert len(collect.scores) == (3 if algo == "iteration_gradient_descent"
                                   else 6)
    np.testing.assert_allclose([s for _, s in collect.scores],
                               [s for _, s in jcollect.scores],
                               atol=SCORE_ATOL, rtol=SCORE_RTOL)


@pytest.mark.parametrize("algo", ["iteration_gradient_descent", "lbfgs",
                                  "hessian_free"])
def test_finetune_and_backprop_false_match_jax(algo):
    """backprop=False: fit() fits only the output layer, with its solver
    over the frozen features (computed in chunks: chunk_size 8 here);
    finetune() called directly does the same."""
    conf, feat = _mlp_conf(algo, 3)
    conf.backprop = False
    net, jnet = _pair(conf, seed=13)
    x, y = _data(feat, 20, seed=14)
    before = _np(net.params())
    net.fit(x, y)
    jnet.fit(x, y)
    _close_tables(net.param_table, jnet._params)
    after = _np(net.params())
    n_hidden = sum(int(np.prod(p.shape))
                   for k in ("0", "1") for p in net.param_table[k].values())
    # the packed order puts layers "0" and "1" first: frozen
    np.testing.assert_array_equal(after[:n_hidden], before[:n_hidden])
    assert not np.array_equal(after, before)
    feats = net._frozen_features(torch.from_numpy(x), chunk_size=8)
    np.testing.assert_allclose(_np(feats), np.asarray(
        jnet._frozen_features(jnp.asarray(x), chunk_size=8)), atol=1e-6)
    net.finetune(x, y)
    jnet.finetune(x, y)
    _close_tables(net.param_table, jnet._params)


# ---------------------------------------------- line search and the rest
@pytest.mark.parametrize("case", ["accept_first", "halve", "non_descent",
                                  "long_direction", "step_min"])
def test_backtrack_line_search_matches_jax(case):
    rng = np.random.default_rng(15)
    a = rng.normal(size=(6, 6)).astype(np.float32)
    hess = (a @ a.T + np.eye(6, dtype=np.float32)).astype(np.float32)
    x0 = rng.normal(size=6).astype(np.float32)

    def f(v, lib):
        h = lib.asarray(hess) if lib is jnp else torch.from_numpy(hess)
        return 0.5 * (v * (h @ v)).sum()

    g0 = (hess @ x0).astype(np.float32)
    d = {"accept_first": -g0 / np.linalg.norm(g0) * 0.1,
         "halve": -g0 * 3.0, "non_descent": g0,
         "long_direction": -g0 * 1e3,
         "step_min": -g0 * 1e-3 + 50 * np.eye(6, dtype=np.float32)[0]}[case]
    d = d.astype(np.float32)
    kw = dict(initial_step=1.0, max_iterations=8)
    if case == "step_min":
        kw = dict(initial_step=1e-9, max_iterations=8)
    x0t = torch.from_numpy(x0)
    res = line_search.backtrack_line_search(
        lambda v: f(v, torch), x0t, f(x0t, torch), torch.from_numpy(g0),
        torch.from_numpy(d), **kw)
    jres = jax_ls.backtrack_line_search(
        lambda v: f(v, jnp), jnp.asarray(x0), f(jnp.asarray(x0), jnp),
        jnp.asarray(g0), jnp.asarray(d), **kw)
    assert float(res.step) == pytest.approx(float(jres.step), rel=STEP_RTOL)
    assert float(res.score) == pytest.approx(float(jres.score), rel=1e-6)
    if case == "non_descent":
        assert float(res.step) == 0.0


def test_step_functions_match_jax():
    rng = np.random.default_rng(16)
    p = {"0": {"W": rng.normal(size=(3, 2)).astype(np.float32),
               "b": rng.normal(size=(1, 2)).astype(np.float32)}}
    d = {"0": {"W": rng.normal(size=(3, 2)).astype(np.float32),
               "b": rng.normal(size=(1, 2)).astype(np.float32)}}
    tp = {k: {n: torch.from_numpy(v) for n, v in t.items()}
          for k, t in p.items()}
    td = {k: {n: torch.from_numpy(v) for n, v in t.items()}
          for k, t in d.items()}
    assert sorted(stepfunctions.STEP_FUNCTIONS) == \
        sorted(jax_steps.STEP_FUNCTIONS)
    for name, fn in stepfunctions.STEP_FUNCTIONS.items():
        got = fn(tp, td, 0.3)
        ref = jax_steps.STEP_FUNCTIONS[name](p, d, 0.3)
        for n in ("W", "b"):
            np.testing.assert_allclose(_np(got["0"][n]),
                                       np.asarray(ref["0"][n]), atol=1e-7)
    assert torch.equal(stepfunctions.default_step(tp["0"]["W"],
                                                  td["0"]["W"], 0.0),
                       tp["0"]["W"])


def test_terminations_match_jax():
    cases = [(1.0, 1.0, 0.0), (1.0, 1.0 + 1e-6, 1.0), (1.0, 2.0, 1e-9),
             (float("nan"), 1.0, 1.0), (1.0, float("inf"), 0.5),
             (10.0, 1.0, 1.0), (1e-9, 1e-10, 0.0)]
    pairs = [(terminations.EpsTermination(), jax_terms.EpsTermination()),
             (terminations.ZeroDirection(), jax_terms.ZeroDirection()),
             (terminations.Norm2Termination(1e-8),
              jax_terms.Norm2Termination(1e-8)),
             (terminations.DivergenceCondition(3.0),
              jax_terms.DivergenceCondition(3.0))]
    for ours, theirs in pairs:
        for new, old, gnorm in cases:
            assert ours.terminate(new, old, gnorm) == \
                theirs.terminate(new, old, gnorm)
    with pytest.raises(ValueError):
        terminations.DivergenceCondition(factor=0.0)


def test_device_termination_flag_equals_the_host_predicates():
    """The sync-free loop's device flag against the host predicates on
    the same (new, old, grad norm) triples."""
    terms = [terminations.EpsTermination(), terminations.ZeroDirection(),
             terminations.Norm2Termination(1e-3)]
    opt = solvers.BaseOptimizer(NeuralNetConfiguration(), _quadratic,
                                terminations=terms)
    for new, old, gnorm in [(1.0, 1.0, 1.0), (1.0, 2.0, 1.0),
                            (1.0, float("inf"), 1.0), (1.0, 2.0, 0.0),
                            (1.0, 2.0, 1e-4), (float("nan"), 1.0, 1.0)]:
        flag = opt._terminate_on_device(torch.tensor(new), torch.tensor(old),
                                        torch.tensor(gnorm))
        assert bool(flag) == any(t.terminate(new, old, gnorm) for t in terms)


def test_step_time_listener_summary():
    conf = NeuralNetConfiguration(
        optimization_algo="iteration_gradient_descent", num_iterations=8,
        lr=0.1)
    listener = listeners.StepTimeListener()
    Solver(conf, _quadratic, listeners=[listener],
           terminations=[]).optimize(torch.zeros(4))
    summary = listener.summary()
    assert summary["count"] == 7  # n iterations, n - 1 intervals
    assert summary["max_ms"] >= summary["median_ms"] >= 0.0
    listener.reset()
    assert listener.summary() == {"count": 0}


def test_profiler_listener_writes_a_trace(tmp_path):
    conf = NeuralNetConfiguration(
        optimization_algo="iteration_gradient_descent", num_iterations=6,
        lr=0.1)
    listener = listeners.ProfilerListener(str(tmp_path), start=1, stop=3)
    Solver(conf, _quadratic, listeners=[listener],
           terminations=[]).optimize(torch.zeros(4))
    assert not listener._active
    assert listener.trace_path and (tmp_path / listener.trace_path).exists()
    with pytest.raises(ValueError):
        listeners.ProfilerListener(str(tmp_path), start=0, stop=2)


def test_composable_and_guardian_listeners():
    seen = []

    class Record(listeners.IterationListener):
        def iteration_done(self, model, iteration, score):
            seen.append((iteration, score))

    both = listeners.ComposableIterationListener([Record(), Record()])
    both.iteration_done(None, 3, 0.5)
    assert seen == [(3, 0.5), (3, 0.5)]
    events = listeners.CollectGuardianEvents()
    events.iteration_done(None, 0, 1.0)

    class Event:
        kind = "skip"

    events.guardian_event(None, Event())
    assert events.kinds() == ["skip"]


def test_ravel_table_is_ravel_pytree_order():
    rng = np.random.default_rng(17)
    table = {str(i): {"b": rng.normal(size=(1, 2)).astype(np.float32),
                      "W": rng.normal(size=(2, 2)).astype(np.float32)}
             for i in range(12)}
    flat, unravel = solvers.ravel_table(
        {k: {n: torch.from_numpy(v) for n, v in t.items()}
         for k, t in table.items()})
    ref, _ = ravel_pytree(table)
    np.testing.assert_array_equal(_np(flat), np.asarray(ref))
    back = unravel(flat)
    assert torch.equal(back["10"]["W"], torch.from_numpy(table["10"]["W"]))
    with pytest.raises(ValueError, match="Unknown optimization"):
        Solver(NeuralNetConfiguration(optimization_algo="nope"),
               _quadratic).get_optimizer()


# ------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ALGOS)
def test_solver_loop_on_the_card_stays_there_without_a_host_sync(card, algo):
    """The sync-free path on a CUDA net: params and score stay on the
    card, and nothing is read back (set_sync_debug_mode("error"))."""
    conf, feat = _mlp_conf(algo, 4, NeuralNetConfiguration.builder)
    net = MultiLayerNetwork(conf, device=card)
    x0, unravel = solvers.ravel_table(net.param_table)

    def loss(vec, bx, by):
        return net.loss_fn(unravel(vec), bx, by)

    data = tuple(torch.from_numpy(a).to(card) for a in _data(feat, 16))
    solver = Solver(net.layers[-1].conf, loss)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, score = solver.optimize(x0, *data, sync=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert out.device.type == "cuda" and score.device.type == "cuda"
    assert bool(torch.isfinite(out).all())
