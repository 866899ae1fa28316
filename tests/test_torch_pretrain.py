"""The PyTorch port's pretraining layers (deeplearning4j_tpu_torch/models/
pretrain.py) and layer-wise pretraining held against the JAX package.

The deterministic parts are held to the JAX package on the same numpy
inputs and parameters, float32 on the CPU, within 1e-5 (forward) and
2e-5 + 1e-4 * |g| (gradients): the RBM's prop_up / prop_down /
free_energy / reconstruct for all 16 visible x hidden unit pairs, the
CD-k gradient given the same injected chain samples, and the
autoencoders' losses and gradients with corruption off. The sampled
paths draw from a torch.Generator, which cannot match jax's draws, so
they are held to statistics: sample means within 5 standard errors of
the probabilities, and reconstruction error falling under CD training.
A DBN fine-tunes from the JAX package's pretrained params to its params
after fine-tuning (within 2e-5), and learns Iris as
tests/test_pretrain_models.py's DBN does (f1 > 0.7).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.config import MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets.iris import load_iris
from deeplearning4j_tpu.models import pretrain as jax_pretrain  # noqa: F401
from deeplearning4j_tpu.nn.layers import make_layer as jax_make_layer
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.eval import Evaluation
from deeplearning4j_tpu_torch.models import pretrain
from deeplearning4j_tpu_torch.nn.layers import make_layer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.weights import (multilayer_params_from_jax,
                                              multilayer_params_to_numpy)

FWD_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
PARAM_TOL = 2e-5
SIGMAS = 5.0
VISIBLE = ["binary", "gaussian", "softmax", "linear"]
HIDDEN = ["binary", "gaussian", "softmax", "rectified"]


def _np(t):
    return t.detach().cpu().numpy()


def _confs(**kw):
    """The same layer conf in both packages."""
    defaults = dict(layer="rbm", n_in=6, n_out=4, lr=0.1,
                    num_iterations=50, use_adagrad=False, momentum=0.0,
                    optimization_algo="iteration_gradient_descent")
    defaults.update(kw)
    jc, c = JConf(), NeuralNetConfiguration()
    for k, v in defaults.items():
        setattr(jc, k, v)
        setattr(c, k, v)
    return c, jc


def _params(shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: (0.5 * rng.normal(size=s)).astype(np.float32)
            for k, s in shapes.items()}


def _t(table, grad=False):
    return {k: torch.tensor(v, requires_grad=grad) for k, v in table.items()}


def _j(table):
    return {k: jnp.asarray(v) for k, v in table.items()}


def _close(got, ref, atol=FWD_TOL):
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=atol)


def _grads_close(grads, ref):
    for k in ref:
        np.testing.assert_allclose(_np(grads[k]), np.asarray(ref[k]),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=k)


def _layers(**kw):
    c, jc = _confs(**kw)
    return make_layer(c, device="cpu"), jax_make_layer(jc)


def _tiny_binary():
    # the 6 x 6 two-cluster pattern of the reference's RBMTests
    return np.array([[1, 1, 1, 0, 0, 0], [1, 0, 1, 0, 0, 0],
                     [1, 1, 1, 0, 0, 0], [0, 0, 1, 1, 1, 0],
                     [0, 0, 1, 1, 0, 0], [0, 0, 1, 1, 1, 0]], np.float32)


# ------------------------------------------------------------------ RBM
@pytest.mark.parametrize("hidden", HIDDEN)
@pytest.mark.parametrize("visible", VISIBLE)
def test_rbm_deterministic_functions_match_jax(visible, hidden):
    layer, jlayer = _layers(visible_unit=visible, hidden_unit=hidden)
    p = _params(layer.param_shapes(), seed=1)
    v = np.random.default_rng(2).uniform(size=(5, 6)).astype(np.float32)
    h = np.random.default_rng(3).uniform(size=(5, 4)).astype(np.float32)
    tp, jp = _t(p), _j(p)
    with torch.no_grad():
        _close(layer.prop_up(tp, torch.tensor(v)), jlayer.prop_up(jp, v))
        _close(layer.prop_down(tp, torch.tensor(h)), jlayer.prop_down(jp, h))
        _close(layer.free_energy(tp, torch.tensor(v)),
               jlayer.free_energy(jp, v))
        _close(layer.reconstruct(tp, torch.tensor(v)),
               jlayer.reconstruct(jp, v))
        _close(layer.activate(tp, torch.tensor(v)), jlayer.activate(jp, v))


@pytest.mark.parametrize("k", [1, 3])
def test_cd_gradient_given_the_same_samples_matches_jax(k):
    """The surrogate loss mean_energy(v0, h0) - mean_energy(vk, hk) and
    its gradient, with the chain's samples injected into both packages
    (the positive minus negative phase moments), plus the closed form
    grad_W = -(v0'h0 - vk'hk) / B."""
    layer, jlayer = _layers(k=k)
    p = _params(layer.param_shapes(), seed=4)
    rng = np.random.default_rng(5)
    v0 = _tiny_binary()
    h0 = rng.uniform(size=(6, 4)).astype(np.float32)
    vk = (rng.uniform(size=(6, 6)) < 0.5).astype(np.float32)
    hk = rng.uniform(size=(6, 4)).astype(np.float32)
    tp = _t(p, grad=True)
    loss = (layer._mean_energy(tp, torch.tensor(v0), torch.tensor(h0))
            - layer._mean_energy(tp, torch.tensor(vk), torch.tensor(hk)))
    grads = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    ref, ref_g = jax.value_and_grad(
        lambda q: jlayer._mean_energy(q, v0, h0)
        - jlayer._mean_energy(q, vk, hk))(_j(p))
    assert float(loss.detach()) == pytest.approx(float(ref), abs=FWD_TOL)
    _grads_close(grads, ref_g)
    np.testing.assert_allclose(_np(grads["W"]),
                               -(v0.T @ h0 - vk.T @ hk) / 6, atol=1e-6)


def test_cd_loss_gradient_is_the_moments_of_its_own_chain():
    """The port's own pretrain_loss: replay the chain with the same
    generator seed and check grad_W against the closed form."""
    layer, _ = _layers(k=1)
    p = _params(layer.param_shapes(), seed=6)
    x = torch.tensor(_tiny_binary())
    tp = _t(p, grad=True)
    gen = torch.Generator().manual_seed(7)
    grads = torch.autograd.grad(layer.pretrain_loss(tp, x, gen),
                                list(tp.values()))
    gen.manual_seed(7)
    with torch.no_grad():
        h0_mean, h0 = layer.sample_h_given_v(tp, x, gen)
        (_, vk), (hk_mean, _) = layer.gibbs_vhv(tp, h0, gen)
    expected = -(x.T @ h0_mean - vk.T @ hk_mean) / x.shape[0]
    np.testing.assert_allclose(_np(dict(zip(tp, grads))["W"]),
                               _np(expected), atol=1e-6)


@pytest.mark.parametrize("unit", ["binary", "gaussian", "rectified"])
def test_samplers_by_their_statistics(unit):
    """Binary samples' means within 5 standard errors of the
    probabilities; gaussian and rectified samples around their means
    with the stated spread."""
    layer, _ = _layers(hidden_unit=unit, visible_unit=(
        "binary" if unit == "binary" else "gaussian"))
    p = _t(_params(layer.param_shapes(), seed=8))
    n = 20000
    v = torch.tensor(np.random.default_rng(9).uniform(
        size=(1, 6)).astype(np.float32)).expand(n, 6)
    gen = torch.Generator().manual_seed(10)
    with torch.no_grad():
        mean, sample = layer.sample_h_given_v(p, v, gen)
        vmean, vsample = layer.sample_v_given_h(p, mean, gen)
    m = mean[0]
    if unit == "binary":
        assert set(torch.unique(sample).tolist()) <= {0.0, 1.0}
        se = torch.sqrt(m * (1 - m) / n)
        assert bool(((sample.mean(0) - m).abs() <= SIGMAS * se).all())
        vm = vmean.mean(0)
        vse = torch.sqrt(vm * (1 - vm) / n)
        assert bool(((vsample.mean(0) - vm).abs()
                     <= SIGMAS * vse + 1e-3).all())
    elif unit == "gaussian":
        noise = sample - mean
        assert bool((noise.mean(0).abs() <= SIGMAS / np.sqrt(n)).all())
        assert bool(((noise.std(0) - 1).abs() < 0.03).all())
        vnoise = vsample - vmean
        assert bool(((vnoise.std(0) - 1).abs() < 0.03).all())
    else:
        # NReLU: relu(mean + N(0, sigmoid(mean)))
        assert bool((sample >= 0).all())
        s = torch.sqrt(torch.sigmoid(m))
        z = -m / s
        normal = torch.distributions.Normal(0.0, 1.0)
        want = m * (1 - normal.cdf(z)) + s * torch.exp(normal.log_prob(z))
        assert bool(((sample.mean(0) - want).abs() < 0.02).all())


def test_binomial_corruption_keeps_the_stated_share():
    gen = torch.Generator().manual_seed(11)
    x = torch.ones(200, 100)
    out = pretrain.binomial_corruption(gen, x, 0.3)
    assert set(torch.unique(out).tolist()) <= {0.0, 1.0}
    n = x.numel()
    assert abs(float(out.mean()) - 0.7) <= SIGMAS * np.sqrt(0.21 / n)


@pytest.mark.parametrize("layer_type", ["rbm", "autoencoder"])
def test_pretraining_lowers_reconstruction_error(layer_type):
    """Like tests/test_pretrain_models.py: plain SGD on pretrain_loss
    over the tiny binary set, reconstruction error falls."""
    kw = {"layer": layer_type}
    if layer_type == "autoencoder":
        kw.update(corruption_level=0.3,
                  loss_function="reconstruction_crossentropy")
    layer, _ = _layers(**kw)
    p = _t(_params(layer.param_shapes(), seed=12), grad=True)
    x = torch.tensor(_tiny_binary())
    gen = torch.Generator().manual_seed(13)

    def err():
        with torch.no_grad():
            return float(torch.square(layer.reconstruct(p, x) - x).mean())

    before = err()
    for _ in range(300):
        grads = torch.autograd.grad(layer.pretrain_loss(p, x, gen),
                                    list(p.values()))
        with torch.no_grad():
            for t, g in zip(p.values(), grads):
                t -= 0.5 * g
    assert err() < 0.5 * before


# --------------------------------------------------------- autoencoders
@pytest.mark.parametrize("act,loss", [
    ("sigmoid", "reconstruction_crossentropy"), ("tanh", "mse"),
    ("sigmoid", "xent")])
@pytest.mark.parametrize("sparsity", [0.0, 0.1])
def test_autoencoder_loss_and_gradients_match_jax(act, loss, sparsity):
    layer, jlayer = _layers(layer="autoencoder", corruption_level=0.0,
                            activation_function=act, loss_function=loss,
                            sparsity=sparsity)
    p = _params(layer.param_shapes(), seed=14)
    x = np.random.default_rng(15).uniform(size=(7, 6)).astype(np.float32)
    tp = _t(p, grad=True)
    got = layer.pretrain_loss(tp, torch.tensor(x), None)
    grads = dict(zip(tp, torch.autograd.grad(got, list(tp.values()))))
    ref, ref_g = jax.value_and_grad(
        lambda q: jlayer.pretrain_loss(q, x, jax.random.PRNGKey(0)))(_j(p))
    assert float(got.detach()) == pytest.approx(float(ref), abs=FWD_TOL)
    _grads_close(grads, ref_g)
    with torch.no_grad():
        _close(layer.encode(tp, torch.tensor(x)), jlayer.encode(_j(p), x))
        _close(layer.reconstruct(tp, torch.tensor(x)),
               jlayer.reconstruct(_j(p), x))


def test_rbm_sparsity_penalty_matches_jax():
    layer, jlayer = _layers(sparsity=0.05)
    p = _params(layer.param_shapes(), seed=16)
    x = _tiny_binary()
    tp = _t(p, grad=True)
    with torch.no_grad():
        hm = layer.prop_up(tp, torch.tensor(x))
    got = layer.sparsity_penalty(layer.prop_up(tp, torch.tensor(x)))
    grads = dict(zip(tp, torch.autograd.grad(got, list(tp.values()),
                                             allow_unused=True,
                                             materialize_grads=True)))
    ref, ref_g = jax.value_and_grad(
        lambda q: jlayer.sparsity_penalty(jlayer.prop_up(q, x)))(_j(p))
    assert float(got.detach()) == pytest.approx(float(ref), abs=FWD_TOL)
    _grads_close(grads, ref_g)
    assert float(layer.sparsity_penalty(hm)) == pytest.approx(
        float(got.detach()))


@pytest.mark.parametrize("act", ["tanh", "sigmoid"])
def test_recursive_autoencoder_matches_jax(act):
    layer, jlayer = _layers(layer="recursive_autoencoder", n_in=5, n_out=5,
                            activation_function=act)
    p = _params(layer.param_shapes(), seed=17)
    x = np.random.default_rng(18).normal(size=(7, 5)).astype(np.float32)
    tp = _t(p, grad=True)
    got = layer.pretrain_loss(tp, torch.tensor(x))
    grads = dict(zip(tp, torch.autograd.grad(got, list(tp.values()))))
    ref, ref_g = jax.value_and_grad(
        lambda q: jlayer.pretrain_loss(q, x))(_j(p))
    assert float(got.detach()) == pytest.approx(float(ref), abs=FWD_TOL)
    _grads_close(grads, ref_g)
    with torch.no_grad():
        hs = layer.activate(tp, torch.tensor(x))
    assert hs.shape == (6, 5)
    _close(hs, jlayer.activate(_j(p), x))
    with pytest.raises(ValueError, match=">= 2 rows"):
        layer.pretrain_loss(tp, torch.tensor(x[:1]))


def test_registry_takes_the_pretrain_layers_and_refuses_lstm():
    for name, cls in [("rbm", pretrain.RBM),
                      ("autoencoder", pretrain.AutoEncoder),
                      ("recursive_autoencoder",
                       pretrain.RecursiveAutoEncoder)]:
        c, _ = _confs(layer=name)
        layer = make_layer(c, device="cpu")
        assert type(layer) is cls
        assert sorted(layer.param_dict()) == sorted(layer.param_shapes())
    from deeplearning4j_tpu_torch.models import LSTM

    c, _ = _confs(layer="lstm")
    assert type(make_layer(c, device="cpu")) is LSTM


# -------------------------------------------------------------- the DBN
def _dbn_conf(n_in, hidden, n_out, iters, builder=JConf.builder, **kw):
    b = (builder().lr(kw.get("lr", 0.1)).n_in(n_in)
         .activation_function("sigmoid")
         .optimization_algo("iteration_gradient_descent")
         .num_iterations(iters).use_adagrad(kw.get("adagrad", False))
         .list(len(hidden) + 1).hidden_layer_sizes(hidden))
    for i in range(len(hidden)):
        b = b.override(i, layer=kw.get("layer", "rbm"), k=1)
    return (b.override(len(hidden), layer="output", loss_function="mcxent",
                       activation_function="softmax", n_out=n_out)
            .pretrain(True).build())


def test_pretrain_tables_cross_both_ways():
    """RBM (W, b, vb), AE (W, b, vb) and RAE (W, c, U, bU) tables cross
    between the packages through the weights functions, packed vectors
    in the same order."""
    conf = _dbn_conf(6, [5, 4], 3, 2)
    conf.confs[1].layer = "autoencoder"
    jnet = JNet(JMLC.from_json(conf.to_json()))
    net = MultiLayerNetwork.from_config_json(conf.to_json(), device="cpu")
    net.param_table = multilayer_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet._params), device="cpu")
    np.testing.assert_array_equal(_np(net.params()),
                                  np.asarray(jnet.params()))
    assert sorted(net.param_table["0"]) == ["W", "b", "vb"]
    back = multilayer_params_to_numpy(net.param_table)
    for k, t in jnet._params.items():
        for name, v in t.items():
            np.testing.assert_array_equal(back[k][name], np.asarray(v))
    rae, jrae = _layers(layer="recursive_autoencoder", n_in=5, n_out=5)
    table = {"0": _params(rae.param_shapes(), seed=19)}
    moved = multilayer_params_from_jax(table, device="cpu")
    assert sorted(moved["0"]) == ["U", "W", "bU", "c"]
    for name, v in multilayer_params_to_numpy(moved)["0"].items():
        np.testing.assert_array_equal(v, table["0"][name])


def test_dbn_fine_tunes_from_jax_pretrained_params_to_jax_params():
    """Pretraining samples, so it is run once, by the JAX package; the
    port takes its pretrained params and both fine-tune (the supervised
    phase of fit: 3 steps of backprop through the RBM layers)."""
    conf = _dbn_conf(8, [6, 5], 3, 3)
    jnet = JNet(JMLC.from_json(conf.to_json()))
    rng = np.random.default_rng(20)
    x = rng.uniform(size=(16, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    jnet.pretrain(x)
    net = MultiLayerNetwork.from_config_json(conf.to_json(), device="cpu")
    net.param_table = multilayer_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet._params), device="cpu")
    np.testing.assert_allclose(_np(net.output(x)), np.asarray(
        jnet.output(x)), atol=FWD_TOL)
    net.conf.pretrain = False
    jnet.conf.pretrain = False
    net.fit(x, y)
    jnet.fit(x, y)
    got = multilayer_params_to_numpy(net.param_table)
    for k, t in jnet._params.items():
        for name, v in t.items():
            np.testing.assert_allclose(got[k][name], np.asarray(v),
                                       atol=PARAM_TOL, err_msg=f"{k}/{name}")


def test_pretrain_changes_each_pretrain_layer_and_not_the_output():
    """pretrain() over an iterator: one cached solver per pretrain layer
    (sync-free: the score stays a device tensor), the output layer
    untouched; the RBM layers' reconstruction error falls."""
    conf = _dbn_conf(6, [4], 2, 20, lr=0.5)
    net = MultiLayerNetwork.from_config_json(conf.to_json(), device="cpu")
    x = np.tile(_tiny_binary(), (4, 1))
    y = np.eye(2, dtype=np.float32)[[0, 0, 0, 1, 1, 1] * 4]
    rbm = net.layers[0]
    xt = torch.tensor(x)

    def err():
        with torch.no_grad():
            return float(torch.square(
                rbm.reconstruct(rbm.param_dict(), xt) - xt).mean())

    before, out_before = err(), _np(net.param_table["1"]["W"]).copy()
    for _ in range(3):
        net.pretrain(ListDataSetIterator(DataSet(x, y), 8))
    assert sorted(net._pretrain_solvers) == [0]
    assert err() < before
    np.testing.assert_array_equal(_np(net.param_table["1"]["W"]),
                                  out_before)


def test_dbn_on_iris_reaches_f1_above_0_7():
    """tests/test_pretrain_models.py's DBN: RBM 4 -> 12 pretrained with
    CD-1, then a softmax output, 20 epochs of fit; Iris from the JAX
    package's loader as numpy."""
    ds = load_iris()
    x, y = np.asarray(ds.features), np.asarray(ds.labels)
    conf = _dbn_conf(4, [12], 3, 30)
    net = MultiLayerNetwork.from_config_json(conf.to_json(), device="cpu")
    net.fit(x, y, epochs=20)
    ev = Evaluation()
    ev.eval(y, net.output(x))
    assert ev.f1() > 0.7


@pytest.mark.cuda
def test_dbn_fit_on_the_card_makes_no_host_sync():
    """A whole DBN fit (pretraining both RBMs, then backprop) on a CUDA
    net under set_sync_debug_mode("error")."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    conf = _dbn_conf(20, [16, 8], 3, 3, NeuralNetConfiguration.builder)
    net = MultiLayerNetwork(conf, device="cuda")
    rng = np.random.default_rng(21)
    x = torch.tensor(rng.uniform(size=(32, 20)).astype(np.float32),
                     device="cuda")
    y = torch.tensor(np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)],
                     device="cuda")
    before = net.params().clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        net.fit(x, y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not torch.equal(net.params(), before)
    assert bool(torch.isfinite(net.params()).all())
