"""The PyTorch port's MultiLayerNetwork (deeplearning4j_tpu_torch/nn/
multilayer.py) held against the JAX package, with the updater, the
device feed and Evaluation.

Three small stacks, each built from one configuration JSON in both
packages and run on the same parameters (the JAX package's, carried
across with `weights.multilayer_params_from_jax`): an MLP, LeNet as
`__graft_entry__.entry()` builds it at reduced width (two conv + pool
layers, a dense layer, a softmax output), and the row-sequence attention
stack (reshape -> self_attention -> flatten -> softmax output). Both run
float32 on the CPU. Tolerances, as tests/test_torch_training.py's:
forward and loss within 1e-5; gradients within 2e-5 + 1e-4 * |g|;
params after 3 steps, and after a masked fit_scan, within 2e-5.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.config import MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets import ListDataSetIterator as JListIter
from deeplearning4j_tpu.datasets import device_feed as jax_feed
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.eval import Evaluation as JEvaluation
from deeplearning4j_tpu.nn import preprocessors as jax_pp
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.utils.sanitize import validate_batch as jax_validate
from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.datasets import (DataSet, DeviceFeed,
                                               ListDataSetIterator,
                                               device_feed)
from deeplearning4j_tpu_torch.datasets.mnist import synthetic_mnist
from deeplearning4j_tpu_torch.eval import Evaluation
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.sanitize import validate_batch
from deeplearning4j_tpu_torch.weights import (multilayer_params_from_jax,
                                              multilayer_params_to_numpy)

FWD_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
PARAM_TOL = 2e-5
REPO = Path(__file__).resolve().parent.parent


# ------------------------------------------------------------ the stacks
def _updater(b, updater):
    if updater == "adagrad":
        return b.lr(0.05)
    return b.lr(0.1).use_adagrad(False).momentum(0.5) \
        .momentum_after({2: 0.9})


def _mlp(updater="adagrad", l2=0.0):
    b = _updater(JConf.builder(), updater)
    return (b.n_in(20).activation_function("relu").num_iterations(1)
            .use_regularization(l2 > 0).l2(l2)
            .list(3).hidden_layer_sizes([32, 16])
            .override(2, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=5)
            .pretrain(False).build()), (20,)


def _lenet(updater="adagrad", l2=0.0):
    b = _updater(JConf.builder(), updater)
    return (b.activation_function("relu").num_iterations(1)
            .use_regularization(l2 > 0).l2(l2)
            .list(4)
            .override(0, layer="conv", filter_size=[3, 3], stride=[2, 2],
                      num_in_feature_maps=1, num_feature_maps=3)
            .override(1, layer="conv", filter_size=[2, 2], stride=[2, 2],
                      num_in_feature_maps=3, num_feature_maps=4)
            .override(2, layer="dense", n_in=2 * 2 * 4, n_out=12)
            .override(3, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_in=12, n_out=5)
            .input_preprocessor(0, jax_pp.ConvolutionInputPreProcessor(
                12, 12, 1))
            .input_preprocessor(2, jax_pp.ConvolutionPostProcessor())
            .pretrain(False).build()), (144,)


def _attention(updater="adagrad", l2=0.0):
    b = _updater(JConf.builder(), updater)
    return (b.num_iterations(1).use_regularization(l2 > 0).l2(l2)
            .list(2)
            .override(0, layer="self_attention", n_in=8, n_out=16,
                      n_heads=2)
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_in=48, n_out=5)
            .input_preprocessor(0, jax_pp.ReshapePreProcessor([6, 8]))
            .input_preprocessor(1, jax_pp.ConvolutionPostProcessor())
            .pretrain(False).build()), (48,)


STACKS = {"mlp": _mlp, "lenet": _lenet, "attention": _attention}


def _pair(stack, seed=0, **kw):
    """(port net, JAX net, feature shape) on the same parameters: the JAX
    net's init, biases and all nudged off zero."""
    conf, feat = STACKS[stack](**kw)
    jnet = JNet(JMLC.from_json(conf.to_json()))
    rng = np.random.default_rng(seed)
    jnet._params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32),
        jnet._params)
    net = MultiLayerNetwork.from_config_json(conf.to_json(), device="cpu")
    net.param_table = multilayer_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet._params), device="cpu")
    return net, jnet, feat


def _data(feat, n, seed=1, classes=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, *feat)).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _tables_close(table, jtable, atol, rtol=0.0):
    got = multilayer_params_to_numpy(table)
    assert sorted(got) == sorted(jtable)
    for k in jtable:
        assert sorted(got[k]) == sorted(jtable[k])
        for name in jtable[k]:
            np.testing.assert_allclose(
                got[k][name], np.asarray(jtable[k][name]), atol=atol,
                rtol=rtol, err_msg=f"{k}/{name}")


def _np(t):
    return t.detach().cpu().numpy()


# ----------------------------------------------------------- forward/loss
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_feed_forward_matches_jax(stack):
    net, jnet, feat = _pair(stack)
    x, _ = _data(feat, 9)
    ref = jax.jit(jnet.feed_forward_fn)(jnet._params, jnp.asarray(x))
    with torch.no_grad():
        got = net.feed_forward_fn(net.param_table, torch.from_numpy(x))
    assert len(got) == len(ref) == len(net.layers) + 1
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=FWD_TOL)


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_loss_with_l2_and_every_gradient_match_jax(stack):
    net, jnet, feat = _pair(stack, l2=0.01)
    x, y = _data(feat, 11)
    ref, ref_g = jax.jit(jax.value_and_grad(jnet.loss_fn))(
        jnet._params, jnp.asarray(x), jnp.asarray(y))
    table = net.param_table
    leaves = [(k, n, p) for k, t in table.items() for n, p in t.items()]
    loss = net.loss_fn(table, torch.from_numpy(x), torch.from_numpy(y))
    grads = torch.autograd.grad(loss, [p for _, _, p in leaves])
    assert abs(float(loss.detach()) - float(ref)) <= FWD_TOL
    for (k, n, _), g in zip(leaves, grads):
        np.testing.assert_allclose(_np(g), np.asarray(ref_g[k][n]),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"{k}/{n}")
    assert net.score(x, y) == pytest.approx(jnet.score(x, y), abs=FWD_TOL)


# --------------------------------------------------------------- training
@pytest.mark.parametrize("updater", ["adagrad", "sgd_momentum"])
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_three_fit_steps_match_jax(stack, updater):
    net, jnet, feat = _pair(stack, updater=updater, l2=0.01)
    for i in range(3):
        x, y = _data(feat, 16, seed=10 + i)
        net.fit(x, y)
        jnet.fit(x, y)
    _tables_close(net.param_table, jnet._params, PARAM_TOL)
    # the updater's state too: AdaGrad history, velocity, iteration
    for k, state in net._updater_state.items():
        jstate = jnet._updater_state[k]
        assert int(state.iteration) == int(jstate.iteration) == 3
        for name in state.velocity:
            np.testing.assert_allclose(
                _np(state.velocity[name]), np.asarray(jstate.velocity[name]),
                atol=GRAD_ATOL, rtol=GRAD_RTOL)
            np.testing.assert_allclose(
                _np(state.hist[name]), np.asarray(jstate.hist[name]),
                atol=GRAD_ATOL, rtol=GRAD_RTOL)
            assert state.hist[name] is not state.velocity[name]


@pytest.mark.parametrize("updater", ["adagrad", "sgd_momentum"])
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_masked_fit_scan_matches_jax(stack, updater):
    """37 examples in batches of 16: the third batch is zero-padded and
    its padding masked out of the loss and the ÷batchSize."""
    net, jnet, feat = _pair(stack, updater=updater)
    x, y = _data(feat, 37, seed=3)
    score = net.fit_scan(x, y, batch_size=16, epochs=2, pad_partial=True)
    ref = jnet.fit_scan(x, y, batch_size=16, epochs=2, pad_partial=True)
    assert isinstance(score, float)
    assert score == pytest.approx(ref, abs=FWD_TOL)
    _tables_close(net.param_table, jnet._params, PARAM_TOL)


def test_fit_scan_without_sync_returns_a_device_scalar():
    net, _, feat = _pair("mlp")
    x, y = _data(feat, 32)
    score = net.fit_scan(torch.from_numpy(x), torch.from_numpy(y), 16,
                         sync=False)
    assert isinstance(score, torch.Tensor) and score.shape == ()
    assert not score.requires_grad
    with pytest.raises(ValueError, match="exceeds"):
        net.fit_scan(x[:3], y[:3], 16)
    with pytest.raises(ValueError, match="epochs"):
        net.fit_scan(x, y, 16, epochs=0)


def test_fit_over_a_ragged_iterator_through_the_device_feed_matches_jax():
    net, jnet, feat = _pair("mlp")
    x, y = _data(feat, 37, seed=4)
    it = ListDataSetIterator(DataSet(x, y), batch_size=16)
    feed = DeviceFeed(it, device="cpu")
    jfeed = jax_feed.DeviceFeed(JListIter(JDataSet(x, y), batch_size=16))
    net.fit(feed, epochs=2)
    jnet.fit(jfeed, epochs=2)
    _tables_close(net.param_table, jnet._params, PARAM_TOL)
    assert feed.stats() == jfeed.stats()
    # the default: fit(iterator) builds a DeviceFeed on the net's device
    net2, jnet2, _ = _pair("mlp")
    net2.fit(ListDataSetIterator(DataSet(x, y), batch_size=16))
    jnet2.fit(JListIter(JDataSet(x, y), batch_size=16))
    _tables_close(net2.param_table, jnet2._params, PARAM_TOL)


def test_fit_over_an_iterator_without_the_feed_matches_jax():
    net, jnet, feat = _pair("lenet", updater="sgd_momentum")
    x, y = _data(feat, 40, seed=5)
    net.fit(ListDataSetIterator(DataSet(x, y), 16), device_feed=False)
    jnet.fit(JListIter(JDataSet(x, y), 16), device_feed=False)
    _tables_close(net.param_table, jnet._params, PARAM_TOL)


def test_training_learns_synthetic_mnist():
    conf = (JConf.builder().lr(0.05).n_in(784).activation_function("relu")
            .num_iterations(1).list(2).hidden_layer_sizes([32])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=10)
            .pretrain(False).build())
    net = MultiLayerNetwork.from_config_json(conf.to_json(), device="cpu")
    x, y = synthetic_mnist(256)
    before = net.score(x, y)
    net.fit_scan(x, y, batch_size=32, epochs=4)
    assert net.score(x, y) < 0.5 * before
    ev = Evaluation()
    ev.eval(y, net.output(x))
    assert ev.accuracy() > 0.8


# -------------------------------------------------------------- inference
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_output_at_ragged_sizes_matches_jax(stack):
    net, jnet, feat = _pair(stack)
    for n in (1, 5, 9, 17):
        x, y = _data(feat, n, seed=n)
        out = net.output(x)
        assert out.shape == (n, 5)
        np.testing.assert_allclose(_np(out), np.asarray(jnet.output(x)),
                                   atol=FWD_TOL)
        np.testing.assert_allclose(_np(net.output(x, bucketed=False)),
                                   _np(out), atol=FWD_TOL)
        assert (net.predict(x) == np.asarray(jnet.predict(x))).all()


def test_evaluation_stats_match_jax():
    net, jnet, feat = _pair("mlp")
    x, y = _data(feat, 40, seed=6)
    ev, jev = Evaluation(), JEvaluation()
    for lo in (0, 25):
        ev.eval(y[lo:lo + 25], net.output(x[lo:lo + 25]))
        jev.eval(y[lo:lo + 25], jnet.output(x[lo:lo + 25]))
    assert ev.stats() == jev.stats()
    assert ev.confusion.total() == 40
    assert (ev.accuracy(), ev.precision(), ev.recall(), ev.f1(2)) == (
        jev.accuracy(), jev.precision(), jev.recall(), jev.f1(2))


# -------------------------------------------------- parameters as a vector
def _deep_conf(n_layers=12):
    return (JConf.builder().lr(0.05).n_in(6).activation_function("tanh")
            .num_iterations(1).list(n_layers)
            .hidden_layer_sizes([5 + i % 3 for i in range(n_layers - 1)])
            .override(n_layers - 1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=4)
            .pretrain(False).build())


def test_packed_vector_crosses_both_ways_in_ravel_order():
    """12 layers, so layer "10" packs before "2" in both packages."""
    conf = _deep_conf()
    jnet = JNet(JMLC.from_json(conf.to_json()))
    x = np.random.default_rng(7).normal(size=(5, 6)).astype(np.float32)
    # JAX -> port
    net = MultiLayerNetwork.from_config_json(
        conf.to_json(), params=np.asarray(jnet.params()), device="cpu")
    np.testing.assert_array_equal(_np(net.params()), np.asarray(jnet.params()))
    np.testing.assert_allclose(_np(net.output(x)), np.asarray(jnet.output(x)),
                               atol=FWD_TOL)
    _tables_close(net.param_table, jnet._params, 0.0)
    # port -> JAX, from a port net with its own weights
    net2 = MultiLayerNetwork.from_config_json(conf.to_json(), device="cpu")
    net2.init()
    jnet.set_parameters(jnp.asarray(_np(net2.params())))
    np.testing.assert_allclose(np.asarray(jnet.output(x)), _np(net2.output(x)),
                               atol=FWD_TOL)
    _tables_close(net2.param_table, jnet._params, 0.0)
    assert net2.num_params() == jnet.num_params()
    with pytest.raises(ValueError, match="packed vector"):
        net2.set_parameters(np.zeros(3, np.float32))


def test_param_table_crosses_back_to_jax():
    net, jnet, feat = _pair("attention")
    net.fit(*_data(feat, 8, seed=8))
    jnet._params = jax.tree_util.tree_map(
        jnp.asarray, multilayer_params_to_numpy(net.param_table))
    x, _ = _data(feat, 4, seed=9)
    np.testing.assert_allclose(np.asarray(jnet.output(x)), _np(net.output(x)),
                               atol=FWD_TOL)
    with pytest.raises(ValueError, match="layers"):
        net.param_table = {"0": {}}
    with pytest.raises(ValueError):
        multilayer_params_from_jax({"W": np.zeros(2)}, device="cpu")


def test_merge_matches_jax():
    a, ja, feat = _pair("lenet", seed=1)
    b, jb, _ = _pair("lenet", seed=2)
    a.merge(b, 3)
    ja.merge(jb, 3)
    _tables_close(a.param_table, ja._params, 1e-6)


def test_clone_and_json_round_trip():
    net, _, feat = _pair("attention")
    twin = net.clone()
    assert twin.to_json() == net.to_json()
    x, _ = _data(feat, 6)
    assert torch.equal(twin.output(x), net.output(x))
    twin.fit(*_data(feat, 8))
    assert not torch.equal(twin.params(), net.params())


def test_layers_are_modules_keyed_by_index():
    net, jnet, _ = _pair("lenet")
    names = sorted(n for n, _ in net.named_parameters())
    assert names == sorted(f"layers.{k}.{n}" for k, t in jnet._params.items()
                           for n in t)
    assert all(p.device.type == "cpu" for p in net.parameters())


# ------------------------------------------------------------ device feed
def test_bucket_ladder_and_padding_match_jax():
    for bs in (1, 8, 16, 100, 4096):
        assert device_feed.pow2_buckets(bs) == jax_feed.pow2_buckets(bs)
        assert device_feed.pow2_buckets(bs, align=3) == \
            jax_feed.pow2_buckets(bs, align=3)
    buckets = device_feed.pow2_buckets(100)
    for n in (1, 8, 9, 64, 65, 100, 101, 300):
        assert device_feed.bucket_for(n, buckets) == \
            jax_feed.bucket_for(n, buckets)
    x = torch.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(
        _np(device_feed.pad_rows(x, 8)),
        np.asarray(jax_feed.pad_rows(jnp.asarray(_np(x)), 8)))
    w, count = device_feed.feed_mask(8, torch.tensor(3, dtype=torch.int32))
    jw, _ = jax_feed.feed_mask(8, jnp.int32(3))
    np.testing.assert_array_equal(_np(w), np.asarray(jw))
    assert int(count) == 3
    assert device_feed.feed_mask(8, None) == (None, 8)
    with pytest.raises(ValueError):
        device_feed.pad_rows(x, 2)


def test_device_feed_stream_and_bad_arguments():
    x, y = _data((4,), 21)
    feed = DeviceFeed(ListDataSetIterator(DataSet(x, y), 8), prefetch=3,
                      device="cpu")
    for _ in range(2):
        batches = list(feed)
        assert [b.bucket for b in batches] == [8, 8, 8]
        assert [int(b.n_valid) for b in batches] == [8, 8, 5]
        assert all(b.n_valid.shape == () for b in batches)
        assert not batches[-1].features[5:].any()
    assert feed.stats()["padded_examples"] == 6
    with pytest.raises(ValueError):
        DeviceFeed(ListDataSetIterator(DataSet(x, y), 8), prefetch=-1,
                   device="cpu")
    feed = DeviceFeed(ListDataSetIterator(DataSet(x, y), 8), buckets=[4, 16],
                      prefetch=0, device="cpu")
    assert [b.bucket for b in feed] == [16, 16, 16]


# -------------------------------------------------------- checks, refusals
def test_validate_batch_raises_as_jax_does():
    cases = [(np.zeros(3), None, {}), (np.zeros((2, 3)), None, {"n_in": 4}),
             (np.zeros((2, 3)), np.zeros(2), {}),
             (np.zeros((2, 3)), np.zeros((3, 2)), {}),
             (np.zeros((2, 3)), np.zeros((2, 2)), {"n_out": 5})]
    for x, y, kw in cases:
        with pytest.raises(ValueError) as got:
            validate_batch(x, y, **kw)
        with pytest.raises(ValueError) as ref:
            jax_validate(x, y, **kw)
        assert str(got.value) == str(ref.value)
    net, _, _ = _pair("mlp")
    with pytest.raises(ValueError, match="n_in"):
        net.fit(np.zeros((4, 7), np.float32), np.zeros((4, 5), np.float32))


def test_paths_outside_the_slice_raise_naming_the_roadmap():
    """Every layer type resolves now (the LSTM came last); what is still
    outside the port names its ROADMAP item."""
    from deeplearning4j_tpu_torch.checkpoint import restore_params_for
    from deeplearning4j_tpu_torch.models import LSTM

    conf, _ = _mlp()
    conf.confs[0].layer = "lstm"
    conf.confs[0].n_out = conf.confs[0].n_in
    net = MultiLayerNetwork(conf, device="cpu")
    assert type(net.layers[0]) is LSTM
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        restore_params_for("unused", shardings=None)


def test_device_none_means_the_card():
    conf, _ = _mlp()
    if torch.cuda.is_available():
        assert default_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiLayerNetwork(conf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceFeed(ListDataSetIterator(DataSet(*_data((4,), 4)), 2))


def test_the_new_modules_import_without_jax():
    """The AST guard of tests/test_torch_transformer.py walks every file
    of the port; this runs the layer network's modules in a process that
    has no JAX loaded."""
    mods = ["config", "nn.multilayer", "nn.preprocessors", "models.conv",
            "attention.layer", "optimize.updater", "datasets",
            "eval", "utils.sanitize", "ops.products", "weights",
            "optimize", "optimize.terminations", "optimize.stepfunctions",
            "optimize.line_search", "optimize.listeners",
            "optimize.solvers", "optimize.solver", "models.pretrain",
            "optimize.guardian", "checkpoint", "checkpoint.format",
            "checkpoint.writer", "checkpoint.saver", "checkpoint.restore",
            "checkpoint.convert", "scaleout", "scaleout.checkpoint",
            "datasets.iris", "datasets.device_feed", "runtime",
            "runtime.native_loader", "utils.moving_window_matrix",
            "utils.image_loader", "utils.archive", "datasets.records",
            "datasets.csv", "datasets.curves", "datasets.moving_window",
            "datasets.vectorizer", "datasets.lfw",
            "datasets.async_iterator", "eval.holdout", "serving.errors",
            "models.lstm", "cli", "serving.prefix_cache",
            "serving.speculation", "serving.decode_loop"]
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            + "; ".join(f"import deeplearning4j_tpu_torch.{m}" for m in mods)
            + "; bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'deeplearning4j_tpu')]; print(bad); "
              "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code, str(REPO)],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=str(REPO))
    assert res.returncode == 0, res.stdout + res.stderr
    for m in mods:
        path = REPO / "deeplearning4j_tpu_torch" / (m.replace(".", "/")
                                                    + ".py")
        assert path.exists() or path.with_suffix("").is_dir(), m


# ---------------------------------------------------------------- updater
@pytest.mark.parametrize("count", [None, 0, 5])
@pytest.mark.parametrize("updater", ["adagrad", "sgd_momentum"])
def test_layer_updater_matches_jax(updater, count):
    """One layer's GradientUpdater over 3 updates; `count` a device
    count (0 clamps to 1, as the JAX package's traced path does) or the
    static batch size 16."""
    from deeplearning4j_tpu.optimize.updater import GradientUpdater as JUpd
    from deeplearning4j_tpu_torch.optimize.updater import GradientUpdater

    conf, _ = _mlp(updater)
    rng = np.random.default_rng(12)
    params = {"W": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(1, 3)).astype(np.float32)}
    upd = GradientUpdater(MultiLayerNetwork(
        conf, device="cpu").layers[0].conf)
    jupd = JUpd(JNet(JMLC.from_json(conf.to_json())).layers[0].conf)
    state = upd.init({k: torch.tensor(v) for k, v in params.items()})
    jstate = jupd.init({k: jnp.asarray(v) for k, v in params.items()})
    for step in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        bs = 16 if count is None else torch.tensor(count, dtype=torch.int32)
        jbs = 16 if count is None else jnp.int32(count)
        ups, state = upd.update({k: torch.tensor(v) for k, v in grads.items()},
                                state, params, bs)
        jups, jstate = jupd.update({k: jnp.asarray(v)
                                    for k, v in grads.items()},
                                   jstate, params, jbs)
        for k in params:
            np.testing.assert_allclose(_np(ups[k]), np.asarray(jups[k]),
                                       atol=1e-7, rtol=1e-6)
    assert int(state.iteration) == 3
    assert state.hist["W"] is not state.velocity["W"]
