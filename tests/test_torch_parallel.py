"""The PyTorch port's parallel trainers (deeplearning4j_tpu_torch/
parallel/) held against the JAX package's on the CPU: the cases of
tests/test_parallel.py (mesh, DataParallelTrainer, ZeRO-1,
TensorParallelTrainer), each at JAX's mesh size.

The JAX package runs its mesh as 8 virtual devices of one process; the
port runs one process a rank (`testing/ranks.py`: forked ranks over
gloo, each group under a 120 s limit). Each JAX reference is computed in
this process before the ranks fork; the ranks never touch JAX. Both
packages start from the same parameters (the JAX net's packed vector).

Tolerances, as the JAX tests they mirror: trainers against each other
and against JAX atol 1e-5 (JAX's ZeRO-1 == DP bound,
tests/test_parallel.py:86); TP against DP rtol 2e-3 on the score and
atol 5e-4 on the parameters (tests/test_parallel.py:188-191).
"""

from __future__ import annotations

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import ListDataSetIterator as JListIter
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iris import load_iris as jload_iris
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import DataParallelTrainer as JDP
from deeplearning4j_tpu.parallel import ShardedUpdateTrainer as JZ1
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel.tensor_parallel import \
    TensorParallelTrainer as JTP
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.eval import Evaluation
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (DataParallelTrainer,
                                               ShardedUpdateTrainer,
                                               TensorParallelTrainer,
                                               make_mesh)
from deeplearning4j_tpu_torch.testing.ranks import run_ranks
from tests.test_multilayer import mlp_conf

GROUP_LIMIT = 120.0
TOL = 1e-5


def _iris(n=None):
    x, y = jload_iris()
    x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
    return (x, y) if n is None else (x[:n], y[:n])


def _zero1_conf():
    from deeplearning4j_tpu.config import NeuralNetConfiguration

    return (NeuralNetConfiguration.builder()
            .lr(0.5).n_in(4).activation_function("tanh")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(1)
            .list(2).hidden_layer_sizes([8])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=3)
            .pretrain(False).build())


def _deep_conf(n_layers=12):
    from deeplearning4j_tpu.config import NeuralNetConfiguration

    return (NeuralNetConfiguration.builder()
            .lr(0.1).n_in(4).activation_function("tanh")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(1)
            .list(n_layers)
            .hidden_layer_sizes([8] * (n_layers - 1))
            .override(-1, fn=lambda i, c: setattr(c, "lr",
                                                  0.02 * (1 + i % 5)))
            .override(n_layers - 1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=3)
            .pretrain(False).build())


def _port_net(conf_json, p0):
    net = MultiLayerNetwork.from_config_json(conf_json, device="cpu")
    net.set_parameters(p0)
    return net


def _params(net):
    return net.params().detach().numpy()


def _fit_rank(rank, trainer, axes, conf_json, p0, x, y, bs, epochs,
              rounds=1, kw=None):
    """One rank: a port net from (conf, p0) trained by `trainer` on the
    mesh `axes` over (x, y) in batches of bs; returns its packed params
    and score."""
    cls = {"dp": DataParallelTrainer, "zero1": ShardedUpdateTrainer,
           "tp": TensorParallelTrainer}[trainer]
    mesh = make_mesh(axes, device="cpu")
    net = _port_net(conf_json, p0)
    tr = cls(net, mesh, **(kw or {}))
    it = ListDataSetIterator(DataSet(x, y), batch_size=bs)
    for _ in range(rounds):
        tr.fit(it, epochs=epochs)
    return _params(net), net.score(x, y)


# ------------------------------------------------------------------ mesh
def test_make_mesh_axes():
    jshapes = [jmake_mesh({"data": 4, "model": 2}).devices.shape,
               jmake_mesh({"data": -1}).devices.shape]

    def body(rank):
        m1 = make_mesh({"data": 4, "model": 2}, device="cpu")
        m2 = make_mesh({"data": -1}, device="cpu")
        return (m1.devices.shape, m2.devices.shape, m1.coords,
                m1.members("model"), m1.members(("model", "data")))

    res = run_ranks(body, 8, timeout=GROUP_LIMIT)
    for rank, (s1, s2, coords, model, both) in enumerate(res):
        assert [s1, s2] == jshapes == [(4, 2), (8,)]
        assert coords == {"data": rank // 2, "model": rank % 2}
        assert model == [rank // 2 * 2, rank // 2 * 2 + 1]
        # model-major order over both axes
        assert both == [0, 2, 4, 6, 1, 3, 5, 7]


def test_make_mesh_bad_axes():
    with pytest.raises(ValueError) as jerr:
        jmake_mesh({"data": 3})

    def body(rank):
        try:
            make_mesh({"data": 3}, device="cpu")
        except ValueError as e:
            return str(e)
        return None

    assert run_ranks(body, 8, timeout=GROUP_LIMIT) == [str(jerr.value)] * 8


# -------------------------------------------------------------------- DP
def test_data_parallel_training_matches_learning():
    x, y = _iris()
    jnet = JNet(mlp_conf(lr=0.1, iters=1))
    p0 = np.asarray(jnet.params())
    conf_json = jnet.to_json()
    initial = _port_net(conf_json, p0).score(x, y)
    res = run_ranks(_fit_rank, 8, "dp", {"data": 8}, conf_json, p0, x, y,
                    48, 60, timeout=GROUP_LIMIT)
    params, final = res[0]
    for p, _ in res[1:]:  # the all-reduce keeps every rank identical
        np.testing.assert_array_equal(p, params)
    assert final < initial * 0.5
    net = _port_net(conf_json, params)
    ev = Evaluation()
    ev.eval(y, net.output(x).numpy())
    assert ev.accuracy() > 0.85


@pytest.mark.parametrize("epochs", [3])
def test_dp_world8_matches_jax(epochs):
    """DP at 8 ranks vs the JAX DataParallelTrainer on its 8-device mesh,
    from the same params, through each package's device feed (the last
    Iris batch is ragged: 150 = 3 x 48 + 6, masked in both)."""
    x, y = _iris()
    jnet = JNet(mlp_conf(lr=0.1, iters=1))
    p0 = np.asarray(jnet.params())
    JDP(jnet, jmake_mesh({"data": 8})).fit(
        JListIter(JDataSet(x, y), batch_size=48), epochs=epochs)
    res = run_ranks(_fit_rank, 8, "dp", {"data": 8}, jnet.to_json(), p0, x,
                    y, 48, epochs, timeout=GROUP_LIMIT)
    np.testing.assert_allclose(res[0][0], np.asarray(jnet.params()),
                               atol=TOL)


def test_dp_batch_padding():
    conf_json = mlp_conf().to_json()

    def body(rank):
        net = MultiLayerNetwork.from_config_json(conf_json, device="cpu")
        trainer = DataParallelTrainer(net, make_mesh({"data": 8},
                                                     device="cpu"))
        x = np.ones((10, 4), np.float32)
        y = np.ones((10, 3), np.float32)
        px, py = trainer.pad_batch(x, y)
        tx, ty = trainer.pad_batch(x[:3], y[:3])
        return px.shape[0], py.shape[0], tx.shape[0], ty.shape[0]

    for px, py, tx, ty in run_ranks(body, 8, timeout=GROUP_LIMIT):
        assert px % 8 == 0 and px >= 10 and py == px
        # a batch smaller than the pad amount tiles, not under-pads
        assert tx == 8 and ty == 8


# ---------------------------------------------------------------- ZeRO-1
class TestShardedUpdateTrainer:
    def test_matches_plain_dp_exactly(self):
        x, y = _iris(144)
        jnet = JNet(_zero1_conf())
        p0 = np.asarray(jnet.params())
        conf_json = jnet.to_json()
        JZ1(jnet, jmake_mesh({"data": 8})).fit(
            JListIter(JDataSet(x, y), batch_size=48), epochs=3)
        dp = run_ranks(_fit_rank, 8, "dp", {"data": 8}, conf_json, p0, x,
                       y, 48, 3, timeout=GROUP_LIMIT)
        z1 = run_ranks(_fit_rank, 8, "zero1", {"data": 8}, conf_json, p0, x,
                       y, 48, 3, timeout=GROUP_LIMIT)
        np.testing.assert_allclose(z1[0][0], dp[0][0], atol=TOL)
        np.testing.assert_allclose(z1[0][0], np.asarray(jnet.params()),
                                   atol=TOL)

    def test_state_is_actually_sharded(self):
        x, y = _iris(64)
        conf_json = _zero1_conf().to_json()

        def body(rank):
            net = MultiLayerNetwork.from_config_json(conf_json,
                                                     device="cpu")
            tr = ShardedUpdateTrainer(net, make_mesh({"data": 8},
                                                     device="cpu"))
            tr.fit(ListDataSetIterator(DataSet(x, y), batch_size=64))
            hist, vel, _ = tr._flat_state
            full = tr.gathered_flat_state()[0]
            return hist.numel(), vel.numel(), tr._n_pad, full.size

        for h, v, n_pad, n in run_ranks(body, 8, timeout=GROUP_LIMIT):
            # each rank keeps 1/8 of the padded vectors
            assert h == v == n_pad // 8 and n_pad >= n and n_pad % 8 == 0

    def test_matches_plain_dp_with_11_plus_layers(self):
        """Per-element tables in ravel order ('0','1','10','11','2',...):
        distinct per-layer lrs make any misalignment visible."""
        x, y = _iris(64)
        jnet = JNet(_deep_conf())
        p0 = np.asarray(jnet.params())
        conf_json = jnet.to_json()
        JZ1(jnet, jmake_mesh({"data": 8})).fit(
            JListIter(JDataSet(x, y), batch_size=64), epochs=2)
        dp = run_ranks(_fit_rank, 8, "dp", {"data": 8}, conf_json, p0, x,
                       y, 64, 2, timeout=GROUP_LIMIT)
        z1 = run_ranks(_fit_rank, 8, "zero1", {"data": 8}, conf_json, p0, x,
                       y, 64, 2, timeout=GROUP_LIMIT)
        np.testing.assert_allclose(z1[0][0], dp[0][0], atol=TOL)
        np.testing.assert_allclose(z1[0][0], np.asarray(jnet.params()),
                                   atol=TOL)

    def test_unit_norm_constraint_rejected(self):
        from deeplearning4j_tpu.config import NeuralNetConfiguration

        conf = (NeuralNetConfiguration.builder()
                .lr(0.1).n_in(4)
                .constrain_gradient_to_unit_norm(True)
                .list(2).hidden_layer_sizes([8])
                .override(1, layer="output", loss_function="mcxent",
                          n_out=3)
                .pretrain(False).build())
        with pytest.raises(ValueError, match="global norm") as jerr:
            JZ1(JNet(conf), jmake_mesh({"data": 8}))
        conf_json = conf.to_json()

        def body(rank):
            net = MultiLayerNetwork.from_config_json(conf_json,
                                                     device="cpu")
            try:
                ShardedUpdateTrainer(net, make_mesh({"data": 8},
                                                    device="cpu"))
            except ValueError as e:
                return str(e)
            return None

        assert run_ranks(body, 8, timeout=GROUP_LIMIT) == \
            [str(jerr.value)] * 8


# -------------------------------------------------------------------- TP
class TestTensorParallelTrainer:
    def _jnet(self, hidden=(8, 8)):
        return JNet(mlp_conf(lr=0.1, iters=1, hidden=hidden))

    @pytest.mark.parametrize("hidden,axes", [
        ((8, 8), {"data": 4, "model": 2}),
        ((8, 7, 8), {"data": 4, "model": 2}),
        ((8, 8, 8), {"data": 2, "model": 4})])
    def test_sharding_plan_matches_jax(self, hidden, axes):
        """The plan, string for string: layer 0 column-split, layer 1
        row-split, the output replicated; an indivisible dim (7) leaves
        its layer replicated without flipping the alternation."""
        jnet = self._jnet(hidden)
        jplan = JTP(jnet, jmake_mesh(axes)).sharding_summary()
        conf_json = jnet.to_json()

        def body(rank):
            net = MultiLayerNetwork.from_config_json(conf_json,
                                                     device="cpu")
            return TensorParallelTrainer(
                net, make_mesh(axes, device="cpu")).sharding_summary()

        plans = run_ranks(body, 8, timeout=GROUP_LIMIT)
        assert plans == [jplan] * 8
        if hidden == (8, 8):
            assert plans[0]["0"]["W"] == "PartitionSpec(None, 'model')"
            assert plans[0]["0"]["b"] == "PartitionSpec(None, 'model')"
            assert plans[0]["1"]["W"] == "PartitionSpec('model', None)"
            assert plans[0]["1"]["b"] == "PartitionSpec()"
            assert plans[0]["2"]["W"] == "PartitionSpec()"

    def test_matches_replicated_training_and_learns(self):
        x, y = _iris(144)
        jnet = self._jnet()
        p0 = np.asarray(jnet.params())
        conf_json = jnet.to_json()
        initial = _port_net(conf_json, p0).score(x, y)
        dp = run_ranks(_fit_rank, 8, "dp", {"data": 8}, conf_json, p0, x,
                       y, 48, 1, 20, timeout=GROUP_LIMIT)
        tp = run_ranks(_fit_rank, 8, "tp", {"data": 4, "model": 2},
                       conf_json, p0, x, y, 48, 1, 20, timeout=GROUP_LIMIT)
        (pa, sa), (pb, sb) = dp[0], tp[0]
        for p, _ in tp[1:]:  # every rank ends with the full params
            np.testing.assert_array_equal(p, pb)
        assert sa < initial * 0.7
        np.testing.assert_allclose(sb, sa, rtol=2e-3)
        np.testing.assert_allclose(pb, pa, atol=5e-4)

    def test_matches_jax_tp(self):
        """TP at data 4 x model 2 vs the JAX TensorParallelTrainer from
        the same params, 3 epochs."""
        x, y = _iris(144)
        jnet = self._jnet()
        p0 = np.asarray(jnet.params())
        JTP(jnet, jmake_mesh({"data": 4, "model": 2})).fit(
            JListIter(JDataSet(x, y), batch_size=48), epochs=3)
        tp = run_ranks(_fit_rank, 8, "tp", {"data": 4, "model": 2},
                       jnet.to_json(), p0, x, y, 48, 3,
                       timeout=GROUP_LIMIT)
        np.testing.assert_allclose(tp[0][0], np.asarray(jnet.params()),
                                   atol=TOL)

    @pytest.mark.parametrize("case", ["no_model_axis", "nothing_splits"])
    def test_errors_match_jax(self, case):
        if case == "no_model_axis":
            jnet, axes, match = self._jnet(), {"data": 8}, "model"
        else:  # hidden 7 not divisible by tp=2 anywhere
            jnet, axes, match = (self._jnet(hidden=(7,)),
                                 {"data": 4, "model": 2}, "splittable")
        with pytest.raises(ValueError, match=match) as jerr:
            JTP(jnet, jmake_mesh(axes))
        conf_json = jnet.to_json()

        def body(rank):
            net = MultiLayerNetwork.from_config_json(conf_json,
                                                     device="cpu")
            try:
                TensorParallelTrainer(net, make_mesh(axes, device="cpu"))
            except ValueError as e:
                return str(e)
            return None

        assert run_ranks(body, 8, timeout=GROUP_LIMIT) == \
            [str(jerr.value)] * 8


# ------------------------------------------------------------- averaging
class TestParameterAveragingTrainer:
    """The averaging wave at JAX's 4 ranks (tests/test_scaleout.py's
    TestParameterAveragingTrainer: Iris, batches of 30, 2 local steps).

    Held against the wave JAX's docstring states (K local steps on each
    rank's own batches, then the pmean), built here from the JAX
    package's own loss and updater. The JAX trainer itself is the
    reference only at one device: under jax 0.9's shard_map the
    parameters enter the wave replicated, so `jax.grad` inside it
    returns the gradient psummed over the devices, and its 4-device wave
    is four summed-gradient steps, not an average (ROADMAP Queue 3)."""

    def _wave_by_hand(self, jnet, x, y, n, k, epochs):
        """The documented wave from the JAX package's loss and updater:
        rank r steps through batches [r*k, (r+1)*k) of each n*k-batch
        wave (a short wave tiled), then params and state are averaged."""
        import jax
        import jax.numpy as jnp

        from deeplearning4j_tpu.optimize.updater import \
            NetworkGradientUpdater as JUpd

        upd = JUpd.for_network(jnet)
        p, s = jnet._params, upd.init(jnet._params)
        batches = [(x[i:i + 30], y[i:i + 30]) for i in range(0, len(x), 30)]
        need = n * k
        for _ in range(epochs):
            waves = [batches[i:i + need]
                     for i in range(0, len(batches), need)]
            for wave in waves:
                wave = [wave[i % len(wave)] for i in range(need)]
                outs = []
                for r in range(n):
                    pr, sr = p, s
                    for bx, by in wave[r * k:(r + 1) * k]:
                        g = jax.grad(jnet.loss_fn)(
                            pr, jnp.asarray(bx), jnp.asarray(by),
                            rng=jax.random.PRNGKey(0), training=True)
                        u, sr = upd.update(g, sr, pr)
                        pr = jax.tree_util.tree_map(jnp.subtract, pr, u)
                    outs.append((pr, sr))

                def avg(*a):
                    if jnp.issubdtype(a[0].dtype, jnp.floating):
                        return sum(a) / n
                    return a[0]

                p = jax.tree_util.tree_map(avg, *[o[0] for o in outs])
                s = jax.tree_util.tree_map(avg, *[o[1] for o in outs])
        from jax.flatten_util import ravel_pytree
        return np.asarray(ravel_pytree(p)[0])

    def _port(self, conf_json, p0, x, y, n, epochs):
        from deeplearning4j_tpu_torch.parallel import \
            ParameterAveragingTrainer

        def body(rank):
            net = _port_net(conf_json, p0)
            ParameterAveragingTrainer(
                net, make_mesh({"data": n}, device="cpu"),
                local_steps=2).fit(ListDataSetIterator(DataSet(x, y), 30),
                                   epochs=epochs)
            return _params(net), net.score(x, y)

        res = run_ranks(body, n, timeout=GROUP_LIMIT)
        for p, _ in res:  # the pmean leaves every rank identical
            np.testing.assert_array_equal(p, res[0][0])
        return res[0]

    def test_four_ranks_average_their_waves_and_converge(self):
        x, y = _iris()
        jnet = JNet(mlp_conf(lr=0.1, iters=1))
        p0 = np.asarray(jnet.params())
        conf_json = jnet.to_json()
        want = self._wave_by_hand(jnet, x, y, 4, 2, 3)
        got, _ = self._port(conf_json, p0, x, y, 4, 3)
        np.testing.assert_allclose(got, want, atol=TOL)
        loss0 = _port_net(conf_json, p0).score(x, y)
        assert self._port(conf_json, p0, x, y, 4, 30)[1] < loss0

    def test_jax_four_device_wave_is_summed_gradient_steps(self):
        """Why the port is not held to the JAX trainer at 4 devices: its
        4-device wave equals 2 steps on the gradient SUMMED over the
        devices' batches (the wave's shard_map psums the gradient of the
        replicated params), not the documented average, within 1e-6."""
        import jax
        import jax.numpy as jnp
        from jax.flatten_util import ravel_pytree

        from deeplearning4j_tpu.parallel import \
            ParameterAveragingTrainer as JPA

        x, y = _iris()
        jnet = JNet(mlp_conf(lr=0.1, iters=1))
        tr = JPA(jnet, jmake_mesh({"data": 4}, devices=jax.devices()[:4]),
                 local_steps=2)
        p, s = jnet._params, tr.updater.init(jnet._params)
        # 5 batches of 30 tiled to the 8-batch grid; device d takes
        # batches 2d and 2d + 1
        assign = [[0, 1], [2, 3], [4, 0], [1, 2]]
        for step in range(2):
            gs = [jax.grad(jnet.loss_fn)(
                p, jnp.asarray(x[a[step] * 30:(a[step] + 1) * 30]),
                jnp.asarray(y[a[step] * 30:(a[step] + 1) * 30]),
                rng=jax.random.PRNGKey(0), training=True) for a in assign]
            g = jax.tree_util.tree_map(lambda *a: sum(a), *gs)
            u, s = tr.updater.update(g, s, p)
            p = jax.tree_util.tree_map(jnp.subtract, p, u)
        tr.fit(JListIter(JDataSet(x, y), batch_size=30), epochs=1)
        np.testing.assert_allclose(np.asarray(jnet.params()),
                                   np.asarray(ravel_pytree(p)[0]), atol=1e-6)

    def test_one_rank_matches_jax_trainer(self):
        import jax

        from deeplearning4j_tpu.parallel import \
            ParameterAveragingTrainer as JPA

        x, y = _iris()
        jnet = JNet(mlp_conf(lr=0.1, iters=1))
        p0 = np.asarray(jnet.params())
        conf_json = jnet.to_json()
        JPA(jnet, jmake_mesh({"data": 1}, devices=jax.devices()[:1]),
            local_steps=2).fit(JListIter(JDataSet(x, y), batch_size=30),
                               epochs=3)
        got, _ = self._port(conf_json, p0, x, y, 1, 3)
        np.testing.assert_allclose(got, np.asarray(jnet.params()), atol=TOL)


def test_fit_with_interleaved_per_layer_rules_matches_jax():
    """Regression: layers whose update rules differ interleave in the
    updater's groups (lr 0.02 * (1 + i % 5) over 12 layers); the updates
    must come back in the parameters' order, or fit subtracts one
    layer's update from another's parameter."""
    x, y = _iris(64)
    jnet = JNet(_deep_conf())
    net = _port_net(jnet.to_json(), np.asarray(jnet.params()))
    for _ in range(2):
        jnet.fit(x, y)
        net.fit(x, y)
    np.testing.assert_allclose(_params(net), np.asarray(jnet.params()),
                               atol=TOL)
