"""The PyTorch port's resharded restore matrix (JAX's TestReshardMatrix,
tests/test_checkpoint_sharded.py) and `restore_params_for`, on forked
gloo ranks (`testing/ranks.py`, 120 s a group): a ZeRO-1 checkpoint
written from 8 ranks restores bit-identically (params, updater state,
cursor) and continues on 2 and then 1 rank, under DP and under TP; a DP
checkpoint restores into ZeRO-1; the architecture errors are JAX's.
Across the packages both ways: a JAX ZeRO-1 checkpoint from its 8-device
mesh restores bit for bit in the port, and a port one in JAX.

Tolerances as JAX's: restores bit-identical; continued training on
another topology atol 1e-5.
"""

from __future__ import annotations

import numpy as np
import pytest

from deeplearning4j_tpu.checkpoint import ShardedModelSaver as JSaver
from deeplearning4j_tpu.checkpoint import restore_network as jrestore
from deeplearning4j_tpu.checkpoint import updater_state_to_flat as jto_flat
from deeplearning4j_tpu.config import NeuralNetConfiguration
from deeplearning4j_tpu.datasets import ListDataSetIterator as JListIter
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import ShardedUpdateTrainer as JZ1
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu_torch.checkpoint import (ShardedModelSaver,
                                                 restore_network,
                                                 restore_params_for,
                                                 updater_state_to_flat)
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import (DataParallelTrainer,
                                               ShardedUpdateTrainer,
                                               TensorParallelTrainer,
                                               make_mesh)
from deeplearning4j_tpu_torch.parallel.mesh import P, Placement, replicated
from deeplearning4j_tpu_torch.testing.ranks import run_ranks

GROUP_LIMIT = 120.0


def _conf(hidden=8):
    return (NeuralNetConfiguration.builder()
            .lr(0.1).n_in(4).activation_function("tanh")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(1).use_adagrad(False).momentum(0.5)
            .list(2).hidden_layer_sizes([hidden])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=3)
            .pretrain(False).build())


def _data(n=96, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return x, y


CONF = _conf().to_json()
P0 = np.asarray(JNet(_conf()).params())


def _it(x, y):
    return ListDataSetIterator(DataSet(x, y), 24)


def _flat(net):
    return net.params().detach().numpy()


def _barrier():
    import torch.distributed as dist

    dist.barrier()


def _zero1_ckpt(rank, root, x, y, then=None):
    """8 ranks: ZeRO-1 fit with an autosave at batch 4 through a
    ShardedModelSaver(mesh=, strategy="zero1"); returns the trainer's
    gathered flat state, its params, and (then=...) a continuation."""
    mesh = make_mesh({"data": 8}, device="cpu")
    net = MultiLayerNetwork.from_config_json(CONF, device="cpu")
    net.set_parameters(P0)
    tr = ShardedUpdateTrainer(net, mesh)
    saver = ShardedModelSaver(root, mesh=mesh, strategy="zero1")
    tr.fit(_it(x, y), epochs=1, checkpoint_every=4, saver=saver)
    saver.close()
    _barrier()
    out = {"flat": tr.gathered_flat_state(), "params": _flat(net)}
    if then == "continue":
        tr.fit(_it(x, y), epochs=1)
        out["continued"] = _flat(net)
    elif then is not None:
        restored, _ = restore_network(root, device="cpu")
        cls = {"dp": DataParallelTrainer, "tp": TensorParallelTrainer}[then]
        axes = {"data": 8} if then == "dp" else {"data": 4, "model": 2}
        cls(restored, make_mesh(axes, device="cpu")).fit(_it(x, y),
                                                         epochs=1)
        tr.fit(_it(x, y), epochs=1)
        out["other"], out["continued"] = _flat(restored), _flat(net)
    return out


class TestReshardMatrix:
    def test_zero1_8_ranks_restores_bit_identical_on_one(self, tmp_path):
        root = str(tmp_path / "z1")
        x, y = _data(96, seed=1)
        z = run_ranks(_zero1_ckpt, 8, root, x, y, timeout=GROUP_LIMIT)[0]
        net1, info = restore_network(root, device="cpu")
        np.testing.assert_array_equal(_flat(net1), z["params"])
        assert info["iterator_position"] == 4
        assert info["mesh"]["axes"] == {"data": 8}
        assert info["mesh"]["strategy"] == "zero1"
        hist, vel, it = updater_state_to_flat(net1._updater_state,
                                              net1.param_table)
        np.testing.assert_array_equal(hist, z["flat"][0])
        np.testing.assert_array_equal(vel, z["flat"][1])
        assert int(it) == int(z["flat"][2])

    def test_zero1_8_to_2_to_1_rank_round_trip(self, tmp_path):
        root, root2 = str(tmp_path / "z1"), str(tmp_path / "z1_2")
        x, y = _data(96, seed=1)
        z = run_ranks(_zero1_ckpt, 8, root, x, y, "continue",
                      timeout=GROUP_LIMIT)[0]

        def two(rank):
            mesh = make_mesh({"data": 2}, device="cpu")
            net, info = restore_network(root, device="cpu")
            tr = ShardedUpdateTrainer(net, mesh)
            tr.restore_flat_state(info["metadata"])
            restored = tr.gathered_flat_state()
            saver = ShardedModelSaver(root2, mesh=mesh, strategy="zero1")
            tr.fit(_it(x, y), epochs=1, checkpoint_every=4, saver=saver)
            saver.close()
            return restored, tr.gathered_flat_state(), _flat(net)

        restored2, flat2, params2 = run_ranks(two, 2,
                                              timeout=GROUP_LIMIT)[0]
        np.testing.assert_array_equal(restored2[0], z["flat"][0])
        # the 8-rank original continued on the same data: same math
        np.testing.assert_allclose(params2, z["continued"], atol=1e-5)

        def one(rank):
            net, info = restore_network(root2, device="cpu")
            tr = ShardedUpdateTrainer(net, make_mesh({"data": 1},
                                                     device="cpu"))
            tr.restore_flat_state(info["metadata"])
            return tr.gathered_flat_state(), _flat(net)

        flat1, params1 = run_ranks(one, 1, timeout=GROUP_LIMIT)[0]
        np.testing.assert_array_equal(flat1[0], flat2[0])
        np.testing.assert_array_equal(params1, params2)

    @pytest.mark.parametrize("other", ["dp", "tp"])
    def test_zero1_checkpoint_continues_under(self, tmp_path, other):
        x, y = _data(96, seed=1)
        z = run_ranks(_zero1_ckpt, 8, str(tmp_path / "z1"), x, y, other,
                      timeout=GROUP_LIMIT)[0]
        np.testing.assert_allclose(z["other"], z["continued"], atol=1e-5)

    def test_dp_checkpoint_restores_into_zero1(self, tmp_path):
        root = str(tmp_path / "dp")
        x, y = _data(96, seed=2)

        def eight(rank):
            mesh = make_mesh({"data": 8}, device="cpu")
            net = MultiLayerNetwork.from_config_json(CONF, device="cpu")
            net.set_parameters(P0)
            dp = DataParallelTrainer(net, mesh)
            saver = ShardedModelSaver(root, mesh=mesh, strategy="dp")
            dp.fit(_it(x, y), epochs=1, checkpoint_every=4, saver=saver)
            saver.close()
            dp.fit(_it(x, y), epochs=1)
            return _flat(net)

        dp_params = run_ranks(eight, 8, timeout=GROUP_LIMIT)[0]

        def two(rank):
            net, info = restore_network(root, device="cpu")
            tr = ShardedUpdateTrainer(net, make_mesh({"data": 2},
                                                     device="cpu"))
            tr.restore_flat_state(info["metadata"])  # the canonical tree
            hist, _, _ = updater_state_to_flat(net._updater_state,
                                               net.param_table)
            flat = tr.gathered_flat_state()
            tr.fit(_it(x, y), epochs=1)
            return hist, flat, _flat(net)

        hist, flat, z_params = run_ranks(two, 2, timeout=GROUP_LIMIT)[0]
        np.testing.assert_array_equal(flat[0], hist)
        np.testing.assert_allclose(z_params, dp_params, atol=1e-5)

    def test_architecture_mismatch_names_the_problem(self):
        wide = JNet(_conf(hidden=16))
        jtr = JZ1(wide, jmake_mesh({"data": 8}))
        legacy = {"zero1_flat_state": {
            "hist": np.zeros(8, np.float32),
            "velocity": np.zeros(8, np.float32),
            "iteration": np.int32(0)}}
        with pytest.raises(ValueError, match="does not match") as j1:
            jtr.restore_flat_state(legacy)
        with pytest.raises(ValueError, match="no optimizer state") as j2:
            jtr.restore_flat_state({})
        conf_json = wide.to_json()

        def body(rank):
            net = MultiLayerNetwork.from_config_json(conf_json,
                                                     device="cpu")
            tr = ShardedUpdateTrainer(net, make_mesh({"data": 2},
                                                     device="cpu"))
            errs = []
            for meta in (legacy, {}):
                try:
                    tr.restore_flat_state(meta)
                except ValueError as e:
                    errs.append(str(e))
            return errs

        for errs in run_ranks(body, 2, timeout=GROUP_LIMIT):
            assert errs == [str(j1.value), str(j2.value)]


class TestRestoreParamsFor:
    def test_replicated_and_tp_placements(self, tmp_path):
        root = str(tmp_path / "ck")
        net = MultiLayerNetwork.from_config_json(CONF, device="cpu")
        net.set_parameters(P0)
        with ShardedModelSaver(root, sync=True) as saver:
            saver.save(net, iterator_position=1)
        full = {k: {n: p.detach().numpy() for n, p in t.items()}
                for k, t in net.param_table.items()}

        def body(rank):
            mesh = make_mesh({"data": 2, "model": 2}, device="cpu")
            whole = restore_params_for(root, replicated(mesh))
            tp = TensorParallelTrainer(net, mesh)
            specs = {k: {n: Placement(mesh, s) for n, s in t.items()}
                     for k, t in tp._param_specs().items()}
            mine = restore_params_for(root, specs)
            return ({k: {n: v.numpy() for n, v in t.items()}
                     for k, t in whole.items()},
                    {k: {n: v.numpy() for n, v in t.items()}
                     for k, t in mine.items()}, mesh.coords["model"])

        for whole, mine, m in run_ranks(body, 4, timeout=GROUP_LIMIT):
            for k in full:
                for n in full[k]:
                    np.testing.assert_array_equal(whole[k][n], full[k][n])
            # layer 0 column-split, the output layer replicated
            np.testing.assert_array_equal(mine["0"]["W"],
                                          full["0"]["W"][:, 4 * m:4 * m + 4])
            np.testing.assert_array_equal(mine["0"]["b"],
                                          full["0"]["b"][:, 4 * m:4 * m + 4])
            np.testing.assert_array_equal(mine["1"]["W"], full["1"]["W"])

    def test_spec_of_placement(self):
        assert str(P(None, "model")) == "PartitionSpec(None, 'model')"
        assert str(P()) == "PartitionSpec()"


class TestAcrossPackages:
    def _jax_zero1(self, root, x, y):
        jnet = JNet(_conf())
        jnet.set_parameters(P0)
        mesh = jmake_mesh({"data": 8})
        tr = JZ1(jnet, mesh)
        saver = JSaver(root, mesh=mesh, strategy="zero1")
        tr.fit(JListIter(JDataSet(x, y), 24), epochs=1, checkpoint_every=4,
               saver=saver)
        saver.close()
        return jnet, tr

    def test_jax_zero1_checkpoint_restores_bit_identically(self, tmp_path):
        root = str(tmp_path / "jz1")
        x, y = _data(96, seed=3)
        jnet, jtr = self._jax_zero1(root, x, y)
        n = np.asarray(jnet.params()).size
        jhist = np.asarray(jtr._flat_state[0])[:n]

        def body(rank):
            net, info = restore_network(root, device="cpu")
            tr = ShardedUpdateTrainer(net, make_mesh({"data": 4},
                                                     device="cpu"))
            tr.restore_flat_state(info["metadata"])
            return _flat(net), tr.gathered_flat_state(), info["mesh"]

        params, flat, mesh = run_ranks(body, 4, timeout=GROUP_LIMIT)[0]
        np.testing.assert_array_equal(params, np.asarray(jnet.params()))
        np.testing.assert_array_equal(flat[0], jhist)
        assert mesh == {"axes": {"data": 8}, "n_devices": 8,
                        "strategy": "zero1"}

    def test_port_zero1_checkpoint_restores_in_jax(self, tmp_path):
        root = str(tmp_path / "pz1")
        x, y = _data(96, seed=4)
        z = run_ranks(_zero1_ckpt, 8, root, x, y, timeout=GROUP_LIMIT)[0]
        jnet, info = jrestore(root)
        np.testing.assert_array_equal(np.asarray(jnet.params()),
                                      z["params"])
        assert info["mesh"]["strategy"] == "zero1"
        hist, vel, it = jto_flat(jnet._updater_state, jnet._params)
        np.testing.assert_array_equal(hist, z["flat"][0])
        np.testing.assert_array_equal(vel, z["flat"][1])
        jtr = JZ1(jnet, jmake_mesh({"data": 8}))
        jtr.restore_flat_state(info["metadata"])
        n = hist.size
        np.testing.assert_array_equal(np.asarray(jtr._flat_state[0])[:n],
                                      z["flat"][0])
