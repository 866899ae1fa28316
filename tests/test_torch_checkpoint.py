"""The PyTorch port's checkpoints (deeplearning4j_tpu_torch/checkpoint/,
scaleout/checkpoint.py) held against the JAX package's.

A step written by either package's ShardedModelSaver restores in the
other (params, hist, velocity, iteration, iteration_count, cursor and
metadata equal bit for bit) for the MLP, LeNet, the attention stack and
the DBN; the same for DefaultModelSaver's `.npz` and `load_checkpoint`;
bfloat16 leaves both ways. Both packages refuse a corrupt or an
uncommitted step. Then the format's crash drills, rotation, the async
writer's bound, error relay and auto step, the flat <-> per-layer
conversion at 12 layers against the JAX package's, `validate_like`'s
messages, and the refusals of what is not ported.
"""

from __future__ import annotations

import os
import pickle
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.checkpoint import ShardedModelSaver as JSaver
from deeplearning4j_tpu.checkpoint import convert as jconvert
from deeplearning4j_tpu.checkpoint import format as jfmt
from deeplearning4j_tpu.checkpoint.restore import restore_network as jrestore
from deeplearning4j_tpu.checkpoint.restore import validate_like as jvalidate
from deeplearning4j_tpu.config import MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import preprocessors as jax_pp
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.scaleout.checkpoint import DefaultModelSaver as JDefault
from deeplearning4j_tpu.scaleout.checkpoint import load_checkpoint as jload
from deeplearning4j_tpu_torch.checkpoint import (AsyncCheckpointWriter,
                                                 CheckpointError,
                                                 CorruptShardError,
                                                 ShardedModelSaver,
                                                 convert, discover_latest,
                                                 is_sharded_checkpoint,
                                                 latest_step, leaf_summary,
                                                 list_steps, load_tree,
                                                 prune, read_manifest,
                                                 restore_network,
                                                 restore_params_for,
                                                 snapshot_tree, tree_scalars,
                                                 validate_like,
                                                 write_checkpoint)
from deeplearning4j_tpu_torch.checkpoint import format as ckfmt
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.guardian import all_finite
from deeplearning4j_tpu_torch.optimize.updater import UpdaterState
from deeplearning4j_tpu_torch.scaleout.checkpoint import (DefaultModelSaver,
                                                          OrbaxModelSaver,
                                                          UriModelSaver,
                                                          dump_payload,
                                                          load_checkpoint,
                                                          load_payload)
from deeplearning4j_tpu_torch.weights import multilayer_params_from_jax


# ------------------------------------------------------------ the stacks
def _mlp():
    return (JConf.builder().lr(0.1).use_adagrad(False).momentum(0.5)
            .n_in(20).activation_function("relu").num_iterations(1)
            .list(3).hidden_layer_sizes([16, 12])
            .override(2, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=5)
            .pretrain(False).build()), (20,)


def _lenet():
    return (JConf.builder().lr(0.05).activation_function("relu")
            .num_iterations(1).list(4)
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


def _attention():
    return (JConf.builder().lr(0.05).num_iterations(1).list(2)
            .override(0, layer="self_attention", n_in=8, n_out=16,
                      n_heads=2)
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_in=48, n_out=5)
            .input_preprocessor(0, jax_pp.ReshapePreProcessor([6, 8]))
            .input_preprocessor(1, jax_pp.ConvolutionPostProcessor())
            .pretrain(False).build()), (48,)


def _dbn():
    b = (JConf.builder().lr(0.1).n_in(12).activation_function("sigmoid")
         .optimization_algo("iteration_gradient_descent")
         .num_iterations(2).use_adagrad(True)
         .list(3).hidden_layer_sizes([8, 6]))
    for i in range(2):
        b = b.override(i, layer="rbm", k=1)
    return (b.override(2, layer="output", loss_function="mcxent",
                       activation_function="softmax", n_out=5)
            .pretrain(True).build()), (12,)


STACKS = {"mlp": _mlp, "lenet": _lenet, "attention": _attention,
          "dbn": _dbn}
META = {"epoch": 0, "epoch_batch": 2, "save_kind": "autosave",
        "guardian": {"skipped": 0, "lr_scale": 1.0, "last_score": None}}


def _data(feat, n=16, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, *feat)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
    return x, y


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flat(tree, prefix=""):
    """{path: numpy} of every array leaf of a params / updater tree."""
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in _flat(t, f"{prefix}/{k}").items()}
    return {prefix: _np(tree)}


def _same(got, ref):
    got, ref = _flat(got), _flat(ref)
    assert sorted(got) == sorted(ref)
    for path in ref:
        assert got[path].dtype == ref[path].dtype, path
        np.testing.assert_array_equal(got[path], ref[path], err_msg=path)


def _trained_pair(stack):
    """A JAX net and a port net of `stack`, each fitted on two batches
    from the same starting parameters (so each has updater state)."""
    conf, feat = STACKS[stack]()
    jnet = JNet(JMLC.from_json(conf.to_json()))
    net = MultiLayerNetwork.from_config_json(conf.to_json(), device="cpu")
    net.param_table = multilayer_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet._params), device="cpu")
    for seed in (1, 2):
        x, y = _data(feat, seed=seed)
        jnet.fit(x, y)
        net.fit(x, y)
    return jnet, net


# ------------------------------------------------ crossing the packages
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_sharded_step_crosses_between_the_packages(tmp_path, stack,
                                                   direction):
    jnet, net = _trained_pair(stack)
    root = str(tmp_path / "ckpt")
    if direction == "jax_to_port":
        with JSaver(root) as saver:
            saver.save(jnet, iterator_position=2, metadata=META, wait=True)
        src = jnet
        got, info = restore_network(root, device="cpu")
        _same(got.param_table, src._params)
        _same(got._updater_state, src._updater_state)
    else:
        with ShardedModelSaver(root) as saver:
            saver.save(net, iterator_position=2, metadata=META, wait=True)
        src = net
        got, info = jrestore(root)
        _same(got._params, src.param_table)
        _same(got._updater_state, src._updater_state)
    assert got._iteration_count == src._iteration_count == 2 * (
        2 if stack == "dbn" else 1)
    assert info["iterator_position"] == 2 and info["step"] == 2
    assert info["metadata"] == META
    assert is_sharded_checkpoint(root)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("stack", ["mlp", "dbn"])
def test_npz_checkpoint_crosses_between_the_packages(tmp_path, stack,
                                                     direction):
    jnet, net = _trained_pair(stack)
    path = str(tmp_path / "model.ckpt")
    if direction == "jax_to_port":
        JDefault(path, keep_old=False).save(jnet, iterator_position=3,
                                           metadata=META)
        got, info = load_checkpoint(path, device="cpu")
        _same(got.param_table, jnet._params)
        _same(got._updater_state, jnet._updater_state)
        src = jnet
    else:
        DefaultModelSaver(path, keep_old=False).save(
            net, iterator_position=3, metadata=META)
        got, info = jload(path)
        _same(got._params, net.param_table)
        _same(got._updater_state, net._updater_state)
        src = net
    assert got._iteration_count == src._iteration_count
    assert info["iterator_position"] == 3 and info["metadata"] == META


def test_load_checkpoint_of_a_directory_restores_the_sharded_step(tmp_path):
    _, net = _trained_pair("mlp")
    root = str(tmp_path / "ckpt")
    with ShardedModelSaver(root) as saver:
        saver.save(net, iterator_position=4, wait=True)
    got, info = load_checkpoint(root, device="cpu")
    _same(got.param_table, net.param_table)
    assert info["step"] == 4


def _bits(seed=0, shape=(3, 5)):
    return np.random.default_rng(seed).integers(
        0, 1 << 16, size=shape, dtype=np.uint16)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_bf16_leaf_crosses_bit_for_bit(tmp_path, direction):
    """Raw bf16 bits (NaN and inf patterns included) through the sharded
    format and the npz codec, written by one package, read by the
    other."""
    import ml_dtypes

    bits = _bits()
    bits[0, :3] = [0x7FC0, 0x7F80, 0xFF80]  # NaN, +inf, -inf
    jarr = jnp.asarray(bits.view(ml_dtypes.bfloat16))
    tarr = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    root = str(tmp_path)
    if direction == "jax_to_port":
        jfmt.write_checkpoint(root, 1, {"w": jarr})
        back, manifest = load_tree(root)
        assert back["w"].dtype == torch.bfloat16
        assert manifest["leaves"]["w"]["dtype"] == "bfloat16"
        blob = load_payload(_jax_dump({"w": jarr}))
        assert blob["w"].dtype.itemsize == 2
        np.testing.assert_array_equal(_np(back["w"]), bits)
        np.testing.assert_array_equal(blob["w"].view(np.uint16), bits)
    else:
        write_checkpoint(root, 1, {"w": tarr})
        back, manifest = jfmt.load_tree(root)
        assert back["w"].dtype.name == "bfloat16"
        np.testing.assert_array_equal(_np(back["w"]), bits)
        from deeplearning4j_tpu.scaleout.checkpoint import load_payload as jl
        blob = jl(dump_payload({"w": tarr}))
        np.testing.assert_array_equal(blob["w"].view(np.uint16), bits)


def _jax_dump(payload) -> bytes:
    from deeplearning4j_tpu.scaleout.checkpoint import dump_payload as jd
    return jd(payload)


def test_npz_bf16_tensor_round_trips_in_the_port(tmp_path):
    from deeplearning4j_tpu_torch.scaleout.checkpoint import to_tensor

    bits = _bits(3)
    t = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    back = to_tensor(load_payload(dump_payload({"w": t}))["w"])
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))


# ------------------------------------------------ refusing bad steps
def _payload():
    return {
        "params": {"0": {"W": torch.arange(12, dtype=torch.float32
                                           ).reshape(3, 4),
                         "b": torch.ones((1, 4), dtype=torch.bfloat16)}},
        "updater_state": {"0": UpdaterState(
            hist=torch.zeros(3), velocity=torch.ones(3),
            iteration=torch.tensor(5, dtype=torch.int32))},
        "cursor": 7,
        "none": None,
        "mixed": (1, [2.5, "tag"], {"k": True}),
    }


def test_round_trip_preserves_tree_and_dtypes(tmp_path):
    root = str(tmp_path)
    write_checkpoint(root, 3, snapshot_tree(_payload()))
    back, manifest = load_tree(root)
    assert manifest["step"] == 3
    _same(back["params"], _payload()["params"])
    assert isinstance(back["updater_state"]["0"], UpdaterState)
    assert back["updater_state"]["0"].iteration.dtype == torch.int32
    assert back["cursor"] == 7 and back["none"] is None
    assert back["mixed"] == (1, [2.5, "tag"], {"k": True})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_flipped_byte_is_refused_by_both_packages(tmp_path, writer):
    root = str(tmp_path)
    payload = {"params": {"0": {"W": np.arange(12, dtype=np.float32)
                                .reshape(3, 4)}}}
    path = (write_checkpoint if writer == "port"
            else jfmt.write_checkpoint)(root, 2, payload)
    victim = [f for f in os.listdir(path) if f.startswith("params__0__W")][0]
    with open(os.path.join(path, victim), "r+b") as f:
        f.seek(-5, os.SEEK_END)
        byte = f.read(1)
        f.seek(-5, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0x10]))
    with pytest.raises(CorruptShardError, match="params/0/W.*crc32"):
        load_tree(root)
    with pytest.raises(jfmt.CorruptShardError, match="params/0/W.*crc32"):
        jfmt.load_tree(root)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_an_uncommitted_step_is_invisible_to_both_packages(tmp_path,
                                                           writer):
    root = str(tmp_path)
    write = write_checkpoint if writer == "port" else jfmt.write_checkpoint
    write(root, 1, {"cursor": 1, "w": np.ones(3, np.float32)})
    path = write(root, 2, {"cursor": 2, "w": np.ones(3, np.float32)})
    os.remove(os.path.join(path, ckfmt.MARKER))
    for fmt in (ckfmt, jfmt):
        assert fmt.list_steps(root) == [1]
        assert fmt.load_tree(root)[0]["cursor"] == 1
        with pytest.raises(FileNotFoundError, match="never committed"):
            fmt.load_tree(root, 2)


def test_a_root_of_torn_steps_names_them(tmp_path):
    root = str(tmp_path)
    os.makedirs(os.path.join(root, ckfmt.step_dir_name(4)))
    with pytest.raises(CheckpointError, match="step_0000000004"):
        discover_latest(root)
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    with pytest.raises(CheckpointError, match="no sharded checkpoint"):
        discover_latest(empty)
    assert not is_sharded_checkpoint(empty)


def test_prune_keeps_newest_and_clears_torn_dirs(tmp_path):
    root = str(tmp_path)
    for step in (1, 2, 3):
        write_checkpoint(root, step, snapshot_tree(_payload()))
    os.makedirs(os.path.join(root, ckfmt.step_dir_name(9)))  # torn
    assert prune(root, keep=2) == [1, 9]
    assert list_steps(root) == [2, 3]


def test_recommitting_an_existing_step_stays_loadable(tmp_path):
    root = str(tmp_path)
    with AsyncCheckpointWriter(root) as w:
        w.save(_payload(), step=5)
        w.flush()
        p2 = dict(_payload())
        p2["cursor"] = 99
        w.save(p2, step=5)
        w.flush()
    assert load_tree(root, 5)[0]["cursor"] == 99


#: the files of one _payload() step, in the order they are written
_FILES = ["params__0__W.s00.npy", "params__0__b.s00.npy",
          "updater_state__0__hist.s00.npy",
          "updater_state__0__velocity.s00.npy",
          "updater_state__0__iteration.s00.npy", ckfmt.MANIFEST, ckfmt.MARKER]


@pytest.mark.parametrize("crash_before", _FILES)
def test_a_crash_before_any_file_leaves_the_last_committed_step(
        tmp_path, crash_before):
    root = str(tmp_path)
    w = AsyncCheckpointWriter(root)
    w.save(_payload(), step=1)
    w.flush()
    seen = []

    def bomb(fname):
        seen.append(fname)
        if fname == crash_before:
            raise OSError("disk died")

    w.between_files = bomb
    w.save(_payload(), step=2)
    with pytest.raises(RuntimeError, match="disk died"):
        w.flush()
    assert seen == _FILES[:_FILES.index(crash_before) + 1]
    assert list_steps(root) == [1] and jfmt.list_steps(root) == [1]
    assert load_tree(root)[1]["step"] == 1
    # the next save garbage-collects the torn directory
    w.between_files = None
    w.save(_payload(), step=3)
    w.flush()
    w.close()
    assert list_steps(root) == [1, 3]
    assert not os.path.exists(os.path.join(root, ckfmt.step_dir_name(2)))


# ------------------------------------------------------- the async writer
def test_save_returns_while_the_write_is_in_flight(tmp_path):
    root = str(tmp_path)
    w = AsyncCheckpointWriter(root, max_in_flight=2)
    gate = threading.Event()
    w.between_files = lambda fname: gate.wait(timeout=30)
    w.save(_payload(), step=1)
    assert latest_step(root) is None and w.in_flight == 1
    gate.set()
    w.flush()
    assert latest_step(root) == 1 and w.in_flight == 0
    assert w.stats()["saves"] == 1 and w.stats()["bytes_last"] > 0
    w.close()


def test_in_flight_saves_are_bounded(tmp_path):
    """max_in_flight=1: with one save inside the worker and one waiting
    behind it, a third save() blocks, before its snapshot, until the
    worker is released; its record holds the wait."""
    root = str(tmp_path)
    w = AsyncCheckpointWriter(root, max_in_flight=1)
    gate, entered = threading.Event(), threading.Event()

    def gated(fname):
        entered.set()
        gate.wait(timeout=30)

    w.between_files = gated
    w.save(_payload(), step=1)
    assert entered.wait(timeout=30)
    w.save(_payload(), step=2)  # takes the one queue slot
    third = threading.Event()
    t = threading.Thread(target=lambda: (w.save(_payload(), step=3),
                                         third.set()), daemon=True)
    t.start()
    time.sleep(0.2)
    assert not third.is_set(), "the third save must block on the queue"
    gate.set()
    t.join(timeout=30)
    w.flush()
    assert list_steps(root) == [1, 2, 3]
    stats = w.stats()
    assert stats["max_in_flight"] == 2
    waits = {h["step"]: h["wait_s"] for h in stats["history"]}
    assert waits[3] >= 0.2 and waits[1] < 0.2
    for h in stats["history"]:
        assert h["snapshot_s"] >= 0 and h["alloc_s"] == 0  # CPU: no pins
        assert h["write_s"] > 0 and h["bytes"] > 0
    w.close()


def test_the_pinned_pool_hands_back_what_it_was_given():
    from deeplearning4j_tpu_torch.checkpoint.writer import _PinnedPool

    pool = _PinnedPool()
    a, b = torch.zeros(3, 2), torch.zeros(3, 2, dtype=torch.bfloat16)
    assert pool.take((3, 2), torch.float32) is None
    pool.give([a, b])
    assert pool.take((3, 2), torch.float32) is a
    assert pool.take((3, 2), torch.float32) is None
    assert pool.take((2, 3), torch.bfloat16) is None
    assert pool.take((3, 2), torch.bfloat16) is b


def test_mesh_spec_of_and_the_manifest_mesh_match_jax(tmp_path):
    from deeplearning4j_tpu.checkpoint.writer import mesh_spec_of as jspec
    from deeplearning4j_tpu_torch.checkpoint import mesh_spec_of

    class Mesh:  # the attributes both read off a jax Mesh
        axis_names = ("dp", "tp")
        devices = np.empty((2, 4), dtype=object)

    for mesh, strategy in ((Mesh(), "zero1"), (Mesh(), None),
                           (None, "dp"), (None, None)):
        assert mesh_spec_of(mesh, strategy) == jspec(mesh, strategy)
    spec = mesh_spec_of(Mesh(), "zero1")
    assert spec == {"axes": {"dp": 2, "tp": 4}, "n_devices": 8,
                    "strategy": "zero1"}
    root = str(tmp_path)
    with AsyncCheckpointWriter(root) as w:
        w.save(_payload(), step=2, mesh_spec=spec)
    assert read_manifest(root)["mesh"] == spec
    assert jfmt.read_manifest(root)["mesh"] == spec


def test_a_writer_error_is_raised_by_the_next_call(tmp_path):
    root = str(tmp_path)
    w = AsyncCheckpointWriter(root)

    def bomb(fname):
        raise OSError("no space left")

    w.between_files = bomb
    w.save(_payload(), step=1)
    while w.in_flight:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="no space left"):
        w.save(_payload(), step=2)
    w.between_files = None
    w.save(_payload(), step=3)  # the error was reported once
    w.close()
    assert list_steps(root) == [3]


def test_auto_step_continues_from_disk(tmp_path):
    root = str(tmp_path)
    with AsyncCheckpointWriter(root) as w:
        w.save(_payload(), step=4)
    with AsyncCheckpointWriter(root) as w2:
        assert w2.save(_payload(), wait=True).endswith(
            ckfmt.step_dir_name(5))
    assert latest_step(root) == 5


def test_rotation_keeps_the_newest(tmp_path):
    root = str(tmp_path)
    with AsyncCheckpointWriter(root, keep=2) as w:
        for step in range(5):
            w.save(_payload(), step=step)
    assert list_steps(root) == [3, 4]
    with pytest.raises(ValueError):
        AsyncCheckpointWriter(root, max_in_flight=0)
    with pytest.raises(ValueError):
        AsyncCheckpointWriter(root, keep=0)


def test_a_snapshot_is_a_copy_of_the_live_tensors():
    live = {"w": torch.ones(4), "b": torch.ones(2, dtype=torch.bfloat16)}
    host = snapshot_tree(live)
    live["w"].add_(1)
    live["b"].add_(1)
    np.testing.assert_array_equal(host["w"], np.ones(4, np.float32))
    assert host["b"].dtype == "bfloat16"
    np.testing.assert_array_equal(host["b"].shards[0].data,
                                  _np(torch.ones(2, dtype=torch.bfloat16)))


# ------------------------------------------------------------- the codec
def test_v1_pickle_streams_are_refused_as_by_jax(tmp_path):
    path = str(tmp_path / "v1.ckpt")
    with open(path, "wb") as f:
        pickle.dump({"params": [1.0]}, f, protocol=4)
    with pytest.raises(ValueError) as ours:
        load_checkpoint(path, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jload(path)
    assert str(ours.value) == str(theirs.value)
    assert "pickle" in str(ours.value)


def test_the_codec_refuses_what_it_cannot_store(tmp_path):
    with pytest.raises(TypeError, match="object-dtype"):
        dump_payload({"x": np.array([object()])})
    with pytest.raises(TypeError, match="bad/obj"):
        write_checkpoint(str(tmp_path), 0, {"bad": {"obj": object()}})

    class Stranger(tuple):
        _fields = ("a",)

    with pytest.raises(TypeError, match="Unregistered NamedTuple"):
        dump_payload({"s": Stranger((1,))})
    with pytest.raises(TypeError, match="keys must be str"):
        dump_payload({1: 2})


def test_default_saver_timestamp_renames_the_prior_file(tmp_path):
    _, net = _trained_pair("mlp")
    path = str(tmp_path / "m.ckpt")
    saver = DefaultModelSaver(path)
    saver.save(net)
    time.sleep(0.002)
    saver.save(net, iterator_position=1)
    assert len([f for f in os.listdir(tmp_path)
                if f.startswith("m.ckpt.")]) == 1
    assert load_checkpoint(path, device="cpu")[1]["iterator_position"] == 1
    uri = UriModelSaver("gs://bucket/run/m.ckpt",
                        mounts={"gs": str(tmp_path / "mnt")})
    assert uri.path == str(tmp_path / "mnt" / "bucket/run/m.ckpt")
    with pytest.raises(ValueError, match="mount point"):
        UriModelSaver("s3://b/m.ckpt", mounts={})


def test_inspect_reads_only_the_manifest_as_jax_does(tmp_path):
    root = str(tmp_path)
    write_checkpoint(root, 6, snapshot_tree(_payload()))
    manifest = read_manifest(root)
    assert tree_scalars(manifest) == jfmt.tree_scalars(manifest)
    assert leaf_summary(manifest) == jfmt.leaf_summary(manifest)
    assert {r["leaf"]: r["bytes"] for r in leaf_summary(manifest)}[
        "params/0/b"] == 8


# --------------------------------------------------------------- helpers
def _table(n_layers=12, seed=0):
    rng = np.random.default_rng(seed)
    return {str(i): {"W": rng.normal(size=(3, 2)).astype(np.float32),
                     "b": rng.normal(size=(1, 2)).astype(np.float32)}
            for i in range(n_layers)}


def test_state_conversion_matches_jax_at_12_layers():
    """At 12 layers the sorted order puts '10' and '11' before '2': the
    slices, the flat vectors and the per-layer tree equal the JAX
    package's, and a round trip is bit-exact."""
    params = _table()
    n = sum(a.size for t in params.values() for a in t.values())
    rng = np.random.default_rng(5)
    hist = rng.normal(size=n).astype(np.float32)
    vel = rng.normal(size=n + 3).astype(np.float32)  # padded
    tparams = {k: {m: torch.from_numpy(a) for m, a in t.items()}
               for k, t in params.items()}
    assert convert.layer_slices(tparams) == jconvert.layer_slices(params)
    assert list(convert.layer_slices(tparams))[:4] == ["0", "1", "10", "11"]
    state = convert.flat_to_updater_state(hist, torch.from_numpy(vel),
                                          np.int32(7), tparams)
    jstate = jconvert.flat_to_updater_state(hist, vel, np.int32(7), params)
    _same(state, jstate)
    back = convert.updater_state_to_flat(state, tparams)
    jback = jconvert.updater_state_to_flat(jstate, params)
    for got, ref in zip(back, jback):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(back[0], hist)
    np.testing.assert_array_equal(back[1], vel[:n])
    with pytest.raises(ValueError, match="architecture"):
        convert.flat_to_updater_state(hist[:5], vel, 0, tparams)


@pytest.mark.parametrize("fault", ["shape", "dtype", "missing"])
def test_validate_like_names_the_leaf_as_jax_does(fault):
    ref = {"0": {"W": np.zeros((3, 2), np.float32),
                 "b": np.zeros((1, 2), np.float32)}}
    got = {"0": {"W": np.zeros((3, 2), np.float32),
                 "b": np.zeros((1, 2), np.float32)}}
    if fault == "shape":
        got["0"]["W"] = np.zeros((2, 3), np.float32)
    elif fault == "dtype":
        got["0"]["b"] = np.zeros((1, 2), np.float64)
    else:
        del got["0"]["b"]
    with pytest.raises(ValueError) as ours:
        validate_like(got, ref, context="reload")
    with pytest.raises(ValueError) as theirs:
        jvalidate(got, ref, context="reload")
    assert str(ours.value) == str(theirs.value)
    # tensors name their dtype the same way
    tgot = {k: {m: torch.from_numpy(a) for m, a in t.items()}
            for k, t in got.items()}
    with pytest.raises(ValueError, match="reload: .*0/"):
        validate_like(tgot, ref, context="reload")
    validate_like(ref, ref)


@pytest.mark.parametrize("what", ["orbax", "restore_params_for",
                                  "all_finite_axis_name"])
def test_what_is_not_ported_refuses_naming_the_roadmap(tmp_path, what):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        if what == "orbax":
            OrbaxModelSaver(str(tmp_path))
        elif what == "restore_params_for":
            restore_params_for(str(tmp_path), None)
        else:
            all_finite(torch.tensor(1.0), axis_name="dp")


# ----------------------------------------------------------------- card
@pytest.mark.cuda
def test_a_step_written_on_the_card_restores_on_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from deeplearning4j_tpu_torch.config import NeuralNetConfiguration

    conf = (NeuralNetConfiguration.builder().lr(0.1).n_in(20)
            .activation_function("relu").num_iterations(1)
            .list(2).hidden_layer_sizes([16])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=5)
            .pretrain(False).build())
    net = MultiLayerNetwork(conf, device="cuda")
    net.fit(*_data((20,)))
    root = str(tmp_path)
    with ShardedModelSaver(root) as saver:
        saver.save(net, iterator_position=1)
    got, _ = restore_network(root, device="cpu")
    _same(got.param_table, net.param_table)
    _same(got._updater_state, net._updater_state)


@pytest.mark.cuda
def test_the_writer_reuses_its_pinned_buffers_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    live = {"w": torch.arange(12.0, device="cuda").reshape(3, 4),
            "b": torch.ones(5, device="cuda", dtype=torch.bfloat16)}
    root = str(tmp_path)
    with AsyncCheckpointWriter(root, max_in_flight=1) as w:
        for step in range(4):
            live["w"].add_(1)
            w.save(live, step=step)
            w.flush()
        history = w.stats()["history"]
    assert history[0]["alloc_s"] > 0
    assert [h["alloc_s"] for h in history[1:]] == [0.0, 0.0, 0.0]
    got = load_tree(root, 3)[0]
    _same(got["w"], live["w"].cpu())
    _same(got["b"], live["b"].cpu())

