"""The PyTorch port's multi-process bootstrap (deeplearning4j_tpu_torch/
parallel/multihost.py), JAX's tests/test_multihost.py cases on the port:
two separately started `python -m` processes join one torch.distributed
job through `multihost.initialize` and train data-parallel on Iris over
gloo to identical params, equal to the port's single-process fit and to
the JAX DataParallelTrainer; a dead coordinator fails fast and names
itself; the probe finds a live port.

Tolerances as JAX's: the two processes' params rtol 1e-6; against the
single-process fits rtol 1e-4, atol 1e-6.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from deeplearning4j_tpu.config import NeuralNetConfiguration
from deeplearning4j_tpu.datasets import ListDataSetIterator as JListIter
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iris import load_iris
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import DataParallelTrainer as JDP
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.testing.ranks import free_port

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import sys

import numpy as np
import torch

torch.set_num_threads(1)
proc_id, nprocs, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4])

from deeplearning4j_tpu_torch.parallel import multihost

multihost.initialize(f"127.0.0.1:{port}", nprocs, proc_id, timeout=60)
info = multihost.process_info()
assert info["process_count"] == nprocs, info
assert info["process_index"] == proc_id, info
assert info["global_devices"] == nprocs, info

from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.parallel import DataParallelTrainer

with open(f"{outdir}/conf.json") as fh:
    net = MultiLayerNetwork.from_config_json(fh.read(), device="cpu")
net.set_parameters(np.load(f"{outdir}/p0.npy"))
data = np.load(f"{outdir}/iris.npz")
x, y = data["x"], data["y"]
mesh = multihost.global_data_mesh(device="cpu")
trainer = DataParallelTrainer(net, mesh)
trainer.fit(ListDataSetIterator(DataSet(x, y), batch_size=48), epochs=3)
np.save(f"{outdir}/params_{proc_id}.npy", net.params().numpy())
multihost.shutdown()
print(f"proc {proc_id} done, score={net.score(x, y):.4f}", flush=True)
"""


def _iris_conf():
    return (NeuralNetConfiguration.builder()
            .lr(0.1).n_in(4).activation_function("tanh")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(1).use_adagrad(False)
            .list(2).hidden_layer_sizes([8])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=3)
            .pretrain(False).build())


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    """Start two `python -m` worker processes against one coordinator
    port, kill both on any failure (a dead worker leaves its peer in the
    rendezvous), and return (p0, x, y, params_0, params_1)."""
    tmp = tmp_path_factory.mktemp("multihost")
    (tmp / "mh_worker.py").write_text(WORKER)
    conf = _iris_conf()
    (tmp / "conf.json").write_text(conf.to_json())
    p0 = np.asarray(JNet(conf).params())
    np.save(tmp / "p0.npy", p0)
    x, y = load_iris()
    x, y = np.asarray(x, np.float32)[:144], np.asarray(y, np.float32)[:144]
    np.savez(tmp / "iris.npz", x=x, y=y)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO_ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mh_worker", str(i), "2", str(port),
         str(tmp)], cwd=str(tmp), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out.decode())
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return (conf, p0, x, y, np.load(tmp / "params_0.npy"),
            np.load(tmp / "params_1.npy"))


def test_two_process_data_parallel_training(two_process_run):
    _, p0, _, _, a, b = two_process_run
    # the gradient all-reduce keeps both processes' params identical
    np.testing.assert_allclose(a, b, rtol=1e-6)
    # and training moved them
    assert np.abs(a - p0).max() > 0


def test_two_process_matches_single_process(two_process_run):
    """The two-process job changes where the bytes move, not the math:
    equal to the port's single-process fit over the same batches and to
    the JAX DataParallelTrainer on its 8-device mesh."""
    conf, p0, x, y, a, _ = two_process_run
    net = MultiLayerNetwork.from_config_json(conf.to_json(), device="cpu")
    net.set_parameters(p0)
    net.fit(ListDataSetIterator(DataSet(x, y), batch_size=48), epochs=3)
    np.testing.assert_allclose(a, net.params().numpy(), rtol=1e-4,
                               atol=1e-6)
    jnet = JNet(conf)
    jnet.set_parameters(p0)
    JDP(jnet, jmake_mesh({"data": 8})).fit(
        JListIter(JDataSet(x, y), batch_size=48), epochs=3)
    np.testing.assert_allclose(a, np.asarray(jnet.params()), rtol=1e-4,
                               atol=1e-6)


def test_initialize_fails_fast_against_dead_coordinator():
    """A dead coordinator is a bounded, catchable error naming the
    address and the attempt count; the probe raises before any
    process group is touched."""
    t0 = time.time()
    with pytest.raises(RuntimeError) as exc:
        # nothing listens on port 9; two bounded attempts then raise
        multihost.initialize("127.0.0.1:9", 2, 1, timeout=0.5, retries=1,
                             backoff=0.2)
    msg = str(exc.value)
    assert "127.0.0.1:9" in msg, f"error must name the coordinator: {msg}"
    assert "2 attempt" in msg, f"error must count attempts: {msg}"
    assert time.time() - t0 < 30, "did not fail fast"


def test_initialize_probe_finds_live_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    s.listen(1)
    try:
        multihost._wait_for_coordinator(f"127.0.0.1:{s.getsockname()[1]}",
                                        1, 2, timeout=2.0, retries=0,
                                        backoff=0.1)
    finally:
        s.close()


def test_local_batch_slice_and_bad_address():
    assert multihost.local_batch_slice(12, 1, 3) == slice(4, 8)
    with pytest.raises(ValueError, match="not divisible"):
        multihost.local_batch_slice(10, 0, 3)
    with pytest.raises(ValueError, match="host:port"):
        multihost.initialize("nohost", 2, 1, timeout=0.1)


def test_rank_group_limit_kills_a_hung_group():
    """The launcher's hard limit: a group whose rank never returns is
    killed at the limit and raises, so no multi-rank test can hang."""
    from deeplearning4j_tpu_torch.testing.ranks import RankError, run_ranks

    def body(rank):
        if rank == 1:
            time.sleep(600)
        return rank

    t0 = time.time()
    with pytest.raises(RankError, match="overran its 3 s limit"):
        run_ranks(body, 2, timeout=3)
    assert time.time() - t0 < 30


def test_a_failing_rank_fails_the_group_with_its_traceback():
    from deeplearning4j_tpu_torch.testing.ranks import RankError, run_ranks

    def body(rank):
        if rank == 2:
            raise KeyError("rank two's fault")
        return rank

    with pytest.raises(RankError, match="rank 2 failed") as exc:
        run_ranks(body, 3, timeout=60)
    assert "rank two's fault" in str(exc.value)
    assert run_ranks(lambda r: r * r, 3, timeout=60) == [0, 1, 4]


def test_no_rank_leaves_while_a_peer_still_needs_it():
    """A rank done first waits for its peers before it exits: rank 0
    (which serves the job's store) returns at once, the others read the
    store a second later. Without the launcher's closing barrier rank 0
    is gone by then, as a fast rank was gone while a slow peer still
    connected a group's mesh under load."""
    from deeplearning4j_tpu_torch.testing.ranks import run_ranks

    def body(rank):
        import torch.distributed as dist

        store = dist.distributed_c10d._get_default_store()
        if rank == 0:
            store.set("k", "v")
            return "first"
        time.sleep(1.0)
        return store.get("k").decode()

    assert run_ranks(body, 3, timeout=60) == ["first", "v", "v"]
