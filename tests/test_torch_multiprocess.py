"""The PyTorch port's cross-process control plane (deeplearning4j_tpu_torch/
scaleout/rpc.py, registry.py, launcher.py) held against the JAX
package's, on the CPU.

The cases of tests/test_multiprocess.py run on the port: the tracker RPC,
the config registry, the URI saver, and real worker processes
(`python -m deeplearning4j_tpu_torch.scaleout.launcher worker`) whose
performer conf says `"device": "cpu"`. The JAX Orbax tier has no port
(orbax is built on jax): its two cases hold the sharded tier, which
takes its place, to the same contract.

Interop: the wire is the checkpoint codec both packages share, so a JAX
`RemoteStateTracker` works a port `StateTrackerServer` and the other way
round, DataSet jobs and packed updates included. A run config naming a
JAX performer is refused by a port worker with the counterpart named.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.datasets.iris import load_iris
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.scaleout.api import CollectionJobIterator, Job
from deeplearning4j_tpu_torch.scaleout.checkpoint import (UriModelSaver,
                                                          load_checkpoint)
from deeplearning4j_tpu_torch.scaleout.launcher import MultiProcessMaster
from deeplearning4j_tpu_torch.scaleout.registry import ConfigRegistry
from deeplearning4j_tpu_torch.scaleout.rpc import (RemoteStateTracker,
                                                   StateTrackerServer)
from deeplearning4j_tpu_torch.scaleout.statetracker import \
    InMemoryStateTracker

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERFORMER = "deeplearning4j_tpu_torch.scaleout.perform.NeuralNetWorkPerformer"
WORKER_LIMIT = 120  # seconds a launched worker may take to finish


def iris_conf_json(iters=5):
    return (NeuralNetConfiguration.builder()
            .lr(0.1).n_in(4).activation_function("tanh")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(iters).use_adagrad(False)
            .list(2).hidden_layer_sizes([8])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=3)
            .pretrain(False).build().to_json())


def _env():
    return dict(os.environ,
                PYTHONPATH=REPO_ROOT + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def _launch(registry_root, run, worker_id, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.scaleout.launcher",
         "worker", "--registry", registry_root, "--run", run,
         "--worker-id", worker_id, *extra],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


class TestTrackerRpc:
    def setup_method(self):
        self.tracker = InMemoryStateTracker()
        self.server = StateTrackerServer(self.tracker).start()
        self.client = RemoteStateTracker(self.server.address)

    def teardown_method(self):
        self.client.close()
        self.server.stop()

    def test_worker_registry_round_trip(self):
        self.client.add_worker("w0")
        assert self.tracker.workers() == ["w0"]
        self.client.heartbeat("w0")
        assert "w0" in self.client.workers()

    def test_job_with_dataset_crosses_the_wire(self):
        ds = DataSet(np.arange(6, dtype=np.float32).reshape(2, 3),
                     np.eye(2, dtype=np.float32))
        self.tracker.add_job(Job(work=ds, worker_id="w0"))
        job = self.client.job_for("w0")
        assert isinstance(job, Job)
        np.testing.assert_array_equal(job.work.features, ds.features)
        np.testing.assert_array_equal(job.work.labels, ds.labels)

    def test_update_and_current_model(self):
        update = np.linspace(0, 1, 7, dtype=np.float32)
        self.client.add_update("w0", update)
        assert self.tracker.worker_updates() == ["w0"]
        np.testing.assert_allclose(self.tracker.load_update("w0"), update)
        self.tracker.set_current(update * 2)
        np.testing.assert_allclose(self.client.get_current(), update * 2)

    def test_counters_and_done(self):
        self.client.increment("words", 5.0)
        self.client.increment("words", 2.5)
        assert self.client.count("words") == 7.5
        assert not self.client.is_done()
        self.client.finish()
        assert self.tracker.is_done()

    def test_disallowed_method_rejected(self):
        with pytest.raises(RuntimeError, match="not allowed"):
            self.client._call("shutdown")


class TestTrackerInterop:
    """One package's client against the other's server."""

    def _exercise(self, tracker, client, job_cls, ds_cls):
        client.add_worker("w0")
        assert tracker.workers() == ["w0"]
        ds = ds_cls(np.arange(6, dtype=np.float32).reshape(2, 3),
                    np.eye(2, dtype=np.float32))
        tracker.add_job(job_cls(work=ds, worker_id="w0", seq=5))
        job = client.job_for("w0")
        assert job.seq == 5 and job.worker_id == "w0"
        np.testing.assert_array_equal(job.work.features, ds.features)
        np.testing.assert_array_equal(job.work.labels, ds.labels)
        update = np.linspace(0, 1, 9, dtype=np.float32)
        client.add_update("w0", update)
        np.testing.assert_array_equal(tracker.load_update("w0"), update)
        client.clear_job("w0")
        assert tracker.jobs() == []
        client.increment("k", 2.0)
        assert tracker.count("k") == 2.0
        tracker.set_current(update * 3)
        np.testing.assert_array_equal(client.get_current(), update * 3)
        with pytest.raises(RuntimeError, match="not allowed"):
            client._call("shutdown")
        client.finish()
        assert tracker.is_done()

    def test_jax_client_works_a_port_server(self):
        from deeplearning4j_tpu.scaleout.rpc import \
            RemoteStateTracker as JClient

        tracker = InMemoryStateTracker()
        server = StateTrackerServer(tracker).start()
        client = JClient(server.address)
        try:
            self._exercise(tracker, client, Job, DataSet)
        finally:
            client.close()
            server.stop()

    def test_port_client_works_a_jax_server(self):
        from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
        from deeplearning4j_tpu.scaleout.api import Job as JJob
        from deeplearning4j_tpu.scaleout.rpc import \
            StateTrackerServer as JServer
        from deeplearning4j_tpu.scaleout.statetracker import \
            InMemoryStateTracker as JTracker

        tracker = JTracker()
        server = JServer(tracker).start()
        client = RemoteStateTracker(server.address)
        try:
            self._exercise(tracker, client, JJob, JDataSet)
        finally:
            client.close()
            server.stop()

    def test_allowed_methods_and_frames_are_jaxs(self):
        from deeplearning4j_tpu.scaleout import rpc as jrpc
        from deeplearning4j_tpu_torch.scaleout import rpc

        assert rpc.ALLOWED_METHODS == jrpc.ALLOWED_METHODS
        assert rpc.MAX_FRAME == jrpc.MAX_FRAME
        payload = {"method": "add_update",
                   "args": ["w", np.arange(4, dtype=np.float32)],
                   "client": "c", "seq": 3}
        from deeplearning4j_tpu.scaleout.checkpoint import \
            dump_payload as jdump
        from deeplearning4j_tpu_torch.scaleout.checkpoint import dump_payload
        assert dump_payload(rpc._to_wire(payload)) \
            == jdump(jrpc._to_wire(payload))


class TestConfigRegistry:
    def test_register_retrieve(self, tmp_path):
        reg = ConfigRegistry(str(tmp_path))
        reg.register("host-a", 1234, {"k": "v"})
        assert reg.retrieve("host-a", 1234) == {"k": "v"}
        with pytest.raises(KeyError):
            reg.retrieve("host-b", 1)
        assert len(reg.entries()) == 1
        reg.unregister("host-a", 1234)
        with pytest.raises(KeyError):
            reg.retrieve("host-a", 1234)

    def test_run_name_convenience(self, tmp_path):
        reg = ConfigRegistry(str(tmp_path))
        reg.register_run("exp1", {"tracker_address": "x:1"})
        assert reg.retrieve_run("exp1")["tracker_address"] == "x:1"

    def test_a_registry_of_either_package_reads_in_the_other(self,
                                                            tmp_path):
        from deeplearning4j_tpu.scaleout.registry import \
            ConfigRegistry as JRegistry

        ours, theirs = (ConfigRegistry(str(tmp_path)),
                        JRegistry(str(tmp_path)))
        ours.register_run("a", {"tracker_address": "h:1", "n": 2})
        theirs.register_run("b", {"tracker_address": "h:2"})
        assert theirs.retrieve_run("a") == {"tracker_address": "h:1",
                                            "n": 2}
        assert ours.retrieve_run("b") == {"tracker_address": "h:2"}
        assert [e["host"] for e in ours.entries()] \
            == [e["host"] for e in theirs.entries()]


class TestUriModelSaver:
    def test_file_scheme_and_bare_path(self, tmp_path):
        for uri in [str(tmp_path / "a.ckpt"),
                    f"file://{tmp_path}/b.ckpt"]:
            saver = UriModelSaver(uri)
            net = MultiLayerNetwork.from_config_json(iris_conf_json(),
                                                     device="cpu")
            path = saver.save(net)
            assert os.path.exists(path)
            net2, _ = load_checkpoint(path, device="cpu")
            np.testing.assert_allclose(net.params().numpy(),
                                       net2.params().numpy())

    def test_remote_scheme_via_mount(self, tmp_path):
        saver = UriModelSaver("gs://bucket/run1/model.ckpt",
                              mounts={"gs": str(tmp_path)})
        assert saver.path == str(tmp_path / "bucket" / "run1" / "model.ckpt")

    def test_remote_scheme_without_mount_fails(self, monkeypatch):
        monkeypatch.delenv("DL4J_TPU_ARTIFACT_ROOT", raising=False)
        with pytest.raises(ValueError, match="mount"):
            UriModelSaver("gs://bucket/model.ckpt")


class TestLauncher:
    def test_jax_performer_is_refused_naming_the_counterpart(self):
        from deeplearning4j_tpu_torch.scaleout.launcher import \
            _resolve_performer

        with pytest.raises(ValueError, match=PERFORMER.replace(".", r"\.")):
            _resolve_performer("deeplearning4j_tpu.scaleout.perform."
                               "NeuralNetWorkPerformer")
        with pytest.raises(ValueError, match="must live under"):
            _resolve_performer("os.system")
        assert _resolve_performer(PERFORMER).__name__ == \
            "NeuralNetWorkPerformer"

    def test_a_jax_argv_parses(self, monkeypatch):
        from deeplearning4j_tpu_torch.scaleout import launcher

        seen = {}
        monkeypatch.setattr(launcher, "run_worker",
                            lambda **kw: seen.update(kw) or 0)
        monkeypatch.setattr(
            "deeplearning4j_tpu_torch.parallel.multihost.initialize",
            lambda addr, num_processes, process_id: seen.update(
                coordinator=(addr, num_processes, process_id)))
        assert launcher.main(
            ["worker", "--registry", "r", "--run", "x", "--worker-id",
             "w", "--heartbeat-interval", "0.5",
             "--registration-timeout", "3",
             "--jax-coordinator", "127.0.0.1:1234",
             "--num-processes", "2", "--process-id", "1"]) == 0
        assert seen["coordinator"] == ("127.0.0.1:1234", 2, 1)
        assert seen["worker_id"] == "w" and seen["run_name"] == "x"
        assert seen["registration_timeout"] == 3.0


class TestTwoProcessTraining:
    def test_separately_launched_workers_train_to_checkpoint(self, tmp_path):
        """Two separately launched worker processes register, train on
        the CPU their performer conf names, and the averaged checkpoint
        lands via the saver."""
        x, y = load_iris()
        rng = np.random.RandomState(0)
        jobs = []
        for _ in range(8):
            idx = rng.choice(len(np.asarray(x)), 32, replace=False)
            jobs.append(DataSet(np.asarray(x)[idx], np.asarray(y)[idx]))

        registry_root = str(tmp_path / "registry")
        ckpt_uri = f"file://{tmp_path}/run/model.ckpt"
        conf_json = iris_conf_json()
        master = MultiProcessMaster(
            CollectionJobIterator(jobs),
            run_name="iris-2p",
            registry=ConfigRegistry(registry_root),
            performer_class=PERFORMER,
            performer_conf={"conf_json": conf_json, "epochs": 1,
                            "device": "cpu"},
            n_workers=2,
            conf_json=conf_json,
            model_saver=UriModelSaver(ckpt_uri, keep_old=False),
            save_every_waves=1,
        )
        procs = [_launch(registry_root, "iris-2p", f"proc-{i}")
                 for i in range(2)]
        try:
            final = master.run(timeout=120.0)
            for p in procs:
                out, _ = p.communicate(timeout=WORKER_LIMIT)
                assert p.returncode == 0, out.decode()
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()

        assert final is not None
        ckpt_path = str(tmp_path / "run" / "model.ckpt")
        assert os.path.exists(ckpt_path)
        net, info = load_checkpoint(ckpt_path, device="cpu")
        assert tuple(net.params().shape) == final.shape
        assert info["metadata"]["waves"] >= 1
        fresh = MultiLayerNetwork.from_config_json(conf_json, device="cpu")
        trained = MultiLayerNetwork.from_config_json(conf_json, params=final,
                                                     device="cpu")
        assert trained.score(x, y) < fresh.score(x, y)

    def test_a_worker_refuses_a_run_naming_a_jax_performer(self, tmp_path):
        registry_root = str(tmp_path / "registry")
        ConfigRegistry(registry_root).register_run("jaxrun", {
            "tracker_address": "127.0.0.1:1",
            "performer_class": ("deeplearning4j_tpu.scaleout.perform."
                                "NeuralNetWorkPerformer"),
            "performer_conf": {}})
        p = _launch(registry_root, "jaxrun", "w0")
        out, _ = p.communicate(timeout=WORKER_LIMIT)
        assert p.returncode != 0
        assert PERFORMER in out.decode()
        assert "No module named 'jax" not in out.decode()


class TestTwoProcessWorkRetriever:
    def test_payloads_ride_shared_work_dir(self, tmp_path):
        x, y = load_iris()
        rng = np.random.RandomState(0)
        jobs = [DataSet(np.asarray(x)[i], np.asarray(y)[i]) for i in
                (rng.choice(len(np.asarray(x)), 32, replace=False)
                 for _ in range(4))]

        registry_root = str(tmp_path / "registry")
        work_dir = str(tmp_path / "work")
        conf_json = iris_conf_json(iters=2)
        master = MultiProcessMaster(
            CollectionJobIterator(jobs),
            run_name="iris-wr",
            registry=ConfigRegistry(registry_root),
            performer_class=PERFORMER,
            performer_conf={"conf_json": conf_json, "epochs": 1,
                            "device": "cpu"},
            n_workers=1,
            conf_json=conf_json,
            work_dir=work_dir,
        )
        assert master.work_retriever is not None
        proc = _launch(registry_root, "iris-wr", "wr-proc")
        try:
            final = master.run(timeout=120.0)
            out, _ = proc.communicate(timeout=WORKER_LIMIT)
            assert proc.returncode == 0, out.decode()
        finally:
            if proc.poll() is None:
                proc.kill()
        assert final is not None
        assert os.listdir(work_dir) == []


class TestShardedTierInOrbaxsPlace:
    """The JAX Orbax tier's contract (full resume, step rotation) on the
    port's sharded tier; `OrbaxModelSaver` itself refuses."""

    def _trained_net(self):
        x, y = load_iris()
        net = MultiLayerNetwork.from_config_json(iris_conf_json(iters=3),
                                                 device="cpu")
        net.fit(x, y)
        return net, np.asarray(x), np.asarray(y)

    def test_save_restore_round_trip(self, tmp_path):
        from deeplearning4j_tpu_torch.checkpoint import (ShardedModelSaver,
                                                         restore_network)
        from deeplearning4j_tpu_torch.scaleout.checkpoint import \
            OrbaxModelSaver

        with pytest.raises(NotImplementedError, match="ShardedModelSaver"):
            OrbaxModelSaver(str(tmp_path / "orbax"))
        net, x, y = self._trained_net()
        with ShardedModelSaver(str(tmp_path / "ckpt")) as saver:
            saver.save(net, iterator_position=7, metadata={"run": "unit"})
        net2, info = restore_network(str(tmp_path / "ckpt"), device="cpu")
        np.testing.assert_allclose(net2.params().numpy(),
                                   net.params().numpy(), atol=1e-6)
        assert info["iterator_position"] == 7
        assert info["metadata"]["run"] == "unit"
        assert net2._updater_state is not None
        s_before = net2.score(x, y)
        net2.fit(x, y)
        assert net2.score(x, y) <= s_before + 1e-6

    def test_rotation_keeps_max_to_keep(self, tmp_path):
        from deeplearning4j_tpu_torch.checkpoint import ShardedModelSaver
        from deeplearning4j_tpu_torch.checkpoint.format import list_steps

        net, _, _ = self._trained_net()
        root = str(tmp_path / "ckpt")
        with ShardedModelSaver(root, keep=2) as saver:
            for i in range(4):
                saver.save(net, iterator_position=i)
        assert list_steps(root) == [2, 3]
