"""The PyTorch port's elastic supervisor (deeplearning4j_tpu_torch/scaleout/
supervisor.py, worker.py) held against the JAX package's, on the CPU.

The cases of tests/test_supervisor.py run on the port: its workers are
`python -m deeplearning4j_tpu_torch.scaleout.worker` processes whose
performer conf says `"device": "cpu"`; the chaos plans are the same
seeded schedules. The SIGKILL / SIGSTOP soaks carry @slow, as in the
JAX file. Every wait is bounded; nothing asserts a wall-clock bound of
the tier-1 drills (the run timeouts only stop a broken run).

Interop: the supervisor's checkpoint (a sharded step whose params leaf
is one shard per worker, its cursor, its source topology) written by
either package resumes on the other, and a supervisor journal written by
either package is adopted by the other.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.datasets.iris import load_iris
from deeplearning4j_tpu_torch.scaleout.api import CollectionJobIterator
from deeplearning4j_tpu_torch.scaleout.registry import ConfigRegistry
from deeplearning4j_tpu_torch.scaleout.supervisor import (
    DEAD, EVICTED, SupervisedWorker, TrainingSupervisor, WorkerSpawner,
    _ProgressListener)
from deeplearning4j_tpu_torch.testing import chaos
from deeplearning4j_tpu_torch.utils import procs

pytestmark = pytest.mark.elastic

PERFORMER = "deeplearning4j_tpu_torch.scaleout.perform.NeuralNetWorkPerformer"
JPERFORMER = "deeplearning4j_tpu.scaleout.perform.NeuralNetWorkPerformer"


def _conf_json(momentum=0.0, iters=2):
    return (NeuralNetConfiguration.builder()
            .lr(0.1).n_in(4).activation_function("tanh")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(iters).use_adagrad(False).momentum(momentum)
            .list(2).hidden_layer_sizes([8])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=3)
            .pretrain(False).build().to_json())


def _jobs(n=6, bs=24, seed=0):
    x, y = load_iris()
    x, y = np.asarray(x), np.asarray(y)
    rng = np.random.RandomState(seed)
    return [DataSet(x[i], y[i])
            for i in (rng.choice(len(x), bs, replace=False)
                      for _ in range(n))]


def _supervisor(tmp_path, tag, jobs, n_workers=2, env_for=None, **kw):
    cj = _conf_json()
    registry_root = str(tmp_path / f"reg_{tag}")
    kw.setdefault("heartbeat_timeout", 3.0)
    kw.setdefault("progress_timeout", 90.0)  # cold-start headroom
    return TrainingSupervisor(
        CollectionJobIterator(list(jobs)), run_name=tag,
        registry=ConfigRegistry(registry_root),
        performer_class=PERFORMER,
        performer_conf={"conf_json": cj, "epochs": 1, "device": "cpu"},
        n_workers=n_workers, conf_json=cj,
        spawner=WorkerSpawner(registry_root, tag, env_for=env_for),
        **kw)


def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read()


def _wait(pred, limit=10.0):
    deadline = time.time() + limit
    while not pred() and time.time() < deadline:
        time.sleep(0.01)
    return pred()


# ---------------------------------------------------------------- units
class TestWorkerSpawner:
    def test_command_names_entrypoint_and_worker(self, tmp_path):
        sp = WorkerSpawner(str(tmp_path), "run1")
        cmd = sp.command("w3")
        assert "deeplearning4j_tpu_torch.scaleout.worker" in cmd
        assert "w3" in cmd and "run1" in cmd

    def test_env_carries_package_root_and_per_worker_extras(self,
                                                           tmp_path):
        sp = WorkerSpawner(
            str(tmp_path), "run1", env={"PATH": os.environ["PATH"]},
            env_for=lambda wid: ({"X_DRILL": wid} if wid == "w1"
                                 else {}))
        import deeplearning4j_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(
            deeplearning4j_tpu_torch.__file__))
        assert pkg_root in sp.env["PYTHONPATH"].split(os.pathsep)
        assert sp.env_for("w1") == {"X_DRILL": "w1"}
        assert sp.env_for("w1r1") == {}
        # every fresh worker process picks the same cuBLAS kernels
        assert sp.env["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"

    def test_command_and_flags_are_jaxs_but_the_module(self, tmp_path):
        from deeplearning4j_tpu.scaleout.supervisor import \
            WorkerSpawner as JSpawner

        ours = WorkerSpawner(str(tmp_path), "r", reconnect_grace=7.0,
                             heartbeat_interval=0.5).command("w0")
        theirs = JSpawner(str(tmp_path), "r", reconnect_grace=7.0,
                          heartbeat_interval=0.5).command("w0")
        assert ours[2] == "deeplearning4j_tpu_torch.scaleout.worker"
        assert theirs[2] == "deeplearning4j_tpu.scaleout.worker"
        assert ours[3:] == theirs[3:]


class TestProgressListener:
    def test_lines_drive_alive_and_progress_eof_drives_gone(self):
        alive, progress, gone = [], [], []
        lst = _ProgressListener(alive.append,
                                lambda w, d: progress.append((w, d)),
                                gone.append, poll_s=0.05)
        try:
            s = socket.create_connection((lst.host, lst.port), timeout=5)
            s.sendall(b'{"worker_id": "wA"}\n')
            s.sendall(b'{"worker_id": "wA", "performed": 2, '
                      b'"job_s": 0.5}\n')
            _wait(lambda: len(progress) >= 2)
            assert ("wA", {"worker_id": "wA", "performed": 2,
                           "job_s": 0.5}) in progress
            assert "wA" in alive
            s.close()
            _wait(lambda: gone)
            assert gone == ["wA"]
        finally:
            lst.close()

    def test_open_but_silent_connection_keeps_liveness(self):
        alive, gone = [], []
        lst = _ProgressListener(alive.append, lambda w, d: None,
                                gone.append, poll_s=0.05)
        try:
            s = socket.create_connection((lst.host, lst.port), timeout=5)
            s.sendall(b'{"worker_id": "wB"}\n')
            _wait(lambda: alive.count("wB") >= 3)
            assert alive.count("wB") >= 3
            assert not gone
        finally:
            try:
                s.close()
            except OSError:
                pass
            lst.close()

    def test_drop_severs_an_evicted_workers_liveness(self):
        alive, gone = [], []
        lst = _ProgressListener(alive.append, lambda w, d: None,
                                gone.append, poll_s=0.05)
        try:
            s = socket.create_connection((lst.host, lst.port), timeout=5)
            s.sendall(b'{"worker_id": "wC"}\n')
            _wait(lambda: alive)
            lst.drop("wC")
            _wait(lambda: gone)
            assert gone == ["wC"]
        finally:
            lst.close()


class TestShardParamsReshard:
    def test_sharded_leaf_reassembles_on_any_topology(self, tmp_path):
        from deeplearning4j_tpu_torch.checkpoint import format as ckfmt
        from deeplearning4j_tpu_torch.checkpoint.restore import \
            load_payload_tree

        vec = np.arange(103, dtype=np.float32)
        leaf = TrainingSupervisor.shard_params(vec, 4)
        assert isinstance(leaf, ckfmt.HostLeaf)
        assert len(leaf.shards) == 4
        root = str(tmp_path / "ck")
        ckfmt.write_checkpoint(root, 7, {"params": leaf,
                                         "iterator_position": 7})
        payload, manifest = load_payload_tree(root, 7)
        np.testing.assert_array_equal(np.asarray(payload["params"]), vec)
        assert len(manifest["leaves"]["params"]["shards"]) == 4

    def test_single_worker_and_tiny_vectors_stay_plain(self):
        vec = np.arange(5, dtype=np.float32)
        assert isinstance(TrainingSupervisor.shard_params(vec, 1),
                          np.ndarray)
        assert isinstance(TrainingSupervisor.shard_params(vec, 8),
                          np.ndarray)

    def test_tree_checkpoint_packs_in_jax_ravel_order(self, tmp_path):
        """A tree checkpoint (layers "0", "1", "10", "2") is packed in
        the sorted-key order JAX's `ravel_pytree` gives."""
        from jax.flatten_util import ravel_pytree

        from deeplearning4j_tpu_torch.checkpoint import format as ckfmt

        rng = np.random.RandomState(0)
        tree = {str(i): {"W": rng.randn(2, 3).astype(np.float32),
                         "b": rng.randn(3).astype(np.float32)}
                for i in (0, 1, 2, 10)}
        root = str(tmp_path / "tree")
        ckfmt.write_checkpoint(root, 3, {"params": tree,
                                         "iterator_position": 3})
        sup = _supervisor(tmp_path, "tree", _jobs(4), resume=root)
        try:
            np.testing.assert_array_equal(
                sup.tracker.get_current(),
                np.asarray(ravel_pytree(tree)[0]))
            assert sup.resume_events[0]["cursor"] == 3
        finally:
            sup.close()


class TestDiscoverLatest:
    def test_latest_committed_step_is_found(self, tmp_path):
        from deeplearning4j_tpu_torch.checkpoint import format as ckfmt
        from deeplearning4j_tpu_torch.checkpoint.restore import \
            discover_latest

        root = str(tmp_path / "ck")
        ckfmt.write_checkpoint(root, 2, {"iterator_position": 2})
        ckfmt.write_checkpoint(root, 5, {"iterator_position": 5})
        assert discover_latest(root) == (root, 5)

    def test_torn_only_dir_error_lists_candidates(self, tmp_path):
        from deeplearning4j_tpu_torch.checkpoint import format as ckfmt
        from deeplearning4j_tpu_torch.checkpoint.restore import \
            discover_latest

        root = str(tmp_path / "ck")
        torn = os.path.join(root, ckfmt.step_dir_name(9))
        os.makedirs(torn)
        with open(os.path.join(torn, ckfmt.MANIFEST), "w") as f:
            f.write("{}")
        with pytest.raises(ckfmt.CheckpointError) as exc:
            discover_latest(root)
        assert "step_0000000009" in str(exc.value)
        assert "torn" in str(exc.value)

    def test_empty_root_has_distinct_error(self, tmp_path):
        from deeplearning4j_tpu_torch.checkpoint import format as ckfmt
        from deeplearning4j_tpu_torch.checkpoint.restore import \
            discover_latest

        with pytest.raises(ckfmt.CheckpointError, match="no sharded"):
            discover_latest(str(tmp_path / "empty"))


class TestStatusHealth:
    def test_healthz_flips_503_when_quorum_verdict_fails(self):
        from deeplearning4j_tpu_torch.scaleout.statetracker import \
            InMemoryStateTracker
        from deeplearning4j_tpu_torch.scaleout.status import StatusServer

        verdict = {"ok": True, "live_workers": 2, "min_workers": 2}
        server = StatusServer(InMemoryStateTracker(),
                              health=lambda: dict(verdict)).start()
        try:
            code, body = _get(server.address + "/healthz")
            assert code == 200 and json.loads(body)["live_workers"] == 2
            verdict["ok"] = False
            verdict["live_workers"] = 1
            try:
                code, body = _get(server.address + "/healthz")
            except urllib.error.HTTPError as e:
                code, body = e.code, e.read()
            assert code == 503
            assert json.loads(body)["live_workers"] == 1
        finally:
            server.stop()


# ------------------------------------------------------- process drills
class TestSupervisedRun:
    def test_trains_checkpoints_and_reports_lifecycle(self, tmp_path):
        from deeplearning4j_tpu_torch.checkpoint import format as ckfmt

        jobs = _jobs(4)
        ckpt = str(tmp_path / "ckpt")
        sup = _supervisor(tmp_path, "happy", jobs, checkpoint_dir=ckpt,
                          status_port=0)
        status_url = sup.status_server.address
        seen = {}

        def poll():
            deadline = time.time() + 120
            while time.time() < deadline and not seen.get("done"):
                try:
                    _, body = _get(status_url + "/status.json",
                                   timeout=5)
                    s = json.loads(body)
                except (OSError, ValueError):
                    return
                extra = s.get("extra", {})
                for wid, rec in (extra.get("workers") or {}).items():
                    if rec.get("state") == "running":
                        seen[wid] = rec
                try:
                    code, _ = _get(status_url + "/healthz", timeout=5)
                    seen["healthz"] = code
                except (OSError, urllib.error.HTTPError):
                    pass
                time.sleep(0.05)

        poller = threading.Thread(target=poll, daemon=True)
        poller.start()
        final = sup.run(timeout=240.0)
        seen["done"] = True
        poller.join(timeout=10)
        assert final is not None and final.ndim == 1
        assert sorted(sup.folded_seqs) == list(range(len(jobs)))
        steps = ckfmt.list_steps(ckpt)
        assert steps and steps[-1] == len(jobs)
        manifest = ckfmt.read_manifest(ckpt, steps[-1])
        assert manifest["mesh"]["axes"]["workers"] >= 1
        assert seen.get("healthz") == 200
        lifecycle = [v for k, v in seen.items()
                     if k not in ("healthz", "done")]
        assert lifecycle, "status.json never showed a running worker"
        assert all("last_step" in rec and "generation" in rec
                   for rec in lifecycle)

    def test_spawn_crash_is_respawned_via_seeded_chaos(self, tmp_path):
        jobs = _jobs(4)
        plan = chaos.env_spec([chaos.Rule("worker.spawn", "error")],
                              seed=7)

        def env_for(wid):
            return plan if wid == "w1" else {}

        sup = _supervisor(tmp_path, "spawncrash", jobs, env_for=env_for,
                          max_respawns=2, respawn_backoff_s=0.05)
        final = sup.run(timeout=240.0)
        assert final is not None
        assert sorted(sup.folded_seqs) == list(range(len(jobs)))
        assert sup.respawns_used >= 1
        evicted = [r for r in sup.members.values()
                   if r.state in (EVICTED, DEAD)]
        assert any((r.eviction_reason or "").startswith("spawn_failed")
                   for r in evicted)

    def test_hung_worker_caught_by_progress_watermark(self, tmp_path):
        """A chaos `hang` at worker.step (after one good job) freezes
        w1's train loop while its reporter thread keeps the socket warm:
        liveness holds, only the progress watermark can evict it. The
        eviction reason must say hung, and the wave must re-form."""
        jobs = _jobs(6)
        plan = chaos.env_spec(
            [chaos.Rule("worker.step", "hang", after=1)], seed=11)

        def env_for(wid):
            return plan if wid == "w1" else {}

        sup = _supervisor(tmp_path, "hangdrill", jobs, env_for=env_for,
                          max_respawns=1, respawn_backoff_s=0.05,
                          heartbeat_timeout=60.0,  # staleness CANNOT fire
                          progress_timeout=3.0, startup_grace=120.0)
        final = sup.run(timeout=240.0)
        assert final is not None
        assert sorted(sup.folded_seqs) == list(range(len(jobs)))
        hung = [r for r in sup.members.values()
                if (r.eviction_reason or "").startswith("hung")]
        assert hung, {r.id: r.eviction_reason
                      for r in sup.members.values()}
        assert sup.respawns_used == 1

    def test_capacity_lost_at_startup_shrinks_to_survivors(self,
                                                           tmp_path):
        jobs = _jobs(4)
        plan = chaos.env_spec([chaos.Rule("worker.spawn", "error")],
                              seed=3)

        def env_for(wid):
            return plan if wid.startswith("w1") else {}

        sup = _supervisor(tmp_path, "shrink", jobs, env_for=env_for,
                          max_respawns=0)
        final = sup.run(timeout=240.0)
        assert final is not None
        assert sorted(sup.folded_seqs) == list(range(len(jobs)))
        assert sup.n_workers == 1
        assert sup.state_counts()[DEAD] == 1

    def test_straggler_flagged_evicted_and_respawned(self, tmp_path):
        jobs = _jobs(10)
        plan = chaos.env_spec(
            [chaos.Rule("worker.step", "delay", delay_s=1.2)], seed=5)

        def env_for(wid):
            return plan if wid == "w1" else {}

        sup = _supervisor(tmp_path, "straggler", jobs, env_for=env_for,
                          max_respawns=1, respawn_backoff_s=0.05,
                          straggler_factor=3.0,
                          straggler_min_samples=2, straggler_strikes=1)
        final = sup.run(timeout=240.0)
        assert final is not None
        assert sorted(sup.folded_seqs) == list(range(len(jobs)))
        straggled = [r for r in sup.members.values()
                     if (r.eviction_reason or "").startswith("straggler")]
        assert straggled and straggled[0].id == "w1"
        assert sup.respawns_used == 1
        assert int(sup._m_straggler.value) >= 1


# -------------------------------------------------------------- interop
def _jax_supervisor(tmp_path, tag, jobs, **kw):
    from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
    from deeplearning4j_tpu.scaleout.api import \
        CollectionJobIterator as JIter
    from deeplearning4j_tpu.scaleout.registry import \
        ConfigRegistry as JRegistry
    from deeplearning4j_tpu.scaleout.supervisor import \
        TrainingSupervisor as JSup
    from deeplearning4j_tpu.scaleout.supervisor import \
        WorkerSpawner as JSpawner

    cj = _conf_json()
    registry_root = str(tmp_path / f"jreg_{tag}")
    return JSup(JIter([JDataSet(j.features, j.labels) for j in jobs]),
                run_name=tag, registry=JRegistry(registry_root),
                performer_class=JPERFORMER,
                performer_conf={"conf_json": cj, "epochs": 1},
                n_workers=2, conf_json=cj,
                spawner=JSpawner(registry_root, tag), **kw)


def _commit(sup, vec, cursor, waves):
    """One supervisor checkpoint as `_save_checkpoint` writes it."""
    sup.tracker.set_current(vec)
    sup.folded_seqs = list(range(cursor))
    sup.jobs_consumed = sup.jobs_aggregated = cursor
    sup.waves = waves
    return sup._save_checkpoint(wait=True)


class TestSupervisorInterop:
    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_checkpoint_of_either_package_resumes_on_the_other(
            self, tmp_path, writer):
        jobs = _jobs(6)
        ck = str(tmp_path / "ck")
        vec = np.random.RandomState(1).randn(67).astype(np.float32)
        make_writer = _jax_supervisor if writer == "jax" else _supervisor
        make_reader = _supervisor if writer == "jax" else _jax_supervisor
        a = make_writer(tmp_path, "w", jobs, checkpoint_dir=ck)
        try:
            assert _commit(a, vec, 4, 2) is not None
        finally:
            a.close()
        b = make_reader(tmp_path, "r", jobs, checkpoint_dir=ck,
                        resume="auto")
        try:
            np.testing.assert_array_equal(
                np.asarray(b.tracker.get_current()), vec)
            ev = b.resume_events[0]
            assert (ev["step"], ev["cursor"]) == (4, 4)
            assert ev["source_workers"] == 0  # written with no live member
            assert b.jobs_consumed == 4 and b.folded_seqs == [0, 1, 2, 3]
        finally:
            b.close()

    def test_port_run_resumes_a_jax_checkpoint_to_the_end(self, tmp_path):
        """The resumed run (port workers on the CPU) trains exactly the
        jobs after the JAX checkpoint's cursor."""
        jobs = _jobs(6)
        ck = str(tmp_path / "ck")
        from deeplearning4j_tpu.nn.multilayer import \
            MultiLayerNetwork as JNet

        vec = np.asarray(JNet.from_config_json(_conf_json()).params())
        a = _jax_supervisor(tmp_path, "w", jobs, checkpoint_dir=ck)
        try:
            _commit(a, vec, 2, 1)
        finally:
            a.close()
        b = _supervisor(tmp_path, "r", jobs, checkpoint_dir=ck,
                        resume="auto")
        final = b.run(timeout=240.0)
        assert sorted(b.folded_seqs) == list(range(len(jobs)))
        assert b.resume_events[0]["cursor"] == 2
        assert final.shape == vec.shape and np.abs(final - vec).max() > 0

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_journal_of_either_package_is_adopted_by_the_other(
            self, tmp_path, writer):
        """One journal format: a live child journaled by one package's
        handoff is fingerprint-verified and adopted by the other's next
        incarnation (same incarnation count, same adoption event)."""
        jobs = _jobs(4)
        state = str(tmp_path / "state")
        make_writer = _jax_supervisor if writer == "jax" else _supervisor
        make_reader = _supervisor if writer == "jax" else _jax_supervisor
        child = subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(120)"],
            start_new_session=True)
        try:
            a = make_writer(tmp_path, "run", jobs, state_dir=state)
            rec_cls = (SupervisedWorker if writer == "port" else
                       __import__("deeplearning4j_tpu.scaleout.supervisor",
                                  fromlist=["x"]).SupervisedWorker)
            rec = rec_cls("w0", 0, proc=child)
            rec.performed = 3
            a.members["w0"] = rec
            a.close(handoff=True)
            journal = a.journal.read()
            assert journal["workers"]["w0"]["pid"] == child.pid
            b = make_reader(tmp_path, "run", jobs, state_dir=state)
            try:
                assert b.incarnation == 1
                assert [(e["worker"], e["kind"], e["pid"])
                        for e in b.adoption_events] \
                    == [("w0", "adopted", child.pid)]
                assert b.members["w0"].adopted
                assert b.members["w0"].performed == 3
            finally:
                b.close()
            # a clean close stops what it adopted and clears the journal
            assert _wait(lambda: child.poll() is not None, 15.0)
            assert b.journal.read() is None
        finally:
            if child.poll() is None:
                child.kill()
            child.wait()
            procs.unregister_spawned(child)


# --------------------------------------------------- slow process soaks
@pytest.mark.slow
class TestKillDrills:
    def _reference(self, tmp_path, jobs):
        return _supervisor(tmp_path, "ref", jobs).run(timeout=240.0)

    def test_sigkill_respawn_is_bit_identical(self, tmp_path):
        jobs = _jobs(6)
        ref = self._reference(tmp_path, jobs)
        sup = _supervisor(tmp_path, "sigkill", jobs,
                          checkpoint_dir=str(tmp_path / "ck_kill"),
                          max_respawns=2, respawn_backoff_s=0.05,
                          heartbeat_timeout=2.0)
        killed = {}

        def killer():
            deadline = time.time() + 120
            while time.time() < deadline:
                for rec in list(sup.members.values()):
                    if (rec.performed >= 1 and rec.proc is not None
                            and rec.generation == 0):
                        chaos.sigkill(rec.proc)
                        killed["id"] = rec.id
                        return
                time.sleep(0.01)

        threading.Thread(target=killer, daemon=True).start()
        final = sup.run(timeout=240.0)
        assert killed, "fault was never injected"
        assert sup.respawns_used >= 1
        assert sorted(sup.folded_seqs) == list(range(len(jobs)))
        np.testing.assert_array_equal(ref, final)

    def test_capacity_loss_resumes_resharded_on_survivor(self, tmp_path):
        jobs = _jobs(6)
        sup = _supervisor(tmp_path, "caploss", jobs,
                          checkpoint_dir=str(tmp_path / "ck_lost"),
                          max_respawns=0, heartbeat_timeout=2.0)
        killed = {}

        def killer():
            deadline = time.time() + 120
            while time.time() < deadline:
                if sup.waves >= 1:
                    for rec in list(sup.members.values()):
                        if rec.performed >= 1 and rec.proc is not None:
                            chaos.sigkill(rec.proc)
                            killed["id"] = rec.id
                            return
                time.sleep(0.01)

        threading.Thread(target=killer, daemon=True).start()
        final = sup.run(timeout=240.0)
        assert killed and final is not None
        assert sorted(sup.folded_seqs) == list(range(len(jobs)))
        assert sup.resume_events, "elastic resume never happened"
        ev = sup.resume_events[-1]
        assert ev["resharded"] and ev["survivors"] == 1
        assert ev["recovery_s"] < 60

    def test_sigstop_detected_by_watermark_within_window(self, tmp_path):
        jobs = _jobs(8)
        sup = _supervisor(tmp_path, "sigstop", jobs,
                          max_respawns=1, respawn_backoff_s=0.05,
                          heartbeat_timeout=60.0, progress_timeout=2.0)
        stopped = {}

        def stopper():
            deadline = time.time() + 120
            while time.time() < deadline:
                for rec in list(sup.members.values()):
                    if (rec.performed >= 1 and rec.proc is not None
                            and rec.generation == 0):
                        chaos.sigstop(rec.proc)
                        stopped["id"] = rec.id
                        stopped["t"] = time.monotonic()
                        return
                time.sleep(0.01)

        threading.Thread(target=stopper, daemon=True).start()
        final = sup.run(timeout=240.0)
        assert stopped, "fault was never injected"
        rec = sup.members[stopped["id"]]
        assert (rec.eviction_reason or "").startswith("hung"), \
            rec.eviction_reason
        detected_in = rec.evicted_at - stopped["t"]
        assert detected_in < 3 * sup.progress_timeout + 5.0
        assert final is not None
        assert sorted(sup.folded_seqs) == list(range(len(jobs)))
