"""The PyTorch port's runtime-level resume drills held against the JAX
package's contract, on the CPU: tests/test_resume_drill.py's
`TestRuntimeLevelDrill` on the port's `DistributedRuntime`, performer
device "cpu". (Its network-level drills are mirrored in
tests/test_torch_guardian.py and tests/test_torch_checkpoint.py.)

Timing: the JAX kill drill evicts on a 0.5 s staleness window, which a
live worker's job can exceed under load, so the survivor too may be
evicted and the wave schedule changes with the load. Here the window is
2 s: the paused worker (which never heartbeats again) is still evicted,
and a live one is not.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.datasets.iris import load_iris
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.scaleout.api import CollectionJobIterator
from deeplearning4j_tpu_torch.scaleout.checkpoint import (DefaultModelSaver,
                                                          load_checkpoint)
from deeplearning4j_tpu_torch.scaleout.perform import NeuralNetWorkPerformer
from deeplearning4j_tpu_torch.scaleout.runtime import DistributedRuntime
from deeplearning4j_tpu_torch.scaleout.statetracker import \
    InMemoryStateTracker

KILL_WINDOW = 2.0  # staleness window of the kill drill


def _conf(iters=2, momentum=0.5):
    return (NeuralNetConfiguration.builder()
            .lr(0.1).n_in(4).activation_function("tanh")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(iters).use_adagrad(False).momentum(momentum)
            .list(2).hidden_layer_sizes([8])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=3)
            .pretrain(False).build())


def _jobs(n=8, bs=24, seed=1):
    x, y = load_iris()
    x, y = np.asarray(x), np.asarray(y)
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        idx = rng.choice(len(x), bs, replace=False)
        out.append(DataSet(x[idx], y[idx]))
    return out


def _make_runtime(jobs, ckpt_path=None, initial_params=None, momentum=0.5,
                  heartbeat_timeout=KILL_WINDOW):
    conf_json = _conf(momentum=momentum).to_json()
    rt = DistributedRuntime(
        CollectionJobIterator(jobs),
        performer_factory=lambda: NeuralNetWorkPerformer(
            conf_json=conf_json, epochs=1, device="cpu"),
        n_workers=2,
        tracker=InMemoryStateTracker(heartbeat_timeout=heartbeat_timeout),
        model_saver=(DefaultModelSaver(ckpt_path, keep_old=False)
                     if ckpt_path else None),
        save_every_waves=1 if ckpt_path else 0,
        initial_params=initial_params,
    )
    rt.conf_json = conf_json
    return rt


def _net(conf_json, params=None):
    return MultiLayerNetwork.from_config_json(conf_json, params=params,
                                              device="cpu")


class TestRuntimeLevelDrill:
    def test_master_crash_resume_is_exact(self, tmp_path):
        """Clean master crash at a wave boundary: resuming from the
        checkpoint (params + jobs_consumed seek) reproduces the
        uninterrupted run (momentum 0: worker-local optimizer state is
        ephemeral by design)."""
        jobs = _jobs(8)
        ref_params = _make_runtime(list(jobs), momentum=0.0,
                                   heartbeat_timeout=60.0).run(timeout=90.0)

        ckpt = str(tmp_path / "run.ckpt")
        rt1 = _make_runtime(jobs[:4], ckpt_path=ckpt, momentum=0.0,
                            heartbeat_timeout=60.0)
        rt1.run(timeout=90.0)
        assert rt1.jobs_consumed == 4

        net, info = load_checkpoint(ckpt, device="cpu")
        assert info["iterator_position"] == 4
        it = CollectionJobIterator(list(jobs))
        it.seek(info["iterator_position"])
        rt2 = _make_runtime(list(jobs), momentum=0.0,
                            heartbeat_timeout=60.0,
                            initial_params=net.params().numpy())
        rt2.job_iterator = it
        resumed = rt2.run(timeout=90.0)
        np.testing.assert_allclose(resumed, ref_params,
                                   rtol=1e-5, atol=1e-6)

    def test_worker_kill_then_master_crash_then_resume_converges(
            self, tmp_path):
        """A worker dies mid-run (heartbeats stop -> eviction -> orphan
        requeue), the master checkpoints each wave then crashes; a new
        master resumes. The eviction reshapes wave composition, so the
        drill asserts loss continuity and convergence."""
        x, y = load_iris()
        x, y = np.asarray(x), np.asarray(y)
        jobs = _jobs(8)

        ref_params = _make_runtime(list(jobs)).run(timeout=90.0)
        conf_json = _conf().to_json()
        ref_loss = _net(conf_json, ref_params).score(x, y)
        fresh_loss = _net(conf_json).score(x, y)

        half = jobs[:4]
        ckpt = str(tmp_path / "run.ckpt")
        rt1 = _make_runtime(list(half), ckpt_path=ckpt)

        def _killer():
            deadline = time.time() + 60
            while time.time() < deadline:
                if rt1.workers and rt1.workers[0].performed >= 1:
                    rt1.workers[0].paused.set()
                    return
                time.sleep(0.005)

        killer = threading.Thread(target=_killer, daemon=True)
        killer.start()
        interrupted = rt1.run(timeout=90.0)
        killer.join(timeout=5)
        assert rt1.workers[0].paused.is_set(), "fault was never injected"
        assert interrupted is not None
        assert rt1.jobs_consumed == len(half)
        ckpt_loss = _net(conf_json, np.asarray(interrupted)).score(x, y)

        net, info = load_checkpoint(ckpt, device="cpu")
        assert info["iterator_position"] == len(half)
        it = CollectionJobIterator(list(jobs))
        it.seek(info["iterator_position"])
        rt2 = _make_runtime(list(jobs),
                            initial_params=net.params().numpy())
        rt2.job_iterator = it
        resumed = rt2.run(timeout=90.0)
        resumed_loss = _net(conf_json, np.asarray(resumed)).score(x, y)

        assert resumed_loss < fresh_loss, "no training happened"
        assert resumed_loss <= ckpt_loss + 0.02, \
            f"resume regressed: {ckpt_loss} -> {resumed_loss}"
        assert abs(resumed_loss - ref_loss) < 0.1, \
            f"did not converge to the uninterrupted result: " \
            f"{resumed_loss} vs {ref_loss}"

    def test_checkpoint_metadata_records_resume_cursor(self, tmp_path):
        jobs = _jobs(4)
        ckpt = str(tmp_path / "c.ckpt")
        rt = _make_runtime(jobs, ckpt_path=ckpt)
        rt.run(timeout=90.0)
        assert os.path.exists(ckpt)
        _, info = load_checkpoint(ckpt, device="cpu")
        assert info["iterator_position"] == len(jobs)
        assert info["metadata"]["waves"] == rt.waves

    def test_runtime_checkpoint_of_either_package_resumes_in_the_other(
            self, tmp_path):
        """The runtime-level `.npz` checkpoint crosses: a JAX runtime's
        save resumes a port runtime (and the port's a JAX one) at the
        same cursor with the same params."""
        from deeplearning4j_tpu.scaleout.checkpoint import \
            DefaultModelSaver as JSaver
        from deeplearning4j_tpu.scaleout.checkpoint import \
            load_checkpoint as jload

        conf_json = _conf(momentum=0.0).to_json()
        vec = np.random.RandomState(3).randn(67).astype(np.float32)
        jpath, ppath = str(tmp_path / "j.ckpt"), str(tmp_path / "p.ckpt")
        JSaver(jpath).save_current(vec, conf_json=conf_json,
                                   iterator_position=4,
                                   metadata={"waves": 2})
        DefaultModelSaver(ppath).save_current(vec, conf_json=conf_json,
                                              iterator_position=4,
                                              metadata={"waves": 2})
        net, info = load_checkpoint(jpath, device="cpu")
        jnet, jinfo = jload(ppath)
        np.testing.assert_array_equal(net.params().numpy(), vec)
        np.testing.assert_array_equal(np.asarray(jnet.params()), vec)
        assert info["iterator_position"] == jinfo["iterator_position"] == 4
        assert info["metadata"] == jinfo["metadata"] == {"waves": 2}
        # and the resumed runtimes start where the other package stopped
        rt = _make_runtime(_jobs(6), momentum=0.0,
                           initial_params=net.params().numpy())
        rt.job_iterator.seek(info["iterator_position"])
        final = rt.run(timeout=90.0)
        assert rt.jobs_consumed == 2 and final.shape == vec.shape
