"""The PyTorch port's in-process scaleout runtime (deeplearning4j_tpu_torch/
scaleout/runtime.py, aggregator.py, perform.py) held against the JAX
package's on the CPU.

The cases of tests/test_scaleout.py run on the port with
`NeuralNetWorkPerformer(..., device="cpu")` (its on-mesh averaging case is
mirrored in tests/test_torch_parallel.py). Parity:

- `ParameterAveragingAggregator` of either package averages the same job
  results to the same bits;
- the same jobs go from the same initial params (the JAX net's packed
  vector) through JAX's `DistributedRuntime` and the port's, sync, 2
  workers, with a stateless updater (AdaGrad off, momentum 0, the conf
  of tests/test_cli.py:211-218): the final params agree within
  PARAM_TOL = 2e-5, the tolerance tests/test_torch_multilayer.py holds
  `fit` to. With 2 workers a wave's sum is order-free in IEEE, and the
  fold is in job-seq order anyway.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest

from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.datasets.iris import load_iris
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.scaleout import (
    CollectionJobIterator,
    DataSetJobIterator,
    DefaultModelSaver,
    DistributedRuntime,
    HogWildWorkRouter,
    InMemoryStateTracker,
    Job,
    LocalFileUpdateSaver,
    NeuralNetWorkPerformer,
    load_checkpoint,
)
from deeplearning4j_tpu_torch.scaleout.aggregator import (
    ParameterAveragingAggregator,
    iterate_and_update,
)

PARAM_TOL = 2e-5  # tests/test_torch_multilayer.py's bound for fit
CPU = "cpu"


def _builder(iters, adagrad=False, momentum=None):
    b = (NeuralNetConfiguration.builder()
         .lr(0.1).n_in(4).activation_function("tanh")
         .optimization_algo("iteration_gradient_descent")
         .num_iterations(iters).use_adagrad(adagrad))
    return b if momentum is None else b.momentum(momentum)


def iris_conf_json(iters=5):
    return (_builder(iters)
            .list(2).hidden_layer_sizes([8])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=3)
            .pretrain(False).build().to_json())


def iris_batches(n_batches=8, batch_size=32):
    x, y = load_iris()
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n_batches):
        idx = rng.choice(len(x), batch_size)
        out.append(DataSet(np.asarray(x)[idx], np.asarray(y)[idx]))
    return out


def performer(conf_json, **kw):
    return lambda: NeuralNetWorkPerformer(conf_json, epochs=1, device=CPU,
                                          **kw)


class TestStateTracker:
    def test_worker_registry_and_heartbeats(self):
        t = InMemoryStateTracker(heartbeat_timeout=0.05)
        t.add_worker("a")
        t.add_worker("b")
        assert set(t.workers()) == {"a", "b"}
        time.sleep(0.06)
        t.heartbeat("a")
        assert t.stale_workers() == ["b"]
        t.remove_worker("b")
        assert t.workers() == ["a"]

    def test_eviction_requeues_job(self):
        t = InMemoryStateTracker()
        t.add_worker("w")
        t.add_job(Job(work="batch", worker_id="w"))
        assert t.job_for("w") is not None
        t.remove_worker("w")
        assert t.job_for("w") is None

    def test_counters_kv_early_stop(self):
        t = InMemoryStateTracker()
        t.increment("words", 10)
        t.increment("words", 5)
        assert t.count("words") == 15
        t.define("alpha", 0.025)
        assert t.get("alpha") == 0.025
        t.set_patience(2)
        t.report_loss(1.0)
        t.report_loss(1.0)  # no improvement x2 -> trip
        t.report_loss(1.0)
        assert t.early_stop()

    def test_current_model_replication_flags(self):
        t = InMemoryStateTracker()
        t.add_worker("w0")
        t.set_current(np.ones(3))
        assert t.needs_replicate("w0")
        t.done_replicating("w0")
        assert not t.needs_replicate("w0")


class TestAggregation:
    def test_parameter_averaging(self):
        agg = ParameterAveragingAggregator()
        agg.accumulate(Job(work=None, worker_id="a", result=np.ones(4)))
        agg.accumulate(Job(work=None, worker_id="b", result=3 * np.ones(4)))
        np.testing.assert_allclose(agg.aggregate(), 2 * np.ones(4))

    def test_iterate_and_update_via_file_saver(self, tmp_path):
        t = InMemoryStateTracker(
            update_saver=LocalFileUpdateSaver(str(tmp_path)))
        t.add_update("a", np.zeros(3))
        t.add_update("b", np.full(3, 2.0))
        out = iterate_and_update(t, ParameterAveragingAggregator())
        np.testing.assert_allclose(out, np.ones(3))

    @pytest.mark.parametrize("n", [2, 3, 7])
    def test_averages_bit_equal_to_jax(self, n):
        """Same job results, same bits: both aggregators sum in float64
        in arrival order and divide once."""
        from deeplearning4j_tpu.scaleout.aggregator import \
            ParameterAveragingAggregator as JAgg
        from deeplearning4j_tpu.scaleout.api import Job as JJob

        rng = np.random.RandomState(n)
        results = [rng.randn(257).astype(np.float32) for _ in range(n)]
        ours, theirs = ParameterAveragingAggregator(), JAgg()
        for i, r in enumerate(results):
            ours.accumulate(Job(work=None, worker_id=f"w{i}", result=r))
            theirs.accumulate(JJob(work=None, worker_id=f"w{i}", result=r))
        a, b = ours.aggregate(), theirs.aggregate()
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        ours.reset()
        assert ours.aggregate() is None


class TestDistributedRuntime:
    def _loss_of(self, params_vec):
        net = MultiLayerNetwork.from_config_json(iris_conf_json(),
                                                 device=CPU)
        net.set_parameters(params_vec)
        x, y = load_iris()
        return net.score(x, y)

    def test_iterative_reduce_converges(self):
        conf_json = iris_conf_json()
        seed_net = MultiLayerNetwork.from_config_json(conf_json, device=CPU)
        loss0 = self._loss_of(seed_net.params().numpy())
        it = CollectionJobIterator(iris_batches(12))
        rt = DistributedRuntime(
            it, performer(conf_json), n_workers=3,
            initial_params=seed_net.params().numpy())
        final = rt.run(timeout=120)
        assert final is not None
        assert rt.waves >= 2  # multiple averaging waves happened
        assert self._loss_of(final) < loss0

    def test_hogwild_converges(self):
        conf_json = iris_conf_json()
        seed_net = MultiLayerNetwork.from_config_json(conf_json, device=CPU)
        loss0 = self._loss_of(seed_net.params().numpy())
        it = CollectionJobIterator(iris_batches(10))
        rt = DistributedRuntime(
            it, performer(conf_json), n_workers=2,
            router_cls=HogWildWorkRouter,
            initial_params=seed_net.params().numpy())
        final = rt.run(timeout=120)
        assert self._loss_of(final) < loss0

    def test_dataset_job_iterator(self):
        ds_iter = ListDataSetIterator(
            DataSet(np.random.rand(64, 4).astype(np.float32),
                    np.eye(3, dtype=np.float32)[np.random.randint(0, 3, 64)]),
            batch_size=16)
        it = DataSetJobIterator(ds_iter)
        seen = 0
        while it.has_next():
            job = it.next(f"w{seen % 2}")
            assert job.work.features.shape[0] == 16
            seen += 1
        assert seen == 4
        it.reset()
        assert it.has_next()

    def test_worker_eviction_and_reregistration(self):
        """Pause a worker past the heartbeat timeout -> master evicts it;
        un-pausing re-registers it (reference MasterActor eviction +
        WorkerActor re-registering heartbeat)."""
        conf_json = iris_conf_json(iters=1)
        it = CollectionJobIterator(iris_batches(6, batch_size=16))
        tracker = InMemoryStateTracker(heartbeat_timeout=0.3)
        rt = DistributedRuntime(it, performer(conf_json), n_workers=2,
                                tracker=tracker, heartbeat_interval=0.02)
        rt.start_workers()
        deadline = time.time() + 30
        while len(tracker.workers()) < 2 and time.time() < deadline:
            time.sleep(0.02)
        rt.workers[0].paused.set()
        # wait (bounded) until the paused worker is stale, then sweep
        deadline = time.time() + 30
        while (rt.workers[0].worker_id not in tracker.stale_workers()
               and time.time() < deadline):
            time.sleep(0.02)
        rt._evict_stale()
        assert rt.workers[0].worker_id not in tracker.workers()
        rt.workers[0].paused.clear()
        deadline = time.time() + 30
        while len(tracker.workers()) < 2 and time.time() < deadline:
            time.sleep(0.02)
        assert len(tracker.workers()) == 2  # elastic re-join
        tracker.finish()

    def test_sync_runtime_matches_jax(self):
        """The parity gate: the same jobs from the same initial params
        through JAX's runtime and the port's (sync, 2 workers, stateless
        updater) end within PARAM_TOL of each other."""
        from deeplearning4j_tpu.config import \
            NeuralNetConfiguration as JConf
        from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
        from deeplearning4j_tpu.nn.multilayer import \
            MultiLayerNetwork as JNet
        from deeplearning4j_tpu.scaleout import \
            CollectionJobIterator as JIter
        from deeplearning4j_tpu.scaleout import \
            DistributedRuntime as JRuntime
        from deeplearning4j_tpu.scaleout import \
            NeuralNetWorkPerformer as JPerformer

        conf_json = (JConf.builder()
                     .lr(0.1).n_in(4).activation_function("tanh")
                     .optimization_algo("iteration_gradient_descent")
                     .num_iterations(2).use_adagrad(False).momentum(0.0)
                     .list(2).hidden_layer_sizes([8])
                     .override(1, layer="output", loss_function="mcxent",
                               activation_function="softmax", n_out=3)
                     .pretrain(False).build().to_json())
        p0 = np.asarray(JNet.from_config_json(conf_json).params())
        batches = iris_batches(8, batch_size=24)
        jrt = JRuntime(
            JIter([JDataSet(b.features, b.labels) for b in batches]),
            lambda: JPerformer(conf_json, epochs=1), n_workers=2,
            initial_params=p0)
        ref = np.asarray(jrt.run(timeout=120))
        rt = DistributedRuntime(CollectionJobIterator(list(batches)),
                                performer(conf_json), n_workers=2,
                                initial_params=p0)
        got = rt.run(timeout=120)
        assert rt.waves == jrt.waves
        assert sorted(rt.folded_seqs) == sorted(jrt.folded_seqs) \
            == list(range(len(batches)))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=PARAM_TOL, rtol=0)
        assert np.abs(got - p0).max() > 100 * PARAM_TOL  # it trained


class TestWaveMembership:
    """Exact wave barrier (reference IterativeReduceWorkRouter.java:46-57):
    an eviction mid-wave must re-form the wave, not silently shrink it."""

    def _runtime(self, jobs):
        it = CollectionJobIterator(jobs)
        tracker = InMemoryStateTracker(heartbeat_timeout=1e9)
        return DistributedRuntime(it, None, n_workers=2,
                                  tracker=tracker), tracker

    def test_wave_reforms_after_mid_wave_eviction(self):
        rt, tracker = self._runtime([np.ones(3), 2 * np.ones(3)])
        tracker.add_worker("a")
        tracker.add_worker("b")
        assert rt._open_wave() == 2

        job_b = tracker.job_for("b")
        tracker.add_update("b", np.asarray(job_b.work))
        tracker.clear_job("b")
        orphan = tracker.remove_worker("a")
        rt._orphan_jobs.append(Job(work=orphan.work,
                                   worker_id=orphan.worker_id))
        assert not rt._wave_complete(len(tracker.worker_updates()),
                                     len(tracker.jobs()))

        tracker.add_worker("c")
        rt._dispatch_wave(orphans_only=True)
        assert not rt._orphan_jobs
        job_c = tracker.job_for("c")
        assert job_c is not None
        np.testing.assert_allclose(job_c.work, orphan.work)
        assert not rt._wave_complete(len(tracker.worker_updates()),
                                     len(tracker.jobs()))

        tracker.add_update("c", np.asarray(job_c.work))
        tracker.clear_job("c")
        assert rt._wave_complete(len(tracker.worker_updates()),
                                 len(tracker.jobs()))
        rt._aggregate_and_publish()
        np.testing.assert_allclose(tracker.get_current(), 1.5 * np.ones(3))

    def test_orphans_only_dispatch_pulls_no_new_work(self):
        rt, tracker = self._runtime([np.ones(3), 2 * np.ones(3),
                                     3 * np.ones(3)])
        tracker.add_worker("a")
        assert rt._open_wave() == 1
        tracker.clear_job("a")
        assert rt._dispatch_wave(orphans_only=True) == 0
        assert rt.job_iterator.has_next()

    def test_dropped_job_releases_barrier(self):
        from deeplearning4j_tpu_torch.scaleout.runtime import JOBS_DROPPED
        rt, tracker = self._runtime([np.ones(3), 2 * np.ones(3)])
        tracker.add_worker("a")
        tracker.add_worker("b")
        assert rt._open_wave() == 2
        job_b = tracker.job_for("b")
        tracker.add_update("b", np.asarray(job_b.work))
        tracker.clear_job("b")
        tracker.clear_job("a")
        tracker.increment(JOBS_DROPPED)
        assert rt._wave_complete(len(tracker.worker_updates()),
                                 len(tracker.jobs()))

    def test_jobs_dropped_counter_is_jaxs(self):
        from deeplearning4j_tpu.scaleout.runtime import \
            JOBS_DROPPED as JDROPPED
        from deeplearning4j_tpu.scaleout.runtime import \
            MAX_JOB_RETRIES as JMAX
        from deeplearning4j_tpu_torch.scaleout.runtime import (
            JOBS_DROPPED, MAX_JOB_RETRIES)

        assert (JOBS_DROPPED, MAX_JOB_RETRIES) == (JDROPPED, JMAX)


class TestRuntimeRegressions:
    def test_initial_params_reach_workers(self):
        t = InMemoryStateTracker()
        t.set_current(np.ones(3))
        t.add_worker("late")
        assert t.needs_replicate("late")

    def test_periodic_checkpoint_written(self, tmp_path):
        path = str(tmp_path / "runtime.ckpt")
        conf_json = iris_conf_json(iters=2)
        it = CollectionJobIterator(iris_batches(6, batch_size=16))
        rt = DistributedRuntime(
            it, performer(conf_json), n_workers=2,
            model_saver=DefaultModelSaver(path), save_every_waves=1)
        rt.run(timeout=120)
        assert os.path.exists(path)
        net, info = load_checkpoint(path, device=CPU)
        assert info["metadata"]["waves"] >= 1

    def test_failed_job_requeued_and_retried(self):
        class FlakyPerformer(NeuralNetWorkPerformer):
            calls = 0

            def perform(self, job):
                FlakyPerformer.calls += 1
                if FlakyPerformer.calls == 1:
                    raise RuntimeError("injected failure")
                super().perform(job)

        conf_json = iris_conf_json(iters=1)
        it = CollectionJobIterator(iris_batches(3, batch_size=16))
        rt = DistributedRuntime(
            it, lambda: FlakyPerformer(conf_json, epochs=1, device=CPU),
            n_workers=1)
        final = rt.run(timeout=60)
        assert final is not None
        assert rt.workers[0].performed == 3


class TestCheckpoint:
    def test_save_load_round_trip(self, tmp_path):
        path = str(tmp_path / "nn-model.ckpt")
        x, y = load_iris()
        net = MultiLayerNetwork.from_config_json(iris_conf_json(),
                                                 device=CPU)
        net.fit(x, y, epochs=2)
        saver = DefaultModelSaver(path)
        saver.save(net, iterator_position=7, metadata={"epoch": 2})
        net2, info = load_checkpoint(path, device=CPU)
        np.testing.assert_allclose(net.params().numpy(),
                                   net2.params().numpy(), atol=1e-6)
        assert info["iterator_position"] == 7
        assert info["metadata"]["epoch"] == 2
        assert net2._updater_state is not None
        s_before = net2.score(x, y)
        net2.fit(x, y, epochs=1)
        assert net2.score(x, y) <= s_before + 1e-3

    def test_object_dtype_rejected_at_save_time(self):
        from deeplearning4j_tpu_torch.scaleout.checkpoint import \
            dump_payload

        ragged = np.empty(2, dtype=object)
        ragged[0], ragged[1] = np.zeros(2), np.zeros(3)
        with pytest.raises(TypeError):
            dump_payload({"bad": ragged})

    def test_timestamp_rename_of_prior(self, tmp_path):
        path = str(tmp_path / "nn-model.ckpt")
        net = MultiLayerNetwork.from_config_json(iris_conf_json(),
                                                 device=CPU)
        saver = DefaultModelSaver(path)
        saver.save(net)
        saver.save(net)
        files = os.listdir(tmp_path)
        assert "nn-model.ckpt" in files
        assert any(f.startswith("nn-model.ckpt.") for f in files)

    def test_runtime_checkpoint_loads_in_jax(self, tmp_path):
        """A runtime-level save (`save_current`, the packed vector + conf
        + cursor) written by the port restores in the JAX package."""
        from deeplearning4j_tpu.scaleout.checkpoint import \
            load_checkpoint as jload

        path = str(tmp_path / "rt.ckpt")
        conf_json = iris_conf_json(iters=1)
        rt = DistributedRuntime(
            CollectionJobIterator(iris_batches(4, batch_size=16)),
            performer(conf_json), n_workers=2,
            model_saver=DefaultModelSaver(path, keep_old=False),
            save_every_waves=1)
        rt.conf_json = conf_json
        final = rt.run(timeout=120)
        jnet, info = jload(path)
        np.testing.assert_array_equal(np.asarray(jnet.params()), final)
        assert info["iterator_position"] == 4
        assert info["metadata"]["waves"] == rt.waves


class TestSyncTickRegressions:
    def test_stray_update_without_open_wave_is_folded_in(self):
        it = CollectionJobIterator([np.ones(3)])
        tracker = InMemoryStateTracker(heartbeat_timeout=1e9)
        rt = DistributedRuntime(it, None, n_workers=1, tracker=tracker)
        tracker.add_worker("late")
        tracker.add_update("late", 4 * np.ones(3))
        assert rt._wave_size == 0
        stop = rt._sync_tick(len(tracker.worker_updates()),
                             len(tracker.jobs()))
        assert not stop
        np.testing.assert_allclose(tracker.get_current(), 4 * np.ones(3))
        assert not tracker.worker_updates()
        rt._sync_tick(0, 0)
        assert rt._wave_size == 1

    def test_undeliverable_orphan_closes_wave_on_survivors(self):
        it = CollectionJobIterator([np.ones(3), 3 * np.ones(3)])
        tracker = InMemoryStateTracker(heartbeat_timeout=1e9)
        rt = DistributedRuntime(it, None, n_workers=2, tracker=tracker)
        tracker.add_worker("a")
        tracker.add_worker("b")
        assert rt._open_wave() == 2
        job_b = tracker.job_for("b")
        tracker.add_update("b", np.asarray(job_b.work))
        tracker.clear_job("b")
        orphan = tracker.remove_worker("a")
        rt._orphan_jobs.append(Job(work=orphan.work,
                                   worker_id=orphan.worker_id))
        rt._sync_tick(len(tracker.worker_updates()), len(tracker.jobs()))
        assert rt._wave_size == 0
        assert tracker.get_current() is not None
        assert not tracker.worker_updates()
        rt._sync_tick(0, 0)
        assert rt._wave_size == 1
        job = tracker.job_for("b")
        np.testing.assert_allclose(job.work, orphan.work)


class TestWorkRetriever:
    def test_save_load_clear_round_trip(self, tmp_path):
        from deeplearning4j_tpu_torch.scaleout import LocalWorkRetriever

        wr = LocalWorkRetriever(str(tmp_path))
        ds = DataSet(np.random.rand(4, 3).astype(np.float32),
                     np.eye(2, dtype=np.float32)[[0, 1, 0, 1]])
        wr.save("w0", Job(work=ds, worker_id="w0"))
        assert wr.workers() == ["w0"]
        loaded = wr.load("w0")
        np.testing.assert_allclose(loaded.work.features, ds.features)
        np.testing.assert_allclose(loaded.work.labels, ds.labels)
        wr.clear("w0")
        assert wr.load("w0") is None
        assert wr.workers() == []

    def test_runtime_routes_payloads_through_retriever(self, tmp_path):
        from deeplearning4j_tpu_torch.scaleout import LocalWorkRetriever

        conf_json = iris_conf_json(iters=2)
        seed_net = MultiLayerNetwork.from_config_json(conf_json, device=CPU)
        it = CollectionJobIterator(iris_batches(6, batch_size=16))
        wr = LocalWorkRetriever(str(tmp_path))
        tracker = InMemoryStateTracker()

        routed_payloads = []
        orig_add_job = tracker.add_job

        def spy_add_job(job):
            routed_payloads.append(job.work)
            return orig_add_job(job)

        tracker.add_job = spy_add_job
        rt = DistributedRuntime(
            it, performer(conf_json), n_workers=2, tracker=tracker,
            work_retriever=wr, initial_params=seed_net.params().numpy())
        final = rt.run(timeout=120)
        assert final is not None
        assert routed_payloads
        assert all(w is None for w in routed_payloads)
        assert wr.workers() == []


class TestPerformerDevice:
    def test_device_comes_from_the_conf(self):
        conf_json = iris_conf_json(iters=1)
        p = NeuralNetWorkPerformer()
        p.setup({"conf_json": conf_json, "epochs": 2, "device": "cpu"})
        assert p.network.device.type == "cpu" and p.epochs == 2
        job = Job(work=iris_batches(1, 16)[0], worker_id="w")
        p.perform(job)
        assert isinstance(job.result, np.ndarray)
        assert job.result.dtype == np.float32
        assert job.result.shape == (p.network.num_params(),)
        p.update(np.zeros_like(job.result))
        assert float(p.network.params().abs().sum()) == 0.0

    def test_no_device_means_the_card(self):
        import torch

        p = NeuralNetWorkPerformer(iris_conf_json(iters=1))
        if torch.cuda.is_available():
            assert p.network.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                p.network
