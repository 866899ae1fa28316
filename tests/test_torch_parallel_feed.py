"""The PyTorch port's parallel trainers with the device feed, the
guardian and autosave, held against the JAX package's on the CPU: the
TestDeviceFeedDataParallel and TestGuardedTrainers cases of
tests/test_parallel.py, at JAX's mesh sizes, on forked gloo ranks
(`testing/ranks.py`, 120 s a group). JAX references are computed before
the ranks fork.

Tolerances as the JAX tests: the feed's DP against the single-device
feed rtol 2e-5 / atol 1e-5; ZeRO-1 against DP atol 1e-5; against the
JAX trainers atol 1e-5; guarded runs with a poisoned batch bit-equal to
clean runs without it.
"""

from __future__ import annotations

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import DeviceFeed as JDeviceFeed
from deeplearning4j_tpu.datasets import ListDataSetIterator as JListIter
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.parallel import DataParallelTrainer as JDP
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel.tensor_parallel import \
    TensorParallelTrainer as JTP
from deeplearning4j_tpu_torch.datasets import (DataSet, DeviceFeed,
                                               ListDataSetIterator)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.guardian import GuardianPolicy
from deeplearning4j_tpu_torch.parallel import (DataParallelTrainer,
                                               ShardedUpdateTrainer,
                                               TensorParallelTrainer,
                                               make_mesh)
from deeplearning4j_tpu_torch.parallel.mesh import batch_sharding
from deeplearning4j_tpu_torch.testing.ranks import run_ranks
from tests.test_multilayer import mlp_conf

GROUP_LIMIT = 120.0
TRAINERS = {"dp": DataParallelTrainer, "zero1": ShardedUpdateTrainer,
            "tp": TensorParallelTrainer}
MESHES = {"dp": {"data": 8}, "zero1": {"data": 8},
          "tp": {"data": 2, "model": 4}}


def _ragged(n=100, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 4).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)])


def _net(conf_json, p0):
    net = MultiLayerNetwork.from_config_json(conf_json, device="cpu")
    net.set_parameters(p0)
    return net


def _jnet():
    jnet = JNet(mlp_conf(lr=0.1, iters=1))
    return jnet, jnet.to_json(), np.asarray(jnet.params())


def _fit_rank(rank, trainer, conf_json, p0, x, y, bs, epochs, **fit_kw):
    mesh = make_mesh(MESHES[trainer], device="cpu")
    net = _net(conf_json, p0)
    tr = TRAINERS[trainer](net, mesh)
    tr.fit(ListDataSetIterator(DataSet(x, y), bs), epochs=epochs, **fit_kw)
    return net.params().numpy()


class TestDeviceFeedDataParallel:
    def test_feed_buckets_align_to_replicas(self):
        x, y = _ragged()
        jnet, conf_json, p0 = _jnet()
        jfeed = JDP(jnet, jmake_mesh({"data": 8}))._make_feed(
            JListIter(JDataSet(x, y), batch_size=48), None)

        def body(rank):
            tr = DataParallelTrainer(_net(conf_json, p0),
                                     make_mesh({"data": 8}, device="cpu"))
            feed = tr._make_feed(ListDataSetIterator(DataSet(x, y), 48),
                                 None)
            return isinstance(feed, DeviceFeed), feed.buckets

        for is_feed, buckets in run_ranks(body, 8, timeout=GROUP_LIMIT):
            assert is_feed and all(b % 8 == 0 for b in buckets)
            assert buckets == jfeed.buckets

    def test_feed_hands_each_rank_its_rows_with_the_global_count(self):
        """sharding= yields this rank's slice of the padded global batch;
        n_valid stays the global count, so the tail's padding (100 =
        2 x 48 + 4, bucket 8) is masked on the last ranks only."""
        x, y = _ragged()

        def body(rank):
            mesh = make_mesh({"data": 8}, device="cpu")
            feed = DeviceFeed(ListDataSetIterator(DataSet(x, y), 48),
                              align=8, sharding=batch_sharding(mesh),
                              device="cpu")
            return [(fb.features.numpy(), int(fb.n_valid)) for fb in feed]

        res = run_ranks(body, 8, timeout=GROUP_LIMIT)
        starts = [0, 48, 96]
        for b, (start, bucket, n) in enumerate(zip(starts, (48, 48, 8),
                                                   (48, 48, 4))):
            rows = bucket // 8
            for rank, batches in enumerate(res):
                feat, n_valid = batches[b]
                assert n_valid == n and feat.shape == (rows, 4)
                lo = rank * rows
                want = np.zeros((rows, 4), np.float32)
                real = max(0, min(rows, n - lo))
                want[:real] = x[start + lo:start + lo + real]
                np.testing.assert_array_equal(feat, want)

    def test_dp_feed_matches_single_device_feed(self):
        """8-rank masked training over a ragged stream equals the
        single-device feed path of the port and of the JAX package."""
        x, y = _ragged()  # batches 48, 48, 4 -> buckets 48, 48, 8
        jnet, conf_json, p0 = _jnet()
        single = _net(conf_json, p0)
        single.fit(ListDataSetIterator(DataSet(x, y), batch_size=48),
                   epochs=3)
        jnet.fit(JListIter(JDataSet(x, y), batch_size=48), epochs=3)
        got = run_ranks(_fit_rank, 8, "dp", conf_json, p0, x, y, 48, 3,
                        timeout=GROUP_LIMIT)[0]
        np.testing.assert_allclose(single.params().numpy(), got, rtol=2e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(jnet.params()),
                                   rtol=2e-5, atol=1e-5)

    def test_sharded_update_feed_matches_plain_dp_on_ragged(self):
        x, y = _ragged(72)  # 48 + ragged 24
        _, conf_json, p0 = _jnet()
        dp = run_ranks(_fit_rank, 8, "dp", conf_json, p0, x, y, 48, 2,
                       timeout=GROUP_LIMIT)[0]
        z1 = run_ranks(_fit_rank, 8, "zero1", conf_json, p0, x, y, 48, 2,
                       timeout=GROUP_LIMIT)[0]
        np.testing.assert_allclose(dp, z1, atol=1e-5)

    def test_legacy_pad_batch_path_matches_jax(self):
        """device_feed=False: the batch padded by repeating rows, as the
        JAX package's legacy path does (its real gradient weight on the
        duplicates included)."""
        x, y = _ragged(52)
        jnet, conf_json, p0 = _jnet()
        JDP(jnet, jmake_mesh({"data": 8})).fit(
            JListIter(JDataSet(x, y), batch_size=48), epochs=1,
            device_feed=False)
        got = run_ranks(_fit_rank, 8, "dp", conf_json, p0, x, y, 48, 1,
                        device_feed=False, timeout=GROUP_LIMIT)[0]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(jnet.params()), atol=1e-5)

    def test_tp_feed_aligns_to_data_axis_not_device_count(self):
        """tp x dp: the batch splits only over `data`, so buckets align
        to mesh.shape['data'] (2), not the rank count (8)."""
        x, y = _ragged(48)
        jnet, conf_json, p0 = _jnet()
        jtr = JTP(jnet, jmake_mesh({"data": 2, "model": 4}))
        jbuckets = jtr._make_feed(JListIter(JDataSet(x, y), 6),
                                  None).buckets
        with pytest.raises(ValueError) as jerr:
            jtr._make_feed(JDeviceFeed(JListIter(JDataSet(x, y), 6),
                                       buckets=(3, 6)), None)

        def body(rank):
            tr = TensorParallelTrainer(
                _net(conf_json, p0),
                make_mesh({"data": 2, "model": 4}, device="cpu"))
            feed = tr._make_feed(ListDataSetIterator(DataSet(x, y), 6), None)
            explicit = DeviceFeed(ListDataSetIterator(DataSet(x, y), 6),
                                  align=2, device="cpu")
            try:
                tr._make_feed(DeviceFeed(ListDataSetIterator(
                    DataSet(x, y), 6), buckets=(3, 6), device="cpu"), None)
                err = None
            except ValueError as e:
                err = str(e)
            return (feed.buckets, tr._make_feed(explicit, None) is explicit,
                    err)

        for buckets, same, err in run_ranks(body, 8, timeout=GROUP_LIMIT):
            assert buckets == jbuckets and 6 in buckets
            assert all(b % 2 == 0 for b in buckets)
            assert same
            assert err == str(jerr.value)

    def test_explicit_global_feed_trains_like_the_trainers_own(self):
        """A DeviceFeed built without sharding (align=8) hands every rank
        the whole batch; the trainer takes its rows itself."""
        x, y = _ragged()
        _, conf_json, p0 = _jnet()

        def body(rank):
            mesh = make_mesh({"data": 8}, device="cpu")
            net = _net(conf_json, p0)
            feed = DeviceFeed(ListDataSetIterator(DataSet(x, y), 48),
                              align=8, device="cpu")
            DataParallelTrainer(net, mesh).fit(feed, epochs=2)
            return net.params().numpy()

        explicit = run_ranks(body, 8, timeout=GROUP_LIMIT)[0]
        own = run_ranks(_fit_rank, 8, "dp", conf_json, p0, x, y, 48, 2,
                        timeout=GROUP_LIMIT)[0]
        np.testing.assert_array_equal(explicit, own)


class TestGuardedTrainers:
    """A guarded run with one poisoned batch is BIT-identical to a clean
    run with that batch absent: the commit is decided on the all-reduced
    gradients (and over both axes for TP), so every rank skips it."""

    def _stream(self, poison_batch=None, n_batches=6, bs=24, seed=9):
        rng = np.random.RandomState(seed)
        x = rng.rand(n_batches * bs, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n_batches * bs)]
        if poison_batch is not None:
            x[poison_batch * bs:(poison_batch + 1) * bs] = np.nan
        return x, y, bs

    @pytest.mark.parametrize("trainer", ["dp", "zero1", "tp"])
    def test_guarded_skip_equals_clean_without_batch(self, trainer):
        _, conf_json, p0 = _jnet()
        xp, y, bs = self._stream(poison_batch=2)
        xc, yc, _ = self._stream()
        keep = np.ones(len(xc), bool)
        keep[2 * bs:3 * bs] = False

        def body(rank, guarded):
            mesh = make_mesh(MESHES[trainer], device="cpu")
            net = _net(conf_json, p0)
            tr = TRAINERS[trainer](net, mesh)
            if guarded:
                data = ListDataSetIterator(DataSet(xp, y), bs)
                tr.fit(data, epochs=2,
                       guardian=GuardianPolicy(check_every=3))
            else:
                tr.fit(ListDataSetIterator(DataSet(xc[keep], yc[keep]), bs),
                       epochs=2)
            return net.params().numpy()

        guarded = run_ranks(body, 8, True, timeout=GROUP_LIMIT)
        clean = run_ranks(body, 8, False, timeout=GROUP_LIMIT)
        for g in guarded:
            assert np.isfinite(g).all(), \
                "a non-finite update committed on a rank"
            np.testing.assert_array_equal(g, clean[0])

    def test_dp_autosave_checkpoints_mid_run(self, tmp_path):
        from deeplearning4j_tpu_torch.scaleout.checkpoint import (
            DefaultModelSaver, load_checkpoint)

        _, conf_json, p0 = _jnet()
        x, y, bs = self._stream()
        path = str(tmp_path / "dp.ckpt")

        def body(rank):
            mesh = make_mesh({"data": 8}, device="cpu")
            net = _net(conf_json, p0)
            DataParallelTrainer(net, mesh).fit(
                ListDataSetIterator(DataSet(x, y), bs), epochs=1,
                checkpoint_every=4,
                saver=DefaultModelSaver(path, keep_old=False))
            return None

        run_ranks(body, 8, timeout=GROUP_LIMIT)
        net2, info = load_checkpoint(path, device="cpu")
        assert info["iterator_position"] == 4
        assert net2._updater_state is not None

    def test_zero1_autosave_carries_flat_state(self, tmp_path):
        from deeplearning4j_tpu_torch.scaleout.checkpoint import (
            DefaultModelSaver, load_checkpoint)

        _, conf_json, p0 = _jnet()
        x, y, bs = self._stream()
        path = str(tmp_path / "z1.ckpt")

        def body(rank):
            import torch.distributed as dist

            mesh = make_mesh({"data": 8}, device="cpu")
            net = _net(conf_json, p0)
            tr = ShardedUpdateTrainer(net, mesh)
            tr.fit(ListDataSetIterator(DataSet(x, y), bs), epochs=1,
                   checkpoint_every=6,
                   saver=DefaultModelSaver(path, keep_old=False))
            dist.barrier()  # rank 0's save has landed
            restored, info = load_checkpoint(path, device="cpu")
            tr2 = ShardedUpdateTrainer(restored, mesh)
            tr2.restore_flat_state(info["metadata"])
            return (info["metadata"], restored._updater_state is not None,
                    tr2.gathered_flat_state()[0],
                    tr.gathered_flat_state()[0])

        for meta, has_state, h2, h1 in run_ranks(body, 8,
                                                 timeout=GROUP_LIMIT):
            # the optimizer state rides ONCE, in the canonical per-layer
            # form; no padded flat blob in the metadata
            assert "zero1_flat_state" not in meta
            assert has_state
            np.testing.assert_array_equal(h2, h1)
