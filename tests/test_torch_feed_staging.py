"""The device feed's pinned staging slots (`datasets/device_feed.py`
`StagingPool`).

On the CPU the pool is driven through a fake slot allocator (plain host
tensors) and a fake event that stays pending, as a copy in flight does,
until the pool synchronizes on it (or, for a fast copy, completes as it
is recorded). A feed on the CPU stages nothing, so the feed tests hand
a CPU feed a pool of fakes: each bucket shape gets its own slots, at
most `prefetch + 1` a key, and a second feed reuses the first one's.
The CPU feed itself is unchanged: its batches, counts and `stats()`.

The `cuda` tests need the card: a staged feed over a ragged stream of
two buckets yields batches bit-equal to a fresh pinned copy of each
array, and `DataParallelTrainer` at world 1 (NCCL, in this process)
stays bit-equal to `MultiLayerNetwork.fit` through its own feed. This
file imports nothing of the JAX package, so the card runs it as is.
"""

from __future__ import annotations

import os
import sys
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.datasets import (DataSet, DeviceFeed,
                                               ListDataSetIterator)
from deeplearning4j_tpu_torch.datasets.device_feed import (STAGING_KEYS,
                                                           StagingPool)
from deeplearning4j_tpu_torch.testing.ranks import free_port

CPU = torch.device("cpu")


class FakeEvent:
    """A copy in flight from `record` until `synchronize`; `auto` copies
    finish as they are recorded."""

    def __init__(self, auto: bool):
        self.auto = auto
        self.pending = False
        self.records = 0
        self.syncs = 0

    def record(self, stream=None):
        # a slot's event is recorded right after its fill: pending here
        # means the pool refilled a slot whose copy had not finished
        assert not self.pending, "slot refilled while its copy was pending"
        self.pending = not self.auto
        self.records += 1

    def query(self) -> bool:
        return not self.pending

    def synchronize(self):
        self.pending = False
        self.syncs += 1


class Fakes:
    """A pool whose slots are plain host tensors and FakeEvents."""

    def __init__(self, auto=False, max_keys=STAGING_KEYS):
        self.allocs, self.events = [], []
        self.pool = StagingPool(max_keys, alloc=self._alloc,
                                event=self._event)
        self.auto = auto

    def _alloc(self, shape, dtype):
        t = torch.empty(shape, dtype=dtype)
        self.allocs.append(t)
        return t

    def _event(self):
        e = FakeEvent(self.auto)
        self.events.append(e)
        return e

    def put(self, a, depth):
        out, reused = self.pool.put(a, CPU, depth)
        np.testing.assert_array_equal(out.numpy(), a)
        return reused


def _counts():
    return (telemetry.counter("dl4j_feed_staging_reused").value,
            telemetry.counter("dl4j_feed_staging_allocated").value)


def _ragged(n=20, width=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, width).astype(np.float32),
            np.eye(2, dtype=np.float32)[rng.randint(0, 2, n)])


def _staged_feed(fakes, x, y, bs, **kw):
    """A CPU feed that stages through `fakes`' pool, as a CUDA feed
    stages through the process's."""
    feed = DeviceFeed(ListDataSetIterator(DataSet(x, y), bs), device="cpu",
                      **kw)
    feed._staging = fakes.pool
    return feed


def _arrays(feed):
    return [(fb.features.numpy().copy(), fb.labels.numpy().copy(),
             int(fb.n_valid)) for fb in feed]


class TestStagingPool:
    def test_slot_is_never_refilled_while_its_event_is_pending(self):
        f = Fakes()
        rows = [np.full((4, 3), i, np.float32) for i in range(5)]
        assert [f.put(r, 2) for r in rows] == [False, False, True, True,
                                               True]
        # two slots, each refilled only after the pool waited on it
        assert len(f.allocs) == 2
        assert [e.syncs for e in f.events] == [2, 1]
        assert [e.records for e in f.events] == [3, 2]
        assert f.pool.held() == {(CPU, np.dtype(np.float32), (4, 3)): 2}

    def test_completed_slot_is_reused_and_both_counters_count(self):
        f = Fakes(auto=True)
        reused0, allocated0 = _counts()
        a = np.arange(12, dtype=np.float32).reshape(4, 3)
        assert [f.put(a + i, 3) for i in range(5)] == [False] + [True] * 4
        # a slot whose copy has finished is taken again: one slot, no wait
        assert len(f.allocs) == 1 and f.events[0].syncs == 0
        reused1, allocated1 = _counts()
        assert (reused1 - reused0, allocated1 - allocated0) == (4, 1)

    def test_lru_bound_frees_the_oldest_keys_after_their_events(self):
        f = Fakes(max_keys=2)
        for n in (2, 3, 4):
            f.put(np.ones(n, np.float32), 2)
        keys = [k[2] for k in f.pool.held()]
        assert keys == [(3,), (4,)]
        # the dropped key's slot was waited on before it was let go
        assert [e.syncs for e in f.events] == [1, 0, 0]
        # a key used again moves to the back; the dropped one starts anew
        f.put(np.ones(3, np.float32), 2)
        assert f.put(np.ones(2, np.float32), 2) is False
        assert [k[2] for k in f.pool.held()] == [(3,), (2,)]
        assert len(f.allocs) == 5

    def test_keys_split_by_dtype_and_zero_d_counts_stage(self):
        f = Fakes(auto=True)
        f.put(np.ones((2, 2), np.float32), 1)
        f.put(np.ones((2, 2), np.int64), 1)
        f.put(np.asarray(7, np.int32), 1)
        assert f.put(np.asarray(9, np.int32), 1) is True
        assert sorted(str(k[1]) for k in f.pool.held()) == [
            "float32", "int32", "int64"]

    def test_threads_never_share_a_slot_in_flight(self):
        """More threads than cores put through one pool at once, with a
        short switch interval: no slot is refilled while pending (the
        fake event asserts it), every array arrives whole, each key
        keeps its bound and every put is counted once."""
        f = Fakes()
        n_threads, n_puts, depth = 4 * (os.cpu_count() or 2), 40, 2
        errors, done = [], []

        def work(t):
            try:
                for i in range(n_puts):
                    a = np.full((8, 2 + (t + i) % 3), t * 1000 + i,
                                np.float32)
                    f.put(a, depth)
                done.append(t)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        before = _counts()
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work, args=(t,))
                       for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not errors
        assert not any(th.is_alive() for th in threads)
        assert sorted(done) == list(range(n_threads))
        assert max(f.pool.held().values()) <= depth
        after = _counts()
        assert sum(after) - sum(before) == n_threads * n_puts
        assert after[1] - before[1] == len(f.allocs)


class TestStagedFeed:
    @pytest.mark.parametrize("prefetch", [0, 2])
    def test_each_bucket_shape_gets_its_own_slots_within_prefetch(
            self, prefetch):
        x, y = _ragged()  # batches 8, 8, 4 -> buckets 8, 8, 4
        plain = _arrays(DeviceFeed(
            ListDataSetIterator(DataSet(x, y), 8), buckets=[4, 8],
            device="cpu"))
        f = Fakes()
        feed = _staged_feed(f, x, y, 8, buckets=[4, 8], prefetch=prefetch)
        for _ in range(3):
            got = _arrays(feed)
            assert len(got) == len(plain) == 3
            for (gf, gl, gn), (pf, pl, pn) in zip(got, plain):
                np.testing.assert_array_equal(gf, pf)
                np.testing.assert_array_equal(gl, pl)
                assert gn == pn
        held = {(str(k[1]), k[2]): n for k, n in f.pool.held().items()}
        assert set(held) == {("float32", (8, 3)), ("float32", (8, 2)),
                             ("float32", (4, 3)), ("float32", (4, 2)),
                             ("int32", ())}
        assert max(held.values()) <= prefetch + 1
        s = feed.stats()
        assert s["staging_reused"] + s["staging_allocated"] == 3 * 3 * 3
        assert s["staging_allocated"] == len(f.allocs)

    def test_second_feed_reuses_the_first_feeds_slots(self):
        x, y = _ragged(16)
        f = Fakes(auto=True)
        first = _staged_feed(f, x, y, 8)
        _arrays(first)
        assert first.stats()["staging_allocated"] == 3
        second = _staged_feed(f, x, y, 8)
        _arrays(second)
        s = second.stats()
        assert (s["staging_allocated"], s["staging_reused"]) == (0, 2 * 3)

    def test_sharded_slices_stage_like_the_local_rows(self):
        class Halves:
            """A placement that keeps the second half of the rows."""

            def local(self, a):
                return a[a.shape[0] // 2:]

        x, y = _ragged(16)
        f = Fakes(auto=True)
        feed = _staged_feed(f, x, y, 8, sharding=Halves(), align=2)
        got = _arrays(feed)
        for i, (gf, gl, gn) in enumerate(got):
            np.testing.assert_array_equal(gf, x[8 * i + 4:8 * i + 8])
            np.testing.assert_array_equal(gl, y[8 * i + 4:8 * i + 8])
            assert gn == 8

    def test_cpu_feed_batches_and_stats_are_unchanged(self):
        x, y = _ragged()
        counts0 = _counts()
        feed = DeviceFeed(ListDataSetIterator(DataSet(x, y), 8),
                          buckets=[4, 8], device="cpu")
        assert feed._staging is None
        got = list(feed)
        want = [(x[:8], y[:8], 8), (x[8:16], y[8:16], 8),
                (x[16:], y[16:], 4)]
        for fb, (wf, wl, wn) in zip(got, want):
            np.testing.assert_array_equal(fb.features.numpy(), wf)
            np.testing.assert_array_equal(fb.labels.numpy(), wl)
            assert fb.n_valid.dtype == torch.int32
            assert fb.n_valid.shape == () and int(fb.n_valid) == wn
            assert fb.features.device == CPU
        assert feed.stats() == {"buckets": [4, 8],
                                "bucket_hits": {4: 1, 8: 2},
                                "padded_examples": 0, "batches": 3}
        assert _counts() == counts0


# ------------------------------------------------------------ the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned staging and its events)")
    return torch.device("cuda", 0)


def _pinned_copy(a, device):
    """A fresh pinned copy of each array, the feed's path before the
    staging slots."""
    return torch.from_numpy(np.require(a, requirements=["C", "W"])) \
        .pin_memory().to(device, non_blocking=True)


@pytest.mark.cuda
def test_staged_feed_is_bit_equal_to_fresh_pinned_copies(card):
    rng = np.random.RandomState(3)
    x = rng.rand(80, 784).astype(np.float32)  # batches 64, 16
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 80)]
    feed = DeviceFeed(ListDataSetIterator(DataSet(x, y), 64), device=card)
    got = [list(feed) for _ in range(3)]
    torch.cuda.synchronize(card)
    want = []
    for lo, hi in ((0, 64), (64, 80)):
        want.append((_pinned_copy(x[lo:hi], card),
                     _pinned_copy(y[lo:hi], card),
                     _pinned_copy(np.asarray(hi - lo, np.int32), card)))
    torch.cuda.synchronize(card)
    for epoch in got:
        assert [fb.bucket for fb in epoch] == [64, 16]
        for fb, w in zip(epoch, want):
            for a, b in zip(fb, w):
                assert a.device == card and a.dtype == b.dtype
                assert torch.equal(a, b)
    # five keys (features and labels a bucket, the count), three slots
    # at most each
    s = feed.stats()
    assert s["staging_reused"] + s["staging_allocated"] == 3 * 2 * 3
    assert s["staging_allocated"] <= 5 * 3


def _mlp(device):
    from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder()
            .lr(0.05).momentum(0.5).use_adagrad(True).n_in(784)
            .activation_function("relu")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(1).batch_size(512).compute_dtype("bfloat16")
            .list(3).hidden_layer_sizes([256, 128])
            .override(2, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=10)
            .pretrain(False).build())
    return MultiLayerNetwork(conf, device=device)


@pytest.mark.cuda
def test_dp_at_world_one_stays_bit_equal_to_fit(card):
    from deeplearning4j_tpu_torch.parallel import (DataParallelTrainer,
                                                   make_mesh, multihost)

    rng = np.random.RandomState(4)
    x = rng.rand(1536, 784).astype(np.float32)  # 3 batches of 512
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 1536)]
    torch.manual_seed(0)
    net_fit, net_dp = _mlp(card), _mlp(card)
    net_dp.set_parameters(net_fit.params())
    net_fit.fit(ListDataSetIterator(DataSet(x, y), 512), epochs=2)
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, timeout=60)
    try:
        DataParallelTrainer(net_dp, make_mesh({"data": 1}, device=card)).fit(
            ListDataSetIterator(DataSet(x, y), 512), epochs=2)
    finally:
        multihost.shutdown()
    np.testing.assert_array_equal(net_dp.params().cpu().numpy(),
                                  net_fit.params().cpu().numpy())
