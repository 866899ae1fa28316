"""The spans of the port's hot paths (telemetry/trace.py) on the CPU: the
decode loop's tick, the device feed and the data-parallel step.

- DecodeLoop, driven tick by tick: every span is on the thread that
  ticks; `decode.tick` is the only root, `decode.admit`, `decode.grant`,
  `decode.upload`, `decode.replay` and `decode.emit` its children in that
  order, each `decode.prefill` inside a `decode.admit` with its `rows`,
  `bucket`, `tokens` and `rids`; `decode.replay` is the region
  `dl4j_decode_step_seconds` times, to the nanosecond; the served tokens
  are the same with tracing on and off.
- DataParallelTrainer at world 1 over its device feed: `dp.grads`,
  `dp.allreduce` and `dp.update` nest in order under each
  `parallel_train_step`, `feed.fetch` and `feed.put` run between the
  steps, each `feed.put` over `feed.stage`, `feed.copy` three times (the
  features, labels and count), and the parameters are bit-equal with
  tracing on and off.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.datasets import (DataSet, DeviceFeed,
                                               ListDataSetIterator)
from deeplearning4j_tpu_torch.models import transformer as tf
from deeplearning4j_tpu_torch.serving.decode_loop import DecodeLoop
from deeplearning4j_tpu_torch.telemetry import trace
from deeplearning4j_tpu_torch.testing.ranks import run_ranks

CFG = tf.TransformerConfig(vocab_size=53, d_model=32, n_heads=2,
                           n_layers=2, d_ff=64, max_len=64)
PS = 8
TICK_CHILDREN = ("decode.admit", "decode.grant", "decode.upload",
                 "decode.replay", "decode.emit")


def _end(s):
    return s.start_ns + s.dur_ns


def _inside(child, parent) -> bool:
    return parent.start_ns <= child.start_ns and _end(child) <= _end(parent)


def _parent(child, spans):
    """The span one level up on the child's thread that holds it."""
    (p,) = [s for s in spans if s.depth == child.depth - 1
            and s.thread_id == child.thread_id and _inside(child, s)]
    return p


@pytest.fixture(scope="module")
def params():
    return tf.init_transformer_params(0, CFG, device="cpu")


def _serve(params, tracing: bool):
    """Two waves through one loop ticked inline: four cold prompts, then
    two that share two full pages with a retired one (a warm tail)."""
    rng = np.random.default_rng(3)
    first = [rng.integers(0, CFG.vocab_size, (n,)) for n in (5, 13, 20, 9)]
    second = [np.concatenate([first[2][:2 * PS],
                              rng.integers(0, CFG.vocab_size, (n,))])
              for n in (3, 6)]
    loop = DecodeLoop(params, CFG, slots=2, page_size=PS, device="cpu",
                      start=False)
    tracer = trace.start_tracing() if tracing else None
    try:
        streams = [loop.submit(p, m) for p, m in zip(first, (6, 4, 7, 5))]
        loop.run_until_idle()
        streams += [loop.submit(p, 5) for p in second]
        loop.run_until_idle()
    finally:
        trace.stop_tracing()
    out = [s.result(0) for s in streams]
    snap = loop.snapshot()
    loop.close()
    return out, streams, snap, loop, tracer


class TestDecodeLoopSpans:
    def test_tick_spans_nest_and_tokens_do_not_change(self, params):
        off, _, _, _, _ = _serve(params, False)
        on, streams, snap, loop, tracer = _serve(params, True)
        assert on == off
        spans = tracer.spans()
        assert {s.thread_id for s in spans} == {threading.get_ident()}
        ticks = [s for s in spans if s.depth == 0]
        assert {s.name for s in ticks} == {"decode.tick"}
        children = [s for s in spans if s.depth == 1]
        assert {s.name for s in children} <= set(TICK_CHILDREN)
        by_tick = {id(t): [] for t in ticks}
        for c in children:
            by_tick[id(_parent(c, spans))].append(c.name)
        dispatched = 0
        for names in by_tick.values():
            assert names[0] == "decode.admit"
            if "decode.replay" in names:
                dispatched += 1
                assert names == list(TICK_CHILDREN)
        replays = [s for s in spans if s.name == "decode.replay"]
        assert dispatched == len(replays) == snap["dispatches"]
        # one pair of clock readings feeds the span and the histogram
        assert list(loop.step_seconds) == [s.dur_ns * 1e-9 for s in replays]

    def test_prefill_spans_name_their_groups(self, params):
        _, streams, snap, _, tracer = _serve(params, True)
        spans = tracer.spans()
        prefills = [s for s in spans if s.name == "decode.prefill"]
        assert prefills and all(s.depth == 2 for s in prefills)
        assert {_parent(s, spans).name for s in prefills} == {"decode.admit"}
        rids = [r for s in prefills for r in s.args["rids"]]
        assert sorted(rids) == sorted(s.rid for s in streams) == \
            list(range(len(streams)))
        assert sum(s.args["tokens"] for s in prefills) == \
            snap["prefill_tokens"]
        for s in prefills:
            assert set(s.args) == {"rows", "bucket", "tokens", "rids"}
            assert s.args["rows"] == len(s.args["rids"])
            assert s.args["bucket"][0] >= s.args["rows"]
        # the second wave's prompts ride a warm tail: (rows, cached
        # pages, tail tokens)
        warm = [s for s in prefills if len(s.args["bucket"]) == 3]
        assert warm and all(min(s.args["rids"]) >= 4 for s in warm)
        assert sum(s.args["tokens"] for s in warm) == 3 + 6


def _assert_put_children(spans, puts):
    """Each `feed.put` holds, one level down and in order, a
    `feed.stage` and a `feed.copy` for each of the features, labels and
    count, and every such span lies in a put."""
    kids = [s for s in spans if s.name in ("feed.stage", "feed.copy")]
    for put in puts:
        inner = sorted((s for s in kids if _inside(s, put)),
                       key=lambda s: s.start_ns)
        assert [s.name for s in inner] == ["feed.stage", "feed.copy"] * 3
        assert all(s.depth == put.depth + 1 for s in inner)
    assert len(kids) == 6 * len(puts)


def _dp_rank(rank, tracing):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import (DataParallelTrainer,
                                                   make_mesh)
    from tests.test_multilayer import mlp_conf

    torch.manual_seed(0)
    net = MultiLayerNetwork(mlp_conf(lr=0.1, iters=1), device="cpu")
    rng = np.random.RandomState(5)
    x = rng.rand(40, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 40)]
    tr = DataParallelTrainer(net, make_mesh({"data": 1}, device="cpu"))
    tracer = trace.start_tracing() if tracing else None
    try:
        tr.fit(ListDataSetIterator(DataSet(x, y), 16), epochs=2)
    finally:
        trace.stop_tracing()
    return (net.params().numpy(),
            tracer.spans() if tracer is not None else None)


class TestTrainingSpans:
    def test_dp_step_spans_nest_and_parameters_do_not_change(self):
        (p_off, _), = run_ranks(_dp_rank, 1, False, timeout=120)
        (p_on, spans), = run_ranks(_dp_rank, 1, True, timeout=120)
        np.testing.assert_array_equal(p_on, p_off)
        steps = [s for s in spans if s.name == "parallel_train_step"]
        assert len(steps) == 2 * 3  # 2 epochs of 40 rows in 16s
        assert all(s.depth == 0 for s in steps)
        for step in steps:
            inner = sorted((s for s in spans if s.depth == 1
                            and _inside(s, step)),
                           key=lambda s: s.start_ns)
            assert [s.name for s in inner] == ["dp.grads", "dp.allreduce",
                                               "dp.update"]
        feed = [s for s in spans if s.name in ("feed.fetch", "feed.put")]
        assert all(s.depth == 0 for s in feed)
        # a fetch a batch and the one that finds the end, a put a batch
        assert sum(s.name == "feed.fetch" for s in feed) == 2 * (3 + 1)
        puts = [s for s in feed if s.name == "feed.put"]
        assert len(puts) == 2 * 3
        _assert_put_children(spans, puts)
        assert {s.name for s in spans} == {
            "parallel_train_step", "dp.grads", "dp.allreduce", "dp.update",
            "feed.fetch", "feed.put", "feed.stage", "feed.copy"}

    def test_feed_spans_cover_each_batch_and_fast_forward(self):
        x = np.arange(30, dtype=np.float32).reshape(10, 3)
        y = np.eye(2, dtype=np.float32)[np.arange(10) % 2]
        feed = DeviceFeed(ListDataSetIterator(DataSet(x, y), 4),
                          device="cpu")
        plain = [fb.features.numpy() for fb in feed]
        feed.fast_forward(1)
        tracer = trace.start_tracing()
        try:
            got = [fb.features.numpy() for fb in feed]
        finally:
            trace.stop_tracing()
        assert len(plain) == 3 and len(got) == 2
        for a, b in zip(got, plain[1:]):
            np.testing.assert_array_equal(a, b)
        names = [s.name for s in sorted(tracer.spans(),
                                        key=lambda s: s.start_ns)]
        # the skipped batch is neither fetched in a span nor put
        assert names.count("feed.fetch") == 3
        assert names.count("feed.put") == 2
        _assert_put_children(tracer.spans(), [
            s for s in tracer.spans() if s.name == "feed.put"])
        assert feed.cursor == 3
