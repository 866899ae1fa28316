"""Percentiles, spreads and a serving window's rates over synthetic
streams that hold a stall."""

import math

import pytest

from harness import common, serve, traffic


def test_percentile_matches_linear_interpolation():
    xs = list(range(1, 101))
    assert common.percentile(xs, 50) == pytest.approx(50.5)
    assert common.percentile(xs, 95) == pytest.approx(95.05)
    assert common.percentile([3.0], 95) == 3.0
    assert math.isnan(common.percentile([], 95))


def test_percentile_counts_a_missing_request_as_worst():
    xs = [10.0] * 95 + [math.inf] * 5
    assert common.percentile(xs, 90) == 10.0
    assert common.percentile(xs, 99) == math.inf


class _Client:
    """The parts of serve.Client that window_stats reads."""

    def __init__(self, reqs):
        self.done, self.live = reqs, []


def _req(idx, plen, sent, times):
    r = traffic.Request(idx, [1] * plen, len(times))
    r.sent = sent
    r.times = list(times)
    r.seen = len(times)
    return r


def test_window_with_a_stall():
    # window [100, 110): a stall holds every token from 103 to 106
    a = _req(0, 10, 99.0, [100.5, 101.0, 101.5, 106.0, 106.5])
    b = _req(1, 20, 103.0, [106.0, 106.2])      # sent in it, waits out it
    c = _req(2, 30, 109.0, [110.5])             # sent in, answered after
    d = _req(3, 40, 111.0, [111.5])             # sent after the window
    st = serve.window_stats(_Client([a, b, c, d]), 100.0, 110.0)
    assert st["tokens"] == 7
    # the stall costs the rate: 7 tokens over the whole 10 s
    assert st["tokens"] / 10.0 == pytest.approx(0.7)
    assert st["first_prompts"] == [10, 20]
    # decode cursors: prompt length + index - 1
    assert st["decode_cursors"] == [10, 11, 12, 13, 20]
    assert st["sent"] == 2 and st["failed"] == 0


def _rank_trace(each, busy_layers, window=2.0, steps=8):
    return {"nccl_each_s": each, "busy_layers_s": busy_layers,
            "window_s": window, "traced_steps": steps}


def _reader(name):
    return common.metric_reader(name)


def test_allreduce_reads_the_least_wait_of_each_collective():
    # rank 1 reaches the first collective last, rank 0 the second
    ctx = {"rank_traces": [_rank_trace([0.030, 0.0002], 0.1),
                           _rank_trace([0.0003, 0.020], 0.1)]}
    got = _reader("allreduce_ms.dp4")(ctx)
    assert got == pytest.approx(1e3 * (0.0003 + 0.0002) / 8)
    assert _reader("allreduce_ms.dp4")({"rank_traces": [None]}) is None


def test_dp_idle_leaves_the_exchange_out():
    ctx = {"rank_traces": [_rank_trace([0.5], 0.5), _rank_trace([0.1], 1.0)]}
    # busy 25% and 50% of the 2 s without NCCL's kernels
    assert _reader("device_idle.dp4")(ctx) == pytest.approx(62.5)
