"""The PyTorch port's serving path (paged KV pool, continuous-batching
DecodeLoop, InferenceEngine) held against the JAX package on the CPU.

Logits agree to 1e-4 on the same weights; greedy tokens from the port's
`InferenceEngine.generate` and `DecodeLoop` are IDENTICAL to the JAX
package's `generate_cached` and `DecodeLoop(kernel="gather")`. The port's
"kernel" lane runs the paged kernel's plain version here. The decode
horizon and the SLO tiers are held to the JAX loop driven tick by tick
(tokens, finish reasons, counters), with the page invariant checked
after every tick; the tiers' wire helpers are held to JAX's.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jax_tf
from deeplearning4j_tpu.serving import kv_cache as jax_kv
from deeplearning4j_tpu.serving import paged_kv as jax_paged
from deeplearning4j_tpu.serving import errors as jax_errors
from deeplearning4j_tpu.serving.decode_loop import DecodeLoop as JaxLoop
from deeplearning4j_tpu_torch.models import transformer as tf
from deeplearning4j_tpu_torch.serving import decode_loop, errors, paged_kv
from deeplearning4j_tpu_torch.serving.decode_loop import DecodeLoop
from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
from deeplearning4j_tpu_torch.serving.errors import (Deadline,
                                                     DeadlineExceededError,
                                                     OverloadedError)
from deeplearning4j_tpu_torch.weights import params_from_jax

LOGIT_TOL = 1e-4
JAX_CFG = jax_tf.TransformerConfig(vocab_size=53, d_model=32, n_heads=2,
                                   n_layers=2, d_ff=64, max_len=64,
                                   interpret=True)
CFG = tf.TransformerConfig(vocab_size=53, d_model=32, n_heads=2,
                           n_layers=2, d_ff=64, max_len=64)
PS = 8


@pytest.fixture(scope="module")
def params():
    jp = jax_tf.init_transformer_params(jax.random.PRNGKey(0), JAX_CFG)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


def _prompts(seed=0, lengths=(5, 13, 8, 20)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, (t,)).astype(np.int32)
            for t in lengths]


def _close(a, b, tol=LOGIT_TOL):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=0)


class TestPagedKV:
    def test_helpers_match_jax(self):
        assert paged_kv.prompt_buckets(CFG, PS) == jax_paged.prompt_buckets(
            JAX_CFG, PS)
        assert paged_kv.pages_per_slot(CFG, PS) == jax_paged.pages_per_slot(
            JAX_CFG, PS)
        assert paged_kv.paged_kv_bytes(CFG, 10, PS) == \
            jax_paged.paged_kv_bytes(JAX_CFG, 10, PS)
        pool = paged_kv.init_paged_pool(CFG, 10, PS, device="cpu")
        jpool = jax_paged.init_paged_pool(JAX_CFG, 10, PS)
        assert (pool.n_pages, pool.trash_page, pool.page_size) == (
            jpool.n_pages, jpool.trash_page, jpool.page_size)
        lengths = [0, 7, 8, 40]
        for dense in (False, True):
            assert paged_kv.decode_read_bytes(pool, lengths, 8,
                                              dense=dense) == \
                jax_paged.decode_read_bytes(jpool, lengths, 8, dense=dense)

    def test_prefill_then_decode_steps_match_jax_on_both_lanes(self, params):
        """Teacher-forced: a batched bucketed prefill (one padding row),
        then decode steps with ragged membership (one inactive slot)."""
        jp, tp = params
        n_pages, pps = 24, paged_kv.pages_per_slot(CFG, PS)
        trash = n_pages
        tb = 16
        toks = np.zeros((3, tb), np.int32)
        true_len = np.array([9, 16, 1], np.int32)
        prompts = _prompts(1, (9, 16))
        toks[0, :9], toks[1, :16] = prompts
        page_ids = np.full((3, tb // PS), trash, np.int32)
        page_ids[0] = [3, 7]
        page_ids[1] = [5, 0]
        jpool = jax_paged.init_paged_pool(JAX_CFG, n_pages, PS)
        jlog, jpool = jax_paged.paged_prefill(
            jp, jnp.asarray(toks), jnp.asarray(true_len), jpool,
            jnp.asarray(page_ids), JAX_CFG)
        table = np.full((3, pps), trash, np.int32)
        table[0, :2] = [3, 7]
        table[1, :3] = [5, 0, 11]
        lengths = np.array([9, 16, 0], np.int32)
        active = np.array([True, True, False])
        steps = np.random.default_rng(2).integers(0, CFG.vocab_size, (6, 3))
        for lane in ("gather", "kernel"):
            pool = paged_kv.init_paged_pool(CFG, n_pages, PS, device="cpu")
            log, pool2 = paged_kv.paged_prefill(
                tp, torch.from_numpy(toks), torch.from_numpy(true_len), pool,
                torch.from_numpy(page_ids), CFG)
            assert pool2 is pool  # written in place
            _close(log[:2], np.asarray(jlog)[:2])
            _close(pool.layers[0]["k"][:n_pages],
                   np.asarray(jpool.layers[0]["k"])[:n_pages])
            jp_step, ln = jpool, lengths.copy()
            for s in range(6):
                tok = steps[s].astype(np.int32)
                jlog_s, jp_step = jax_paged.paged_decode_step(
                    jp, jnp.asarray(tok), jp_step, jnp.asarray(table),
                    jnp.asarray(ln), jnp.asarray(active), JAX_CFG,
                    kernel="gather")
                log_s, pool = paged_kv.paged_decode_step(
                    tp, torch.from_numpy(tok), pool, torch.from_numpy(table),
                    torch.from_numpy(ln), torch.from_numpy(active), CFG,
                    kernel=lane)
                _close(log_s[:2], np.asarray(jlog_s)[:2])
                ln = ln + active.astype(np.int32)
            _close(pool.layers[1]["v"][:n_pages],
                   np.asarray(jp_step.layers[1]["v"])[:n_pages])

    def test_cursor_at_window_edge_writes_trash_and_matches_jax(self, params):
        """A cursor AT the window (pos // ps == P) writes to the trash
        page, not into the slot's last real page, and reads every page."""
        jp, tp = params
        pps = paged_kv.pages_per_slot(CFG, PS)
        n_pages = pps + 2
        rng = np.random.default_rng(5)
        kv = rng.normal(size=(CFG.n_layers, 2, n_pages + 1, CFG.n_heads, PS,
                              CFG.d_model // CFG.n_heads)).astype(np.float32)
        table = np.arange(pps, dtype=np.int32)[None, :]
        ln = np.array([pps * PS], np.int32)
        tok = np.array([3], np.int32)
        jpool = jax_paged.PagedKVPool(tuple(
            {"k": jnp.asarray(kv[i, 0]), "v": jnp.asarray(kv[i, 1])}
            for i in range(CFG.n_layers)))
        jlog, _ = jax_paged.paged_decode_step(
            jp, jnp.asarray(tok), jpool, jnp.asarray(table),
            jnp.asarray(ln), jnp.asarray([True]), JAX_CFG, kernel="gather")
        for lane in ("gather", "kernel"):
            pool = paged_kv.PagedKVPool([
                {"k": torch.from_numpy(kv[i, 0].copy()),
                 "v": torch.from_numpy(kv[i, 1].copy())}
                for i in range(CFG.n_layers)])
            log, pool = paged_kv.paged_decode_step(
                tp, torch.from_numpy(tok), pool, torch.from_numpy(table),
                torch.from_numpy(ln), torch.tensor([True]), CFG, kernel=lane)
            _close(log, jlog)
            # every real page unchanged; only the trash page was written
            _close(pool.layers[0]["k"][:n_pages], kv[0, 0, :n_pages], tol=0)

    def test_scatter_layout_matches_value_layout(self):
        """`pool[dest, :, offset, :] = v` with advanced indices split by a
        slice indexes an (S, H, hd) view, as in JAX."""
        pool = torch.zeros((5, 2, 4, 3))
        dest = torch.tensor([1, 3])
        offset = torch.tensor([2, 0])
        val = torch.arange(12, dtype=torch.float32).reshape(2, 2, 3)
        pool[dest, :, offset, :] = val
        assert torch.equal(pool[1, :, 2, :], val[0])
        assert torch.equal(pool[3, :, 0, :], val[1])
        jp = jnp.zeros((5, 2, 4, 3)).at[jnp.asarray([1, 3]), :,
                                        jnp.asarray([2, 0]), :].set(
            jnp.asarray(val.numpy()))
        np.testing.assert_array_equal(pool.numpy(), np.asarray(jp))

    def test_bad_lane_raises(self, params):
        _, tp = params
        pool = paged_kv.init_paged_pool(CFG, 4, PS, device="cpu")
        z = torch.zeros(1, dtype=torch.int32)
        with pytest.raises(ValueError, match="resolve 'auto'"):
            paged_kv.paged_decode_step(tp, z, pool, torch.zeros(
                (1, 8), dtype=torch.int32), z, torch.tensor([True]), CFG,
                kernel="auto")


class TestGreedyTokens:
    def test_engine_generate_matches_jax_generate_cached(self, params):
        jp, tp = params
        prompt = _prompts(3, (7, 7))
        prompt = np.stack(prompt)
        ref = np.asarray(jax_kv.generate_cached(jp, jnp.asarray(prompt),
                                                JAX_CFG, 10))
        eng = InferenceEngine.for_transformer(tp, CFG, device="cpu")
        np.testing.assert_array_equal(eng.generate(prompt, 10), ref)
        assert eng.snapshot()["requests"] == 1

    @pytest.mark.parametrize("lane", ["gather", "kernel"])
    def test_decode_loop_tokens_identical_to_jax_loop(self, params, lane):
        jp, tp = params
        prompts = _prompts(4)
        max_tokens = [6, 9, 12, 5]
        ref_loop = JaxLoop(jp, JAX_CFG, slots=2, page_size=PS,
                           prefix_cache=False, kernel="gather", start=False)
        ref_streams = [ref_loop.submit(p, m)
                       for p, m in zip(prompts, max_tokens)]
        ref_loop.run_until_idle()
        loop = DecodeLoop(tp, CFG, slots=2, page_size=PS, kernel=lane,
                          prefix_cache=False, device="cpu", start=False)
        assert loop.decode_kernel == lane
        streams = [loop.submit(p, m) for p, m in zip(prompts, max_tokens)]
        loop.run_until_idle()
        for s, r in zip(streams, ref_streams):
            assert s.result(0) == r.result(0)
            assert s.finish_reason == r.finish_reason == "max_tokens"
        snap = loop.snapshot()
        assert snap["pages_in_use"] == 0
        assert snap["pages_free"] == loop.n_pages
        assert snap["tokens_streamed"] == sum(max_tokens)
        assert snap["decode_kernel"]["selected"] == lane
        # every token but the prefill's first came from a decode step
        assert snap["prefill_tokens"] == sum(len(p) for p in prompts)

    def test_eos_and_threaded_streams(self, params):
        _, tp = params
        prompts = _prompts(5, (6, 11, 3))
        eng = InferenceEngine.for_transformer(
            tp, CFG, decode_slots=2, page_size=PS, device="cpu")
        try:
            solo = eng.generate_stream(prompts[0], 8).result(60)
            eos = solo[3]
            streams = [eng.generate_stream(p, 8, eos_id=eos)
                       for p in prompts]
            outs = [s.result(60) for s in streams]
            assert outs[0] == solo[:solo.index(eos) + 1]
            assert streams[0].finish_reason == "eos"
            assert list(streams[1].tokens(timeout=5)) == outs[1]
            assert eng.decode_loop.alive
            snap = eng.snapshot()["decode"]
            assert snap["pages_in_use"] == 0
            assert snap["requests"] == 4
        finally:
            eng.close()
        assert not eng.decode_loop.alive


class TestLoopContracts:
    def test_unported_options_raise_not_implemented(self, params):
        """Every `fleet_kv` mode and `role` of the JAX package is taken
        now; an unknown mode or role raises the JAX package's ValueError,
        through the loop and through the engine, and so does a
        prefill-role loop without the full plane."""
        jp, tp = params
        cases = (({"fleet_kv": "summary"}, "fleet_kv must be one of"),
                 ({"role": "router"}, "role must be one of"),
                 ({"role": "prefill", "fleet_kv": "affinity-only"},
                  "prefill-role loop needs"),
                 ({"role": "prefill", "prefix_cache": False},
                  "prefill-role loop needs"))
        for kw, msg in cases:
            with pytest.raises(ValueError, match=msg):
                JaxLoop(jp, JAX_CFG, kernel="gather", start=False, **kw)
            with pytest.raises(ValueError, match=msg):
                DecodeLoop(tp, CFG, device="cpu", start=False, **kw)
            with pytest.raises(ValueError, match=msg):
                InferenceEngine.for_transformer(tp, CFG, decode_slots=2,
                                                device="cpu", **kw)
        for mode in ("on", "affinity-only", "off"):
            for role in ("unified", "decode", "prefill"):
                if role == "prefill" and mode != "on":
                    continue
                loop = DecodeLoop(tp, CFG, device="cpu", start=False,
                                  fleet_kv=mode, role=role)
                assert (loop.fleet_kv, loop.role) == (mode, role)
        assert DecodeLoop(tp, CFG, device="cpu", start=False,
                          prefix_cache=False).fleet_kv == "off"

    def test_scheduler_error_reaches_the_caller(self, params, monkeypatch):
        _, tp = params

        def boom(*a, **kw):
            raise RuntimeError("step exploded")

        monkeypatch.setattr(decode_loop, "paged_decode_step", boom)
        with DecodeLoop(tp, CFG, slots=2, page_size=PS,
                        device="cpu") as loop:
            stream = loop.submit(_prompts(6, (5,))[0], 4)
            with pytest.raises(RuntimeError, match="step exploded"):
                stream.result(60)
            assert stream.finish_reason == "error"
            assert loop.pages_in_use == 0

    def test_shed_cancel_and_deadline(self, params):
        _, tp = params
        loop = DecodeLoop(tp, CFG, slots=1, page_size=PS, max_waiting=2,
                          device="cpu", start=False)
        p = _prompts(7, (5, 5, 5, 5))
        a = loop.submit(p[0], 20)
        b = loop.submit(p[1], 20)    # queue depth 2: at the bound
        with pytest.raises(OverloadedError):
            loop.submit(p[2], 20)
        loop.tick()                  # admits `a`, first decode step
        assert loop.occupied_slots == 1
        a.cancel()
        loop.tick()                  # reaps `a`, admits `b`
        assert a.finish_reason == "cancelled"
        c = loop.submit(p[3], 5, deadline=Deadline.from_ms(20))
        time.sleep(0.05)             # `c` expires while queued behind `b`
        loop.run_until_idle()
        assert b.finish_reason == "max_tokens"
        assert c.finish_reason == "deadline_exceeded"
        with pytest.raises(DeadlineExceededError):
            c.result(0)
        with pytest.raises(DeadlineExceededError):
            loop.submit(p[3], 5, deadline=Deadline.from_ms(0))
        assert loop.snapshot()["shed"] == 1
        assert loop.pages_free == loop.n_pages

    def test_validate_rejects_bad_requests(self, params):
        _, tp = params
        loop = DecodeLoop(tp, CFG, device="cpu", start=False)
        for prompt, n, msg in (([], 3, "empty"), ([1], 0, "max_tokens"),
                               ([1] * 60, 10, "max_len"),
                               ([CFG.vocab_size], 2, "token ids")):
            with pytest.raises(ValueError, match=msg):
                loop.submit(prompt, n)


# ----------------------------------------------------- tick-by-tick drive
def _balance(loop):
    """free + in use + cached-unreferenced == n_pages (either package)."""
    assert (len(loop._free) + loop.pages_in_use + loop._cached_unref()
            == loop.n_pages)


def _drain(loop, max_ticks=500):
    for _ in range(max_ticks):
        with loop._cond:
            if not loop._waiting and loop.occupied_slots == 0:
                return
        loop.tick()
        _balance(loop)
    raise AssertionError("loop did not drain")


def _jax_loop(jp, **kw):
    return JaxLoop(jp, JAX_CFG, page_size=PS, kernel="gather",
                   fleet_kv="off", start=False, **kw)


def _port_loop(tp, lane, **kw):
    return DecodeLoop(tp, CFG, page_size=PS, kernel=lane, device="cpu",
                      start=False, **kw)


class TestHorizon:
    JOBS = ((5, 11), (13, 6), (21, 9), (7, 1), (16, 14))

    def _run(self, loop, jobs, seed):
        rng = np.random.default_rng(seed)
        streams = [loop.submit(rng.integers(0, CFG.vocab_size, t)
                               .astype(np.int32), n) for t, n in jobs]
        _drain(loop)
        snap = loop.snapshot()
        return ([s.result(0) for s in streams],
                [s.finish_reason for s in streams],
                snap["decode_kernel"]["kv_read_bytes"], snap["dispatches"])

    @pytest.mark.parametrize("lane", ["gather", "kernel"])
    def test_horizon4_tokens_equal_horizon1_and_jax(self, params, lane):
        """horizon=4 changes only the dispatch granularity: the tokens of
        horizon 1 and of JAX's horizon 4, JAX's KV read accounting and
        dispatch count, and one step program."""
        jp, tp = params
        ref = self._run(_jax_loop(jp, slots=2, horizon=4), self.JOBS, 10)
        h1 = self._run(_port_loop(tp, lane, slots=2), self.JOBS, 10)
        loop = _port_loop(tp, lane, slots=2, horizon=4)
        got = self._run(loop, self.JOBS, 10)
        assert got == ref
        assert got[:2] == h1[:2]
        assert got[3] < h1[3]
        assert loop.decode_step_programs() == 1
        assert loop.snapshot()["horizon"] == 4

    @pytest.mark.parametrize("horizon", [3, 4])
    def test_generation_to_the_window_edge(self, params, horizon):
        """prompt + max_tokens == max_len with a horizon that does not
        divide the budget: the chain stops at the window edge exactly as
        JAX's does (its overshoot writes go to the trash page)."""
        jp, tp = params
        jobs = ((34, CFG.max_len - 34), (3, 9))
        ref = self._run(_jax_loop(jp, slots=2, horizon=horizon), jobs, 20)
        got = self._run(_port_loop(tp, "kernel", slots=2, horizon=horizon),
                        jobs, 20)
        assert got == ref
        assert got[1] == ["max_tokens", "max_tokens"]

    def test_eos_overshoot_trimmed(self, params):
        jp, tp = params
        rng = np.random.default_rng(21)
        prompt = rng.integers(0, CFG.vocab_size, 9).astype(np.int32)
        plain = _port_loop(tp, "gather", slots=1)
        full = plain.submit(prompt, 20)
        _drain(plain)
        eos = full.result(0)[6]
        outs = []
        for loop in (_jax_loop(jp, slots=1, horizon=4),
                     _port_loop(tp, "gather", slots=1, horizon=4)):
            st = loop.submit(prompt, 20, eos_id=eos)
            _drain(loop)
            outs.append((st.result(0), st.finish_reason,
                         loop.snapshot()["tokens_streamed"]))
        assert outs[0] == outs[1]
        toks = full.result(0)
        assert outs[1][0] == toks[:toks.index(eos) + 1]

    def test_horizon_validation(self, params):
        _, tp = params
        with pytest.raises(ValueError, match="horizon"):
            DecodeLoop(tp, CFG, horizon=0, device="cpu", start=False)


class TestTierHelpers:
    @pytest.mark.parametrize("headers,body", [
        (None, None), ({}, {}), ({"X-Priority": "batch"},
                                 {"priority": "interactive"}),
        ({}, {"priority": "batch"}), ({"X-Priority": " Batch "}, None),
        ({}, {"priority": "bacth"}), ({"X-Priority": "urgent"}, {})])
    def test_parse_tier_matches_jax(self, headers, body):
        try:
            want = jax_errors.parse_tier(headers, body)
        except ValueError as e:
            with pytest.raises(ValueError, match="unknown priority tier"):
                errors.parse_tier(headers, body)
            assert "unknown" in str(e)
            return
        assert errors.parse_tier(headers, body) == want

    def test_constants_and_backlog_retry_match_jax(self):
        assert errors.TIERS == jax_errors.TIERS
        assert (errors.TIER_INTERACTIVE, errors.TIER_BATCH,
                errors.PRIORITY_HEADER) == (
            jax_errors.TIER_INTERACTIVE, jax_errors.TIER_BATCH,
            jax_errors.PRIORITY_HEADER)
        for backlog in (-3, 0, 1, 2, 4, 8, 64, 512, 10_000):
            for per_item in (0.0, 50.0, 250.0):
                assert errors.backlog_retry_ms(backlog, per_item) == \
                    jax_errors.backlog_retry_ms(backlog, per_item)
        assert errors.backlog_retry_ms(4, 250.0) == 1000
        assert decode_loop._TIER_ITEM_MS == {"interactive": 50.0,
                                             "batch": 250.0}


def _tier_record(loop, streams):
    snap = loop.snapshot()
    tiers = snap["tiers"]
    return {"tokens": [list(s._generated) for s in streams],
            "reasons": [s.finish_reason for s in streams],
            "preemptions": tiers["preemptions"],
            "occupied": tiers["occupied"], "waiting": tiers["waiting"],
            "requests": tiers["requests"], "shed": tiers["shed"],
            "hits": snap["prefix_cache"]["hits"],
            "pages_cached": snap["prefix_cache"]["pages_cached"],
            "admission_waits": snap["admission_waits"]}


def _ticks(loop, n):
    for _ in range(n):
        loop.tick()
        _balance(loop)


def _tier_prompts(seed, n, t=17):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, t).astype(np.int32)
            for _ in range(n)]


def tier_fill_then_preempt(loop):
    """Batch fills every idle slot; an interactive arrival preempts the
    batch slot with the fewest tokens emitted, whose prompt pages seed
    the cache; the interactive stream completes; a resubmitted victim
    prompt hits the cache."""
    prompts = _tier_prompts(0, 5)
    batch = [loop.submit(prompts[0], 30, tier="batch")]
    _ticks(loop, 2)                   # the first batch stream is ahead
    batch += [loop.submit(p, 30, tier="batch") for p in prompts[1:4]]
    _ticks(loop, 2)
    recs = [_tier_record(loop, batch)]
    assert recs[0]["occupied"]["batch"] == 4
    inter = loop.submit(prompts[4], 6)
    _ticks(loop, 1)
    recs.append(_tier_record(loop, batch + [inter]))
    assert recs[1]["preemptions"] == 1
    reasons = [s.finish_reason for s in batch]
    assert reasons.count("preempted") == 1
    assert reasons.index("preempted") != 0  # the oldest emitted most
    assert recs[1]["pages_cached"] >= 2
    _drain(loop)
    recs.append(_tier_record(loop, batch + [inter]))
    assert inter.finish_reason == "max_tokens"
    victim = batch[reasons.index("preempted")]
    again = loop.submit(victim.prompt, 4, tier="batch")
    _drain(loop)
    recs.append(_tier_record(loop, batch + [inter, again]))
    assert recs[-1]["hits"] >= 1
    assert loop.pages_in_use == 0
    return recs


def tier_admission_order(loop):
    """One slot: interactive arrivals go ahead of earlier batch ones,
    FIFO within each tier."""
    prompts = _tier_prompts(1, 5, t=5)
    order = []
    streams = [loop.submit(prompts[0], 3, tier="batch"),
               loop.submit(prompts[1], 3, tier="batch"),
               loop.submit(prompts[2], 3),
               loop.submit(prompts[3], 3, tier="batch"),
               loop.submit(prompts[4], 3)]
    for _ in range(100):
        with loop._cond:
            if not loop._waiting and loop.occupied_slots == 0:
                break
        loop.tick()
        _balance(loop)
        for i, s in enumerate(streams):
            if s.done and i not in order:
                order.append(i)
    assert order == [2, 4, 0, 1, 3]
    return [_tier_record(loop, streams), order]


def tier_share_cap(loop):
    """4 slots, batch_share 0.5: while interactive work is live batch
    holds at most 2 slots; once it is gone batch soaks every slot."""
    prompts = _tier_prompts(2, 6, t=6)
    inter = loop.submit(prompts[0], 12)
    batch = [loop.submit(p, 20, tier="batch") for p in prompts[1:6]]
    _ticks(loop, 1)
    recs = [_tier_record(loop, [inter] + batch)]
    assert recs[0]["occupied"] == {"interactive": 1, "batch": 2}
    _ticks(loop, 14)                  # the interactive stream finishes
    recs.append(_tier_record(loop, [inter] + batch))
    assert inter.finish_reason == "max_tokens"
    assert recs[1]["occupied"]["batch"] == 4
    _drain(loop)
    recs.append(_tier_record(loop, [inter] + batch))
    return recs


def tier_batch_shed(loop):
    """max_waiting 4 -> batch_max_waiting 2: the batch lane sheds first,
    with the tier and a Retry-After from the batch backlog, while
    interactive admission stays open."""
    prompts = _tier_prompts(3, 8, t=6)
    held = [loop.submit(p, 10, tier="batch") for p in prompts[:2]]
    _ticks(loop, 1)                   # both slots busy
    queued = [loop.submit(p, 4, tier="batch") for p in prompts[2:4]]
    with pytest.raises((OverloadedError,
                        jax_errors.OverloadedError)) as shed:
        loop.submit(prompts[4], 4, tier="batch")
    err = shed.value
    inter = [loop.submit(p, 3) for p in prompts[5:8]]
    recs = [_tier_record(loop, held + queued + inter),
            (err.tier, err.retry_after_ms, err.retry_after_s)]
    assert err.tier == "batch"
    assert err.retry_after_ms == jax_errors.backlog_retry_ms(3, 250.0)
    _drain(loop)
    recs.append(_tier_record(loop, held + queued + inter))
    return recs


TIER_SCENARIOS = {
    "fill_then_preempt": (tier_fill_then_preempt, {"slots": 4}),
    "admission_order": (tier_admission_order, {"slots": 1}),
    "share_cap": (tier_share_cap, {"slots": 4}),
    "batch_shed": (tier_batch_shed, {"slots": 2, "max_waiting": 4}),
}


@pytest.fixture(scope="module")
def jax_tier_runs(params):
    jp, _ = params
    cache = {}

    def get(name):
        if name not in cache:
            fn, kw = TIER_SCENARIOS[name]
            cache[name] = fn(_jax_loop(jp, **kw))
        return cache[name]

    return get


class TestTiers:
    @pytest.mark.parametrize("lane", ["gather", "kernel"])
    @pytest.mark.parametrize("name", list(TIER_SCENARIOS))
    def test_scenario_matches_jax(self, params, jax_tier_runs, name, lane):
        _, tp = params
        fn, kw = TIER_SCENARIOS[name]
        assert fn(_port_loop(tp, lane, **kw)) == jax_tier_runs(name)

    def test_tier_validation_and_defaults(self, params):
        _, tp = params
        loop = DecodeLoop(tp, CFG, slots=8, device="cpu", start=False)
        snap = loop.snapshot()["tiers"]
        assert snap["batch_share"] == 0.5 and snap["batch_slot_cap"] == 4
        assert snap["batch_max_waiting"] is None
        with pytest.raises(ValueError, match="unknown tier"):
            loop.submit([1, 2], 2, tier="bulk")
        for bad in (0.0, 1.5):
            with pytest.raises(ValueError, match="batch_share"):
                DecodeLoop(tp, CFG, batch_share=bad, device="cpu",
                           start=False)
        with pytest.raises(ValueError, match="batch_max_waiting"):
            DecodeLoop(tp, CFG, batch_max_waiting=-1, device="cpu",
                       start=False)


class TestEngineOptions:
    def test_for_transformer_forwards_every_loop_option(self, params):
        _, tp = params
        eng = InferenceEngine.for_transformer(
            tp, CFG, decode_slots=3, page_size=PS, kv_pages=40,
            max_waiting=6, prefix_cache=False, decode_kernel="kernel",
            horizon=2, batch_share=0.34, batch_max_waiting=1, device="cpu",
            start=False)
        loop = eng.decode_loop
        assert (loop.slots, loop.page_size, loop.n_pages, loop.horizon) == (
            3, PS, 40, 2)
        assert loop.max_waiting == 6 and loop.batch_max_waiting == 1
        assert not loop.prefix_cache_enabled
        assert loop.decode_kernel == "kernel"
        assert loop._batch_slot_cap == 1
        snap = eng.snapshot()["decode"]
        for key in ("tiers", "prefix_cache", "speculation", "fleet_kv",
                    "decode_step_programs"):
            assert key in snap
        with pytest.raises(ValueError, match="mutually exclusive"):
            InferenceEngine.for_transformer(tp, CFG, decode_slots=2,
                                            horizon=2, speculation=2,
                                            device="cpu")

    def test_engine_defaults_match_jax(self):
        import inspect

        from deeplearning4j_tpu.serving.engine import \
            InferenceEngine as JaxEngine
        for name in ("for_transformer", "start_decode_loop"):
            ours = inspect.signature(getattr(InferenceEngine, name))
            ref = inspect.signature(getattr(JaxEngine, name))
            for pname, p in ours.parameters.items():
                if pname in ref.parameters:
                    assert p.default == ref.parameters[pname].default, pname
        assert inspect.signature(InferenceEngine.start_decode_loop) \
            .parameters["fleet_kv"].default == "on"
        assert inspect.signature(DecodeLoop).parameters[
            "fleet_kv"].default == inspect.signature(JaxLoop).parameters[
            "fleet_kv"].default == "on"

    def test_generate_stream_speculation_opt_out(self, params):
        jp, tp = params
        prompts = _prompts(8, (9, 12))
        eng = InferenceEngine.for_transformer(
            tp, CFG, decode_slots=2, page_size=PS, speculation=3,
            device="cpu")
        try:
            a = eng.generate_stream(prompts[0], 10).result(120)
            b = eng.generate_stream(prompts[0], 10,
                                    speculation=False).result(120)
            spec = eng.snapshot()["decode"]["speculation"]
        finally:
            eng.close()
        assert a == b
        assert spec["enabled"] and spec["k"] == 3
        ref = np.asarray(jax_kv.generate_cached(
            jp, jnp.asarray(prompts[0][None]), JAX_CFG, 10))[0]
        assert a == ref[len(prompts[0]):].tolist()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the captured step runs only "
                    "there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("horizon,spec", [(1, 0), (4, 0), (1, 3)])
def test_graph_step_matches_eager_step_on_card(card, horizon, spec):
    """The captured step (and verify) graphs give the eager step's tokens
    on the card: one graph plain, two with speculation. The model has the
    kernels' head dim (64) and the port's own initialiser (the JAX
    package is not on the card)."""
    cfg = tf.TransformerConfig(vocab_size=53, d_model=128, n_heads=2,
                               n_layers=2, d_ff=64, max_len=64)
    tp = tf.init_transformer_params(0, cfg, device=card)
    prompts = _prompts(9, (5, 13, 8, 20))
    outs = []
    for capture in (True, False):
        loop = DecodeLoop(tp, cfg, slots=2, page_size=PS, horizon=horizon,
                          speculation=spec, device=card, start=False)
        loop._capture = capture
        streams = [loop.submit(p, 9) for p in prompts]
        _drain(loop)
        outs.append([s.result(0) for s in streams])
        if capture:
            # speculation captures the verify and step graphs up front
            assert sorted(loop._graphs) == (["step", "verify"] if spec
                                            else ["step"])
            assert loop.decode_step_programs() == (2 if spec else 1)
            # each graph records K4 once a layer a column; its replays
            # are counted by the loop, never by the wrapper
            per = {"step": horizon * cfg.n_layers,
                   "verify": (spec + 1) * cfg.n_layers}
            for name, g in loop._graphs.items():
                assert g.launches == {"paged_decode": per[name],
                                      "flash_fwd": 0}
            assert loop.graph_launches()["paged_decode"] == sum(
                g.replays * per[n] for n, g in loop._graphs.items()) > 0
    assert outs[0] == outs[1]
