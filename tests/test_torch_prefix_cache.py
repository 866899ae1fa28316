"""The PyTorch port's prefix cache (PrefixIndex, copy_page,
paged_prefill_ctx, the DecodeLoop's refcounted pages and copy-on-write)
held against the JAX package on the CPU.

- `PrefixIndex`: the JAX package's own index cases, run on both copies.
- `copy_page` / `paged_prefill_ctx`: logits within 1e-4 of JAX's; pages
  the call does not write are bit-equal (a fork copies exact bytes),
  pages it writes (K/V of the tail, float32 products summed in another
  order) within 1e-6.
- The loop: each scenario of the JAX package's `tests/test_prefix_cache.py`
  runs on both packages' `DecodeLoop(start=False)` (JAX: kernel="gather",
  fleet_kv="off"; the port on both of its lanes), and gives identical
  tokens, finish reasons, prefill tokens and hits / misses / forks /
  evictions, with the page invariant (free + in use + cached-unreferenced
  == n_pages) checked after every tick.
"""

from __future__ import annotations

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jax_tf
from deeplearning4j_tpu.serving import paged_kv as jax_paged
from deeplearning4j_tpu.serving.decode_loop import DecodeLoop as JaxLoop
from deeplearning4j_tpu.serving.prefix_cache import \
    PrefixIndex as JaxPrefixIndex
from deeplearning4j_tpu_torch.models import transformer as tf
from deeplearning4j_tpu_torch.serving import paged_kv
from deeplearning4j_tpu_torch.serving.decode_loop import DecodeLoop
from deeplearning4j_tpu_torch.serving.prefix_cache import PrefixIndex
from deeplearning4j_tpu_torch.weights import params_from_jax

LOGIT_TOL = 1e-4
#: K/V the call computes: float32 products summed in another order
WRITTEN_TOL = 1e-6
JAX_CFG = jax_tf.TransformerConfig(vocab_size=17, d_model=32, n_heads=2,
                                   n_layers=2, d_ff=64, max_len=64,
                                   interpret=True)
CFG = tf.TransformerConfig(vocab_size=17, d_model=32, n_heads=2,
                           n_layers=2, d_ff=64, max_len=64)
PS = 8
LANES = ("gather", "kernel")
INDEXES = pytest.mark.parametrize("index", [PrefixIndex, JaxPrefixIndex],
                                  ids=["port", "jax"])


@pytest.fixture(scope="module")
def params():
    jp = jax_tf.init_transformer_params(jax.random.PRNGKey(0), JAX_CFG)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


def _prompt(rng, t):
    return rng.randint(0, CFG.vocab_size, (t,)).astype(np.int32)


# ------------------------------------------------------ index unit tests
class TestPrefixIndex:
    @INDEXES
    def test_match_full_chunks_only(self, index):
        idx = index(page_size=4)
        idx.insert([1, 2, 3, 4, 5, 6, 7, 8], [10, 11])
        assert idx.match([1, 2, 3, 4, 5, 6, 7, 8]) == [10, 11]
        assert idx.match([1, 2, 3, 4, 5, 6]) == [10]
        assert idx.match([1, 2, 3, 4, 9, 9, 9, 9]) == [10]
        assert idx.match([9, 2, 3, 4]) == []
        assert idx.match([1, 2, 3]) == []
        assert len(idx) == 2

    @INDEXES
    def test_insert_keeps_existing_pages(self, index):
        idx = index(page_size=2)
        assert idx.insert([1, 2, 3, 4], [7, 8]) == 2
        assert idx.insert([1, 2, 3, 4], [20, 21]) == 0
        assert idx.match([1, 2, 3, 4]) == [7, 8]
        assert idx.insert([1, 2, 9, 9], [7, 30]) == 1
        assert idx.match([1, 2, 9, 9]) == [7, 30]
        assert len(idx) == 3

    @INDEXES
    def test_insert_skip_stops_the_walk(self, index):
        idx = index(page_size=2)
        assert idx.insert([1, 2, 3, 4, 5, 6], [7, 8, 9], skip={8}) == 1
        assert idx.match([1, 2, 3, 4]) == [7]
        assert not idx.owns(8) and not idx.owns(9)

    @INDEXES
    def test_evict_lru_leaf_only(self, index):
        idx = index(page_size=2)
        idx.insert([1, 2, 3, 4], [7, 8])
        idx.insert([5, 6], [9])
        idx.match([5, 6])
        assert idx.evict_lru(lambda p: True) == 8
        assert idx.evict_lru(lambda p: True) == 7
        assert idx.evict_lru(lambda p: p != 9) is None
        assert idx.evict_lru(lambda p: True) == 9
        assert len(idx) == 0 and idx.match([1, 2]) == []

    @INDEXES
    def test_validates_page_size(self, index):
        with pytest.raises(ValueError, match="page_size"):
            index(0)

    def test_sequences_heads_and_snapshot_match_jax(self):
        """The same insert/match/evict history gives the same corpus
        (`iter_sequences`), head paths and snapshot in both copies."""
        rng = np.random.RandomState(9)
        port, ref = PrefixIndex(3), JaxPrefixIndex(3)
        for step in range(40):
            toks = rng.randint(0, 4, (rng.randint(3, 13),)).tolist()
            pages = rng.randint(0, 60, (len(toks) // 3,)).tolist()
            for idx in (port, ref):
                if step % 5 == 4:
                    idx.evict_lru(lambda p: p % 2 == 0)
                elif step % 3:
                    idx.insert(toks, pages, skip={pages[-1]} if step % 7 == 0
                               else ())
                else:
                    idx.match(toks)
            assert list(port.iter_sequences()) == list(ref.iter_sequences())
            assert list(port.head_paths(2)) == list(ref.head_paths(2))
            assert port.snapshot() == ref.snapshot()
            assert sorted(port.pages()) == sorted(ref.pages())


# ------------------------------------------------- device functions
def _pools(n_pages, seed):
    rng = np.random.default_rng(seed)
    kv = rng.normal(size=(CFG.n_layers, 2, n_pages + 1, CFG.n_heads, PS,
                          CFG.d_model // CFG.n_heads)).astype(np.float32)
    jpool = jax_paged.PagedKVPool(tuple(
        {"k": jnp.asarray(kv[i, 0]), "v": jnp.asarray(kv[i, 1])}
        for i in range(CFG.n_layers)))
    pool = paged_kv.PagedKVPool([
        {"k": torch.from_numpy(kv[i, 0].copy()),
         "v": torch.from_numpy(kv[i, 1].copy())}
        for i in range(CFG.n_layers)])
    return kv, jpool, pool


def _check_pool(pool, jpool, kv, written):
    """Pages in `written` within WRITTEN_TOL of JAX's; every other page
    bit-equal to JAX's and to what it held before."""
    for i, (layer, jlayer) in enumerate(zip(pool.layers, jpool.layers)):
        for j, name in enumerate(("k", "v")):
            got = layer[name].numpy()
            ref = np.asarray(jlayer[name])
            n = got.shape[0] - 1  # the trash page's bytes are unspecified
            keep = [p for p in range(n) if p not in written]
            np.testing.assert_array_equal(got[keep], ref[keep])
            np.testing.assert_array_equal(got[keep], kv[i, j, keep])
            if written:
                np.testing.assert_allclose(got[sorted(written)],
                                           ref[sorted(written)],
                                           atol=WRITTEN_TOL, rtol=0)


class TestDeviceFunctions:
    def test_copy_page_matches_jax_bit_for_bit(self):
        kv, jpool, pool = _pools(6, 0)
        for src, dst in ((1, 4), (4, 0), (5, 5)):
            jpool = jax_paged.copy_page(jpool, jnp.asarray(src, jnp.int32),
                                        jnp.asarray(dst, jnp.int32))
            assert paged_kv.copy_page(pool, src, dst) is pool  # in place
        for layer, jlayer in zip(pool.layers, jpool.layers):
            for name in ("k", "v"):
                np.testing.assert_array_equal(layer[name].numpy(),
                                              np.asarray(jlayer[name]))
        np.testing.assert_array_equal(pool.layers[1]["v"][0].numpy(),
                                      kv[1, 1, 1])

    @pytest.mark.parametrize("case", ["one_ctx_page", "ragged_batch"])
    def test_prefill_ctx_matches_jax(self, params, case):
        """Warm tails over cached pages (a padding row, trash-padded ctx
        tables, a tail shorter than its bucket): logits within 1e-4,
        the tail pages close, every other page bit-equal."""
        jp, tp = params
        n_pages, trash = 20, 20
        kv, jpool, pool = _pools(n_pages, 1)
        rng = np.random.default_rng(2)
        if case == "one_ctx_page":
            toks = rng.integers(0, CFG.vocab_size, (1, 8)).astype(np.int32)
            tl = np.array([5], np.int32)
            pids = np.array([[9]], np.int32)
            ctab = np.array([[3]], np.int32)
            clen = np.array([8], np.int32)
            written, real = {9}, 1
        else:
            toks = rng.integers(0, CFG.vocab_size, (4, 16)).astype(np.int32)
            tl = np.array([11, 16, 3, 1], np.int32)
            pids = np.array([[5, 6], [7, 8], [10, trash], [trash, trash]],
                            np.int32)
            ctab = np.array([[1, 2, 3, trash], [4, trash, trash, trash],
                             [11, 12, 13, 14], [trash] * 4], np.int32)
            clen = np.array([24, 8, 32, 0], np.int32)
            written, real = {5, 6, 7, 8, 10}, 3
        t = [torch.from_numpy(a) for a in (toks, tl, pids, ctab, clen)]
        jlog, jpool = jax_paged.paged_prefill_ctx(
            jp, *(jnp.asarray(a) for a in (toks, tl)), jpool,
            *(jnp.asarray(a) for a in (pids, ctab, clen)), JAX_CFG)
        log, out = paged_kv.paged_prefill_ctx(tp, t[0], t[1], pool, t[2],
                                              t[3], t[4], CFG)
        assert out is pool
        np.testing.assert_allclose(log[:real].numpy(),
                                   np.asarray(jlog)[:real], atol=LOGIT_TOL,
                                   rtol=0)
        _check_pool(pool, jpool, kv, written)

    def test_prefill_ctx_equals_cold_prefill_of_the_whole_prompt(self,
                                                                 params):
        """A tail prefilled over the cached pages of its own head gives
        the cold prefill's last logits (to 1e-4) and the same tail K/V."""
        _, tp = params
        rng = np.random.default_rng(3)
        prompt = rng.integers(0, CFG.vocab_size, (21,)).astype(np.int32)
        cold = paged_kv.init_paged_pool(CFG, 8, PS, device="cpu")
        toks = np.zeros((1, 32), np.int32)
        toks[0, :21] = prompt
        lc, cold = paged_kv.paged_prefill(
            tp, torch.from_numpy(toks), torch.tensor([21], dtype=torch.int32),
            cold, torch.tensor([[0, 1, 2, 8]], dtype=torch.int32), CFG)
        warm = paged_kv.init_paged_pool(CFG, 8, PS, device="cpu")
        toks = np.zeros((1, 16), np.int32)
        toks[0, :16] = prompt[:16]
        paged_kv.paged_prefill(tp, torch.from_numpy(toks),
                               torch.tensor([16], dtype=torch.int32), warm,
                               torch.tensor([[0, 1]], dtype=torch.int32), CFG)
        tail = np.zeros((1, 8), np.int32)
        tail[0, :5] = prompt[16:]
        lw, warm = paged_kv.paged_prefill_ctx(
            tp, torch.from_numpy(tail), torch.tensor([5], dtype=torch.int32),
            warm, torch.tensor([[2]], dtype=torch.int32),
            torch.tensor([[0, 1]], dtype=torch.int32),
            torch.tensor([16], dtype=torch.int32), CFG)
        torch.testing.assert_close(lw, lc, atol=LOGIT_TOL, rtol=0)
        for a, b in zip(warm.layers, cold.layers):
            torch.testing.assert_close(a["k"][2, :, :5], b["k"][2, :, :5],
                                       atol=1e-5, rtol=0)


# ----------------------------------------------------- loop scenarios
def _balance(loop):
    """The three-way page invariant (either package's loop)."""
    in_use = loop.pages_in_use
    free = len(loop._free)
    cached_unref = loop._cached_unref()
    assert in_use + free + cached_unref == loop.n_pages, (
        in_use, free, cached_unref, loop.n_pages)
    for page in loop._free:
        assert loop._ref[page] == 0
        assert loop._prefix is None or not loop._prefix.owns(page)


def _tick(loop, n=1):
    for _ in range(n):
        loop.tick()
        _balance(loop)


def _drain(loop, max_ticks=400):
    for _ in range(max_ticks):
        with loop._cond:
            if not loop._waiting and loop.occupied_slots == 0:
                return
        _tick(loop)
    raise AssertionError("loop did not drain")


def _record(loop, streams):
    snap = loop.snapshot()
    pc = snap["prefix_cache"]
    return {"tokens": [list(s._generated) for s in streams],
            "reasons": [s.finish_reason for s in streams],
            "prefill_tokens": snap["prefill_tokens"],
            "counters": {k: pc[k] for k in ("hits", "misses", "forks",
                                            "evictions", "pages_cached")},
            "admission_waits": snap["admission_waits"],
            "cached": sorted(int(p) for p in (
                loop._prefix.pages() if loop._prefix is not None else ()))}


def sc_warm_tail(loop):
    rng = np.random.RandomState(0)
    head = _prompt(rng, 16)
    long_pr = np.concatenate([head, _prompt(rng, 4)])
    s1 = loop.submit(head, 2)
    _drain(loop)
    r1 = _record(loop, [s1])
    assert r1["counters"]["pages_cached"] == 2
    s2 = loop.submit(long_pr, 6)
    _drain(loop)
    r2 = _record(loop, [s1, s2])
    assert r2["prefill_tokens"] - r1["prefill_tokens"] == 4
    assert r2["counters"]["hits"] == 1
    return [r1, r2]


def sc_full_hit_forks_once(loop):
    rng = np.random.RandomState(1)
    pr = _prompt(rng, 16)
    s1 = loop.submit(pr, 5)
    _drain(loop)
    r1 = _record(loop, [s1])
    s2 = loop.submit(pr, 5)
    _drain(loop)
    r2 = _record(loop, [s1, s2])
    assert r2["prefill_tokens"] == r1["prefill_tokens"]
    assert r2["counters"]["forks"] == 1 and r2["counters"]["hits"] == 1
    assert r2["tokens"][0] == r2["tokens"][1]
    assert loop.decode_step_programs() == 1
    return [r1, r2]


def sc_forked_page_never_seeds(loop):
    rng = np.random.RandomState(2)
    pr = _prompt(rng, 16)
    s1 = loop.submit(pr, 3)
    _drain(loop)
    before = sorted(loop._prefix.pages())
    s2 = loop.submit(pr, 3)
    _drain(loop)
    assert sorted(loop._prefix.pages()) == before
    return [_record(loop, [s1, s2])]


def sc_concurrent_sharing(loop):
    rng = np.random.RandomState(3)
    head = _prompt(rng, 16)
    tails = [_prompt(rng, 4), _prompt(rng, 5), _prompt(rng, 6)]
    s0 = loop.submit(head, 2)
    _drain(loop)
    streams = [loop.submit(np.concatenate([head, t]), 6) for t in tails]
    saw_shared = 0
    for _ in range(200):
        with loop._cond:
            if not loop._waiting and loop.occupied_slots == 0:
                break
        _tick(loop)
        saw_shared = max(saw_shared, loop.pages_shared)
    assert saw_shared >= 2
    rec = _record(loop, [s0] + streams)
    assert rec["counters"]["hits"] == 3
    rec["saw_shared"] = saw_shared
    return [rec]


def sc_lru_eviction(loop):
    rng = np.random.RandomState(4)
    a, b = _prompt(rng, 16), _prompt(rng, 16)
    sa = loop.submit(a, 1)
    _drain(loop)
    sb = loop.submit(b, 1)
    _drain(loop)
    assert loop.snapshot()["prefix_cache"]["pages_cached"] == 4
    assert len(loop._free) == 0
    assert len(loop._prefix.match(list(a))) == 2  # freshen a's path
    sc = loop.submit(_prompt(rng, 15), 1)
    _drain(loop)
    rec = _record(loop, [sa, sb, sc])
    assert rec["counters"]["evictions"] == 2
    assert len(loop._prefix.match(list(a))) == 2
    assert loop._prefix.match(list(b)) == []
    return [rec]


def sc_fork_under_pressure(loop):
    rng = np.random.RandomState(5)
    pr = _prompt(rng, 16)
    s0 = loop.submit(pr, 1)        # seed: 2 cached pages, 3 free
    _drain(loop)
    c = loop.submit(_prompt(rng, 8), 17)
    for _ in range(200):
        _tick(loop)
        if int(loop._lengths[0]) >= 16:
            break
    assert int(loop._lengths[0]) == 16 and len(loop._free) == 1
    st = loop.submit(pr, 4)        # full hit: needs a fork page
    waits = loop.snapshot()["admission_waits"]
    _tick(loop)                    # C's grant wins; the fork stalls
    mid = _record(loop, [s0, c, st])
    assert mid["counters"]["forks"] == 0
    assert mid["admission_waits"] > waits and not st.done
    _drain(loop)
    rec = _record(loop, [s0, c, st])
    assert rec["counters"]["forks"] == 1
    assert rec["counters"]["evictions"] == 0
    return [mid, rec]


def sc_opt_out(loop):
    rng = np.random.RandomState(6)
    pr = _prompt(rng, 16)
    s1 = loop.submit(pr, 2, prefix_cache=False)
    _drain(loop)
    r1 = _record(loop, [s1])
    assert r1["counters"]["pages_cached"] == 0
    assert r1["counters"]["hits"] == r1["counters"]["misses"] == 0
    s2 = loop.submit(pr, 2)
    _drain(loop)
    r2 = _record(loop, [s1, s2])
    assert r2["counters"]["pages_cached"] == 2
    s3 = loop.submit(pr, 2, prefix_cache=False)
    _drain(loop)
    r3 = _record(loop, [s1, s2, s3])
    assert r3["prefill_tokens"] - r2["prefill_tokens"] == 16
    assert r3["counters"]["hits"] == 0
    return [r1, r2, r3]


def sc_cancel_mid_share(loop):
    rng = np.random.RandomState(7)
    head = _prompt(rng, 16)
    pr1 = np.concatenate([head, _prompt(rng, 4)])
    pr2 = np.concatenate([head, _prompt(rng, 5)])
    s0 = loop.submit(head, 1)
    _drain(loop)
    s1 = loop.submit(pr1, 8)
    s2 = loop.submit(pr2, 8)
    _tick(loop)
    assert loop.pages_shared >= 2
    s1.cancel()
    _tick(loop)
    assert s1.finish_reason == "cancelled"
    _drain(loop)
    return [_record(loop, [s0, s1, s2])]


def sc_disabled(loop):
    s = loop.submit([1, 2, 3, 4, 5, 6, 7, 8], 2)
    _drain(loop)
    snap = loop.snapshot()["prefix_cache"]
    assert snap["enabled"] is False
    assert snap["pages_cached"] == 0 and snap["nodes"] == 0
    return [_record(loop, [s])]


#: scenario -> (function, loop options)
SCENARIOS = {
    "warm_tail": (sc_warm_tail, {"slots": 2}),
    "full_hit_forks_once": (sc_full_hit_forks_once, {"slots": 2}),
    "forked_page_never_seeds": (sc_forked_page_never_seeds, {"slots": 2}),
    "concurrent_sharing": (sc_concurrent_sharing, {"slots": 4}),
    "lru_eviction": (sc_lru_eviction, {"slots": 2, "n_pages": 4}),
    "fork_under_pressure": (sc_fork_under_pressure,
                            {"slots": 2, "n_pages": 5}),
    "opt_out": (sc_opt_out, {"slots": 2}),
    "cancel_mid_share": (sc_cancel_mid_share, {"slots": 2}),
    "disabled": (sc_disabled, {"slots": 1, "prefix_cache": False}),
}


@pytest.fixture(scope="module")
def jax_runs(params):
    """Each scenario's records from the JAX package's loop, run once."""
    jp, _ = params
    cache = {}

    def get(name):
        if name not in cache:
            fn, kw = SCENARIOS[name]
            cache[name] = fn(JaxLoop(jp, JAX_CFG, page_size=PS,
                                     kernel="gather", fleet_kv="off",
                                     start=False, **kw))
        return cache[name]

    return get


class TestLoopMatchesJax:
    @pytest.mark.parametrize("lane", LANES)
    @pytest.mark.parametrize("name", list(SCENARIOS))
    def test_scenario(self, params, jax_runs, name, lane):
        _, tp = params
        fn, kw = SCENARIOS[name]
        loop = DecodeLoop(tp, CFG, page_size=PS, kernel=lane, device="cpu",
                          start=False, **kw)
        assert fn(loop) == jax_runs(name)

    def test_prefix_cache_is_on_by_default(self, params):
        jp, tp = params
        loop = DecodeLoop(tp, CFG, device="cpu", start=False)
        assert loop.prefix_cache_enabled
        snap = loop.snapshot()
        assert snap["prefix_cache"]["enabled"] is True
        # the fleet_kv block reads as the JAX loop's, with the plane at
        # its default (on) and off
        for kw in ({}, {"fleet_kv": "off"}):
            ref = JaxLoop(jp, JAX_CFG, kernel="gather", start=False, **kw)
            ours = DecodeLoop(tp, CFG, device="cpu", start=False, **kw)
            assert ours.snapshot()["fleet_kv"] == \
                ref.snapshot()["fleet_kv"]
        assert snap["fleet_kv"] == {"mode": "on", "page_ships": 0,
                                    "ship_bytes": 0, "ship_failures": 0}


class TestThreaded:
    def test_threaded_submitters_one_prefix_balance_holds(self, params):
        """More submitter threads than cores hammering one shared prefix
        (the switch interval shortened): every output equals the cache-off
        loop's, and the pool balances at the end."""
        _, tp = params
        rng = np.random.RandomState(8)
        head = _prompt(rng, 8)
        prompts = [np.concatenate([head, _prompt(rng, 1 + i % 5)])
                   for i in range(12)]
        ref_loop = DecodeLoop(tp, CFG, slots=3, page_size=PS, n_pages=12,
                              prefix_cache=False, device="cpu", start=False)
        refs = [ref_loop.submit(p, 4) for p in prompts]
        _drain(ref_loop)
        outs: dict = {}
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            with DecodeLoop(tp, CFG, slots=3, page_size=PS, n_pages=12,
                            device="cpu") as loop:
                def worker(k):
                    outs[k] = loop.submit(prompts[k], 4).result(120)

                threads = [threading.Thread(target=worker, args=(k,))
                           for k in range(len(prompts))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=180)
                assert not any(t.is_alive() for t in threads)
                with loop._cond:
                    _balance(loop)
                hits = loop.snapshot()["prefix_cache"]["hits"]
        finally:
            sys.setswitchinterval(old)
        assert [outs[k] for k in range(len(prompts))] == [
            r.result(0) for r in refs]
        assert hits >= 1
