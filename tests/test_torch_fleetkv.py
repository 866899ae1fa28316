"""The PyTorch port's fleet KV plane (serving/fleetkv.py, the loop's
`kv_summary` / `kv_export` / `kv_ship`, paged_kv's page extract and
install) held against the JAX package on the CPU.

- Hashing, the ring, summaries and the affinity plan: equal to JAX's on
  the same inputs.
- The `DL4JKV1` wire: `pack_pages` is byte-identical to JAX's for float32
  and bfloat16 pages, and each package's `unpack_pages` reads the other's
  bytes exactly; any corruption raises `ShipError`.
- Shipping: each scenario of the JAX package's `tests/test_fleetkv.py`
  runs on both packages' `DecodeLoop(start=False)` (JAX at
  kernel="gather", the port on both of its lanes) with the same params:
  the same tokens, prefill tokens, installed pages and ship counters, the
  page invariant holding on both ends; the installed pages are bit-equal
  to the donor's pool pages. A JAX donor's pages are refused by a port
  receiver through `kv_ship` (the decode identity names the device and
  the lane: the designed result), and installed directly they give the
  JAX receiver's tokens.
- `/kv/export` between two port servers over real HTTP.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jax_tf
from deeplearning4j_tpu.serving import fleetkv as jfk
from deeplearning4j_tpu.serving.decode_loop import DecodeLoop as JaxLoop
from deeplearning4j_tpu.serving.prefix_cache import \
    PrefixIndex as JaxPrefixIndex
from deeplearning4j_tpu.testing import chaos as jchaos
from deeplearning4j_tpu_torch.models import transformer as tf
from deeplearning4j_tpu_torch.serving import (InferenceEngine, ReplicaSet,
                                             fleetkv, paged_kv,
                                             serve_network)
from deeplearning4j_tpu_torch.serving.decode_loop import DecodeLoop
from deeplearning4j_tpu_torch.serving.prefix_cache import PrefixIndex
from deeplearning4j_tpu_torch.testing import chaos
from deeplearning4j_tpu_torch.weights import params_from_jax

JAX_CFG = jax_tf.TransformerConfig(vocab_size=17, d_model=32, n_heads=2,
                                   n_layers=2, d_ff=64, max_len=64,
                                   interpret=True)
CFG = tf.TransformerConfig(vocab_size=17, d_model=32, n_heads=2,
                           n_layers=2, d_ff=64, max_len=64)
PS = 8
LANES = ("gather", "kernel")


@pytest.fixture(scope="module")
def params():
    jp = jax_tf.init_transformer_params(jax.random.PRNGKey(0), JAX_CFG)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


def _prompt(rng, t):
    return rng.randint(0, CFG.vocab_size, (t,)).astype(np.int32)


def _balanced(loop) -> bool:
    return (loop.pages_in_use + len(loop._free) + loop._cached_unref()
            == loop.n_pages)


def _loop(pkg, params, lane="gather", **kw):
    jp, tp = params
    kw.setdefault("slots", 2)
    kw.setdefault("page_size", PS)
    if pkg == "jax":
        return JaxLoop(jp, JAX_CFG, kernel="gather", start=False, **kw)
    return DecodeLoop(tp, CFG, kernel=lane, device="cpu", start=False,
                      **kw)


def _seeded_donor(pkg, params, head, lane="gather", **kw):
    donor = _loop(pkg, params, lane, **kw)
    s = donor.submit(head, 1)
    donor.run_until_idle()
    s.result(5)
    return donor


@pytest.fixture
def fetch_from(monkeypatch):
    """Point both packages' `fetch_pages` at a donor loop's `kv_export`
    (the transport is exercised over real HTTP below)."""
    def install(donor):
        def fake(url, tokens, timeout, max_chunks=None):
            return donor.kv_export(list(tokens), max_chunks=max_chunks)

        monkeypatch.setattr(fleetkv, "fetch_pages", fake)
        monkeypatch.setattr(jfk, "fetch_pages", fake)

    return install


# ------------------------------------------------- hashing + placement
class TestHashingAndPlacement:
    @pytest.mark.parametrize("ps", [1, 4, 8])
    def test_hash_chunks_and_ring_match_jax(self, ps):
        rng = np.random.RandomState(ps)
        for t in (0, 3, 8, 17, 40, 200):
            toks = rng.randint(0, 1000, t).tolist()
            for limit in (None, 2, fleetkv.MAX_HEAD_CHUNKS):
                assert fleetkv.hash_chunks(toks, ps, limit) == \
                    jfk.hash_chunks(toks, ps, limit)
        ids = [f"r{i}" for i in range(5)]
        ring, jring = fleetkv.HashRing(ids), jfk.HashRing(ids)
        keys = rng.randint(0, 2 ** 32, 500).tolist()
        assert [ring.lookup(k) for k in keys] == \
            [jring.lookup(k) for k in keys]
        assert fleetkv.HashRing([]).lookup(5) is None

    def test_summary_heads_and_match_match_jax(self):
        rng = np.random.RandomState(1)
        idx, jidx = PrefixIndex(4), JaxPrefixIndex(4)
        page = 0
        for _ in range(12):
            toks = rng.randint(0, 9, rng.randint(4, 30)).tolist()
            n = len(toks) // 4
            pages = list(range(page, page + n))
            page += n
            idx.insert(toks, pages)
            jidx.insert(toks, pages)
            idx.match(toks[:8])
            jidx.match(toks[:8])
        for kw in ({}, {"max_hashes": 5}, {"max_chunks": 1}):
            heads = fleetkv.summary_heads(idx, 4, **kw)
            assert heads == jfk.summary_heads(jidx, 4, **kw)
        heads = fleetkv.summary_heads(idx, 4)
        probe = fleetkv.hash_chunks(rng.randint(0, 9, 24).tolist(), 4)
        for summary in (None, {}, {"heads": heads},
                        {"heads": heads[:3] + probe[:2]}):
            assert fleetkv.match_summary(summary, probe) == \
                jfk.match_summary(summary, probe)

    def test_affinity_plan_matches_jax(self):
        rng = np.random.RandomState(2)
        head = rng.randint(0, 50, 24).tolist()
        deep = fleetkv.hash_chunks(head, PS)
        summaries = {
            "a": ({"heads": deep[:1], "page_size": PS}, "http://a"),
            "b": ({"heads": deep, "page_size": PS}, "http://b"),
            "c": ({"heads": deep, "page_size": PS, "role": "prefill"},
                  "http://c"),
            "d": ({"heads": [], "page_size": PS}, "http://d"),
        }
        cold = rng.randint(50, 99, 24).tolist()
        cases = [(head, summaries), (cold, summaries), (head[:5], summaries),
                 (head, {"c": summaries["c"]}),
                 (head, {**summaries,
                         "e": ({"heads": deep, "page_size": 4}, "http://e")}),
                 (head, {})]
        for mode in fleetkv.MODES:
            ours, ref = fleetkv.RouterAffinity(mode), jfk.RouterAffinity(mode)
            assert (ours.enabled, ours.shipping) == (ref.enabled,
                                                     ref.shipping)
            for prompt, summ in cases:
                got, want = ours.plan(prompt, summ), ref.plan(prompt, summ)
                if want is None:
                    assert got is None
                    continue
                assert (got.prefer, got.depth, got.donor, got.donor_url) \
                    == (want.prefer, want.depth, want.donor, want.donor_url)
        with pytest.raises(ValueError, match="fleet-kv mode"):
            fleetkv.RouterAffinity("maybe")


# ------------------------------------------------------------ the wire
def _pages(dtype, seed=0, chunks=3, layers=2, shape=(2, 8, 16)):
    rng = np.random.RandomState(seed)
    return [[tuple(rng.randn(*shape).astype(np.float32).astype(dtype)
                   for _ in range(2)) for _ in range(layers)]
            for _ in range(chunks)]


META = {"v": 1, "cache_key": "ck", "page_size": 8, "chunks": 3,
        "layers": 2, "shape": [2, 8, 16]}


class TestWireFormat:
    @pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                             ids=["float32", "bfloat16"])
    def test_pack_is_byte_identical_and_each_unpacks_the_other(self, dtype):
        pages = _pages(dtype)
        ref = jfk.pack_pages(META, pages)
        as_numpy = fleetkv.pack_pages(META, pages)
        # the port's own pages are CPU tensors (bfloat16 as torch's)
        as_tensors = fleetkv.pack_pages(META, [
            [tuple(torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                   if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a)
                   for a in kv) for kv in chunk] for chunk in pages])
        assert as_numpy == ref and as_tensors == ref
        header, got = fleetkv.unpack_pages(ref)
        assert header == jfk.unpack_pages(ref)[0]
        assert header["dtype"] == np.dtype(dtype).name
        for cj, oj in zip(pages, got):
            for (k, v), (ok, ov) in zip(cj, oj):
                for a, b in ((k, ok), (v, ov)):
                    if dtype == ml_dtypes.bfloat16:
                        assert b.dtype == np.uint16
                        b = b.view(ml_dtypes.bfloat16)
                    np.testing.assert_array_equal(a, b)
        _, back = jfk.unpack_pages(as_tensors)
        for cj, oj in zip(pages, back):
            for (k, v), (ok, ov) in zip(cj, oj):
                np.testing.assert_array_equal(k, ok)
                np.testing.assert_array_equal(v, ov)

    def test_corruption_always_raises_ship_error(self):
        payload = fleetkv.pack_pages(META, _pages(np.float32))
        bad_dtype = payload.replace(b'"float32"', b'"float99"')
        body = bytearray(payload)
        body[len(body) // 2] ^= 0xFF
        for bad in (b"NOTKV00\n" + payload[8:], bytes(body), payload[:-7],
                    b"", bad_dtype, payload[:12]):
            with pytest.raises(fleetkv.ShipError):
                fleetkv.unpack_pages(bad)
            with pytest.raises(jfk.ShipError):
                jfk.unpack_pages(bad)
        header, chunks = fleetkv.unpack_pages(
            fleetkv.pack_pages({**META, "chunks": 0}, []))
        assert chunks == [] and header["chunks"] == 0


# ------------------------------------------------- loop-level shipping
def _ship_scenario(pkg, params, fetch_from, lane="gather"):
    """Donor seeds a 2-page head; the receiver ships it, a repeat ship
    is a no-op, and the next admission prefills only the tail."""
    rng = np.random.RandomState(0)
    head = _prompt(rng, 16)
    full = np.concatenate([head, _prompt(rng, 4)])
    donor = _seeded_donor(pkg, params, head, lane)
    recv = _loop(pkg, params, lane)
    fetch_from(donor)
    installed = recv.kv_ship("http://donor:1", list(head))
    again = recv.kv_ship("http://donor:1", list(head))
    before = recv.snapshot()
    st = recv.submit(full, 6)
    recv.run_until_idle()
    snap = recv.snapshot()
    out = {"installed": installed, "again": again,
           "tokens": st.full_sequence(5),
           "prefill_delta": snap["prefill_tokens"]
           - before["prefill_tokens"],
           "hits": snap["prefix_cache"]["hits"],
           "page_ships": snap["fleet_kv"]["page_ships"],
           "ship_failures": snap["fleet_kv"]["ship_failures"],
           "balanced": (_balanced(recv), _balanced(donor))}
    assert snap["fleet_kv"]["ship_bytes"] > 0
    return out, donor, recv, head


class TestShipping:
    @pytest.mark.parametrize("lane", LANES)
    def test_ship_install_tail_only_prefill_matches_jax(self, params,
                                                        fetch_from, lane):
        ref, *_ = _ship_scenario("jax", params, fetch_from)
        got, donor, recv, head = _ship_scenario("port", params, fetch_from,
                                                lane)
        assert got == ref
        assert got["installed"] == 2 and got["prefill_delta"] == 4
        # the installed pages are the donor's pool pages, bit for bit
        dpages, rpages = donor._prefix.match(list(head)), \
            recv._prefix.match(list(head))
        assert len(dpages) == len(rpages) == 2
        for dl, rl in zip(donor._pool.layers, recv._pool.layers):
            for name in ("k", "v"):
                assert torch.equal(dl[name][dpages], rl[name][rpages])

    def test_dead_donor_falls_back_to_plain_prefill(self, params):
        rng = np.random.RandomState(1)
        full = _prompt(rng, 20)
        outs = {}
        for pkg in ("jax", "port"):
            recv = _loop(pkg, params)
            # nothing listens on a reserved port: the fetch fails fast
            assert recv.kv_ship("http://127.0.0.1:9", list(full),
                                timeout=0.5) == 0
            snap = recv.snapshot()["fleet_kv"]
            assert (snap["ship_failures"], snap["page_ships"]) == (1, 0)
            st = recv.submit(full, 4)
            recv.run_until_idle()
            outs[pkg] = st.full_sequence(5)
            assert _balanced(recv)
        assert outs["port"] == outs["jax"]

    def test_identity_mismatch_refuses_pages(self, params, monkeypatch):
        """A payload whose cache_key names another decode identity is
        refused — a forged key, and a JAX donor's genuine payload (its key
        names a JAX device and lane)."""
        rng = np.random.RandomState(2)
        head = _prompt(rng, 16)
        donor = _seeded_donor("port", params, head)
        jdonor = _seeded_donor("jax", params, head)
        header, chunks = fleetkv.unpack_pages(donor.kv_export(list(head)))
        forged = fleetkv.pack_pages({**header, "cache_key": "other"},
                                    chunks)
        for payload in (forged, jdonor.kv_export(list(head))):
            recv = _loop("port", params)
            monkeypatch.setattr(fleetkv, "fetch_pages",
                                lambda *a, _p=payload, **k: _p)
            assert recv.kv_ship("http://x:1", list(head)) == 0
            snap = recv.snapshot()
            assert snap["fleet_kv"]["ship_failures"] == 1
            assert snap["prefix_cache"]["pages_cached"] == 0
            assert _balanced(recv)
        assert jdonor.cache_key != donor.cache_key
        assert donor.cache_key.endswith("|dev=cpu")

    def test_jax_pages_installed_directly_give_the_jax_tokens(self,
                                                              params):
        """Cross-package parity goes through `unpack_pages` on the other
        package's bytes: a JAX donor's pages installed into a port loop
        decode the JAX receiver's tokens with a tail-only prefill."""
        rng = np.random.RandomState(7)
        head = _prompt(rng, 16)
        full = np.concatenate([head, _prompt(rng, 5)])
        jdonor = _seeded_donor("jax", params, head)
        _, chunks = fleetkv.unpack_pages(jdonor.kv_export(list(head)))
        outs = {}
        for pkg in ("jax", "port"):
            recv = _loop(pkg, params)
            mod = jfk if pkg == "jax" else fleetkv
            assert recv._kv_install(list(head), mod.unpack_pages(
                jdonor.kv_export(list(head)))[1] if pkg == "jax"
                else chunks, 5.0) == 2
            st = recv.submit(full, 6)
            recv.run_until_idle()
            outs[pkg] = (st.full_sequence(5),
                         recv.snapshot()["prefill_tokens"])
        assert outs["port"] == outs["jax"] and outs["port"][1] == 5

    @pytest.mark.parametrize("kind,at", [("error", 0), ("reset", 1)])
    def test_chaos_mid_ship_falls_back_balanced(self, params, fetch_from,
                                                kind, at):
        """An injected error on the receiver's fetch (ordinal 0) or a
        reset on the donor's export read (ordinal 1): the receiver falls
        back to plain prefill with the JAX package's tokens, both pools
        balance, the export pins are all released."""
        rng = np.random.RandomState(3)
        head = _prompt(rng, 16)
        full = np.concatenate([head, _prompt(rng, 4)])
        outs = {}
        for pkg, mod in (("jax", jchaos), ("port", chaos)):
            donor = _seeded_donor(pkg, params, head)
            recv = _loop(pkg, params)
            fetch_from(donor)
            mod.configure([mod.Rule("fleet.kv_ship", kind, at=[at])])
            try:
                assert recv.kv_ship("http://donor:1", list(head)) == 0
            finally:
                mod.deactivate()
            assert recv.snapshot()["fleet_kv"]["ship_failures"] == 1
            st = recv.submit(full, 6)
            recv.run_until_idle()
            outs[pkg] = st.full_sequence(5)
            assert _balanced(recv) and _balanced(donor)
            assert donor.pages_in_use == 0
        assert outs["port"] == outs["jax"]

    def test_export_pin_blocks_eviction_race(self, params):
        """A chaos delay holds the donor's export pins open while the
        main thread forces allocation pressure: the pinned head pages
        survive (only the other cached entry is evicted), balance holds
        tick by tick, and the bytes read in the window install into a
        receiver whose warm admission gives the cold reference's tokens
        with a tail-only prefill."""
        rng = np.random.RandomState(4)
        head = _prompt(rng, 16)
        other = _prompt(rng, 16)
        donor = _loop("port", params, n_pages=4)
        recv = _loop("port", params)
        donor.submit(head, 1)
        donor.run_until_idle()
        donor.submit(other, 1)
        donor.run_until_idle()
        assert len(donor._free) == 0
        donor._prefix.match(list(other))  # freshen: head is LRU
        out = {}
        chaos.configure([chaos.Rule("fleet.kv_ship", "delay",
                                    delay_s=0.6, at=[0])])
        try:
            t = threading.Thread(target=lambda: out.update(
                payload=donor.kv_export(list(head))))
            t.start()
            deadline = time.time() + 5
            while time.time() < deadline:
                with donor._cond:
                    pinned = [pg for pg in donor._prefix.match(list(head))
                              if donor._ref[pg] > 0]
                if len(pinned) == 2:
                    break
                time.sleep(0.005)
            assert len(pinned) == 2, "export pins never appeared"
            cold = _prompt(rng, 15)
            st = donor.submit(cold, 1)
            for _ in range(200):
                donor.tick()
                with donor._cond:
                    assert _balanced(donor)
                    still = donor._prefix.match(list(head))
                assert len(still) == 2, "a pinned export page was evicted"
                if st.done:
                    break
            assert st.done
            assert donor._prefix.match(list(other)) == []
            t.join(10)
            assert not t.is_alive()
        finally:
            chaos.deactivate()
        _, chunks = fleetkv.unpack_pages(out["payload"])
        assert recv._kv_install(list(head), chunks, 5.0) == 2
        full = np.concatenate([head, _prompt(rng, 4)])
        cold_loop = _loop("port", params, prefix_cache=False)
        ref = cold_loop.submit(full, 6)
        cold_loop.run_until_idle()
        st2 = recv.submit(full, 6)
        recv.run_until_idle()
        assert st2.full_sequence(5) == ref.full_sequence(5)
        assert recv.snapshot()["prefill_tokens"] == 4
        assert _balanced(recv) and _balanced(donor)

    def test_install_under_full_pool_fails_cleanly(self, params,
                                                   fetch_from):
        rng = np.random.RandomState(5)
        head = _prompt(rng, 16)
        busy_prompt = _prompt(rng, 12)
        outs = {}
        for pkg in ("jax", "port"):
            donor = _seeded_donor(pkg, params, head)
            recv = _loop(pkg, params, n_pages=2)
            busy = recv.submit(busy_prompt, 3)
            recv.tick()
            assert recv._avail_pages() == 0
            fetch_from(donor)
            assert recv.kv_ship("http://d:1", list(head)) == 0
            assert recv.snapshot()["fleet_kv"]["ship_failures"] == 1
            recv.run_until_idle()
            outs[pkg] = busy.result(5)
            assert _balanced(recv)
        assert outs["port"] == outs["jax"]

    def test_modes_gate_both_halves(self, params):
        """affinity-only publishes a summary but never exports or
        fetches; off publishes nothing; prefix_cache=False forces the
        plane off — the same summaries and snapshots as JAX's."""
        rng = np.random.RandomState(6)
        head = _prompt(rng, 16)
        for pkg in ("jax", "port"):
            aff = _loop(pkg, params, slots=1, fleet_kv="affinity-only")
            off = _loop(pkg, params, slots=1, prefix_cache=False)
            aff.submit(head, 1)
            aff.run_until_idle()
            summ = aff.kv_summary()
            assert summ["mode"] == "affinity-only" and summ["heads"]
            assert aff.kv_export(list(head)) is None
            assert aff.kv_ship("http://x:1", list(head)) == 0
            assert aff.snapshot()["fleet_kv"]["ship_failures"] == 0
            assert off.kv_summary() is None
            assert off.snapshot()["fleet_kv"]["mode"] == "off"
        summaries = {}
        for pkg in ("jax", "port"):
            loop = _loop(pkg, params)
            loop.submit(head, 1)
            loop.run_until_idle()
            summaries[pkg] = loop.kv_summary()
        assert summaries["port"] == summaries["jax"]
        with pytest.raises(ValueError, match="fleet_kv"):
            _loop("port", params, fleet_kv="maybe")
        with pytest.raises(ValueError, match="kv_ship_timeout"):
            _loop("port", params, kv_ship_timeout=0)


class TestPages:
    def test_extract_and_install_pages_round_trip_in_place(self):
        """`extract_pages` gathers every layer's pages in one copy;
        `install_pages` writes them back in place (the pool's storage is
        never reallocated); bfloat16 pages travel as raw bits."""
        cfg = CFG._replace(dtype=torch.bfloat16)
        pool = paged_kv.init_paged_pool(cfg, 6, PS, device="cpu")
        gen = torch.Generator().manual_seed(0)
        for layer in pool.layers:
            for name in ("k", "v"):
                layer[name].copy_(torch.randn(layer[name].shape,
                                              generator=gen))
        chunks = paged_kv.extract_pages(pool, [4, 1])
        assert len(chunks) == 2 and len(chunks[0]) == cfg.n_layers
        assert torch.equal(chunks[0][1][1], pool.layers[1]["v"][4])
        payload = fleetkv.pack_pages({**META, "chunks": 2}, chunks)
        _, wire = fleetkv.unpack_pages(payload)
        assert wire[0][0][0].dtype == np.uint16
        dst = paged_kv.init_paged_pool(cfg, 6, PS, device="cpu")
        ptrs = [layer["k"].data_ptr() for layer in dst.layers]
        paged_kv.install_pages(dst, [0, 5], wire)
        assert ptrs == [layer["k"].data_ptr() for layer in dst.layers]
        for s, d in zip(pool.layers, dst.layers):
            for name in ("k", "v"):
                assert torch.equal(d[name][0], s[name][4])
                assert torch.equal(d[name][5], s[name][1])
                assert not d[name][1:5].any()
        paged_kv.install_page(dst, 2, chunks[1])
        assert torch.equal(dst.layers[0]["k"][2], pool.layers[0]["k"][1])
        with pytest.raises(ValueError, match="layers"):
            paged_kv.install_page(dst, 2, chunks[1][:1])
        with pytest.raises(ValueError, match="dtype"):
            paged_kv.install_page(dst, 2, [(k.float(), v.float())
                                           for k, v in chunks[1]])


# ------------------------------------------------------- over HTTP
def _post_raw(url, payload, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


class TestShipHTTP:
    def test_p2p_ship_over_real_http(self, params):
        """Two port servers: the receiver's `/generate` names the donor as
        `kv_donor`, pulls its pages over `/kv/export`, prefills only the
        tail, and answers the cold reference's tokens; `/kv/export`
        answers 404 while the plane is off."""
        jp, tp = params
        rng = np.random.RandomState(8)
        head = _prompt(rng, 16).tolist()
        full = head + _prompt(rng, 5).tolist()
        engines = [InferenceEngine.for_transformer(tp, CFG, device="cpu")
                   for _ in range(3)]
        stub = ReplicaSet([engines[2]])
        donor = serve_network(replicas=stub, generate_engine=engines[0],
                              slots=2, page_size=PS, kv_ship_timeout=30)
        recv = serve_network(replicas=stub, generate_engine=engines[1],
                             slots=2, page_size=PS, kv_ship_timeout=30)
        off = serve_network(replicas=stub,
                            generate_engine=InferenceEngine.for_transformer(
                                tp, CFG, device="cpu"),
                            slots=1, page_size=PS, fleet_kv="off")
        try:
            json.loads(_post_raw(donor.url + "/generate",
                                 {"prompt": [head], "max_tokens": 1}))
            payload = _post_raw(donor.url + "/kv/export", {"tokens": head})
            header, chunks = fleetkv.unpack_pages(payload)
            assert header["chunks"] == 2 and len(chunks) == 2
            out = json.loads(_post_raw(recv.url + "/generate", {
                "prompt": [full], "max_tokens": 6,
                "kv_donor": donor.url}))
            snap = engines[1].decode_loop.snapshot()
            assert snap["fleet_kv"]["page_ships"] == 2
            assert snap["prefill_tokens"] == 5
            ref = JaxLoop(jp, JAX_CFG, kernel="gather", start=False,
                          fleet_kv="off", prefix_cache=False)
            st = ref.submit(np.asarray(full, np.int32), 6)
            ref.run_until_idle()
            assert out["tokens"] == [st.full_sequence(5)]
            with pytest.raises(urllib.error.HTTPError) as e:
                _post_raw(off.url + "/kv/export", {"tokens": head})
            assert e.value.code == 404
            with pytest.raises(urllib.error.HTTPError) as e:
                _post_raw(donor.url + "/kv/export", {"tokens": []})
            assert e.value.code == 400
        finally:
            for h in (donor, recv, off):
                h.close()
