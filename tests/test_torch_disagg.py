"""The PyTorch port's disaggregated roles (`role="prefill"|"decode"`,
`DecodeLoop.prefill_only`, the server's `/prefill` and the `kv_donor`
field of `/generate`) held against the JAX package on the CPU.

Loop level, each case runs on both packages' `DecodeLoop(start=False)`
(JAX at kernel="gather", the port on both of its lanes) with the same
params: role validation raises the same errors; a `prefill_only` report
equals JAX's; the handoff (prefill loop parks the pages, decode loop
ships them and prefills only the tail) gives the JAX package's tokens and
prefill tokens, with the page invariant on both ends; a repeat handoff is
a covered no-op; pool pressure raises `OverloadedError`; a chaos fault on
the export leg raises and the next handoff lands; the prefill loop never
dispatches a decode step (`decode_step_programs() == 0`).

Over real HTTP between port servers: `POST /prefill` to a prefill-role
server, then `/generate` on a decode-role server naming it as
`kv_donor` — the JAX package's tokens, tail-only prefill, the same
counters; a chaos fault on either leg falls back to plain prefill with
the same tokens.

On the card (`cuda` marker): pages shipped into a decode loop AFTER its
step graph was captured are written in place, and the next replays'
tokens equal a cold loop's.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jax_tf
from deeplearning4j_tpu.serving import fleetkv as jfk
from deeplearning4j_tpu.serving.decode_loop import DecodeLoop as JaxLoop
from deeplearning4j_tpu.serving.errors import \
    OverloadedError as JaxOverloaded
from deeplearning4j_tpu.serving.kv_cache import generate_cached
from deeplearning4j_tpu.testing import chaos as jchaos
from deeplearning4j_tpu_torch.models import transformer as tf
from deeplearning4j_tpu_torch.serving import (InferenceEngine, ReplicaSet,
                                             fleetkv, serve_network)
from deeplearning4j_tpu_torch.serving.decode_loop import (ROLE_DECODE,
                                                          ROLE_PREFILL,
                                                          DecodeLoop)
from deeplearning4j_tpu_torch.serving.errors import OverloadedError
from deeplearning4j_tpu_torch.serving.paged_kv import paged_kv_bytes
from deeplearning4j_tpu_torch.testing import chaos
from deeplearning4j_tpu_torch.weights import params_from_jax

JAX_CFG = jax_tf.TransformerConfig(vocab_size=17, d_model=32, n_heads=2,
                                   n_layers=2, d_ff=64, max_len=64,
                                   interpret=True)
CFG = tf.TransformerConfig(vocab_size=17, d_model=32, n_heads=2,
                           n_layers=2, d_ff=64, max_len=64)
PS = 8
LANES = ("gather", "kernel")
PKGS = {"jax": (jchaos, jfk, JaxOverloaded),
        "port": (chaos, fleetkv, OverloadedError)}


@pytest.fixture(scope="module")
def params():
    jp = jax_tf.init_transformer_params(jax.random.PRNGKey(0), JAX_CFG)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    chaos.deactivate()
    jchaos.deactivate()


def _prompt(rng, t):
    return rng.randint(0, CFG.vocab_size, (t,)).astype(np.int32)


def _ref_tokens(jp, prompt, n):
    return np.asarray(generate_cached(
        jp, jnp.asarray(np.asarray(prompt)[None]), JAX_CFG, n))[0].tolist()


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


def _cases(lanes=LANES):
    return [("jax", "gather")] + [("port", lane) for lane in lanes]


# ------------------------------------------------------ role validation
class TestRoleValidation:
    @pytest.mark.parametrize("kw,match", [
        ({"role": "verifier"}, "role must be one of"),
        ({"role": ROLE_PREFILL, "prefix_cache": False}, "prefix"),
        ({"role": ROLE_PREFILL, "fleet_kv": "affinity-only"}, "fleet_kv"),
        ({"role": ROLE_PREFILL, "fleet_kv": "off"}, "fleet_kv"),
    ])
    def test_bad_roles_raise_the_jax_errors(self, params, kw, match):
        messages = []
        for pkg in ("jax", "port"):
            with pytest.raises(ValueError, match=match) as e:
                _loop(pkg, params, slots=1, **kw)
            messages.append(str(e.value))
        assert messages[0] == messages[1]

    def test_prefill_role_refuses_streams_and_announces(self, params):
        messages = []
        for pkg in ("jax", "port"):
            loop = _loop(pkg, params, slots=1, role=ROLE_PREFILL)
            with pytest.raises(ValueError, match="prefill") as e:
                loop.submit([1, 2, 3, 4], 2)
            messages.append(str(e.value))
            assert loop.snapshot()["role"] == "prefill"
            assert loop.kv_summary()["role"] == "prefill"
        assert messages[0] == messages[1]

    @pytest.mark.parametrize("lane", LANES)
    def test_decode_role_still_streams(self, params, lane):
        jp, _ = params
        pr = _prompt(np.random.RandomState(0), 12)
        loop = _loop("port", params, lane, slots=1, role=ROLE_DECODE)
        st = loop.submit(pr, 3)
        loop.run_until_idle()
        assert st.full_sequence(5) == _ref_tokens(jp, pr, 3)
        assert loop.snapshot()["role"] == "decode"


# -------------------------------------------------- loop-level handoff
class TestPrefillHandoffLoop:
    @pytest.mark.parametrize("pkg,lane", _cases())
    def test_handoff_tail_only_prefill_matches_jax(self, params,
                                                   monkeypatch, pkg, lane):
        """A prefill-role loop parks the prompt's full pages, a decode
        loop ships them and prefills only the tail: the JAX package's
        report, tokens and counters; the prefill loop never decodes."""
        jp, _ = params
        rng = np.random.RandomState(1)
        head = _prompt(rng, 16)                    # 2 full pages
        full = np.concatenate([head, _prompt(rng, 4)])
        pre = _loop(pkg, params, lane, role=ROLE_PREFILL)
        dec = _loop(pkg, params, lane, role=ROLE_DECODE)
        report = pre.prefill_only(list(full))
        assert report == {"chunks": 2, "covered": 0, "cached": 2,
                          "kv_bytes": 2 * paged_kv_bytes(CFG, 1, PS)}
        assert pre.snapshot()["fleet_kv"]["prefill_handoffs"] == 1
        monkeypatch.setattr(PKGS[pkg][1], "fetch_pages",
                            lambda url, tokens, timeout, max_chunks=None:
                            pre.kv_export(list(tokens),
                                          max_chunks=max_chunks))
        assert dec.kv_ship("http://pre:1", list(full)) == 2
        st = dec.submit(full, 6)
        dec.run_until_idle()
        assert st.full_sequence(5) == _ref_tokens(jp, full, 6)
        snap = dec.snapshot()
        assert snap["prefill_tokens"] == 4       # tail only, ever
        assert snap["prefix_cache"]["hits"] == 1
        assert snap["fleet_kv"]["page_ships"] == 2
        assert pre.decode_step_programs() == 0
        assert pre.snapshot()["dispatches"] == 0
        assert _balanced(pre) and _balanced(dec)

    @pytest.mark.parametrize("pkg,lane", _cases(("kernel",)))
    def test_repeat_handoff_is_a_cheap_covered_noop(self, params, pkg,
                                                    lane):
        rng = np.random.RandomState(2)
        full = _prompt(rng, 20)
        pre = _loop(pkg, params, lane, role=ROLE_PREFILL)
        first = pre.prefill_only(list(full))
        assert (first["chunks"], first["cached"]) == (2, 2)
        again = pre.prefill_only(list(full))
        assert again["covered"] == 2 and again["cached"] == 0
        tiny = pre.prefill_only([1, 2, 3])
        assert tiny == {"chunks": 0, "covered": 0, "cached": 0,
                        "kv_bytes": 0}
        # a head that extends a parked one prefills only its new page
        longer = pre.prefill_only(list(full[:16]) + [5] * 8)
        assert (longer["chunks"], longer["covered"],
                longer["cached"]) == (3, 2, 1)
        assert pre.snapshot()["prefill_tokens"] == 16 + 8
        assert _balanced(pre)

    @pytest.mark.parametrize("pkg", ["jax", "port"])
    def test_pool_pressure_raises_overloaded_balanced(self, params, pkg):
        rng = np.random.RandomState(3)
        pre = _loop(pkg, params, n_pages=2, role=ROLE_PREFILL)
        pre.prefill_only(list(_prompt(rng, 16)))  # fills the pool
        with pytest.raises(PKGS[pkg][2]):
            pre.prefill_only(list(_prompt(rng, 24)))
        assert _balanced(pre)

    @pytest.mark.parametrize("pkg", ["jax", "port"])
    def test_chaos_on_export_leg_raises_then_recovers(self, params, pkg):
        mod = PKGS[pkg][0]
        full = _prompt(np.random.RandomState(4), 16)
        pre = _loop(pkg, params, role=ROLE_PREFILL)
        mod.configure([mod.Rule("disagg.handoff", "error", at=[0])])
        try:
            with pytest.raises(mod.ChaosError):
                pre.prefill_only(list(full))
        finally:
            mod.deactivate()
        assert _balanced(pre)
        assert pre.prefill_only(list(full))["cached"] == 2
        assert _balanced(pre)

    def test_prefill_loop_on_a_thread_never_decodes(self, params):
        """With its scheduler thread running, a prefill-role loop takes
        handoffs through the kv job queue and never dispatches."""
        rng = np.random.RandomState(5)
        _, tp = params
        with DecodeLoop(tp, CFG, slots=2, page_size=PS, device="cpu",
                        role=ROLE_PREFILL) as pre:
            for t in (16, 24, 40):
                assert pre.prefill_only(list(_prompt(rng, t)))[
                    "cached"] == t // PS
            assert pre.decode_step_programs() == 0
            snap = pre.snapshot()
            assert snap["dispatches"] == 0
            assert snap["fleet_kv"]["prefill_handoffs"] == 3
            assert pre.kv_export(list(_prompt(rng, 3))) is not None
        assert not pre.alive


# ------------------------------------------------------------ over HTTP
def _post(url, payload, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


@pytest.fixture
def servers(params):
    """A prefill-role and a decode-role port server (ships generously
    timed: the CPU computes the donor's pages)."""
    _, tp = params
    handles = []

    def serve(role):
        eng = InferenceEngine.for_transformer(tp, CFG, device="cpu")
        stub = ReplicaSet([InferenceEngine.for_transformer(tp, CFG,
                                                           device="cpu")])
        h = serve_network(replicas=stub, generate_engine=eng, slots=2,
                          page_size=PS, role=role, kv_ship_timeout=30)
        handles.append(h)
        return h, eng.decode_loop

    yield serve
    for h in handles:
        h.close()


class TestDisaggHTTP:
    def test_handoff_over_http_matches_jax(self, params, servers):
        jp, _ = params
        (pre, pre_loop), (dec, dec_loop) = servers("prefill"), \
            servers("decode")
        head = list(range(1, 17))
        full = head + [3, 1, 4, 1]
        assert _get(f"{pre.url}/readyz")["role"] == "prefill"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{pre.url}/generate", {"prompt": [full],
                                          "max_tokens": 2})
        assert e.value.code == 400
        report = _post(f"{pre.url}/prefill", {"prompt": [full]})
        assert (report["chunks"], report["cached"]) == (2, 2)
        out = _post(f"{dec.url}/generate", {"prompt": [full],
                                            "max_tokens": 4,
                                            "kv_donor": pre.url})
        assert out["tokens"] == [_ref_tokens(jp, full, 4)]
        assert out["finish_reasons"] == ["max_tokens"]
        pre_stats = _get(f"{pre.url}/stats")
        assert pre_stats["role"] == "prefill"
        pdec = pre_stats["generate"]["decode"]
        assert pdec["fleet_kv"]["prefill_handoffs"] == 1
        assert pdec["decode_step_programs"] == 0
        ddec = _get(f"{dec.url}/stats")["generate"]["decode"]
        assert ddec["fleet_kv"]["page_ships"] == 2
        assert ddec["fleet_kv"]["ship_failures"] == 0
        assert ddec["prefill_tokens"] == 4
        assert ddec["prefix_cache"]["hits"] == 1
        # a 2-row prefill answers per-row reports and their sums
        two = _post(f"{pre.url}/prefill",
                    {"prompt": [full, list(range(0, 16))]})
        assert len(two["rows"]) == 2 and two["covered"] == 2
        assert _balanced(pre_loop) and _balanced(dec_loop)

    def test_chaos_at_each_handoff_leg_degrades_to_the_same_tokens(
            self, params, servers):
        jp, _ = params
        (pre, _), (dec, dec_loop) = servers("prefill"), servers("decode")
        rng = np.random.RandomState(8)
        # export leg: /prefill answers 500; the stream prefills it all
        p1 = [int(t) for t in _prompt(rng, 20)]
        chaos.configure([chaos.Rule("disagg.handoff", "error", at=[0])])
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{pre.url}/prefill", {"prompt": [p1]})
            assert e.value.code == 500
        finally:
            chaos.deactivate()
        out = _post(f"{dec.url}/generate", {"prompt": [p1], "max_tokens": 4,
                                            "kv_donor": pre.url})
        assert out["tokens"] == [_ref_tokens(jp, p1, 4)]
        # install leg: the decode server skips the ship, prefills it all
        p2 = [int(t) for t in _prompt(rng, 20)]
        _post(f"{pre.url}/prefill", {"prompt": [p2]})
        before = dec_loop.snapshot()
        chaos.configure([chaos.Rule("disagg.handoff", "error", at=[0])])
        try:
            out = _post(f"{dec.url}/generate", {"prompt": [p2],
                                                "max_tokens": 4,
                                                "kv_donor": pre.url})
        finally:
            chaos.deactivate()
        assert out["tokens"] == [_ref_tokens(jp, p2, 4)]
        after = dec_loop.snapshot()
        assert after["fleet_kv"]["page_ships"] == \
            before["fleet_kv"]["page_ships"]
        assert after["prefill_tokens"] - before["prefill_tokens"] == len(p2)
        # a ship fault (chaos fleet.kv_ship) is a counted failure
        p3 = [int(t) for t in _prompt(rng, 20)]
        _post(f"{pre.url}/prefill", {"prompt": [p3]})
        failures = dec_loop.snapshot()["fleet_kv"]["ship_failures"]
        chaos.configure([chaos.Rule("fleet.kv_ship", "error", at=[0])])
        try:
            out = _post(f"{dec.url}/generate", {"prompt": [p3],
                                                "max_tokens": 4,
                                                "kv_donor": pre.url})
        finally:
            chaos.deactivate()
        assert out["tokens"] == [_ref_tokens(jp, p3, 4)]
        assert dec_loop.snapshot()["fleet_kv"]["ship_failures"] == \
            failures + 1
        assert _balanced(dec_loop)


# ------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the captured step runs only "
                    "there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_pages_shipped_after_capture_decode_like_a_cold_loop(card):
    """The receiver's step graph is captured first; the shipped pages
    are then installed in place (the graph reads the pool's addresses),
    and the next replays' tokens equal a cold loop's. The model has the
    kernels' head dim (64) and the port's own initialiser."""
    cfg = tf.TransformerConfig(vocab_size=53, d_model=128, n_heads=2,
                               n_layers=2, d_ff=64, max_len=64)
    tp = tf.init_transformer_params(0, cfg, device=card)
    rng = np.random.RandomState(9)
    head = rng.randint(0, 53, 16).astype(np.int32)
    full = np.concatenate([head, rng.randint(0, 53, 5).astype(np.int32)])
    pre = DecodeLoop(tp, cfg, slots=2, page_size=PS, start=False,
                     role=ROLE_PREFILL)
    dec = DecodeLoop(tp, cfg, slots=2, page_size=PS, start=False)
    cold = DecodeLoop(tp, cfg, slots=2, page_size=PS, start=False,
                      prefix_cache=False)
    warm_up = dec.submit(rng.randint(0, 53, 9).astype(np.int32), 3)
    dec.run_until_idle()
    warm_up.result(5)
    assert dec.decode_step_programs() == 1  # captured before the ship
    pre.prefill_only(list(full))
    _, chunks = fleetkv.unpack_pages(pre.kv_export(list(head)))
    ptrs = [layer["k"].data_ptr() for layer in dec._pool.layers]
    assert dec._kv_install(list(head), chunks, 30.0) == 2
    assert ptrs == [layer["k"].data_ptr() for layer in dec._pool.layers]
    st = dec.submit(full, 8)
    dec.run_until_idle()
    ref = cold.submit(full, 8)
    cold.run_until_idle()
    assert dec.snapshot()["prefill_tokens"] - 9 == 5
    assert st.result(5) == ref.result(5)
    assert dec.decode_step_programs() == 1
