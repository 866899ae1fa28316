"""The PyTorch port's speculative decoding (paged_verify_step, the ngram
and model drafters, the DecodeLoop's draft-and-verify rounds) held
against the JAX package on the CPU.

- `paged_verify_step`: logits within 1e-4 of JAX's on both lanes, with
  ragged widths 0 / 1 / k+1; pages the step does not write bit-equal,
  the K/V it writes within 1e-6; and one widened step equal to W chained
  `paged_decode_step` calls (1e-5), as the JAX package's own test holds.
- The drafters propose exactly what the JAX package's do for the same
  histories and windows.
- The loop (JAX: kernel="gather", fleet_kv="off"; the port on both
  lanes) gives the plain loop's tokens, and JAX's speculative loop's
  tokens and proposed / accepted / rounds, with the page invariant
  checked after every tick.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer as jax_tf
from deeplearning4j_tpu.serving import paged_kv as jax_paged
from deeplearning4j_tpu.serving import speculation as jax_spec
from deeplearning4j_tpu.serving.decode_loop import DecodeLoop as JaxLoop
from deeplearning4j_tpu_torch.models import transformer as tf
from deeplearning4j_tpu_torch.serving import paged_kv, speculation
from deeplearning4j_tpu_torch.serving.decode_loop import DecodeLoop
from deeplearning4j_tpu_torch.weights import params_from_jax

LOGIT_TOL = 1e-4
WRITTEN_TOL = 1e-6
JAX_CFG = jax_tf.TransformerConfig(vocab_size=17, d_model=32, n_heads=2,
                                   n_layers=2, d_ff=64, max_len=64,
                                   interpret=True)
CFG = tf.TransformerConfig(vocab_size=17, d_model=32, n_heads=2,
                           n_layers=2, d_ff=64, max_len=64)
JAX_DRAFT_CFG = jax_tf.TransformerConfig(vocab_size=17, d_model=16,
                                         n_heads=2, n_layers=1, d_ff=32,
                                         max_len=64, interpret=True)
DRAFT_CFG = tf.TransformerConfig(vocab_size=17, d_model=16, n_heads=2,
                                 n_layers=1, d_ff=32, max_len=64)
PS = 8
LANES = ("gather", "kernel")
#: the JAX package's `test_self_draft_accepts_nearly_everything` setup
#: reaches this acceptance rate, not the 0.9 that test asks for (ROADMAP
#: Queue 3); the port must reproduce it
JAX_SELF_DRAFT_ACCEPTANCE = 0.6727272727272727


def _to_port(jp):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")


@pytest.fixture(scope="module")
def params():
    jp = jax_tf.init_transformer_params(jax.random.PRNGKey(0), JAX_CFG)
    return jp, _to_port(jp)


@pytest.fixture(scope="module")
def draft_params():
    jp = jax_tf.init_transformer_params(jax.random.PRNGKey(7), JAX_DRAFT_CFG)
    return jp, _to_port(jp)


def _prompt(rng, t):
    return rng.randint(0, CFG.vocab_size, (t,)).astype(np.int32)


# --------------------------------------------------- verify-step parity
def _seeded(jp, tp, prompts, width, n_pages=16):
    """Both packages' pools after one prefill of `prompts`, with tables
    granting `width` positions past each prompt."""
    n = len(prompts)
    pps = paged_kv.pages_per_slot(CFG, PS)
    trash = n_pages
    table = np.full((n, pps), trash, np.int32)
    lengths = np.zeros((n,), np.int32)
    tb = 16
    padded = np.zeros((n, tb), np.int32)
    pids = np.full((n, tb // PS), trash, np.int32)
    free = list(range(n_pages))
    for i, pr in enumerate(prompts):
        padded[i, :len(pr)] = pr
        need = paged_kv.pages_for_tokens(len(pr) + width, PS)
        pages = [free.pop(0) for _ in range(need)]
        own = paged_kv.pages_for_tokens(len(pr), PS)
        pids[i, :own] = pages[:own]
        table[i, :need] = pages
        lengths[i] = len(pr)
    _, jpool = jax_paged.paged_prefill(
        jp, jnp.asarray(padded), jnp.asarray(lengths),
        jax_paged.init_paged_pool(JAX_CFG, n_pages, PS),
        jnp.asarray(pids), JAX_CFG)
    pool = paged_kv.PagedKVPool([
        {"k": torch.from_numpy(np.array(layer["k"])),
         "v": torch.from_numpy(np.array(layer["v"]))}
        for layer in jpool.layers])
    return jpool, pool, table, lengths


class TestVerifyStep:
    @pytest.mark.parametrize("lane", LANES)
    def test_matches_jax_with_ragged_widths(self, params, lane):
        """widths k+1 / 1 / 0 / k+1 (one slot idle, one plain), from one
        JAX-written pool: logits and the pool against JAX's gather lane."""
        jp, tp = params
        rng = np.random.RandomState(3)
        W = 4
        prompts = [_prompt(rng, t) for t in (10, 5, 8, 16)]
        jpool, pool, table, lengths = _seeded(jp, tp, prompts, W, 20)
        before = [{n: layer[n].clone() for n in ("k", "v")}
                  for layer in pool.layers]
        tokens = rng.randint(0, CFG.vocab_size, (4, W)).astype(np.int32)
        widths = np.asarray([W, 1, 0, W], np.int32)
        jlog, jpool = jax_paged.paged_verify_step(
            jp, jnp.asarray(tokens), jpool, jnp.asarray(table),
            jnp.asarray(lengths), jnp.asarray(widths), JAX_CFG,
            kernel="gather")
        log, out = paged_kv.paged_verify_step(
            tp, torch.from_numpy(tokens), pool, torch.from_numpy(table),
            torch.from_numpy(lengths), torch.from_numpy(widths), CFG,
            kernel=lane)
        assert out is pool
        jlog = np.asarray(jlog)
        written = set()
        for i in range(4):
            for j in range(int(widths[i])):
                np.testing.assert_allclose(log[i, j].numpy(), jlog[i, j],
                                           atol=LOGIT_TOL, rtol=0)
                pos = int(lengths[i]) + j
                written.add((int(table[i, pos // PS]), pos % PS))
        n_pages = pool.n_pages
        for layer, jlayer, old in zip(pool.layers, jpool.layers, before):
            for name in ("k", "v"):
                got, ref = layer[name].numpy(), np.asarray(jlayer[name])
                mask = np.ones(got.shape[:1] + got.shape[2:3], bool)
                for page, off in written:
                    mask[page, off] = False
                mask[n_pages] = False  # the trash page: unspecified
                np.testing.assert_array_equal(got.transpose(0, 2, 1, 3)[mask],
                                              ref.transpose(0, 2, 1, 3)[mask])
                np.testing.assert_array_equal(
                    got.transpose(0, 2, 1, 3)[mask],
                    old[name].numpy().transpose(0, 2, 1, 3)[mask])
                for page, off in written:
                    np.testing.assert_allclose(got[page, :, off],
                                               ref[page, :, off],
                                               atol=WRITTEN_TOL, rtol=0)

    @pytest.mark.parametrize("lane", LANES)
    def test_equals_chained_decode_steps(self, params, lane):
        """One widened step == W teacher-forced single-token steps."""
        jp, tp = params
        rng = np.random.RandomState(4)
        W = 4
        prompts = [_prompt(rng, t) for t in (10, 5, 8)]
        tokens = rng.randint(0, CFG.vocab_size, (3, W)).astype(np.int32)
        widths = np.asarray([4, 4, 2], np.int32)
        _, pool_a, table, lengths = _seeded(jp, tp, prompts, W)
        cur = lengths.copy()
        ref = {}
        for j in range(W):
            act = widths > j
            lg, _ = paged_kv.paged_decode_step(
                tp, torch.from_numpy(tokens[:, j].copy()), pool_a,
                torch.from_numpy(table), torch.from_numpy(cur),
                torch.from_numpy(act), CFG, kernel=lane)
            for i in range(3):
                if act[i]:
                    ref[i, j] = lg[i]
            cur = cur + act.astype(np.int32)
        _, pool_b, table, lengths = _seeded(jp, tp, prompts, W)
        lg, _ = paged_kv.paged_verify_step(
            tp, torch.from_numpy(tokens), pool_b, torch.from_numpy(table),
            torch.from_numpy(lengths), torch.from_numpy(widths), CFG,
            kernel=lane)
        for (i, j), r in ref.items():
            torch.testing.assert_close(lg[i, j], r, atol=1e-5, rtol=0)

    def test_rejects_unresolved_kernel(self, params):
        _, tp = params
        pool = paged_kv.init_paged_pool(CFG, 4, PS, device="cpu")
        z = torch.zeros((1,), dtype=torch.int32)
        with pytest.raises(ValueError, match="resolve 'auto'"):
            paged_kv.paged_verify_step(
                tp, torch.zeros((1, 2), dtype=torch.int32), pool,
                torch.zeros((1, 8), dtype=torch.int32), z, z + 1, CFG,
                kernel="auto")


# ------------------------------------------------------- drafter parity
NGRAM_CASES = [
    (3, None, [1, 5, 6, 7, 8, 9, 2, 5, 6, 7], 2),
    (1, None, [4, 1, 4, 2, 4], 1),
    (2, None, [1, 2, 3, 4, 9, 1, 2, 5, 1, 2], 3),
    (2, None, [1, 2, 3, 4, 9, 1, 2, 5, 1, 2], 4),
    (3, None, [7, 8] + [5] * 10, 4),
    (3, None, [9, 9, 3, 1, 2, 3], 1),
    (2, [[1, 2, 3, 4, 5, 6]], [7, 2, 3], 3),
    (2, [[2, 3, 9]], [2, 3, 8, 2, 3], 1),
    (3, None, [1, 2, 3], 4),
    (3, None, [5], 4),
    (3, None, [1, 2, 3], 0),
]


class TestDrafters:
    @pytest.mark.parametrize("case", range(len(NGRAM_CASES)))
    def test_ngram_proposals_equal_jax(self, case):
        n, corpus, hist, k = NGRAM_CASES[case]
        get = (lambda: corpus) if corpus is not None else None
        got = speculation.NgramDrafter(n, corpus=get).propose(hist, k)
        assert got == jax_spec.NgramDrafter(n, corpus=get).propose(hist, k)

    def test_ngram_random_histories_equal_jax(self):
        rng = np.random.RandomState(11)
        corpus = [rng.randint(0, 5, (rng.randint(4, 30),)).tolist()
                  for _ in range(4)]
        port = speculation.NgramDrafter(3, corpus=lambda: corpus)
        ref = jax_spec.NgramDrafter(3, corpus=lambda: corpus)
        for _ in range(200):
            hist = rng.randint(0, 5, (rng.randint(0, 25),)).tolist()
            k = int(rng.randint(0, 6))
            assert port.propose(hist, k) == ref.propose(hist, k)

    def test_model_proposals_equal_jax(self, draft_params):
        jdp, tdp = draft_params
        rng = np.random.RandomState(12)
        port = speculation.ModelDrafter(tdp, DRAFT_CFG, window=8,
                                        device="cpu")
        ref = jax_spec.ModelDrafter(jdp, JAX_DRAFT_CFG, window=8)
        assert port.draft_programs() == 0
        for _ in range(3):
            win = rng.randint(0, 17, (4, 8)).astype(np.int32)
            win[0, :5] = 0  # a left-padded short history
            np.testing.assert_array_equal(port.propose_all(win, 3),
                                          ref.propose_all(win, 3))
        assert port.draft_programs() == 1
        assert speculation.ModelDrafter(tdp, DRAFT_CFG, window=1000,
                                        device="cpu").window == 64

    def test_build_drafter_validation(self, draft_params):
        _, tdp = draft_params
        with pytest.raises(ValueError, match="draft_params"):
            speculation.build_drafter("model", k=4, cfg=CFG)
        with pytest.raises(ValueError, match="vocab_size"):
            speculation.build_drafter(
                "model", k=4, cfg=CFG, draft_params=tdp,
                draft_cfg=DRAFT_CFG._replace(vocab_size=99))
        with pytest.raises(ValueError, match="drafter"):
            speculation.build_drafter("oracle", k=4, cfg=CFG)
        with pytest.raises(ValueError, match="ngram"):
            speculation.build_drafter("ngram", k=4, cfg=CFG, ngram=0)


# ------------------------------------------------------ loop parity
PROMPTS = ([1, 2, 3, 4, 5, 6, 7, 8], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
           [7, 7, 7, 7])
MT = (24, 20, 16)


def _balance(loop):
    assert (len(loop._free) + loop.pages_in_use + loop._cached_unref()
            == loop.n_pages)


def _drain(loop, max_ticks=400):
    for _ in range(max_ticks):
        with loop._cond:
            if not loop._waiting and loop.occupied_slots == 0:
                return
        loop.tick()
        _balance(loop)
    raise AssertionError("loop did not drain")


def _run(loop, submit=None):
    streams = (submit(loop) if submit is not None
               else loop.submit_many(list(PROMPTS), list(MT)))
    _drain(loop)
    snap = loop.snapshot()
    spec = snap["speculation"]
    return {"tokens": [s.result(0) for s in streams],
            "reasons": [s.finish_reason for s in streams],
            "spec": {k: spec[k] for k in ("proposed", "accepted",
                                          "rounds")},
            "prefix": {k: snap["prefix_cache"][k]
                       for k in ("hits", "misses", "forks")}}


def _eos_submit(loop):
    return [loop.submit(PROMPTS[0], 24, eos_id=EOS)]


def _mixed_submit(loop):
    return [loop.submit(PROMPTS[0], MT[0]),
            loop.submit(PROMPTS[1], MT[1], speculation=False),
            loop.submit(PROMPTS[2], MT[2])]


def _reuse_submit(loop):
    a = loop.submit(PROMPTS[1], 20)
    _drain(loop)
    return [a, loop.submit(PROMPTS[1], 20)]


#: an id the plain run emits mid-generation for PROMPTS[0] (set below)
EOS = None

#: case -> (loop options beyond speculation, submit function)
CASES = {
    "ngram": ({"speculation": 4}, None),
    "model": ({"speculation": 3, "drafter": "model", "draft_window": 16},
              None),
    "self_draft": ({"speculation": 3, "drafter": "model",
                    "draft_window": 32}, None),
    "eos_mid_round": ({"speculation": 4}, _eos_submit),
    "opt_out": ({"speculation": 4},
                lambda lp: lp.submit_many(list(PROMPTS), list(MT),
                                          speculation=False)),
    "mixed_opt_in_out": ({"speculation": 4}, _mixed_submit),
    "prefix_reuse": ({"speculation": 4, "slots": 4}, _reuse_submit),
}


def _draft_kw(case, jax_side, params, draft_params):
    kw = dict(CASES[case][0])
    if kw.get("drafter") == "model":
        pick = 0 if jax_side else 1
        if case == "self_draft":
            kw.update(draft_params=params[pick],
                      draft_cfg=JAX_CFG if jax_side else CFG)
        else:
            kw.update(draft_params=draft_params[pick],
                      draft_cfg=JAX_DRAFT_CFG if jax_side else DRAFT_CFG)
    kw.setdefault("slots", 4)
    return kw


@pytest.fixture(scope="module")
def jax_runs(params, draft_params):
    global EOS
    jp, _ = params
    plain = _run(JaxLoop(jp, JAX_CFG, slots=4, page_size=PS,
                         kernel="gather", fleet_kv="off", start=False))
    gen = plain["tokens"][0]
    EOS = gen[len(gen) // 2]
    cache = {"plain": plain}

    def get(case):
        if case not in cache:
            kw = _draft_kw(case, True, params, draft_params)
            cache[case] = _run(JaxLoop(jp, JAX_CFG, page_size=PS,
                                       kernel="gather", fleet_kv="off",
                                       start=False, **kw), CASES[case][1])
        return cache[case]

    return get


class TestSpeculativeLoop:
    @pytest.mark.parametrize("lane", LANES)
    @pytest.mark.parametrize("case", list(CASES))
    def test_matches_plain_and_jax(self, params, draft_params, jax_runs,
                                   case, lane):
        _, tp = params
        ref = jax_runs(case)
        kw = _draft_kw(case, False, params, draft_params)
        loop = DecodeLoop(tp, CFG, page_size=PS, kernel=lane, device="cpu",
                          start=False, **kw)
        got = _run(loop, CASES[case][1])
        assert got == ref
        plain = jax_runs("plain")["tokens"]
        if case == "eos_mid_round":
            full = plain[0]
            assert got["tokens"][0] == full[:full.index(EOS) + 1]
            assert got["reasons"] == ["eos"]
        elif case in ("prefix_reuse",):
            assert got["tokens"][0] == got["tokens"][1] == plain[1]
            assert got["prefix"]["hits"] >= 1
        elif case == "mixed_opt_in_out":
            assert got["tokens"] == plain
        else:
            assert got["tokens"] == plain
        assert loop.decode_step_programs() <= 2
        spec = loop.snapshot()["speculation"]
        assert 0 <= spec["accepted"] <= spec["proposed"]
        if case == "opt_out":
            assert spec["proposed"] == 0
        else:
            assert spec["rounds"] >= 1 and spec["proposed"] > 0
        if case == "self_draft":
            # the JAX package's acceptance on this setup, reproduced
            assert spec["acceptance_rate"] == pytest.approx(
                JAX_SELF_DRAFT_ACCEPTANCE, abs=1e-12)
        if CASES[case][0].get("drafter") == "model":
            assert spec["draft_programs"] == 1

    def test_corpus_feeds_from_prefix_trie(self, params):
        _, tp = params
        seed_prompt = list(range(1, 13))
        loop = DecodeLoop(tp, CFG, slots=2, page_size=PS, speculation=4,
                          device="cpu", start=False)
        loop.submit(seed_prompt, 4)
        _drain(loop)
        assert loop.snapshot()["prefix_cache"]["nodes"] >= 1
        corpus = list(loop._prefix.iter_sequences())
        assert seed_prompt[:8] in [c[:8] for c in corpus]
        assert loop._drafter.propose([9, 1, 2, 3], 3) == [4, 5, 6]

    def test_validation(self, params, draft_params):
        _, tp = params
        _, tdp = draft_params
        with pytest.raises(ValueError, match="speculation"):
            DecodeLoop(tp, CFG, speculation=-1, device="cpu", start=False)
        with pytest.raises(ValueError, match="mutually exclusive"):
            DecodeLoop(tp, CFG, speculation=4, horizon=2, device="cpu",
                       start=False)
        with pytest.raises(ValueError, match="vocab_size"):
            DecodeLoop(tp, CFG, speculation=4, drafter="model",
                       draft_params=tdp,
                       draft_cfg=DRAFT_CFG._replace(vocab_size=5),
                       device="cpu", start=False)

    def test_speculation_off_by_default(self, params):
        _, tp = params
        loop = DecodeLoop(tp, CFG, device="cpu", start=False)
        assert loop.spec_k == 0 and loop._drafter is None
        snap = loop.snapshot()["speculation"]
        assert snap["enabled"] is False and snap["drafter"] is None
        stream = loop.submit_many([[1, 2]], 2)[0]
        assert stream.speculation is True
        with pytest.raises(ValueError, match="max_tokens needs 3"):
            loop.submit_many([[1, 2]] * 3, [4, 4])
