"""The PyTorch port's fleet router (serving/router.py) on the CPU: the
JAX package's router contracts over port replicas, and the JAX router
over JAX replicas side by side with the port router over port replicas.

- Durable `/generate` streams (`tests/test_stream_failover.py`'s tier-1
  classes): a replica reset mid-stream resumes on the survivor, the
  client's `token_index` gapless and duplicate-free, the tokens equal to
  an uninterrupted run; non-streamed rows survive; bounded resume (502
  before the first byte, in-band after it); the `router.stream_resume`
  chaos point; the prefix-cache opt-out across the hop; the horizon and
  speculation lanes; exactly-once dedupe against a noisy stub. The
  SIGKILL / SIGSTOP drills on spawned `cli serve --device cpu` processes
  keep `@slow`.
- Fleet KV placement (`tests/test_fleetkv.py`'s `TestRouterAffinity` and
  `TestOptOutTwin`) and the disaggregated roles
  (`tests/test_disagg.py`'s `TestRoleFences`, `TestMultiModelRouting`,
  `TestRouterHandoffDispatch`, the router-driven handoff over port
  servers, and the `@slow` prefill-SIGKILL drill).
- Parity: one float32 transformer (the JAX package's initialiser, carried
  across by `weights.params_from_jax`) behind a JAX router over two JAX
  servers and a port router over two port servers: identical tokens
  (also equal to the JAX package's `generate_cached`), the same
  `/healthz`, `/stats` and 502 shapes by key, and the same
  `dl4j_fleet_*` series names.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.models import transformer as jax_tf
from deeplearning4j_tpu.serving.kv_cache import generate_cached
from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.models import transformer as tf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import (Fleet, InferenceEngine,
                                             serve_fleet, serve_network)
from deeplearning4j_tpu_torch.serving import fleetkv
from deeplearning4j_tpu_torch.serving.decode_loop import DecodeLoop
from deeplearning4j_tpu_torch.serving.fleet import EVICTED, NoReadyReplicas
from deeplearning4j_tpu_torch.testing import chaos
from deeplearning4j_tpu_torch.testing.chaos import Rule
from deeplearning4j_tpu_torch.utils.httpd import start_http_server
from deeplearning4j_tpu_torch.weights import params_from_jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_CFG = jax_tf.TransformerConfig(vocab_size=17, d_model=32, n_heads=2,
                                   n_layers=2, d_ff=64, max_len=64,
                                   interpret=True)
CFG = tf.TransformerConfig(vocab_size=17, d_model=32, n_heads=2,
                           n_layers=2, d_ff=64, max_len=64)
#: the replica spec spawned processes build with the port's initialiser
SPEC = {"vocab_size": 17, "d_model": 32, "n_heads": 2, "n_layers": 2,
        "d_ff": 64, "max_len": 64, "seed": 0}


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    chaos.deactivate()


@pytest.fixture(scope="module")
def jax_params():
    return jax_tf.init_transformer_params(jax.random.PRNGKey(0), JAX_CFG)


@pytest.fixture(scope="module")
def tf_setup(jax_params):
    """The JAX package's weights on the port (so every reference token
    can also come from the JAX package)."""
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params),
                           device="cpu"), CFG


def _ref_tokens(jp, prompt, n):
    """prompt + n greedy tokens from the JAX package's generate_cached."""
    return np.asarray(generate_cached(
        jp, jnp.asarray(np.asarray(prompt)[None]), JAX_CFG, n))[0].tolist()


def _prompt(rng, t):
    return rng.randint(0, CFG.vocab_size, (t,)).astype(np.int32)


def _post(url, payload, timeout=120, headers=()):
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(dict(headers))
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers=hdrs)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _stream(url, payload, timeout=120):
    """POST a streaming /generate and return the NDJSON events."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"].startswith(
            "application/x-ndjson")
        return [json.loads(ln) for ln in r if ln.strip()]


def _net(n_in=4, n_out=3):
    conf = (NeuralNetConfiguration.builder()
            .lr(0.1).n_in(n_in).activation_function("tanh")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(1).use_adagrad(False)
            .list(2).hidden_layer_sizes([8])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=n_out)
            .pretrain(False).build())
    return MultiLayerNetwork(conf, device="cpu")


def _write_spec(tmp_path):
    from deeplearning4j_tpu_torch.scaleout.checkpoint import \
        DefaultModelSaver

    ckpt = str(tmp_path / "replica.ckpt")
    if not os.path.exists(ckpt):
        DefaultModelSaver(ckpt, keep_old=False).save(_net())
    spec = str(tmp_path / "tf.json")
    if not os.path.exists(spec):
        with open(spec, "w") as f:
            json.dump(SPEC, f)
    return ckpt, spec

class _Pair:
    """N in-process replicas serving the SAME transformer weights
    behind a router — the interchangeability the failover leans on."""

    def __init__(self, tf_setup, n=2, prefix_cache=True, serve_kw=None,
                 **fleet_kw):
        params, cfg = tf_setup
        self.handles = []
        for _ in range(n):
            gen = InferenceEngine.for_transformer(
                params, cfg, prefix_cache=prefix_cache, device="cpu")
            self.handles.append(serve_network(
                _net(), n_replicas=1, max_delay_ms=1.0,
                generate_engine=gen, slots=4, page_size=8,
                prefix_cache=prefix_cache, **dict(serve_kw or {})))
        fleet_kw.setdefault("heartbeat_timeout", 5.0)
        self.fleet = Fleet(start=False, **fleet_kw)
        for h in self.handles:
            self.fleet.attach(h.url)
        for _ in range(200):
            self.fleet.poll()
            if self.fleet.ready_count() >= n:
                break
            time.sleep(0.02)
        assert self.fleet.ready_count() >= n
        self.router = serve_fleet(self.fleet)

    @property
    def url(self):
        return self.router.url

    def decode_stats(self):
        return [_get(f"{h.url}/stats")["generate"]["decode"]
                for h in self.handles]

    def close(self):
        self.router.close()
        for h in self.handles:
            h.close()


def _token_events(events):
    return [e for e in events if "token" in e]


# =========================== in-process failover (tier-1 deterministic)
@pytest.mark.chaos
class TestMidStreamFailover:
    def test_reset_resumes_on_survivor_bit_identical(self, tf_setup):
        """In-process drill: a replica hard-resets its
        socket mid-stream; the router resumes the generation on the
        survivor and the client sees a gapless, duplicate-free stream
        bit-identical to an uninterrupted reference — plus the
        dl4j_fleet_stream_* series live on the router's /metrics."""
        pair = _Pair(tf_setup)
        body = {"prompt": [[1, 2, 3, 4]], "max_tokens": 8,
                "stream": True}
        try:
            ref = _stream(f"{pair.url}/generate", body)
            ref_toks = [e["token"] for e in _token_events(ref)]
            assert len(ref_toks) == 8
            # 3rd chunk write resets the connection: 2 tokens made it
            # out, the rest must come from the survivor
            chaos.configure([Rule("generate.midstream", "reset",
                                  at=[3])])
            out = _stream(f"{pair.url}/generate", body)
            chaos.deactivate()
            toks = _token_events(out)
            assert [e["token"] for e in toks] == ref_toks
            assert [e["token_index"] for e in toks] == list(range(8))
            done = out[-1]
            assert done["done"] and done["resumes"] == 1
            assert done["tokens"] == ref[-1]["tokens"]
            assert done["finish_reasons"] == ["max_tokens"]
            snap = pair.fleet.snapshot()
            assert snap["stream_resumes"] >= 1
            assert snap["stream_resume_failures"] == 0
            # replay prefill = prompt + the 2 delivered tokens
            assert snap["stream_tokens_replayed"] >= 6
            # the victim's reset cancelled its slots (pages freed); the
            # survivor retired the resumed row; and resume was ordinary
            # admission — never a new program
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                decs = pair.decode_stats()
                if all(d["pages_in_use"] == 0 for d in decs):
                    break
                time.sleep(0.05)
            assert all(d["pages_in_use"] == 0 for d in decs)
            assert all(d["decode_step_programs"] == 1 for d in decs)
            # satellite: the counters scrape END TO END off the live
            # router /metrics (process-global registry — match THIS
            # fleet's label, earlier tests leave their series behind)
            with urllib.request.urlopen(f"{pair.url}/metrics",
                                        timeout=30) as r:
                text = r.read().decode()
            label = f'fleet="{pair.fleet.label}"'
            for series in ("dl4j_fleet_stream_resumes",
                           "dl4j_fleet_stream_resume_failures",
                           "dl4j_fleet_stream_tokens_replayed",
                           "dl4j_fleet_stream_tokens_deduped"):
                assert series in text
            resumed = [ln for ln in text.splitlines()
                       if ln.startswith(
                           "dl4j_fleet_stream_resumes_total{")
                       and label in ln]
            assert resumed and float(resumed[0].split()[-1]) >= 1
        finally:
            pair.close()

    def test_nonstream_multirow_rows_survive_replica_death(
            self, tf_setup):
        """Non-streaming /generate through the router
        must not lose already-generated rows when the replica fails
        mid-batch — the router buffers per-row progress, resumes the
        unfinished rows, and the aggregated reply (rows AND
        finish_reasons) matches an uninterrupted reference."""
        pair = _Pair(tf_setup)
        body = {"prompt": [[1, 2, 3], [4, 5, 6, 7]],
                "max_tokens": 6}
        try:
            ref = _post(f"{pair.url}/generate", body)
            assert ref["finish_reasons"] == ["max_tokens", "max_tokens"]
            chaos.configure([Rule("generate.midstream", "reset",
                                  at=[5])])
            out = _post(f"{pair.url}/generate", body)
            chaos.deactivate()
            assert out["tokens"] == ref["tokens"]
            assert out["finish_reasons"] == ref["finish_reasons"]
            assert out["resumes"] >= 1
        finally:
            pair.close()

    def test_resume_exhaustion_falls_back_inband_with_attempts(
            self, tf_setup):
        """No survivor to resume on: the stream ends with the legacy
        in-band retryable error, now carrying `resume_attempts`."""
        pair = _Pair(tf_setup, n=1)
        try:
            chaos.configure([Rule("generate.midstream", "reset",
                                  at=[3])])
            out = _stream(f"{pair.url}/generate",
                          {"prompt": [[1, 2, 3, 4]], "max_tokens": 8,
                           "stream": True})
            chaos.deactivate()
            toks = _token_events(out)
            assert len(toks) == 3  # delivered before the reset (0-based
            assert [e["token_index"] for e in toks] == [0, 1, 2]  # at=3)
            err = out[-1]
            assert err["error"] == "replica_failed"
            assert err["retryable"] is True
            assert err["resume_attempts"] == 1  # tried, no survivor
            assert not any(e.get("done") for e in out)
            assert pair.fleet.snapshot()["stream_resume_failures"] >= 1
        finally:
            pair.close()

    def test_resume_exhaustion_before_first_byte_is_502(self, tf_setup):
        """A non-streaming client never saw a byte, so exhaustion keeps
        the clean status-code contract: 502 + the structured shape."""
        pair = _Pair(tf_setup, n=1)
        try:
            chaos.configure([Rule("generate.midstream", "reset",
                                  at=[2])])
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{pair.url}/generate",
                      {"prompt": [[1, 2, 3]], "max_tokens": 5})
            chaos.deactivate()
            assert e.value.code == 502
            body = json.loads(e.value.read())
            assert body["error"] == "replica_failed"
            assert body["retryable"] is True
            assert body["resume_attempts"] == 1
        finally:
            pair.close()

    def test_stream_resume_chaos_point_blocks_every_resume(
            self, tf_setup):
        """The `router.stream_resume` chaos point sits exactly on the
        re-admission path: an injected error there exhausts the
        bounded attempts even though a healthy survivor exists."""
        pair = _Pair(tf_setup)
        try:
            chaos.configure([Rule("generate.midstream", "reset",
                                  at=[3]),
                             Rule("router.stream_resume", "error",
                                  message="resume forbidden")])
            out = _stream(f"{pair.url}/generate",
                          {"prompt": [[1, 2, 3, 4]], "max_tokens": 8,
                           "stream": True})
            chaos.deactivate()
            err = out[-1]
            assert err["error"] == "replica_failed"
            assert err["resume_attempts"] == \
                pair.fleet.stream_resume_attempts
            assert "resume blocked" in err["detail"]
        finally:
            pair.close()

    def test_prefix_cache_optout_not_seeded_on_replay(self, tf_setup):
        """A resumed `"prefix_cache": false` request
        must neither match nor seed the cache on replay — and the
        positive twin seeds the survivor exactly as a normal retire
        would."""
        # the replayed prompt (original 6 + 3 delivered = 9 tokens)
        # spans a full 8-token page, so the survivor's retire WOULD
        # seed it — unless the opt-out rides the hop
        body = {"prompt": [[1, 2, 3, 4, 5, 6]], "max_tokens": 8,
                "stream": True}
        # opt-out: after a resumed completion, EVERY replica's cache
        # is still empty
        pair = _Pair(tf_setup)
        try:
            chaos.configure([Rule("generate.midstream", "reset",
                                  at=[3])])
            out = _stream(f"{pair.url}/generate",
                          dict(body, prefix_cache=False))
            chaos.deactivate()
            assert out[-1]["done"] and out[-1]["resumes"] == 1
            for dec in pair.decode_stats():
                assert dec["prefix_cache"]["hits"] == 0
                assert dec["prefix_cache"]["nodes"] == 0
                assert dec["prefix_cache"]["pages_cached"] == 0
        finally:
            pair.close()
        # default: the survivor's retire seeds the cache with the
        # replayed-and-finished sequence
        pair = _Pair(tf_setup)
        try:
            chaos.configure([Rule("generate.midstream", "reset",
                                  at=[3])])
            out = _stream(f"{pair.url}/generate", body)
            chaos.deactivate()
            assert out[-1]["done"] and out[-1]["resumes"] == 1
            assert sum(d["prefix_cache"]["nodes"]
                       for d in pair.decode_stats()) > 0
        finally:
            pair.close()


# ============== decode-lane variants: horizon chaining + speculation
@pytest.mark.chaos
class TestDecodeLaneFailover:
    """The drills above run the plain one-token decode lane. The
    durable-stream contract must hold UNCHANGED when the replica's lane
    batches (horizon>1 chains K decode steps per dispatch, tokens land
    in bursts) or speculates (draft-and-verify emits 1..k+1 tokens per
    verify round): resume is ordinary admission either way, every chunk
    still carries its absolute `token_index`, and greedy argmax keeps
    the continuation bit-identical to an uninterrupted run."""

    BODY = {"prompt": [[1, 2, 3, 4]], "max_tokens": 12, "stream": True}

    def _drill(self, tf_setup, serve_kw, programs_max=1):
        pair = _Pair(tf_setup, serve_kw=serve_kw)
        try:
            ref = _stream(f"{pair.url}/generate", self.BODY)
            ref_toks = [e["token"] for e in _token_events(ref)]
            assert len(ref_toks) == 12
            # reset at chunk 3: MID-window for horizon=4 (burst
            # boundary is 4) and mid-round for speculation — the
            # delivered prefix ends at a point the lane never chose
            chaos.configure([Rule("generate.midstream", "reset",
                                  at=[3])])
            out = _stream(f"{pair.url}/generate", self.BODY)
            chaos.deactivate()
            toks = _token_events(out)
            assert [e["token"] for e in toks] == ref_toks
            assert [e["token_index"] for e in toks] == list(range(12))
            assert out[-1]["done"] and out[-1]["resumes"] == 1
            assert out[-1]["tokens"] == ref[-1]["tokens"]
            decs = pair.decode_stats()
            assert all(d["decode_step_programs"] <= programs_max
                       for d in decs)
            return decs
        finally:
            pair.close()

    def test_horizon_chain_resume_bit_identical(self, tf_setup):
        """horizon=4: the victim dies mid-burst (3 of 12 delivered, not
        a multiple of the horizon) — the survivor re-admits
        prompt+delivered and its own burst grid restarts from there,
        proving the chain carries no hidden per-window state."""
        decs = self._drill(tf_setup, {"horizon": 4})
        assert all(d["horizon"] == 4 for d in decs)

    def test_speculative_resume_bit_identical(self, tf_setup):
        """speculation=4 (ngram drafter): accept lengths are
        data-dependent, so the resumed continuation retraces the SAME
        tokens through a different accept pattern — the absolute
        token_index contract is what keeps the client stream gapless."""
        decs = self._drill(tf_setup, {"speculation": 4},
                           programs_max=2)
        assert all(d["speculation"]["enabled"] for d in decs)
        # speculation actually engaged on the serving path
        assert sum(d["speculation"]["rounds"] for d in decs) >= 1

    def test_speculative_nonstream_multirow_resume(self, tf_setup):
        """The non-streaming multi-row recovery (rows buffered by the
        router, unfinished rows resumed) with speculation on: aggregated
        rows and finish_reasons match the uninterrupted reference."""
        pair = _Pair(tf_setup, serve_kw={"speculation": 4})
        body = {"prompt": [[1, 2, 3], [4, 5, 6, 7]], "max_tokens": 6}
        try:
            ref = _post(f"{pair.url}/generate", body)
            chaos.configure([Rule("generate.midstream", "reset",
                                  at=[5])])
            out = _post(f"{pair.url}/generate", body)
            chaos.deactivate()
            assert out["tokens"] == ref["tokens"]
            assert out["finish_reasons"] == ref["finish_reasons"]
            assert out["resumes"] >= 1
        finally:
            pair.close()


# ============================ exactly-once dedupe against a noisy stub
@pytest.mark.chaos
class TestExactlyOnceDedupe:
    def test_duplicate_token_indices_relayed_once(self):
        """A (stub) replica that replays already-delivered indices —
        what a resumed stream with a conservative `token_index_base`
        looks like — reaches the client exactly once, and the drops
        are counted."""
        lines = [{"row": 0, "token": 5, "token_index": 0},
                 {"row": 0, "token": 5, "token_index": 0},   # dup
                 {"row": 0, "token": 6, "token_index": 1},
                 {"row": 0, "token": 6, "token_index": 1},   # dup
                 {"row": 0, "token": 7, "token_index": 2},
                 {"done": True, "tokens": [[9, 5, 6, 7]],
                  "finish_reasons": ["max_tokens"]}]

        class StubReplica(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                body = (b'{"ready": true}'
                        if self.path.startswith("/readyz")
                        else b'{"ok": true}')
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                self.rfile.read(n)
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for obj in lines:
                    raw = (json.dumps(obj) + "\n").encode()
                    self.wfile.write(f"{len(raw):x}\r\n".encode()
                                     + raw + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")

        srv = start_http_server(StubReplica)
        fleet = Fleet(start=False, heartbeat_timeout=5.0)
        try:
            fleet.attach(srv.url)
            for _ in range(100):
                fleet.poll()
                if fleet.ready_count():
                    break
                time.sleep(0.02)
            deduped_before = fleet.snapshot()["stream_tokens_deduped"]
            with serve_fleet(fleet) as router:
                out = _stream(f"{router.url}/generate",
                              {"prompt": [[9]], "max_tokens": 3,
                               "stream": True})
            toks = _token_events(out)
            assert [e["token"] for e in toks] == [5, 6, 7]
            assert [e["token_index"] for e in toks] == [0, 1, 2]
            assert out[-1]["done"]
            assert out[-1]["tokens"] == [[9, 5, 6, 7]]
            assert (fleet.snapshot()["stream_tokens_deduped"]
                    - deduped_before) == 2
        finally:
            fleet.close()
            srv.close()



# ===================== real processes: SIGKILL / SIGSTOP stream drills
def _spawner(tmp_path, slow_ms=40, extra=()):
    """Replica processes (`cli serve --device cpu`) serving /generate
    from `--transformer SPEC`: the port's initialiser is a pure function
    of (seed, config), so every process carries the same weights. A chaos
    delay on each streamed chunk paces token emission so the drill's
    signal lands MID-stream."""
    from deeplearning4j_tpu_torch.serving.fleet import ReplicaSpawner

    ckpt, spec = _write_spec(tmp_path)
    env = dict(os.environ,
               PYTHONPATH=REPO_ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               **chaos.env_spec([Rule("generate.midstream", "delay",
                                      delay_s=slow_ms / 1000.0)]))
    return ReplicaSpawner(ckpt,
                          serve_args=["--max-delay-ms", "1",
                                      "--transformer", spec,
                                      "--slots", "4",
                                      "--page-size", "8",
                                      "--device", "cpu",
                                      *extra],
                          env=env)


def _victim(fleet):
    """The replica currently serving stream traffic."""
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        busy = [r for r in fleet._replicas.values() if r.outstanding]
        if busy:
            return busy[0]
        time.sleep(0.02)
    raise AssertionError("no replica ever went busy")


@pytest.mark.slow
@pytest.mark.chaos
class TestProcessDrills:
    PROMPT = [1, 2, 3, 4]
    N_TOKENS = 24

    def _run_streams(self, router_url, n=3):
        """n concurrent streaming clients, same prompt (deterministic
        decode -> same expected tokens). Returns (results, failures)
        after all threads join."""
        results, failures = [None] * n, []

        def worker(i):
            try:
                results[i] = _stream(
                    f"{router_url}/generate",
                    {"prompt": [self.PROMPT],
                     "max_tokens": self.N_TOKENS, "stream": True},
                    timeout=300)
            except Exception as e:  # noqa: BLE001
                failures.append(repr(e))

        threads = [threading.Thread(target=worker, args=(i,),
                                    daemon=True) for i in range(n)]
        for t in threads:
            t.start()
        return threads, results, failures

    def _check_streams(self, results, ref_toks):
        """Every stream: zero gaps, zero dups, bit-identical tokens."""
        total_resumes = 0
        for events in results:
            toks = _token_events(events)
            assert [e["token_index"] for e in toks] == \
                list(range(self.N_TOKENS))
            assert [e["token"] for e in toks] == ref_toks
            done = events[-1]
            assert done["done"]
            assert done["tokens"] == [self.PROMPT + ref_toks]
            total_resumes += done["resumes"]
        return total_resumes

    def _sigkill_drill(self, tmp_path, extra=(), programs_max=1):
        fleet = Fleet(spawner=_spawner(tmp_path, extra=extra),
                      heartbeat_interval=0.2, heartbeat_timeout=3.0,
                      breaker_threshold=2, breaker_reset_s=0.4)
        router = None
        try:
            fleet.spawn(2)
            fleet.wait_ready(2, timeout=300)
            router = serve_fleet(fleet)
            # uninterrupted reference (also a warm pass: both the
            # bucket programs and — on whichever replica served it —
            # the prefix cache)
            ref = _stream(f"{router.url}/generate",
                          {"prompt": [self.PROMPT],
                           "max_tokens": self.N_TOKENS,
                           "stream": True}, timeout=300)
            ref_toks = [e["token"] for e in _token_events(ref)]
            assert len(ref_toks) == self.N_TOKENS

            threads, results, failures = self._run_streams(router.url)
            victim = _victim(fleet)
            time.sleep(0.4)          # let a few tokens flow
            chaos.sigkill(victim.proc)
            for t in threads:
                t.join(timeout=300)
            assert failures == []    # ZERO client-visible failures
            total_resumes = self._check_streams(results, ref_toks)
            assert total_resumes >= 1

            # live-scrape the resume counters off the router /metrics
            with urllib.request.urlopen(f"{router.url}/metrics",
                                        timeout=30) as r:
                text = r.read().decode()
            scraped = {ln.split("{")[0]: float(ln.split()[-1])
                       for ln in text.splitlines()
                       if ln.startswith("dl4j_fleet_stream_")
                       and f'fleet="{fleet.label}"' in ln}
            assert scraped["dl4j_fleet_stream_resumes_total"] >= 1
            assert scraped["dl4j_fleet_stream_tokens_replayed_total"] \
                >= len(self.PROMPT)

            # the survivor: resume was ordinary admission (no extra
            # programs past the lane's pinned budget) and every page
            # came back
            survivor = next(r for r in fleet._replicas.values()
                            if r.id != victim.id)
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                dec = survivor.client.stats()["generate"]["decode"]
                if dec["pages_in_use"] == 0:
                    break
                time.sleep(0.1)
            assert dec["pages_in_use"] == 0
            assert dec["decode_step_programs"] <= programs_max
            return dec
        finally:
            if router is not None:
                router.close(stop_replicas=True)
            else:
                fleet.close(stop_replicas=True)

    def test_sigkill_mid_stream_zero_client_failures(self, tmp_path):
        """Acceptance drill: SIGKILL the serving replica while
        concurrent streams are mid-flight — zero client-visible
        failures, every stream gapless/duplicate-free and
        bit-identical to the uninterrupted reference, resume counters
        scraped off the live /metrics, and the survivor never compiled
        a second decode program."""
        dec = self._sigkill_drill(tmp_path)
        assert dec["decode_step_programs"] == 1

    def test_sigkill_mid_horizon_stream(self, tmp_path):
        """The same SIGKILL drill with `cli serve --horizon 4`: the kill
        lands mid-burst at an arbitrary window offset, and the resumed
        stream is still gapless (absolute token_index) and bit-identical
        — the horizon chain carries no state a failover could lose."""
        dec = self._sigkill_drill(tmp_path, extra=("--horizon", "4"))
        assert dec["horizon"] == 4

    def test_sigkill_mid_speculative_stream(self, tmp_path):
        """And with `cli serve --speculation 4`: accept lengths are
        data-dependent per round, so victim and survivor take different
        accept paths through the SAME token sequence — bit-identity and
        exactly-once delivery must survive that."""
        dec = self._sigkill_drill(tmp_path,
                                  extra=("--speculation", "4"),
                                  programs_max=2)
        assert dec["speculation"]["enabled"]

    def test_sigstop_breaker_eviction_resumes_and_frees_pages(
            self, tmp_path):
        """Breaker-eviction flavor: the victim is SIGSTOPped
        (hung-but-TCP-alive). The router's mid-stream read times out,
        feeds the breaker (threshold 1 -> evicted), and the stream
        resumes on the survivor. After SIGCONT the victim's abandoned
        slots cancel (the router closed the connection) and its KV
        pages come home."""
        fleet = Fleet(spawner=_spawner(tmp_path),
                      heartbeat_interval=0.2, heartbeat_timeout=60.0,
                      generate_timeout=2.0,
                      breaker_threshold=1, breaker_reset_s=30.0)
        router = None
        try:
            fleet.spawn(2)
            fleet.wait_ready(2, timeout=300)
            router = serve_fleet(fleet)
            ref = _stream(f"{router.url}/generate",
                          {"prompt": [self.PROMPT],
                           "max_tokens": self.N_TOKENS,
                           "stream": True}, timeout=300)
            ref_toks = [e["token"] for e in _token_events(ref)]

            threads, results, failures = self._run_streams(router.url)
            victim = _victim(fleet)
            time.sleep(0.4)
            chaos.sigstop(victim.proc)   # hung, NOT dead
            for t in threads:
                t.join(timeout=300)
            assert failures == []
            assert self._check_streams(results, ref_toks) >= 1
            # the stalled stream read fed the breaker
            deadline = time.monotonic() + 15.0
            while victim.state != EVICTED:
                assert time.monotonic() < deadline, \
                    f"breaker never evicted: {fleet.snapshot()}"
                time.sleep(0.05)
            assert "circuit breaker" in victim.eviction_reason
            chaos.sigcont(victim.proc)
            # its orphaned slots cancel on the dead client connection
            # and every origin-side KV page is freed
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline:
                try:
                    dec = victim.client.stats()["generate"]["decode"]
                    if dec["pages_in_use"] == 0:
                        break
                except Exception:  # noqa: BLE001
                    pass
                time.sleep(0.2)
            assert dec["pages_in_use"] == 0
        finally:
            if router is not None:
                router.close(stop_replicas=True)
            else:
                fleet.close(stop_replicas=True)


# ------------------------------------------------ fleet KV placement
@pytest.mark.fleetkv
class TestOptOutTwin:
    def test_replica_summary_never_sees_opted_out_prompts(
            self, tf_setup, jax_params):
        """The positive twin: an identical prompt submitted WITH the
        cache seeds head fingerprints (the JAX loop's, and
        `fleetkv.hash_chunks` of its head); the opted-out submission
        leaves the summary empty — prompt-derived hashes of opted-out
        traffic never leave the replica."""
        from deeplearning4j_tpu.serving.decode_loop import \
            DecodeLoop as JaxLoop

        p, _ = tf_setup
        rng = np.random.RandomState(7)
        pr = _prompt(rng, 16)
        loop = DecodeLoop(p, CFG, slots=2, page_size=8, device="cpu",
                          start=False)
        ref = JaxLoop(jax_params, JAX_CFG, slots=2, page_size=8,
                      kernel="gather", start=False)
        try:
            for lp in (loop, ref):
                lp.submit(pr, 1, prefix_cache=False)
                lp.run_until_idle()
                assert lp.kv_summary()["heads"] == []
                lp.submit(pr, 1)  # the twin
                lp.run_until_idle()
            heads = loop.kv_summary()["heads"]
            assert heads == fleetkv.hash_chunks(list(pr), 8)
            assert heads == ref.kv_summary()["heads"]
        finally:
            loop.close()
            ref.close()


def _fake_kv_replica(summary, record):
    """A fake replica speaking just enough of the serving surface for
    the router's durable /generate loop: healthz/readyz (with the
    given kv_summary riding readyz) and a one-token NDJSON stream."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _send(self, code, body):
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._send(200, b'{"ok": true}')
            elif self.path.startswith("/readyz"):
                self._send(200, json.dumps(
                    {"ready": True, "kv_summary": summary}).encode())
            else:
                self._send(404, b"{}")

        def do_POST(self):
            length = int(self.headers.get("Content-Length") or 0)
            data = json.loads(self.rfile.read(length))
            record.append(data)
            lines = [{"row": i, "token": 1, "token_index": b}
                     for i, b in enumerate(
                         data.get("token_index_base",
                                  [0] * len(data["prompt"])))]
            lines.append({"done": True,
                          "finish_reasons":
                          ["max_tokens"] * len(data["prompt"])})
            body = "".join(json.dumps(l) + "\n" for l in lines).encode()
            self._send(200, body)

    return start_http_server(Handler)


@pytest.mark.fleetkv
class TestRouterAffinity:
    def test_affinity_routes_stats_aggregate_and_metrics_scrape(self):
        """Two fake replicas, one holding the prompt's head: every
        request lands on the holder (beating round-robin), /stats
        grows the fleet-wide prefix-cache section, ship stats fold
        from replica summaries into dl4j_fleet_prefix_* series on the
        router's live /metrics."""
        toks = list(range(1, 17))
        heads = fleetkv.hash_chunks(toks, 8)
        hot_summary = {"v": 1, "mode": "on", "page_size": 8,
                       "heads": heads, "pages_cached": 2,
                       "hits": 5, "misses": 1,
                       "page_ships": 3, "ship_bytes": 999,
                       "ship_failures": 1}
        cold_summary = {"v": 1, "mode": "on", "page_size": 8,
                        "heads": [], "pages_cached": 0,
                        "hits": 0, "misses": 4,
                        "page_ships": 0, "ship_bytes": 0,
                        "ship_failures": 0}
        hot_reqs, cold_reqs = [], []
        hot = _fake_kv_replica(hot_summary, hot_reqs)
        cold = _fake_kv_replica(cold_summary, cold_reqs)
        fleet = Fleet(start=False, heartbeat_timeout=5.0)
        try:
            hot_rep = fleet.attach(hot.url)
            fleet.attach(cold.url)
            for _ in range(3):
                fleet.poll()
            assert fleet.ready_count() == 2
            with serve_fleet(fleet, fleet_kv="on") as router:
                for _ in range(4):
                    out = _post(f"{router.url}/generate",
                                {"prompt": [toks], "max_tokens": 1})
                    assert out["finish_reasons"] == ["max_tokens"]
                # every request beat round-robin to the summary holder
                assert len(hot_reqs) == 4 and len(cold_reqs) == 0
                # ... and none carried a donor hint (it LANDED on the
                # donor, so there is nothing to ship)
                assert all("kv_donor" not in r for r in hot_reqs)
                stats = _get(f"{router.url}/stats")["fleet"]
                sec = stats["prefix_cache"]
                assert sec["affinity"]["hits"] == 4
                assert sec["affinity"]["misses"] == 0
                assert sec["affinity"]["rate"] == 1.0
                assert sec["hits"] == 5 and sec["pages_cached"] == 2
                assert sec["page_ships"] == 3
                assert sec["ship_bytes"] == 999
                assert sec["ship_failures"] == 1
                assert sec["replicas"][hot_rep.id]["page_ships"] == 3
                # acceptance bar: the new series scrape LIVE off the
                # router's /metrics
                with urllib.request.urlopen(f"{router.url}/metrics",
                                            timeout=30) as r:
                    text = r.read().decode()
                for series in ("dl4j_fleet_prefix_affinity_hits",
                               "dl4j_fleet_prefix_affinity_misses",
                               "dl4j_fleet_prefix_page_ships",
                               "dl4j_fleet_prefix_ship_bytes",
                               "dl4j_fleet_prefix_ship_failures"):
                    assert series in text, f"{series} missing"
                lab = f'fleet="{fleet.label}"'
                assert (f'dl4j_fleet_prefix_affinity_hits_total'
                        f'{{{lab}}} 4') in text
                assert (f'dl4j_fleet_prefix_page_ships_total'
                        f'{{{lab}}} 3') in text
        finally:
            fleet.close()
            hot.close()
            cold.close()

    def test_opted_out_bodies_are_never_hashed_on_the_router(self):
        """Router half of the opt-out twin: `"prefix_cache": false`
        must short-circuit BEFORE any prompt hashing; the `true` twin
        of the same body hashes (and places) normally."""
        toks = list(range(1, 17))
        summary = {"v": 1, "mode": "on", "page_size": 8,
                   "heads": fleetkv.hash_chunks(toks, 8),
                   "pages_cached": 2, "hits": 0, "misses": 0,
                   "page_ships": 0, "ship_bytes": 0,
                   "ship_failures": 0}
        reqs = []
        srv = _fake_kv_replica(summary, reqs)
        fleet = Fleet(start=False, heartbeat_timeout=5.0)
        calls = []
        orig = fleetkv.hash_chunks

        def spy(tokens, page_size, limit=fleetkv.MAX_HEAD_CHUNKS):
            calls.append(list(tokens))
            return orig(tokens, page_size, limit)

        try:
            fleet.attach(srv.url)
            fleet.poll()
            with serve_fleet(fleet, fleet_kv="on") as router:
                fleetkv.hash_chunks = spy
                try:
                    _post(f"{router.url}/generate",
                          {"prompt": [toks], "max_tokens": 1,
                           "prefix_cache": False})
                    assert calls == []  # opted out: never hashed
                    _post(f"{router.url}/generate",
                          {"prompt": [toks], "max_tokens": 1})
                    assert calls and calls[0] == toks  # the twin hashes
                finally:
                    fleetkv.hash_chunks = orig
                # the opt-out flag itself still reached the replica
                assert reqs[0]["prefix_cache"] is False
                assert reqs[1]["prefix_cache"] is True
        finally:
            fleet.close()
            srv.close()



# ------------------------------------------------- role/model fences
def _fake_replica(record, role=None, model_id=None, summary=None,
                  checkpoint=None):
    """A fake replica speaking the serving surface the fleet registry
    reads: /readyz announces (role, model_id, checkpoint, kv_summary),
    /reload answers 200, /generate speaks a one-token NDJSON stream."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def _send(self, code, body):
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._send(200, b'{"ok": true}')
            elif self.path.startswith("/readyz"):
                payload = {"ready": True}
                if role is not None:
                    payload["role"] = role
                if model_id is not None:
                    payload["model_id"] = model_id
                if checkpoint is not None:
                    payload["checkpoint"] = checkpoint
                if summary is not None:
                    payload["kv_summary"] = summary
                self._send(200, json.dumps(payload).encode())
            else:
                self._send(404, b"{}")

        def do_POST(self):
            length = int(self.headers.get("Content-Length") or 0)
            data = json.loads(self.rfile.read(length) or b"{}")
            record.append({"path": self.path, "body": data})
            if self.path.startswith("/reload"):
                self._send(200, b'{"reloaded": true}')
                return
            if self.path.startswith("/prefill"):
                self._send(200, json.dumps(
                    {"chunks": 2, "covered": 0, "cached": 2,
                     "kv_bytes": 4096, "rows": []}).encode())
                return
            lines = [{"row": i, "token": 1, "token_index": b}
                     for i, b in enumerate(
                         data.get("token_index_base",
                                  [0] * len(data["prompt"])))]
            lines.append({"done": True,
                          "finish_reasons":
                          ["max_tokens"] * len(data["prompt"])})
            body = "".join(json.dumps(l) + "\n" for l in lines).encode()
            self._send(200, body)

    return start_http_server(Handler)


def _ready_fleet(*servers, **fleet_kw):
    fleet_kw.setdefault("heartbeat_timeout", 5.0)
    fleet = Fleet(start=False, **fleet_kw)
    reps = [fleet.attach(s.url) for s in servers]
    for _ in range(200):
        fleet.poll()
        if fleet.ready_count() >= len(servers):
            break
        time.sleep(0.02)
    assert fleet.ready_count() >= len(servers)
    return fleet, reps


@pytest.mark.disagg
class TestRoleFences:
    def test_select_never_routes_streams_to_prefill(self):
        """Regression (the satellite's headline): stream selection
        with the default role must NEVER land on a prefill replica —
        not even as an affinity `prefer` hint — while role="prefill"
        reaches exactly the prefill pool."""
        pre_reqs, dec_reqs = [], []
        pre = _fake_replica(pre_reqs, role="prefill")
        dec = _fake_replica(dec_reqs, role="decode")
        fleet, (pre_rep, dec_rep) = _ready_fleet(pre, dec)
        try:
            for _ in range(6):
                rep = fleet.select(route="generate")
                assert rep.id == dec_rep.id
                fleet.release(rep)
            # the prefer hint passes through the same fence: naming
            # the prefill replica cannot override it
            rep = fleet.select(route="generate", prefer=pre_rep.id,
                               prefer_slack=100)
            assert rep.id == dec_rep.id
            fleet.release(rep)
            rep = fleet.select(route="generate", role="prefill")
            assert rep.id == pre_rep.id
            fleet.release(rep)
            assert fleet.role_counts() == {"prefill": 1, "decode": 1}
        finally:
            fleet.close()
            pre.close()
            dec.close()

    def test_prefill_only_fleet_has_no_stream_capacity(self):
        reqs = []
        pre = _fake_replica(reqs, role="prefill")
        fleet, _ = _ready_fleet(pre)
        try:
            with pytest.raises(NoReadyReplicas):
                fleet.select(route="generate")
        finally:
            fleet.close()
            pre.close()

    def test_kv_summaries_and_affinity_exclude_prefill(self):
        """A prefill replica holding the DEEPEST summary match must
        attract neither affinity placement nor a donor hint: both
        `Fleet.kv_summaries` and `RouterAffinity.plan` filter it."""
        toks = list(range(16))
        heads = fleetkv.hash_chunks(toks, 8)
        deep = {"v": 1, "mode": "on", "page_size": 8, "heads": heads,
                "role": "prefill", "pages_cached": 2, "hits": 0,
                "misses": 0, "page_ships": 0, "ship_bytes": 0,
                "ship_failures": 0}
        shallow = dict(deep, role="decode", heads=heads[:1])
        pre = _fake_replica([], role="prefill", summary=deep)
        dec = _fake_replica([], role="decode", summary=shallow)
        fleet, (pre_rep, dec_rep) = _ready_fleet(pre, dec)
        try:
            summ = fleet.kv_summaries()
            assert pre_rep.id not in summ and dec_rep.id in summ
            # belt and braces: even a summary set that still carries
            # the prefill entry is filtered inside plan()
            aff = fleetkv.RouterAffinity("on")
            raw = {pre_rep.id: (deep, pre.url),
                   dec_rep.id: (shallow, dec.url)}
            p = aff.plan(toks, raw)
            assert p.prefer == dec_rep.id and p.depth == 1
            assert aff.plan(toks, {pre_rep.id: (deep, pre.url)}) is None
        finally:
            fleet.close()
            pre.close()
            dec.close()

    def test_kv_summaries_filter_by_model(self):
        toks = list(range(16))
        heads = fleetkv.hash_chunks(toks, 8)
        summ = {"v": 1, "mode": "on", "page_size": 8, "heads": heads,
                "pages_cached": 2, "hits": 0, "misses": 0,
                "page_ships": 0, "ship_bytes": 0, "ship_failures": 0}
        a = _fake_replica([], model_id="a", summary=summ)
        b = _fake_replica([], model_id="b", summary=summ)
        fleet, (a_rep, b_rep) = _ready_fleet(a, b)
        try:
            assert set(fleet.kv_summaries()) == {a_rep.id, b_rep.id}
            assert set(fleet.kv_summaries(model_id="a")) == {a_rep.id}
            assert set(fleet.kv_summaries(model_id="b")) == {b_rep.id}
        finally:
            fleet.close()
            a.close()
            b.close()


# ---------------------------------------------------- multi-model fleet
@pytest.mark.disagg
class TestMultiModelRouting:
    def test_requests_route_by_model_and_never_mix(self):
        """Body `model_id` and the `X-Model` header each scope routing;
        an unknown model sheds with 503; zero cross-model hits."""
        a_reqs, b_reqs = [], []
        a = _fake_replica(a_reqs, model_id="a",
                          checkpoint={"path": "/ck/a", "step": 1})
        b = _fake_replica(b_reqs, model_id="b",
                          checkpoint={"path": "/ck/b", "step": 2})
        fleet, _ = _ready_fleet(a, b)
        try:
            with serve_fleet(fleet, fleet_kv="off") as router:
                for _ in range(3):
                    out = _post(f"{router.url}/generate",
                                {"prompt": [[1, 2, 3]], "max_tokens": 1,
                                 "model_id": "a"})
                    assert out["finish_reasons"] == ["max_tokens"]
                _post(f"{router.url}/generate",
                      {"prompt": [[1, 2, 3]], "max_tokens": 1},
                      headers={"X-Model": "b"})
                gen_a = [r for r in a_reqs
                         if r["path"].startswith("/generate")]
                gen_b = [r for r in b_reqs
                         if r["path"].startswith("/generate")]
                assert len(gen_a) == 3 and len(gen_b) == 1
                with pytest.raises(urllib.error.HTTPError) as ei:
                    _post(f"{router.url}/generate",
                          {"prompt": [[1, 2]], "max_tokens": 1,
                           "model_id": "zzz"})
                assert ei.value.code == 503
                assert json.loads(ei.value.read())["error"] == \
                    "no_ready_replicas"
                stats = _get(f"{router.url}/stats")["fleet"]
                assert set(stats["models"]) == {"a", "b"}
                assert stats["models"]["a"]["roles"] == {"unified": 1}
                assert "/ck/a@1" in \
                    stats["models"]["a"]["checkpoints_served"]
                assert "/ck/b@2" in \
                    stats["models"]["b"]["checkpoints_served"]
        finally:
            fleet.close()
            a.close()
            b.close()

    def test_rolling_reload_scoped_by_model(self):
        a_reqs, b_reqs = [], []
        a = _fake_replica(a_reqs, model_id="a")
        b = _fake_replica(b_reqs, model_id="b")
        fleet, _ = _ready_fleet(a, b)
        try:
            res = fleet.rolling_reload("/ck/a2", step=7, model_id="a")
            assert res["reloaded"] and res["model_id"] == "a"
            assert [r for r in a_reqs
                    if r["path"].startswith("/reload")]
            assert not [r for r in b_reqs
                        if r["path"].startswith("/reload")]
            # the promoted identity pins per model, not fleet-wide
            assert fleet.model_checkpoints["a"] == ("/ck/a2", 7)
            assert fleet.current_checkpoint is None
            snap = fleet.snapshot()
            assert snap["models"]["a"]["current_checkpoint"] == "/ck/a2"
            assert "current_checkpoint" not in snap["models"]["b"]
            with pytest.raises(NoReadyReplicas):
                fleet.rolling_reload("/ck/x", model_id="zzz")
        finally:
            fleet.close()
            a.close()
            b.close()

    def test_predict_routes_by_model_header(self):
        a_reqs, b_reqs = [], []
        a = _fake_replica(a_reqs, model_id="a")
        b = _fake_replica(b_reqs, model_id="b")

        # the fakes above only speak /generate; /predict forwards raw
        # bytes, so teach them by path prefix — the record already
        # captures everything we need
        fleet, _ = _ready_fleet(a, b)
        try:
            with serve_fleet(fleet, fleet_kv="off") as router:
                try:
                    _post(f"{router.url}/predict", {"rows": [[1]]},
                          headers={"X-Model": "b"})
                except urllib.error.HTTPError:
                    pass  # the fake's NDJSON reply confuses nobody here
                assert not [r for r in a_reqs
                            if r["path"].startswith("/predict")]
                assert [r for r in b_reqs
                        if r["path"].startswith("/predict")]
        finally:
            fleet.close()
            a.close()
            b.close()


# ----------------------------------------- router handoff (fake pools)
@pytest.mark.disagg
class TestRouterHandoffDispatch:
    def test_router_drives_prefill_then_names_donor(self):
        """With a prefill pool present, the durable /generate first
        POSTs /prefill on the prefill replica, then forwards the
        stream to the decode replica with `kv_donor` naming the
        prefill replica — and the disagg counters move."""
        pre_reqs, dec_reqs = [], []
        pre = _fake_replica(pre_reqs, role="prefill")
        dec = _fake_replica(dec_reqs, role="decode")
        fleet, _ = _ready_fleet(pre, dec)
        try:
            with serve_fleet(fleet, fleet_kv="on") as router:
                out = _post(f"{router.url}/generate",
                            {"prompt": [list(range(16))],
                             "max_tokens": 1})
                assert out["finish_reasons"] == ["max_tokens"]
                assert [r for r in pre_reqs
                        if r["path"].startswith("/prefill")]
                gen = [r for r in dec_reqs
                       if r["path"].startswith("/generate")]
                assert len(gen) == 1
                assert gen[0]["body"]["kv_donor"] == pre.url
                # ... and the prefill replica NEVER saw the stream
                assert not [r for r in pre_reqs
                            if r["path"].startswith("/generate")]
                disagg = _get(f"{router.url}/stats")["fleet"]["disagg"]
                assert disagg["handoffs"] == 1
                assert disagg["handoff_bytes"] == 4096
                assert disagg["handoff_failures"] == 0
                assert disagg["fallbacks"] == 0
                # metrics scrape live off the router
                with urllib.request.urlopen(f"{router.url}/metrics",
                                            timeout=30) as r:
                    text = r.read().decode()
                for series in ("dl4j_disagg_handoffs",
                               "dl4j_disagg_handoff_bytes",
                               "dl4j_disagg_handoff_failures",
                               "dl4j_disagg_fallbacks",
                               "dl4j_fleet_role_replicas"):
                    assert series in text, f"{series} missing"
                lab = f'fleet="{fleet.label}"'
                assert (f'dl4j_disagg_handoffs_total{{{lab}}} 1'
                        in text)
                assert ('dl4j_fleet_role_replicas{fleet="'
                        f'{fleet.label}",model="default",'
                        'role="prefill"} 1') in text
        finally:
            fleet.close()
            pre.close()
            dec.close()

    def test_opted_out_and_short_prompts_skip_the_handoff(self):
        pre_reqs, dec_reqs = [], []
        pre = _fake_replica(pre_reqs, role="prefill")
        dec = _fake_replica(dec_reqs, role="decode")
        fleet, _ = _ready_fleet(pre, dec)
        try:
            with serve_fleet(fleet, fleet_kv="on") as router:
                _post(f"{router.url}/generate",
                      {"prompt": [list(range(16))], "max_tokens": 1,
                       "prefix_cache": False})
                assert pre_reqs == []  # opt-out: no prefill dispatch
                gen = [r for r in dec_reqs
                       if r["path"].startswith("/generate")]
                assert "kv_donor" not in gen[0]["body"]
        finally:
            fleet.close()
            pre.close()
            dec.close()



# ------------------------------------ router-driven handoff, port servers
@pytest.mark.disagg
class TestRouterDrivenHandoffHTTP:
    def _serve(self, p, role, **kw):
        return serve_network(
            _net(), n_replicas=1, max_delay_ms=1.0,
            generate_engine=InferenceEngine.for_transformer(
                p, CFG, device="cpu"),
            slots=2, page_size=8, role=role, **kw)

    def test_handoff_bit_identical_and_counters(self, tf_setup,
                                                jax_params):
        """Real processes-in-threads e2e: prefill + decode replicas
        behind the router; a 2-page prompt hands off (router /prefill
        -> kv_donor -> decode replica ships) and streams bit-identical
        to the cold reference; the decode replica prefilled ONLY the
        tail; disagg/role telemetry reads true."""
        p = jax_params
        head = list(range(1, 17))
        full = head + [3, 1, 4, 1]
        ref = _ref_tokens(p, full, 4)
        pre = self._serve(tf_setup[0], "prefill")
        dec = self._serve(tf_setup[0], "decode")
        fleet = Fleet(start=False, heartbeat_timeout=5.0)
        router = None
        try:
            assert _get(f"{pre.url}/readyz")["role"] == "prefill"
            fleet.attach(pre.url)
            fleet.attach(dec.url)
            for _ in range(200):
                fleet.poll()
                if fleet.ready_count() >= 2:
                    break
                time.sleep(0.02)
            assert fleet.role_counts() == {"prefill": 1, "decode": 1}
            router = serve_fleet(fleet, fleet_kv="on")
            out = _post(f"{router.url}/generate",
                        {"prompt": [full], "max_tokens": 4})
            assert out["tokens"][0] == full + ref[len(full):] \
                or out["tokens"][0] == ref  # full_sequence shape
            assert out["finish_reasons"] == ["max_tokens"]
            disagg = _get(f"{router.url}/stats")["fleet"]["disagg"]
            assert disagg["handoffs"] == 1
            assert disagg["handoff_bytes"] > 0
            assert disagg["handoff_failures"] == 0
            pre_dec = _get(f"{pre.url}/stats")["generate"]["decode"]
            assert pre_dec["fleet_kv"]["prefill_handoffs"] == 1
            assert pre_dec["decode_step_programs"] == 0
            assert _get(f"{pre.url}/stats")["role"] == "prefill"
            dec_dec = _get(f"{dec.url}/stats")["generate"]["decode"]
            assert dec_dec["fleet_kv"]["page_ships"] == 2
            assert dec_dec["fleet_kv"]["ship_failures"] == 0
            assert dec_dec["prefill_tokens"] == 4  # tail only, ever
            assert dec_dec["prefix_cache"]["hits"] == 1
        finally:
            if router is not None:
                router.close()
            fleet.close()
            pre.close()
            dec.close()

    @pytest.mark.chaos
    def test_chaos_at_every_handoff_point_degrades_bit_identical(
            self, tf_setup, jax_params):
        """Handoff failure at ANY point degrades to plain unified
        prefill with the SAME bytes: chaos on the export leg (the
        /prefill 500s -> failed handoff + fallback counters), chaos on
        the install leg (donor hint dropped on the decode replica),
        and a dead prefill pool (no dispatch at all). Zero
        client-visible failures throughout."""
        p = jax_params
        rng = np.random.RandomState(8)
        pre = self._serve(tf_setup[0], "prefill")
        dec = self._serve(tf_setup[0], "decode")
        fleet = Fleet(start=False, heartbeat_timeout=0.8,
                      heartbeat_interval=0.1)
        router = None
        try:
            fleet.attach(pre.url)
            fleet.attach(dec.url)
            for _ in range(200):
                fleet.poll()
                if fleet.ready_count() >= 2:
                    break
                time.sleep(0.02)
            router = serve_fleet(fleet, fleet_kv="on")

            def run(prompt, n=4):
                out = _post(f"{router.url}/generate",
                            {"prompt": [prompt], "max_tokens": n})
                assert out["finish_reasons"] == ["max_tokens"]
                return out["tokens"][0]

            # export leg: the very first disagg.handoff hit is the
            # prefill replica's export — /prefill answers 500, the
            # router counts a failed handoff and falls back
            p1 = [int(t) for t in _prompt(rng, 20)]
            chaos.configure([Rule("disagg.handoff", "error", at=[0])])
            try:
                toks = run(p1)
            finally:
                chaos.deactivate()
            assert toks[len(p1):] == _ref_tokens(p, p1, 4)[len(p1):]
            disagg = _get(f"{router.url}/stats")["fleet"]["disagg"]
            assert disagg["handoff_failures"] == 1
            assert disagg["fallbacks"] == 1
            assert disagg["handoffs"] == 0

            # install leg: hit 0 is the export (succeeds is wrong —
            # ordinal 0 already burned above; reconfigure fresh), hit 1
            # is the decode replica's install — the ship is skipped
            # and the decode replica prefills the WHOLE prompt
            p2 = [int(t) for t in _prompt(rng, 20)]
            before = _get(f"{dec.url}/stats")["generate"]["decode"]
            chaos.configure([Rule("disagg.handoff", "error", at=[1])])
            try:
                toks = run(p2)
            finally:
                chaos.deactivate()
            assert toks[len(p2):] == _ref_tokens(p, p2, 4)[len(p2):]
            after = _get(f"{dec.url}/stats")["generate"]["decode"]
            assert after["fleet_kv"]["page_ships"] == \
                before["fleet_kv"]["page_ships"]  # install skipped
            assert after["prefill_tokens"] - before["prefill_tokens"] \
                == len(p2)  # plain prefill, full prompt
            disagg = _get(f"{router.url}/stats")["fleet"]["disagg"]
            assert disagg["handoffs"] == 1  # dispatch itself landed

            # dead prefill pool: evict it, no dispatch is attempted
            pre.close()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                fleet.poll()
                if fleet.role_counts().get("prefill", 0) == 0:
                    break
                time.sleep(0.05)
            assert fleet.role_counts().get("prefill", 0) == 0
            p3 = [int(t) for t in _prompt(rng, 20)]
            toks = run(p3)
            assert toks[len(p3):] == _ref_tokens(p, p3, 4)[len(p3):]
            disagg2 = _get(f"{router.url}/stats")["fleet"]["disagg"]
            assert disagg2["handoffs"] == disagg["handoffs"]
            assert disagg2["handoff_failures"] == \
                disagg["handoff_failures"]
            # page invariant on both survivors of all that
            dec_dec = _get(f"{dec.url}/stats")["generate"]["decode"]
            assert dec_dec["pages_in_use"] == 0
        finally:
            if router is not None:
                router.close()
            fleet.close()
            pre.close()
            dec.close()



# ================== real processes: SIGKILL-mid-handoff storm (@slow)
def _role_spawner(tmp_path, role, slow_ms=40):
    return _spawner(tmp_path, slow_ms=slow_ms, extra=("--role", role))


@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.disagg
class TestDisaggProcessDrill:
    PROMPT = list(range(1, 17)) + [3, 1, 4, 1]   # 2 full pages + tail
    N_TOKENS = 24

    def test_sigkill_prefill_mid_storm_zero_client_failures(
            self, tmp_path):
        """Acceptance drill: a long-prompt storm over a
        prefill=1/decode=2 fleet of REAL processes; the prefill
        replica is SIGKILLed while handoffs are in flight. Every
        stream completes bit-identically to the uninterrupted
        reference (handoffs that died fall back to plain prefill),
        zero client-visible failures, and at least one handoff
        actually happened before the kill."""
        fleet = Fleet(heartbeat_interval=0.2, heartbeat_timeout=3.0,
                      breaker_threshold=2, breaker_reset_s=0.4)
        router = None
        try:
            fleet.add_pool(role="prefill",
                           spawner=_role_spawner(tmp_path, "prefill"))
            fleet.add_pool(role="decode",
                           spawner=_role_spawner(tmp_path, "decode"))
            pre_rep = fleet.spawn_pool("default", "prefill", 1)[0]
            fleet.spawn_pool("default", "decode", 2)
            fleet.wait_ready(3, timeout=300)
            assert fleet.role_counts() == {"prefill": 1, "decode": 2}
            router = serve_fleet(fleet, fleet_kv="on")
            ref = _post(f"{router.url}/generate",
                        {"prompt": [self.PROMPT],
                         "max_tokens": self.N_TOKENS}, timeout=300)
            ref_toks = ref["tokens"][0]
            handoffs0 = _get(
                f"{router.url}/stats")["fleet"]["disagg"]["handoffs"]
            assert handoffs0 >= 1

            n = 4
            results, failures = [None] * n, []

            def worker(i):
                try:
                    results[i] = _post(
                        f"{router.url}/generate",
                        {"prompt": [self.PROMPT],
                         "max_tokens": self.N_TOKENS}, timeout=300)
                except Exception as e:  # noqa: BLE001
                    failures.append(repr(e))

            threads = [threading.Thread(target=worker, args=(i,),
                                        daemon=True) for i in range(n)]
            for t in threads:
                t.start()
            time.sleep(0.3)          # let handoffs get in flight
            chaos.sigkill(pre_rep.proc)
            for t in threads:
                t.join(timeout=300)
            assert failures == []    # ZERO client-visible failures
            for out in results:
                assert out is not None
                assert out["tokens"][0] == ref_toks
                assert out["finish_reasons"] == ["max_tokens"]
            # the decode pool survived with its pages balanced (the
            # dead prefill replica may still await heartbeat timeout —
            # only the decode survivors answer /stats)
            deadline = time.monotonic() + 10.0
            survivors = [rep for rep in fleet.ready_replicas()
                         if rep.id != pre_rep.id
                         and (rep.role or "unified") != "prefill"]
            assert len(survivors) == 2
            for rep in survivors:
                while time.monotonic() < deadline:
                    dec = rep.client.stats()["generate"]["decode"]
                    if dec["pages_in_use"] == 0:
                        break
                    time.sleep(0.1)
                assert dec["pages_in_use"] == 0
                assert dec["decode_step_programs"] <= 1
        finally:
            if router is not None:
                router.close(stop_replicas=True)
            else:
                fleet.close(stop_replicas=True)


# ------------------------------------ parity: JAX router vs port router
def _jax_net():
    from deeplearning4j_tpu.config import NeuralNetConfiguration as JConf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet

    conf = (JConf.builder()
            .lr(0.1).n_in(4).activation_function("tanh")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(1).use_adagrad(False)
            .list(2).hidden_layer_sizes([8])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=3)
            .pretrain(False).build())
    return JNet(conf)


class _Stack:
    """One package's router over n of its own servers, all holding the
    same float32 transformer."""

    def __init__(self, pkg, jax_params, port_params, n=2):
        if pkg == "jax":
            from deeplearning4j_tpu.serving import Fleet as F
            from deeplearning4j_tpu.serving import InferenceEngine as E
            from deeplearning4j_tpu.serving import serve_fleet as route
            from deeplearning4j_tpu.serving import serve_network as serve

            def engine():
                return E.for_transformer(jax_params, JAX_CFG)
            net = _jax_net
        else:
            F, route, serve, net = Fleet, serve_fleet, serve_network, _net

            def engine():
                return InferenceEngine.for_transformer(port_params, CFG,
                                                       device="cpu")
        self.handles = [serve(net(), n_replicas=1, max_delay_ms=1.0,
                              generate_engine=engine(), slots=4,
                              page_size=8) for _ in range(n)]
        self.fleet = F(start=False, heartbeat_timeout=5.0)
        for h in self.handles:
            self.fleet.attach(h.url)
        for _ in range(200):
            self.fleet.poll()
            if self.fleet.ready_count() >= n:
                break
            time.sleep(0.02)
        assert self.fleet.ready_count() == n
        self.router = route(self.fleet)

    @property
    def url(self):
        return self.router.url

    def close(self):
        self.router.close()
        for h in self.handles:
            h.close()


def _keys(obj):
    """The nested key structure of a JSON value (lists by their first
    element)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj:
        return [_keys(obj[0])]
    return None


def _fleet_families(text, label):
    """{family name: help} of this fleet's dl4j_fleet_* series."""
    helps = {ln.split()[2]: ln.split(None, 3)[3]
             for ln in text.splitlines() if ln.startswith("# HELP ")}
    names = set()
    for ln in text.splitlines():
        if ln.startswith("dl4j_fleet_") and f'fleet="{label}"' in ln:
            name = ln.split("{")[0]
            for suffix in ("_total", "_bucket", "_sum", "_count"):
                if name.endswith(suffix) and name[:-len(suffix)] in helps:
                    name = name[:-len(suffix)]
            names.add(name)
    return {n: helps.get(n) for n in names}


@pytest.fixture(scope="class")
def stacks(jax_params, tf_setup):
    built = {pkg: _Stack(pkg, jax_params, tf_setup[0])
             for pkg in ("jax", "port")}
    yield built
    for s in built.values():
        s.close()


REQUESTS = [
    {"prompt": [[1, 2, 3, 4]], "max_tokens": 6},
    {"prompt": [[5, 6, 7], [1, 2, 3, 4, 5, 6, 7, 8, 9]],
     "max_tokens": [4, 7]},
    {"prompt": [[2, 7, 1, 8, 2, 8, 1, 8, 2, 8]], "max_tokens": 5,
     "stream": True},
    {"prompt": [[3, 1, 4]], "max_tokens": 9, "eos_id": 11},
]


class TestRouterParityWithJax:
    @pytest.mark.parametrize("case", range(len(REQUESTS)))
    def test_tokens_identical_through_both_routers(self, stacks,
                                                   jax_params, case):
        body = REQUESTS[case]
        outs = {}
        for pkg, st in stacks.items():
            if body.get("stream"):
                events = _stream(f"{st.url}/generate", body)
                toks = [e for e in events if "token" in e]
                assert [e["token_index"] for e in toks] == \
                    list(range(len(toks)))
                outs[pkg] = ([(e["row"], e["token"]) for e in toks],
                             events[-1]["tokens"],
                             events[-1]["finish_reasons"])
            else:
                out = _post(f"{st.url}/generate", body)
                outs[pkg] = (out["tokens"], out["finish_reasons"])
        assert outs["port"] == outs["jax"]
        rows = body["prompt"]
        mts = body["max_tokens"]
        mts = mts if isinstance(mts, list) else [mts] * len(rows)
        final = outs["port"][-2]
        for row, mt, got in zip(rows, mts, final):
            ref = _ref_tokens(jax_params, row, mt)
            if "eos_id" in body and body["eos_id"] in ref[len(row):]:
                ref = ref[:ref.index(body["eos_id"], len(row)) + 1]
            assert got == ref

    def test_healthz_readyz_and_stats_shapes_match(self, stacks):
        for path in ("/healthz", "/readyz", "/stats"):
            got = _get(stacks["port"].url + path)
            ref = _get(stacks["jax"].url + path)
            assert _keys(got) == _keys(ref), path
        got = _get(stacks["port"].url + "/healthz")
        assert got["replicas"] == _get(stacks["jax"].url + "/healthz")[
            "replicas"]

    def test_fleet_series_names_and_help_match(self, stacks):
        texts = {}
        for pkg, st in stacks.items():
            with urllib.request.urlopen(f"{st.url}/metrics",
                                        timeout=30) as r:
                texts[pkg] = _fleet_families(r.read().decode(),
                                             st.fleet.label)
        assert texts["port"] == texts["jax"]
        assert "dl4j_fleet_requests_total" in texts["port"]
        assert "dl4j_fleet_stream_resumes_total" in texts["port"]

    def test_no_replica_left_answers_the_same_502_and_503(
            self, jax_params, tf_setup):
        shapes = {}
        for pkg in ("jax", "port"):
            st = _Stack(pkg, jax_params, tf_setup[0], n=1)
            try:
                for h in st.handles:
                    h.close()  # the router has not noticed yet
                with pytest.raises(urllib.error.HTTPError) as e:
                    _post(f"{st.url}/generate",
                          {"prompt": [[1, 2]], "max_tokens": 3})
                body = json.loads(e.value.read())
                assert e.value.code == 502
                assert body["error"] == "replica_failed"
                assert body["retryable"] is True
                # the connection failure evicted it: nothing to route to
                with pytest.raises(urllib.error.HTTPError) as e2:
                    _post(f"{st.url}/generate",
                          {"prompt": [[1, 2]], "max_tokens": 3})
                assert e2.value.code == 503
                assert e2.value.headers["Retry-After"] == "1"
                shapes[pkg] = (_keys(body), json.loads(e2.value.read()))
                assert st.fleet.state_counts()["evicted"] == 1
            finally:
                st.router.close()
        assert shapes["port"][0] == shapes["jax"][0]
        assert shapes["port"][1]["error"] == shapes["jax"][1]["error"] \
            == "no_ready_replicas"
