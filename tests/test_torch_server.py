"""The PyTorch port's serving front end (serving/server.py over
replicas.py, batcher.py and the engine, and the CLI's `serve` and
`batch`) held against the JAX package's on the CPU.

The round trips of the JAX package's `tests/test_serving_http.py` run
against a port server and, where a reply can be compared, against a JAX
server holding the same weights (the layer network carried across by
`weights.multilayer_params_from_jax`, the LM by
`weights.params_from_jax`): `/predict` outputs within 1e-5, `/generate`
tokens (plain, EOS with per-row `max_tokens`, streamed NDJSON lines and
their `token_index`) exactly equal, error codes equal, and the metric
families a scrape shows — names, help strings, label sets — equal. The
engine, `MicroBatcher` and `ReplicaSet` cases of the JAX package's
`tests/test_serving.py` run on the port's classes (the batcher's on both
packages' classes). `cli serve --smoke`'s announce line carries the JAX
CLI's keys; `cli batch` resumes exactly once after a truncated run.

On the CPU the port's `ReplicaSet.for_network` builds one engine (the
JAX package's builds one a device of its 8-device test mesh), so the
parity cases pass `n_replicas` and the dispatch cases build sets of
explicit engines.
"""

from __future__ import annotations

import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import cli as jcli
from deeplearning4j_tpu.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.models import transformer as jax_tf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.serving import InferenceEngine as JEngine
from deeplearning4j_tpu.serving import MicroBatcher as JBatcher
from deeplearning4j_tpu.serving import serve_network as jserve
from deeplearning4j_tpu.serving.kv_cache import generate_cached
from deeplearning4j_tpu.scaleout.checkpoint import DefaultModelSaver as JSaver
from deeplearning4j_tpu_torch import cli as pcli
from deeplearning4j_tpu_torch.checkpoint import ShardedModelSaver
from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.models import transformer as tf
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.scaleout.checkpoint import DefaultModelSaver
from deeplearning4j_tpu_torch.serving import (InferenceEngine, MicroBatcher,
                                             ReplicaSet, serve_network)
from deeplearning4j_tpu_torch.weights import (multilayer_params_from_jax,
                                              params_from_jax)

OUT_TOL = 1e-5
JAX_CFG = jax_tf.TransformerConfig(vocab_size=17, d_model=32, n_heads=2,
                                   n_layers=2, d_ff=64, max_len=64,
                                   interpret=True)
CFG = tf.TransformerConfig(vocab_size=17, d_model=32, n_heads=2,
                           n_layers=2, d_ff=64, max_len=64)
PS = 8
#: the metric families a serving scrape holds in both packages
SERVING_FAMILIES = ("dl4j_serve_", "dl4j_batcher_", "dl4j_decode_",
                    "dl4j_kv_", "dl4j_tier_", "dl4j_spec_",
                    "dl4j_compile_warmup_seconds")


def _conf(builder, hidden=8):
    return (builder.lr(0.1).n_in(4).activation_function("tanh")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(1).use_adagrad(False)
            .list(2).hidden_layer_sizes([hidden])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=3)
            .pretrain(False).build())


def _net(hidden=8):
    return MultiLayerNetwork(_conf(NeuralNetConfiguration.builder(), hidden),
                             device="cpu")


@pytest.fixture(scope="module")
def nets():
    """(port net, JAX net) on the same weights."""
    jnet = JNet(_conf(JConf.builder()))
    net = MultiLayerNetwork.from_config_json(jnet.conf.to_json(),
                                             device="cpu")
    net.param_table = multilayer_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet._params), device="cpu")
    return net, jnet


@pytest.fixture(scope="module")
def lm():
    jp = jax_tf.init_transformer_params(jax.random.PRNGKey(0), JAX_CFG)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


def _gen(pkg, lm):
    jp, tp = lm
    if pkg == "jax":
        return JEngine.for_transformer(jp, JAX_CFG)
    return InferenceEngine.for_transformer(tp, CFG, device="cpu")


def _serve(pkg, nets, **kw):
    net, jnet = nets
    if pkg == "jax":
        return jserve(jnet, **kw)
    return serve_network(net, **kw)


def _post(url, payload, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _stream(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["Content-Type"].startswith("application/x-ndjson")
        return [json.loads(line) for line in r.read().splitlines()
                if line.strip()]


def _code(fn, *a):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn(*a)
    return e.value.code


def _families(text):
    """{family: (help, type, {label-key sets})} of a Prometheus scrape,
    the serving families only."""
    out = {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, help_ = line[7:].split(" ", 1)
            out.setdefault(name, [help_, None, set()])[0] = help_
        elif line.startswith("# TYPE "):
            name, kind = line[7:].split(" ", 1)
            out.setdefault(name, [None, kind, set()])[1] = kind
        elif line and not line.startswith("#"):
            m = re.match(r"([a-z0-9_]+)(\{([^}]*)\})? ", line)
            series = m.group(1)
            fam = next((f for f in out if series == f
                        or series.startswith(f + "_")), series)
            keys = frozenset(kv.split("=", 1)[0] for kv in
                             (m.group(3) or "").split(",") if kv)
            out.setdefault(fam, [None, None, set()])[2].add(
                keys - {"le"})
    return {f: (h, k, frozenset(ls)) for f, (h, k, ls) in out.items()
            if f.startswith(SERVING_FAMILIES)}


# ------------------------------------------------------- round trips
class TestHTTPRoundTrip:
    def test_predict_healthz_stats_and_shutdown(self, nets):
        net, _ = nets
        x = np.random.RandomState(0).rand(3, 4)
        outs = {}
        for pkg in ("jax", "port"):
            handle = _serve(pkg, nets, n_replicas=1, max_batch_size=16,
                            max_delay_ms=1.0, warmup_shape=(4,))
            try:
                assert handle.port != 0
                health = _get(f"{handle.url}/healthz")
                assert health == {"ok": True, "replicas": 1}
                outs[pkg] = _post(f"{handle.url}/predict",
                                  {"inputs": x.tolist()})
                stats = _get(f"{handle.url}/stats")
                assert stats["replicas"]["rows"] >= 3
                assert stats["batcher"]["completed"] >= 1
                assert stats["replicas"]["bucket_forwards"] == {"8": 1}
                assert stats["warmup"]["recompiled_after_warmup"] == 0
                assert sorted(stats) == ["batcher", "checkpoint", "model_id",
                                         "replicas", "role", "uptime_s",
                                         "warmup"]
            finally:
                handle.close()
        np.testing.assert_allclose(outs["port"]["outputs"],
                                   outs["jax"]["outputs"], atol=OUT_TOL)
        assert outs["port"]["classes"] == outs["jax"]["classes"]
        np.testing.assert_allclose(
            outs["port"]["outputs"],
            net.output(torch.tensor(x, dtype=torch.float32)).numpy(),
            atol=OUT_TOL)
        # the socket is released and the port rebindable
        with pytest.raises((ConnectionError, urllib.error.URLError, OSError)):
            _get(f"{handle.url}/healthz", timeout=2)
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", handle.port))

    def test_generate_rows_eos_and_streams_match_jax(self, nets, lm):
        """Plain rows (the legacy `n_tokens` shape too), EOS with
        per-row `max_tokens`, and a two-row stream with its token
        indices: the JAX server's replies exactly."""
        jp, _ = lm
        prompt = [1, 2, 3, 4]
        ref = np.asarray(generate_cached(
            jp, jnp.asarray([prompt], jnp.int32), JAX_CFG, 12))[0, 4:]
        eos = int(ref[3])
        got = {}
        for pkg in ("jax", "port"):
            gen = _gen(pkg, lm)
            with _serve(pkg, nets, n_replicas=1, max_delay_ms=1.0,
                        generate_engine=gen, slots=4,
                        page_size=PS) as handle:
                url = f"{handle.url}/generate"
                got[pkg] = [
                    _post(url, {"prompt": [prompt], "n_tokens": 5}),
                    _post(url, {"prompt": [prompt, [5, 6, 7]],
                                "max_tokens": [12, 4], "eos_id": eos}),
                    _stream(url, {"prompt": [[1, 2, 3, 4], [5, 6, 7]],
                                  "max_tokens": 6, "stream": True,
                                  "token_index_base": [0, 3]}),
                    _post(url, {"prompt": [[1, 2, 3, 4], [5, 6, 7]],
                                "max_tokens": 6}),
                ]
        assert got["port"][:2] == got["jax"][:2]
        assert got["port"][3] == got["jax"][3]
        plain, eos_out, events, twin = got["port"]
        assert plain["tokens"][0][4:] == ref[:5].tolist()
        first = int(np.argmax(ref == eos))
        assert eos_out["finish_reasons"][0] == "eos"
        assert eos_out["tokens"][0] == prompt + ref[:first + 1].tolist()
        for row in (0, 1):
            mine = [(e["token"], e["token_index"]) for e in events
                    if e.get("row") == row]
            theirs = [(e["token"], e["token_index"]) for e in got["jax"][2]
                      if e.get("row") == row]
            assert mine == theirs
            assert [i for _, i in mine] == [3 * row + n for n in range(6)]
        assert events[-1] == got["jax"][2][-1]
        assert events[-1]["tokens"] == twin["tokens"]

    def test_metrics_names_help_and_labels_match_jax(self, nets, lm):
        """A scrape after /predict and /generate traffic: every serving
        family (serve, batcher, decode, kv, tier, spec) has the JAX
        server's name, help string, type and label sets; the device
        families are there (no memory gauges without a card)."""
        scraped = {}
        for pkg in ("jax", "port"):
            gen = _gen(pkg, lm)
            with _serve(pkg, nets, n_replicas=1, max_delay_ms=1.0,
                        generate_engine=gen, slots=2, page_size=PS,
                        warmup_shape=(4,)) as handle:
                _post(f"{handle.url}/predict", {"inputs": [[0.1] * 4]})
                _post(f"{handle.url}/generate",
                      {"prompt": [[1, 2, 3, 4]], "max_tokens": 5})
                with urllib.request.urlopen(f"{handle.url}/metrics",
                                            timeout=30) as r:
                    assert r.headers["Content-Type"].startswith(
                        "text/plain")
                    scraped[pkg] = r.read().decode()
                assert "dl4j_serve_requests" in _get(
                    f"{handle.url}/snapshot")
                label = gen.decode_loop.label
                text = scraped[pkg]
                assert (f'dl4j_kv_pages_total{{loop="{label}"}} '
                        f'{gen.decode_loop.n_pages}') in text
        ours, ref = _families(scraped["port"]), _families(scraped["jax"])
        # the JAX registry is process-wide and may also hold families
        # other JAX tests of this process registered (routers, fleets):
        # every port family must be a JAX family with the same help, type
        # and label names, and the server's own families must all be here
        assert len(ours) > 30
        for fam, (help_, kind, labels) in ours.items():
            assert fam in ref, fam
            assert (help_, kind) == ref[fam][:2], fam
            # label names, where both scrapes hold a series of the family
            # (a counter never incremented renders none)
            if labels and ref[fam][2]:
                assert labels == ref[fam][2], fam
        for fam in ("dl4j_serve_requests_total",
                    "dl4j_serve_latency_seconds",
                    "dl4j_serve_bucket_forwards_total",
                    "dl4j_serve_reloads_total", "dl4j_batcher_queue_depth",
                    "dl4j_batcher_batches_total",
                    "dl4j_decode_requests_total",
                    "dl4j_decode_tokens_streamed_total",
                    "dl4j_decode_step_seconds",
                    "dl4j_decode_kv_read_bytes_total",
                    "dl4j_decode_active_slots", "dl4j_kv_pages_total",
                    "dl4j_kv_pages_in_use", "dl4j_kv_prefix_hits_total",
                    "dl4j_tier_requests_total", "dl4j_tier_backlog",
                    "dl4j_tier_preemptions_total",
                    "dl4j_spec_acceptance_rate",
                    "dl4j_compile_warmup_seconds"):
            assert fam in ours and fam in ref, fam
        text = scraped["port"]
        for series in ("dl4j_device_count 0", "dl4j_jit_programs",
                       "dl4j_decode_kv_read_bytes_total",
                       "dl4j_decode_step_seconds_bucket"):
            assert series in text
        assert "dl4j_device_memory_bytes" not in text

    def test_keepalive_connection_survives_early_reply_paths(self, nets):
        import http.client

        with _serve("port", nets, n_replicas=1,
                    max_delay_ms=1.0) as handle:
            conn = http.client.HTTPConnection("127.0.0.1", handle.port,
                                              timeout=30)
            try:
                body = json.dumps({"prompt": [[1, 2]], "n_tokens": 2})
                conn.request("POST", "/generate", body=body,
                             headers={"Content-Type": "application/json"})
                assert conn.getresponse().read() is not None
                conn.request("POST", "/nowhere", body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                assert resp.status == 404
                resp.read()
                x = np.random.RandomState(0).rand(2, 4)
                conn.request("POST", "/predict",
                             body=json.dumps({"inputs": x.tolist()}),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                assert resp.status == 200
                assert np.asarray(json.loads(resp.read())["outputs"]
                                  ).shape == (2, 3)
            finally:
                conn.close()

    def test_slots_zero_bad_rows_and_error_codes_match_jax(self, nets, lm):
        codes = {}
        for pkg in ("jax", "port"):
            gen = _gen(pkg, lm)
            with _serve(pkg, nets, n_replicas=1, max_delay_ms=1.0,
                        generate_engine=gen, slots=0) as legacy:
                assert gen.decode_loop is None
                out = _post(f"{legacy.url}/generate",
                            {"prompt": [[1, 2, 3, 4]], "n_tokens": 5})
                assert len(out["tokens"][0]) == 9
                got = [_code(_post, f"{legacy.url}/generate",
                             {"prompt": [[1, 2]], "max_tokens": 2,
                              "stream": True})]
            gen = _gen(pkg, lm)
            with _serve(pkg, nets, n_replicas=1, max_delay_ms=1.0,
                        generate_engine=gen, slots=2,
                        page_size=PS) as handle:
                overlong = list(range(CFG.max_len - 2))
                got.append(_code(_post, f"{handle.url}/generate",
                                 {"prompt": [[1, 2, 3], overlong],
                                  "max_tokens": 8}))
                snap = gen.decode_loop.snapshot()
                assert snap["occupied_slots"] == 0 and snap["queued"] == 0
                assert snap["requests"] == 0
                got.append(_code(_post, f"{handle.url}/generate",
                                 {"prompt": [[1]], "max_tokens": 2,
                                  "priority": "bulk"}))
            with _serve(pkg, nets, n_replicas=1,
                        max_delay_ms=1.0) as plain:
                got += [_code(_post, f"{plain.url}/predict", {"nope": 1}),
                        _code(_post, f"{plain.url}/predict",
                              {"inputs": [[1.0, 2.0]]}),
                        _code(_post, f"{plain.url}/generate",
                              {"prompt": [[1]], "n_tokens": 2}),
                        _code(_post, f"{plain.url}/kv/export",
                              {"tokens": [1]}),
                        _code(_post, f"{plain.url}/prefill",
                              {"prompt": [1]}),
                        _code(_get, f"{plain.url}/nowhere")]
            codes[pkg] = got
        assert codes["port"] == codes["jax"] == [400, 400, 400, 400, 400,
                                                 404, 404, 404, 404]


# --------------------------------------------------------- readiness
class TestReadiness:
    def test_async_warmup_gates_readyz(self, nets):
        net, _ = nets
        rs = ReplicaSet.for_network(net, n_replicas=1, max_batch_size=16)
        gate = threading.Event()
        inner = rs.engines[0].warmup

        def gated(shape, **kw):
            assert gate.wait(30)
            inner(shape, **kw)

        rs.engines[0].warmup = gated
        handle = serve_network(replicas=rs, max_delay_ms=1.0,
                               warmup_shape=(4,), warmup_async=True)
        try:
            assert _get(f"{handle.url}/healthz")["ok"]
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(f"{handle.url}/readyz")
            assert e.value.code == 503
            body = json.loads(e.value.read())
            assert body["ready"] is False and "warmup" in body["reason"]
            gate.set()
            t0 = time.monotonic()
            while True:
                try:
                    ready = _get(f"{handle.url}/readyz")
                    break
                except urllib.error.HTTPError:
                    assert time.monotonic() - t0 < 30
                    time.sleep(0.05)
            assert ready["ready"] and ready["warmup_done"]
            assert rs.engines[0].warmed_up
            assert _get(f"{handle.url}/stats")["warmup"][
                "recompiled_after_warmup"] == 0
        finally:
            gate.set()
            handle.close()

    def test_readyz_payload_matches_jax_and_a_dead_loop_flips_it(self,
                                                                 nets, lm):
        bodies = {}
        for pkg in ("jax", "port"):
            gen = _gen(pkg, lm)
            with _serve(pkg, nets, n_replicas=1, max_delay_ms=1.0,
                        generate_engine=gen, slots=2, page_size=PS,
                        warmup_shape=(4,), role="decode",
                        model_id="m") as handle:
                _post(f"{handle.url}/generate",
                      {"prompt": [list(range(1, 17))], "max_tokens": 1})
                ready = _get(f"{handle.url}/readyz")
                ready.pop("warmup_seconds")
                bodies[pkg] = ready
                gen.decode_loop.close()
                with pytest.raises(urllib.error.HTTPError) as e:
                    _get(f"{handle.url}/readyz")
                assert e.value.code == 503
                assert "decode loop" in json.loads(e.value.read())["reason"]
                assert _get(f"{handle.url}/healthz")["ok"]
        assert bodies["port"] == bodies["jax"]
        assert bodies["port"]["kv_summary"]["heads"]
        assert bodies["port"]["role"] == "decode"


# ---------------------------------------------------------- shedding
class TestOverloadShedding:
    def test_predict_queue_full_sheds_503_with_retry_after(self):
        gate = threading.Event()

        class GatedEngine:
            decode_loop = None

            def infer(self, x):
                assert gate.wait(30)
                return np.zeros((x.shape[0], 3), np.float32)

            def snapshot(self):
                return {"requests": 0, "rows": 0, "errors": 0}

            def program_cache_size(self):
                return 0

        handle = serve_network(replicas=ReplicaSet([GatedEngine()]),
                               max_delay_ms=1.0, max_queue=1)
        try:
            results = []

            def post_bg():
                try:
                    results.append(_post(f"{handle.url}/predict",
                                         {"inputs": [[1.0, 2.0]]}))
                except Exception as e:  # noqa: BLE001
                    results.append(e)

            threads = [threading.Thread(target=post_bg, daemon=True)
                       for _ in range(2)]
            threads[0].start()
            time.sleep(0.3)
            threads[1].start()
            time.sleep(0.3)
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{handle.url}/predict", {"inputs": [[1.0, 2.0]]})
            assert e.value.code == 503
            assert int(e.value.headers["Retry-After"]) >= 1
            body = json.loads(e.value.read())
            assert body["error"] == "overloaded"
            assert body["retry_after_ms"] > 0
            gate.set()
            for t in threads:
                t.join(timeout=30)
            assert all(isinstance(r, dict) for r in results)
            assert handle.batcher.snapshot()["shed"] == 1
        finally:
            gate.set()
            handle.close()

    def test_generate_admission_full_sheds_503(self, nets, lm):
        gen = _gen("port", lm)
        with serve_network(nets[0], n_replicas=1, max_delay_ms=1.0,
                           generate_engine=gen, slots=1, page_size=PS,
                           max_waiting=0) as handle:
            req = urllib.request.Request(
                f"{handle.url}/generate",
                data=json.dumps({"prompt": [[1, 2, 3, 4]],
                                 "max_tokens": 48,
                                 "stream": True}).encode(),
                headers={"Content-Type": "application/json"})
            r = urllib.request.urlopen(req, timeout=60)
            assert "token" in json.loads(r.readline())
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{handle.url}/generate",
                      {"prompt": [[5, 6]], "max_tokens": 2})
            assert e.value.code == 503
            assert int(e.value.headers["Retry-After"]) >= 1
            body = json.loads(e.value.read())
            assert body["error"] == "overloaded" and body["tier"] == \
                "interactive"
            r.close()
            assert gen.decode_loop.snapshot()["shed"] == 1


# -------------------------------------------------------- hot reload
class TestHotReload:
    def _checkpoints(self, tmp_path):
        net_a, net_b = _net(), _net()
        x = np.random.RandomState(1).rand(48, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[
            np.random.RandomState(2).randint(0, 3, 48)]
        net_b.fit(x, y, epochs=3)
        sharded = str(tmp_path / "sharded")
        with ShardedModelSaver(sharded) as saver:
            saver.save(net_b, iterator_position=3)
        npz = str(tmp_path / "b.ckpt")
        DefaultModelSaver(npz, keep_old=False).save(net_b)
        return net_a, net_b, sharded, npz

    def test_reload_swaps_weights_without_dropping_requests(self,
                                                            tmp_path):
        net_a, net_b, sharded, npz = self._checkpoints(tmp_path)
        x = np.random.RandomState(0).rand(3, 4).astype(np.float32)
        ref_a = net_a.output(torch.tensor(x)).numpy()
        ref_b = net_b.output(torch.tensor(x)).numpy()
        assert not np.allclose(ref_a, ref_b)
        engines = [InferenceEngine.for_network(net_a, max_batch_size=16)
                   for _ in range(2)]
        with serve_network(replicas=ReplicaSet(engines), max_batch_size=16,
                           max_delay_ms=1.0, warmup_shape=(4,)) as handle:
            out = _post(f"{handle.url}/predict", {"inputs": x.tolist()})
            np.testing.assert_allclose(out["outputs"], ref_a, atol=OUT_TOL)
            stop = threading.Event()
            failures = []

            def hammer():
                while not stop.is_set():
                    try:
                        got = np.asarray(_post(f"{handle.url}/predict",
                                               {"inputs": x.tolist()}
                                               )["outputs"])
                        if not (np.allclose(got, ref_a, atol=OUT_TOL)
                                or np.allclose(got, ref_b, atol=OUT_TOL)):
                            failures.append("torn outputs")
                    except Exception as e:  # noqa: BLE001
                        failures.append(repr(e))

            t = threading.Thread(target=hammer, daemon=True)
            t.start()
            try:
                res = _post(f"{handle.url}/reload", {"path": sharded})
            finally:
                stop.set()
                t.join(timeout=30)
            assert res["reloaded"] and res["replicas"] == 2
            assert res["step"] == 3 and failures == []
            out2 = _post(f"{handle.url}/predict", {"inputs": x.tolist()})
            np.testing.assert_allclose(out2["outputs"], ref_b, atol=OUT_TOL)
            stats = _get(f"{handle.url}/stats")
            assert stats["last_reload"]["step"] == 3
            assert stats["checkpoint"]["step"] == 3
            _post(f"{handle.url}/reload", {"path": npz})
            out3 = _post(f"{handle.url}/predict", {"inputs": x.tolist()})
            np.testing.assert_allclose(out3["outputs"], ref_b, atol=OUT_TOL)

    def test_reload_error_paths(self, tmp_path):
        net_a, _, _, npz = self._checkpoints(tmp_path)
        with serve_network(net_a, n_replicas=1,
                           max_delay_ms=1.0) as handle:
            assert _code(_post, f"{handle.url}/reload", {}) == 400
            assert _code(_post, f"{handle.url}/reload",
                         {"path": str(tmp_path / "nope")}) == 404
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{handle.url}/reload", {"path": npz, "step": 5})
            assert e.value.code == 400
            assert "no steps" in json.loads(e.value.read())["error"]
            wrong = str(tmp_path / "wrong")
            with ShardedModelSaver(wrong) as saver:
                saver.save(_net(hidden=16))
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{handle.url}/reload", {"path": wrong})
            assert e.value.code == 400
            assert "0/W" in json.loads(e.value.read())["error"]
            x = np.random.RandomState(0).rand(2, 4).astype(np.float32)
            out = _post(f"{handle.url}/predict", {"inputs": x.tolist()})
            np.testing.assert_allclose(
                out["outputs"], net_a.output(torch.tensor(x)).numpy(),
                atol=OUT_TOL)
            assert _code(_post, f"{handle.url}/reload",
                         {"path": npz, "target": "draft"}) == 400

    def test_generate_reload_copies_into_the_loop_in_place(self, lm):
        """`load_params` on a transformer engine copies the new weights
        into the running loop's params in place (between dispatches):
        later streams decode with the new weights."""
        jp, tp = lm
        other = tf.init_transformer_params(3, CFG, device="cpu")
        eng = InferenceEngine.for_transformer(tp, CFG, device="cpu",
                                              decode_slots=2, page_size=PS)
        try:
            ptr = eng.decode_loop.params["embed"].data_ptr()
            eng.generate_stream([1, 2, 3], 6).result(60)
            eng.load_params(other, checkpoint={"path": "x", "step": 1})
            after = eng.generate_stream([1, 2, 3], 6).result(60)
            assert eng.decode_loop.params["embed"].data_ptr() == ptr
            ref = InferenceEngine.for_transformer(
                other, CFG, device="cpu").generate(np.array([[1, 2, 3]]), 6)
            assert after == ref[0, 3:].tolist()
            assert torch.equal(eng.decode_loop.params["embed"],
                               other["embed"])
            assert eng.snapshot()["checkpoint"] == {"path": "x", "step": 1}
            with pytest.raises(ValueError, match="embed"):
                eng.load_params({**other, "embed": other["embed"][:5]})
        finally:
            eng.close()


# ------------------------------------------------------------ engine
class TestEngine:
    def test_network_engine_matches_the_jax_engine(self, nets):
        net, jnet = nets
        eng = InferenceEngine.for_network(net, max_batch_size=16)
        jeng = JEngine.for_network(jnet, max_batch_size=16)
        assert eng.buckets == jeng.buckets
        assert eng.cache_key.split("|")[0] == jeng.cache_key.split("|")[0]
        for n in (1, 5, 9, 16, 20):
            x = np.random.RandomState(n).rand(n, 4).astype(np.float32)
            np.testing.assert_allclose(eng.infer(x), jeng.infer(x),
                                       atol=OUT_TOL)
        snap, jsnap = eng.snapshot(), jeng.snapshot()
        for key in ("requests", "rows", "padded_rows", "errors",
                    "bucket_forwards", "buckets", "compiled_programs"):
            assert snap[key] == jsnap[key], key

    def test_warmup_runs_every_bucket_then_no_new_shapes(self, nets):
        eng = InferenceEngine.for_network(nets[0], max_batch_size=16)
        eng.warmup((4,))
        assert eng.warmed_up and eng.warmup_seconds >= 0
        assert eng.program_cache_size() == len(eng.buckets)
        for n in (1, 5, 9, 16):
            eng.infer(np.zeros((n, 4), np.float32))
        assert eng.program_cache_size() == len(eng.buckets)
        assert eng.snapshot()["requests"] == 4

    def test_rejects_bad_requests(self, nets):
        eng = InferenceEngine.for_network(nets[0])
        with pytest.raises(ValueError, match="batch"):
            eng.infer(np.zeros((4,), np.float32))
        with pytest.raises(ValueError, match="empty"):
            eng.infer(np.zeros((0, 4), np.float32))
        with pytest.raises(ValueError, match="generate"):
            eng.generate(np.zeros((1, 4), np.int32), 4)
        with pytest.raises(ValueError, match="transformer"):
            eng.start_decode_loop()
        with pytest.raises(TypeError, match="decode_slots"):
            InferenceEngine.for_transformer({}, CFG, device="cpu",
                                            fleet_kv="on")

    def test_lstm_engine_matches_the_jax_engine(self):
        from deeplearning4j_tpu.models.lstm import LSTM as JLSTM
        from deeplearning4j_tpu_torch.nn import layers

        base = dict(layer="lstm", n_in=5, n_out=6,
                    activation_function="tanh", loss_function="mcxent")
        layer = layers.make_layer(NeuralNetConfiguration(**base),
                                  device="cpu")
        jlayer = JLSTM(JConf(**base))
        rng = np.random.default_rng(0)
        params = {name: (0.3 * rng.normal(size=shape)).astype(np.float32)
                  for name, shape in jlayer.param_shapes().items()}
        eng = InferenceEngine.for_lstm(layer, params, max_batch_size=8,
                                       device="cpu")
        jeng = JEngine.for_lstm(jlayer, {k: jnp.asarray(v)
                                         for k, v in params.items()},
                                max_batch_size=8)
        x = np.random.RandomState(0).rand(3, 7, 5).astype(np.float32)
        np.testing.assert_allclose(eng.infer(x), jeng.infer(x), atol=OUT_TOL)
        assert eng.snapshot()["bucket_forwards"] == {8: 1}


# ------------------------------------------------------------ batcher
BATCHERS = pytest.mark.parametrize("mb_cls", [MicroBatcher, JBatcher],
                                   ids=["port", "jax"])


class TestMicroBatcher:
    @BATCHERS
    def test_coalesces_and_preserves_order(self, mb_cls):
        seen = []

        def run(x):
            seen.append(x.shape[0])
            return x * 2.0

        results = {}
        with mb_cls(run, max_batch_size=64, max_delay_ms=20.0) as mb:
            def producer(i):
                x = np.full((i + 1, 3), float(i), np.float32)
                results[i] = (x, mb.submit(x))

            threads = [threading.Thread(target=producer, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for x, fut in results.values():
                np.testing.assert_allclose(fut.result(timeout=10), x * 2.0)
        assert sum(seen) == 36 and len(seen) < 8
        assert mb.snapshot()["completed"] == 8

    @BATCHERS
    def test_flushes_holds_oversize_and_single_rows(self, mb_cls):
        with mb_cls(lambda x: x, max_batch_size=1024,
                    max_delay_ms=10.0) as mb:
            start = time.monotonic()
            mb.submit(np.ones((2, 2), np.float32)).result(timeout=10)
            assert time.monotonic() - start < 5.0
            assert mb.submit(np.ones((3,), np.float32)).result(
                timeout=10).shape == (1, 3)
        sizes = []
        with mb_cls(lambda x: (sizes.append(x.shape[0]), x)[1],
                    max_batch_size=8, max_delay_ms=50.0) as mb:
            futs = [mb.submit(np.zeros((5, 2), np.float32))
                    for _ in range(3)]
            for f in futs:
                assert f.result(timeout=10).shape == (5, 2)
        assert all(s <= 8 for s in sizes)

    @BATCHERS
    def test_error_isolation_and_engine_failure(self, mb_cls):
        with mb_cls(lambda x: x + 1.0, max_batch_size=64,
                    max_delay_ms=30.0) as mb:
            good1 = mb.submit(np.zeros((2, 4), np.float32))
            bad = mb.submit(np.zeros((2, 7), np.float32))
            good2 = mb.submit(np.zeros((3, 4), np.float32))
            assert good1.result(timeout=10).shape == (2, 4)
            assert good2.result(timeout=10).shape == (3, 4)
            with pytest.raises(ValueError, match="feature shape"):
                bad.result(timeout=10)
        snap = mb.snapshot()
        assert snap["completed"] == 2 and snap["failed"] == 1
        calls = {"n": 0}

        def flaky(x):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("boom")
            return x

        with mb_cls(flaky, max_batch_size=4, max_delay_ms=1.0) as mb:
            with pytest.raises(RuntimeError, match="boom"):
                mb.submit(np.zeros((4, 2), np.float32)).result(timeout=10)
            assert mb.submit(np.zeros((4, 2), np.float32)).result(
                timeout=10).shape == (4, 2)

    @BATCHERS
    def test_close_flushes_and_a_cancelled_future_spares_the_worker(
            self, mb_cls):
        mb = mb_cls(lambda x: x, max_batch_size=64, max_delay_ms=5.0)
        fut = mb.submit(np.ones((1, 2), np.float32))
        mb.close()
        assert fut.result(timeout=10).shape == (1, 2)
        with pytest.raises(RuntimeError, match="closed"):
            mb.submit(np.ones((1, 2), np.float32)).result()
        gate = threading.Event()

        def slow(x):
            gate.wait(5)
            return x

        with mb_cls(slow, max_batch_size=1, max_delay_ms=1.0) as mb:
            f1 = mb.submit(np.zeros((1, 2), np.float32))
            time.sleep(0.05)
            f2 = mb.submit(np.zeros((1, 2), np.float32))
            assert f2.cancel()
            gate.set()
            assert f1.result(timeout=10).shape == (1, 2)
            assert mb.submit(np.zeros((1, 2), np.float32)).result(
                timeout=10).shape == (1, 2)
        assert mb.snapshot()["cancelled"] == 1


# ------------------------------------------------------------ replicas
class TestReplicaSet:
    def test_round_robin_spreads_identical_results(self, nets):
        engines = [InferenceEngine.for_network(nets[0], max_batch_size=8)
                   for _ in range(3)]
        reps = ReplicaSet(engines)
        x = np.random.RandomState(0).rand(3, 4).astype(np.float32)
        ref = reps.infer(x)
        for _ in range(5):
            np.testing.assert_allclose(reps.infer(x), ref, atol=1e-6)
        snap = reps.snapshot()
        assert snap["replicas"] == 3
        assert all(r["requests"] == 2 for r in snap["per_replica"])
        with reps.batcher(max_batch_size=16, max_delay_ms=5.0) as mb:
            futs = [mb.submit(np.zeros((2, 4), np.float32))
                    for _ in range(6)]
            for f in futs:
                assert f.result(timeout=30).shape == (2, 3)

    def test_for_network_builds_one_engine_on_the_cpu(self, nets):
        reps = ReplicaSet.for_network(nets[0])
        assert len(reps.engines) == 1
        assert reps.engines[0].device == torch.device("cpu")
        with pytest.raises(ValueError, match="at least one"):
            ReplicaSet([])
        with pytest.raises(ValueError, match="n_replicas"):
            ReplicaSet.for_network(nets[0], n_replicas=0)

    def test_least_outstanding_avoids_busy_replica(self):
        gate = threading.Event()

        class StubEngine:
            decode_loop = None

            def __init__(self, block=False):
                self.block = block
                self.served = 0

            def infer(self, x):
                self.served += 1
                if self.block:
                    assert gate.wait(30)
                return np.asarray(x)

        slow, fast = StubEngine(block=True), StubEngine()
        reps = ReplicaSet([slow, fast])
        blocked = threading.Thread(
            target=reps.infer, args=(np.zeros((1, 2), np.float32),),
            daemon=True)
        try:
            blocked.start()
            t0 = time.monotonic()
            while slow.served == 0:
                assert time.monotonic() - t0 < 30
                time.sleep(0.005)
            assert reps.outstanding() == [1, 0]
            for _ in range(4):
                reps.infer(np.zeros((1, 2), np.float32))
            assert fast.served == 4 and slow.served == 1
        finally:
            gate.set()
            blocked.join(timeout=30)
        assert reps.outstanding() == [0, 0]
        for _ in range(4):
            reps.infer(np.zeros((1, 2), np.float32))
        assert slow.served == 3 and fast.served == 6

    def test_generate_stream_prefers_least_loaded_loop(self):
        class StubLoop:
            def __init__(self, load):
                self.load = load

        class StubEngine:
            def __init__(self, loop):
                self.decode_loop = loop
                self.streams = 0

            def generate_stream(self, prompt, max_tokens, eos_id=None,
                                speculation=True):
                self.streams += 1
                return f"stream-{id(self)}"

        busy = StubEngine(StubLoop(load=3))
        idle = StubEngine(StubLoop(load=0))
        plain = StubEngine(None)
        reps = ReplicaSet([busy, plain, idle])
        for _ in range(3):
            reps.generate_stream([1, 2], 4)
        assert idle.streams == 3 and busy.streams == 0
        idle.decode_loop.load = 3
        for _ in range(4):
            reps.generate_stream([1, 2], 4)
        assert busy.streams == 2 and idle.streams == 5
        with pytest.raises(ValueError, match="decode loop"):
            ReplicaSet([plain]).generate_stream([1], 2)


# ---------------------------------------------------------------- CLI
def _keys(obj):
    """The nested key structure of an announce line."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    return None


class TestCLI:
    def test_serve_smoke_announces_the_jax_keys(self, tmp_path, capsys,
                                                nets):
        ckpt = str(tmp_path / "m.ckpt")
        JSaver(ckpt).save(nets[1])
        spec = json.dumps({"vocab_size": 17, "d_model": 32, "n_heads": 2,
                           "n_layers": 2, "d_ff": 64, "max_len": 64,
                           "seed": 1})
        common = ["serve", "-m", ckpt, "--replicas", "1", "--max-delay-ms",
                  "1", "--transformer", spec, "--page-size", "8",
                  "--smoke"]
        assert jcli.main(common) == 0
        ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert pcli.main(common + ["--device", "cpu"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert _keys(out) == _keys(ref)
        assert out["serving"].startswith("http://127.0.0.1:")
        assert out["replicas"] == 1
        assert out["decode"]["fleet_kv"] == ref["decode"]["fleet_kv"] == "on"
        assert out["decode"]["kernel"] == {"requested": "auto",
                                           "selected": "gather"}

    def test_serve_metrics_port_and_trace(self, tmp_path, capsys, nets):
        """serve's --metrics-port starts a standalone /metrics endpoint
        (announced in place of the server's) and --trace writes a Chrome
        trace on exit, as the JAX CLI's do."""
        ckpt = str(tmp_path / "m.ckpt")
        JSaver(ckpt).save(nets[1])
        trace_path = tmp_path / "t.json"
        assert pcli.main(["serve", "-m", ckpt, "--replicas", "1",
                          "--smoke", "--metrics-port", "0", "--trace",
                          str(trace_path), "--device", "cpu"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["metrics"].startswith("http://127.0.0.1:")
        assert not out["metrics"].startswith(out["serving"])
        with open(trace_path) as f:
            assert "traceEvents" in json.load(f)

    def test_transformer_spec_is_deterministic_across_processes(self):
        """Stream failover relies on it: the same SPEC gives the same
        weights in every process."""
        import subprocess
        import sys

        spec = '{"vocab_size": 17, "d_model": 32, "seed": 5}'
        code = ("import sys, torch; sys.path.insert(0, sys.argv[1]); "
                "from deeplearning4j_tpu_torch.cli import "
                "_transformer_from_spec as f; p, _ = f(sys.argv[2], 'cpu'); "
                "print(float(p['embed'].double().sum()), "
                "float(p['blocks'][1]['W2'].double().abs().sum()))")
        root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
        outs = {subprocess.run([sys.executable, "-c", code, root, spec],
                               capture_output=True, text=True, timeout=120,
                               check=True).stdout for _ in range(2)}
        assert len(outs) == 1
        p, cfg = pcli._transformer_from_spec(spec, "cpu")
        assert cfg.d_model == 32 and cfg.vocab_size == 17
        assert outs == {f"{float(p['embed'].double().sum())} "
                        f"{float(p['blocks'][1]['W2'].double().abs().sum())}"
                        "\n"}

    def _args(self, url, inp, outp, **kw):
        base = dict(url=url, input=inp, output=outp, journal=None,
                    max_tokens=6, batch_size=2, eos_id=None,
                    timeout=120.0, max_shed_retries=10, progress=False)
        base.update(kw)
        return SimpleNamespace(**base)

    def test_batch_resumes_exactly_once_after_a_truncated_run(
            self, tmp_path, capsys, nets, lm):
        gen = _gen("port", lm)
        inp = str(tmp_path / "prompts.jsonl")
        outp = str(tmp_path / "out.jsonl")
        prompt = [1, 5, 2, 7, 3, 9]
        with open(inp, "w") as f:
            for i in range(6):
                f.write(json.dumps(prompt[:2 + (i % 3)]) + "\n")
        with serve_network(nets[0], n_replicas=1, max_delay_ms=1.0,
                           generate_engine=gen, slots=2,
                           page_size=PS) as handle:
            assert pcli.cmd_batch(self._args(handle.url, inp, outp)) == 0
            done = json.loads(
                capsys.readouterr().out.strip().splitlines()[-1])
            assert done["batch_done"] and done["rows"] == 6
            assert done["resumed_at"] == 0
            with open(outp) as f:
                first = [json.loads(ln) for ln in f]
            assert [r["row"] for r in first] == list(range(6))
            assert all(len(r["tokens"]) == 2 + (i % 3) + 6
                       for i, r in enumerate(first))
            journal = outp + ".journal"
            with open(journal) as f:
                state = json.load(f)
            assert state["cursor"] == 6
            state["cursor"] = 2
            with open(journal, "w") as f:
                json.dump(state, f)
            with open(outp, "w") as f:
                for r in first[:3]:
                    f.write(json.dumps(r) + "\n")
            assert pcli.cmd_batch(self._args(handle.url, inp, outp)) == 0
            done = json.loads(
                capsys.readouterr().out.strip().splitlines()[-1])
            assert done["resumed_at"] == 2
            with open(outp) as f:
                assert [json.loads(ln) for ln in f] == first
            tiers = gen.decode_loop.snapshot()["tiers"]["requests"]
            assert tiers["batch"] == 10 and tiers["interactive"] == 0
            # a journal committed against another input refuses
            with open(inp, "a") as f:
                f.write(json.dumps(prompt) + "\n")
            assert pcli.cmd_batch(self._args(handle.url, inp, outp)) == 2
