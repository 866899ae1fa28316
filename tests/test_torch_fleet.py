"""The PyTorch port's serving fleet (serving/fleet.py) and router
(serving/router.py) on the CPU: the JAX package's `tests/test_fleet.py`
contracts (routing with retries, readiness gating, eviction and rejoin,
load shedding, rolling / canary reload, the autoscaler, `cli fleet`) over
port replicas — in-process `serve_network` servers, and `cli serve`
processes spawned with `--device cpu` — plus the control plane's
`TestFleetCrashSafety` and `TestProcsAdoption`
(`tests/test_controlplane.py`), and parity with the JAX package: the
circuit breaker's state sequence, the autoscaler's decisions, the state
tracker's stale workers under a fake clock, and the scaleout work codec.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler

import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import (Autoscaler, Fleet, ReplicaSpawner,
                                        serve_fleet, serve_network)
from deeplearning4j_tpu_torch.serving.fleet import EVICTED, READY, STARTING
from deeplearning4j_tpu_torch.serving.router import ReplicaClient
from deeplearning4j_tpu_torch.utils import procs
from deeplearning4j_tpu_torch.utils.httpd import start_http_server
from deeplearning4j_tpu_torch.utils.statefile import StateFile

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _net(n_in=4, n_out=3, hidden=8):
    conf = (NeuralNetConfiguration.builder()
            .lr(0.1).n_in(n_in).activation_function("tanh")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(1).use_adagrad(False)
            .list(2).hidden_layer_sizes([hidden])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=n_out)
            .pretrain(False).build())
    return MultiLayerNetwork(conf, device="cpu")


def _post(url, payload, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _poll_until_ready(fleet, n, tries=100):
    """Drive the monitor inline (start=False fleets) until n READY."""
    for _ in range(tries):
        fleet.poll()
        if fleet.ready_count() >= n:
            return
        time.sleep(0.02)
    raise AssertionError(
        f"only {fleet.ready_count()}/{n} ready: {fleet.state_counts()}")


class TestFleetRouting:
    def test_predict_routes_with_retries_metrics_and_stats(self):
        net = _net()
        handles = [serve_network(net, n_replicas=1, max_delay_ms=1.0,
                                 warmup_shape=(4,)) for _ in range(2)]
        fleet = Fleet(start=False, heartbeat_interval=0.1,
                      heartbeat_timeout=5.0)
        try:
            for h in handles:
                fleet.attach(h.url)
            _poll_until_ready(fleet, 2)
            with serve_fleet(fleet) as router:
                x = np.random.RandomState(0).rand(3, 4)
                ref = np.asarray(net.output(x.astype(np.float32)))
                for _ in range(8):
                    out = _post(f"{router.url}/predict",
                                {"inputs": x.tolist()})
                    np.testing.assert_allclose(
                        np.asarray(out["outputs"]), ref, atol=1e-5)
                # least-outstanding with RR tiebreak spread the traffic
                served = [h.stats()["replicas"]["requests"]
                          for h in handles]
                assert all(s >= 1 for s in served)
                # router health/readiness surface
                assert _get(f"{router.url}/healthz")["ok"]
                assert _get(f"{router.url}/readyz")["ready_replicas"] == 2
                stats = _get(f"{router.url}/stats")["fleet"]
                assert stats["states"][READY] == 2
                assert stats["requests"]["predict"] >= 8
                assert stats["outstanding"] == 0
                # acceptance bar: dl4j_fleet_* scrape e2e from the
                # ROUTER's /metrics
                with urllib.request.urlopen(f"{router.url}/metrics",
                                            timeout=30) as r:
                    text = r.read().decode()
                lab = f'fleet="{fleet.label}"'
                assert (f'dl4j_fleet_replicas{{{lab},state="ready"}} 2'
                        in text)
                for series in ("dl4j_fleet_requests_total",
                               "dl4j_fleet_request_latency_seconds_bucket",
                               "dl4j_fleet_outstanding",
                               "dl4j_fleet_evictions_total",
                               "dl4j_fleet_shed_total"):
                    assert series in text, f"{series} missing"
                # a client error passes through untouched (no retry)
                with pytest.raises(urllib.error.HTTPError) as e:
                    _post(f"{router.url}/predict", {"nope": 1})
                assert e.value.code == 400
        finally:
            fleet.close()
            for h in handles:
                h.close()

    def test_readiness_gates_admission(self):
        """A replica that is alive but not ready (still compiling)
        receives no traffic until /readyz flips — the warmup-gated
        spin-up story (arXiv:1810.09868 framing)."""
        ready_flag = threading.Event()

        class FakeReplica(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path.startswith("/healthz"):
                    body, code = b'{"ok": true}', 200
                elif self.path.startswith("/readyz"):
                    if ready_flag.is_set():
                        body, code = b'{"ready": true}', 200
                    else:
                        body, code = (b'{"ready": false, '
                                      b'"reason": "warmup"}', 503)
                else:
                    body, code = b'{}', 404
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        srv = start_http_server(FakeReplica)
        fleet = Fleet(start=False, heartbeat_timeout=5.0)
        try:
            rep = fleet.attach(srv.url)
            fleet.poll()
            assert rep.state == STARTING  # alive, not admitted
            with pytest.raises(Exception):
                fleet.select()  # nothing ready to route to
            ready_flag.set()
            fleet.poll()
            assert rep.state == READY
            assert fleet.select().id == rep.id
            fleet.release(rep)
        finally:
            fleet.close()
            srv.close()

    def test_ready_replica_losing_readiness_is_evicted(self):
        ready_flag = threading.Event()
        ready_flag.set()

        class FakeReplica(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                ok = ready_flag.is_set()
                if self.path.startswith("/healthz"):
                    body, code = b'{"ok": true}', 200
                elif self.path.startswith("/readyz"):
                    body, code = ((b'{"ready": true}', 200) if ok else
                                  (b'{"ready": false, "reason": '
                                   b'"decode loop not running"}', 503))
                else:
                    body, code = b'{}', 404
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        srv = start_http_server(FakeReplica)
        fleet = Fleet(start=False, heartbeat_timeout=5.0)
        try:
            rep = fleet.attach(srv.url)
            fleet.poll()
            assert rep.state == READY
            ready_flag.clear()  # e.g. its decode loop died
            fleet.poll()
            assert rep.state == EVICTED
            assert "decode loop" in rep.eviction_reason
            ready_flag.set()  # and it recovers
            fleet.poll()
            assert rep.state == READY
            snap = fleet.snapshot()
            assert snap["evictions"] == 1 and snap["readmissions"] == 1
        finally:
            fleet.close()
            srv.close()


class TestGenerateThroughRouter:
    def test_generate_proxies_and_fails_fast_with_structured_error(self):
        from deeplearning4j_tpu_torch.models.transformer import (
            TransformerConfig, init_transformer_params)
        from deeplearning4j_tpu_torch.serving import InferenceEngine

        cfg = TransformerConfig(vocab_size=17, d_model=32, n_heads=2,
                                n_layers=2, d_ff=64, max_len=64)
        params = init_transformer_params(0, cfg, device="cpu")
        gen = InferenceEngine.for_transformer(params, cfg, device="cpu")
        handle = serve_network(_net(), n_replicas=1, max_delay_ms=1.0,
                               generate_engine=gen, slots=4, page_size=8)
        fleet = Fleet(start=False, heartbeat_timeout=5.0)
        try:
            fleet.attach(handle.url)
            _poll_until_ready(fleet, 1)
            with serve_fleet(fleet) as router:
                out = _post(f"{router.url}/generate",
                            {"prompt": [[1, 2, 3, 4]], "max_tokens": 5})
                assert len(out["tokens"][0]) == 9
                assert out["finish_reasons"] == ["max_tokens"]
                # streaming passthrough: NDJSON lines relayed as the
                # replica emits them
                req = urllib.request.Request(
                    f"{router.url}/generate",
                    data=json.dumps({"prompt": [[1, 2, 3]],
                                     "max_tokens": 4,
                                     "stream": True}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    assert r.headers["Content-Type"].startswith(
                        "application/x-ndjson")
                    events = [json.loads(ln) for ln in r if ln.strip()]
                assert events[-1]["done"] is True
                assert len([e for e in events if "token" in e]) == 4
                # kill the replica (router hasn't noticed yet): a
                # generate fails FAST with a structured error — no
                # blind replay of an expensive stream
                handle.close()
                with pytest.raises(urllib.error.HTTPError) as e:
                    _post(f"{router.url}/generate",
                          {"prompt": [[1, 2]], "max_tokens": 3})
                assert e.value.code == 502
                body = json.loads(e.value.read())
                assert body["error"] == "replica_failed"
                assert body["retryable"] is True
                # ...and the connection failure evicted it immediately
                assert fleet.state_counts()[EVICTED] == 1
        finally:
            fleet.close()
            handle.close()


class TestLoadShedding:
    def test_high_water_mark_sheds_with_retry_after(self):
        gate = threading.Event()
        started = threading.Semaphore(0)

        class SlowReplica(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                ok = self.path.startswith(("/healthz", "/readyz"))
                body = b'{"ok": true, "ready": true}' if ok else b'{}'
                self.send_response(200 if ok else 404)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                self.rfile.read(n)
                started.release()
                gate.wait(30)
                body = b'{"outputs": [[1.0]], "classes": [0]}'
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        srv = start_http_server(SlowReplica)
        fleet = Fleet(start=False, heartbeat_timeout=5.0,
                      shed_high_water=2)
        try:
            fleet.attach(srv.url)
            fleet.poll()
            router = serve_fleet(fleet)
            results = []

            def hammer():
                try:
                    results.append(_post(f"{router.url}/predict",
                                         {"inputs": [[1.0]]}))
                except Exception as e:  # noqa: BLE001
                    results.append(e)

            threads = [threading.Thread(target=hammer) for _ in range(2)]
            for t in threads:
                t.start()
            # both requests are inside the replica (outstanding == 2)
            assert started.acquire(timeout=10)
            assert started.acquire(timeout=10)
            # the third request sheds at the router, replica untouched
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{router.url}/predict", {"inputs": [[1.0]]})
            assert e.value.code == 503
            assert int(e.value.headers["Retry-After"]) >= 1
            body = json.loads(e.value.read())
            assert body["error"] == "overloaded"
            assert body["retry_after_ms"] > 0
            gate.set()
            for t in threads:
                t.join(timeout=30)
            assert all(isinstance(r, dict) for r in results)
            assert fleet.snapshot()["shed"]["predict"] == 1
            router.close()
        finally:
            gate.set()
            fleet.close()
            srv.close()


class TestEvictionRejoin:
    def _spawner(self, tmp_path, net):
        from deeplearning4j_tpu_torch.scaleout.checkpoint import DefaultModelSaver

        ckpt = str(tmp_path / "fleet.ckpt")
        DefaultModelSaver(ckpt, keep_old=False).save(net)
        env = dict(os.environ,
                   PYTHONPATH=REPO_ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        return ReplicaSpawner(ckpt, serve_args=["--max-delay-ms", "1",
                                                "--device", "cpu"],
                              env=env)

    def test_kill_spawned_replica_mid_hammer_then_rejoin(self, tmp_path):
        """Acceptance drill: kill a REAL replica process under
        concurrent /predict load — zero failed client requests
        (idempotent retries), eviction within the heartbeat timeout,
        and a restarted replica passes /readyz and receives traffic."""
        net = _net()
        spawner = self._spawner(tmp_path, net)
        fleet = Fleet(spawner=spawner, heartbeat_interval=0.2,
                      heartbeat_timeout=1.5)
        router = None
        extra_proc = None
        try:
            fleet.spawn(2)
            fleet.wait_ready(2, timeout=150)
            router = serve_fleet(fleet)
            victim = next(iter(fleet._replicas.values()))

            x = np.random.RandomState(0).rand(2, 4)
            failures, stop = [], threading.Event()

            def hammer():
                while not stop.is_set():
                    try:
                        out = _post(f"{router.url}/predict",
                                    {"inputs": x.tolist()}, timeout=30)
                        if len(out["classes"]) != 2:
                            failures.append("bad shape")
                    except Exception as e:  # noqa: BLE001
                        failures.append(repr(e))

            threads = [threading.Thread(target=hammer, daemon=True)
                       for _ in range(4)]
            for t in threads:
                t.start()
            time.sleep(0.4)         # load flowing through both
            killed_at = time.monotonic()
            victim.proc.kill()      # hard kill mid-hammer
            # eviction lands within the heartbeat timeout (request-path
            # connection failures evict even faster)
            while victim.state != EVICTED:
                if time.monotonic() - killed_at > 1.5 + 2.0:
                    raise AssertionError(
                        f"not evicted in time: {fleet.state_counts()}")
                time.sleep(0.05)
            evicted_after = time.monotonic() - killed_at
            time.sleep(0.6)         # keep hammering the survivor
            stop.set()
            for t in threads:
                t.join(timeout=30)
            assert failures == []   # ZERO failed client requests
            assert evicted_after <= 1.5 + 2.0
            assert fleet.snapshot()["evictions"] >= 1

            # restart on the SAME port: the fleet's existing record
            # sees /healthz + /readyz pass again and readmits it
            extra_proc, _ = spawner.spawn(port=victim.client.port)
            fleet.wait_ready(2, timeout=150)
            assert victim.state == READY
            assert fleet.snapshot()["readmissions"] >= 1
            served_before = ReplicaClient(
                victim.client.url).stats()["replicas"]["requests"]
            for _ in range(6):
                _post(f"{router.url}/predict", {"inputs": x.tolist()})
            served_after = ReplicaClient(
                victim.client.url).stats()["replicas"]["requests"]
            assert served_after > served_before  # traffic flows again
        finally:
            if router is not None:
                router.close(stop_replicas=True)
            else:
                fleet.close(stop_replicas=True)
            if extra_proc is not None:
                ReplicaSpawner.stop(extra_proc)

    def test_in_process_eviction_and_rejoin_via_monitor(self):
        """Monitor-driven twin (no processes): a closed endpoint goes
        stale and is evicted with NO request traffic flowing; reopening
        the same port readmits it."""
        net = _net()
        handle = serve_network(net, n_replicas=1, max_delay_ms=1.0)
        port = handle.port
        fleet = Fleet(heartbeat_interval=0.1, heartbeat_timeout=0.6)
        handle2 = None
        try:
            rep = fleet.attach(handle.url)
            fleet.wait_ready(1, timeout=30)
            handle.close()
            deadline = time.monotonic() + 5.0
            while rep.state != EVICTED:
                assert time.monotonic() < deadline, "eviction missed"
                time.sleep(0.05)
            assert rep.eviction_reason == "heartbeat timeout"
            handle2 = serve_network(net, n_replicas=1, max_delay_ms=1.0,
                                    port=port)
            fleet.wait_ready(1, timeout=30)
            assert rep.state == READY
        finally:
            fleet.close()
            if handle2 is not None:
                handle2.close()


class TestRollingReload:
    def _checkpoints(self, tmp_path):
        """net_a/net_b (same arch, different weights) as sharded dirs,
        plus an arch-mismatched checkpoint for canary failures."""
        from deeplearning4j_tpu_torch.checkpoint import ShardedModelSaver

        net_a, net_b = _net(), _net()
        x = np.random.RandomState(1).rand(48, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[
            np.random.RandomState(2).randint(0, 3, 48)]
        net_b.fit(x, y, epochs=3)
        a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
        with ShardedModelSaver(a_dir) as s:
            s.save(net_a)
        with ShardedModelSaver(b_dir) as s:
            s.save(net_b)
        wide = _net(hidden=16)
        wrong_dir = str(tmp_path / "wrong")
        with ShardedModelSaver(wrong_dir) as s:
            s.save(wide)
        return net_a, net_b, a_dir, b_dir, wrong_dir

    def _fleet(self, net_a, a_dir, n=3):
        handles = [serve_network(net_a, n_replicas=1, max_delay_ms=1.0,
                                 warmup_shape=(4,)) for _ in range(n)]
        fleet = Fleet(start=False, heartbeat_timeout=10.0,
                      initial_checkpoint=a_dir)
        for h in handles:
            fleet.attach(h.url)
        _poll_until_ready(fleet, n)
        return handles, fleet

    def test_zero_downtime_rolling_reload_never_mixes_weights(
            self, tmp_path):
        net_a, net_b, a_dir, b_dir, _ = self._checkpoints(tmp_path)
        x = np.random.RandomState(0).rand(3, 4).astype(np.float32)
        ref_a, ref_b = (np.asarray(net_a.output(x)),
                        np.asarray(net_b.output(x)))
        assert not np.allclose(ref_a, ref_b)
        handles, fleet = self._fleet(net_a, a_dir, n=3)
        try:
            with serve_fleet(fleet) as router:
                failures, mixed, stop = [], [], threading.Event()

                def hammer():
                    while not stop.is_set():
                        try:
                            out = _post(f"{router.url}/predict",
                                        {"inputs": x.tolist()})
                            got = np.asarray(out["outputs"])
                            if not (np.allclose(got, ref_a, atol=1e-5)
                                    or np.allclose(got, ref_b,
                                                   atol=1e-5)):
                                mixed.append(got)
                        except Exception as e:  # noqa: BLE001
                            failures.append(repr(e))

                threads = [threading.Thread(target=hammer, daemon=True)
                           for _ in range(3)]
                for t in threads:
                    t.start()
                time.sleep(0.2)
                res = fleet.rolling_reload(b_dir)
                time.sleep(0.2)
                stop.set()
                for t in threads:
                    t.join(timeout=30)
                assert res["reloaded"] is True
                assert len(res["replicas"]) == 3
                assert failures == []   # zero downtime
                assert mixed == []      # no response mixed old/new
                # every replica now serves the NEW weights
                for h in handles:
                    out = _post(f"{h.url}/predict", {"inputs": x.tolist()})
                    np.testing.assert_allclose(np.asarray(out["outputs"]),
                                               ref_b, atol=1e-5)
                assert fleet.current_checkpoint == b_dir
                assert fleet.snapshot()["reloads"]["ok"] == 1
                assert fleet.state_counts()[READY] == 3
        finally:
            fleet.close()
            for h in handles:
                h.close()

    def test_failed_canary_reload_keeps_fleet_on_old_weights(
            self, tmp_path):
        """/reload itself rejecting (arch mismatch) keeps the canary's
        old weights — the fleet stays consistent, nothing rolls."""
        net_a, _, a_dir, _, wrong_dir = self._checkpoints(tmp_path)
        x = np.random.RandomState(0).rand(2, 4).astype(np.float32)
        ref_a = np.asarray(net_a.output(x))
        handles, fleet = self._fleet(net_a, a_dir, n=2)
        try:
            res = fleet.rolling_reload(wrong_dir)
            assert res["reloaded"] is False
            assert res["canary"] is True
            assert res["error"]["stage"] == "reload"
            assert res["rolled_back"] == []  # old weights never left
            assert fleet.state_counts()[READY] == 2
            assert fleet.current_checkpoint == a_dir
            for h in handles:
                out = _post(f"{h.url}/predict", {"inputs": x.tolist()})
                np.testing.assert_allclose(np.asarray(out["outputs"]),
                                           ref_a, atol=1e-5)
        finally:
            fleet.close()
            for h in handles:
                h.close()

    def test_canary_probe_failure_rolls_back_automatically(
            self, tmp_path):
        """A canary that RELOADED but fails the validation probe rolls
        back to the previously-serving checkpoint automatically."""
        net_a, net_b, a_dir, b_dir, _ = self._checkpoints(tmp_path)
        x = np.random.RandomState(0).rand(2, 4).astype(np.float32)
        ref_a = np.asarray(net_a.output(x))
        handles, fleet = self._fleet(net_a, a_dir, n=2)
        try:
            # the probe's feature width is wrong -> every /predict
            # validation 400s, exactly like a bad canary would
            res = fleet.rolling_reload(
                b_dir, probe={"inputs": [[1.0, 2.0]]})
            assert res["reloaded"] is False
            assert res["canary"] is True
            assert res["error"]["stage"] == "probe"
            canary_id = res["failed_replica"]
            assert res["rolled_back"] == [canary_id]
            assert res["rollback_path"] == a_dir
            assert fleet.state_counts()[READY] == 2
            # the canary is back on the OLD weights — never mixed
            for h in handles:
                out = _post(f"{h.url}/predict", {"inputs": x.tolist()})
                np.testing.assert_allclose(np.asarray(out["outputs"]),
                                           ref_a, atol=1e-5)
            assert fleet.snapshot()["reloads"]["rolled_back"] == 1
        finally:
            fleet.close()
            for h in handles:
                h.close()


class TestAutoscaler:
    def test_policy_bounds_and_cooldown(self):
        a = Autoscaler(min_replicas=1, max_replicas=3, scale_up_at=4.0,
                       scale_down_at=0.5, cooldown_s=60.0)
        assert a.decide(0, 0) == 1          # below floor: always up
        assert a.decide(1, 10) == 1         # saturated: up
        a.note_action()
        assert a.decide(1, 10) == 0         # cooldown holds
        a._last_action = 0.0
        assert a.decide(3, 100) == 0        # at ceiling
        assert a.decide(2, 0) == -1         # idle: down
        assert a.decide(1, 0) == 0          # at floor
        with pytest.raises(ValueError):
            Autoscaler(min_replicas=3, max_replicas=1)

    def test_tick_spawns_and_retires_from_queue_depth(self):
        net = _net()

        class FakeSpawner:
            """Spawns in-process serve_network endpoints (proc=None)."""

            def __init__(self):
                self.handles = []

            def spawn(self, port=0):
                h = serve_network(net, n_replicas=1, max_delay_ms=1.0)
                self.handles.append(h)
                return None, h.url

        spawner = FakeSpawner()
        fleet = Fleet(start=False, heartbeat_timeout=10.0,
                      spawner=spawner,
                      autoscaler=Autoscaler(min_replicas=1,
                                            max_replicas=2,
                                            scale_up_at=2.0,
                                            scale_down_at=0.25,
                                            cooldown_s=0.0))
        try:
            assert fleet.autoscale_tick() == 1   # below floor -> spawn
            _poll_until_ready(fleet, 1)
            rep = fleet.ready_replicas()[0]
            with fleet._lock:
                rep.outstanding = 5              # synthetic saturation
            assert fleet.autoscale_tick() == 1   # queue depth -> spawn
            _poll_until_ready(fleet, 2)
            with fleet._lock:
                rep.outstanding = 0
            assert fleet.autoscale_tick() == -1  # idle -> retire
            assert len(fleet._replicas) == 1
            assert fleet.autoscale_tick() == 0   # at floor: steady
            snap = fleet.snapshot()
            assert snap["spawned"] == 2 and snap["retired"] == 1
            # the manual hook scales to an explicit target (autoscaler
            # off: polling would immediately retire the idle spare)
            fleet.autoscaler = None
            res = fleet.scale_to(2)
            assert len(res["spawned"]) == 1
            _poll_until_ready(fleet, 2)
            res = fleet.scale_to(1)
            assert len(res["retired"]) == 1
            assert len(fleet._replicas) == 1
        finally:
            fleet.close()
            for h in spawner.handles:
                h.close()


class TestCLIFleet:
    def test_fleet_attach_smoke(self, capsys):
        from deeplearning4j_tpu_torch.cli import main

        handle = serve_network(_net(), n_replicas=1, max_delay_ms=1.0,
                               warmup_shape=(4,))
        try:
            assert main(["fleet", "--attach", handle.url, "--replicas",
                         "0", "--smoke", "--heartbeat-interval", "0.1"]
                        ) == 0
            out = json.loads(
                capsys.readouterr().out.strip().splitlines()[-1])
            assert out["router"].startswith("http://127.0.0.1:")
            assert out["replicas"]["ready"] == 1
            assert out["endpoints"] == [handle.url]
        finally:
            handle.close()

    def test_fleet_without_model_or_attach_errors(self, capsys):
        from deeplearning4j_tpu_torch.cli import main

        assert main(["fleet", "--replicas", "0"]) == 2
        assert "fleet needs" in capsys.readouterr().err


class TestCLIFleetSpawn:
    """`cli fleet` spawning `cli serve` replicas: `--device` reaches each
    replica (the tests ask for the CPU), a replica asked for the card on
    a machine without one fails its spawn with its output tail, and
    `--compile-cache` reaches each replica through its environment."""

    def _conf(self, tmp_path):
        path = tmp_path / "conf.json"
        path.write_text(_net().conf.to_json())
        return str(path)

    def _run(self, argv, tmp_path, timeout=240):
        env = dict(os.environ,
                   PYTHONPATH=REPO_ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        return subprocess.run(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", *argv],
            capture_output=True, text=True, timeout=timeout, env=env,
            cwd=str(tmp_path))

    def test_spawns_cpu_replicas_and_stops_them(self, tmp_path):
        conf = self._conf(tmp_path)
        res = self._run(["fleet", "-m", conf, "--replicas", "1",
                         "--device", "cpu", "--smoke",
                         "--heartbeat-interval", "0.1",
                         "--serve-arg=--transformer",
                         '--serve-arg={"vocab_size": 17, "d_model": 16, '
                         '"n_heads": 2, "n_layers": 1, "d_ff": 32, '
                         '"max_len": 32}'], tmp_path)
        assert res.returncode == 0, res.stderr
        out = json.loads(res.stdout.strip().splitlines()[-1])
        assert out["replicas"]["ready"] == 1
        assert out["roles"] == {"unified": 1}
        assert len(out["endpoints"]) == 1
        # --smoke stopped the replica it spawned: nothing answers
        with pytest.raises(OSError):
            ReplicaClient(out["endpoints"][0]).healthz(timeout=2)

    def test_cuda_replica_without_a_card_fails_its_spawn(self, tmp_path):
        import torch

        if torch.cuda.is_available():
            pytest.skip("the refusal path needs a machine without a CUDA "
                        "device")
        conf = self._conf(tmp_path)
        spawner = ReplicaSpawner(conf, serve_args=["--device", "cuda"],
                                 env=dict(os.environ,
                                          PYTHONPATH=REPO_ROOT))
        assert spawner.command()[2] == "deeplearning4j_tpu_torch.cli"
        with pytest.raises(RuntimeError) as e:
            spawner.spawn()
        assert "exited with code 2" in str(e.value)
        assert "no CUDA device" in str(e.value)
        assert not procs.SPAWNED_PROCS or all(
            p.poll() is not None for p in procs.SPAWNED_PROCS)

    def test_device_leads_and_serve_arg_wins(self):
        from deeplearning4j_tpu_torch import cli as pcli

        args = pcli.build_parser().parse_args(
            ["fleet", "-m", "m.ckpt", "--device", "cpu",
             "--serve-arg=--device", "--serve-arg=cuda"])
        assert args.device == "cpu"
        serve = pcli.build_parser().parse_args(
            ["serve", "-m", "m.ckpt", "--fleet-kv", args.fleet_kv,
             "--device", args.device, *args.serve_arg])
        assert serve.device == "cuda"  # the later occurrence wins

    def test_compile_cache_is_refused_naming_its_item(self, tmp_path):
        """`fleet --compile-cache DIR` (refused until the program store
        came) activates the store before the spawner snapshots its
        environment: the spawned replica inherits it through
        DL4J_TPU_COMPILE_CACHE alone and leaves its warmup plan and its
        programs' signatures there."""
        conf = self._conf(tmp_path)
        cache = tmp_path / "cache"
        res = self._run(["fleet", "-m", conf, "--replicas", "1",
                         "--device", "cpu", "--smoke",
                         "--heartbeat-interval", "0.1",
                         "--compile-cache", str(cache)], tmp_path)
        assert res.returncode == 0, res.stderr
        out = json.loads(res.stdout.strip().splitlines()[-1])
        assert out["replicas"]["ready"] == 1
        plans = list((cache / "plans").glob("*.json"))
        assert len(plans) == 1
        plan = json.loads(plans[0].read_text())
        assert plan["engines"] and plan["engines"][0]["buckets"]
        assert list(cache.glob("v1/*/*.xc"))


# ------------------------------------------------- control-plane drills
class TestProcsAdoption:
    def test_fingerprint_matches_self_and_rejects_recycled(self):
        st = procs.proc_start_time(os.getpid())
        assert isinstance(st, int)
        assert procs.pid_matches(os.getpid(), st)
        assert not procs.pid_matches(os.getpid(), st + 12345)
        # a pid that cannot exist
        assert not procs.pid_matches(2 ** 22 + 1337, None)

    def test_adopted_proc_poll_kill_and_group_stop(self):
        child = subprocess.Popen(["sleep", "60"],
                                 start_new_session=True)
        try:
            ap = procs.AdoptedProc(child.pid)
            assert ap.poll() is None
            assert ap.start_time == procs.proc_start_time(child.pid)
            procs.register_spawned(ap)
            # group stop works through the adopted handle (pid==pgid)
            procs.stop_process_group(ap, term_first=False, timeout=10.0)
            assert ap.poll() is not None
            assert ap not in procs.SPAWNED_PROCS
        finally:
            if child.poll() is None:
                child.kill()
            child.wait()

    def test_dead_and_mismatched_pids_are_never_signalled(self):
        child = subprocess.Popen(["sleep", "60"],
                                 start_new_session=True)
        child.kill()
        child.wait()
        ap = procs.AdoptedProc(child.pid)
        assert ap.poll() == procs.AdoptedProc.UNKNOWN_RC
        ap.kill()  # no-op, no ProcessLookupError, no stranger killed
        procs.stop_process_group(ap)  # dead: wait() returns, no killpg
        # wrong fingerprint on a LIVE pid: treated as not-ours
        ap2 = procs.AdoptedProc(os.getpid(), start_time=1)
        assert ap2.poll() is not None
        ap2.kill()  # must not signal ourselves

    def test_release_scopes_the_atexit_sweep(self):
        child = subprocess.Popen(["sleep", "60"],
                                 start_new_session=True)
        try:
            procs.register_spawned(child)
            assert child in procs.SPAWNED_PROCS
            procs.release_spawned(child)  # handoff: out of the sweep
            assert child not in procs.SPAWNED_PROCS
            assert child.poll() is None  # ...and still running
        finally:
            child.kill()
            child.wait()


class TestFleetCrashSafety:
    def test_restarted_router_readmits_warm_with_zero_respawns(
            self, tmp_path):
        """Router-restart drill (in-process): fleet A journals one
        'spawned' replica (a real child process fingerprint paired with
        an in-process endpoint) and one attached URL, then hands off.
        Fleet B re-adopts both from the journal, readmits them through
        the ordinary /readyz probe — same pid, same warm endpoint, zero
        respawns — and serves."""
        net = _net()
        h1 = serve_network(net, n_replicas=1, warmup_shape=(4,))
        h2 = serve_network(net, n_replicas=1, warmup_shape=(4,))
        sleeper = subprocess.Popen(["sleep", "120"],
                                   start_new_session=True)
        procs.register_spawned(sleeper)
        state = str(tmp_path / "fstate")
        a = Fleet(start=False, heartbeat_interval=0.1,
                  heartbeat_timeout=5.0, state_dir=state)
        b = None
        try:
            a.attach(h1.url, proc=sleeper, spawned=True)
            a.attach(h2.url)
            _poll_until_ready(a, 2)
            a.close(handoff=True)
            assert sleeper not in procs.SPAWNED_PROCS, \
                "handoff must release the spawned replica"
            journal = a.journal.read()
            assert journal and len(journal["replicas"]) == 2

            t0 = time.monotonic()
            b = Fleet(start=False, heartbeat_interval=0.1,
                      heartbeat_timeout=5.0, state_dir=state)
            assert b.incarnation == 1
            kinds = sorted(e["kind"] for e in b.adoption_events)
            assert kinds == ["adopted", "attached"], b.adoption_events
            _poll_until_ready(b, 2)
            recovery_s = time.monotonic() - t0
            snap = b.snapshot()
            spawned = [r for r in snap["replicas"].values()
                       if r["spawned"]]
            assert spawned and spawned[0]["pid"] == sleeper.pid
            assert spawned[0]["adopted"] and spawned[0]["proc_alive"]
            assert int(b._m_spawned.value) == 0, "a replica respawned"
            assert recovery_s < 5.0, f"readmission took {recovery_s}s"
            # ...and the readmitted world actually routes
            rep = b.select()
            b.release(rep)
        finally:
            for f in (a, b):
                if f is not None:
                    f.close()
            if sleeper.poll() is None:
                sleeper.kill()
                sleeper.wait()
            procs.unregister_spawned(sleeper)
            h1.close()
            h2.close()

    def test_dead_and_recycled_pids_are_skipped_not_killed(
            self, tmp_path):
        """A journal entry whose pid died (or got recycled by a stranger
        — wrong start time) is SKIPPED: no adoption, no signal sent, and
        the spawner/autoscaler owns the replacement."""
        state = str(tmp_path / "fstate")
        dead = subprocess.Popen(["sleep", "60"],
                                start_new_session=True)
        dead.kill()
        dead.wait()
        StateFile(os.path.join(state, "fleet.journal")).write({
            "plane": "fleet", "incarnation": 3,
            "current_checkpoint": "/ck/step7",
            "replicas": {
                "r0": {"url": "http://127.0.0.1:9", "spawned": True,
                       "pid": dead.pid, "start_time": 12345},
                "r1": {"url": "http://127.0.0.1:9", "spawned": True,
                       "pid": os.getpid(), "start_time": 1},
            }})
        b = Fleet(start=False, state_dir=state)
        try:
            assert b.incarnation == 4
            assert b.state_counts()["starting"] == 0  # nothing adopted
            kinds = {e["replica"]: e["kind"]
                     for e in b.adoption_events}
            assert kinds["r0"] == "dead"
            assert kinds["r1"] == "recycled"
            # journaled serving checkpoint survives the restart (the
            # rollback target of the next rolling reload)
            assert b.current_checkpoint == "/ck/step7"
            # fresh ids never collide with journaled ones
            rep = b.attach("http://127.0.0.1:9")
            assert rep.id == "r2"
        finally:
            b.close()

    def test_journal_written_by_either_package_is_adopted_by_the_other(
            self, tmp_path):
        """The journal is one format: a JAX fleet's handoff is adopted by
        a port fleet and the other way round (same incarnation count,
        same adoption events, same journaled checkpoint)."""
        from deeplearning4j_tpu.serving.fleet import Fleet as JFleet

        net = _net()
        h = serve_network(net, n_replicas=1, warmup_shape=(4,))
        try:
            for first, second in ((JFleet, Fleet), (Fleet, JFleet)):
                state = str(tmp_path / f"{first.__module__}")
                a = first(start=False, heartbeat_timeout=5.0,
                          state_dir=state, initial_checkpoint="/ck/a")
                a.attach(h.url)
                _poll_until_ready(a, 1)
                a.close(handoff=True)
                b = second(start=False, heartbeat_timeout=5.0,
                           state_dir=state)
                try:
                    assert b.incarnation == 1
                    assert [e["kind"] for e in b.adoption_events] == \
                        ["attached"]
                    assert b.current_checkpoint == "/ck/a"
                    _poll_until_ready(b, 1)
                finally:
                    b.close()
        finally:
            h.close()


# ------------------------------------------------ parity with the JAX package
class _Clock:
    """A fake `time` module: `monotonic()` and `time()` read `now`."""

    def __init__(self, now=1000.0):
        self.now = float(now)

    def monotonic(self):
        return self.now

    def time(self):
        return self.now

    def module(self):
        return SimpleNamespace(monotonic=self.monotonic, time=self.time,
                               perf_counter=self.monotonic,
                               sleep=time.sleep)


@pytest.fixture
def jax_fleet_mod():
    from deeplearning4j_tpu.serving import fleet as jfleet

    return jfleet


def _breaker_trace(mod, monkeypatch, events):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock.module())
    br = mod.CircuitBreaker(threshold=3, reset_s=2.0)
    out = []
    for kind, arg in events:
        if kind == "wait":
            clock.now += arg
            res = None
        elif kind == "timeout":
            res = br.record_timeout()
        elif kind == "success":
            res = br.record_success()
        elif kind == "probe":
            res = br.allow_probe()
        else:
            res = br.reopen()
        out.append((kind, res, br.snapshot()))
    return out


class TestParityWithJax:
    EVENTS = ([("timeout", None)] * 2 + [("wait", 1.0), ("timeout", None),
              ("probe", None), ("wait", 2.5), ("probe", None),
              ("timeout", None), ("wait", 2.0), ("probe", None),
              ("reopen", None), ("probe", None), ("wait", 2.0),
              ("probe", None), ("success", None), ("timeout", None),
              ("wait", 31.0), ("timeout", None), ("timeout", None),
              ("wait", 0.5), ("timeout", None), ("timeout", None)])

    def test_circuit_breaker_state_sequence(self, monkeypatch,
                                            jax_fleet_mod):
        from deeplearning4j_tpu_torch.serving import fleet as pfleet

        got = _breaker_trace(pfleet, monkeypatch, self.EVENTS)
        ref = _breaker_trace(jax_fleet_mod, monkeypatch, self.EVENTS)
        assert got == ref
        states = [snap["state"] for _, _, snap in got]
        assert {"closed", "open", "half_open"} <= set(states)

    def test_autoscaler_decisions_over_a_grid(self, monkeypatch,
                                              jax_fleet_mod):
        from deeplearning4j_tpu_torch.serving import fleet as pfleet

        def decisions(mod):
            clock = _Clock()
            monkeypatch.setattr(mod, "time", clock.module())
            out = []
            for lo, hi in ((1, 1), (1, 3), (2, 4)):
                for up, down in ((4.0, 0.5), (2.0, 0.25)):
                    a = mod.Autoscaler(min_replicas=lo, max_replicas=hi,
                                       scale_up_at=up, scale_down_at=down,
                                       cooldown_s=10.0,
                                       batch_backlog_up_at=3)
                    for n in range(0, 6):
                        for outstanding in (0, 1, 2, 5, 9, 20):
                            for backlog in (0, 2, 3, 7):
                                for since in (None, 5.0, 11.0):
                                    if since is not None:
                                        a.note_action()
                                        clock.now += since
                                    out.append(a.decide(
                                        n, outstanding, backlog))
                                    a._last_action = 0.0
            with pytest.raises(ValueError):
                mod.Autoscaler(min_replicas=3, max_replicas=1)
            with pytest.raises(ValueError):
                mod.Autoscaler(batch_backlog_up_at=0)
            return out

        got, ref = decisions(pfleet), decisions(jax_fleet_mod)
        assert got == ref
        assert {-1, 0, 1} <= set(got)

    def test_state_tracker_stale_workers_under_a_fake_clock(
            self, monkeypatch):
        from deeplearning4j_tpu.scaleout import statetracker as jst
        from deeplearning4j_tpu_torch.scaleout import statetracker as pst

        def trace(mod):
            clock = _Clock(now=50.0)
            monkeypatch.setattr(mod, "time", clock.module())
            tr = mod.InMemoryStateTracker(heartbeat_timeout=3.0)
            out = []
            script = [("add", "w0"), ("add", "w1"), ("tick", 1.0),
                      ("beat", "w2"), ("tick", 2.5), ("beat", "w0"),
                      ("stale", None), ("tick", 1.0), ("stale", None),
                      ("remove", "w1"), ("stale", None), ("tick", 5.0),
                      ("beat", "w1"), ("stale", None), ("stale_at", 100.0)]
            for op, arg in script:
                if op == "add":
                    tr.add_worker(arg)
                elif op == "beat":
                    tr.heartbeat(arg)
                elif op == "remove":
                    tr.remove_worker(arg)
                elif op == "tick":
                    clock.now += arg
                elif op == "stale":
                    out.append(sorted(tr.stale_workers()))
                else:
                    out.append(sorted(tr.stale_workers(now=arg)))
                out.append((sorted(tr.workers()), sorted(
                    tr.heartbeats().items())))
            return out

        got, ref = trace(pst), trace(jst)
        assert got == ref
        assert any(isinstance(o, list) and o for o in got)

    def test_work_codec_crosses_between_the_packages(self, tmp_path):
        """`LocalWorkRetriever.save` / `load` (over the ported
        `scaleout.rpc` codec) read what the other package wrote."""
        from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
        from deeplearning4j_tpu.scaleout import api as japi
        from deeplearning4j_tpu_torch.datasets.api import DataSet
        from deeplearning4j_tpu_torch.scaleout import api as papi

        rng = np.random.default_rng(0)
        feats = rng.standard_normal((5, 4)).astype(np.float32)
        labels = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 5)]
        for writer, reader, ds_cls in ((papi, japi, DataSet),
                                       (japi, papi, JDataSet)):
            d = str(tmp_path / writer.__name__)
            job = writer.Job(work=ds_cls(feats, labels), worker_id="w/1",
                             result={"loss": np.float32(0.5)},
                             retries=2, seq=7)
            writer.LocalWorkRetriever(d).save("w/1", job)
            back = reader.LocalWorkRetriever(d).load("w/1")
            assert isinstance(back, reader.Job)
            assert (back.worker_id, back.retries, back.seq) == ("w/1", 2, 7)
            np.testing.assert_array_equal(back.work.features, feats)
            np.testing.assert_array_equal(back.work.labels, labels)
            assert float(back.result["loss"]) == 0.5
            assert reader.LocalWorkRetriever(d).workers() == ["w_1"]
            assert reader.LocalWorkRetriever(d).load("nobody") is None
