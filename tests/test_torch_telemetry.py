"""The PyTorch port's telemetry plane (telemetry/: registry, exposition,
trace, device gauges), its chaos layer (testing/chaos.py) and its
journal file (utils/statefile.py) held against the JAX package's copies
on the CPU.

- The registry and the exposition: the same script of counter, gauge and
  histogram operations on both packages' registries renders the same
  Prometheus text and the same JSON snapshot, byte for byte.
- Tracing: the same nested spans give the same Chrome-trace structure
  (names, depths, nesting, args); a span converted to the profiler's
  clock lies over the operation the profiler recorded inside it; off,
  `span()` hands out one shared no-op and records nothing.
- Device gauges: a host with no card registers `dl4j_device_count 0` and
  no memory gauges; `watch_jit_cache` aggregates live probes and reads -1
  when any probe reports its counter unavailable.
- Chaos: the same seeded plan decides the same schedule, logs the same
  firings and replays the same way in both packages; `env_spec` is the
  same payload under the same environment variable.
- StateFile: a journal written by either package reads in the other; a
  torn file reads as None with `torn` set.

No wall-clock bound is asserted here (timing tests belong on the card).
"""

from __future__ import annotations

import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import telemetry as jtele
from deeplearning4j_tpu.telemetry import device as jdevice
from deeplearning4j_tpu.telemetry import exposition as jexpo
from deeplearning4j_tpu.testing import chaos as jchaos
from deeplearning4j_tpu.utils.statefile import StateFile as JStateFile
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.telemetry import device, exposition, trace
from deeplearning4j_tpu_torch.testing import chaos
from deeplearning4j_tpu_torch.utils.statefile import StateFile

PKGS = {"jax": (jtele, jexpo), "port": (telemetry, exposition)}


@pytest.fixture(autouse=True)
def _clean():
    yield
    chaos.deactivate()
    jchaos.deactivate()
    trace.stop_tracing()


def _script(tele):
    """The same operations on a fresh registry of either package."""
    reg = tele.MetricsRegistry()
    c = reg.counter("dl4j_test_requests", "requests served")
    c.labels(engine="e0").inc()
    c.labels(engine="e1").inc(2.5)
    g = reg.gauge("dl4j_test_depth", "queue depth\nwith a newline")
    g.labels(q='a"b').set(3)
    g.labels(q="c\\d").set_function(lambda: 7.0)
    reg.gauge("dl4j_test_nan", "a diverged value").set(float("nan"))
    reg.gauge("dl4j_test_inf", "unbounded").set(float("inf"))
    h = reg.histogram("dl4j_test_seconds", "latency",
                      buckets=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.002, 0.05, 0.5, 0.007):
        h.labels(loop="d0").observe(v)
    reg.histogram("dl4j_test_default", "default buckets").observe(0.3)
    fam = reg.counter("dl4j_test_cardinality", "removed children")
    fam.labels(k="keep").inc()
    fam.labels(k="drop").inc()
    fam.remove(k="drop")
    return reg


class TestRegistryAndExposition:
    def test_the_same_script_renders_the_same_text_and_snapshot(self):
        regs = {pkg: _script(mods[0]) for pkg, mods in PKGS.items()}
        texts = {pkg: PKGS[pkg][1].render_prometheus(reg)
                 for pkg, reg in regs.items()}
        assert texts["port"] == texts["jax"]
        assert "dl4j_test_requests_total" in texts["port"]
        assert 'le="+Inf"' in texts["port"] and "NaN" in texts["port"]
        snaps = {pkg: json.dumps(PKGS[pkg][1].snapshot(reg), sort_keys=True)
                 for pkg, reg in regs.items()}
        assert snaps["port"] == snaps["jax"]
        h = regs["port"].histogram("dl4j_test_seconds").labels(loop="d0")
        jh = regs["jax"].histogram("dl4j_test_seconds").labels(loop="d0")
        for q in (0.0, 0.5, 0.99, 1.0):
            assert h.percentile(q) == jh.percentile(q)

    @pytest.mark.parametrize("pkg", ["port", "jax"])
    def test_registry_contracts(self, pkg):
        tele = PKGS[pkg][0]
        reg = tele.MetricsRegistry()
        c = reg.counter("c")
        with pytest.raises(ValueError, match="monotonic"):
            c.inc(-1)
        fam = reg.counter("l")
        fam.labels(bucket="8")
        with pytest.raises(ValueError, match="label names"):
            fam.labels(engine="e0")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("c")
        assert reg.counter("c") is reg.counter("c", "other help")
        g = reg.gauge("g")
        g.set(7.0)
        g._default().set_function(lambda: 1 / 0)
        assert g.value == 7.0
        h = reg.histogram("h")
        tele.set_enabled(False)
        try:
            c.inc()
            h.observe(1.0)
        finally:
            tele.set_enabled(True)
        assert c.value == 0 and h.count == 0

    def test_metrics_routes_and_standalone_server(self):
        reg = _script(telemetry)
        code, ctype, body = exposition.handle_metrics_get("/metrics", reg)
        assert code == 200 and ctype == exposition.CONTENT_TYPE
        assert body.decode().startswith("# HELP")
        code, ctype, body = exposition.handle_metrics_get("/snapshot", reg)
        assert json.loads(body)["dl4j_test_requests"]["kind"] == "counter"
        assert exposition.handle_metrics_get("/other", reg) is None
        with exposition.start_metrics_server(registry=reg) as server:
            with urllib.request.urlopen(server.url + "/metrics",
                                        timeout=30) as r:
                text = r.read().decode()
        assert 'dl4j_test_requests_total{engine="e1"} 2.5' in text
        assert "dl4j_device_count 0" in text


class TestTrace:
    def _spans(self, mod):
        mod.start_tracing(max_spans=100)
        with mod.span("train_step", step=1):
            with mod.span("forward"):
                pass
            with mod.span("backward", layers=2):
                pass
        with mod.span("eval"):
            pass
        events = mod.chrome_trace()["traceEvents"]
        mod.stop_tracing()
        return [(e["name"], e["ph"], e.get("args")) for e in events]

    def test_spans_nest_and_export_like_jax(self, tmp_path):
        from deeplearning4j_tpu.telemetry import trace as jtrace

        ours, ref = self._spans(trace), self._spans(jtrace)
        assert ours == ref and len(ours) == 4
        tracer = trace.start_tracing(max_spans=3)
        for i in range(5):
            with trace.span("s", i=i):
                pass
        assert len(tracer.spans()) == 3
        path = trace.save_chrome_trace(str(tmp_path / "t.json"))
        with open(path) as f:
            assert len(json.load(f)["traceEvents"]) == 3
        trace.stop_tracing()
        assert trace.save_chrome_trace(str(tmp_path / "u.json")) is None
        with trace.span("off"):
            pass  # a no-op while tracing is off

    def test_span_lies_over_the_profiled_op_on_the_profilers_clock(self):
        tracer = trace.start_tracing()
        try:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU]) as prof:
                with trace.span("op"):
                    torch.ones(4).sum().item()
        finally:
            trace.stop_tracing()
        start_ns = prof.profiler.kineto_results.trace_start_ns()
        (rec,) = tracer.spans()
        a = (tracer.to_profiler_ns(rec.start_ns) - start_ns) / 1e3
        b = a + rec.dur_ns / 1e3
        (op,) = [e.time_range for e in prof.events()
                 if e.name == "aten::sum"]
        # inside the span, which starts within 5 ms of the op
        assert a <= op.start and op.end <= b
        assert op.start - a < 5e3
        # the Chrome export's ts is the same instant, in microseconds
        tracer.record(rec)
        ts = tracer.chrome_trace()["traceEvents"][0]["ts"]
        assert abs(ts - (a + start_ns / 1e3)) < 1.0

    def test_off_hands_out_one_noop_and_records_nothing(self):
        import contextlib

        assert not trace.tracing()
        a, b = trace.span("a"), trace.span("b", rows=3)
        assert a is b
        assert not isinstance(a, contextlib._GeneratorContextManager)
        with a as bound:
            assert bound is None
        trace.add_span("a", 1, 2)  # a no-op too
        tracer = trace.start_tracing()
        trace.stop_tracing()
        with trace.span("after"):
            pass
        assert tracer.spans() == []

    def test_add_span_nests_at_the_callers_depth(self):
        import threading

        tracer = trace.start_tracing()
        try:
            with trace.span("outer") as sp:
                sp.args["rows"] = 2
                t0 = time.perf_counter_ns()
                t1 = time.perf_counter_ns()
                trace.add_span("timed", t0, t1, k=1)
        finally:
            trace.stop_tracing()
        timed, outer = tracer.spans()
        assert (timed.name, timed.depth, timed.args) == ("timed", 1,
                                                         {"k": 1})
        assert (timed.start_ns, timed.dur_ns) == (t0, t1 - t0)
        assert (outer.name, outer.depth, outer.args) == ("outer", 0,
                                                         {"rows": 2})
        assert timed.thread_id == outer.thread_id == threading.get_ident()
        assert outer.start_ns <= t0 and t1 <= outer.start_ns + outer.dur_ns
        # the anchor pair: perf_counter against the profiler's clock
        now = tracer.to_profiler_ns(time.perf_counter_ns())
        assert abs(now - trace.profiler_clock_ns()) < 50_000_000


class TestDeviceGauges:
    def test_a_host_without_a_card_registers_no_memory_gauges(self):
        reg = telemetry.MetricsRegistry()
        device.install(reg)
        device.install(reg)  # idempotent
        text = exposition.render_prometheus(reg)
        assert "dl4j_device_count 0" in text
        assert "dl4j_device_memory_bytes" not in text
        assert device._MEM_STATS == jdevice._MEM_STATS

    @pytest.mark.parametrize("mod", [device, jdevice], ids=["port", "jax"])
    def test_watch_jit_cache_aggregates_and_propagates_unavailable(self,
                                                                   mod):
        class Owner:
            def __init__(self, n):
                self.n = n

            def size(self):
                return self.n

        label = f"unit-{mod.__name__}-{time.perf_counter_ns()}"
        a, b = Owner(2), Owner(3)
        mod.watch_jit_cache(label, a.size)
        mod.watch_jit_cache(label, b.size)
        assert mod.jit_cache_total(label) == 5
        b.n = -1
        assert mod.jit_cache_total(label) == -1
        del b
        assert mod.jit_cache_total(label) == 2


class TestChaos:
    @pytest.mark.parametrize("rules", [
        [("p.a", "error", {"prob": 0.3}), ("p.b", "delay",
                                           {"prob": 0.5, "delay_s": 0.0})],
        [("p", "error", {"at": [1, 3]})],
        [("p", "error", {"times": 2}), ("q", "reset", {"after": 2})],
    ])
    def test_the_same_plan_decides_the_same_schedule(self, rules):
        runs = {}
        for name, mod in (("jax", jchaos), ("port", chaos)):
            plan = mod.ChaosPlan([mod.Rule(p, k, **kw)
                                  for p, k, kw in rules], seed=42)
            points = sorted({p for p, _, _ in rules})
            fired = [(points[i % len(points)], i) for i in range(60)
                     if plan.decide(points[i % len(points)]) is not None]
            log = [{k: v for k, v in e.items() if k != "t_s"}
                   for e in plan.log()]
            replay = mod.ChaosPlan(plan.replay_rules(), seed=999)
            replayed = [(points[i % len(points)], i) for i in range(60)
                        if replay.decide(points[i % len(points)])
                        is not None]
            assert replayed == fired
            runs[name] = (fired, log, plan.spec())
        assert runs["port"] == runs["jax"]
        assert runs["port"][0]

    def test_env_spec_points_and_kinds_match_jax(self):
        rules = [chaos.Rule("fleet.kv_ship", "error", at=[0],
                            message="boom"),
                 chaos.Rule("decode.step", "delay", prob=0.5,
                            delay_s=0.01)]
        jrules = [jchaos.Rule("fleet.kv_ship", "error", at=[0],
                              message="boom"),
                  jchaos.Rule("decode.step", "delay", prob=0.5,
                              delay_s=0.01)]
        assert chaos.env_spec(rules, seed=5) == jchaos.env_spec(jrules,
                                                                seed=5)
        assert chaos.ENV_VAR == jchaos.ENV_VAR == "DL4J_TPU_CHAOS"
        assert chaos.POINTS == jchaos.POINTS and chaos.KINDS == jchaos.KINDS
        for point in ("decode.step", "decode.fork", "server.generate",
                      "generate.midstream"):
            assert point in chaos.POINTS
        with pytest.raises(ValueError, match="kind"):
            chaos.Rule("p", "frobnicate")

    def test_kinds_and_the_injection_counter(self):
        chaos.configure([chaos.Rule("a", "error", message="injected-a"),
                         chaos.Rule("b", "reset"),
                         chaos.Rule("n", "nan", times=1),
                         chaos.Rule("t.count", "error", times=3)])
        with pytest.raises(chaos.ChaosError, match="injected-a"):
            chaos.hit("a")
        with pytest.raises(chaos.ChaosReset):
            chaos.hit("b")
        x = np.ones((4, 4), np.float32)
        assert np.isnan(chaos.maybe_nan("n", x)).any()
        assert not np.isnan(x).any()
        c = telemetry.get_registry().counter(
            "dl4j_chaos_injected", "faults injected by the chaos layer"
        ).labels(point="t.count", kind="error")
        before = c.value
        for _ in range(5):
            try:
                chaos.hit("t.count")
            except chaos.ChaosError:
                pass
        assert c.value == before + 3
        chaos.deactivate()
        assert chaos.hit("anything") is None


class TestStateFile:
    @pytest.mark.parametrize("writer,reader", [(StateFile, JStateFile),
                                               (JStateFile, StateFile)],
                             ids=["port->jax", "jax->port"])
    def test_journals_cross_both_ways(self, tmp_path, writer, reader):
        path = str(tmp_path / "j.journal")
        state = {"cursor": 3, "input_sha": "ab" * 8, "rows": [1, 2]}
        writer(path, point="batch.journal").write(state)
        assert reader(path).read() == state
        assert not os.path.exists(path + ".tmp")

    def test_torn_reads_none_and_chaos_faults_leave_the_last_commit(
            self, tmp_path):
        path = str(tmp_path / "j.journal")
        sf = StateFile(path, point="batch.journal")
        sf.write({"cursor": 1})
        chaos.configure([chaos.Rule("batch.journal", "error", at=[1])])
        with pytest.raises(chaos.ChaosError):
            sf.write({"cursor": 2})  # fails before the rename
        chaos.deactivate()
        assert StateFile(path).read() == {"cursor": 1}
        with open(path, "w") as f:
            f.write("{torn")
        torn = StateFile(path)
        assert torn.read() is None and torn.torn
        assert JStateFile(path).read() is None
