"""The port's warm start (`deeplearning4j_tpu_torch.compilecache`) on the
CPU: the JAX package's `tests/test_compilecache.py` case for case, held
to what each case states, on the port's CPU lane —

1. **Store durability**: crash-atomic entry commit — a torn or
   CRC-failing entry is skipped and quarantined, never loaded; chaos
   faults at `compile.cache_write`/`compile.cache_read` at any ordinal
   degrade to an uncached call with correct outputs, never an error.
2. **Stale-runtime defense**: entries under a different runtime
   fingerprint are swept on open; the LRU byte budget evicts
   oldest-read entries.
3. **Dispatch equivalence**: `AotDispatch` is a drop-in for the
   callable it wraps — identical outputs cold, warm, faulted, and with
   static arguments — and `jit_cache_size` keeps counting through it
   (the JAX package's `test_miss_then_hit_identical_outputs` fails in
   the reference; the port's passes).
4. **Warmup-plan round trip**: the program set one engine / decode loop
   used, recorded as a plan, replays on a fresh instance to the
   IDENTICAL store key set — across kernel lane x speculation x prefix
   cache — after which traffic builds nothing new and gives identical
   tokens.
5. **Spin-up integration**: `serve_network(compile_cache=...)` boots
   warm from the recorded plan (`recompiled_after_warmup == 0`), /stats
   and /metrics surface `dl4j_compile_*`; spawners export
   `DL4J_TPU_COMPILE_CACHE` to children.

Then what is the port's own: the kernel library through the store
(`_build.build()` with the compiler replaced by a stub that records its
calls: a stored library loads with 0 compiler calls, a quarantined one
is built), and a port plan that the JAX package's `load_plan` reads as
the same structure, apart from the fingerprint. Every construction
passes `device="cpu"`.
"""

from __future__ import annotations

import json
import os
import sys
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import _build
from deeplearning4j_tpu_torch import compilecache as cc
from deeplearning4j_tpu_torch.compilecache import warmup as ccwarmup
from deeplearning4j_tpu_torch.compilecache.aot import TensorSpec
from deeplearning4j_tpu_torch.compilecache.store import (ProgramStore,
                                                         key_digest)
from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, init_transformer_params)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving.decode_loop import DecodeLoop
from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
from deeplearning4j_tpu_torch.serving.server import serve_network
from deeplearning4j_tpu_torch.testing import chaos
from deeplearning4j_tpu_torch.testing.chaos import Rule
from deeplearning4j_tpu_torch.utils.jitcache import jit_cache_size

CPU = "cpu"
CFG = TransformerConfig(vocab_size=17, d_model=16, n_heads=2, n_layers=1,
                        d_ff=32, max_len=64)


def _params(seed=0, cfg=CFG):
    return init_transformer_params(seed, cfg, device=CPU)


def _net(n_in=4, n_out=3):
    conf = (NeuralNetConfiguration.builder()
            .lr(0.1).n_in(n_in).activation_function("tanh")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(1).use_adagrad(False)
            .list(2).hidden_layer_sizes([8])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=n_out)
            .pretrain(False).build())
    return MultiLayerNetwork(conf, device=CPU)


@pytest.fixture(autouse=True)
def _clean_cache_state():
    """Every test runs with NO process-global compiler and no env
    export leaking in or out (activation is explicit per test)."""
    cc.deactivate()
    chaos.deactivate()
    yield
    chaos.deactivate()
    cc.deactivate()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read().decode())


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read().decode())


# ---------------------------------------------------------------- store
class TestProgramStore:
    def test_put_get_roundtrip(self, tmp_path):
        st = ProgramStore(str(tmp_path))
        assert st.get("k") is None
        assert st.put("k", b"payload-bytes")
        assert st.get("k") == b"payload-bytes"
        assert "k" in st
        assert st.keys() == {key_digest("k")}
        # overwrite commits atomically over the old entry
        assert st.put("k", b"v2")
        assert st.get("k") == b"v2"
        assert st.stats()["entries"] == 1

    def test_torn_entry_skipped_and_quarantined(self, tmp_path):
        st = ProgramStore(str(tmp_path))
        st.put("k", b"x" * 256)
        path = os.path.join(st.dir, key_digest("k") + ".xc")
        blob = open(path, "rb").read()
        before = st.evictions().get("torn", 0)
        open(path, "wb").write(blob[:len(blob) // 2])
        assert st.get("k") is None
        assert not os.path.exists(path)  # deleted on sight
        assert st.evictions().get("torn", 0) == before + 1

    def test_crc_mismatch_skipped(self, tmp_path):
        st = ProgramStore(str(tmp_path))
        st.put("k", b"y" * 128)
        path = os.path.join(st.dir, key_digest("k") + ".xc")
        blob = bytearray(open(path, "rb").read())
        blob[-1] ^= 0xFF  # flip one payload byte; header CRC now lies
        open(path, "wb").write(bytes(blob))
        assert st.get("k") is None
        assert not os.path.exists(path)

    def test_lru_gc_size_budget(self, tmp_path):
        st = ProgramStore(str(tmp_path), size_budget_bytes=600)
        for i in range(5):
            st.put(f"k{i}", bytes([i]) * 180)  # ~200B/entry with header
            os.utime(os.path.join(st.dir, key_digest(f"k{i}") + ".xc"),
                     (i, i))  # deterministic LRU order
        st.gc()
        assert st.stats()["bytes"] <= 600
        assert st.evictions().get("lru", 0) >= 2
        assert st.get("k4") is not None
        assert st.get("k0") is None

    def test_fingerprint_quarantine(self, tmp_path):
        old = ProgramStore(str(tmp_path), fingerprint="deadbeef00000000")
        old.put("k", b"stale-runtime-program")
        new = ProgramStore(str(tmp_path), fingerprint="cafebabe00000000")
        assert new.get("k") is None
        assert not os.path.isdir(old.dir)
        assert new.evictions().get("fingerprint", 0) >= 1

    def test_chaos_write_fault_degrades(self, tmp_path):
        st = ProgramStore(str(tmp_path))
        for op_ordinal in (0, 1):  # fault the tmp write, then the rename
            chaos.configure([Rule("compile.cache_write", "error",
                                  at=[op_ordinal])])
            try:
                assert st.put("k", b"data") is False
            finally:
                chaos.deactivate()
            assert st.get("k") is None      # nothing torn committed
            assert st.keys() == set()
        assert st.put("k", b"data")
        assert st.get("k") == b"data"

    def test_chaos_read_fault_degrades(self, tmp_path):
        st = ProgramStore(str(tmp_path))
        st.put("k", b"data")
        chaos.configure([Rule("compile.cache_read", "error", times=1)])
        try:
            assert st.get("k") is None  # degraded, not raised
        finally:
            chaos.deactivate()
        assert st.get("k") == b"data"   # entry intact afterwards


# ------------------------------------------------------------- dispatch
class TestAotDispatch:
    def test_miss_then_hit_identical_outputs(self, tmp_path):
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        cc.activate(str(tmp_path))

        def build():
            return cc.maybe_wrap(lambda a: a * 2.0 + 1.0, "test.f")

        f1 = build()
        ref = np.asarray(f1(x))
        s = cc.stats()
        assert s["misses"] >= 1 and s["entries"] == 1
        hits0 = s["hits"]
        f2 = build()  # fresh dispatcher, same store: known, a hit
        out = np.asarray(f2(x))
        assert (out == ref).all()
        assert cc.stats()["hits"] == hits0 + 1
        assert f2.aot_programs() == 1
        assert jit_cache_size(f2) == 1

    def test_static_argnums_roundtrip(self, tmp_path):
        x = np.ones((2, 3), np.float32)
        cc.activate(str(tmp_path))
        f = cc.maybe_wrap(lambda a, k: a * k, "test.static",
                          static_argnums=(1,))
        assert np.allclose(f(x, 2), x * 2)
        assert np.allclose(f(x, 5), x * 5)   # distinct static => program
        assert f.aot_programs() == 2
        g = cc.maybe_wrap(lambda a, k: a * k, "test.static",
                          static_argnums=(1,))
        hits = cc.stats()["hits"]
        assert np.allclose(g(x, 5), x * 5)
        assert np.allclose(g(x, 2), x * 2)
        assert cc.stats()["hits"] == hits + 2

    def test_warm_via_shape_structs(self, tmp_path):
        cc.activate(str(tmp_path))
        calls = []
        f = cc.maybe_wrap(lambda a: calls.append(1) or a - 1.0,
                          "test.warm")
        assert f.warm(TensorSpec((4, 2), np.float32))  # recorded, not run
        assert f.aot_programs() == 1 and calls == []
        misses = cc.stats()["misses"]
        x = np.zeros((4, 2), np.float32)
        assert (np.asarray(f(x)) == -1.0).all()
        assert cc.stats()["misses"] == misses  # call hit the warm program
        # a tensor signature carries its device
        t = cc.maybe_wrap(lambda a: a + 1, "test.warm.t")
        assert t.warm(TensorSpec((3,), torch.float32, torch.device(CPU)))
        misses = cc.stats()["misses"]
        t(torch.zeros(3))
        assert cc.stats()["misses"] == misses and t.aot_programs() == 1

    def test_chaos_faults_never_change_results(self, tmp_path):
        """Fault the store at EVERY ordinal of a cold+warm cycle: the
        wrapped function must always return the right answer."""
        x = np.full((2, 2), 3.0, np.float32)
        for rules in ([Rule("compile.cache_write", "error")],
                      [Rule("compile.cache_read", "error")],
                      [Rule("compile.cache_write", "error"),
                       Rule("compile.cache_read", "error")]):
            root = str(tmp_path / f"r{len(rules)}{rules[0].point[-5:]}")
            cc.activate(root)
            chaos.configure(rules)
            try:
                f = cc.maybe_wrap(lambda a: a * a, "test.chaos")
                assert (np.asarray(f(x)) == 9.0).all()
                f2 = cc.maybe_wrap(lambda a: a * a, "test.chaos")
                assert (np.asarray(f2(x)) == 9.0).all()
            finally:
                chaos.deactivate()
                cc.deactivate()

    def test_inactive_cache_is_identity(self):
        def jf(a):
            return a

        assert cc.maybe_wrap(jf, "k") is jf       # no compiler active
        assert os.environ.get(cc.CACHE_ENV) is None
        assert cc.maybe_wrap(jf, None) is jf      # no key => identity


# ----------------------------------------------------------- plan files
class TestWarmupPlans:
    def test_save_load_roundtrip(self, tmp_path):
        p = str(tmp_path / "plan.json")
        assert ccwarmup.save_plan(p, {"engines": [{"cache_key": "e"}],
                                      "decode": None})
        doc = ccwarmup.load_plan(p)
        assert doc["engines"] == [{"cache_key": "e"}]
        assert doc["version"] == ccwarmup.PLAN_VERSION

    def test_wrong_fingerprint_ignored(self, tmp_path):
        p = str(tmp_path / "plan.json")
        ccwarmup.save_plan(p, {"engines": [], "fingerprint": "not-this"})
        assert ccwarmup.load_plan(p) is None

    def test_torn_and_wrong_version_ignored(self, tmp_path):
        p = str(tmp_path / "plan.json")
        open(p, "w").write('{"version": 1, "eng')  # torn JSON
        assert ccwarmup.load_plan(p) is None
        ccwarmup.save_plan(p, {"engines": [], "version": 99})
        assert ccwarmup.load_plan(p) is None
        assert ccwarmup.load_plan(str(tmp_path / "missing.json")) is None

    def test_replay_plan_matches_by_cache_key(self):
        calls = []

        class Obj:
            def __init__(self, key):
                self.cache_key = key

            def warmup_from_plan(self, frag):
                calls.append(("eng", frag["cache_key"]))

            def warm_programs(self, frag):
                calls.append(("loop", frag["cache_key"]))
                return 1

        plan = {"engines": [{"cache_key": "A"}, {"cache_key": "B"}],
                "decode": {"cache_key": "D"}}
        rep = ccwarmup.replay_plan(plan,
                                   engines=[Obj("A"), Obj("C")],
                                   loops=[Obj("D")])
        assert rep == {"engines": 1, "loops": 1, "errors": 0}
        assert calls == [("eng", "A"), ("loop", "D")]


# ----------------------------------------------------- engine round trip
class TestEngineWarmBoot:
    def test_record_replay_no_recompiles(self, tmp_path):
        x = np.random.RandomState(0).rand(5, 4).astype(np.float32)
        net = _net()
        cc.activate(str(tmp_path))
        eng = InferenceEngine.for_network(net)
        eng.warmup((4,))
        ref = eng.infer(x)
        frag = eng.plan_fragment()
        assert frag["cache_key"] == eng.cache_key
        assert frag["buckets"]  # the warmed ladder
        disk = {key_digest(k) for k in eng._jit.store_keys()}
        assert disk <= ProgramStore(str(tmp_path)).keys()

        cc.deactivate()
        cc.activate(str(tmp_path))
        eng2 = InferenceEngine.for_network(_net())
        eng2.warmup_from_plan(frag)
        assert {key_digest(k) for k in eng2._jit.store_keys()} == disk
        misses = cc.stats()["misses"]
        out = eng2.infer(x)
        assert cc.stats()["misses"] == misses  # zero traffic recompiles
        np.testing.assert_allclose(out, ref, atol=1e-6)


# ----------------------------------------------------- decode round trip
class TestDecodeRoundTrip:
    PROMPTS = ([1, 2, 3, 4, 5, 6], [7, 8, 9])
    MT = (10, 8)

    def _traffic(self, loop):
        streams = loop.submit_many(list(self.PROMPTS), list(self.MT))
        return [s.result(timeout=120) for s in streams]

    def _dispatchers(self, loop):
        return [d for d in (loop._step, loop._verify, loop._prefill,
                            loop._prefill_ctx, loop._copy)
                if hasattr(d, "store_keys")]

    @pytest.mark.parametrize("kernel", ["auto", "gather"])
    @pytest.mark.parametrize("spec", [0, 2])
    @pytest.mark.parametrize("prefix", [True, False])
    def test_plan_round_trip_identical_keys(self, tmp_path, kernel,
                                            spec, prefix):
        params = _params()
        root = str(tmp_path)
        cc.activate(root)
        with DecodeLoop(params, CFG, slots=2, page_size=8,
                        kernel=kernel, speculation=spec,
                        prefix_cache=prefix, device=CPU) as loop:
            ref = self._traffic(loop)
            frag = loop.plan_fragment()
            progs = loop.decode_step_programs()
            keys = set()
            for d in self._dispatchers(loop):
                keys |= {key_digest(k) for k in d.store_keys()}
        assert frag["cache_key"].startswith("decode:")
        # speculation routes every round through verify; otherwise the
        # plain step must have dispatched — the flags track actual USE
        assert frag["verify"] if spec else frag["step"]
        assert bool(frag["prefill"])

        cc.deactivate()
        cc.activate(root)
        with DecodeLoop(params, CFG, slots=2, page_size=8,
                        kernel=kernel, speculation=spec,
                        prefix_cache=prefix, device=CPU) as loop2:
            n = loop2.warm_programs(frag)
            assert n >= 1
            keys2 = set()
            for d in self._dispatchers(loop2):
                keys2 |= {key_digest(k) for k in d.store_keys()}
            assert keys2 == keys
            assert loop2.decode_step_programs() == progs
            misses = cc.stats()["misses"]
            out = self._traffic(loop2)
            assert out == ref                       # identical tokens
            assert cc.stats()["misses"] == misses   # zero recompiles


# ------------------------------------------------------ serving handle
class TestServeWarmStart:
    def test_cold_then_warm_boot_http(self, tmp_path):
        root = str(tmp_path / "cache")
        x = np.random.RandomState(0).rand(3, 4)
        cold = serve_network(_net(), n_replicas=1, max_delay_ms=1.0,
                             warmup_shape=(4,), compile_cache=root)
        try:
            ref = _post(f"{cold.url}/predict", {"inputs": x.tolist()})
            stats = _get(f"{cold.url}/stats")
            assert stats["warmup"]["recompiled_after_warmup"] == 0
            assert stats["compile_cache"]["dir"] == os.path.abspath(root)
            assert stats["compile_cache"]["misses"] >= 1
            ready = _get(f"{cold.url}/readyz")
            assert ready["warmup_seconds"] > 0
            plan_path = cold.warmup_plan_path
        finally:
            cold.close()   # records the plan
            cc.deactivate()

        assert os.path.exists(plan_path)
        warm = serve_network(_net(), n_replicas=1, max_delay_ms=1.0,
                             warmup_shape=(4,), compile_cache=root)
        try:
            stats = _get(f"{warm.url}/stats")
            assert stats["warmup"]["plan_replayed"]["engines"] >= 1
            assert stats["warmup"]["recompiled_after_warmup"] == 0
            assert stats["compile_cache"]["hits"] >= 1
            out = _post(f"{warm.url}/predict", {"inputs": x.tolist()})
            np.testing.assert_allclose(out["outputs"], ref["outputs"],
                                       atol=1e-6)
            with urllib.request.urlopen(f"{warm.url}/metrics",
                                        timeout=30) as r:
                text = r.read().decode()
            for series in ("dl4j_compile_cache_hits",
                           "dl4j_compile_cache_misses",
                           "dl4j_compile_warmup_seconds"):
                assert series in text
            stats = _get(f"{warm.url}/stats")
            assert stats["warmup"]["recompiled_after_warmup"] == 0
        finally:
            warm.close()

    def test_chaos_faulted_cache_serves_clean(self, tmp_path):
        """A chaos-faulted store degrades to uncached calls — requests
        still return 200 with correct outputs, zero errors."""
        root = str(tmp_path / "cache")
        x = np.random.RandomState(1).rand(2, 4)
        chaos.configure([Rule("compile.cache_read", "error"),
                         Rule("compile.cache_write", "error")])
        try:
            with serve_network(_net(), n_replicas=1, max_delay_ms=1.0,
                               warmup_shape=(4,),
                               compile_cache=root) as handle:
                out = _post(f"{handle.url}/predict",
                            {"inputs": x.tolist()})
                assert np.asarray(out["outputs"]).shape == (2, 3)
                assert _get(f"{handle.url}/readyz")["ready"]
        finally:
            chaos.deactivate()


# ------------------------------------------ the recompile gate can fail
class TestRecompileGate:
    PROMPTS = ([1, 2, 3, 4, 5, 6], [7, 8, 9])

    def _boot(self, root, plan):
        """One boot on the store at `root` with an LM behind /generate,
        the prompts answered one at a time; its /stats "warmup"."""
        gen = InferenceEngine.for_transformer(_params(), CFG, device=CPU)
        handle = serve_network(_net(), n_replicas=1, max_delay_ms=1.0,
                               warmup_shape=(4,), generate_engine=gen,
                               slots=2, page_size=8, compile_cache=root,
                               warmup_plan=plan)
        try:
            for prompt in self.PROMPTS:
                _post(f"{handle.url}/generate",
                      {"prompt": [prompt], "max_tokens": 4})
            return _get(f"{handle.url}/stats")["warmup"]
        finally:
            handle.close()
            cc.deactivate()

    def test_a_boot_without_its_plan_reads_its_programs(self, tmp_path):
        """`recompiled_after_warmup` counts the programs built after
        warmup, store or not. A boot on a warm store with plan replay
        off builds the decode step and the prefill groups in traffic and
        reads > 0, although the store knew every signature (0 store
        misses); the boot that replays the plan reads 0."""
        root = str(tmp_path / "cache")
        cold = self._boot(root, "auto")
        assert cold["recompiled_after_warmup"] > 0
        assert cold["store_misses_after_warmup"] > 0
        warm = self._boot(root, "auto")
        assert warm["plan_replayed"]["decode"] >= 1
        assert warm["recompiled_after_warmup"] == 0
        assert warm["store_misses_after_warmup"] == 0
        off = self._boot(root, "off")
        assert off["plan_replayed"] is None
        assert off["store_misses_after_warmup"] == 0
        assert off["recompiled_after_warmup"] > 0


# ------------------------------------------------- no reference cycles
class TestNoReferenceCycles:
    @pytest.mark.parametrize("store", [False, True])
    def test_owners_are_freed_by_refcount(self, tmp_path, store):
        """A network, an engine, a drafter and a decode loop that ran
        their programs are freed by refcount alone, with and without a
        store: no dispatcher holds its owner strongly."""
        import gc
        import weakref

        from deeplearning4j_tpu_torch.serving.speculation import \
            ModelDrafter

        if store:
            cc.activate(str(tmp_path))
        x = np.random.RandomState(0).randn(8, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[np.arange(8) % 3]
        gc.collect()
        gc.disable()
        try:
            net = _net()
            net.fit(x, y, epochs=1)
            net.output(x)
            eng = InferenceEngine.for_network(_net())
            eng.infer(x)
            drafter = ModelDrafter(_params(), CFG, window=8, device=CPU)
            drafter.propose_all(np.zeros((2, 8), np.int32), 2)
            with DecodeLoop(_params(), CFG, slots=2, page_size=8,
                            device=CPU) as loop:
                loop.submit_many([[1, 2, 3]], [4])[0].result(timeout=120)
            refs = [weakref.ref(o) for o in (net, eng, drafter, loop)]
            del net, eng, drafter, loop
            assert [r() is None for r in refs] == [True] * 4
        finally:
            gc.enable()


# ------------------------------------------------------------- spawners
class TestSpawnerPropagation:
    def test_replica_spawner_exports_cache_env(self, tmp_path):
        from deeplearning4j_tpu_torch.serving.fleet import ReplicaSpawner

        cc.activate(str(tmp_path))
        sp = ReplicaSpawner("model.json")
        assert sp.env[cc.CACHE_ENV] == str(tmp_path)
        # an explicit caller-provided value is never overridden
        sp2 = ReplicaSpawner("model.json",
                             env={cc.CACHE_ENV: "/elsewhere"})
        assert sp2.env[cc.CACHE_ENV] == "/elsewhere"

    def test_worker_spawner_exports_cache_env(self, tmp_path):
        from deeplearning4j_tpu_torch.scaleout.supervisor import \
            WorkerSpawner

        cc.activate(str(tmp_path))
        sp = WorkerSpawner("reg", "run")
        assert sp.env[cc.CACHE_ENV] == str(tmp_path)

    def test_no_export_when_inactive(self):
        from deeplearning4j_tpu_torch.serving.fleet import ReplicaSpawner

        sp = ReplicaSpawner("model.json", env={})
        assert cc.CACHE_ENV not in sp.env

    def test_env_auto_activation(self, tmp_path):
        """Children activate lazily from the env var their parent
        exported — the no-flag inheritance path."""
        os.environ[cc.CACHE_ENV] = str(tmp_path)
        try:
            cc._env_checked = False  # simulate a fresh child process
            assert cc.active_dir() == str(tmp_path)
        finally:
            os.environ.pop(cc.CACHE_ENV, None)


# -------------------------------------------------- kill→respawn drill
@pytest.mark.slow
class TestFleetRespawnDrill:
    def test_kill_respawn_boots_warm(self, tmp_path):
        """The fleet-spawner contract end to end in real processes: the
        parent's active store reaches a spawned `cli serve` child through
        DL4J_TPU_COMPILE_CACHE alone (no flags), the cold child
        populates store + plan, and after a kill the RESPAWNED member
        boots warm — plan replayed, zero recompiles after warmup,
        faster warmup than the victim's."""
        import time

        from deeplearning4j_tpu_torch.scaleout.checkpoint import \
            DefaultModelSaver
        from deeplearning4j_tpu_torch.serving.fleet import ReplicaSpawner

        ckpt = str(tmp_path / "m.ckpt")
        DefaultModelSaver(ckpt, keep_old=False).save(_net())
        cc.activate(str(tmp_path / "cache"))
        spawner = ReplicaSpawner(ckpt, serve_args=["--max-delay-ms", "1",
                                                   "--device", CPU])
        x = np.random.RandomState(0).rand(2, 4)

        def ready_stats(url):
            deadline = time.monotonic() + 240
            while time.monotonic() < deadline:
                try:
                    if _get(f"{url}/readyz")["ready"]:
                        return _get(f"{url}/stats")
                except Exception:  # noqa: BLE001 — 503 until warm
                    pass
                time.sleep(0.05)
            raise AssertionError("replica never became ready")

        proc, url = spawner.spawn()
        try:
            cold = ready_stats(url)
            assert cold["compile_cache"]["misses"] >= 1
            ref = _post(f"{url}/predict", {"inputs": x.tolist()})
        finally:
            proc.kill()      # the drill: replica dies
            proc.wait(timeout=30)

        proc2, url2 = spawner.spawn()   # capacity repair respawns
        try:
            warm = ready_stats(url2)
            assert warm["warmup"]["plan_replayed"]["engines"] >= 1
            assert warm["warmup"]["recompiled_after_warmup"] == 0
            assert warm["compile_cache"]["hits"] >= 1
            assert warm["compile_cache"]["misses"] == 0
            assert (warm["warmup"]["seconds"]
                    < cold["warmup"]["seconds"])
            out = _post(f"{url2}/predict", {"inputs": x.tolist()})
            np.testing.assert_allclose(out["outputs"], ref["outputs"],
                                       atol=1e-6)
        finally:
            proc2.kill()
            proc2.wait(timeout=30)


# ------------------------------------------------------------- trainer
class TestTrainerWarmStart:
    def test_fit_warm_boot(self, tmp_path):
        x = np.random.RandomState(0).randn(16, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[
            np.random.RandomState(1).randint(0, 3, 16)]
        cc.activate(str(tmp_path))
        n1 = _net()
        n1.fit(x, y, epochs=2)
        p1 = n1.predict(x)
        assert cc.stats()["entries"] >= 1
        cc.deactivate()
        cc.activate(str(tmp_path))
        hits0 = cc.stats()["hits"]
        n2 = _net()
        n2.fit(x, y, epochs=2)
        assert cc.stats()["hits"] > hits0   # train step known, not new
        assert (n2.predict(x) == p1).all()

    def test_fit_scan_warm_boot(self, tmp_path):
        x = np.random.RandomState(0).randn(16, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[
            np.random.RandomState(1).randint(0, 3, 16)]
        cc.activate(str(tmp_path))
        s1 = _net().fit_scan(x, y, batch_size=8, epochs=3)
        cc.deactivate()
        cc.activate(str(tmp_path))
        misses0 = cc.stats()["misses"]
        s2 = _net().fit_scan(x, y, batch_size=8, epochs=3)
        assert cc.stats()["misses"] == misses0  # whole-call program hit
        assert abs(s1 - s2) < 1e-6


# ------------------------------------------- the kernel library's store
_STUB_NVCC = '''\
import os, sys
with open(os.environ["STUB_NVCC_LOG"], "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "wb") as f:
    f.write(b"stub-object:" + os.path.basename(out).encode())
'''


@pytest.fixture
def stub_compiler(tmp_path, monkeypatch):
    """`_build` with its output under tmp_path and `nvcc` replaced by a
    stub that records each call and writes its `-o` file."""
    stub = tmp_path / "nvcc"
    stub.write_text(f"#!{sys.executable}\n" + _STUB_NVCC)
    stub.chmod(0o755)
    log = tmp_path / "nvcc.log"
    log.write_text("")
    monkeypatch.setenv("STUB_NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build" / "kernels")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(stub))

    def calls():
        return [line for line in log.read_text().splitlines() if line]

    return calls


def _wipe_build_dir():
    import shutil

    shutil.rmtree(_build.BUILD_ROOT, ignore_errors=True)


def test_kernel_library_comes_from_the_store_without_nvcc(tmp_path,
                                                         stub_compiler):
    cc.activate(str(tmp_path / "cache"))
    lib = _build.build()
    n_sources = len(_build.sources())
    assert len(stub_compiler()) == n_sources + 1  # compiles + the link
    assert _build.build_from == "nvcc"
    stored = cc.active_compiler().store.get(_build.store_key())
    assert stored == lib.read_bytes()
    # a fresh checkout: empty build directory, the same store
    _wipe_build_dir()
    cc.deactivate()
    cc.activate(str(tmp_path / "cache"))
    hits = cc.stats()["hits"]
    lib2 = _build.build()
    assert len(stub_compiler()) == n_sources + 1  # no compiler call
    assert _build.build_from == "store"
    assert lib2 == lib and lib2.read_bytes() == stored
    assert cc.stats()["hits"] == hits + 1
    # already on disk: neither the store nor the compiler
    assert _build.build() == lib and _build.build_from == "disk"


def test_quarantined_library_is_built_by_nvcc(tmp_path, stub_compiler):
    cc.activate(str(tmp_path / "cache"))
    _build.build()
    calls = len(stub_compiler())
    store = cc.active_compiler().store
    path = os.path.join(store.dir, key_digest(_build.store_key()) + ".xc")
    blob = bytearray(open(path, "rb").read())
    blob[-1] ^= 0xFF  # the entry's CRC now fails
    open(path, "wb").write(bytes(blob))
    _wipe_build_dir()
    torn = store.evictions().get("torn", 0)
    lib = _build.build()
    assert store.evictions().get("torn", 0) == torn + 1
    assert _build.build_from == "nvcc"
    assert len(stub_compiler()) == 2 * calls
    assert store.get(_build.store_key()) == lib.read_bytes()  # re-stored


def test_no_store_means_nvcc_and_nothing_stored(tmp_path, stub_compiler):
    assert cc.active_compiler() is None
    _build.build()
    assert _build.build_from == "nvcc"
    assert len(stub_compiler()) == len(_build.sources()) + 1


def test_a_kernel_edit_misses_the_library_and_keeps_the_plans(
        monkeypatch):
    """The kernel sources key the library (`kernels:<hash>`), not the
    runtime fingerprint: an edited kernel misses its library, and the
    store's other entries and plans stay valid. The cuBLAS workspace
    setting is in the fingerprint."""
    from deeplearning4j_tpu_torch.compilecache import store as ccstore

    fp, key = ccstore.runtime_fingerprint(), _build.store_key()
    monkeypatch.setattr(_build, "source_digest", lambda: "edited")
    assert ccstore.runtime_fingerprint() == fp
    assert _build.store_key() != key
    monkeypatch.undo()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    assert ccstore.runtime_fingerprint() != fp


# ---------------------------------------------- the plan format is JAX's
def test_a_port_plan_reads_in_the_jax_package(tmp_path, monkeypatch):
    from deeplearning4j_tpu.compilecache import warmup as jwarmup

    root = str(tmp_path)
    cc.activate(root)
    with DecodeLoop(_params(), CFG, slots=2, page_size=8, speculation=2,
                    device=CPU) as loop:
        TestDecodeRoundTrip()._traffic(loop)
        dfrag = loop.plan_fragment()
    eng = InferenceEngine.for_network(_net())
    eng.warmup((4,))
    path = ccwarmup.auto_plan_path(root, eng.cache_key)
    assert ccwarmup.save_plan(path, {"engines": [eng.plan_fragment()],
                                     "decode": dfrag})
    ours = ccwarmup.load_plan(path)
    assert ours is not None
    # the JAX package ignores a plan of another runtime: hand it ours
    monkeypatch.setattr(jwarmup, "runtime_fingerprint",
                        lambda: ours["fingerprint"])
    theirs = jwarmup.load_plan(path)
    assert theirs == ours
    assert sorted(theirs) == ["decode", "engines", "fingerprint", "version"]
    assert set(theirs["decode"]) >= {"cache_key", "step", "verify", "copy",
                                     "prefill", "prefill_ctx"}
    assert set(theirs["engines"][0]) == {"cache_key", "buckets",
                                         "feature_shape", "dtype"}
    assert jwarmup.auto_plan_path(root, eng.cache_key, role="prefill") == \
        ccwarmup.auto_plan_path(root, eng.cache_key, role="prefill")
    # JAX's replay drives the port's hooks through the same fragments
    rep = jwarmup.replay_plan(theirs, engines=[eng])
    assert rep == {"engines": 1, "loops": 0, "errors": 0}
