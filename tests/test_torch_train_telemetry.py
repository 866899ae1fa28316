"""The PyTorch port's training telemetry and chaos points on the CPU,
held against the JAX package's.

The JAX package's `TestInstrumentedTraining` and `TestCLITelemetry`
(`tests/test_telemetry.py`) run on the port: steps, examples and feed
batches from a DeviceFeed fit, the scan series and the loss gauge from
fit_scan, guardian events in the registry, listeners publishing without
a second code path, params bit-identical with telemetry killed, and
`cli train --metrics-port 0 --trace` (the wall-clock overhead bound is
left out: the port's tests assert none). Then parity with the JAX
package: the same conf, weights and batches through one `fit` and one
`fit_scan` move every training series by the same name, labels, help
and value; the `checkpoint.write` / `checkpoint.rename` chaos points
fire at the same ordinals for one sharded save; a `train.batch` NaN
rule makes the guardian skip exactly the steps the JAX guardian skips.
"""

from __future__ import annotations

import json
import os
import urllib.request

import jax
import numpy as np
import pytest

from deeplearning4j_tpu import telemetry as jtelemetry
from deeplearning4j_tpu.checkpoint import ShardedModelSaver as JSaver
from deeplearning4j_tpu.config import MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.datasets import DeviceFeed as JFeed
from deeplearning4j_tpu.datasets import ListDataSetIterator as JListIter
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.optimize import guardian as jguardian
from deeplearning4j_tpu.optimize.listeners import \
    CollectGuardianEvents as JCollect
from deeplearning4j_tpu.testing import chaos as jchaos
from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.checkpoint import ShardedModelSaver
from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.datasets import (DataSet, DeviceFeed,
                                               ListDataSetIterator)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.guardian import GuardianPolicy
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectGuardianEvents, CollectScoresListener, StepTimeListener)
from deeplearning4j_tpu_torch.telemetry import device as tdevice
from deeplearning4j_tpu_torch.testing import chaos
from deeplearning4j_tpu_torch.weights import multilayer_params_from_jax

#: every family the training side publishes
TRAIN_SERIES = ("dl4j_train_steps", "dl4j_train_examples",
                "dl4j_train_epochs", "dl4j_train_loss",
                "dl4j_train_step_seconds", "dl4j_listener_iterations",
                "dl4j_feed_batches", "dl4j_feed_padded_examples",
                "dl4j_feed_bucket_hits", "dl4j_feed_prefetch_depth",
                "dl4j_guardian_events", "dl4j_ckpt_saves",
                "dl4j_ckpt_bytes_written", "dl4j_ckpt_errors",
                "dl4j_ckpt_snapshot_seconds", "dl4j_ckpt_write_seconds",
                "dl4j_ckpt_in_flight", "dl4j_ckpt_last_committed_step")
#: the counters whose values a fit and a fit_scan must move alike
COUNTED = ("dl4j_train_steps", "dl4j_train_examples", "dl4j_train_epochs",
           "dl4j_feed_batches", "dl4j_feed_padded_examples",
           "dl4j_feed_bucket_hits")


def _conf(builder=NeuralNetConfiguration.builder, iters=1):
    """tests/test_telemetry.py's net: 4-8-3 tanh, SGD."""
    return (builder()
            .lr(0.1).n_in(4).activation_function("tanh")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(iters).use_adagrad(False)
            .list(2).hidden_layer_sizes([8])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=3)
            .pretrain(False).build())


def _net(iters=1):
    return MultiLayerNetwork(_conf(iters=iters), device="cpu")


def _pair():
    """(port net, JAX net) on the JAX net's initial parameters."""
    conf = _conf(JConf.builder)
    jnet = JNet(JMLC.from_json(conf.to_json()))
    net = MultiLayerNetwork.from_config_json(conf.to_json(), device="cpu")
    net.param_table = multilayer_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet._params), device="cpu")
    return net, jnet


def _data(n=32, n_in=4, n_out=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, n_in).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rng.randint(0, n_out, n)]
    return x, y


def _samples(reg, names=TRAIN_SERIES) -> dict:
    """{(family, labels): (kind, help, value)} of the named families;
    a histogram's value is its observation count."""
    out = {}
    for fam, children in reg.collect():
        if fam.name not in names:
            continue
        for labels, child in children:
            value = (child.count if fam.kind == "histogram"
                     else child.value)
            out[(fam.name, tuple(sorted(labels.items())))] = (
                fam.kind, fam.help, value)
    return out


def _moved(before, after, names=COUNTED) -> dict:
    """The counters of `names` that a run moved, by how much."""
    return {key: after[key][2] - before.get(key, (0, 0, 0))[2]
            for key in after if key[0] in names
            and after[key][2] != before.get(key, (0, 0, 0))[2]}


# =========================================================== instrumentation
class TestInstrumentedTraining:
    def test_fit_publishes_steps_examples_and_feed_counters(self):
        reg = telemetry.get_registry()
        steps0 = reg.counter("dl4j_train_steps").value
        ex0 = reg.counter("dl4j_train_examples").value
        batches0 = reg.counter("dl4j_feed_batches").value

        net = _net()
        x, y = _data(40)
        feed = DeviceFeed(ListDataSetIterator(DataSet(x, y), 16),
                          device="cpu")
        net.fit(feed, epochs=2)  # 3 batches/epoch (16, 16, 8)

        assert reg.counter("dl4j_train_steps").value - steps0 == 6
        # bucketed rows: 16+16+8(pad of ragged 8-row tail) per epoch
        assert reg.counter("dl4j_train_examples").value - ex0 == 80
        assert reg.counter("dl4j_feed_batches").value - batches0 == 6
        hist = reg.histogram("dl4j_train_step_seconds")
        assert hist.labels(source="fit").count >= 6

    def test_fit_scan_publishes_scan_series_and_loss(self):
        reg = telemetry.get_registry()
        steps0 = reg.counter("dl4j_train_steps").value
        net = _net()
        x, y = _data(32)
        score = net.fit_scan(x, y, batch_size=8, epochs=2)
        assert reg.counter("dl4j_train_steps").value - steps0 == 8
        assert reg.gauge("dl4j_train_loss").value == pytest.approx(score)
        assert reg.histogram(
            "dl4j_train_step_seconds").labels(source="scan").count >= 1

    def test_guardian_events_reach_the_registry(self):
        reg = telemetry.get_registry()
        skips0 = reg.counter("dl4j_guardian_events").labels(
            kind="skip").value
        net = _net()
        x, y = _data(48)
        x[16:32] = np.nan  # one poisoned batch mid-stream
        net.fit(ListDataSetIterator(DataSet(x, y), 16),
                guardian=GuardianPolicy(check_every=1, snapshot_every=100,
                                        max_skips_per_window=2))
        assert reg.counter("dl4j_guardian_events").labels(
            kind="skip").value > skips0

    def test_listeners_publish_without_a_second_code_path(self):
        reg = telemetry.get_registry()
        listener_hist = reg.histogram(
            "dl4j_train_step_seconds").labels(source="listener")
        before = listener_hist.count
        net = _net()
        scores, times = CollectScoresListener(), StepTimeListener()
        net.set_listeners([scores, times])
        x, y = _data(16)
        for _ in range(3):
            net.fit(x, y)
        assert len(scores.scores) == 3  # public API unchanged
        assert len(times.step_times) == 2
        assert listener_hist.count - before == 2
        assert reg.gauge("dl4j_train_loss").value \
            == pytest.approx(scores.scores[-1][1])

    def test_off_by_default_paths_bit_identical(self):
        """The instrumented fit must produce bit-identical parameters
        with telemetry enabled vs killed: recording is host counters
        only."""
        x, y = _data(32)
        net_on = _net()
        net_on.fit(x, y, epochs=3)
        net_on.fit_scan(x, y, batch_size=8, epochs=2)
        telemetry.set_enabled(False)
        try:
            net_off = _net()
            net_off.fit(x, y, epochs=3)
            net_off.fit_scan(x, y, batch_size=8, epochs=2)
        finally:
            telemetry.set_enabled(True)
        np.testing.assert_array_equal(net_on.params().numpy(),
                                      net_off.params().numpy())

    def test_program_counts_track_batch_shapes(self):
        """dl4j_jit_programs{cache="train_step"|"predict_step"} count the
        distinct batch shapes run: a bucketed feed keeps the train step
        at the buckets it hit, the bucketed forward at its pow2 sizes."""
        net = _net()
        x, y = _data(40)
        net.fit(DeviceFeed(ListDataSetIterator(DataSet(x, y), 16),
                           device="cpu"), epochs=2)
        assert net.train_step_cache_size() == 2  # buckets 16 and 8
        for n in (3, 5, 8, 9):
            net.output(x[:n])
        assert net.predict_step_cache_size() == 2  # buckets 8 and 16
        assert tdevice.jit_cache_total("train_step") >= 2
        assert tdevice.jit_cache_total("predict_step") >= 2


# ======================================================================= cli
class TestCLITelemetry:
    def test_train_with_trace_and_metrics_port(self, tmp_path, capsys):
        from deeplearning4j_tpu_torch.cli import main
        from deeplearning4j_tpu_torch.datasets.iris import load_iris

        data = load_iris()
        x, y = np.asarray(data.features), np.asarray(data.labels)
        rows = np.hstack([x, np.argmax(y, 1)[:, None]])
        csv = tmp_path / "iris.csv"
        np.savetxt(csv, rows, delimiter=",", fmt="%.4f")
        conf_path = tmp_path / "conf.json"
        conf_path.write_text(_conf(iters=3).to_json())
        trace_path = tmp_path / "trace.json"

        assert main(["train", "-i", str(csv), "-m", str(conf_path),
                     "-o", str(tmp_path / "m.ckpt"), "--device", "cpu",
                     "--metrics-port", "0",
                     "--trace", str(trace_path)]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        # the live endpoint is announced UP FRONT (before the fit); the
        # closing summary carries only the trace path — the endpoint is
        # already shut down, a dead URL there would mislead parsers
        first, last = json.loads(lines[0]), json.loads(lines[-1])
        assert first["metrics"].endswith("/metrics")
        assert "metrics" not in last
        assert last["trace"] == str(trace_path)
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        assert any(e["name"] == "train_step" for e in events)

    def test_train_metrics_endpoint_serves_the_training_series(
            self, tmp_path, capsys, monkeypatch):
        """The announced endpoint answers while the run lives: a scrape
        taken just before it closes shows the steps, epochs and the
        checkpoint writer's commits of this run."""
        from deeplearning4j_tpu_torch import cli

        x, y = _data(48)
        csv = tmp_path / "d.csv"
        np.savetxt(csv, np.hstack([x, y.argmax(1)[:, None]]),
                   delimiter=",", fmt="%.9g")
        conf_path = tmp_path / "conf.json"
        conf_path.write_text(_conf().to_json())
        scraped = []
        close = cli._Telemetry.close

        def scrape_then_close(self):
            with urllib.request.urlopen(self.metrics.url + "/metrics",
                                        timeout=30) as r:
                scraped.append(r.read().decode())
            return close(self)

        monkeypatch.setattr(cli._Telemetry, "close", scrape_then_close)
        reg = telemetry.get_registry()
        steps0 = reg.counter("dl4j_train_steps").value
        saves0 = reg.counter("dl4j_ckpt_saves").value
        assert cli.main(["train", "-i", str(csv), "-m", str(conf_path),
                         "-o", str(tmp_path / "m.ckpt"), "--device", "cpu",
                         "--batch-size", "16", "--epochs", "2",
                         "--checkpoint-dir", str(tmp_path / "ck"),
                         "--checkpoint-every", "2",
                         "--metrics-port", "0"]) == 0
        capsys.readouterr()
        text = scraped[0]
        values = {ln.split()[0]: float(ln.split()[-1])
                  for ln in text.splitlines()
                  if ln.startswith(("dl4j_train_steps_total ",
                                    "dl4j_ckpt_saves_total "))}
        assert values["dl4j_train_steps_total"] - steps0 == 6
        # autosaves after batches 2, 4 and 6
        assert values["dl4j_ckpt_saves_total"] - saves0 == 3
        assert 'dl4j_guardian_events_total{kind="autosave"}' in text


# ============================================================ JAX parity
class TestParityWithJax:
    def test_fit_and_fit_scan_move_the_jax_packages_series(self):
        """One DeviceFeed fit (a ragged tail, so padding) and one padded
        fit_scan, from the same weights on the same batches: every
        training counter moves by the same name, labels, help and
        value as the JAX package's, and the params agree."""
        x, y = _data(36, seed=3)  # batches 16, 16, 4 (padded to 8)
        net, jnet = _pair()
        jreg, reg = jtelemetry.get_registry(), telemetry.get_registry()
        j0, p0 = _samples(jreg), _samples(reg)
        jnet.fit(JFeed(JListIter(JDataSet(x, y), 16)), epochs=2)
        jnet.fit_scan(x, y, batch_size=16, epochs=3, pad_partial=True)
        net.fit(DeviceFeed(ListDataSetIterator(DataSet(x, y), 16),
                           device="cpu"), epochs=2)
        net.fit_scan(x, y, batch_size=16, epochs=3, pad_partial=True)
        j1, p1 = _samples(jreg), _samples(reg)
        theirs, ours = _moved(j0, j1), _moved(p0, p1)
        assert ours == theirs
        assert ours[("dl4j_train_steps", ())] == 6 + 9
        assert ours[("dl4j_feed_padded_examples", ())] == 2 * 4
        np.testing.assert_allclose(net.params().numpy(),
                                   np.asarray(jnet.params()), atol=2e-5)

    def test_every_training_family_has_the_jax_name_help_and_labels(self):
        """After the same runs in both packages, each training family
        present in the JAX registry is in the port's with the same kind,
        help and label names."""
        x, y = _data(32, seed=4)
        net, jnet = _pair()
        for n in (net, jnet):
            n.set_listeners([])
        jnet.fit(JFeed(JListIter(JDataSet(x, y), 16)))
        net.fit(DeviceFeed(ListDataSetIterator(DataSet(x, y), 16),
                           device="cpu"))

        def families(reg):
            out = {}
            for fam, children in reg.collect():
                if fam.name in TRAIN_SERIES:
                    out[fam.name] = (fam.kind, fam.help, sorted(
                        {tuple(sorted(lab)) for lab, _ in children}))
            return out

        ours = families(telemetry.get_registry())
        theirs = families(jtelemetry.get_registry())
        assert set(theirs) <= set(ours)
        for name in theirs:
            assert ours[name][:2] == theirs[name][:2], name
            assert set(theirs[name][2]) <= set(ours[name][2]), name

    def test_checkpoint_chaos_points_fire_at_the_jax_ordinals(
            self, tmp_path, monkeypatch):
        """One sharded save of the same network: the port hits
        `checkpoint.write` before each shard file and `checkpoint.rename`
        before the manifest and the marker, in the JAX package's order,
        and a rename fault at the marker leaves the step uncommitted in
        both."""
        net, jnet = _pair()
        x, y = _data(16)
        net.fit(x, y)
        jnet.fit(x, y)
        calls = {"port": [], "jax": []}

        def recorder(module, side):
            hit = module.hit

            def record(point, **ctx):
                if point.startswith("checkpoint."):
                    calls[side].append((point, ctx.get("file")))
                return hit(point, **ctx)

            monkeypatch.setattr(module, "hit", record)

        recorder(chaos, "port")
        recorder(jchaos, "jax")
        with ShardedModelSaver(str(tmp_path / "p")) as s:
            s.save(net, step=1)
        with JSaver(str(tmp_path / "j"), sync=True) as s:
            s.save(jnet, step=1)
        assert calls["port"] == calls["jax"]
        points = [p for p, _ in calls["port"]]
        assert points[-2:] == ["checkpoint.rename"] * 2
        assert set(points[:-2]) == {"checkpoint.write"}

        from deeplearning4j_tpu.checkpoint.restore import \
            list_committed_steps as jlist
        from deeplearning4j_tpu_torch.checkpoint.restore import \
            list_committed_steps

        for side, module, make in (
                ("port", chaos,
                 lambda r: ShardedModelSaver(r)),
                ("jax", jchaos, lambda r: JSaver(r, sync=True))):
            root = str(tmp_path / f"torn_{side}")
            module.configure([module.Rule("checkpoint.rename", "error",
                                          at=[1])])
            saver = make(root)
            try:
                with pytest.raises(Exception, match="chaos"):
                    saver.save(net if side == "port" else jnet, step=2,
                               wait=True)
            finally:
                module.deactivate()
            for _ in range(2):  # the writer relays the fault once
                try:
                    saver.close()
                except RuntimeError:
                    continue
                break
            assert os.path.exists(os.path.join(root, "step_0000000002",
                                               "manifest.json"))
            assert list_committed_steps(root) == jlist(root) == []

    def test_train_batch_nan_rule_skips_the_jax_packages_steps(self):
        """A `train.batch` NaN rule at two ordinals: the port's guardian
        skips exactly the steps the JAX guardian skips, with the same
        events, and the params agree."""
        x, y = _data(16 * 8, seed=5)
        rule_at = [2, 5]
        results = {}
        for side in ("port", "jax"):
            net, jnet = _pair()
            module = chaos if side == "port" else jchaos
            listener = CollectGuardianEvents() if side == "port" \
                else JCollect()
            policy_cls = (GuardianPolicy if side == "port"
                          else jguardian.GuardianPolicy)
            policy = policy_cls(listeners=[listener], check_every=1,
                                snapshot_every=100,
                                max_skips_per_window=4)
            module.configure([module.Rule("train.batch", "nan",
                                          at=rule_at)])
            try:
                if side == "port":
                    net.fit(ListDataSetIterator(DataSet(x, y), 16),
                            guardian=policy)
                    params = net.params().numpy()
                else:
                    jnet.fit(JListIter(JDataSet(x, y), 16),
                             guardian=policy)
                    params = np.asarray(jnet.params())
                fired = [e["hit"] for e in module.active().log()]
            finally:
                module.deactivate()
            results[side] = ([(e.kind, e.step) for e in listener.events],
                             fired, params)
        ours, theirs = results["port"], results["jax"]
        assert ours[0] == theirs[0]
        assert [k for k, _ in ours[0]].count("skip") == len(rule_at)
        assert ours[1] == theirs[1] == rule_at
        np.testing.assert_allclose(ours[2], theirs[2], atol=2e-5)
