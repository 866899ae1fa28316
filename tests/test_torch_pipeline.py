"""The PyTorch port's deployment controller (deeplearning4j_tpu_torch/
deploy/controller.py) and `cli pipeline` on the CPU.

The JAX package's `tests/test_pipeline.py` on the port: sharded
checkpoints committed by the port's `ShardedModelSaver`, port
`serve_network` replicas (a CPU network) behind a `Fleet(start=False)`
driven inline, and the controller's watch → eval gate (on the CPU) →
canary promote → rollback loop on top; crash-consistency restarts over a
journal captured mid-promotion; the chaos fault matrix over every
pipeline injection point; the watcher against a rotating writer.

Then parity with the JAX package: port-written steps (a good one, its
output layer negated, a newer good one, and a trained network of
another width) committed one by one into a root that the JAX
controller and the port's each watch, over the same stub fleet for the
same cycles: both reach the same champion, the same quarantine map with
the same reason prefixes, the same journal phases and the same gate
metrics (f1 and accuracy equal in float32). The gate's exception tuple
is held in both packages: a step pruned between the scan and the eval,
and a held-out file of another width, leave the candidate pending. A
`checkpoint.rename` fault at the COMMITTED publish leaves a torn step
that the watcher never offers.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.deploy import DeploymentController as JController
from deeplearning4j_tpu_torch.checkpoint import ShardedModelSaver
from deeplearning4j_tpu_torch.checkpoint import format as ckfmt
from deeplearning4j_tpu_torch.checkpoint.restore import (discover_latest,
                                                         list_committed_steps)
from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.deploy import (CANARY, ControllerBusy,
                                             DeploymentController,
                                             QUARANTINE_MARKER,
                                             ROLLING_BACK)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import (Fleet, serve_fleet,
                                              serve_network)
from deeplearning4j_tpu_torch.testing import chaos

pytestmark = pytest.mark.pipeline


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


def _dataset(n=96, seed=0):
    """Linearly separable 3-class clusters in R^4: a fit net scores
    near 1.0, a random-init net near 1/3 — a reliable gate spread."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 3, n)
    centers = np.eye(3, 4, dtype=np.float32) * 4.0
    x = (centers[labels] + 0.3 * rng.randn(n, 4)).astype(np.float32)
    return x, labels


def _holdout_csv(tmp_path, n=48, seed=7) -> str:
    x, labels = _dataset(n, seed)
    path = str(tmp_path / "holdout.csv")
    np.savetxt(path, np.hstack([x, labels[:, None]]), delimiter=",")
    return path


def _trained_net(hidden=8, epochs=40):
    x, labels = _dataset(96, seed=0)
    y = np.eye(3, dtype=np.float32)[labels]
    net = _net(hidden=hidden)
    net.fit(x, y, epochs=epochs)
    return net


def _save(ck_dir, net, step, **kw):
    with ShardedModelSaver(ck_dir, **kw) as s:
        s.save(net, step=step)


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _poll_until_ready(fleet, n, tries=100):
    for _ in range(tries):
        fleet.poll()
        if fleet.ready_count() >= n:
            return
        time.sleep(0.02)
    raise AssertionError(
        f"only {fleet.ready_count()}/{n} ready: {fleet.state_counts()}")


def _replica(net, ck_dir, step):
    return serve_network(net, n_replicas=1, max_delay_ms=1.0,
                         warmup_shape=(4,),
                         checkpoint={"path": ck_dir, "step": step})


def _fleet(boot_net, boot_dir, n=2):
    handles = [_replica(boot_net, boot_dir, 0) for _ in range(n)]
    fleet = Fleet(start=False, heartbeat_timeout=10.0,
                  initial_checkpoint=boot_dir)
    for h in handles:
        fleet.attach(h.url)
    _poll_until_ready(fleet, n)
    return handles, fleet


def _close(fleet, handles, *ctrls):
    for c in ctrls:
        c.close()
    fleet.close()
    for h in handles:
        h.close()


def _controller(ck_dir, **kw):
    return DeploymentController(ck_dir, device="cpu", **kw)


class TestConveyor:
    def test_commit_eval_promote_end_to_end(self, tmp_path):
        """Happy path: a newly COMMITTED step passes the gate, canaries
        through the fleet, and every replica reports the promoted
        checkpoint identity (/readyz + /stats + fleet snapshot)."""
        good = _trained_net()
        ck_dir = str(tmp_path / "ck")
        _save(ck_dir, good, 1)
        csv = _holdout_csv(tmp_path)
        boot_dir = str(tmp_path / "boot")
        _save(boot_dir, _net(), 0)
        handles, fleet = _fleet(_net(), boot_dir, n=2)
        ctrl = _controller(
            ck_dir, fleet=fleet, eval_data=csv, eval_threshold=0.6,
            poll_interval=0.01, state_dir=str(tmp_path / "state"),
            name="e2e")
        try:
            out = ctrl.run_once()
            assert out == {"action": "promote", "promoted": True,
                           "step": 1}
            assert ctrl.champion["step"] == 1
            assert ctrl.champion["metrics"]["f1"] >= 0.8
            want = os.path.abspath(ck_dir)
            for h in handles:
                ready = _get(f"{h.url}/readyz")
                assert ready["checkpoint"] == {"path": want, "step": 1}
                assert h.stats()["checkpoint"]["step"] == 1
            snap = fleet.snapshot()
            assert list(snap["checkpoints_served"]) == [f"{want}@1"]
            assert len(snap["checkpoints_served"][f"{want}@1"]) == 2
            # quiesced: nothing newer than the champion
            assert ctrl.run_once() == {"action": "idle"}
            # a newer commit rides the same conveyor
            _save(ck_dir, good, 2)
            out = ctrl.run_once()
            assert out["promoted"] and out["step"] == 2
            assert ctrl.status()["counters"]["promotions"] == 2
            assert ctrl.status()["counters"]["eval_pass"] == 2
        finally:
            _close(fleet, handles, ctrl)

    def test_eval_gate_quarantines_bad_checkpoint(self, tmp_path):
        """A poisoned (random-weights) step fails the absolute gate:
        QUARANTINED marker lands in its step dir, the fleet is never
        touched, and the conveyor falls back to the best remaining
        step. A later regressing step trips the champion-relative
        gate too."""
        ck_dir = str(tmp_path / "ck")
        with ShardedModelSaver(ck_dir) as s:
            s.save(_trained_net(), step=1)
            s.save(_net(), step=2)  # poisoned: untrained
        csv = _holdout_csv(tmp_path)
        boot_dir = str(tmp_path / "boot")
        _save(boot_dir, _net(), 0)
        handles, fleet = _fleet(_net(), boot_dir, n=2)
        ctrl = _controller(
            ck_dir, fleet=fleet, eval_data=csv, eval_threshold=0.6,
            regression_margin=0.05, poll_interval=0.01, name="gate")
        try:
            out = ctrl.run_once()
            assert out == {"action": "eval", "step": 2,
                           "promoted": False}
            marker = os.path.join(ck_dir, ckfmt.step_dir_name(2),
                                  QUARANTINE_MARKER)
            assert os.path.exists(marker)
            with open(marker) as f:
                assert "eval_gate" in json.load(f)["reason"]
            assert fleet.snapshot()["reloads"]["ok"] == 0
            out = ctrl.run_once()
            assert out["promoted"] and out["step"] == 1
            _save(ck_dir, _net(), 3)
            out = ctrl.run_once()
            assert out == {"action": "eval", "step": 3,
                           "promoted": False}
            assert ctrl.champion["step"] == 1
            assert set(ctrl.quarantined) == {"2", "3"}
            assert ctrl.status()["counters"]["quarantines"] == 2
            assert fleet.snapshot()["reloads"]["ok"] == 1
            assert ctrl.run_once() == {"action": "idle"}
        finally:
            _close(fleet, handles, ctrl)

    def test_failed_canary_rolls_back_and_quarantines(self, tmp_path):
        """A checkpoint the canary cannot serve (arch mismatch) reaches
        a definitive fleet verdict: the controller journals
        ROLLING_BACK, quarantines the step, and the fleet stays on the
        champion's weights."""
        good = _trained_net()
        ck_dir = str(tmp_path / "ck")
        _save(ck_dir, good, 1)
        boot_dir = str(tmp_path / "boot")
        _save(boot_dir, _net(), 0)
        handles, fleet = _fleet(_net(), boot_dir, n=2)
        ctrl = _controller(ck_dir, fleet=fleet, poll_interval=0.01,
                           name="canary")
        try:
            assert ctrl.run_once()["promoted"]  # step 1 = champion
            # step 2 has a WIDER hidden layer: the replica's /reload
            # rejects it — a definitive canary failure
            _save(ck_dir, _net(hidden=16), 2)
            out = ctrl.run_once()
            assert out["promoted"] is False and out["rolled_back"]
            assert ctrl.champion["step"] == 1
            assert "2" in ctrl.quarantined
            assert "canary" in ctrl.quarantined["2"]
            assert ctrl.status()["counters"]["rollbacks"] == 1
            want = os.path.abspath(ck_dir)
            snap = fleet.snapshot()
            assert list(snap["checkpoints_served"]) == [f"{want}@1"]
            x = np.random.RandomState(0).rand(2, 4).astype(np.float32)
            ref = good.output(x).numpy()
            for h in handles:
                req = urllib.request.Request(
                    f"{h.url}/predict",
                    data=json.dumps({"inputs": x.tolist()}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30) as r:
                    out_p = json.loads(r.read())["outputs"]
                np.testing.assert_allclose(np.asarray(out_p), ref,
                                           atol=1e-5)
        finally:
            _close(fleet, handles, ctrl)

    def test_probe_failure_rolls_back(self, tmp_path):
        """A canary that reloads but fails the validation probe rolls
        back: the fleet's all-or-nothing reload plus the controller's
        quarantine verdict."""
        ck_dir = str(tmp_path / "ck")
        _save(ck_dir, _trained_net(), 1)
        boot_dir = str(tmp_path / "boot")
        _save(boot_dir, _net(), 0)
        handles, fleet = _fleet(_net(), boot_dir, n=2)
        # the probe's feature width is wrong -> the canary's /predict
        # validation 400s after a successful reload
        ctrl = _controller(ck_dir, fleet=fleet,
                           probe={"inputs": [[1.0, 2.0]]},
                           poll_interval=0.01, name="probe")
        try:
            out = ctrl.run_once()
            assert out["promoted"] is False and out["rolled_back"]
            assert ctrl.champion is None
            assert "1" in ctrl.quarantined
            assert fleet.snapshot()["reloads"]["rolled_back"] == 1
            want_key = f"{boot_dir}@0"
            assert list(fleet.snapshot()["checkpoints_served"]) \
                == [want_key]
        finally:
            _close(fleet, handles, ctrl)


class TestRouterDriven:
    def test_promote_and_quarantine_over_http(self, tmp_path):
        """The fleet_url lane: the controller drives POST /reload on a
        live router, 200 promotes, 409 (canary failure) quarantines;
        the router's /stats aggregates per-replica identity."""
        ck_dir = str(tmp_path / "ck")
        _save(ck_dir, _trained_net(), 1)
        boot_dir = str(tmp_path / "boot")
        _save(boot_dir, _net(), 0)
        handles, fleet = _fleet(_net(), boot_dir, n=2)
        try:
            with serve_fleet(fleet) as router:
                ctrl = _controller(ck_dir, fleet_url=router.url,
                                   poll_interval=0.01, name="http")
                out = ctrl.run_once()
                assert out == {"action": "promote", "promoted": True,
                               "step": 1}
                want = os.path.abspath(ck_dir)
                stats = _get(f"{router.url}/stats")["fleet"]
                assert list(stats["checkpoints_served"]) == [f"{want}@1"]
                _save(ck_dir, _net(hidden=16), 2)
                out = ctrl.run_once()
                assert out["promoted"] is False and out["rolled_back"]
                assert ctrl.champion["step"] == 1
                assert "2" in ctrl.quarantined
                ctrl.close()
        finally:
            _close(fleet, handles)

    def test_unreachable_fleet_leaves_candidate_pending(self, tmp_path):
        """Infra failure is NOT a verdict: an unreachable router leaves
        the candidate pending (no quarantine)."""
        ck_dir = str(tmp_path / "ck")
        _save(ck_dir, _trained_net(), 1)
        ctrl = _controller(ck_dir, fleet_url="http://127.0.0.1:9",
                           poll_interval=0.01, request_timeout=0.5,
                           name="pending")
        try:
            out = ctrl.run_once()
            assert out["promoted"] is False and out.get("pending")
            assert ctrl.quarantined == {}
            assert ctrl.champion is None
            assert ctrl.phase == "idle"
        finally:
            ctrl.close()


class _StubFleet:
    """In-memory stand-in recording which checkpoint the 'fleet'
    serves — the chaos matrix only needs reload semantics, not HTTP.
    With `boot_shapes` (leaf -> shape of the served network) a step
    whose manifest lays out other shapes fails its canary definitively,
    as a replica's /reload of another architecture does; the check
    reads the manifest's JSON only, so one stub serves both packages'
    controllers."""

    label = "stub"

    def __init__(self, boot=("boot", 0), boot_shapes=None):
        self.current = boot
        self.reloads = []
        self.fail_next = None  # None | "definitive" | "infra"
        self.boot_shapes = boot_shapes

    def rolling_reload(self, path, step=None, rollback_path=None,
                       rollback_step=None, probe=None, **kw):
        from deeplearning4j_tpu_torch.serving.fleet import NoReadyReplicas

        self.reloads.append((path, step))
        if self.fail_next == "infra":
            self.fail_next = None
            raise NoReadyReplicas("stub: nobody home")
        if self.fail_next == "definitive":
            self.fail_next = None
            return {"reloaded": False, "canary": True,
                    "error": {"stage": "probe"}, "rolled_back": []}
        if self.boot_shapes is not None \
                and _param_shapes(path, step) != self.boot_shapes:
            return {"reloaded": False, "canary": True,
                    "error": {"stage": "reload",
                              "error": "architecture mismatch"},
                    "rolled_back": []}
        self.current = (path, step)
        return {"reloaded": True, "replicas": ["r0"]}


def _param_shapes(root, step) -> dict:
    with open(os.path.join(root, ckfmt.step_dir_name(step),
                           ckfmt.MANIFEST)) as f:
        leaves = json.load(f)["leaves"]
    return {k: v["shape"] for k, v in leaves.items()
            if k.startswith("params")}


def _commit_step(ck_dir, step):
    _save(ck_dir, _net(), step)


class TestCrashConsistency:
    def test_double_start_lock(self, tmp_path):
        ck_dir = str(tmp_path / "ck")
        _commit_step(ck_dir, 1)
        state = str(tmp_path / "state")
        ctrl = _controller(ck_dir, fleet=_StubFleet(), state_dir=state,
                           name="lock")
        try:
            with pytest.raises(ControllerBusy):
                _controller(ck_dir, fleet=_StubFleet(), state_dir=state,
                            name="lock2")
        finally:
            ctrl.close(release=True)
        # a released journal admits a successor, which adopts the state
        ctrl2 = _controller(ck_dir, fleet=_StubFleet(), state_dir=state,
                            name="lock3")
        assert ctrl2.incarnation == 1
        ctrl2.close()

    def _dead_owner_journal(self, ctrl, **overrides):
        """Re-write the journal as a DEAD prior incarnation left it —
        the kill -9 drill without killing the test process."""
        state = ctrl.journal.read()
        state["owner"] = {"pid": 2 ** 30, "start_time": 1.0}
        state.update(overrides)
        ctrl.journal.write(state)

    def test_kill_mid_promotion_resumes_to_promoted(self, tmp_path):
        """A controller that died between journaling CANARY and the
        fleet verdict re-drives the (idempotent) reload on restart and
        lands promoted — never torn."""
        ck_dir = str(tmp_path / "ck")
        _commit_step(ck_dir, 1)
        state = str(tmp_path / "state")
        stub = _StubFleet()
        ctrl = _controller(ck_dir, fleet=stub, state_dir=state,
                           name="kill")
        self._dead_owner_journal(
            ctrl, phase=CANARY,
            candidate={"path": os.path.abspath(ck_dir), "step": 1,
                       "metrics": None})
        ctrl.close(release=False)
        ctrl2 = _controller(ck_dir, fleet=stub, state_dir=state,
                            name="kill")
        try:
            assert ctrl2.incarnation == 1
            assert ctrl2.phase == CANARY  # journaled decision adopted
            out = ctrl2.run_once()
            assert out["promoted"] and out["step"] == 1
            assert stub.current == (os.path.abspath(ck_dir), 1)
            assert ctrl2.champion["step"] == 1
            assert ctrl2.status()["counters"]["promotions"] == 1
        finally:
            ctrl2.close()

    def test_kill_mid_rollback_reasserts_champion(self, tmp_path):
        """Dying inside ROLLING_BACK: the failure verdict was already
        decided — the restart re-asserts the champion on the fleet and
        finishes the quarantine."""
        ck_dir = str(tmp_path / "ck")
        _commit_step(ck_dir, 1)
        _commit_step(ck_dir, 2)
        state = str(tmp_path / "state")
        stub = _StubFleet()
        ctrl = _controller(ck_dir, fleet=stub, state_dir=state, name="rb")
        champ = {"path": os.path.abspath(ck_dir), "step": 1,
                 "metrics": None}
        self._dead_owner_journal(
            ctrl, phase=ROLLING_BACK, champion=champ,
            candidate={"path": os.path.abspath(ck_dir), "step": 2,
                       "metrics": None})
        ctrl.close(release=False)
        ctrl2 = _controller(ck_dir, fleet=stub, state_dir=state, name="rb")
        try:
            out = ctrl2.run_once()
            assert out == {"action": "resume_rollback", "step": 2}
            assert stub.current == (os.path.abspath(ck_dir), 1)
            assert "2" in ctrl2.quarantined
            assert ctrl2.champion["step"] == 1
            assert ctrl2.run_once() == {"action": "idle"}
        finally:
            ctrl2.close()


@pytest.mark.chaos
class TestChaosMatrix:
    """Fault at every pipeline injection point: the journal stays
    readable, the (stub) fleet is on exactly one of {old, new}
    champion, and once chaos lifts the conveyor converges."""

    POINTS = ("pipeline.watch", "pipeline.eval", "pipeline.promote")

    def _run(self, tmp_path, rules, cycles=6, eval_data=None):
        ck_dir = str(tmp_path / "ck")
        _save(ck_dir, _trained_net(), 1)
        stub = _StubFleet()
        chaos.configure(rules)
        try:
            ctrl = _controller(
                ck_dir, fleet=stub, eval_data=eval_data,
                eval_threshold=0.6, state_dir=str(tmp_path / "state"),
                poll_interval=0.01, name="matrix")
            for _ in range(cycles):
                ctrl.run_once()
        finally:
            chaos.deactivate()
        return ck_dir, stub, ctrl

    @pytest.mark.parametrize("point",
                             ("pipeline.watch", "pipeline.eval",
                              "pipeline.promote"))
    def test_fault_then_converge(self, tmp_path, point):
        csv = _holdout_csv(tmp_path)
        ck_dir, stub, ctrl = self._run(
            tmp_path, [chaos.Rule(point, "error", times=2)],
            eval_data=csv)
        try:
            assert ctrl.champion and ctrl.champion["step"] == 1
            assert stub.current == (os.path.abspath(ck_dir), 1)
            assert ctrl.quarantined == {}  # infra faults never verdict
            journal = ctrl.journal.read()
            assert journal and not ctrl.journal.torn
            assert journal["champion"]["step"] == 1
        finally:
            ctrl.close()

    @pytest.mark.parametrize("ordinal", list(range(6)))
    def test_journal_write_faults_never_tear_state(self, tmp_path,
                                                   ordinal):
        """A failed journal write at ANY ordinal (write or rename leg)
        degrades to the previous committed state — never a torn file,
        and a successor adopts a consistent champion."""
        csv = _holdout_csv(tmp_path)
        ck_dir, stub, ctrl = self._run(
            tmp_path,
            [chaos.Rule("controller.journal", "error", at=[ordinal])],
            eval_data=csv)
        ctrl.close(release=False)
        assert stub.current == (os.path.abspath(ck_dir), 1)
        journal = ctrl.journal.read()
        assert not ctrl.journal.torn
        if journal is not None:
            assert journal.get("champion") is None \
                or journal["champion"]["step"] == 1
            journal["owner"] = {"pid": 2 ** 30, "start_time": 1.0}
            ctrl.journal.write(journal)
        self_stub = _StubFleet()
        ctrl2 = _controller(
            ck_dir, fleet=self_stub, eval_data=csv, eval_threshold=0.6,
            state_dir=str(tmp_path / "state"), name="matrix")
        try:
            for _ in range(3):
                ctrl2.run_once()
            assert ctrl2.champion["step"] == 1
        finally:
            ctrl2.close()


class TestAdmissionConvergence:
    def test_newcomer_converges_to_champion_before_admission(
            self, tmp_path):
        """A replica joining AFTER a promotion must enter rotation on
        the promoted champion, not whatever it booted with."""
        good = _trained_net()
        ck_dir = str(tmp_path / "ck")
        _save(ck_dir, good, 1)
        boot_dir = str(tmp_path / "boot")
        _save(boot_dir, _net(), 0)
        handles, fleet = _fleet(_net(), boot_dir, n=2)
        ctrl = _controller(ck_dir, fleet=fleet, poll_interval=0.01,
                           name="join")
        late = None
        try:
            assert ctrl.run_once()["promoted"]
            assert fleet.current_step == 1
            late = _replica(_net(), boot_dir, 0)
            fleet.attach(late.url)
            _poll_until_ready(fleet, 3)
            want = os.path.abspath(ck_dir)
            snap = fleet.snapshot()
            assert list(snap["checkpoints_served"]) == [f"{want}@1"]
            assert len(snap["checkpoints_served"][f"{want}@1"]) == 3
        finally:
            if late is not None:
                late.close()
            _close(fleet, handles, ctrl)

    def test_fleet_without_promotion_admits_heterogeneous_replicas(
            self, tmp_path):
        """Before any rolling_reload pins current_step, admission must
        NOT rewrite what attached replicas serve."""
        boot_dir = str(tmp_path / "boot")
        _save(boot_dir, _net(), 0)
        other_dir = str(tmp_path / "other")
        _save(other_dir, _net(), 5)
        h1 = _replica(_net(), boot_dir, 0)
        h2 = _replica(_net(), other_dir, 5)
        fleet = Fleet(start=False, heartbeat_timeout=10.0,
                      initial_checkpoint=boot_dir)
        try:
            fleet.attach(h1.url)
            fleet.attach(h2.url)
            _poll_until_ready(fleet, 2)
            assert fleet.current_step is None
            assert len(fleet.snapshot()["checkpoints_served"]) == 2
        finally:
            fleet.close()
            h1.close()
            h2.close()


class TestWatcherRaces:
    def test_list_committed_steps_races_rotating_writer(self, tmp_path):
        """The watcher's scan vs the async writer's rotation (prune
        after every commit). Steps vanish mid-listdir; the scan and
        discover_latest must skip them, never raise."""
        root = str(tmp_path / "ck")
        net = _net()
        errors = []
        stop = threading.Event()

        def scan():
            while not stop.is_set():
                try:
                    steps = list_committed_steps(root)
                    assert steps == sorted(steps)
                    if steps:
                        _, latest = discover_latest(root)
                        assert latest >= steps[0]
                except Exception as e:  # noqa: BLE001
                    errors.append(repr(e))
                    return

        threads = [threading.Thread(target=scan, daemon=True)
                   for _ in range(3)]
        for t in threads:
            t.start()
        with ShardedModelSaver(root, keep=2) as s:
            for step in range(1, 40):
                s.save(net, step=step, wait=True)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert errors == []
        assert list_committed_steps(root) == [38, 39]
        assert discover_latest(root) == (root, 39)

    def test_discover_latest_skips_deleted_step(self, tmp_path):
        """A step dir whose manifest vanished between listing and read
        (GC race) falls back to the next-older committed step."""
        root = str(tmp_path / "ck")
        with ShardedModelSaver(root) as s:
            s.save(_net(), step=1)
            s.save(_net(), step=2)
        os.unlink(os.path.join(root, ckfmt.step_dir_name(2),
                               ckfmt.MANIFEST))
        assert list_committed_steps(root) == [1]
        assert discover_latest(root) == (root, 1)


class TestCliSurface:
    def test_cli_eval_json(self, tmp_path, capsys):
        from deeplearning4j_tpu_torch.cli import main

        ck_dir = str(tmp_path / "ck")
        _save(ck_dir, _trained_net(), 3)
        csv = _holdout_csv(tmp_path)
        rc = main(["eval", "-m", ck_dir, "--data", csv, "--json",
                   "--device", "cpu"])
        assert rc == 0
        out = json.loads(capsys.readouterr().out.strip())
        assert set(out) >= {"f1", "accuracy", "precision", "recall",
                            "n", "path", "step", "eval_seconds"}
        assert out["step"] == 3
        assert out["f1"] >= 0.8

    def test_cli_pipeline_smoke_and_arg_validation(self, tmp_path,
                                                   capsys):
        from deeplearning4j_tpu.cli import main as jmain
        from deeplearning4j_tpu_torch.cli import main

        ck_dir = str(tmp_path / "ck")
        _commit_step(ck_dir, 1)
        # exactly one of --fleet-url / --spawn-fleet
        assert main(["pipeline", "--checkpoint-dir", ck_dir,
                     "--device", "cpu"]) == 2
        assert main(["pipeline", "--checkpoint-dir", ck_dir,
                     "--spawn-fleet", "--device", "cpu"]) == 2
        capsys.readouterr()
        argv = ["pipeline", "--checkpoint-dir", ck_dir,
                "--fleet-url", "http://127.0.0.1:9",
                "--status-port", "0", "--smoke"]
        rc = main(argv + ["--state-dir", str(tmp_path / "state"),
                          "--device", "cpu"])
        assert rc == 0
        announce = json.loads(capsys.readouterr().out.splitlines()[0])
        assert announce["checkpoint_dir"] == os.path.abspath(ck_dir)
        assert announce["fleet"] == "http://127.0.0.1:9"
        assert announce["status"].startswith("http://")
        assert json.load(open(os.path.join(
            str(tmp_path / "state"), "controller.journal")))["owner"] \
            is None
        # the JAX CLI's announce line has the same keys
        assert jmain(argv + ["--state-dir", str(tmp_path / "jstate")]) == 0
        jannounce = json.loads(capsys.readouterr().out.splitlines()[0])
        assert sorted(announce) == sorted(jannounce)

    def test_cli_pipeline_exits_3_while_a_live_controller_owns_the_journal(
            self, tmp_path, capsys):
        """The double-start lock through the CLI: a live owner of the
        state dir's journal makes `cli pipeline` exit 3, as the JAX CLI
        does; with `--metrics-port 0` a free run announces the metrics
        URL beside the JAX keys."""
        from deeplearning4j_tpu_torch.cli import main

        ck_dir = str(tmp_path / "ck")
        _commit_step(ck_dir, 1)
        state = str(tmp_path / "state")
        argv = ["pipeline", "--checkpoint-dir", ck_dir, "--fleet-url",
                "http://127.0.0.1:9", "--state-dir", state, "--smoke",
                "--device", "cpu"]
        owner = _controller(ck_dir, fleet=_StubFleet(), state_dir=state,
                            name="owner")
        try:
            assert main(argv) == 3
            assert "already running" in capsys.readouterr().err
        finally:
            owner.close()
        assert main(argv + ["--metrics-port", "0"]) == 0
        announce = json.loads(capsys.readouterr().out.splitlines()[0])
        assert announce["metrics"].endswith("/metrics")
        assert announce["incarnation"] == 1

    def test_cli_pipeline_refuses_the_compile_cache_and_no_card(
            self, tmp_path, capsys):
        """`--compile-cache` (refused until the program store came) is
        taken: `auto` next to a checkpoint dir that does not exist is a
        no-op, a path activates the store for the replicas the
        controller spawns; `--device cuda` without a card exits 2 before
        anything runs."""
        from deeplearning4j_tpu_torch import compilecache as cc
        from deeplearning4j_tpu_torch.cli import main

        ck_dir = str(tmp_path / "ck")
        base = ["pipeline", "--checkpoint-dir", ck_dir, "--fleet-url",
                "http://127.0.0.1:9", "--smoke"]
        cc.deactivate()
        try:
            assert main(base + ["--compile-cache", "auto", "--device",
                                "cpu"]) == 0
            assert cc.active_dir() is None
            cache = str(tmp_path / "cache")
            assert main(base + ["--compile-cache", cache, "--device",
                                "cpu"]) == 0
            assert cc.active_dir() == cache
            assert os.environ[cc.CACHE_ENV] == cache
        finally:
            cc.deactivate()
        capsys.readouterr()
        if not __import__("torch").cuda.is_available():
            assert main(base) == 2
            assert "no CUDA device" in capsys.readouterr().err
        assert not os.path.exists(ck_dir)

    def test_cli_pipeline_spawn_fleet_promotes_a_committed_step(
            self, tmp_path, capsys):
        """`--spawn-fleet` spawns `cli serve --device cpu` replicas
        behind a router, promotes the committed step through them within
        `--cycles`, and leaves no replica running (no --state-dir, so
        stopping the pipeline stops its fleet)."""
        from deeplearning4j_tpu_torch.cli import main
        from deeplearning4j_tpu_torch.scaleout.checkpoint import \
            DefaultModelSaver

        ck_dir = str(tmp_path / "ck")
        _save(ck_dir, _trained_net(), 4)
        init = str(tmp_path / "init.ckpt")
        DefaultModelSaver(init).save(_net())
        csv = _holdout_csv(tmp_path)
        rc = main(["pipeline", "--checkpoint-dir", ck_dir,
                   "--spawn-fleet", "-m", init, "--replicas", "1",
                   "--device", "cpu", "--eval-data", csv,
                   "--eval-threshold", "0.6", "--poll-interval", "0.05",
                   "--cycles", "2", "--name", "spawned"])
        assert rc == 0
        announce = json.loads(capsys.readouterr().out.splitlines()[0])
        assert announce["fleet"].startswith("http://")
        from deeplearning4j_tpu_torch import telemetry

        promos = telemetry.get_registry().counter(
            "dl4j_pipeline_promotions").labels(pipeline="spawned").value
        assert promos == 1


# ============================================================ JAX parity
def _parity_steps(root):
    """Port-written steps 1-4: a trained net, the same with its output
    layer negated (passes nothing), a newer (longer trained) net, and a
    trained net of another hidden width (passes the gate, fails the
    canary)."""
    good = _trained_net()
    poisoned = good.clone()
    poisoned.param_table["1"]["W"].data.neg_()
    newer = _trained_net(epochs=60)
    other = _trained_net(hidden=16)
    with ShardedModelSaver(root, keep=4) as s:
        for step, net in enumerate((good, poisoned, newer, other), 1):
            s.save(net, step=step)
    return _param_shapes(root, 1)


def _drive_conveyor(cls, staging, root, csv, boot_shapes, **kw):
    """Copy staging's steps into `root` one by one, one cycle each, then
    one more: (outcomes, journal phases, champion, quarantined, reasons,
    gate metrics by step)."""
    os.makedirs(root)
    stub = _StubFleet(boot_shapes=boot_shapes)
    ctrl = cls(root, fleet=stub, eval_data=csv, eval_threshold=0.6,
               regression_margin=0.05, poll_interval=0.01,
               state_dir=root + "_state", name="parity", **kw)
    phases = []
    write = ctrl._journal_write

    def record():
        phases.append(ctrl.phase)
        write()

    ctrl._journal_write = record
    outcomes = []
    try:
        for step in (1, 2, 3, 4):
            name = ckfmt.step_dir_name(step)
            shutil.copytree(os.path.join(staging, name),
                            os.path.join(root, name))
            outcomes.append(ctrl.run_once())
        outcomes.append(ctrl.run_once())
        metrics = {"champion": ctrl.champion["metrics"]}
        for step in ctrl.quarantined:
            with open(os.path.join(root, ckfmt.step_dir_name(int(step)),
                                   QUARANTINE_MARKER)) as f:
                metrics[step] = json.load(f)["metrics"]
        return (outcomes, phases, ctrl.champion["step"],
                sorted(ctrl.quarantined),
                {k: v.split(":")[0] for k, v in ctrl.quarantined.items()},
                metrics, stub.reloads)
    finally:
        ctrl.close()


GATE_KEYS = ("f1", "accuracy", "precision", "recall", "n", "step")


class TestParityWithJax:
    def test_both_controllers_reach_the_same_verdicts(self, tmp_path):
        staging = str(tmp_path / "staging")
        boot_shapes = _parity_steps(staging)
        csv = _holdout_csv(tmp_path)
        ours = _drive_conveyor(DeploymentController, staging,
                               str(tmp_path / "port"), csv, boot_shapes,
                               device="cpu")
        theirs = _drive_conveyor(JController, staging,
                                 str(tmp_path / "jax"), csv, boot_shapes)
        assert ours[0] == theirs[0]
        assert [o.get("step") for o in ours[0]] == [1, 2, 3, 4, None]
        assert ours[1] == theirs[1]  # the journal's phase sequence
        assert ours[2] == theirs[2] == 3  # the newest good step
        assert ours[3] == theirs[3] == ["2", "4"]
        assert ours[4] == theirs[4] == {"2": "eval_gate",
                                        "4": "canary"}
        for key in ours[5]:
            if ours[5][key] is None:
                assert theirs[5][key] is None
                continue
            got = {k: ours[5][key][k] for k in GATE_KEYS}
            want = {k: theirs[5][key][k] for k in GATE_KEYS}
            assert got == want, key
        # the canary candidate passed the gate; the poisoned one did not
        assert ours[5]["4"] is not None and ours[5]["4"]["f1"] >= 0.6
        assert ours[5]["2"]["f1"] < 0.6
        assert [s for _, s in ours[6]] == [s for _, s in theirs[6]] \
            == [1, 3, 4]

    @pytest.mark.parametrize("case", ["pruned_mid_eval", "holdout_width"])
    def test_an_eval_that_cannot_run_leaves_the_step_pending(
            self, tmp_path, case):
        """The gate's exception tuple in both packages: a step whose
        shard files vanish between the scan and the eval (the writer's
        rotation), and a held-out file of another feature width, raise
        an exception of the tuple (OSError, ValueError): no verdict, no
        quarantine, the candidate retried next poll."""
        root = str(tmp_path / "ck")
        _save(root, _trained_net(), 1)
        if case == "holdout_width":
            x, labels = _dataset(16, seed=7)
            csv = str(tmp_path / "wide.csv")
            np.savetxt(csv, np.hstack([x, x[:, :1], labels[:, None]]),
                       delimiter=",")
        else:
            csv = _holdout_csv(tmp_path)
        for cls, kw in ((DeploymentController, {"device": "cpu"}),
                        (JController, {})):
            ctrl = cls(root, fleet=_StubFleet(), eval_data=csv,
                       eval_threshold=0.6, name=f"pending-{case}", **kw)
            try:
                cand = ctrl._scan()
                assert cand["step"] == 1
                if case == "pruned_mid_eval":
                    step_dir = os.path.join(root, ckfmt.step_dir_name(1))
                    saved = str(tmp_path / "saved")
                    shutil.copytree(step_dir, saved)
                    for name in os.listdir(step_dir):
                        if name.endswith(".npy"):
                            os.unlink(os.path.join(step_dir, name))
                assert ctrl._gate(cand) is None
                assert ctrl.quarantined == {}
                assert ctrl.phase == "idle" and ctrl.candidate is None
                assert not os.path.exists(os.path.join(
                    root, ckfmt.step_dir_name(1), QUARANTINE_MARKER))
                if case == "pruned_mid_eval":
                    shutil.rmtree(step_dir)
                    shutil.copytree(saved, step_dir)
                    shutil.rmtree(saved)
            finally:
                ctrl.close()

    def test_torn_commit_is_never_offered(self, tmp_path):
        """A `checkpoint.rename` fault at the COMMITTED publish (the
        second rename of a save) leaves the step's manifest without its
        marker: the watcher never offers it, and once the fault is gone
        the next save of that step commits and promotes."""
        root = str(tmp_path / "ck")
        stub = _StubFleet()
        _save(root, _trained_net(), 1)
        ctrl = _controller(root, fleet=stub, name="torn")
        try:
            assert ctrl.run_once()["promoted"]
            saver = ShardedModelSaver(root)
            chaos.configure([chaos.Rule("checkpoint.rename", "error",
                                        at=[1])])
            try:
                with pytest.raises(chaos.ChaosError):
                    saver.save(_trained_net(), step=2, wait=True)
            finally:
                chaos.deactivate()
            with pytest.raises(RuntimeError, match="chaos"):
                saver.close()  # the writer relays the fault once
            saver.close()
            step_dir = os.path.join(root, ckfmt.step_dir_name(2))
            assert os.path.exists(os.path.join(step_dir, ckfmt.MANIFEST))
            assert not os.path.exists(os.path.join(step_dir, ckfmt.MARKER))
            assert list_committed_steps(root) == [1]
            assert ctrl.run_once() == {"action": "idle"}
            assert stub.reloads == [(os.path.abspath(root), 1)]
            _save(root, _trained_net(), 2)
            out = ctrl.run_once()
            assert out == {"action": "promote", "promoted": True,
                           "step": 2}
        finally:
            ctrl.close()
