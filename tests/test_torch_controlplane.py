"""The PyTorch port's crash-safe training control plane held against the
JAX package's contract, on the CPU: the supervisor half of
tests/test_controlplane.py (`TestSupervisorCrashSafety`,
`TestRealSigkillDrills`, @slow as there). The journal, process and fleet
halves are mirrored in tests/test_torch_fleet.py; `TestWatchdogCLI` in
tests/test_torch_elastic_cli.py.

The in-process twin of SIGKILLing the supervisor poisons its tick after
two waves; the next incarnation reads the journal and re-adopts the
surviving worker processes (`python -m
deeplearning4j_tpu_torch.scaleout.worker`, performer device "cpu").

Timing: the JAX torn-journal drill lets the strays of the crashed
incarnation rejoin whenever their reconnect backoff says, and under load
one could miss the restarted run entirely and outlive the test. Here the
restarted incarnation spawns its fresh pool first and the test waits
(bounded) until every stray has been adopted or killed before the run
starts, so each stray is judged against a whole pool on every schedule.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu_torch.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.datasets.iris import load_iris
from deeplearning4j_tpu_torch.scaleout.api import CollectionJobIterator
from deeplearning4j_tpu_torch.scaleout.registry import ConfigRegistry
from deeplearning4j_tpu_torch.scaleout.supervisor import (TrainingSupervisor,
                                                          WorkerSpawner)
from deeplearning4j_tpu_torch.testing import chaos
from deeplearning4j_tpu_torch.utils import procs

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERFORMER = "deeplearning4j_tpu_torch.scaleout.perform.NeuralNetWorkPerformer"


def _conf_json():
    return (NeuralNetConfiguration.builder()
            .lr(0.1).n_in(4).activation_function("tanh")
            .optimization_algo("iteration_gradient_descent")
            .num_iterations(2).use_adagrad(False).momentum(0.0)
            .list(2).hidden_layer_sizes([8])
            .override(1, layer="output", loss_function="mcxent",
                      activation_function="softmax", n_out=3)
            .pretrain(False).build().to_json())


def _jobs(n=6, bs=24, seed=0):
    x, y = load_iris()
    x, y = np.asarray(x), np.asarray(y)
    rng = np.random.RandomState(seed)
    return [DataSet(x[i], y[i])
            for i in (rng.choice(len(x), bs, replace=False)
                      for _ in range(n))]


def _supervisor(tmp_path, run_name, jobs, **kw):
    cj = _conf_json()
    registry_root = str(tmp_path / f"reg_{run_name}")
    kw.setdefault("heartbeat_timeout", 3.0)
    kw.setdefault("progress_timeout", 90.0)
    return TrainingSupervisor(
        CollectionJobIterator(list(jobs)), run_name=run_name,
        registry=ConfigRegistry(registry_root),
        performer_class=PERFORMER,
        performer_conf={"conf_json": cj, "epochs": 1, "device": "cpu"},
        n_workers=2, conf_json=cj,
        spawner=WorkerSpawner(registry_root, run_name,
                              reconnect_grace=120.0), **kw)


class _ControlPlaneCrash(RuntimeError):
    """The injected 'supervisor process died' for in-process drills."""


def _crash_after_waves(sup, waves):
    orig = sup._tick

    def tick():
        if sup.waves >= waves:
            raise _ControlPlaneCrash(f"crashed at wave {sup.waves}")
        orig()

    sup._tick = tick


def _live_pids(sup):
    out = {}
    for wid, rec in sup.members.items():
        if rec.proc is not None and rec.proc.poll() is None:
            out[wid] = rec.proc.pid
    return out


@pytest.mark.elastic
class TestSupervisorCrashSafety:
    def test_restart_adopts_warm_and_completes_bit_identical(
            self, tmp_path):
        """Crash the control plane after two waves; the next incarnation
        re-adopts BOTH surviving worker processes (same pids, zero
        respawns), the workers reconnect and re-announce, the run
        restores from the last COMMITTED checkpoint, and the completed
        params are BIT-IDENTICAL to an uninterrupted run, with
        folded_seqs tiling the stream exactly once."""
        jobs = _jobs(6)
        ref = _supervisor(tmp_path, "cpref", jobs).run(timeout=240.0)

        state = str(tmp_path / "state")
        ck = str(tmp_path / "ck")
        a = _supervisor(tmp_path, "cprun", jobs, state_dir=state,
                        checkpoint_dir=ck)
        _crash_after_waves(a, 2)
        with pytest.raises(_ControlPlaneCrash):
            a.run(timeout=240.0)
        pids_a = {wid: rec.proc.pid for wid, rec in a.members.items()
                  if rec.proc is not None}
        journal = a.journal.read()
        assert journal is not None and journal["workers"], \
            "handoff never journaled the surviving workers"
        for rec in a.members.values():
            assert rec.proc not in procs.SPAWNED_PROCS

        b = _supervisor(tmp_path, "cprun", jobs, state_dir=state,
                        checkpoint_dir=ck)
        assert b.incarnation == 1
        adopted = [e for e in b.adoption_events
                   if e["kind"] == "adopted"]
        assert len(adopted) == 2, b.adoption_events
        assert {e["pid"] for e in adopted} == set(pids_a.values())
        final = b.run(timeout=240.0)
        assert b.respawns_used == 0, "a live pid was respawned"
        assert sorted(b.folded_seqs) == list(range(len(jobs)))
        np.testing.assert_array_equal(ref, final)
        assert b.journal.read() is None, \
            "clean finish must clear the journal"
        assert any(r.adopted for r in b.members.values())

    def test_stale_journal_from_faulted_writes_still_recovers(
            self, tmp_path):
        jobs = _jobs(6)
        state = str(tmp_path / "state")
        ck = str(tmp_path / "ck")
        a = _supervisor(tmp_path, "stalerun", jobs, state_dir=state,
                        checkpoint_dir=ck)
        _crash_after_waves(a, 2)
        chaos.configure([chaos.Rule("supervisor.journal", "error",
                                    after=4)])
        try:
            with pytest.raises(_ControlPlaneCrash):
                a.run(timeout=240.0)
        finally:
            chaos.deactivate()
        journal = a.journal.read()
        assert journal is not None, "the early commits must survive"

        b = _supervisor(tmp_path, "stalerun", jobs, state_dir=state,
                        checkpoint_dir=ck)
        final = b.run(timeout=240.0)
        assert final is not None
        assert sorted(b.folded_seqs) == list(range(len(jobs)))
        pids = [e["pid"] for e in b.adoption_events
                if e["kind"] == "adopted"]
        assert len(pids) == len(set(pids))

    def test_torn_journal_falls_back_and_never_leaks_strays(
            self, tmp_path):
        jobs = _jobs(6)
        state = str(tmp_path / "state")
        ck = str(tmp_path / "ck")
        a = _supervisor(tmp_path, "tornrun", jobs, state_dir=state,
                        checkpoint_dir=ck)
        _crash_after_waves(a, 2)
        with pytest.raises(_ControlPlaneCrash):
            a.run(timeout=240.0)
        survivors = _live_pids(a)
        assert survivors, "drill needs surviving workers"
        with open(a.journal.path, "w") as f:
            f.write('{"incarnation": 0, "workers": {"w0"')  # torn

        b = _supervisor(tmp_path, "tornrun", jobs, state_dir=state,
                        checkpoint_dir=ck, heartbeat_timeout=2.0)
        assert b.incarnation == 1
        assert not [e for e in b.adoption_events
                    if e["kind"] == "adopted"]
        # the fresh pool first, then every stray judged against it
        b.spawn_workers()
        judged = lambda: {e["pid"] for e in b.adoption_events  # noqa: E731
                          if e["kind"] in ("stray", "killed_stale")}
        deadline = time.monotonic() + 120.0
        while (not set(survivors.values()) <= judged()
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert set(survivors.values()) <= judged(), b.adoption_events
        final = b.run(timeout=240.0)
        assert final is not None
        assert sorted(b.folded_seqs) == list(range(len(jobs)))
        fresh = [wid for wid, rec in b.members.items()
                 if not rec.adopted]
        assert fresh and all("_i1" in wid for wid in fresh), fresh
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            leaked = {w: p for w, p in survivors.items()
                      if procs.pid_matches(p, None)}
            if not leaked:
                break
            time.sleep(0.1)
        assert not leaked, f"stray workers leaked: {leaked}"


def _iris_csv(tmp_path):
    x, y = load_iris()
    data = np.hstack([np.asarray(x),
                      np.argmax(np.asarray(y), axis=1)[:, None]])
    csv = str(tmp_path / "iris.csv")
    np.savetxt(csv, data, delimiter=",", fmt="%.6f")
    conf = str(tmp_path / "conf.json")
    with open(conf, "w") as f:
        f.write(_conf_json())
    return csv, conf


@pytest.mark.slow
@pytest.mark.elastic
class TestRealSigkillDrills:
    def test_sigkill_supervisor_under_watchdog_completes(self,
                                                         tmp_path):
        """`cli watchdog -- train --elastic 2 --state-dir ... --device
        cpu`, SIGKILL the supervisor process mid-run, and require the
        watchdog's next incarnation to re-adopt the surviving workers
        and finish the run (summary reports adopted>0,
        incarnation>0)."""
        csv, conf = _iris_csv(tmp_path)
        state = str(tmp_path / "state")
        ck = str(tmp_path / "ck")
        out_path = str(tmp_path / "model.ckpt")
        proc = subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.cli",
             "watchdog", "--max-restarts", "3", "--backoff", "0.2",
             "--", "train", "--elastic", "2", "-i", csv, "-m", conf,
             "-o", out_path, "--batch-size", "8", "--epochs", "6",
             "--state-dir", state, "--checkpoint-dir", ck,
             "--run-timeout", "240", "--device", "cpu"],
            stdout=subprocess.PIPE, text=True, cwd=REPO_ROOT)
        children = []
        killed = []

        def killer():
            from deeplearning4j_tpu_torch.checkpoint.format import \
                list_steps

            deadline = time.time() + 300
            while time.time() < deadline and not killed:
                if children:
                    try:
                        if list_steps(ck):
                            chaos.sigkill(children[0])
                            killed.append(children[0])
                            return
                    except (OSError, ProcessLookupError):
                        return
                time.sleep(0.05)

        threading.Thread(target=killer, daemon=True).start()
        lines = []
        try:
            deadline = time.time() + 420
            for line in proc.stdout:
                lines.append(line)
                if time.time() > deadline:
                    break
                if line.startswith("{"):
                    try:
                        e = json.loads(line)
                    except ValueError:
                        continue
                    if "watchdog_child" in e:
                        children.append(e["watchdog_child"])
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert killed, "never saw a committed step to kill behind"
        assert rc == 0, "".join(lines[-20:])
        assert len(children) >= 2, \
            f"watchdog never restarted the supervisor: {lines}"
        summary = [json.loads(ln) for ln in lines
                   if ln.startswith("{") and '"saved"' in ln][-1]
        assert summary["incarnation"] >= 1
        assert summary["adopted"] >= 1, summary
        assert summary["folded"] == summary["jobs"]
        assert os.path.exists(out_path)
