"""Crash-safe train→serve deployment controller, the counterpart of the
JAX package's `deploy/controller.py` (docs/PIPELINE.md).

The conveyor: watch a checkpoint directory for newly COMMITTED steps
(the atomic-rename marker IS the watch primitive — bounded-interval
polling, no inotify), run an **eval gate** on each candidate (held-out
set through eval/holdout.py, absolute-score and regression-vs-champion
thresholds), then drive the fleet's canary reload (drain → reload →
`/readyz` → validation probe), **promoting** on success and **rolling
back + quarantining** on failure. A `QUARANTINED` marker in the step
dir keeps the watcher from ever re-offering a bad checkpoint; the
reason is journaled.

State machine: IDLE → EVALUATING → CANARY → PROMOTING (→ IDLE) or
→ ROLLING_BACK (→ IDLE). Every transition journals through `StateFile`
(chaos point ``controller.journal``) so a killed controller restarts
into the same decision — a promotion is either fully applied to the
fleet or fully rolled back, never torn:

- killed before CANARY: the candidate is rediscovered by the next scan
  (evaluation is idempotent);
- killed in CANARY/PROMOTING: the restart re-drives the rolling reload
  (itself idempotent — the fleet's own canary/rollback machinery makes
  the outcome all-or-nothing) and lands on the same verdict;
- killed in ROLLING_BACK: the failure verdict was already committed —
  the restart re-asserts the champion on the fleet and quarantines the
  candidate.

Failure policy — the asymmetry that keeps the conveyor honest:
*definitive* verdicts (a gate score below threshold, a canary probe
failure reported by the fleet) quarantine the candidate; *infra*
failures (the fleet unreachable, no ready replicas, a reload already in
flight, an eval that could not run) leave the candidate pending and are
retried next poll — an eval that could not run is NOT a failed eval.
The gate treats exactly the JAX package's exception classes as "could
not run" (`ChaosError`, `CheckpointError`, `OSError`, `ValueError`):
the port's restore path raises those classes in those situations (a
step pruned mid-read: `FileNotFoundError`; a table that does not fit
the conf, or a held-out file of the wrong width: `ValueError`).

Ownership: the journal carries the owner's (pid, /proc start-time)
fingerprint; a second controller pointed at the same journal refuses to
start while the fingerprint classifies as a live owner
(`ControllerBusy`) — the same pid-recycling-safe discipline as the
fleet (utils/procs.py).

Telemetry: ``dl4j_pipeline_candidates_seen``,
``dl4j_pipeline_eval_pass`` / ``_fail``, ``dl4j_pipeline_promotions`` /
``_rollbacks`` / ``_quarantines`` counters, ``dl4j_pipeline_eval_seconds``
+ ``dl4j_pipeline_promote_seconds`` histograms, and the
``dl4j_pipeline_champion_step`` gauge — all labelled ``pipeline=<name>``
— plus the shared ``dl4j_controlplane_*`` journal/restart series
(plane="pipeline"). `status_port=` serves the StatusServer surface
(/status.json with the controller state under "extra", /healthz,
/metrics).

The port adds one argument, `device=`: where the eval gate restores
each candidate (None = the CUDA device, raising without one; the
tests pass "cpu"). Each gate's network lives only inside
`evaluate_checkpoint`, so the controller's allocated device memory is
back to its value before the gate once the gate returns.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
import weakref
from typing import Dict, Optional

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.checkpoint import format as ckfmt
from deeplearning4j_tpu_torch.checkpoint.restore import list_committed_steps
from deeplearning4j_tpu_torch.testing import chaos
from deeplearning4j_tpu_torch.utils import procs
from deeplearning4j_tpu_torch.utils.statefile import (StateFile,
                                                      controlplane_metrics)

__all__ = ["DeploymentController", "ControllerBusy", "QUARANTINE_MARKER",
           "IDLE", "EVALUATING", "CANARY", "PROMOTING", "ROLLING_BACK"]

log = logging.getLogger(__name__)

# controller phases (the journaled state machine)
IDLE = "idle"
EVALUATING = "evaluating"
CANARY = "canary"
PROMOTING = "promoting"
ROLLING_BACK = "rolling_back"

#: marker file dropped in a rejected step dir — the watcher skips any
#: step carrying it, so a bad checkpoint is never re-offered (the
#: negative twin of the COMMITTED marker, same atomic-rename publish)
QUARANTINE_MARKER = "QUARANTINED"

_name_seq = itertools.count()


class ControllerBusy(RuntimeError):
    """Another live controller owns this journal (double-start lock)."""


class DeploymentController:
    """One conveyor: checkpoint_dir → eval gate → fleet canary promote.

    Exactly one of `fleet` (an in-process serving Fleet object) or
    `fleet_url` (a fleet router endpoint, POST /reload) carries the
    promotion. `eval_data` (held-out labelled CSV) arms the eval gate;
    without it candidates skip straight to the canary (the fleet's
    validation `probe` is then the only gate). `state_dir` arms the
    crash-safe journal + double-start lock.
    """

    def __init__(self, checkpoint_dir: str, *,
                 fleet=None, fleet_url: Optional[str] = None,
                 eval_data: Optional[str] = None,
                 eval_via_fleet: bool = False,
                 label_columns: int = 1,
                 metric: str = "f1",
                 eval_threshold: float = 0.0,
                 regression_margin: float = 0.05,
                 poll_interval: float = 2.0,
                 probe: Optional[dict] = None,
                 state_dir: Optional[str] = None,
                 name: Optional[str] = None,
                 status_port: Optional[int] = None,
                 request_timeout: float = 120.0,
                 model_id: Optional[str] = None,
                 device=None):
        if (fleet is None) == (fleet_url is None):
            raise ValueError(
                "DeploymentController needs exactly one of fleet= "
                "(in-process) or fleet_url= (router endpoint)")
        if eval_via_fleet and fleet_url is None:
            raise ValueError(
                "eval_via_fleet scores the LIVE fleet over HTTP and "
                "needs fleet_url= (a router endpoint)")
        self.checkpoint_dir = checkpoint_dir
        self.fleet = fleet
        self.fleet_url = fleet_url.rstrip("/") if fleet_url else None
        self.eval_data = eval_data
        #: refresh the champion's regression baseline from the live
        #: fleet (batch SLO tier — bulk scoring never competes with
        #: interactive admission) instead of trusting the journaled
        #: score: a drifted holdout or a champion reloaded behind the
        #: controller's back would otherwise skew the gate
        self.eval_via_fleet = bool(eval_via_fleet)
        self.label_columns = int(label_columns)
        self.metric = metric
        self.eval_threshold = float(eval_threshold)
        self.regression_margin = float(regression_margin)
        self.poll_interval = float(poll_interval)
        self.probe = probe
        self.request_timeout = float(request_timeout)
        #: scope every reload this conveyor drives to ONE model's
        #: replicas on a multi-model fleet (docs/FLEET.md
        #: "Disaggregated roles"); None drives the whole fleet
        self.model_id = model_id
        #: where the eval gate restores candidates (None = the CUDA device)
        self.device = device
        self.name = name if name is not None else f"p{next(_name_seq)}"

        self.phase = IDLE
        #: current champion {path, step, metrics} — the rollback target
        self.champion: Optional[dict] = None
        #: in-flight candidate {path, step, metrics} while not IDLE
        self.candidate: Optional[dict] = None
        #: {step(str): reason} — quarantined steps this conveyor decided
        self.quarantined: Dict[str, str] = {}
        self.incarnation = 0
        self._seen: set = set()
        self._stop = threading.Event()
        self.started_at = time.time()

        # ----------------------------------------------------- telemetry
        reg = telemetry.get_registry()
        lab = {"pipeline": self.name}
        self._m_seen = reg.counter(
            "dl4j_pipeline_candidates_seen",
            "newly COMMITTED checkpoint steps the watcher offered the "
            "gate").labels(**lab)
        self._m_eval_pass = reg.counter(
            "dl4j_pipeline_eval_pass",
            "candidates that passed the eval gate").labels(**lab)
        self._m_eval_fail = reg.counter(
            "dl4j_pipeline_eval_fail",
            "candidates the eval gate rejected (absolute threshold or "
            "regression vs champion)").labels(**lab)
        self._m_promotions = reg.counter(
            "dl4j_pipeline_promotions",
            "candidates promoted to fleet champion").labels(**lab)
        self._m_rollbacks = reg.counter(
            "dl4j_pipeline_rollbacks",
            "failed canaries rolled back to the champion").labels(**lab)
        self._m_quarantines = reg.counter(
            "dl4j_pipeline_quarantines",
            "checkpoints quarantined (QUARANTINED marker "
            "written)").labels(**lab)
        self._m_eval_s = reg.histogram(
            "dl4j_pipeline_eval_seconds",
            "eval-gate wall time per candidate").labels(**lab)
        self._m_promote_s = reg.histogram(
            "dl4j_pipeline_promote_seconds",
            "canary promote wall time (drive + fleet convergence)"
            ).labels(**lab)
        ref = weakref.ref(self)
        reg.gauge(
            "dl4j_pipeline_champion_step",
            "committed step of the current champion (-1 = none "
            "yet)").labels(**lab).set_function(
            lambda: (lambda o: (o.champion or {}).get("step")
                     if o and o.champion else -1)(ref()))
        self._m_restarts, self._m_adoptions = controlplane_metrics(
            "pipeline", self.name,
            lambda: (lambda o: o.incarnation if o else 0)(ref()),
            kinds=("resumed", "refused"))

        # --------------------------------------- journal + ownership lock
        self.journal: Optional[StateFile] = None
        self._resume_phase: Optional[str] = None
        if state_dir:
            os.makedirs(state_dir, exist_ok=True)
            self.journal = StateFile(
                os.path.join(state_dir, "controller.journal"),
                point="controller.journal", plane="pipeline")
            prior = self.journal.read()
            if prior:
                self._adopt_prior(prior)
        self._journal_write()  # claim ownership (or commit a fresh one)

        # ------------------------------------------------ status endpoint
        self.status_server = None
        if status_port is not None:
            from deeplearning4j_tpu_torch.scaleout.statetracker import \
                InMemoryStateTracker
            from deeplearning4j_tpu_torch.scaleout.status import \
                StatusServer

            self.status_server = StatusServer(
                InMemoryStateTracker(), port=status_port,
                extra=lambda: (lambda o: o.status() if o else {})(ref()),
                health=lambda: (lambda o: {
                    "ok": True, "phase": o.phase,
                    "pipeline": o.name} if o else {"ok": False})(ref()))
            self.status_server.start()

    # ------------------------------------------------- journal / adoption
    def _owner_fingerprint(self) -> dict:
        pid = os.getpid()
        return {"pid": pid, "start_time": procs.proc_start_time(pid)}

    def _adopt_prior(self, prior: dict) -> None:
        """Restart over a prior journal: refuse while its owner still
        lives (double-start lock), else resume its decision state —
        champion, quarantine list, and any promotion in flight."""
        owner = prior.get("owner")
        if owner and owner.get("pid"):
            verdict = procs.classify_pid(owner["pid"],
                                         owner.get("start_time"))
            if verdict == "adopted":  # alive AND fingerprint-matched
                self._m_adoptions["refused"].inc()
                raise ControllerBusy(
                    f"deployment controller journal {self.journal.path} "
                    f"is owned by live pid {owner['pid']} — refusing to "
                    "double-start on one checkpoint dir")
        self._m_restarts.inc()
        self.incarnation = int(prior.get("incarnation", 0)) + 1
        self.champion = prior.get("champion")
        self.quarantined = dict(prior.get("quarantined") or {})
        phase = prior.get("phase", IDLE)
        cand = prior.get("candidate")
        if cand and phase in (CANARY, PROMOTING, ROLLING_BACK):
            # an in-flight decision: re-drive it to its verdict before
            # looking at anything newer (run_once resumes it first)
            self.candidate = cand
            self._resume_phase = phase
            self.phase = phase
            self._m_adoptions["resumed"].inc()

    def _journal_write(self) -> None:
        if self.journal is None:
            return
        self.journal.try_write({
            "plane": "pipeline",
            "controller": self.name,
            "incarnation": self.incarnation,
            "owner": self._owner_fingerprint(),
            "phase": self.phase,
            "champion": self.champion,
            "candidate": self.candidate,
            "quarantined": self.quarantined,
            "checkpoint_dir": os.path.abspath(self.checkpoint_dir),
            "written_at": time.time(),
        })

    # --------------------------------------------------------- quarantine
    def _quarantine_marker(self, step: int) -> str:
        return os.path.join(self.checkpoint_dir,
                            ckfmt.step_dir_name(step), QUARANTINE_MARKER)

    def _is_quarantined(self, step: int) -> bool:
        if str(step) in self.quarantined:
            return True
        try:
            return os.path.exists(self._quarantine_marker(step))
        except OSError:
            return False

    def _quarantine(self, cand: dict, reason: str) -> None:
        """Commit the rejection: QUARANTINED marker in the step dir
        (atomic rename — the negative COMMITTED) + journaled reason.
        A step dir the writer already pruned still lands in the
        journal's quarantine list, so the verdict survives either
        way."""
        step = cand.get("step")
        self.quarantined[str(step)] = reason
        self._m_quarantines.inc()
        marker = self._quarantine_marker(step)
        try:
            tmp = marker + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": step, "reason": reason,
                           "at": time.time(),
                           "metrics": cand.get("metrics")}, f)
            os.replace(tmp, marker)
        except OSError as e:
            log.warning("could not write %s (%s); quarantine survives "
                        "in the journal", marker, e)
        self._journal_write()

    # ------------------------------------------------------------- watch
    def _scan(self) -> Optional[dict]:
        """One bounded poll of the checkpoint dir: newest COMMITTED,
        non-quarantined step beyond the champion, or None."""
        chaos.hit("pipeline.watch", dir=self.checkpoint_dir)
        steps = list_committed_steps(self.checkpoint_dir)
        for s in steps:
            if s not in self._seen:
                self._seen.add(s)
                self._m_seen.inc()
        champ_step = ((self.champion or {}).get("step")
                      if self.champion else None)
        eligible = [s for s in steps
                    if not self._is_quarantined(s)
                    and (champ_step is None or s > champ_step)]
        if not eligible:
            return None
        step = max(eligible)
        return {"path": os.path.abspath(self.checkpoint_dir),
                "step": step, "metrics": None}

    # --------------------------------------------------------- eval gate
    def _gate(self, cand: dict) -> Optional[dict]:
        """Run the eval gate. Returns the candidate (with metrics) on
        pass; None on fail (quarantined) or on an eval that could not
        run (left pending — NOT a failed eval)."""
        if self.eval_data is None:
            return cand  # unarmed gate: the canary probe decides
        self.phase = EVALUATING
        self.candidate = cand
        self._journal_write()
        t0 = time.perf_counter()
        try:
            chaos.hit("pipeline.eval", step=cand["step"])
            from deeplearning4j_tpu_torch.eval.holdout import \
                evaluate_checkpoint

            metrics = evaluate_checkpoint(
                cand["path"], self.eval_data,
                label_columns=self.label_columns, step=cand["step"],
                device=self.device)
        except (chaos.ChaosError, ckfmt.CheckpointError, OSError,
                ValueError) as e:
            # the candidate may have been pruned mid-eval, the holdout
            # file unreadable, or a chaos fault fired: pending, retried
            # next poll — never quarantined for an eval that didn't run
            log.warning("eval gate could not run for step %s: %s",
                        cand.get("step"), e)
            self.phase = IDLE
            self.candidate = None
            self._journal_write()
            return None
        self._m_eval_s.observe(time.perf_counter() - t0)
        cand = {**cand, "metrics": metrics}
        score = metrics.get(self.metric)
        champ_metrics = (self.champion or {}).get("metrics") or {}
        champ_score = champ_metrics.get(self.metric)
        if self.eval_via_fleet and self.champion is not None:
            # regression baseline from the LIVE fleet, scored on the
            # batch tier (docs/SERVING.md "Priority tiers") so the
            # gate's bulk traffic sheds first and never preempts a
            # user; an unreachable/shedding fleet falls back to the
            # journaled champion score — an eval that could not run
            # must not change the verdict's inputs silently
            try:
                from deeplearning4j_tpu_torch.eval.holdout import \
                    evaluate_via_fleet

                live = evaluate_via_fleet(
                    self.fleet_url, self.eval_data,
                    label_columns=self.label_columns,
                    timeout=self.request_timeout)
                if live.get(self.metric) is not None:
                    champ_score = live[self.metric]
            except Exception as e:
                log.warning(
                    "live champion baseline unavailable (%s); using "
                    "journaled score %s", e, champ_score)
        if score is None:
            verdict = f"metric {self.metric!r} missing from eval output"
        elif score < self.eval_threshold:
            verdict = (f"{self.metric}={score:.4f} below absolute "
                       f"threshold {self.eval_threshold}")
        elif (champ_score is not None
                and score < champ_score - self.regression_margin):
            verdict = (f"{self.metric}={score:.4f} regressed more than "
                       f"{self.regression_margin} below champion "
                       f"{champ_score:.4f} (step "
                       f"{(self.champion or {}).get('step')})")
        else:
            self._m_eval_pass.inc()
            return cand
        self._m_eval_fail.inc()
        log.info("eval gate rejected step %s: %s", cand["step"], verdict)
        self._quarantine(cand, f"eval_gate: {verdict}")
        self.phase = IDLE
        self.candidate = None
        self._journal_write()
        return None

    # ----------------------------------------------------------- promote
    def _drive_reload(self, path: str, step: Optional[int]):
        """Ask the fleet to canary-reload onto (path, step). Returns
        (result_dict, definitive): definitive=False means the fleet
        never reached a verdict (unreachable / no ready replicas /
        reload already in flight) — the candidate stays pending."""
        champ = self.champion or {}
        if self.fleet is not None:
            from deeplearning4j_tpu_torch.serving.errors import \
                OverloadedError
            from deeplearning4j_tpu_torch.serving.fleet import \
                NoReadyReplicas

            try:
                res = self.fleet.rolling_reload(
                    path, step=step,
                    rollback_path=champ.get("path"),
                    rollback_step=champ.get("step"),
                    probe=self.probe, model_id=self.model_id)
                return res, True
            except (NoReadyReplicas, OverloadedError) as e:
                return {"reloaded": False, "error": str(e)}, False
        import urllib.error
        import urllib.request

        payload = {"path": path, "step": step,
                   "rollback_path": champ.get("path"),
                   "rollback_step": champ.get("step"),
                   "probe": self.probe}
        if self.model_id is not None:
            payload["model_id"] = self.model_id
        req = urllib.request.Request(
            self.fleet_url + "/reload",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=self.request_timeout) as r:
                return json.loads(r.read()), True
        except urllib.error.HTTPError as e:
            body = e.read()
            try:
                data = json.loads(body)
            except ValueError:
                data = {"error": body.decode(errors="replace")}
            # 409 is the router's definitive "canary failed, rolled
            # back" verdict; 5xx (no ready replicas, shedding) is infra
            return data, e.code == 409
        except Exception as e:
            return {"reloaded": False,
                    "error": f"{type(e).__name__}: {e}"}, False

    def _promote(self, cand: dict) -> dict:
        """Drive the canary promotion of an eval-passed candidate to
        its all-or-nothing verdict."""
        self.phase = CANARY
        self.candidate = cand
        self._journal_write()
        t0 = time.perf_counter()
        try:
            chaos.hit("pipeline.promote", step=cand.get("step"))
        except chaos.ChaosError as e:
            # fault before the fleet was touched: candidate pending,
            # fleet untouched on the old champion
            self.phase = IDLE
            self._journal_write()
            return {"action": "promote", "promoted": False,
                    "pending": True, "error": str(e)}
        result, definitive = self._drive_reload(cand["path"],
                                                cand.get("step"))
        if result.get("reloaded"):
            # verdict reached: journal PROMOTING before the champion
            # switch so a crash between the two re-drives to the same
            # (idempotent) outcome
            self.phase = PROMOTING
            self._journal_write()
            self.champion = cand
            self.candidate = None
            self.phase = IDLE
            self._m_promotions.inc()
            self._m_promote_s.observe(time.perf_counter() - t0)
            self._journal_write()
            log.info("promoted step %s to champion", cand.get("step"))
            return {"action": "promote", "promoted": True,
                    "step": cand.get("step")}
        if not definitive:
            self.phase = IDLE
            self._journal_write()
            return {"action": "promote", "promoted": False,
                    "pending": True, "error": result.get("error")}
        # definitive canary failure: the fleet already rolled itself
        # back (Fleet.rolling_reload's all-or-nothing contract) — commit
        # our half of the verdict
        self.phase = ROLLING_BACK
        self._journal_write()
        self._m_rollbacks.inc()
        reason = json.dumps(result.get("error") or result,
                            default=str)[:500]
        self._quarantine(cand, f"canary: {reason}")
        self.candidate = None
        self.phase = IDLE
        self._m_promote_s.observe(time.perf_counter() - t0)
        self._journal_write()
        log.info("canary for step %s failed; rolled back and "
                 "quarantined", cand.get("step"))
        return {"action": "promote", "promoted": False,
                "rolled_back": True, "step": cand.get("step"),
                "error": result}

    def _resume(self) -> Optional[dict]:
        """Finish the decision a prior incarnation died inside."""
        phase, cand = self._resume_phase, self.candidate
        self._resume_phase = None
        if not cand:
            return None
        if phase in (CANARY, PROMOTING):
            log.info("resuming in-flight promotion of step %s "
                     "(journaled phase %s)", cand.get("step"), phase)
            return self._promote(cand)
        if phase == ROLLING_BACK:
            # the failure verdict was already decided: re-assert the
            # champion on the fleet, then finish the quarantine
            champ = self.champion or {}
            if champ.get("path"):
                self._drive_reload(champ["path"], champ.get("step"))
            self._m_rollbacks.inc()
            self._quarantine(cand, "canary: rollback resumed after "
                                   "controller restart")
            self.candidate = None
            self.phase = IDLE
            self._journal_write()
            return {"action": "resume_rollback",
                    "step": cand.get("step")}
        return None

    # --------------------------------------------------------- main loop
    def run_once(self) -> dict:
        """One conveyor cycle: resume any journaled in-flight decision,
        scan, gate, promote. Returns a dict describing what happened
        (tests drive the controller deterministically through this)."""
        if self._resume_phase is not None:
            out = self._resume()
            if out is not None:
                return out
        try:
            cand = self._scan()
        except (chaos.ChaosError, OSError) as e:
            log.warning("checkpoint scan failed (retrying next poll): "
                        "%s", e)
            return {"action": "watch", "error": str(e)}
        if cand is None:
            return {"action": "idle"}
        gated = self._gate(cand)
        if gated is None:
            return {"action": "eval", "step": cand["step"],
                    "promoted": False}
        return self._promote(gated)

    def run(self, max_cycles: Optional[int] = None) -> None:
        """Poll forever (or `max_cycles`) at `poll_interval`, until
        `stop()`. This is what `cli pipeline` blocks in."""
        cycles = 0
        while not self._stop.is_set():
            self.run_once()
            cycles += 1
            if max_cycles is not None and cycles >= max_cycles:
                return
            self._stop.wait(self.poll_interval)

    def stop(self) -> None:
        self._stop.set()

    def close(self, release: bool = True) -> None:
        """Stop polling and the status endpoint. `release=True` writes
        a final journal with no owner so a successor may start
        immediately; the decision state (champion, quarantine list)
        stays committed for it to adopt."""
        self.stop()
        if self.status_server is not None:
            self.status_server.stop()
        if self.journal is not None and release:
            state = self.journal.read() or {}
            state.update({
                "plane": "pipeline", "controller": self.name,
                "incarnation": self.incarnation, "owner": None,
                "phase": self.phase, "champion": self.champion,
                "candidate": self.candidate,
                "quarantined": self.quarantined,
                "checkpoint_dir": os.path.abspath(self.checkpoint_dir),
                "written_at": time.time(),
            })
            self.journal.try_write(state)

    @property
    def status_address(self):
        """StatusServer URL ("http://host:port"), None when unarmed."""
        return (self.status_server.address
                if self.status_server is not None else None)

    def __enter__(self) -> "DeploymentController":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------- observability
    def status(self) -> dict:
        """The /stats-style surface (StatusServer `extra` hook)."""
        return {
            "pipeline": self.name,
            "phase": self.phase,
            "checkpoint_dir": os.path.abspath(self.checkpoint_dir),
            "champion": self.champion,
            "candidate": self.candidate,
            "quarantined": dict(self.quarantined),
            "incarnation": self.incarnation,
            "eval_threshold": self.eval_threshold,
            "eval_via_fleet": self.eval_via_fleet,
            "regression_margin": self.regression_margin,
            "metric": self.metric,
            "poll_interval": self.poll_interval,
            "fleet": (self.fleet_url if self.fleet_url
                      else getattr(self.fleet, "label", "in-process")),
            "counters": {
                "candidates_seen": int(self._m_seen.value),
                "eval_pass": int(self._m_eval_pass.value),
                "eval_fail": int(self._m_eval_fail.value),
                "promotions": int(self._m_promotions.value),
                "rollbacks": int(self._m_rollbacks.value),
                "quarantines": int(self._m_quarantines.value),
            },
            "uptime_s": round(time.time() - self.started_at, 3),
        }
