"""Self-healing elastic training: a process supervisor for DP workers,
the counterpart of the JAX package's `scaleout/supervisor.py` (host
code, the same ladder, journal and series; its workers train the port's
network on the device their performer conf names).

The serving fleet is elastic (heartbeats, circuit breakers, chaos
drills); this module is the training-side mirror of that stack: a
`TrainingSupervisor`
runs a data-parallel iterative-reduce job across N OUT-OF-PROCESS
workers (`scaleout/worker.py` entrypoints, spawned like
`serving/fleet.py`'s ReplicaSpawner — own session groups, module atexit
orphan sweep) and keeps the RUN alive across worker churn:

- **Liveness** rides the existing scaleout control plane: the
  supervisor heartbeats the `InMemoryStateTracker` on behalf of each
  worker for as long as the worker's PROGRESS SOCKET stays open
  (`_ProgressListener`), and `stale_workers()` drives eviction exactly
  as `runtime._evict_stale` always has. A SIGKILLed worker's socket
  closes (kernel FIN) -> heartbeats stop -> staleness evicts within the
  heartbeat window.
- **Hang detection** (the training twin of the fleet's circuit breaker): a
  SIGSTOP'd worker still HOLDS its TCP connection (the kernel keeps it
  ESTABLISHED), so liveness alone would trust it forever. The
  supervisor therefore also tracks a steps-per-heartbeat progress
  watermark — a worker holding a dispatched job whose performed-count
  has not advanced within `progress_timeout` is hung: evicted, its
  process group killed, its job re-served (orphan requeue).
- **Elastic respawn**: every eviction (crash, hang, straggler)
  schedules a replacement worker under a bounded respawn budget with
  exponential backoff; the wave barrier re-forms around the respawned
  member (`DistributedRuntime`'s exact-membership wave), and because
  updates fold in canonical job-seq order, the completed run's params
  are BIT-IDENTICAL to an uninterrupted run at the same wave schedule.
- **Elastic resume**: when capacity is durably lost (respawn budget
  exhausted, or a spawn that keeps failing), the supervisor restarts
  from the last COMMITTED sharded checkpoint resharded to the surviving
  topology: the checkpoint's params leaf is written as one shard per
  worker (`checkpoint/format.py` shard table), reassembled by
  `checkpoint/restore.py` whatever the survivor count, and the job
  stream seeks back to the checkpoint's cursor — no example is dropped
  or double-trained (`folded_seqs` is the audit trail).
- **Straggler defense**: per-job durations stream in on the progress
  plane; a worker persistently slower than the wave median by
  `straggler_factor` is flagged (telemetry + status), and after
  `straggler_strikes` consecutive flags evicted and respawned.

- **Crash-safe control plane** (`state_dir=`): the supervisor itself is
  no longer the one process nobody may lose. Every membership
  transition journals (pid + start-time fingerprint, slot, generation,
  progress port, incarnation) through a `utils/statefile.py` StateFile
  (`supervisor.journal`, the checkpoint layer's atomic-rename commit
  idiom), and a restarted incarnation **re-adopts** its live children
  instead of respawning them: journaled pids are fingerprint-verified
  (`utils/procs.pid_matches` — pid + /proc start time, never pid
  alone), surviving workers become `AdoptedProc` members that
  reconnect warm (`scaleout/worker.py`'s bounded-backoff reconnect
  loop re-announces `(worker_id, last Job.seq)`), the progress port is
  rebound from the journal, and run state restores from the last
  COMMITTED checkpoint so the completed run stays BIT-IDENTICAL with
  zero lost or double-trained examples. The failure ladder gains a
  rung above the elastic resume: reconnect-adopt -> reshard-resume ->
  fresh start.
  A torn journal or dead children degrade one rung, never crash; a
  crash-exiting incarnation hands its children off
  (`procs.release_spawned` scopes the atexit sweep to what THIS
  incarnation still owns) and unknown rejoiners are adopted-or-killed,
  never leaked. `cli watchdog` supervises the supervisor.

Chaos points (`testing/chaos.py`, env-activated per worker process so
drills are seeded and replayable): `worker.spawn`, `worker.step`,
`worker.heartbeat`, `worker.reconnect`, and `supervisor.journal` (the
journal's write/rename ordinals) — see `WorkerSpawner(env_for=...)`
for per-worker plans. Telemetry: `dl4j_train_fleet_*`
(workers-by-state, evictions by reason, respawns, resumes, straggler
flags, wave latency histogram) plus `dl4j_controlplane_*` (restarts,
adoptions by kind, journal write/commit histograms, incarnation
gauge), scraped from the supervisor's StatusServer `/metrics`;
`status.json` carries per-worker lifecycle and `/healthz` answers 503
when quorum (`min_workers`) is lost. Runbook: docs/FAULT_TOLERANCE.md
"Who watches the watcher".

A worker's first job on the card pays for its CUDA context (and, for an
attention stack, for loading the kernel library): `startup_grace` covers
a member until its first job completes, so that cost never reads as a
hang. A tree checkpoint (one written by a trainer) is packed in
`checkpoint/convert.py`'s sorted-key order, which is the JAX package's
`ravel_pytree` order.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.scaleout.launcher import MultiProcessMaster
from deeplearning4j_tpu_torch.scaleout.runtime import JOBS_DROPPED
from deeplearning4j_tpu_torch.scaleout.statetracker import InMemoryStateTracker
from deeplearning4j_tpu_torch.utils import procs
from deeplearning4j_tpu_torch.utils.statefile import StateFile

__all__ = ["TrainingSupervisor", "WorkerSpawner", "SupervisedWorker",
           "SupervisorAbort", "STARTING", "RUNNING", "SUSPECT",
           "EVICTED", "DEAD"]

log = logging.getLogger(__name__)

#: worker lifecycle (the fleet's replica states, trained on training)
STARTING = "starting"   # spawned, progress socket not yet open
RUNNING = "running"     # connected and heartbeating
SUSPECT = "suspect"     # straggler-flagged, still in the wave
EVICTED = "evicted"     # removed from the run (respawn may replace it)
DEAD = "dead"           # evicted with no respawn capacity left
STATES = (STARTING, RUNNING, SUSPECT, EVICTED, DEAD)

_sup_seq = itertools.count()


class SupervisorAbort(RuntimeError):
    """The supervisor cannot keep the run alive (quorum lost and no
    respawn capacity). The failure ladder bottomed out:
    respawn -> reshard-resume -> abort (docs/FAULT_TOLERANCE.md)."""


# --------------------------------------------------------------- spawner
class WorkerSpawner:
    """Spawns local training-worker processes
    (`python -m deeplearning4j_tpu_torch.scaleout.worker`) joined to a
    registered run. Single-host backend (tests/bench/laptop drills); a
    multi-host deployment brings its own process manager and launches
    the same entrypoint. `env_for(worker_id)` lets a drill hand ONE
    worker a chaos plan (`chaos.env_spec`) while its peers run clean —
    how seeded straggler/hang schedules stay per-process."""

    def __init__(self, registry_root: str, run_name: str, *,
                 env: Optional[dict] = None,
                 env_for: Optional[Callable[[str], dict]] = None,
                 python: Optional[str] = None,
                 heartbeat_interval: float = 0.05,
                 reconnect_grace: float = 30.0):
        self.registry_root = str(registry_root)
        self.run_name = run_name
        self.reconnect_grace = float(reconnect_grace)
        base_env = dict(env) if env is not None else dict(os.environ)
        # the package must be importable in the child whatever cwd the
        # supervisor runs from
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        path = base_env.get("PYTHONPATH", "")
        if pkg_root not in path.split(os.pathsep):
            base_env["PYTHONPATH"] = (pkg_root + (os.pathsep + path
                                                  if path else ""))
        # elastic respawns inherit the program store: a replacement worker
        # loads the kernel library from it instead of running nvcc
        from deeplearning4j_tpu_torch import compilecache
        compilecache.export_env(base_env)
        # cuBLAS picks the same kernels in every fresh worker process: a
        # respawned member recomputes an orphan job bit for bit
        base_env.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        self.env = base_env
        self.env_for = env_for
        self.python = python or sys.executable
        self.heartbeat_interval = float(heartbeat_interval)

    def command(self, worker_id: str) -> List[str]:
        return [self.python, "-m", "deeplearning4j_tpu_torch.scaleout.worker",
                "--registry", self.registry_root,
                "--run", self.run_name,
                "--worker-id", worker_id,
                "--heartbeat-interval", str(self.heartbeat_interval),
                "--reconnect-grace", str(self.reconnect_grace)]

    def spawn(self, worker_id: str) -> subprocess.Popen:
        env = dict(self.env)
        if self.env_for is not None:
            env.update(self.env_for(worker_id) or {})
        proc = subprocess.Popen(
            self.command(worker_id), env=env, text=True,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            start_new_session=True)
        procs.register_spawned(proc)
        return proc

    @staticmethod
    def stop(proc: subprocess.Popen, timeout: float = 10.0,
             term_first: bool = True) -> None:
        """Terminate a worker and its whole process group — the shared
        group-stop discipline (utils/procs.py; same as
        ReplicaSpawner.stop). `term_first=False` goes straight to
        SIGKILL: a hung or SIGSTOP'd worker never honors SIGTERM and
        its work is already requeued."""
        procs.stop_process_group(proc, timeout=timeout,
                                 term_first=term_first)


# -------------------------------------------------------- progress plane
class _ProgressListener:
    """The supervisor's liveness/progress socket.

    Each worker opens ONE TCP connection at startup (hello line naming
    its worker id) and streams NDJSON progress lines. The listener's
    per-connection reader drives two signals:

    - **liveness**: while the connection is OPEN — lines arriving OR
      merely an established socket — `on_alive(wid)` fires every poll,
      which the supervisor turns into `tracker.heartbeat`. This is
      deliberately TCP-held liveness: a SIGSTOP'd worker's socket stays
      ESTABLISHED (the kernel answers for it), so it keeps
      "heartbeating" — exactly the hung-but-TCP-alive failure mode the
      progress watermark exists to catch. EOF/reset (process death)
      ends liveness immediately.
    - **progress**: each line's `performed` count and `job_s` duration
      feed the watermark and the straggler stats via
      `on_progress(wid, data)`.
    """

    def __init__(self, on_alive, on_progress, on_gone,
                 host: str = "127.0.0.1", poll_s: float = 0.25,
                 port: int = 0):
        self.on_alive = on_alive
        self.on_progress = on_progress
        self.on_gone = on_gone
        self.poll_s = float(poll_s)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            # a restarted incarnation rebinds its journaled port so
            # surviving workers' reconnects land without a registry
            # round trip; if something else claimed it meanwhile, fall
            # back to an ephemeral port — workers re-resolve the fresh
            # address from the re-registered run config either way
            self._sock.bind((host, int(port)))
        except OSError:
            self._sock.bind((host, 0))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()[:2]
        self._closed = threading.Event()
        self._conns: Dict[str, socket.socket] = {}
        self._lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="supervisor-progress-accept")
        self._accept_thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # closed
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True,
                             name="supervisor-progress-read").start()

    def _reader(self, conn: socket.socket) -> None:
        wid = None
        conn.settimeout(self.poll_s)
        buf = b""
        try:
            while not self._closed.is_set():
                try:
                    chunk = conn.recv(4096)
                except socket.timeout:
                    # open-but-silent: the kernel still owns an
                    # ESTABLISHED socket for this peer — liveness holds
                    if wid is not None:
                        self.on_alive(wid)
                    continue
                except OSError:
                    break
                if not chunk:
                    break  # EOF: the process is gone
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    try:
                        data = json.loads(line)
                    except ValueError:
                        continue
                    if wid is None:
                        wid = str(data.get("worker_id", ""))
                        if not wid:
                            return
                        with self._lock:
                            self._conns[wid] = conn
                    self.on_alive(wid)
                    self.on_progress(wid, data)
        finally:
            try:
                conn.close()
            except OSError:
                pass
            if wid is not None:
                with self._lock:
                    if self._conns.get(wid) is conn:
                        self._conns.pop(wid, None)
                self.on_gone(wid)

    def drop(self, worker_id: str) -> None:
        """Sever an evicted worker's connection so its kernel-held
        socket can never heartbeat it back into the run."""
        with self._lock:
            conn = self._conns.pop(worker_id, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass


# --------------------------------------------------------- worker record
class SupervisedWorker:
    """Supervisor-side record of one worker process (mutations under
    the supervisor's lock)."""

    def __init__(self, worker_id: str, slot: int,
                 proc: Optional[subprocess.Popen] = None,
                 generation: int = 0, adopted: bool = False):
        self.id = worker_id
        self.slot = slot                # stable index of the capacity slot
        self.generation = generation    # respawn count for this slot
        self.proc = proc
        self.state = STARTING
        self.adopted = adopted          # re-adopted from a prior incarnation
        #: /proc start-time fingerprint journaled next to the pid so the
        #: NEXT incarnation never adopts a recycled pid
        self.start_time = (getattr(proc, "start_time", None)
                           or (procs.proc_start_time(proc.pid)
                               if proc is not None else None))
        self.spawned_at = time.monotonic()
        self.connected = False
        self.performed = 0              # jobs completed (worker-reported)
        self.last_step = 0              # alias surfaced in status.json
        self.last_seq: Optional[int] = None  # re-announced on reconnect
        self.last_progress_t = time.monotonic()
        self.job_seen_t: Optional[float] = None  # current dispatch seen at
        self.job_seconds: deque = deque(maxlen=8)
        self.straggler_strikes = 0
        self.evicted_at: Optional[float] = None
        self.eviction_reason: Optional[str] = None

    def mean_job_s(self) -> Optional[float]:
        if not self.job_seconds:
            return None
        return sum(self.job_seconds) / len(self.job_seconds)

    def snapshot(self) -> dict:
        out = {"state": self.state, "slot": self.slot,
               "generation": self.generation,
               "last_step": self.last_step,
               "straggler_strikes": self.straggler_strikes}
        if self.adopted:
            out["adopted"] = True
        if self.last_seq is not None:
            out["last_seq"] = self.last_seq
        mean = self.mean_job_s()
        if mean is not None:
            out["mean_job_s"] = round(mean, 4)
        if self.proc is not None:
            out["pid"] = self.proc.pid
            out["proc_alive"] = self.proc.poll() is None
        if self.eviction_reason is not None:
            out["eviction_reason"] = self.eviction_reason
        return out


# ------------------------------------------------------------ supervisor
class TrainingSupervisor(MultiProcessMaster):
    """MultiProcessMaster that OWNS its worker processes: spawn, health,
    hang/straggler defense, bounded respawn, and checkpoint-backed
    elastic resume. The wave/aggregation choreography is inherited; the
    `_tick` hook injects supervision into every master poll."""

    def __init__(self, job_iterator, *, run_name: str, registry,
                 performer_class: str,
                 performer_conf: Optional[Dict[str, Any]] = None,
                 n_workers: int = 2,
                 spawner: Optional[WorkerSpawner] = None,
                 checkpoint_dir: Optional[str] = None,
                 save_every_waves: int = 1,
                 keep_checkpoints: int = 3,
                 resume: Optional[str] = None,
                 max_respawns: int = 3,
                 respawn_backoff_s: float = 0.25,
                 heartbeat_timeout: float = 3.0,
                 progress_timeout: float = 15.0,
                 startup_grace: float = 120.0,
                 straggler_factor: float = 4.0,
                 straggler_min_samples: int = 2,
                 straggler_strikes: int = 2,
                 min_workers: int = 1,
                 conf_json: Optional[str] = None,
                 host: str = "127.0.0.1",
                 status_port: Optional[int] = None,
                 heartbeat_interval: float = 0.02,
                 state_dir: Optional[str] = None,
                 **kw):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        if not 1 <= min_workers <= n_workers:
            raise ValueError(
                f"need 1 <= min_workers <= n_workers, got "
                f"{min_workers}..{n_workers}")
        self.run_label = run_name
        self.members: Dict[str, SupervisedWorker] = {}
        self._sup_lock = threading.RLock()
        self.max_respawns = int(max_respawns)
        self.respawns_used = 0
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.progress_timeout = float(progress_timeout)
        self.startup_grace = float(startup_grace)
        self.straggler_factor = float(straggler_factor)
        self.straggler_min_samples = int(straggler_min_samples)
        self.straggler_strikes = int(straggler_strikes)
        self.min_workers = int(min_workers)
        self.checkpoint_dir = checkpoint_dir
        self.saver = None
        self._resume_request = resume
        self._slot_seq = itertools.count()
        self._respawn_queue: List[dict] = []  # {slot, gen, not_before}
        self._last_waves_seen = 0
        self._waves_since_save = 0
        self._last_saved_step: Optional[int] = None
        self.resume_events: List[dict] = []
        self._capacity_lost_pending = False
        self._aborted: Optional[str] = None

        # ------------------------------------ crash-safe control plane
        self.state_dir = state_dir
        self.journal: Optional[StateFile] = None
        self.incarnation = 0
        self.adoption_events: List[dict] = []
        self._adopt_respawn: List[tuple] = []  # (slot, generation)
        self._journal_io_lock = threading.Lock()
        #: strays are only judged once journal adoption has run — a
        #: survivor reconnecting to the rebound progress port mid-init
        #: must wait for its journaled record, not be adopted twice
        self._adoption_done = False
        prior = None
        if state_dir is not None:
            self.journal = StateFile(
                os.path.join(state_dir, "supervisor.journal"),
                point="supervisor.journal")
            prior = self.journal.read()
            if prior is not None:
                self.incarnation = int(prior.get("incarnation", 0)) + 1
            elif self.journal.torn:
                # a torn journal means a prior incarnation existed but
                # its children are unknown: spawn fresh under the new
                # incarnation's namespace and adopt-or-kill whoever
                # re-announces on the progress plane
                self.incarnation = 1
        self._init_metrics()

        if checkpoint_dir is not None:
            from deeplearning4j_tpu_torch.checkpoint.writer import \
                AsyncCheckpointWriter

            self.saver = AsyncCheckpointWriter(checkpoint_dir,
                                               keep=keep_checkpoints)
        self.save_every_waves_elastic = int(save_every_waves)

        self._progress = _ProgressListener(
            self._on_worker_alive, self._on_worker_progress,
            self._on_worker_gone, host=host,
            port=int((prior or {}).get("progress_port") or 0))

        super().__init__(
            job_iterator, run_name=run_name, registry=registry,
            performer_class=performer_class,
            performer_conf=performer_conf, n_workers=n_workers,
            host=host, conf_json=conf_json, status_port=status_port,
            status_extra=self._status_extra,
            status_health=self._health,
            tracker=InMemoryStateTracker(
                heartbeat_timeout=heartbeat_timeout),
            heartbeat_interval=heartbeat_interval,
            **kw)
        # workers read the progress address from the run config
        registry.register_run(run_name, {
            **registry.retrieve_run(run_name),
            "progress_address": self._progress.address,
        })
        self.spawner = spawner if spawner is not None else WorkerSpawner(
            getattr(registry, "root", "."), run_name)
        adopted_any = False
        if prior is not None:
            try:
                adopted_any = self._adopt_prior(prior)
            except Exception:
                # a journal that parses but carries an unexpected shape
                # (older/newer writer, hand edit) must degrade like a
                # torn one — fresh spawns + stray adopt-or-kill — never
                # crash the restart into the watchdog's restart budget
                log.exception(
                    "supervisor %s: journal adoption failed; falling "
                    "back to fresh spawns", self.run_label)
        if self._resume_request:
            self._apply_initial_resume(self._resume_request)
        elif (self.incarnation > 0 and self.checkpoint_dir is not None):
            # a restarted incarnation implies resume-if-any: the last
            # COMMITTED checkpoint is the run state the adopted (or
            # fresh) pool continues from — the reconnect-adopt rung of
            # the failure ladder degrades to exactly the elastic
            # resume when no one survived, and to a fresh start when
            # nothing committed
            self._apply_initial_resume("auto")
        if adopted_any and not self.resume_events:
            log.warning(
                "supervisor %s: incarnation %d adopted %d worker(s) "
                "with no committed checkpoint — continuing from fresh "
                "params (ladder rung: fresh start, warm processes)",
                self.run_label, self.incarnation,
                sum(1 for e in self.adoption_events
                    if e["kind"] == "adopted"))
        self._journal_write()
        self._adoption_done = True

    # ------------------------------------------------------- telemetry
    def _init_metrics(self) -> None:
        reg = telemetry.get_registry()
        lab = {"run": self.run_label}
        self._m_evictions = {
            reason: reg.counter(
                "dl4j_train_fleet_evictions",
                "training workers evicted, by reason").labels(
                    reason=reason, **lab)
            for reason in ("stale", "hung", "straggler", "spawn_failed")}
        self._m_respawns = reg.counter(
            "dl4j_train_fleet_respawns",
            "replacement training workers spawned").labels(**lab)
        self._m_resumes = {
            kind: reg.counter(
                "dl4j_train_fleet_resumes",
                "elastic resumes from the last committed checkpoint, "
                "by topology relation").labels(kind=kind, **lab)
            for kind in ("resharded", "same_topology")}
        self._m_straggler = reg.counter(
            "dl4j_train_fleet_straggler_flags",
            "straggler flags raised (worker slower than the wave "
            "median by the configured factor)").labels(**lab)
        self._m_wave_s = reg.histogram(
            "dl4j_train_fleet_wave_seconds",
            "wave wall latency (dispatch to aggregate)").labels(**lab)
        ref = weakref.ref(self)
        for state in STATES:
            reg.gauge(
                "dl4j_train_fleet_workers",
                "supervised training workers by lifecycle state").labels(
                    state=state, **lab).set_function(
                (lambda st: lambda: (
                    (lambda o: o.state_counts().get(st, 0) if o else 0)(
                        ref())))(state))
        # crash-safe control plane (docs/OBSERVABILITY.md) — series
        # definitions shared with the fleet (statefile module)
        from deeplearning4j_tpu_torch.utils.statefile import \
            controlplane_metrics

        self._m_restarts, self._m_adoptions = controlplane_metrics(
            "supervisor", self.run_label,
            lambda: (lambda o: o.incarnation if o else 0)(ref()),
            ("adopted", "dead", "recycled", "stray", "killed_stale"))

    # ------------------------------------------------------ membership
    def state_counts(self) -> Dict[str, int]:
        with self._sup_lock:
            counts = {s: 0 for s in STATES}
            for rec in self.members.values():
                counts[rec.state] += 1
            return counts

    def live_workers(self) -> List[SupervisedWorker]:
        with self._sup_lock:
            return [r for r in self.members.values()
                    if r.state in (STARTING, RUNNING, SUSPECT)]

    def _worker_id(self, slot: int, generation: int) -> str:
        base = (f"w{slot}" if generation == 0
                else f"w{slot}r{generation}")
        # incarnation-scoped ids for FRESH spawns of a restarted
        # control plane: a prior incarnation's survivor keeps its old
        # id (it re-announces it), so new spawns must never collide
        # with a rejoiner wearing the same slot number
        return base if self.incarnation == 0 \
            else f"{base}_i{self.incarnation}"

    def spawn_workers(self, n: Optional[int] = None) -> None:
        """Spawn the initial pool (idempotent; run() calls it). A
        restarted incarnation first replaces journaled slots whose
        processes did not survive (same slot, bumped generation — not
        charged to the respawn budget: this is the incarnation's
        initial pool), then fills any remainder with fresh slots."""
        n = self.n_workers if n is None else n
        while self._adopt_respawn and len(self.live_workers()) < n:
            slot, gen = self._adopt_respawn.pop(0)
            self._spawn_slot(slot, gen)
        with self._sup_lock:
            self._adopt_respawn.clear()
            have = len(self.live_workers())
        for _ in range(max(0, n - have)):
            slot = next(self._slot_seq)
            self._spawn_slot(slot, generation=0)

    def _spawn_slot(self, slot: int, generation: int) -> SupervisedWorker:
        wid = self._worker_id(slot, generation)
        proc = self.spawner.spawn(wid)
        rec = SupervisedWorker(wid, slot, proc=proc,
                               generation=generation)
        with self._sup_lock:
            self.members[wid] = rec
        log.info("supervisor %s: spawned worker %s (pid %d)",
                 self.run_label, wid, proc.pid)
        self._journal_write()
        return rec

    # ---------------------------------------- crash-safe control plane
    def _journal_write(self) -> None:
        """Commit the membership journal (utils/statefile.py atomic
        rename). Called at every transition: spawn, adopt, evict,
        close. A failed write is logged and survived — the previous
        committed journal stays valid, which at worst costs a restart
        one ladder rung (it adopts a slightly older membership and the
        pid fingerprints reject anything that changed)."""
        if self.journal is None:
            return
        with self._sup_lock:
            workers = {}
            for wid, rec in self.members.items():
                if rec.state in (EVICTED, DEAD) or rec.proc is None:
                    continue
                workers[wid] = {
                    "slot": rec.slot, "generation": rec.generation,
                    "pid": rec.proc.pid,
                    "start_time": rec.start_time,
                    "state": rec.state,
                    "performed": rec.performed,
                    "last_seq": rec.last_seq,
                }
            state = {
                "plane": "supervisor",
                "run": self.run_label,
                "incarnation": self.incarnation,
                "progress_port": self._progress.port,
                "n_workers": self.n_workers,
                "respawns_used": self.respawns_used,
                "checkpoint_dir": self.checkpoint_dir,
                "workers": workers,
                "written_at": time.time(),
            }
        with self._journal_io_lock:
            self.journal.try_write(state)

    def _adopt_prior(self, prior: dict) -> bool:
        """Re-adopt the previous incarnation's live children. Every
        journaled entry is fingerprint-verified (pid + start time):
        survivors become AdoptedProc members awaiting their reconnect
        re-announcement; dead or recycled pids are replaced by fresh
        spawns of the same slot (bumped generation). Returns True when
        at least one child was adopted."""
        self._m_restarts.inc()
        adopted = False
        max_slot = -1
        with self._sup_lock:
            for wid, w in (prior.get("workers") or {}).items():
                slot = int(w.get("slot", 0))
                gen = int(w.get("generation", 0))
                max_slot = max(max_slot, slot)
                pid = w.get("pid")
                kind = procs.classify_pid(pid, w.get("start_time"))
                if kind == "adopted":
                    proc = procs.AdoptedProc(pid, w.get("start_time"))
                    procs.register_spawned(proc)
                    rec = SupervisedWorker(wid, slot, proc=proc,
                                           generation=gen, adopted=True)
                    rec.performed = int(w.get("performed") or 0)
                    self.members[wid] = rec
                    adopted = True
                else:
                    # "recycled" = alive-but-mismatched start time (a
                    # stranger wearing the number: never touched, only
                    # replaced); "dead" is simply replaced
                    self._adopt_respawn.append((slot, gen + 1))
                self._m_adoptions[kind].inc()
                self.adoption_events.append(
                    {"worker": wid, "kind": kind, "pid": pid,
                     "slot": slot, "at": time.time()})
                log.warning("supervisor %s: incarnation %d %s prior "
                            "worker %s (pid %s)", self.run_label,
                            self.incarnation,
                            "re-adopts" if kind == "adopted"
                            else f"found {kind}", wid, pid)
            self.respawns_used = int(prior.get("respawns_used")
                                     or self.respawns_used)
            # fresh slots must never collide with journaled ones
            self._slot_seq = itertools.count(max_slot + 1)
        return adopted

    def _maybe_adopt_stray(self, wid: str, data: dict) -> None:
        """A progress hello from a worker this incarnation does not
        know — a survivor the (torn or stale) journal failed to name.
        Policy: adopted when its (pid, start_time) self-announcement
        verifies AND the pool has room; otherwise killed. Never
        ignored: an unknown live worker would keep taking tracker jobs
        while nobody owns its liveness — the leak this module exists
        to close."""
        if self.journal is None or not self._adoption_done:
            return  # non-journaled supervisors keep the old semantics;
            # mid-init hellos retry on the reporter's next beat
        pid = data.get("pid")
        start_time = data.get("start_time")
        if not pid:
            return  # a legacy hello carries no fingerprint: ignore
        if not procs.pid_matches(int(pid), start_time):
            return  # claimed fingerprint does not verify: not ours
        with self._sup_lock:
            if wid in self.members:
                return
            room = len(self.live_workers()) < self.n_workers
            if room:
                proc = procs.AdoptedProc(int(pid), start_time)
                procs.register_spawned(proc)
                slot = next(self._slot_seq)
                rec = SupervisedWorker(wid, slot, proc=proc,
                                       adopted=True)
                rec.performed = int(data.get("performed") or 0)
                self.members[wid] = rec
                self._m_adoptions["stray"].inc()
                self.adoption_events.append(
                    {"worker": wid, "kind": "stray", "pid": pid,
                     "slot": slot, "at": time.time()})
        if room:
            log.warning("supervisor %s: adopted stray rejoiner %s "
                        "(pid %s)", self.run_label, wid, pid)
            self._journal_write()
            return
        # over capacity: adopted-or-killed, never leaked — and never
        # double-adopted (the members check above is under the lock)
        log.warning("supervisor %s: killing stray rejoiner %s (pid %s)"
                    " — pool already whole", self.run_label, wid, pid)
        self._m_adoptions["killed_stale"].inc()
        self.adoption_events.append(
            {"worker": wid, "kind": "killed_stale", "pid": pid,
             "at": time.time()})
        self._progress.drop(wid)
        self.tracker.remove_worker(wid)
        try:
            procs.stop_process_group(
                procs.AdoptedProc(int(pid), start_time),
                term_first=False)
        except Exception:
            log.exception("killing stray worker %s failed", wid)

    # -------------------------------------------------- progress plane
    def _rec(self, wid: str) -> Optional[SupervisedWorker]:
        with self._sup_lock:
            return self.members.get(wid)

    def _on_worker_alive(self, wid: str) -> None:
        rec = self._rec(wid)
        if rec is None or rec.state in (EVICTED, DEAD):
            return  # never heartbeat an evicted member back in
        self.tracker.heartbeat(wid)
        if rec.state == STARTING:
            with self._sup_lock:
                rec.state = RUNNING
                rec.connected = True

    def _on_worker_progress(self, wid: str, data: dict) -> None:
        rec = self._rec(wid)
        if rec is None:
            # an unknown rejoiner from a previous incarnation:
            # adopt-or-kill (never leak, never double-adopt)
            self._maybe_adopt_stray(wid, data)
            return
        if rec.state in (EVICTED, DEAD):
            return
        now = time.monotonic()
        with self._sup_lock:
            if data.get("last_seq") is not None:
                rec.last_seq = int(data["last_seq"])
            advanced = False
            performed = int(data.get("performed", rec.performed))
            if performed > rec.performed:
                rec.performed = performed
                rec.last_step = performed
                rec.last_progress_t = now
                rec.job_seen_t = None  # its dispatch completed
                advanced = True
            job_s = data.get("job_s")
            if job_s is not None and advanced:
                if rec.performed == 1:
                    # a member's FIRST job carries its cold start (CUDA
                    # context, kernel library) — counting it would
                    # straggler-flag every freshly (re)spawned worker
                    return
                rec.job_seconds.append(float(job_s))

    def _on_worker_gone(self, wid: str) -> None:
        rec = self._rec(wid)
        if rec is None:
            return
        with self._sup_lock:
            rec.connected = False
        # no explicit eviction here: heartbeats simply stop, and the
        # staleness sweep (the scaleout eviction contract) names it

    # ------------------------------------------------------ the monitor
    def _tick(self) -> None:
        """One supervision pass, run inside the master poll loop."""
        if self._aborted:
            raise SupervisorAbort(self._aborted)
        now = time.monotonic()
        self._watch_waves(now)
        self._watch_processes(now)
        self._watch_progress(now)
        self._watch_stale()
        self._drain_respawn_queue(now)
        if self._capacity_lost_pending:
            self._capacity_lost_pending = False
            self._elastic_resume()
        self._maybe_abort()

    def _watch_waves(self, now: float) -> None:
        """Wave-close bookkeeping: latency histogram, autosave cadence,
        straggler verdicts (judged at wave boundaries, where every
        member just reported a comparable unit of work)."""
        if self.waves == self._last_waves_seen:
            return
        closed = self.waves - self._last_waves_seen
        self._last_waves_seen = self.waves
        opened_at = getattr(self, "_wave_opened_at", None)
        if opened_at is not None:
            self._m_wave_s.observe(max(0.0, now - opened_at))
        self._check_stragglers()
        self._waves_since_save += closed
        if (self.saver is not None and self.save_every_waves_elastic
                and self._waves_since_save
                >= self.save_every_waves_elastic):
            self._waves_since_save = 0
            self._save_checkpoint()

    def _watch_processes(self, now: float) -> None:
        """A spawned process that died before (or after) connecting is
        evicted on the spot — no need to wait out the heartbeat window
        when the exit status already names the death. A process that is
        ALIVE but never opened its progress socket within
        `startup_grace` (hung mid-boot: it holds no job, sends no
        heartbeat, and would pin `_expecting_capacity` — and with it
        the wave barrier — forever) is evicted on the same grace the
        watermark gives a first job."""
        with self._sup_lock:
            recs = [r for r in self.members.values()
                    if r.state in (STARTING, RUNNING, SUSPECT)
                    and r.proc is not None]
        for rec in recs:
            if rec.proc.poll() is not None:
                reason = ("spawn_failed" if rec.state == STARTING
                          else "stale")
                self._evict(rec, reason,
                            detail=f"process exited "
                                   f"rc={rec.proc.returncode}")
            elif (rec.state == STARTING
                  and now - rec.spawned_at >= self.startup_grace):
                self._evict(rec, "spawn_failed",
                            detail=f"never connected within "
                                   f"{self.startup_grace:.0f}s")

    def _watch_progress(self, now: float) -> None:
        """The progress watermark: a worker HOLDING a dispatched job
        whose performed-count has not advanced within the window is
        hung — heartbeats (TCP-held or otherwise) notwithstanding."""
        assigned = {j.worker_id for j in self.tracker.jobs()}
        with self._sup_lock:
            recs = [r for r in self.members.values()
                    if r.state in (RUNNING, SUSPECT, STARTING)]
        for rec in recs:
            if rec.id in assigned:
                if rec.job_seen_t is None:
                    rec.job_seen_t = now
                    continue
                window = (self.progress_timeout if rec.performed > 0
                          else max(self.progress_timeout,
                                   self.startup_grace))
                stalled = now - max(rec.job_seen_t, rec.last_progress_t)
                if stalled >= window:
                    self._evict(
                        rec, "hung",
                        detail=f"no step progress for "
                               f"{stalled:.1f}s with a dispatched job "
                               f"(window {window:.1f}s)")
            else:
                rec.job_seen_t = None

    def _watch_stale(self) -> None:
        """Staleness sweep twin of runtime._evict_stale, but the
        supervisor ALSO owns the process: kill the group, requeue the
        orphan, schedule the respawn. (The base _evict_stale that runs
        after us finds nothing left to do.)"""
        for wid in self.tracker.stale_workers():
            rec = self._rec(wid)
            if rec is not None and rec.state not in (EVICTED, DEAD):
                self._evict(rec, "stale", detail="heartbeat timeout")

    def _check_stragglers(self) -> None:
        with self._sup_lock:
            live = [r for r in self.members.values()
                    if r.state in (RUNNING, SUSPECT)]
            means = [(r, r.mean_job_s()) for r in live]
            means = [(r, m) for r, m in means
                     if m is not None
                     and len(r.job_seconds) >= self.straggler_min_samples]
            if len(means) < 2:
                return
            flagged = []
            for rec, mean in means:
                # median of the OTHER members: with a small pool a
                # straggler drags a whole-pool median up with it and
                # could never exceed factor x its own contribution
                med = float(np.median([m for r, m in means
                                       if r is not rec]))
                if med <= 0:
                    continue
                if mean > self.straggler_factor * med:
                    rec.straggler_strikes += 1
                    if rec.state == RUNNING:
                        rec.state = SUSPECT
                    self._m_straggler.inc()
                    log.warning(
                        "supervisor %s: worker %s flagged straggler "
                        "(%.3fs/job vs wave median %.3fs, strike %d/%d)",
                        self.run_label, rec.id, mean, med,
                        rec.straggler_strikes, self.straggler_strikes)
                    if rec.straggler_strikes >= self.straggler_strikes:
                        flagged.append((rec, mean, med))
                else:
                    rec.straggler_strikes = 0
                    if rec.state == SUSPECT:
                        rec.state = RUNNING
        for rec, mean, med in flagged:
            self._evict(rec, "straggler",
                        detail=f"{mean:.3f}s/job vs median {med:.3f}s "
                               f"x{self.straggler_factor:g}")

    # -------------------------------------------------------- eviction
    def _evict(self, rec: SupervisedWorker, reason: str,
               detail: str = "") -> None:
        with self._sup_lock:
            if rec.state in (EVICTED, DEAD):
                return
            rec.state = EVICTED
            rec.evicted_at = time.monotonic()
            rec.eviction_reason = f"{reason}: {detail}" if detail \
                else reason
        log.warning("supervisor %s: evicting worker %s (%s)",
                    self.run_label, rec.id, rec.eviction_reason)
        self._m_evictions[reason].inc()
        # sever its telemetry plane FIRST: a SIGSTOP'd worker's kernel-
        # held socket must not heartbeat it back into the tracker
        self._progress.drop(rec.id)
        # reclaim the process BEFORE deciding the orphan's fate
        # (SIGKILL: a hung/stopped member will not honor SIGTERM). A
        # LIVE worker evicted between its add_update and clear_job RPCs
        # would otherwise race the check below — once the process is
        # dead and reaped, no further update can land.
        if rec.proc is not None:
            try:
                WorkerSpawner.stop(rec.proc, term_first=False)
            except Exception:
                log.exception("killing evicted worker %s failed", rec.id)
        # the scaleout eviction contract: remove + requeue the orphan —
        # UNLESS the worker already delivered its update (it died
        # between add_update and clear_job): the update will fold, so
        # redoing the job would train the same batch twice
        orphan = self.tracker.remove_worker(rec.id)
        if (orphan is not None and orphan.result is None
                and rec.id not in self.tracker.worker_updates()):
            from deeplearning4j_tpu_torch.scaleout.api import Job

            self._orphan_jobs.append(Job(work=orphan.work,
                                         worker_id=orphan.worker_id,
                                         retries=orphan.retries,
                                         seq=orphan.seq))
        self._schedule_respawn(rec)
        self._journal_write()

    def _schedule_respawn(self, rec: SupervisedWorker) -> None:
        with self._sup_lock:
            if self.respawns_used >= self.max_respawns:
                rec.state = DEAD
                log.error(
                    "supervisor %s: respawn budget exhausted (%d/%d) — "
                    "capacity durably lost at slot %d",
                    self.run_label, self.respawns_used,
                    self.max_respawns, rec.slot)
                self._capacity_lost_pending = True
                return
            self.respawns_used += 1
            gen = rec.generation + 1
            backoff = self.respawn_backoff_s * (2 ** (gen - 1))
            self._respawn_queue.append({
                "slot": rec.slot, "generation": gen,
                "not_before": time.monotonic() + min(backoff, 30.0)})

    def _drain_respawn_queue(self, now: float) -> None:
        with self._sup_lock:
            due = [e for e in self._respawn_queue
                   if e["not_before"] <= now]
            self._respawn_queue = [e for e in self._respawn_queue
                                   if e["not_before"] > now]
        for entry in due:
            try:
                self._spawn_slot(entry["slot"], entry["generation"])
                self._m_respawns.inc()
            except Exception:
                log.exception("supervisor %s: respawn of slot %d failed",
                              self.run_label, entry["slot"])
                # count the failed attempt against the budget and retry
                # with doubled backoff (or declare capacity lost)
                fake = SupervisedWorker(
                    self._worker_id(entry["slot"], entry["generation"]),
                    entry["slot"], proc=None,
                    generation=entry["generation"])
                fake.state = EVICTED
                self._schedule_respawn(fake)

    def _expecting_capacity(self) -> bool:
        """Replacements in flight: queued respawns, or spawned members
        that have not yet connected (STARTING). While true, an open
        wave's barrier waits for the respawned member instead of
        closing early on the survivors."""
        with self._sup_lock:
            if self._respawn_queue:
                return True
            return any(r.state == STARTING
                       for r in self.members.values())

    def _maybe_abort(self) -> None:
        with self._sup_lock:
            live = len(self.live_workers())
            pending = len(self._respawn_queue)
        if live == 0 and pending == 0 and not self._capacity_lost_pending:
            self._aborted = (
                "no live workers and no respawn capacity left "
                f"(respawns used {self.respawns_used}/"
                f"{self.max_respawns})")
            raise SupervisorAbort(self._aborted)

    # ------------------------------------------------------ checkpoints
    @staticmethod
    def shard_params(params: np.ndarray, n_shards: int):
        """Split the packed params into one shard per worker — the
        checkpoint carries the run's topology in its shard table, and a
        restore onto fewer survivors is a true resharded reassembly
        (checkpoint/format.py coverage-checked stitch), not a file copy."""
        from deeplearning4j_tpu_torch.checkpoint import format as ckfmt

        vec = np.asarray(params)
        n = max(1, int(n_shards))
        if vec.ndim != 1 or n == 1 or vec.size < n:
            return vec
        bounds = np.linspace(0, vec.size, n + 1, dtype=np.int64)
        shards = [
            ckfmt.HostShard(((int(lo), int(hi)),), vec[lo:hi].copy())
            for lo, hi in zip(bounds[:-1], bounds[1:])]
        return ckfmt.HostLeaf(dtype=ckfmt._dtype_name(vec.dtype),
                              shape=(int(vec.size),), shards=shards)

    def _exact_cursor(self) -> int:
        """The stream position a resume may safely seek to: the length
        of the CONTIGUOUS folded prefix (plus finally-dropped jobs),
        capped by the base cursor. A wave that closed around a
        carried-over orphan folds seqs out of order; counting folds
        alone would then label work as trained that never was —
        undershooting merely re-trains a batch (averaging tolerates
        it), overshooting silently loses one."""
        folded = set(self.folded_seqs)
        k = 0
        while k in folded:
            k += 1
        dropped = int(self.tracker.count(JOBS_DROPPED))
        return int(min(self._resume_cursor(), k + dropped))

    def _save_checkpoint(self, wait: bool = False) -> Optional[str]:
        if self.saver is None:
            return None
        current = self.tracker.get_current()
        if current is None:
            return None
        cursor = self._exact_cursor()
        if cursor == self._last_saved_step:
            # never re-save an already-committed step: rewriting tears
            # the existing committed dir open for the write window
            return None
        self._last_saved_step = cursor
        payload = {
            "format_version": 3,
            "conf_json": self.conf_json,
            "params": self.shard_params(np.asarray(current),
                                        len(self.live_workers())),
            "updater_state": None,
            "iteration_count": self.waves,
            "iterator_position": cursor,
            "metadata": {"waves": self.waves,
                         "n_workers": len(self.live_workers()),
                         "run": self.run_label},
            "saved_at": time.time(),
        }
        mesh_spec = {"axes": {"workers": len(self.live_workers())},
                     "strategy": "iterative_reduce"}
        return self.saver.save(payload, step=cursor,
                               mesh_spec=mesh_spec, wait=wait)

    def _apply_initial_resume(self, request: str) -> None:
        """`resume="auto"` (or an explicit checkpoint path): seed the
        run from the newest COMMITTED step before any worker trains."""
        from deeplearning4j_tpu_torch.checkpoint.restore import discover_latest

        path = (self.checkpoint_dir if request == "auto" else request)
        if path is None:
            raise ValueError(
                "resume='auto' needs checkpoint_dir to discover from")
        try:
            root, step = discover_latest(path)
        except FileNotFoundError:
            return  # nothing saved yet: a fresh run
        except Exception as e:
            if request == "auto" and "no sharded checkpoint steps" in str(e):
                return  # fresh dir: auto-resume means "resume if any"
            raise
        self._restore_from(root, step, initial=True)

    def _restore_from(self, root: str, step: int,
                      initial: bool = False) -> dict:
        from deeplearning4j_tpu_torch.checkpoint.restore import \
            load_payload_tree

        payload, manifest = load_payload_tree(root, step)
        params = payload.get("params")
        if params is not None and not isinstance(params, np.ndarray):
            # the loader's tensor, or a tree checkpoint (e.g. written by
            # a trainer): pack it in the canonical sorted-key ravel order
            # convert.py documents
            from deeplearning4j_tpu_torch.checkpoint.convert import \
                ravel_tree

            params = ravel_tree(params)
        cursor = int(payload.get("iterator_position") or 0)
        src_workers = ((manifest.get("mesh") or {}).get("axes") or {}) \
            .get("workers")
        survivors = max(1, len(self.live_workers())) if not initial \
            else self.n_workers
        resharded = (src_workers is not None
                     and int(src_workers) != survivors)
        self.tracker.set_current(np.asarray(params))
        self.job_iterator.seek(cursor)
        # re-baseline the stream accounting at the checkpoint cursor:
        # everything before it is IN the restored params, everything
        # after it will be re-dispatched exactly once
        self.jobs_consumed = cursor
        self.jobs_aggregated = cursor
        dropped = self.tracker.count(JOBS_DROPPED)
        if dropped:
            self.tracker.increment(JOBS_DROPPED, -dropped)
        # re-baseline the audit trail: the restored params embody the
        # stream prefix [0, cursor) — including any dropped-job gaps
        # the checkpoint's cursor accounted for. Keeping a gap here
        # would stall _exact_cursor below the restore point forever
        # (every later save would re-hit the same step).
        self.folded_seqs = list(range(cursor))
        self._seq_of.clear()
        event = {"step": step, "cursor": cursor,
                 "source_workers": src_workers,
                 "survivors": survivors,
                 "resharded": resharded, "initial": initial,
                 "at": time.time()}
        self.resume_events.append(event)
        self._m_resumes["resharded" if resharded
                        else "same_topology"].inc()
        log.warning("supervisor %s: %s from checkpoint step %d "
                    "(cursor %d, %s -> %d workers)", self.run_label,
                    "seeded" if initial else "elastic resume",
                    step, cursor, src_workers, survivors)
        return event

    # --------------------------------------------------- elastic resume
    def _elastic_resume(self) -> None:
        """Capacity durably lost: restart the wave from the last
        COMMITTED checkpoint on the surviving topology. Ladder position
        two of three (respawn -> reshard-resume -> abort)."""
        survivors = self.live_workers()
        if not survivors:
            return  # abort path handles zero capacity
        t0 = time.monotonic()
        if self.saver is not None:
            # make any in-flight save durable BEFORE asking what the
            # newest committed step is
            try:
                self.saver.flush(timeout=60.0)
            except Exception:
                log.exception("flush before elastic resume failed")
        if self.saver is None or self.saver.latest_step() is None:
            # no checkpoint to roll back to: shrink the pool in place —
            # un-aggregated work is already requeued as orphans, so the
            # run continues smaller with nothing lost
            self.n_workers = len(survivors)
            log.warning(
                "supervisor %s: capacity lost with no committed "
                "checkpoint; continuing on %d survivor(s)",
                self.run_label, self.n_workers)
            return
        step = self.saver.latest_step()
        # drain survivors' in-flight jobs: a cleared-but-still-running
        # job would later report an update for work the rollback is
        # about to re-dispatch — wait for those updates, then discard
        # the whole pending set atomically
        live_ids = {r.id for r in survivors}
        drain_by = time.monotonic() + max(10.0, self.progress_timeout)
        while (any(j.worker_id in live_ids for j in self.tracker.jobs())
               and time.monotonic() < drain_by):
            time.sleep(self.interval)
        for job in self.tracker.jobs():
            self.tracker.clear_job(job.worker_id)
        self.tracker.clear_updates()
        self._orphan_jobs.clear()
        self._wave_size = 0
        event = self._restore_from(self.checkpoint_dir, step)
        self.n_workers = len(survivors)
        event["recovery_s"] = round(time.monotonic() - t0, 4)

    # ------------------------------------------------------ run surface
    def run(self, timeout: float = 300.0) -> np.ndarray:
        self.spawn_workers()
        ok = False
        try:
            final = super().run(timeout=timeout)
            if self.saver is not None and final is not None:
                self._save_checkpoint(wait=True)
            ok = True
            return final
        finally:
            # a failing run with a journal HANDS ITS CHILDREN OFF to
            # the next incarnation (the watchdog restarts us); a clean
            # finish tears everything down and clears the journal
            self.close(handoff=not ok)

    def close(self, handoff: bool = False) -> None:
        """Stop worker processes, the progress plane, and the saver.
        Safe to call repeatedly (run() calls it on every exit path).

        `handoff=True` (only meaningful with a journal): the control
        plane is dying but the RUN is not — leave the warm worker
        processes alive for the next incarnation to re-adopt. The
        journal gets a final commit naming them, they are released
        from THIS incarnation's atexit orphan sweep
        (procs.release_spawned — the sweep is scoped to what the
        current incarnation still owns), and the tracker is NOT
        finished, so workers enter their bounded reconnect loop
        instead of exiting."""
        if handoff and self.journal is not None:
            with self._sup_lock:
                self._respawn_queue.clear()
                recs = [r for r in self.members.values()
                        if r.proc is not None
                        and r.state not in (EVICTED, DEAD)]
            self._journal_write()
            for rec in recs:
                procs.release_spawned(rec.proc)
            log.warning(
                "supervisor %s: handing %d live worker(s) off to the "
                "next incarnation (journal %s)", self.run_label,
                len(recs), self.journal.path)
            self._progress.close()
            if self.saver is not None:
                try:
                    self.saver.close(timeout=60.0)
                except Exception:
                    log.exception("closing checkpoint writer failed")
                self.saver = None
            return
        self.tracker.finish()  # workers exit their loops
        with self._sup_lock:
            recs = [r for r in self.members.values()
                    if r.proc is not None]
            self._respawn_queue.clear()
        for rec in recs:
            try:
                WorkerSpawner.stop(rec.proc, timeout=5.0)
            except Exception:
                log.exception("stopping worker %s failed", rec.id)
        self._progress.close()
        if self.saver is not None:
            try:
                self.saver.close(timeout=60.0)
            except Exception:
                log.exception("closing checkpoint writer failed")
            self.saver = None
        if self.journal is not None:
            # nothing is handed off: a stale journal must not trick
            # the next incarnation into adopting recycled pids (the
            # fingerprints would reject them, but why leave the trap)
            self.journal.clear()

    # --------------------------------------------------- observability
    def _status_extra(self) -> Dict[str, Any]:
        with self._sup_lock:
            workers = {wid: rec.snapshot()
                       for wid, rec in self.members.items()}
        return {
            "workers": workers,
            "states": self.state_counts(),
            "respawns_used": self.respawns_used,
            "max_respawns": self.max_respawns,
            "min_workers": self.min_workers,
            "resumes": list(self.resume_events),
            "folded_jobs": len(self.folded_seqs),
            "checkpoint_dir": self.checkpoint_dir,
            "incarnation": self.incarnation,
            "state_dir": self.state_dir,
            "adoptions": list(self.adoption_events),
        }

    def _health(self) -> Dict[str, Any]:
        """Quorum verdict for /healthz: 503 once fewer than
        `min_workers` members are live — the signal a cluster manager
        watches to replace the whole run."""
        live = len(self.live_workers())
        return {"ok": live >= self.min_workers,
                "live_workers": live,
                "min_workers": self.min_workers,
                "respawns_used": self.respawns_used,
                "incarnation": self.incarnation}
