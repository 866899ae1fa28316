"""Elastic serving fleet: health-tracked replicas behind a router tier.

The port's counterpart of the JAX package's `serving/fleet.py`: the same
classes, arguments, defaults, states, HTTP shapes and metric names. It is
host code only; every replica is a port `serve_network` server whose
decode loop runs the flash-attention (K1) and paged-decode (K4) kernels
on its own device.

`serving/replicas.py` scales one process across local devices; this
module scales across PROCESSES (and hosts): a `Fleet` owns N replica
endpoints — each a full `serve_network` server, spawned locally by a
`ReplicaSpawner` (`python -m deeplearning4j_tpu_torch.cli serve`) or
attached by URL — and the router (`serving/router.py`) dispatches over
them. The design deliberately reuses the scaleout control-plane idioms:
replica health IS worker health, so the fleet rides the scaleout
`InMemoryStateTracker` — `tracker.heartbeat()` on every successful
liveness probe (which re-registers an evicted member, the tracker's
elasticity contract), `tracker.stale_workers()` to find the dead. The
readiness split hides a replica's spin-up (weights to the device, the
warmup forwards, kernel builds) behind the router — `/healthz` up but
`/readyz` 503 means "alive, still warming up", and the router admits it
only when readiness lands.

Several spawned replicas may share one CUDA device: each is its own
process with its own CUDA context (spawned with `subprocess.Popen`, a
fresh interpreter; a process holding a CUDA context is never forked).

Replica lifecycle:

```
 attach()/spawn()          readyz ok                 heartbeat stale /
      │                       │                      conn refused
      ▼                       ▼                            │
  STARTING ───────────────► READY ◄────────────────┐       ▼
                              │     readyz ok      │   EVICTED ◄──┐
                              │  (readmission)     └───────┤      │
                     drain for reload/retire               │ probes keep
                              ▼                            │ running: a
                          DRAINING ──► READY / retired     │ rejoining
                                                           └─ replica is
                                                              readmitted
```

Routing is least-outstanding-requests over READY replicas (round-robin
tiebreak — the same policy `ReplicaSet` applies intra-process), with:

- **retries**: idempotent `/predict` replays on a healthy peer after a
  connection failure, request timeout, or replica 5xx — under an
  explicit `retry_budget`, with each hop's socket timeout derived from
  the request's remaining `deadline_ms` budget (docs/SERVING.md
  "Deadlines") so a hung replica costs a slice of the budget, not the
  fixed 30s client timeout; a connection-level failure also evicts the
  replica immediately (faster than the heartbeat timeout — the monitor
  readmits it when it answers `/readyz` again).
- **hung-replica defense**: a request TIMEOUT marks the replica
  SUSPECT (deprioritized, still probed) and feeds its per-replica
  circuit breaker — closed → open after `breaker_threshold`
  consecutive timeouts (the replica is EVICTED: hung-but-TCP-alive
  members, e.g. SIGSTOP'd or with a wedged handler pool, answer
  health probes the heartbeat path trusts) → half-open after
  `breaker_reset_s` (one `/readyz` probe) → closed on success
  (readmission). One pathological request still cannot evict a
  replica; N consecutive ones can (docs/FLEET.md "Chaos runbook").
- **load shedding**: total in-flight past `shed_high_water` answers
  503 + `Retry-After` + `{"error": "overloaded", ...}` before any
  replica is touched — PER TIER: the batch lane has its own lower
  `batch_high_water` (default half the global mark) so bulk work sheds
  while interactive admission still has headroom, and every shed reply
  names the shed tier and derives Retry-After from THAT tier's backlog
  (docs/FLEET.md "Per-tier shedding & autoscaling").
- **rolling/canary reload** (`rolling_reload`): drain -> per-replica
  `POST /reload` -> `/readyz` probe (-> optional `/predict` validation
  probe) -> readmit, one replica at a time; the first replica is the
  canary — if it fails, replicas already on the new checkpoint roll
  back to the previous one automatically and the fleet stays
  consistent. A replica whose `/reload` itself failed kept its old
  weights (the engine's validated atomic swap), so only
  probe-stage failures need a rollback of the failed member.
- **autoscaling hook** (`Autoscaler` + a spawner): queue-depth
  (outstanding-per-replica) signals spawn or retire replicas between
  `min_replicas`/`max_replicas` with a cooldown; `scale_to(n)` is the
  manual twin (router `POST /scale`).
- **crash-safe control plane** (`state_dir=`): losing the router no
  longer strands (or worse, recompiles) the warm fleet. Every
  membership transition journals replica endpoints, states, and spawn
  fingerprints (pid + /proc start time) through a `utils/statefile.py`
  StateFile (`fleet.journal`, the checkpoint layer's atomic-rename
  commit idiom), and a restarted incarnation re-adopts the journaled
  world instead of respawning it: attached URLs re-attach, spawned
  replicas whose fingerprints verify become `AdoptedProc` members
  (released from the previous incarnation's atexit sweep via
  `procs.release_spawned` on a handoff close — and simply surviving a
  SIGKILL, which runs no sweep at all), and the ordinary `/readyz`
  probe readmits each one WARM — zero replica respawns, zero engine
  recompiles. Dead or recycled pids are skipped (the
  spawner/autoscaler replaces them); a torn journal degrades to a
  fresh spawn, never a crash. `cli watchdog` supervises the router
  itself (docs/FLEET.md "Router restart runbook").

Telemetry (`dl4j_fleet_*` + `dl4j_controlplane_*`,
docs/OBSERVABILITY.md): `dl4j_fleet_replicas{state=}` gauges,
request/retry/shed/eviction/readmission/reload counters, per-route
latency histograms, `dl4j_fleet_outstanding`; control-plane restarts,
adoptions by kind, journal write/commit histograms, incarnation gauge.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import subprocess
import sys
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.scaleout.statetracker import InMemoryStateTracker
from deeplearning4j_tpu_torch.utils import procs
from deeplearning4j_tpu_torch.utils.statefile import StateFile
from deeplearning4j_tpu_torch.serving.errors import (DEADLINE_HEADER,
                                               PRIORITY_HEADER,
                                               TIER_BATCH, TIER_INTERACTIVE,
                                               TIERS, Deadline,
                                               OverloadedError,
                                               backlog_retry_ms)
from deeplearning4j_tpu_torch.serving.router import ReplicaClient

__all__ = ["Fleet", "FleetReplica", "ReplicaSpawner", "Autoscaler",
           "CircuitBreaker", "NoReadyReplicas",
           "STARTING", "READY", "SUSPECT", "DRAINING", "EVICTED"]

log = logging.getLogger(__name__)

STARTING = "starting"
READY = "ready"
#: READY member with recent request timeouts: still alive by every
#: probe, deprioritized for routing, one breaker trip from EVICTED
SUSPECT = "suspect"
DRAINING = "draining"
EVICTED = "evicted"
STATES = (STARTING, READY, SUSPECT, DRAINING, EVICTED)

_fleet_seq = itertools.count()

#: rough per-request drain estimate feeding tier-aware Retry-After at
#: the fleet's shed sites: an interactive request is a short decode, a
#: batch request is a bulk stream — a shed bulk client should back off
#: proportionally longer (serving/errors.backlog_retry_ms)
_TIER_ITEM_MS = {TIER_INTERACTIVE: 50.0, TIER_BATCH: 250.0}


class NoReadyReplicas(RuntimeError):
    """No replica is in the READY state (the router answers 503)."""


class CircuitBreaker:
    """Per-replica request-timeout breaker (mutations happen under the
    owning fleet's lock).

    closed --(threshold consecutive timeouts)--> open
    open   --(reset_s elapsed, one /readyz probe)--> half_open
    half_open --(probe ok)--> closed | --(probe fails)--> open

    The heartbeat monitor sees liveness; THIS sees request progress —
    a SIGSTOP'd replica (the kernel keeps accepting into the listen
    backlog) or a wedged handler pool passes every health probe and
    only the breaker evicts it. Any success fully closes the breaker;
    one success is what a half-open trial is for."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, threshold: int = 3, reset_s: float = 2.0):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = int(threshold)
        self.reset_s = float(reset_s)
        #: a "consecutive" streak whose previous timeout is older than
        #: this is no streak at all — without the horizon, 2-of-3
        #: timeouts from a transient blip would arm the breaker
        #: forever, and ONE slow request hours later would evict a
        #: healthy replica (a suspect's probing trickle fires well
        #: inside this window, so real hangs still accumulate)
        self.streak_ttl_s = max(30.0, 10.0 * self.reset_s)
        self.state = self.CLOSED
        self.consecutive_timeouts = 0
        self.opened_at: Optional[float] = None
        self.last_timeout_at: Optional[float] = None
        self.opens = 0  # lifetime closed/half_open -> open transitions

    def record_timeout(self) -> bool:
        """Count one request timeout; returns True when this one OPENS
        the breaker (the caller evicts)."""
        now = time.monotonic()
        if (self.state == self.CLOSED
                and self.last_timeout_at is not None
                and now - self.last_timeout_at > self.streak_ttl_s):
            self.consecutive_timeouts = 0  # ancient streak: start over
        self.consecutive_timeouts += 1
        self.last_timeout_at = now
        trip = (self.state == self.HALF_OPEN
                or self.consecutive_timeouts >= self.threshold)
        if trip and self.state != self.OPEN:
            self.state = self.OPEN
            self.opened_at = time.monotonic()
            self.opens += 1
            return True
        if trip:
            self.opened_at = time.monotonic()  # re-arm the reset clock
        return False

    def record_success(self) -> None:
        self.consecutive_timeouts = 0
        self.state = self.CLOSED
        self.opened_at = None

    def allow_probe(self) -> bool:
        """True when a half-open `/readyz` probe may run: open breakers
        wait out `reset_s` first (and transition to half_open here)."""
        if self.state == self.OPEN:
            if (self.opened_at is not None
                    and time.monotonic() - self.opened_at >= self.reset_s):
                self.state = self.HALF_OPEN
                return True
            return False
        return True  # closed / half_open: probing is always fine

    def reopen(self) -> None:
        """A half-open probe failed: back to open, clock re-armed."""
        self.state = self.OPEN
        self.opened_at = time.monotonic()

    def snapshot(self) -> dict:
        return {"state": self.state,
                "consecutive_timeouts": self.consecutive_timeouts,
                "opens": self.opens,
                "threshold": self.threshold,
                "reset_s": self.reset_s}


class FleetReplica:
    """Router-side record of one replica endpoint. Mutable fields
    (`state`, `outstanding`, `failures`) are guarded by the owning
    fleet's lock."""

    def __init__(self, replica_id: str, client: ReplicaClient,
                 proc: Optional[subprocess.Popen] = None,
                 spawned: bool = False,
                 breaker: Optional[CircuitBreaker] = None,
                 adopted: bool = False):
        self.id = replica_id
        self.client = client
        self.proc = proc
        self.spawned = spawned
        self.adopted = adopted  # re-adopted from a prior incarnation
        #: /proc start-time fingerprint journaled next to the pid so a
        #: restarted router never adopts (or kills) a recycled pid
        self.start_time = (getattr(proc, "start_time", None)
                           or (procs.proc_start_time(proc.pid)
                               if proc is not None else None))
        self.state = STARTING
        self.outstanding = 0
        self.failures = 0          # consecutive request-path failures
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.last_ready: Optional[dict] = None
        #: last cumulative ship stats folded into the fleet counters
        #: (the /readyz kv_summary reports lifetime figures; the probe
        #: deltas them — see Fleet._fold_kv_summary)
        self.kv_seen: Optional[dict] = None
        self.admitted_at: Optional[float] = None
        self.evicted_at: Optional[float] = None
        self.eviction_reason: Optional[str] = None
        #: (model_id, role) pool this replica was spawned INTO —
        #: pool-scoped autoscaling attributes a STARTING member (no
        #: /readyz payload yet, so no announced identity) to the pool
        #: that spawned it instead of the default pool
        self.pool: Optional[Tuple[str, str]] = None

    @property
    def role(self) -> str:
        """Replica role announced in its last /readyz payload
        (docs/FLEET.md "Disaggregated roles"). "unified" until the
        first probe — a never-probed replica routes the legacy way."""
        return (self.last_ready or {}).get("role") or "unified"

    @property
    def model_id(self) -> Optional[str]:
        """Model this replica announced (None = single-model legacy;
        consumers normalize None to "default")."""
        return (self.last_ready or {}).get("model_id")

    def snapshot(self, now: Optional[float] = None) -> dict:
        now = now if now is not None else time.time()
        out = {"url": self.client.url, "state": self.state,
               "outstanding": self.outstanding,
               "failures": self.failures, "spawned": self.spawned,
               # what the replica itself says it serves ({path, step}
               # or None), from its last /readyz payload — the per-
               # replica identity the torn-promotion check aggregates
               "checkpoint": (self.last_ready or {}).get("checkpoint"),
               # disaggregated placement identity, from the same probe
               "role": self.role,
               "model_id": self.model_id,
               "breaker": self.breaker.snapshot()}
        if self.adopted:
            out["adopted"] = True
        if self.proc is not None:
            out["pid"] = self.proc.pid
            out["proc_alive"] = self.proc.poll() is None
        if self.admitted_at is not None:
            out["admitted_age_s"] = round(now - self.admitted_at, 3)
        if self.state == EVICTED and self.evicted_at is not None:
            out["evicted_age_s"] = round(now - self.evicted_at, 3)
            out["eviction_reason"] = self.eviction_reason
        return out


# spawned replica processes still alive, reaped at interpreter exit: a
# router that dies without close() must not leak live replica servers
# holding ports. Each replica runs in its OWN session/process group
# (start_new_session); the registry, atexit sweep, and group-kill
# discipline are shared with the training supervisor's WorkerSpawner
# (utils/procs.py holds the pid/pgid-recycling rationale). The module
# aliases keep the historical names on fleet's surface.
_SPAWNED_PROCS = procs.SPAWNED_PROCS
_register_spawned = procs.register_spawned
_unregister_spawned = procs.unregister_spawned
_kill_spawned_orphans = procs.kill_spawned_orphans


class ReplicaSpawner:
    """Spawns local replica server processes (`cli serve` with async
    warmup) and reads each one's announce line for its URL.

    `cli serve` runs on the CUDA device unless `serve_args` carry
    `--device cpu`; a replica asked for the card on a machine without
    one exits non-zero before announcing, and its spawn raises with the
    output tail (it never falls back to the CPU).

    This is the single-host spawner (the autoscaling hook's local
    backend and the test/bench harness); a multi-host deployment
    attaches remote replicas by URL instead and brings its own process
    manager. Every spawn lands in its own process group and a
    module-level atexit sweep SIGKILLs whatever `stop()` never reaped —
    a router crash-exit cannot orphan replica servers on live ports."""

    def __init__(self, model_path: str, *, host: str = "127.0.0.1",
                 serve_args: Sequence[str] = (),
                 env: Optional[dict] = None,
                 python: Optional[str] = None,
                 announce_timeout: float = 180.0):
        self.model_path = str(model_path)
        self.host = host
        self.serve_args = list(serve_args)
        self.env = dict(env) if env is not None else dict(os.environ)
        # replicas inherit the parent's program store, so respawns and
        # autoscale spin-ups load the kernel library and replay the
        # warmup plan instead of building them
        from deeplearning4j_tpu_torch import compilecache
        compilecache.export_env(self.env)
        self.python = python or sys.executable
        self.announce_timeout = float(announce_timeout)

    def command(self, port: int = 0) -> List[str]:
        return ([self.python, "-m", "deeplearning4j_tpu_torch.cli", "serve",
                 "-m", self.model_path, "--host", self.host,
                 "--port", str(port), "--warmup-async"]
                + self.serve_args)

    def spawn(self, port: int = 0
              ) -> Tuple[subprocess.Popen, str]:
        """Launch one replica process; returns (proc, url). The
        replica announces fast (async warmup) — readiness is gated by
        its /readyz, not by this call. The process gets its own
        session/group and is registered for atexit orphan cleanup."""
        proc = subprocess.Popen(
            self.command(port), env=self.env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True)
        _register_spawned(proc)
        try:
            url = self._read_announce(proc)
        except BaseException:
            _unregister_spawned(proc)
            raise
        return proc, url

    def _read_announce(self, proc: subprocess.Popen) -> str:
        """First stdout line is the serve announce JSON; a stdout drain
        thread keeps running afterwards so the child never blocks on a
        full pipe (its tail is kept for post-mortem errors)."""
        tail: deque = deque(maxlen=50)
        found: List[str] = []
        got = threading.Event()

        def drain():
            for line in proc.stdout:
                tail.append(line.rstrip())
                if not found and line.lstrip().startswith("{"):
                    try:
                        if "serving" in json.loads(line):
                            found.append(line)
                            got.set()
                    except ValueError:
                        pass
            got.set()  # EOF

        t = threading.Thread(target=drain, daemon=True,
                             name="replica-announce")
        t.start()
        if not got.wait(self.announce_timeout) or not found:
            why = (f"produced no announce line within "
                   f"{self.announce_timeout}s")
            if got.is_set():  # EOF: the replica exited before announcing
                try:
                    why = (f"exited with code {proc.wait(timeout=10)} "
                           "before announcing")
                except subprocess.TimeoutExpired:
                    pass
            proc.kill()
            raise RuntimeError(
                f"replica process {why}; output tail:\n" + "\n".join(tail))
        return json.loads(found[0])["serving"]

    @staticmethod
    def stop(proc: subprocess.Popen, timeout: float = 10.0) -> None:
        """Terminate a spawned replica and its whole process group —
        TERM the group (leader un-reaped: raceless), give it the
        graceful window, KILL stragglers. Ordering rationale lives in
        utils/procs.stop_process_group."""
        procs.stop_process_group(proc, timeout=timeout)


class Autoscaler:
    """Queue-depth-driven scaling policy: spawn when mean outstanding
    per ready replica crosses `scale_up_at`, retire when it falls under
    `scale_down_at`, bounded by [min_replicas, max_replicas] with a
    cooldown between actions. Pure policy — the Fleet applies the
    decision (`Fleet.autoscale_tick`), so tests drive it with synthetic
    load and a fake spawner.

    The BATCH tier feeds a second, backlog-shaped signal
    (docs/FLEET.md "Per-tier shedding & autoscaling"): bulk streams
    queue patiently behind replica admission instead of inflating
    instantaneous queue depth the way an interactive burst does, so
    batch scales up on `batch_backlog >= batch_backlog_up_at` (how much
    bulk work is parked, not how fast it arrives) and the fleet never
    scales DOWN while any batch backlog exists — idle capacity is
    exactly what the bulk lane is there to soak."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 4,
                 scale_up_at: float = 4.0, scale_down_at: float = 0.5,
                 cooldown_s: float = 10.0,
                 batch_backlog_up_at: int = 8):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}")
        if batch_backlog_up_at < 1:
            raise ValueError(
                f"batch_backlog_up_at must be >= 1, got "
                f"{batch_backlog_up_at}")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_at = float(scale_up_at)
        self.scale_down_at = float(scale_down_at)
        self.cooldown_s = float(cooldown_s)
        self.batch_backlog_up_at = int(batch_backlog_up_at)
        self._last_action = 0.0

    def decide(self, n_replicas: int, outstanding: int,
               batch_backlog: int = 0) -> int:
        """-1 / 0 / +1 given live replica count, total in-flight, and
        the batch tier's parked backlog."""
        if n_replicas < self.min_replicas:
            return 1  # below floor: act regardless of cooldown
        if time.monotonic() - self._last_action < self.cooldown_s:
            return 0
        per = outstanding / max(1, n_replicas)
        if per >= self.scale_up_at and n_replicas < self.max_replicas:
            return 1
        if (batch_backlog >= self.batch_backlog_up_at
                and n_replicas < self.max_replicas):
            return 1
        if (per <= self.scale_down_at and n_replicas > self.min_replicas
                and batch_backlog == 0):
            return -1
        return 0

    def note_action(self) -> None:
        self._last_action = time.monotonic()


class Fleet:
    """N replica endpoints + health tracking + dispatch policy."""

    def __init__(self, *, spawner: Optional[ReplicaSpawner] = None,
                 heartbeat_interval: float = 0.5,
                 heartbeat_timeout: float = 3.0,
                 shed_high_water: Optional[int] = None,
                 batch_high_water: Optional[int] = None,
                 probe_timeout: float = 2.0,
                 request_timeout: float = 60.0,
                 generate_timeout: float = 300.0,
                 retry_budget: int = 2,
                 stream_resume_attempts: int = 2,
                 breaker_threshold: int = 3,
                 breaker_reset_s: Optional[float] = None,
                 autoscaler: Optional[Autoscaler] = None,
                 initial_checkpoint: Optional[str] = None,
                 name: Optional[str] = None,
                 state_dir: Optional[str] = None,
                 start: bool = True):
        self.spawner = spawner
        self.autoscaler = autoscaler
        self.heartbeat_interval = float(heartbeat_interval)
        self.shed_high_water = shed_high_water
        #: the BATCH tier's own (lower) high-water mark: bulk work
        #: sheds while interactive admission is still wide open, so an
        #: interactive burst always finds headroom. Default: half the
        #: global mark. Per-tier in-flight is tracked fleet-side
        #: (`_tier_inflight`, select/release twins).
        if batch_high_water is not None:
            if batch_high_water < 1:
                raise ValueError(
                    f"batch_high_water must be >= 1, got "
                    f"{batch_high_water}")
            self.batch_high_water: Optional[int] = int(batch_high_water)
        elif shed_high_water is not None:
            self.batch_high_water = max(1, int(shed_high_water) // 2)
        else:
            self.batch_high_water = None
        self._tier_inflight = {t: 0 for t in TIERS}
        #: monitor probes use this short dedicated timeout, never the
        #: ReplicaClient default — and the sweep probes replicas
        #: CONCURRENTLY, so one hung replica costs the sweep one probe
        #: timeout instead of stalling every later probe past the
        #: heartbeat window
        self.probe_timeout = float(probe_timeout)
        self.request_timeout = float(request_timeout)
        self.generate_timeout = float(generate_timeout)
        #: retries (attempts after the first) forward_predict may spend
        #: on peers after a failure; deadline budgets are split across
        #: the attempts this allows
        self.retry_budget = max(0, int(retry_budget))
        #: mid-stream /generate failovers the router may attempt per
        #: client request: each resume re-admits the interrupted rows
        #: on a surviving replica with `prompt + delivered tokens` as
        #: the continuation context (docs/FLEET.md "Stream failover");
        #: 0 restores the pre-failover fail-fast behavior
        self.stream_resume_attempts = max(0, int(stream_resume_attempts))
        self.breaker_threshold = int(breaker_threshold)
        #: open -> half_open wait; default: a few monitor passes
        self.breaker_reset_s = (float(breaker_reset_s)
                                if breaker_reset_s is not None
                                else 4.0 * self.heartbeat_interval)
        #: checkpoint the fleet currently serves — the implicit
        #: rollback target of a failed canary (rolling_reload updates
        #: it; None until a reload or an explicit initial_checkpoint)
        self.current_checkpoint = initial_checkpoint
        #: step of current_checkpoint once a rolling_reload pinned one.
        #: While set, every replica ADMITTED into rotation (capacity-gap
        #: spawn, readmission, adoption) is first converged onto exactly
        #: this checkpoint@step — a promotion can never end up torn by
        #: later capacity repair. None = never promoted: boot-time
        #: heterogeneity is the operator's business, not ours.
        self.current_step: Optional[int] = None
        #: multi-model twin of current_checkpoint/current_step:
        #: model_id -> (path, step) pinned by a model-scoped
        #: rolling_reload. Newcomers announcing that model converge
        #: onto THIS identity before admission (docs/FLEET.md
        #: "Disaggregated roles" — one router, N models)
        self.model_checkpoints: Dict[str, Tuple[str, Optional[int]]] = {}
        #: (model_id, role) -> {"spawner", "autoscaler"} replica pools
        #: for pool-scoped autoscaling (add_pool); empty = the legacy
        #: single-pool fleet-level autoscaler signal
        self._pools: Dict[Tuple[str, str], dict] = {}
        #: (role, model) gauge children registered so far — roles and
        #: models are DISCOVERED from /readyz payloads, so the
        #: dl4j_fleet_role_replicas series appear at first sight
        self._role_gauge_keys: set = set()
        # the scaleout control-plane tracker IS the health store:
        # heartbeat() on probe success (re-registers evicted members),
        # stale_workers() drives eviction — runtime._evict_stale's idiom
        self.tracker = InMemoryStateTracker(
            heartbeat_timeout=heartbeat_timeout)
        self._replicas: Dict[str, FleetReplica] = {}  # insertion order
        self._lock = threading.RLock()
        self._rr = 0
        self._rid_seq = itertools.count()
        self._reload_lock = threading.Lock()
        self._reload_active = False
        self._closed = threading.Event()
        self._monitor: Optional[threading.Thread] = None

        # ------------------------------------ crash-safe control plane
        self.state_dir = state_dir
        self.journal: Optional[StateFile] = None
        self.incarnation = 0
        self.adoption_events: List[dict] = []
        self._journal_io_lock = threading.Lock()
        #: journal writes are suppressed while _adopt_prior runs: each
        #: attach() inside it would otherwise commit a journal naming
        #: only the already-adopted SUBSET — a crash mid-adoption would
        #: then permanently leak the rest of the warm world. One commit
        #: lands after adoption completes.
        self._adopting = False
        self._prior_journal = None
        if state_dir is not None:
            self.journal = StateFile(
                os.path.join(state_dir, "fleet.journal"),
                point="fleet.journal")
            self._prior_journal = self.journal.read()
            if self._prior_journal is not None:
                self.incarnation = int(
                    self._prior_journal.get("incarnation", 0)) + 1
            elif self.journal.torn:
                self.incarnation = 1  # prior world unknown: fresh spawn

        # telemetry ----------------------------------------------------
        reg = telemetry.get_registry()
        self.label = name if name is not None else f"f{next(_fleet_seq)}"
        lab = {"fleet": self.label}
        self._m_requests = {
            route: reg.counter(
                "dl4j_fleet_requests",
                "requests routed by the fleet tier").labels(
                    route=route, **lab)
            for route in ("predict", "generate")}
        self._m_latency = {
            route: reg.histogram(
                "dl4j_fleet_request_latency_seconds",
                "router-side request wall latency (incl. retries)"
            ).labels(route=route, **lab)
            for route in ("predict", "generate")}
        self._m_shed = {
            route: reg.counter(
                "dl4j_fleet_shed",
                "requests shed at the router's high-water mark").labels(
                    route=route, **lab)
            for route in ("predict", "generate")}
        self._m_retries = reg.counter(
            "dl4j_fleet_retries",
            "predict retries on a healthy peer after a replica "
            "failure").labels(**lab)
        self._m_deadline = {
            route: reg.counter(
                "dl4j_fleet_deadline_exceeded",
                "requests shed at the router because their deadline "
                "budget was already spent").labels(route=route, **lab)
            for route in ("predict", "generate")}
        self._m_stream_resumes = reg.counter(
            "dl4j_fleet_stream_resumes",
            "mid-stream /generate failovers re-admitted on a "
            "surviving replica (prompt + delivered tokens replayed "
            "as the continuation context)").labels(**lab)
        self._m_stream_resume_failures = reg.counter(
            "dl4j_fleet_stream_resume_failures",
            "generate streams the router could NOT resume (attempts "
            "or deadline budget exhausted, or no surviving replica) "
            "— the client saw the in-band retryable error").labels(
                **lab)
        self._m_stream_tokens_replayed = reg.counter(
            "dl4j_fleet_stream_tokens_replayed",
            "context tokens (prompt + already-delivered) re-submitted "
            "as prefill during stream failover — the prefix cache "
            "turns these into page-reference hits on the "
            "survivor").labels(**lab)
        self._m_stream_tokens_deduped = reg.counter(
            "dl4j_fleet_stream_tokens_deduped",
            "replayed tokens the router suppressed by absolute "
            "token_index so the client stream stays exactly-once "
            "across failover").labels(**lab)
        self._m_disagg_handoffs = reg.counter(
            "dl4j_disagg_handoffs",
            "prefill->decode handoffs dispatched: the router drove "
            "/prefill on a prefill-role replica and named it as the "
            "kv_donor of the decode placement").labels(**lab)
        self._m_disagg_handoff_bytes = reg.counter(
            "dl4j_disagg_handoff_bytes",
            "KV page bytes made shippable by prefill handoffs (as "
            "reported by the prefill replica's /prefill reply)").labels(
                **lab)
        self._m_disagg_handoff_failures = reg.counter(
            "dl4j_disagg_handoff_failures",
            "prefill handoff dispatches that errored (dead prefill "
            "replica, shed, chaos) — each one degrades the stream to "
            "plain unified prefill, never to a failed request").labels(
                **lab)
        self._m_disagg_fallbacks = reg.counter(
            "dl4j_disagg_fallbacks",
            "streams that proceeded with plain prefill after a failed "
            "or skipped handoff on a fleet that HAS prefill "
            "capacity").labels(**lab)
        tscope = {"scope": f"fleet:{self.label}"}
        self._m_tier_requests = {
            t: reg.counter(
                "dl4j_tier_requests",
                "requests admitted per SLO tier").labels(tier=t, **tscope)
            for t in TIERS}
        self._m_tier_shed = {
            t: reg.counter(
                "dl4j_tier_shed",
                "requests shed per SLO tier (batch sheds at its own, "
                "lower high-water mark)").labels(tier=t, **tscope)
            for t in TIERS}
        self._m_tier_latency = {
            t: reg.histogram(
                "dl4j_tier_request_latency_seconds",
                "router-side request wall latency per SLO tier").labels(
                    tier=t, **tscope)
            for t in TIERS}
        self._m_preempt_resumes = reg.counter(
            "dl4j_tier_preempt_resumes",
            "batch rows re-admitted after an interactive arrival "
            "preempted their decode slot — the lossless durable-stream "
            "resume path, distinct from failover resumes").labels(
                tier=TIER_BATCH, **tscope)
        self._m_timeouts = reg.counter(
            "dl4j_fleet_request_timeouts",
            "request-path timeouts (the circuit breaker's input — a "
            "hung-but-TCP-alive replica shows up here first)").labels(
                **lab)
        self._m_breaker_opens = reg.counter(
            "dl4j_fleet_breaker_opens",
            "circuit breakers tripped open (the replica is evicted "
            "until a half-open /readyz probe passes)").labels(**lab)
        self._m_evictions = reg.counter(
            "dl4j_fleet_evictions",
            "replicas evicted (stale heartbeat, lost readiness, or "
            "connection failure)").labels(**lab)
        self._m_readmissions = reg.counter(
            "dl4j_fleet_readmissions",
            "evicted replicas readmitted after passing /readyz").labels(
                **lab)
        self._m_reloads = {
            outcome: reg.counter(
                "dl4j_fleet_reloads",
                "rolling checkpoint reloads by outcome").labels(
                    outcome=outcome, **lab)
            for outcome in ("ok", "rolled_back", "failed")}
        self._m_spawned = reg.counter(
            "dl4j_fleet_spawned", "replicas spawned").labels(**lab)
        self._m_retired = reg.counter(
            "dl4j_fleet_retired", "replicas retired").labels(**lab)
        # fleet KV plane (serving/fleetkv.py, docs/FLEET.md): affinity
        # placement counted router-side at select; ship counters are
        # DELTAS of the cumulative per-replica figures each /readyz
        # summary carries, folded in by the health probe — the router
        # never sits on the ship path, yet its /metrics still tells
        # the fleet-wide story
        self._m_affinity_hits = reg.counter(
            "dl4j_fleet_prefix_affinity_hits",
            "generate requests routed to the replica whose KV summary "
            "matched >= 1 head chunk of the prompt (the fleet-level "
            "prefix hit)").labels(**lab)
        self._m_affinity_misses = reg.counter(
            "dl4j_fleet_prefix_affinity_misses",
            "affinity-eligible generate requests with no summary "
            "match anywhere, or whose preferred replica lost to load "
            "slack / shed / exclusion").labels(**lab)
        self._m_page_ships = reg.counter(
            "dl4j_fleet_prefix_page_ships",
            "KV pages installed via peer-to-peer shipping across the "
            "fleet (replica-reported, probe-aggregated)").labels(**lab)
        self._m_ship_bytes = reg.counter(
            "dl4j_fleet_prefix_ship_bytes",
            "serialized bytes fetched by successful page ships "
            "(replica-reported, probe-aggregated)").labels(**lab)
        self._m_ship_failures = reg.counter(
            "dl4j_fleet_prefix_ship_failures",
            "page-ship attempts that fell back to plain prefill "
            "(donor dead, timeout, crc/identity mismatch, pool "
            "pressure; replica-reported, probe-aggregated)").labels(
                **lab)
        ref = weakref.ref(self)
        for state in STATES:
            reg.gauge(
                "dl4j_fleet_replicas",
                "fleet replicas by lifecycle state").labels(
                    state=state, **lab).set_function(
                (lambda st: lambda: (
                    (lambda o: o.state_counts().get(st, 0) if o else 0)(
                        ref())))(state))
        for bstate in (CircuitBreaker.CLOSED, CircuitBreaker.HALF_OPEN,
                       CircuitBreaker.OPEN):
            reg.gauge(
                "dl4j_fleet_breaker",
                "replica circuit breakers by state").labels(
                    state=bstate, **lab).set_function(
                (lambda st: lambda: (
                    (lambda o: o.breaker_counts().get(st, 0) if o else 0)(
                        ref())))(bstate))
        reg.gauge(
            "dl4j_fleet_outstanding",
            "in-flight requests across the fleet").labels(
                **lab).set_function(
            lambda: (lambda o: o.total_outstanding() if o else 0)(ref()))
        for t in TIERS:
            reg.gauge(
                "dl4j_tier_backlog",
                "in-flight (or replica-queued) requests per SLO "
                "tier").labels(tier=t, **tscope).set_function(
                (lambda _t: lambda: (
                    (lambda o: o._tier_inflight[_t] if o else 0)(
                        ref())))(t))
        reg.gauge(
            "dl4j_fleet_utilization",
            "fleet load as a fraction of shed capacity (outstanding / "
            "shed_high_water; per-ready-replica outstanding when no "
            "mark is set) — near 1.0 under a batch flood means the "
            "bulk lane is soaking idle capacity").labels(
                **lab).set_function(
            lambda: (lambda o: o.utilization() if o else 0.0)(ref()))
        # crash-safe control plane (docs/OBSERVABILITY.md) — series
        # definitions shared with the supervisor (statefile module)
        from deeplearning4j_tpu_torch.utils.statefile import \
            controlplane_metrics

        self._m_restarts, self._m_adoptions = controlplane_metrics(
            "fleet", self.label,
            lambda: (lambda o: o.incarnation if o else 0)(ref()),
            ("adopted", "dead", "recycled", "attached"))

        if self._prior_journal is not None:
            try:
                self._adopt_prior(self._prior_journal)
            except Exception:
                # an unexpectedly-shaped journal degrades to a fresh
                # spawn (the torn-journal rung) — never a crash that
                # burns the watchdog's restart budget
                log.exception("fleet %s: journal adoption failed; "
                              "starting fresh", self.label)
            finally:
                self._adopting = False  # a failed adoption must not
                # leave journaling suppressed for the fleet's lifetime
        self._journal_write()
        if start:
            self.start()

    # ------------------------------------------------------- lifecycle
    def start(self) -> "Fleet":
        if self._monitor is None or not self._monitor.is_alive():
            self._closed.clear()
            self._monitor = threading.Thread(
                target=self._monitor_loop, daemon=True,
                name=f"fleet-monitor-{self.label}")
            self._monitor.start()
        return self

    def close(self, stop_replicas: bool = False,
              timeout: float = 10.0, handoff: bool = False) -> None:
        """Stop the monitor; optionally terminate spawned replica
        processes (attached-by-URL replicas are never touched).

        `handoff=True` (only meaningful with a journal): the router is
        going away but the warm fleet is not — spawned replicas are
        RELEASED from this incarnation's atexit orphan sweep
        (procs.release_spawned) and the journal gets a final commit
        naming them, so the next incarnation re-adopts the whole world
        through `/readyz` with zero respawns and zero recompiles."""
        self._closed.set()
        if self._monitor is not None:
            self._monitor.join(timeout=timeout)
        if handoff and self.journal is not None:
            with self._lock:
                owned = [r.proc for r in self._replicas.values()
                         if r.spawned and r.proc is not None]
            self._journal_write()
            for proc in owned:
                procs.release_spawned(proc)
            log.warning(
                "fleet %s: handing %d spawned replica(s) off to the "
                "next incarnation (journal %s)", self.label,
                len(owned), self.journal.path)
            return
        if stop_replicas:
            with self._lock:
                owned = [r.proc for r in self._replicas.values()
                         if r.spawned and r.proc is not None]
            for proc in owned:
                ReplicaSpawner.stop(proc, timeout=timeout)
            if self.journal is not None:
                # a full teardown hands nothing off: clear the journal
                # so the next incarnation starts fresh instead of
                # probing dead endpoints
                self.journal.clear()

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close(stop_replicas=True)

    # ---------------------------------------- crash-safe control plane
    def _journal_write(self) -> None:
        """Commit the fleet journal (utils/statefile.py atomic rename):
        replica endpoints, states, spawn fingerprints, the serving
        checkpoint. Called at every membership/state transition. A
        failed write is logged and survived — the previous committed
        journal stays valid, and the pid fingerprints reject whatever
        changed since."""
        if self.journal is None or self._adopting:
            return
        with self._lock:
            replicas = {}
            for rid, rep in self._replicas.items():
                entry = {"url": rep.client.url, "state": rep.state,
                         "spawned": rep.spawned,
                         "checkpoint": (rep.last_ready
                                        or {}).get("checkpoint")}
                if rep.proc is not None:
                    entry["pid"] = rep.proc.pid
                    entry["start_time"] = rep.start_time
                replicas[rid] = entry
            state = {
                "plane": "fleet",
                "fleet": self.label,
                "incarnation": self.incarnation,
                "current_checkpoint": self.current_checkpoint,
                "current_step": self.current_step,
                "model_checkpoints": {
                    m: list(v)
                    for m, v in self.model_checkpoints.items()},
                "replicas": replicas,
                "written_at": time.time(),
            }
        with self._journal_io_lock:
            self.journal.try_write(state)

    def _adopt_prior(self, prior: dict) -> None:
        """Re-adopt the previous incarnation's journaled world. Every
        entry re-attaches as STARTING; spawned entries additionally
        verify their (pid, start-time) fingerprint and become
        `AdoptedProc` members — the ordinary monitor then readmits
        each one through `/readyz` WARM: zero respawns, zero
        recompiles. Dead/recycled pids are skipped (spawner/autoscaler
        replace them); a recycled pid is never signalled."""
        self._m_restarts.inc()
        self._adopting = True
        if self.current_checkpoint is None:
            self.current_checkpoint = prior.get("current_checkpoint")
            self.current_step = prior.get("current_step")
        if not self.model_checkpoints:
            self.model_checkpoints = {
                m: (v[0], v[1]) for m, v in
                (prior.get("model_checkpoints") or {}).items()
                if isinstance(v, (list, tuple)) and len(v) == 2}
        max_rid = -1
        for rid, e in (prior.get("replicas") or {}).items():
            if rid.startswith("r"):
                try:
                    max_rid = max(max_rid, int(rid[1:]))
                except ValueError:
                    pass
            url = e.get("url")
            if not url:
                continue
            pid = e.get("pid")
            spawned = bool(e.get("spawned"))
            if spawned and pid:
                kind = procs.classify_pid(pid, e.get("start_time"))
                if kind == "adopted":
                    proc = procs.AdoptedProc(pid, e.get("start_time"))
                    procs.register_spawned(proc)
                    self.attach(url, replica_id=rid, proc=proc,
                                spawned=True, adopted=True)
            else:
                # attached-by-URL member: re-attach; the /readyz probe
                # readmits it (or staleness evicts a dead endpoint)
                self.attach(url, replica_id=rid, adopted=True)
                kind = "attached"
            self._m_adoptions[kind].inc()
            self.adoption_events.append(
                {"replica": rid, "kind": kind, "url": url, "pid": pid,
                 "at": time.time()})
            log.warning("fleet %s: incarnation %d %s prior replica %s "
                        "(%s)", self.label, self.incarnation,
                        "re-adopts" if kind in ("adopted", "attached")
                        else f"found {kind}", rid, url)
        with self._lock:
            # fresh replica ids must never collide with journaled ones
            self._rid_seq = itertools.count(max_rid + 1)
        self._adopting = False

    # ------------------------------------------------------ membership
    def attach(self, url: str, replica_id: Optional[str] = None,
               proc: Optional[subprocess.Popen] = None,
               spawned: bool = False,
               adopted: bool = False) -> FleetReplica:
        """Add a replica endpoint (STARTING until /readyz passes)."""
        with self._lock:
            rid = replica_id or f"r{next(self._rid_seq)}"
            if rid in self._replicas:
                raise ValueError(f"replica id {rid!r} already attached")
            rep = FleetReplica(rid, ReplicaClient(url), proc=proc,
                               spawned=spawned, adopted=adopted,
                               breaker=CircuitBreaker(
                                   threshold=self.breaker_threshold,
                                   reset_s=self.breaker_reset_s))
            self._replicas[rid] = rep
        self.tracker.add_worker(rid)
        self._journal_write()
        return rep

    def spawn(self, n: int = 1) -> List[FleetReplica]:
        """Spawn n local replica processes through the spawner."""
        if self.spawner is None:
            raise RuntimeError("fleet has no spawner configured")
        out = []
        for _ in range(n):
            proc, url = self.spawner.spawn()
            out.append(self.attach(url, proc=proc, spawned=True))
            self._m_spawned.inc()
        return out

    def retire(self, replica_id: str, drain_timeout: float = 30.0
               ) -> None:
        """Drain one replica out of rotation and remove it (terminating
        its process when the fleet spawned it)."""
        with self._lock:
            rep = self._replicas.get(replica_id)
            if rep is None:
                raise KeyError(f"no replica {replica_id!r}")
            rep.state = DRAINING
        self._drain(rep, drain_timeout)
        with self._lock:
            self._replicas.pop(replica_id, None)
        self.tracker.remove_worker(replica_id)
        if rep.spawned and rep.proc is not None:
            ReplicaSpawner.stop(rep.proc)
        self._m_retired.inc()
        self._journal_write()

    def scale_to(self, n: int, drain_timeout: float = 30.0) -> dict:
        """Manual autoscaling hook: spawn or retire (least-loaded,
        fleet-spawned first) until `n` non-evicted replicas remain."""
        spawned, retired = [], []
        with self._lock:
            live = [r for r in self._replicas.values()
                    if r.state != EVICTED]
        if len(live) < n:
            spawned = [r.id for r in self.spawn(n - len(live))]
        while len(live) > n:
            # retire the least-loaded spawned replica first; attached
            # replicas only when nothing spawned remains
            live.sort(key=lambda r: (not r.spawned, r.outstanding))
            victim = live.pop(0)
            self.retire(victim.id, drain_timeout=drain_timeout)
            retired.append(victim.id)
        return {"replicas": n, "spawned": spawned, "retired": retired}

    # -------------------------------------------------- health monitor
    def _monitor_loop(self) -> None:
        while not self._closed.is_set():
            try:
                self.poll()
            except Exception:  # the monitor must survive anything
                log.exception("fleet monitor poll failed")
            self._closed.wait(self.heartbeat_interval)

    def poll(self) -> None:
        """One monitor pass: probe every replica, evict the stale,
        readmit rejoiners, run the autoscaler. Public so tests drive
        it deterministically. Probes run CONCURRENTLY with the short
        dedicated `probe_timeout`: one hung replica (SIGSTOP'd, wedged
        accept loop) costs the sweep a single probe window — it can
        never starve the other replicas' heartbeats past the staleness
        eviction threshold."""
        with self._lock:
            reps = list(self._replicas.values())
        if len(reps) == 1:
            self._probe(reps[0])
        elif reps:
            threads = [threading.Thread(target=self._probe, args=(rep,),
                                        daemon=True,
                                        name=f"fleet-probe-{rep.id}")
                       for rep in reps]
            for t in threads:
                t.start()
            # both probes (healthz + readyz) are socket-timeout bound,
            # so the join wall is ~2 probe windows whatever hangs
            join_by = time.monotonic() + 2.0 * self.probe_timeout + 1.0
            for t in threads:
                t.join(timeout=max(0.0, join_by - time.monotonic()))
        # the scaleout eviction idiom: stale heartbeats name the dead
        for wid in self.tracker.stale_workers():
            with self._lock:
                rep = self._replicas.get(wid)
            if rep is not None and rep.state != EVICTED:
                self._evict(rep, "heartbeat timeout")
        if ((self.autoscaler is not None and self.spawner is not None)
                or self._pools):
            self.autoscale_tick()

    def _probe(self, rep: FleetReplica) -> None:
        try:
            rep.client.healthz(timeout=self.probe_timeout)
        except Exception:
            return  # no heartbeat recorded; staleness evicts
        # liveness ok -> heartbeat (re-registers an evicted member,
        # InMemoryStateTracker's elasticity contract)
        self.tracker.heartbeat(rep.id)
        if rep.state == DRAINING:
            return  # mid-reload/retire: rolling_reload owns its state
        with self._lock:
            # breaker-evicted members readmit ONLY through the breaker's
            # half-open window: /readyz may well answer 200 on a replica
            # whose request path is still wedged, so an open breaker
            # outranks a healthy-looking readiness probe until reset_s
            # has elapsed
            half_open_trial = (rep.state == EVICTED
                               and rep.breaker.state != CircuitBreaker.CLOSED)
            if half_open_trial and not rep.breaker.allow_probe():
                return
        try:
            ready, payload = rep.client.readyz(
                timeout=self.probe_timeout)
        except Exception:
            if half_open_trial:
                with self._lock:
                    rep.breaker.reopen()
            return
        rep.last_ready = payload
        self._ensure_role_gauge(rep.role, rep.model_id or "default")
        self._fold_kv_summary(rep, payload)
        if ready and rep.state in (STARTING, EVICTED):
            with self._lock:
                rep.breaker.record_success()  # closes a half-open trial
            self._admit(rep)
        elif not ready:
            if half_open_trial:
                with self._lock:
                    rep.breaker.reopen()
            if rep.state in (READY, SUSPECT):
                self._evict(rep, payload.get("reason", "readiness lost"))

    # ---------------------------------------- fleet KV plane (fleetkv)
    def _fold_kv_summary(self, rep: FleetReplica,
                         payload: dict) -> None:
        """Delta one replica's cumulative ship stats (carried by its
        /readyz kv_summary) into the fleet-level counters. A replica
        restart resets its cumulative figures — a negative delta means
        exactly that, so the new figure is taken whole."""
        summary = (payload or {}).get("kv_summary")
        if not isinstance(summary, dict):
            return
        with self._lock:
            seen = rep.kv_seen or {}
            for key, counter in (
                    ("page_ships", self._m_page_ships),
                    ("ship_bytes", self._m_ship_bytes),
                    ("ship_failures", self._m_ship_failures)):
                now = int(summary.get(key, 0))
                delta = now - int(seen.get(key, 0))
                if delta < 0:
                    delta = now
                if delta > 0:
                    counter.inc(delta)
                seen[key] = now
            rep.kv_seen = seen

    def kv_summaries(self, model_id: Optional[str] = None) -> dict:
        """READY replicas' affinity summaries: {replica_id ->
        (kv_summary payload, url)}. The router's placement input
        (fleetkv.RouterAffinity.plan); replicas without a summary
        (plane off, pre-first-probe, summary chaos) simply don't
        appear — affinity degrades, routing never blocks on it.
        Prefill-role replicas never appear either: they donate pages
        through the explicit /prefill handoff, and an affinity prefer
        pointing at one would route a stream to a replica that rejects
        streams. `model_id` (when given) keeps model B's summaries
        from placing model A's prompt."""
        with self._lock:
            out = {}
            for rid, rep in self._replicas.items():
                if rep.state != READY:
                    continue
                if rep.role == "prefill":
                    continue
                if (model_id is not None
                        and (rep.model_id or "default") != model_id):
                    continue
                summary = (rep.last_ready or {}).get("kv_summary")
                if isinstance(summary, dict):
                    out[rid] = (summary, rep.client.url)
            return out

    def note_affinity(self, hit: bool) -> None:
        """Router-side placement outcome: hit = the request landed on
        the replica whose summary matched its head chunks."""
        (self._m_affinity_hits if hit
         else self._m_affinity_misses).inc()

    def _prefix_section(self, model_id: Optional[str] = None) -> dict:
        """Fleet-wide prefix-cache view for /stats: each replica's
        last-reported hit/page figures plus the fleet totals and the
        router's affinity hit rate. Figures come from the same
        kv_summary the affinity plane rides on, so a replica whose
        plane is off simply contributes zeros. `model_id` narrows the
        view to one model's replicas (the per-model /stats section);
        the affinity rate is router-global, so it only appears on the
        fleet-wide view."""
        per: Dict[str, dict] = {}
        hits = misses = pages = ships = 0
        with self._lock:
            for rid, rep in self._replicas.items():
                if (model_id is not None
                        and (rep.model_id or "default") != model_id):
                    continue
                summary = (rep.last_ready or {}).get("kv_summary")
                if not isinstance(summary, dict):
                    continue
                row = {
                    "hits": int(summary.get("hits", 0)),
                    "misses": int(summary.get("misses", 0)),
                    "pages_cached": int(summary.get("pages_cached", 0)),
                    "page_ships": int(summary.get("page_ships", 0)),
                }
                per[rid] = row
                hits += row["hits"]
                misses += row["misses"]
                pages += row["pages_cached"]
                ships += row["page_ships"]
        out = {
            "replicas": per,
            "hits": hits,
            "misses": misses,
            "pages_cached": pages,
            "page_ships": ships,
        }
        if model_id is None:
            ahits = int(self._m_affinity_hits.value)
            amisses = int(self._m_affinity_misses.value)
            placed = ahits + amisses
            out["ship_bytes"] = int(self._m_ship_bytes.value)
            out["ship_failures"] = int(self._m_ship_failures.value)
            out["affinity"] = {
                "hits": ahits,
                "misses": amisses,
                "rate": round(ahits / placed, 4) if placed else 0.0,
            }
        return out

    def _converge_target(self, rep: FleetReplica
                         ) -> Tuple[Optional[str], Optional[int]]:
        """The checkpoint identity `rep` must serve to enter rotation:
        its model's pinned (path, step) when a model-scoped
        rolling_reload promoted one, else the fleet-wide pin."""
        pinned = self.model_checkpoints.get(rep.model_id or "default")
        if pinned is not None:
            return pinned
        return self.current_checkpoint, self.current_step

    def _needs_converge(self, rep: FleetReplica) -> bool:
        """True when `rep` reports a checkpoint identity other than
        its converge target. Only armed once a rolling_reload pinned
        one (fleet-wide step, or the replica's model): before any
        promotion the fleet has no opinion on what its members
        serve."""
        if self._reload_active:
            return False  # rolling_reload is rewriting identity now
        target, step = self._converge_target(rep)
        if target is None:
            return False
        if (step is None
                and (rep.model_id or "default")
                not in self.model_checkpoints):
            return False  # fleet-wide pin needs a step to be armed
        ck = (rep.last_ready or {}).get("checkpoint") or {}
        path = ck.get("path")
        return not (path
                    and os.path.abspath(path)
                    == os.path.abspath(target)
                    and ck.get("step") == step)

    def _admit(self, rep: FleetReplica) -> None:
        if self._needs_converge(rep):
            # a newcomer (capacity-gap spawn, readmitted eviction, late
            # adoption) must not enter rotation serving anything but
            # ITS MODEL's promoted champion — THAT would be a torn
            # promotion. Bring it to the converge target first; on
            # failure it stays out of rotation and the next monitor
            # pass retries — dark beats stale.
            target, tstep = self._converge_target(rep)
            ok, info = self._reload_one(
                rep, target, tstep,
                None, ready_timeout=max(30.0, self.request_timeout))
            if not ok:
                log.warning(
                    "fleet %s: replica %s failed to converge onto "
                    "%s@%s (%s); held out of rotation", self.label,
                    rep.id, target, tstep, info.get("error"))
                return
            log.info("fleet %s: replica %s converged onto %s@%s before "
                     "admission", self.label, rep.id, target, tstep)
        with self._lock:
            was_evicted = rep.state == EVICTED
            rep.state = READY
            rep.failures = 0
            rep.admitted_at = time.time()
        if was_evicted:
            self._m_readmissions.inc()
            log.info("fleet %s: replica %s readmitted", self.label,
                     rep.id)
        self._journal_write()

    def _evict(self, rep: FleetReplica, reason: str) -> None:
        with self._lock:
            if rep.state == EVICTED:
                return
            rep.state = EVICTED
            rep.evicted_at = time.time()
            rep.eviction_reason = reason
        # removed from the registry; the next successful heartbeat
        # re-registers it (stale_workers stops naming it meanwhile)
        self.tracker.remove_worker(rep.id)
        self._m_evictions.inc()
        log.warning("fleet %s: evicting replica %s (%s)", self.label,
                    rep.id, reason)
        self._journal_write()

    def note_request_failure(self, rep: FleetReplica,
                             exc: BaseException,
                             breaker_eligible: bool = True) -> None:
        """Request-path failure feedback. Connection-level failures
        evict immediately (the process is gone — waiting out the
        heartbeat just fails more requests); HTTP-level failures only
        count (the monitor decides on readiness). A request TIMEOUT
        (socket.timeout is an OSError) means slow, not dead — ONE
        pathological request must not evict a replica that still
        answers /healthz. Instead it marks the replica SUSPECT
        (deprioritized) and feeds its circuit breaker; after
        `breaker_threshold` CONSECUTIVE timeouts the breaker opens and
        evicts the hung-but-TCP-alive member the heartbeat path cannot
        see. Readmission then goes through the breaker's half-open
        /readyz probe (`_probe`).

        `breaker_eligible=False` marks a timeout whose wait window was
        an impatient deadline SLICE, not a fair request_timeout: it
        still fails this attempt and triggers a retry, but says nothing
        reliable about the replica — a client hammering tiny
        `X-Deadline-Ms` budgets must not be able to trip breakers and
        evict healthy members."""
        opened = False
        is_timeout = isinstance(exc, TimeoutError)
        with self._lock:
            rep.failures += 1
            if is_timeout:
                self._m_timeouts.inc()
                if not breaker_eligible:
                    return
                opened = rep.breaker.record_timeout()
                if rep.state == READY:
                    rep.state = SUSPECT
        if is_timeout:
            if opened:
                self._m_breaker_opens.inc()
                self._evict(rep, "circuit breaker open after "
                            f"{rep.breaker.threshold} consecutive "
                            "request timeouts")
        elif isinstance(exc, OSError):
            self._evict(rep, f"connection failure: {exc}")

    def note_request_success(self, rep: FleetReplica) -> None:
        """A completed request closes the replica's breaker and clears
        a SUSPECT verdict — suspicion is about request progress, and
        the request just progressed."""
        with self._lock:
            rep.failures = 0
            rep.breaker.record_success()
            if rep.state == SUSPECT:
                rep.state = READY

    # ------------------------------------------------------- dispatch
    def ready_replicas(self) -> List[FleetReplica]:
        with self._lock:
            return [r for r in self._replicas.values()
                    if r.state == READY]

    def ready_count(self) -> int:
        return len(self.ready_replicas())

    def wait_ready(self, n: int = 1, timeout: float = 120.0) -> None:
        """Block until >= n replicas are READY (spin-up gate)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.ready_count() >= n:
                return
            time.sleep(min(0.05, self.heartbeat_interval))
        raise TimeoutError(
            f"only {self.ready_count()}/{n} replicas ready after "
            f"{timeout}s: {self.state_counts()}")

    def total_outstanding(self) -> int:
        with self._lock:
            return sum(r.outstanding for r in self._replicas.values())

    def state_counts(self) -> Dict[str, int]:
        with self._lock:
            counts = {s: 0 for s in STATES}
            for r in self._replicas.values():
                counts[r.state] += 1
            return counts

    def breaker_counts(self) -> Dict[str, int]:
        with self._lock:
            counts = {CircuitBreaker.CLOSED: 0,
                      CircuitBreaker.HALF_OPEN: 0,
                      CircuitBreaker.OPEN: 0}
            for r in self._replicas.values():
                counts[r.breaker.state] += 1
            return counts

    def utilization(self) -> float:
        """Fleet load normalized to its shed capacity: outstanding /
        shed_high_water when a mark is set (1.0 = shedding), else mean
        outstanding per ready replica. The bench's "batch soaks idle
        capacity" gauge (docs/OBSERVABILITY.md)."""
        total = self.total_outstanding()
        if self.shed_high_water:
            return total / float(self.shed_high_water)
        return total / float(max(1, self.ready_count()))

    def batch_backlog(self) -> int:
        """Batch-tier work parked on this fleet: bulk streams in
        flight or queued behind replica admission (the router holds a
        batch stream open while its rows wait for slots, so in-flight
        IS the backlog). The autoscaler's batch signal."""
        with self._lock:
            return self._tier_inflight[TIER_BATCH]

    # --------------------------------------- roles & models (disagg)
    def _ensure_role_gauge(self, role: str, model: str) -> None:
        """Register the dl4j_fleet_role_replicas{role=,model=} gauge
        child at first sight of a (role, model) pair — the series are
        discovered from /readyz payloads, never pre-declared."""
        key = (role, model)
        with self._lock:
            if key in self._role_gauge_keys:
                return
            self._role_gauge_keys.add(key)
        ref = weakref.ref(self)
        telemetry.get_registry().gauge(
            "dl4j_fleet_role_replicas",
            "READY fleet replicas by disaggregated role and model "
            '(docs/FLEET.md "Disaggregated roles")').labels(
                role=role, model=model, fleet=self.label).set_function(
            (lambda rl, m: lambda: (
                (lambda o: o.role_model_count(rl, m) if o else 0)(
                    ref())))(role, model))

    def role_model_count(self, role: str, model: str) -> int:
        with self._lock:
            return sum(1 for r in self._replicas.values()
                       if r.state == READY and r.role == role
                       and (r.model_id or "default") == model)

    def role_counts(self, model_id: Optional[str] = None
                    ) -> Dict[str, int]:
        """READY replicas by role (optionally one model's) — the
        router's cheap "does this fleet have a prefill pool" check."""
        with self._lock:
            counts: Dict[str, int] = {}
            for r in self._replicas.values():
                if r.state != READY:
                    continue
                if (model_id is not None
                        and (r.model_id or "default") != model_id):
                    continue
                counts[r.role] = counts.get(r.role, 0) + 1
            return counts

    @staticmethod
    def _routable(rep: FleetReplica, role: Optional[str],
                  model_id: Optional[str]) -> bool:
        """Role/model admission filter (docs/FLEET.md "Disaggregated
        roles"). `role=None` means a STREAM-capable replica — unified
        or decode: a prefill-role replica never serves /predict or
        /generate, so it is excluded unless explicitly requested with
        role="prefill". Any non-prefill role is satisfied by a
        unified replica (the default deployment IS the unified pool).
        `model_id=None` skips model filtering (single-model fleets);
        otherwise replicas that announce no model count as
        "default"."""
        rrole = rep.role
        if role is None:
            if rrole == "prefill":
                return False
        elif role == "prefill":
            if rrole != "prefill":
                return False
        elif rrole not in (role, "unified"):
            return False
        if (model_id is not None
                and (rep.model_id or "default") != model_id):
            return False
        return True

    def select(self, route: str = "predict",
               exclude: Sequence[str] = (),
               tier: str = TIER_INTERACTIVE,
               count: bool = True,
               prefer: Optional[str] = None,
               prefer_slack: int = 4,
               role: Optional[str] = None,
               model_id: Optional[str] = None) -> FleetReplica:
        """Least-outstanding READY replica (round-robin tiebreak) —
        the ReplicaSet policy lifted across processes. SUSPECT
        replicas (recent request timeouts, breaker not yet open) stay
        in the pool but rank AFTER any equally-loaded READY peer:
        under load their in-flight hangs pile up `outstanding` so real
        traffic skews to healthy members, while the trickle they still
        receive is exactly what either clears the suspicion (a
        success) or trips the breaker (N consecutive timeouts) — a
        suspect starved of all traffic could never resolve either way.
        Under idle/sequential traffic even the deprioritized rank would
        starve a suspect (every peer sits at outstanding 0), so
        suspicion additionally DECAYS back to READY after a quiet
        `breaker_reset_s` — the replica re-enters the tiebreak rotation
        and the next request delivers the breaker its verdict either
        way. Sheds with OverloadedError past the global high-water
        mark — and the BATCH tier additionally past its own, lower
        `batch_high_water`, with Retry-After derived from the shed
        tier's backlog. Raises NoReadyReplicas when nothing is
        admittable. The caller owns `release(rep, tier)` (same tier).

        `prefer` names a replica the fleet KV plane wants this request
        on (prefix affinity / consistent-hash placement —
        serving/fleetkv.py). It is a PREFERENCE with strict bounds:
        honored only when the target is READY (never SUSPECT — a
        suspect must not attract a convoy of its favorite prefix), not
        excluded, and within `prefer_slack` outstanding requests of
        the least-loaded candidate. Every shed above still fires
        first; when the preference loses, selection falls back to the
        least-outstanding policy unchanged.

        `role`/`model_id` scope the candidate pool for a disaggregated
        or multi-model fleet (`_routable`): the default role=None
        excludes prefill-role replicas — a generate stream or predict
        must NEVER land on one — and role="prefill" is how the router
        dispatches the handoff's prefill leg. The `prefer` hint passes
        through the same filter by construction (it is resolved inside
        the filtered candidate set), so an affinity plan can never
        override the role/model fence."""
        if tier not in TIERS:
            raise ValueError(
                f"unknown tier {tier!r} (expected one of {TIERS})")
        with self._lock:
            now = time.monotonic()
            for r in self._replicas.values():
                if (r.state == SUSPECT
                        and r.breaker.last_timeout_at is not None
                        and now - r.breaker.last_timeout_at
                        >= r.breaker.reset_s):
                    # decay does NOT reset the consecutive-timeout
                    # streak: only a completed request proves progress
                    r.state = READY
            ids = list(self._replicas)
            ready = [r for r in self._replicas.values()
                     if r.state in (READY, SUSPECT)
                     and r.id not in exclude
                     and self._routable(r, role, model_id)]
            if not ready:
                raise NoReadyReplicas(
                    f"no ready replica for role="
                    f"{role or 'unified/decode'} model="
                    f"{model_id or 'any'} "
                    f"(states: {self.state_counts()})")
            total = sum(r.outstanding
                        for r in self._replicas.values())
            if (tier == TIER_BATCH and self.batch_high_water is not None
                    and total >= self.batch_high_water):
                # the bulk lane sheds FIRST, while interactive
                # admission still has headroom up to the global mark
                self._m_shed[route].inc()
                self._m_tier_shed[TIER_BATCH].inc()
                raise OverloadedError(
                    f"fleet batch lane at high-water mark ({total} in "
                    f"flight >= {self.batch_high_water})",
                    retry_after_ms=backlog_retry_ms(
                        self._tier_inflight[TIER_BATCH] + 1,
                        _TIER_ITEM_MS[TIER_BATCH]),
                    tier=TIER_BATCH)
            if (self.shed_high_water is not None
                    and total >= self.shed_high_water):
                self._m_shed[route].inc()
                self._m_tier_shed[tier].inc()
                raise OverloadedError(
                    f"fleet at high-water mark ({total} in flight "
                    f">= {self.shed_high_water})",
                    retry_after_ms=backlog_retry_ms(
                        self._tier_inflight[tier] + 1,
                        _TIER_ITEM_MS[tier]),
                    tier=tier)
            n = len(ids)
            best = None
            if prefer is not None:
                cand = next((r for r in ready
                             if r.id == prefer and r.state == READY),
                            None)
                if cand is not None:
                    floor = min(r.outstanding for r in ready)
                    if cand.outstanding - floor <= prefer_slack:
                        best = cand
            if best is None:
                best = min(ready, key=lambda r: (
                    r.outstanding, r.state == SUSPECT,
                    (ids.index(r.id) - self._rr) % n))
            self._rr = (ids.index(best.id) + 1) % n
            best.outstanding += 1
            self._tier_inflight[tier] += 1
            if not exclude and count:
                # first attempt only: a retried client request counts
                # ONCE in dl4j_fleet_requests (retries have their own
                # counter, retry attempts carry a non-empty exclude
                # set by construction, and preemption re-admissions
                # pass count=False — same client request)
                self._m_requests[route].inc()
                self._m_tier_requests[tier].inc()
            return best

    def release(self, rep: FleetReplica,
                tier: str = TIER_INTERACTIVE) -> None:
        """Return a `select`ed replica; `tier` must match the select
        call so per-tier in-flight accounting balances."""
        with self._lock:
            rep.outstanding -= 1
            self._tier_inflight[tier] -= 1

    def observe(self, route: str, seconds: float,
                tier: Optional[str] = None) -> None:
        self._m_latency[route].observe(seconds)
        if tier is not None:
            self._m_tier_latency[tier].observe(seconds)

    def forward_predict(self, body: bytes,
                        deadline: Optional[Deadline] = None,
                        tier: str = TIER_INTERACTIVE,
                        model_id: Optional[str] = None
                        ) -> Tuple[int, dict, bytes]:
        """Route one /predict: least-loaded replica, transparent retry
        on a healthy peer after connection failures, request timeouts,
        or replica 5xx (idempotent, so at-least-once is safe) — under
        the fleet's explicit `retry_budget`. With a `deadline`, each
        hop's socket timeout is a SLICE of the remaining budget
        (remaining / attempts-left, capped by request_timeout) so a
        hung replica spends one slice and leaves room to retry, and
        the shrunk budget is forwarded downstream as `X-Deadline-Ms`.
        The SLO `tier` gates admission (batch sheds at its own mark)
        and is forwarded as `X-Priority` so the replica's batcher
        applies its tiered queue bound too. Returns (status, headers,
        body) from the replica that answered."""
        start = time.perf_counter()
        tried: set = set()
        last_5xx: Optional[Tuple[int, dict, bytes]] = None
        last_err: Optional[BaseException] = None
        try:
            if deadline is not None and deadline.expired:
                # shed before any replica is touched: machine-readable
                # 504, no compute anywhere
                self._m_deadline["predict"].inc()
                deadline.check("router dispatch")
            with self._lock:
                attempts = max(1, min(len(self._replicas),
                                      1 + self.retry_budget))
            for attempt in range(attempts):
                if deadline is not None and deadline.expired:
                    self._m_deadline["predict"].inc()
                    deadline.check("router retry")
                try:
                    rep = self.select(route="predict", exclude=tried,
                                      tier=tier, model_id=model_id)
                except NoReadyReplicas:
                    break  # fall through to best-effort answer below
                if tried:
                    # a retry is an attempt actually MADE on a peer
                    # after a failure, not the failure itself
                    self._m_retries.inc()
                if deadline is None:
                    hop_timeout = self.request_timeout
                    headers = {}
                else:
                    hop_timeout = max(0.05, min(
                        self.request_timeout,
                        deadline.remaining_s() / (attempts - attempt)))
                    # forward the HOP's own window, not the whole
                    # remaining budget: once the router stops waiting
                    # and replays on a peer, the first replica's
                    # admission gates shed the abandoned work instead
                    # of computing an answer nobody will read
                    headers = {DEADLINE_HEADER:
                               str(max(1, int(hop_timeout * 1000)))}
                if tier != TIER_INTERACTIVE:
                    headers[PRIORITY_HEADER] = tier
                headers = headers or None
                # a timeout at a deadline-sliced window shorter than a
                # fair request_timeout says the CLIENT was impatient,
                # not that the replica hung — it must not feed the
                # breaker (min() with probe_timeout keeps short
                # explicitly-configured request_timeouts eligible)
                fair_window = min(self.request_timeout,
                                  self.probe_timeout)
                try:
                    status, hdrs, data = rep.client.request(
                        "POST", "/predict", body,
                        timeout=hop_timeout, headers=headers)
                except Exception as e:
                    self.note_request_failure(
                        rep, e,
                        breaker_eligible=hop_timeout >= fair_window)
                    tried.add(rep.id)
                    last_err = e
                    continue
                finally:
                    self.release(rep, tier)
                if status >= 500:
                    # replica answered but failed/shed: try a peer,
                    # keep the reply in case every peer does the same
                    tried.add(rep.id)
                    last_5xx = (status, hdrs, data)
                    continue
                self.note_request_success(rep)
                return status, hdrs, data
            if last_5xx is not None:
                return last_5xx
            raise NoReadyReplicas(
                "every ready replica failed /predict"
                + (f" (last error: {last_err})" if last_err else ""))
        finally:
            self.observe("predict", time.perf_counter() - start,
                         tier=tier)

    # --------------------------------------------------- rolling reload
    def _drain(self, rep: FleetReplica, timeout: float) -> bool:
        """Wait for a DRAINING replica's in-flight requests to land."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if rep.outstanding == 0:
                    return True
            time.sleep(0.01)
        return False

    def _reload_one(self, rep: FleetReplica, path: str,
                    step: Optional[int], probe: Optional[dict],
                    ready_timeout: float) -> Tuple[bool, dict]:
        """Reload one drained replica and probe it back to readiness.
        Returns (ok, info); info["weights_changed"] says whether the
        replica now holds the NEW checkpoint (reload-stage failures
        keep the old weights — the engine's validated atomic swap)."""
        payload = {"path": path}
        if step is not None:
            payload["step"] = step
        try:
            status, _, data = rep.client.request(
                "POST", "/reload", json.dumps(payload).encode(),
                timeout=self.request_timeout)
        except Exception as e:
            return False, {"stage": "reload", "weights_changed": False,
                           "error": f"{type(e).__name__}: {e}"}
        if status != 200:
            return False, {"stage": "reload", "weights_changed": False,
                           "status": status,
                           "error": data.decode(errors="replace")}
        # readiness probe: the reload may have cost compile/cache state
        deadline = time.monotonic() + ready_timeout
        ready = False
        while time.monotonic() < deadline:
            try:
                ready, ready_payload = rep.client.readyz(
                    timeout=self.probe_timeout)
            except Exception:
                ready = False
            else:
                # refresh the identity snapshot NOW — journal/stats
                # must show the reloaded checkpoint without waiting a
                # heartbeat (the deployment controller reads this)
                rep.last_ready = ready_payload
            if ready:
                break
            time.sleep(0.05)
        if not ready:
            return False, {"stage": "readyz", "weights_changed": True,
                           "error": f"not ready within {ready_timeout}s"}
        if probe is not None:
            try:
                status, _, data = rep.client.request(
                    "POST", "/predict", json.dumps(probe).encode(),
                    timeout=self.request_timeout)
            except Exception as e:
                return False, {"stage": "probe",
                               "weights_changed": True,
                               "error": f"{type(e).__name__}: {e}"}
            if status != 200:
                return False, {"stage": "probe",
                               "weights_changed": True,
                               "status": status,
                               "error": data.decode(errors="replace")}
        return True, {"weights_changed": True}

    def rolling_reload(self, path: str, step: Optional[int] = None,
                       rollback_path: Optional[str] = None,
                       rollback_step: Optional[int] = None,
                       probe: Optional[dict] = None,
                       drain_timeout: float = 30.0,
                       ready_timeout: float = 120.0,
                       model_id: Optional[str] = None) -> dict:
        """Orchestrate `POST /reload` across the fleet with zero
        downtime: one replica at a time — drain (stop routing to it,
        wait out its in-flight requests), reload, `/readyz`-probe
        (plus the optional `/predict` validation `probe`), readmit.
        The FIRST replica is the canary: if it fails validation, the
        reload aborts and every replica already moved to the new
        checkpoint rolls back to `rollback_path` (default: the
        checkpoint the fleet was serving) — the fleet never stays
        mixed. Requests in flight elsewhere are untouched throughout,
        and each replica's own swap is atomic, so no response ever
        mixes old and new weights.

        `model_id` scopes the reload to ONE model's replicas in a
        multi-model fleet (every role pool of that model; the others
        keep serving untouched) and pins the promoted identity in
        `model_checkpoints[model_id]` — the per-model convergence
        target newcomers of that model must reach before admission.
        The default rollback target is then that model's previously
        pinned checkpoint, not the fleet-wide one."""
        if not self._reload_lock.acquire(blocking=False):
            raise OverloadedError(
                "a rolling reload is already in progress",
                retry_after_ms=5000)
        self._reload_active = True
        try:
            # SUSPECT replicas route traffic too (select() admits
            # them), so they MUST be reloaded — skipping one would
            # leave it serving the old checkpoint indefinitely
            with self._lock:
                targets = [r for r in self._replicas.values()
                           if r.state in (READY, SUSPECT)
                           and (model_id is None
                                or (r.model_id or "default")
                                == model_id)]
            if not targets:
                raise NoReadyReplicas(
                    "no ready replicas to reload"
                    + (f" for model {model_id!r}" if model_id else ""))
            if rollback_path is not None:
                rollback = rollback_path
            elif (model_id is not None
                  and model_id in self.model_checkpoints):
                rollback, pinned_step = self.model_checkpoints[model_id]
                if rollback_step is None:
                    rollback_step = pinned_step
            else:
                rollback = self.current_checkpoint
            done: List[str] = []
            for i, rep in enumerate(targets):
                with self._lock:
                    rep.state = DRAINING
                drained = self._drain(rep, drain_timeout)
                ok, info = self._reload_one(rep, path, step, probe,
                                            ready_timeout)
                if ok:
                    with self._lock:
                        rep.state = READY
                    done.append(rep.id)
                    continue
                # ---- failure: canary (or later member) — roll back
                result = {
                    "reloaded": False, "path": path,
                    "failed_replica": rep.id, "canary": i == 0,
                    "drained": drained, "error": info,
                    "completed_before_failure": list(done),
                }
                if model_id is not None:
                    result["model_id"] = model_id
                to_roll = list(done)
                if info.get("weights_changed"):
                    to_roll.append(rep.id)
                elif self._replica_alive(rep):
                    # reload-stage failure kept the OLD weights: the
                    # replica is still consistent — readmit it
                    with self._lock:
                        rep.state = READY
                else:
                    self._evict(rep, "failed during rolling reload")
                rolled, roll_failed = self._roll_back(
                    to_roll, rollback, rollback_step,
                    drain_timeout, ready_timeout)
                result["rollback_path"] = rollback
                result["rolled_back"] = rolled
                result["rollback_failed"] = roll_failed
                outcome = ("rolled_back"
                           if not roll_failed and (rolled or not to_roll)
                           else "failed")
                self._m_reloads[outcome].inc()
                return result
            if model_id is None:
                self.current_checkpoint = path
                self.current_step = step
            else:
                self.model_checkpoints[model_id] = (path, step)
            self._m_reloads["ok"].inc()
            self._journal_write()  # the serving checkpoint is journaled
            # state: a restarted router must know the rollback target
            out = {"reloaded": True, "path": path, "step": step,
                   "replicas": done}
            if model_id is not None:
                out["model_id"] = model_id
            return out
        finally:
            self._reload_active = False
            self._reload_lock.release()

    def _roll_back(self, replica_ids: List[str],
                   rollback: Optional[str], rollback_step: Optional[int],
                   drain_timeout: float, ready_timeout: float
                   ) -> Tuple[List[str], List[str]]:
        """Reload members back onto the previously-serving checkpoint.
        The validation probe is NOT re-run here: the rollback target
        already served validated traffic, and a probe built to catch
        the NEW checkpoint failing must not strand the rollback."""
        rolled: List[str] = []
        failed: List[str] = []
        if rollback is None:
            # nowhere to roll back to: members on the new checkpoint
            # leave rotation rather than serving mixed weights
            for rid in replica_ids:
                with self._lock:
                    rep = self._replicas.get(rid)
                if rep is not None:
                    self._evict(rep, "mixed weights, no rollback path")
                failed.append(rid)
            return rolled, failed
        for rid in replica_ids:
            with self._lock:
                rep = self._replicas.get(rid)
            if rep is None:
                continue
            with self._lock:
                rep.state = DRAINING
            self._drain(rep, drain_timeout)
            ok, _ = self._reload_one(rep, rollback, rollback_step,
                                     None, ready_timeout)
            if ok:
                with self._lock:
                    rep.state = READY
                rolled.append(rid)
            else:
                self._evict(rep, "rollback reload failed")
                failed.append(rid)
        return rolled, failed

    def _replica_alive(self, rep: FleetReplica) -> bool:
        try:
            rep.client.healthz(timeout=self.probe_timeout)
            return True
        except Exception:
            return False

    # ------------------------------------------------------ autoscaling
    def add_pool(self, *, model_id: str = "default",
                 role: str = "unified",
                 spawner: Optional[ReplicaSpawner] = None,
                 autoscaler: Optional[Autoscaler] = None) -> None:
        """Register a (model, role) replica pool for pool-scoped
        autoscaling (docs/FLEET.md "Disaggregated roles"):
        `autoscale_tick` then sizes each registered pool independently
        between ITS autoscaler's min/max using ITS spawner — whose
        serve_args bake in the matching `--role`/`--model-id` — so
        per-role AND per-model floors/ceilings hold on one fleet. With
        no pools registered the legacy single-pool fleet-level signal
        runs unchanged. `spawner=None` falls back to the fleet
        spawner; `autoscaler=None` registers the pool for placement
        bookkeeping only (spawn_pool still works)."""
        with self._lock:
            self._pools[(model_id, role)] = {
                "spawner": (spawner if spawner is not None
                            else self.spawner),
                "autoscaler": autoscaler,
            }

    def spawn_pool(self, model_id: str, role: str,
                   n: int = 1) -> List[FleetReplica]:
        """Spawn n replicas into a registered (model, role) pool and
        stamp their pool membership (STARTING members have no
        announced identity yet — the stamp is what attributes them to
        the right pool's autoscaler)."""
        with self._lock:
            pool = self._pools.get((model_id, role))
        spawner = (pool or {}).get("spawner") or self.spawner
        if spawner is None:
            raise RuntimeError(
                f"no spawner for pool ({model_id!r}, {role!r})")
        out = []
        for _ in range(n):
            proc, url = spawner.spawn()
            rep = self.attach(url, proc=proc, spawned=True)
            rep.pool = (model_id, role)
            out.append(rep)
            self._m_spawned.inc()
        return out

    def _pool_members(self, model: str, role: str
                      ) -> List[FleetReplica]:
        """Non-evicted replicas belonging to a (model, role) pool: by
        spawn stamp when present, else by announced identity (caller
        holds the lock)."""
        out = []
        for r in self._replicas.values():
            if r.state == EVICTED:
                continue
            if r.pool is not None:
                if r.pool == (model, role):
                    out.append(r)
            elif (r.role == role
                  and (r.model_id or "default") == model):
                out.append(r)
        return out

    def _autoscale_pools(self) -> int:
        """One pool-scoped autoscale pass: each registered pool's
        queue-depth signal is computed over ITS members only, and
        spawn/retire act through ITS spawner. Returns the net delta."""
        applied = 0
        with self._lock:
            pools = list(self._pools.items())
        for (model, role), pool in pools:
            scaler = pool.get("autoscaler")
            if scaler is None:
                continue
            with self._lock:
                members = self._pool_members(model, role)
                live = [r for r in members
                        if r.state in (READY, SUSPECT, STARTING)]
                outstanding = sum(r.outstanding for r in members)
            delta = scaler.decide(len(live), outstanding)
            if delta > 0:
                self.spawn_pool(model, role, 1)
                scaler.note_action()
                applied += 1
            elif delta < 0:
                ready = [r for r in live
                         if r.state == READY and r.spawned]
                if ready:
                    victim = min(ready, key=lambda r: r.outstanding)
                    self.retire(victim.id)
                    scaler.note_action()
                    applied -= 1
        return applied

    def autoscale_tick(self) -> int:
        """Apply one autoscaler decision; returns the delta applied.
        With registered pools (add_pool) the pass is pool-scoped; the
        legacy fleet-level signal runs otherwise."""
        if self._reload_active:
            return 0  # never resize mid-reload
        if self._pools:
            return self._autoscale_pools()
        if self.autoscaler is None or self.spawner is None:
            return 0
        with self._lock:
            live = [r for r in self._replicas.values()
                    if r.state in (READY, SUSPECT, STARTING)]
            outstanding = sum(r.outstanding
                              for r in self._replicas.values())
            batch_backlog = self._tier_inflight[TIER_BATCH]
        delta = self.autoscaler.decide(len(live), outstanding,
                                       batch_backlog=batch_backlog)
        if delta > 0:
            self.spawn(1)
            self.autoscaler.note_action()
            return 1
        if delta < 0:
            ready = [r for r in live if r.state == READY and r.spawned]
            if not ready:
                return 0
            victim = min(ready, key=lambda r: r.outstanding)
            self.retire(victim.id)
            self.autoscaler.note_action()
            return -1
        return 0

    # --------------------------------------------------- observability
    def snapshot(self) -> dict:
        now = time.time()
        with self._lock:
            reps = {rid: r.snapshot(now)
                    for rid, r in self._replicas.items()}
        heartbeats = self.tracker.heartbeats()
        for rid, hb in heartbeats.items():
            if rid in reps:
                reps[rid]["heartbeat_age_s"] = round(now - hb, 3)
        # per-checkpoint-identity aggregation: "path@step" -> [rids].
        # The deployment controller's torn-promotion gate reads this
        # off the router's /stats — a converged fleet shows exactly one
        # identity key across its READY replicas (docs/PIPELINE.md)
        served: Dict[str, list] = {}
        # per-model aggregation (docs/FLEET.md "Disaggregated roles"):
        # one router, N models — each model's role pools, served
        # checkpoints, and prefix-cache view keyed by model_id (the
        # multi-model /stats section the deployment controller and the
        # cross-model isolation drill read)
        models: Dict[str, dict] = {}
        for rid, r in sorted(reps.items()):
            if r.get("state") == EVICTED:
                continue  # not serving: a stale identity is not "served"
            ck = r.get("checkpoint")
            key = (f"{ck.get('path')}@{ck.get('step')}" if ck else "none")
            served.setdefault(key, []).append(rid)
            m = r.get("model_id") or "default"
            sec = models.setdefault(
                m, {"replicas": [], "roles": {},
                    "checkpoints_served": {}})
            sec["replicas"].append(rid)
            ro = r.get("role") or "unified"
            sec["roles"][ro] = sec["roles"].get(ro, 0) + 1
            sec["checkpoints_served"].setdefault(key, []).append(rid)
        for m, sec in models.items():
            sec["prefix_cache"] = self._prefix_section(model_id=m)
            pinned = self.model_checkpoints.get(m)
            if pinned is not None:
                sec["current_checkpoint"] = pinned[0]
                sec["current_step"] = pinned[1]
        return {
            "replicas": reps,
            "checkpoints_served": served,
            "roles": self.role_counts(),
            "models": models,
            "states": self.state_counts(),
            "breakers": self.breaker_counts(),
            "outstanding": self.total_outstanding(),
            "incarnation": self.incarnation,
            "state_dir": self.state_dir,
            "adoptions": list(self.adoption_events),
            "shed_high_water": self.shed_high_water,
            "current_checkpoint": self.current_checkpoint,
            "current_step": self.current_step,
            "rolling_reload_active": self._reload_active,
            "retry_budget": self.retry_budget,
            "requests": {route: int(c.value)
                         for route, c in self._m_requests.items()},
            "retries": int(self._m_retries.value),
            "stream_resume_attempts": self.stream_resume_attempts,
            "stream_resumes": int(self._m_stream_resumes.value),
            "stream_resume_failures": int(
                self._m_stream_resume_failures.value),
            "stream_tokens_replayed": int(
                self._m_stream_tokens_replayed.value),
            "stream_tokens_deduped": int(
                self._m_stream_tokens_deduped.value),
            "disagg": {
                "handoffs": int(self._m_disagg_handoffs.value),
                "handoff_bytes": int(
                    self._m_disagg_handoff_bytes.value),
                "handoff_failures": int(
                    self._m_disagg_handoff_failures.value),
                "fallbacks": int(self._m_disagg_fallbacks.value),
            },
            "request_timeouts": int(self._m_timeouts.value),
            "breaker_opens": int(self._m_breaker_opens.value),
            "deadline_exceeded": {route: int(c.value)
                                  for route, c in
                                  self._m_deadline.items()},
            "shed": {route: int(c.value)
                     for route, c in self._m_shed.items()},
            "tiers": {
                "batch_high_water": self.batch_high_water,
                "inflight": {t: self._tier_inflight[t] for t in TIERS},
                "requests": {t: int(c.value) for t, c
                             in self._m_tier_requests.items()},
                "shed": {t: int(c.value) for t, c
                         in self._m_tier_shed.items()},
                "preempt_resumes": int(self._m_preempt_resumes.value),
                "utilization": round(self.utilization(), 4),
            },
            "prefix_cache": self._prefix_section(),
            "evictions": int(self._m_evictions.value),
            "readmissions": int(self._m_readmissions.value),
            "reloads": {outcome: int(c.value)
                        for outcome, c in self._m_reloads.items()},
            "spawned": int(self._m_spawned.value),
            "retired": int(self._m_retired.value),
            "autoscaler": (None if self.autoscaler is None else {
                "min_replicas": self.autoscaler.min_replicas,
                "max_replicas": self.autoscaler.max_replicas,
                "scale_up_at": self.autoscaler.scale_up_at,
                "scale_down_at": self.autoscaler.scale_down_at,
                "batch_backlog_up_at":
                    self.autoscaler.batch_backlog_up_at,
            }),
        }
