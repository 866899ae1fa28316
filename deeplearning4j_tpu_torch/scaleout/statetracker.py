"""Cluster-coordination state tracker.

Parity: reference StateTracker.java:43 (~60 methods: worker registry,
heartbeats, job assignment, update collection, current-model storage,
replication flags, counters, generic KV, early-stop state, mini-batch
sizing) and its Hazelcast implementation BaseHazelCastStateTracker.java
(heartbeats :909, jobs :833, updates :423, current model IAtomicReference
:76, early-stop fields :70-93, removeWorker :875).

Design: one thread-safe in-memory implementation. The data plane never
goes through the tracker (collectives own it); the tracker is pure
control state, so a single coordinator host replaces the Hazelcast
replicated-map cluster. The interface is kept so a gRPC/etcd
implementation can be swapped in without touching the runtime. A copy of
the JAX package's module; the serving fleet uses it as its health store
(`heartbeat`, `stale_workers`, `heartbeats`).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.scaleout.api import (
    InMemoryUpdateSaver,
    Job,
    UpdateSaver,
)


class InMemoryStateTracker:
    """Thread-safe in-process StateTracker (embedded-Hazelcast equivalent,
    the reference's test-tier tracker, BaseTestDistributed.java:32-95)."""

    def __init__(self, update_saver: Optional[UpdateSaver] = None,
                 heartbeat_timeout: float = 120.0):
        self._lock = threading.RLock()
        self._workers: Dict[str, float] = {}  # id -> registration time
        self._heartbeats: Dict[str, float] = {}
        self._jobs: Dict[str, Job] = {}
        self._updates: List[str] = []  # worker ids with pending updates
        self._update_saver = update_saver or InMemoryUpdateSaver()
        self._current: Any = None  # the global model (packed params)
        self._needs_replicate: Dict[str, bool] = {}
        self._counters: Dict[str, float] = {}
        self._kv: Dict[str, Any] = {}
        self._done = False
        self.heartbeat_timeout = heartbeat_timeout
        # early-stop state (reference BaseHazelCastStateTracker.java:70-93)
        self._initial_patience = 40.0
        self._patience = 40.0
        self._best_loss = float("inf")
        self._early_stop = False
        self._improvement_threshold = 1e-4
        # mini-batch sizing (reference inputSplit)
        self._batch_size: Optional[int] = None

    # ------------------------------------------------------- worker registry
    def add_worker(self, worker_id: str) -> None:
        with self._lock:
            now = time.time()
            new = worker_id not in self._workers
            self._workers.setdefault(worker_id, now)
            self._heartbeats[worker_id] = now
            if new and self._current is not None:
                # late joiner must pull the current global model before
                # training (reference WorkerActor replication on join)
                self._needs_replicate[worker_id] = True

    def remove_worker(self, worker_id: str) -> Optional[Job]:
        """Evict a worker; returns its in-flight job (if any) so the caller
        can reroute it to a live worker (reference removeWorker :875-880 +
        MasterActor stale-job requeue :117-131)."""
        with self._lock:
            self._workers.pop(worker_id, None)
            self._heartbeats.pop(worker_id, None)
            orphan = self._jobs.pop(worker_id, None)
            self._needs_replicate.pop(worker_id, None)
            return orphan

    def workers(self) -> List[str]:
        with self._lock:
            return list(self._workers)

    def heartbeat(self, worker_id: str) -> None:
        with self._lock:
            if worker_id not in self._workers:  # re-register (elasticity)
                self._workers[worker_id] = time.time()
                if self._current is not None:
                    self._needs_replicate[worker_id] = True
            self._heartbeats[worker_id] = time.time()

    def heartbeats(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._heartbeats)

    def stale_workers(self, now: Optional[float] = None) -> List[str]:
        """Workers whose heartbeat is older than the timeout
        (reference MasterActor eviction, MasterActor.java:137-160)."""
        now = now if now is not None else time.time()
        with self._lock:
            return [w for w, hb in self._heartbeats.items()
                    if now - hb >= self.heartbeat_timeout]

    # ------------------------------------------------------- job assignment
    def add_job(self, job: Job) -> None:
        with self._lock:
            self._jobs[job.worker_id] = job

    def job_for(self, worker_id: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(worker_id)

    def clear_job(self, worker_id: str) -> None:
        with self._lock:
            self._jobs.pop(worker_id, None)

    def jobs(self) -> List[Job]:
        with self._lock:
            return list(self._jobs.values())

    # ----------------------------------------------------- update collection
    def add_update(self, worker_id: str, update: Any) -> None:
        """Record a worker result (reference addUpdate :423 — spills through
        the UpdateSaver rather than holding params in tracker memory)."""
        with self._lock:
            self._update_saver.save(worker_id, update)
            if worker_id not in self._updates:
                self._updates.append(worker_id)

    def worker_updates(self) -> List[str]:
        with self._lock:
            return list(self._updates)

    def load_update(self, worker_id: str) -> Any:
        return self._update_saver.load(worker_id)

    def clear_update(self, worker_id: str) -> None:
        """Drop ONE worker's pending update — used after aggregation so
        updates that arrive mid-aggregation are never lost."""
        with self._lock:
            if worker_id in self._updates:
                self._updates.remove(worker_id)
            self._update_saver.delete(worker_id)

    def clear_updates(self) -> None:
        with self._lock:
            self._updates.clear()
            self._update_saver.clear()

    def update_saver(self) -> UpdateSaver:
        return self._update_saver

    # ------------------------------------------------------- current model
    def set_current(self, model: Any) -> None:
        """Store the global model (reference IAtomicReference "master" :76)."""
        with self._lock:
            self._current = model
            for w in self._workers:
                self._needs_replicate[w] = True

    def get_current(self) -> Any:
        with self._lock:
            return self._current

    def needs_replicate(self, worker_id: str) -> bool:
        with self._lock:
            return self._needs_replicate.get(worker_id, False)

    def done_replicating(self, worker_id: str) -> None:
        with self._lock:
            self._needs_replicate[worker_id] = False

    # ----------------------------------------------------------- counters/KV
    def increment(self, key: str, by: float = 1.0) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + by

    def count(self, key: str) -> float:
        with self._lock:
            return self._counters.get(key, 0.0)

    def counters(self) -> Dict[str, float]:
        """All counters at once (status/observability surface)."""
        with self._lock:
            return dict(self._counters)

    def define(self, key: str, value: Any) -> None:
        with self._lock:
            self._kv[key] = value

    def get(self, key: str) -> Any:
        with self._lock:
            return self._kv.get(key)

    # ------------------------------------------------------------ early stop
    def set_patience(self, patience: float) -> None:
        with self._lock:
            self._initial_patience = patience
            self._patience = patience

    def patience(self) -> float:
        with self._lock:
            return self._patience

    def report_loss(self, loss: float) -> None:
        """Track best loss; trip early-stop when no improvement consumes
        the remaining patience (reference patience/bestLoss fields)."""
        with self._lock:
            if loss < self._best_loss - self._improvement_threshold:
                self._best_loss = loss
                self._patience = self._initial_patience  # full reset
            else:
                self._patience -= 1.0
                if self._patience <= 0:
                    self._early_stop = True

    def best_loss(self) -> float:
        with self._lock:
            return self._best_loss

    def early_stop(self) -> bool:
        with self._lock:
            return self._early_stop

    # ------------------------------------------------------------- lifecycle
    def input_split(self, batch_size: int) -> None:
        with self._lock:
            self._batch_size = batch_size

    def batch_size(self) -> Optional[int]:
        with self._lock:
            return self._batch_size

    def finish(self) -> None:
        with self._lock:
            self._done = True

    def is_done(self) -> bool:
        with self._lock:
            return self._done

    def shutdown(self) -> None:
        self.finish()
