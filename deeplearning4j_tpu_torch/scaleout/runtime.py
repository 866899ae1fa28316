"""In-process distributed runtime: master/worker choreography, the
counterpart of the JAX package's `scaleout/runtime.py` (host code, the
same choreography).

Parity: reference Akka runtime (SURVEY §2.3/§3.2) —
`DeepLearning4jDistributed` (runner), `MasterActor` (1 s heartbeat poll:
workRouter.sendWork -> nextBatch; stale-job reaping; 120 s worker eviction;
DoneMessage -> aggregate updates -> setCurrent), `WorkerActor` (1 s
heartbeat that re-registers, jobFor -> perform -> addUpdate -> clearJob,
replicate current model when needsReplicate), `BatchActor` (hand the next
mini-batch job to each free worker), `ModelSavingActor` ("save" topic).

Design: actors/Hazelcast become plain threads + the in-memory
StateTracker — the whole runtime runs embedded in one process (the
reference's own test tier, BaseTestDistributed). The heavy math happens
on each performer's device inside its `fit` (`NeuralNetWorkPerformer`'s
`device`, the CUDA device by default); this layer moves packed parameter
vectors as host numpy, one copy per job. Across hosts a "worker" may be a
whole process group running `parallel.DataParallelTrainer` internally,
its gradient exchange on NCCL, never this queue; elasticity (stale
eviction + late registration) lives at that level.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Type

import numpy as np

from deeplearning4j_tpu_torch.scaleout.aggregator import (
    ParameterAveragingAggregator,
)
from deeplearning4j_tpu_torch.scaleout.api import (
    IterativeReduceWorkRouter,
    Job,
    JobIterator,
    WorkerPerformer,
    WorkRouter,
)
from deeplearning4j_tpu_torch.scaleout.statetracker import InMemoryStateTracker

log = logging.getLogger(__name__)

#: tracker counter bumped by workers when a job exhausts its retries, so the
#: master's wave barrier can stop waiting for it
JOBS_DROPPED = "_jobs_dropped"


#: bounded job-retry budget shared by every worker variant
MAX_JOB_RETRIES = 3


def perform_job(tracker, worker_id, performer, job, *,
                work_retriever=None, max_retries=MAX_JOB_RETRIES,
                before_perform=None) -> bool:
    """Execute ONE fetched job under the worker contract shared by the
    in-process `_Worker`, the launcher's remote worker, and the
    supervised elastic worker: resolve the payload (WorkRetriever data
    plane), perform, publish the update, clear the job — or requeue it
    with the bounded retry budget, incrementing `JOBS_DROPPED` when the
    budget runs out so the master's exact wave barrier stops waiting.
    `before_perform(job)` runs inside the try (a failure there is a job
    failure — the supervised worker's chaos point). ConnectionError
    propagates: for a remote worker the master being gone is a shutdown
    signal, not a job failure. Returns True when the job performed."""
    try:
        if before_perform is not None:
            before_perform(job)
        if job.work is None and work_retriever is not None:
            # payload travels via the WorkRetriever data plane, not the
            # tracker (reference WorkRetriever.load)
            stored = work_retriever.load(worker_id)
            if stored is not None:
                job.work = stored.work
        performer.perform(job)
        tracker.add_update(worker_id, job.result)
        tracker.clear_job(worker_id)
        if work_retriever is not None:
            work_retriever.clear(worker_id)
        return True
    except ConnectionError:
        raise
    except Exception:  # requeue (bounded), don't kill the loop
        log.exception("worker %s failed job", worker_id)
        tracker.clear_job(worker_id)
        job.retries += 1
        if job.retries < max_retries:
            tracker.add_job(job)
        else:
            log.error("dropping job for %s after %d retries",
                      worker_id, job.retries)
            # the master's exact wave barrier must not wait for an
            # update that will never come
            tracker.increment(JOBS_DROPPED)
        return False


class _Worker(threading.Thread):
    """Worker loop (reference WorkerActor.java:166-215 heartbeat body)."""

    MAX_RETRIES = MAX_JOB_RETRIES

    def __init__(self, worker_id: str, tracker: InMemoryStateTracker,
                 performer: WorkerPerformer, interval: float,
                 work_retriever=None):
        super().__init__(name=f"dl4j-worker-{worker_id}", daemon=True)
        self.worker_id = worker_id
        self.tracker = tracker
        self.performer = performer
        self.interval = interval
        self.work_retriever = work_retriever
        self.performed = 0
        self.paused = threading.Event()  # set => skip heartbeats (fault inj.)

    def run(self):
        tracker, wid = self.tracker, self.worker_id
        if hasattr(self.performer, "bind_tracker"):
            self.performer.bind_tracker(tracker)  # e.g. w2v alpha counter
        tracker.add_worker(wid)
        while not tracker.is_done():
            if self.paused.is_set():
                time.sleep(self.interval)
                continue
            tracker.heartbeat(wid)  # re-registers if evicted (elasticity)
            if tracker.needs_replicate(wid):
                current = tracker.get_current()
                if current is not None:
                    self.performer.update(current)
                tracker.done_replicating(wid)
            job = tracker.job_for(wid)
            if job is not None and job.result is None:
                if perform_job(tracker, wid, self.performer, job,
                               work_retriever=self.work_retriever,
                               max_retries=self.MAX_RETRIES):
                    self.performed += 1
            else:
                time.sleep(self.interval)


class DistributedRuntime:
    """Embedded master + N workers over a StateTracker.

    `performer_factory` builds one WorkerPerformer per worker (the reference's
    WorkerPerformerFactory config key). `sync=True` uses iterative-reduce
    waves (aggregate when ALL workers reported); `sync=False` is hogwild:
    every arriving update merges into the current model immediately
    (reference HogWildWorkRouter + MultiLayerNetwork.merge :1361).
    """

    def __init__(
        self,
        job_iterator: JobIterator,
        performer_factory: Callable[[], WorkerPerformer],
        n_workers: int = 2,
        tracker: Optional[InMemoryStateTracker] = None,
        router_cls: Optional[Type[WorkRouter]] = None,
        heartbeat_interval: float = 0.01,
        model_saver=None,
        save_every_waves: int = 0,
        initial_params: Optional[np.ndarray] = None,
        aggregator_factory: Optional[Callable] = None,
        work_retriever=None,
    ):
        self.job_iterator = job_iterator
        self.tracker = tracker or InMemoryStateTracker()
        self.n_workers = n_workers
        # performer_factory=None => workers live in other processes
        # (MultiProcessMaster) and bring their own performers
        self.performers = ([performer_factory() for _ in range(n_workers)]
                           if performer_factory is not None else [])
        self.router = (router_cls or IterativeReduceWorkRouter)(self.tracker)
        # Declarative router policy: barrier-style routers aggregate in
        # waves; async routers merge updates as they arrive, with
        # send_work() gating each dispatch (reference WorkRouter.sendWork).
        self.sync = self.router.synchronous
        self.interval = heartbeat_interval
        self.model_saver = model_saver
        self.save_every_waves = save_every_waves
        self.workers: List[_Worker] = []
        self.work_retriever = work_retriever
        self.aggregator_factory = (aggregator_factory
                                   or ParameterAveragingAggregator)
        self.waves = 0
        #: jobs pulled from the iterator so far
        self.jobs_consumed = 0
        #: updates folded into the published model (one per job); see
        #: _resume_cursor for how the checkpointed position is derived
        self.jobs_aggregated = 0
        #: stream positions of every update folded into the published
        #: model, in fold order — the batch-index trace the elastic
        #: drills audit ("no example dropped or double-trained")
        self.folded_seqs: List[int] = []
        #: last job-stream seq dispatched to each worker: aggregation
        #: folds in SEQ order so the averaged sum is a function of the
        #: wave's job set alone, never of completion order or of which
        #: (possibly respawned) worker computed which job — what makes
        #: an elastic run bit-identical to an uninterrupted one
        self._seq_of: Dict[str, int] = {}
        self._orphan_jobs: List[Job] = []  # evicted workers' in-flight jobs
        # Exact wave membership (reference IterativeReduceWorkRouter.java:46-57
        # barrier): number of jobs dispatched into the current wave. The wave
        # completes only when that many updates arrived — an eviction mid-wave
        # re-forms the wave (its orphan job is re-served to a live worker and
        # the barrier keeps waiting) instead of silently shrinking it.
        self._wave_size = 0
        self._wave_dropped_base = 0  # JOBS_DROPPED count when wave opened
        if initial_params is not None:
            self.tracker.set_current(np.asarray(initial_params))

    # ------------------------------------------------------------ lifecycle
    def start_workers(self):
        if self.workers:  # idempotent: run() also calls this, and two
            return        # threads sharing one performer would race
        for i, performer in enumerate(self.performers):
            w = _Worker(f"worker-{i}", self.tracker, performer, self.interval,
                        work_retriever=self.work_retriever)
            self.workers.append(w)
            w.start()

    def _free_workers(self) -> List[str]:
        assigned = {j.worker_id for j in self.tracker.jobs()}
        pending = set(self.tracker.worker_updates())
        return [w for w in self.tracker.workers()
                if w not in assigned and w not in pending]

    def _dispatch_wave(self, orphans_only: bool = False) -> int:
        """Hand jobs to free workers. `orphans_only` re-serves evicted
        members' jobs into an OPEN wave without pulling new work from the
        iterator (the re-formed wave keeps its original membership)."""
        sent = 0
        for wid in self._free_workers():
            if self._orphan_jobs:  # re-serve evicted workers' jobs first
                job = self._orphan_jobs.pop()
                job.worker_id = wid
                job.result = None
            elif not orphans_only and self.job_iterator.has_next():
                try:
                    job = self.job_iterator.next(wid)
                except StopIteration:
                    break
                if job.seq is None:
                    job.seq = self.jobs_consumed
                self.jobs_consumed += 1
            else:
                break
            if job.seq is not None:
                self._seq_of[wid] = job.seq
            if self.work_retriever is not None and job.work is not None:
                # data plane: payload goes through the WorkRetriever
                # (reference BatchActor routeJob -> workRetriever.save);
                # the tracker carries only the light descriptor
                self.work_retriever.save(wid, job)
                job = Job(work=None, worker_id=wid, retries=job.retries,
                          seq=job.seq)
            self.router.route_job(job)
            sent += 1
        return sent

    def _has_work(self) -> bool:
        return bool(self._orphan_jobs) or self.job_iterator.has_next()

    def _open_wave(self) -> int:
        """Dispatch a new wave and record its exact membership size."""
        self._wave_dropped_base = self.tracker.count(JOBS_DROPPED)
        self._wave_opened_at = time.monotonic()
        self._wave_size = self._dispatch_wave()
        return self._wave_size

    def _sync_tick(self, n_updates: int, n_outstanding: int) -> bool:
        """One master poll in iterative-reduce mode; True => job stream
        drained (stop). Exact wave barrier (reference
        IterativeReduceWorkRouter.java:46-57)."""
        if self._wave_size:
            # Open wave: first re-serve any evicted member's job to a
            # live worker (wave re-forms), then hold the barrier until
            # EVERY dispatched job has reported — exact membership,
            # not "whatever jobs happen to remain".
            if self._orphan_jobs:
                sent = self._dispatch_wave(orphans_only=True)
                if not sent and not n_outstanding \
                        and not self._expecting_capacity():
                    # Every surviving member has reported and nobody is
                    # free to take the orphan (live workers all hold
                    # pending updates; re-dispatching to one would
                    # overwrite its update). Close the wave on the
                    # survivors and carry the orphan into the next wave —
                    # it is served first there — instead of spinning
                    # until the run timeout.
                    log.warning(
                        "wave of %d: %d orphan job(s) undeliverable, "
                        "closing wave on survivors and carrying them over",
                        self._wave_size, len(self._orphan_jobs))
                    self._aggregate_and_publish()
                    self._wave_size = 0
            elif self._wave_complete(n_updates, n_outstanding):
                self._aggregate_and_publish()
                self._wave_size = 0
        elif n_updates and not n_outstanding:
            # stray updates with no open wave — e.g. an evicted worker
            # re-registered and completed its old job after the wave it
            # belonged to already closed. Fold them in (at-least-once
            # semantics; averaging tolerates the duplicate batch) so the
            # loop can't livelock on an update nobody is waiting for.
            self._aggregate_and_publish()
        elif not n_updates and not n_outstanding:
            if not self._has_work():
                return True
            if (self._expecting_capacity()
                    and len(self._free_workers()) < self.n_workers):
                # a replacement worker is on its way: hold the next
                # wave until the pool is whole again, so wave
                # composition matches the uninterrupted schedule
                # (capacity that never arrives flips the flag off and
                # the wave opens on the survivors)
                return False
            self._open_wave()
        return False

    def _wave_complete(self, n_updates: int, n_outstanding: int) -> bool:
        """True when every job dispatched into the current wave has either
        reported an update or been dropped after exhausting retries.
        Evicted members don't shrink the wave: their orphan jobs are
        re-served (`_dispatch_wave(orphans_only=True)`) and the barrier
        keeps waiting for their updates."""
        if n_outstanding or self._orphan_jobs:
            return False
        dropped = (self.tracker.count(JOBS_DROPPED)
                   - getattr(self, "_wave_dropped_base", 0))
        return n_updates + dropped >= self._wave_size

    def _aggregate_and_publish(self):
        """Average pending updates into the new global model (reference
        MasterActor DoneMessage handling :219-330). Only the snapshot of
        updates that was aggregated is cleared — updates arriving
        mid-aggregation survive for the next round.

        Updates fold in canonical JOB-SEQ order (not arrival order): a
        float sum depends on operand order, so folding by the stream
        position of the job each update answers makes the published
        params a pure function of the wave's job set — an evicted
        worker's orphan job redone by a respawned peer aggregates bit-
        identically to the uninterrupted run."""
        snapshot = self.tracker.worker_updates()
        if not snapshot:
            return
        inf = float("inf")
        snapshot = sorted(snapshot,
                          key=lambda w: (self._seq_of.get(w, inf), w))
        agg = self.aggregator_factory()
        for wid in snapshot:
            update = self.tracker.load_update(wid)
            if update is not None:
                agg.accumulate(Job(work=None, worker_id=wid, result=update))
        averaged = agg.aggregate()
        if averaged is None:
            return
        current = self.tracker.get_current()
        if hasattr(agg, "apply"):
            # aggregators with custom publication semantics (delta
            # application, counter merge — the distributed NLP performers)
            new = agg.apply(current, averaged)
        elif current is not None and self.sync:
            # epoch-wave averaging: replace (all replicas started from
            # `current`, so the average IS the merged model)
            new = averaged
        elif current is not None:
            # hogwild merge: current += (update_avg - current)/n
            n = max(1, len(self.tracker.workers()))
            new = np.asarray(current) + (averaged - np.asarray(current)) / n
        else:
            new = averaged
        self.tracker.set_current(new)
        for wid in snapshot:
            self.tracker.clear_update(wid)
            seq = self._seq_of.pop(wid, None)
            if seq is not None:
                self.folded_seqs.append(seq)
        self.waves += 1
        self.jobs_aggregated += len(snapshot)
        if (self.model_saver is not None and self.save_every_waves
                and self.waves % self.save_every_waves == 0):
            self._save()

    def _resume_cursor(self) -> int:
        """Job-stream position a resumed master may safely seek() to.

        Never overshoots work that is NOT in the saved params: counts
        only updates actually folded in (jobs_aggregated) plus jobs
        finally dropped after retries (re-running those would fail
        again), capped at jobs pulled — the cap keeps at-least-once
        duplicates (an evicted worker's late update folding alongside
        the orphan's redo) from skipping never-trained batches.
        Undershoot merely re-trains a batch, which parameter averaging
        tolerates; overshoot would silently lose training data."""
        dropped = self.tracker.count(JOBS_DROPPED)
        return int(min(self.jobs_consumed,
                       self.jobs_aggregated + dropped))

    def _save(self):
        """Checkpoint the current averaged model (reference ModelSavingActor
        "save" topic). The saver's save_current gets the packed params plus
        the conf JSON so the checkpoint is self-describing, and the
        first-class iterator_position resume cursor."""
        conf_json = getattr(self, "conf_json", None)
        if conf_json is None and self.performers:
            conf_json = getattr(self.performers[0], "conf_json", None)
        self.model_saver.save_current(
            self.tracker.get_current(), conf_json=conf_json,
            iterator_position=self._resume_cursor(),
            metadata={"waves": self.waves})

    def _tick(self):
        """Per-poll supervision hook, called once per master loop pass
        (including the registration wait). The base runtime does nothing;
        TrainingSupervisor overrides it with process health, respawn,
        straggler, and elastic-resume duties."""

    def _expecting_capacity(self) -> bool:
        """True while replacement workers are known to be on their way
        (the supervisor's respawn pipeline). An open wave holding an
        undeliverable orphan then KEEPS its barrier — the orphan is
        served to the respawned member and the wave re-forms with its
        original membership (what makes the respawn path bit-identical)
        — instead of closing early on the survivors. The base runtime
        has no respawn pipeline, so capacity never arrives: False."""
        return False

    def _evict_stale(self):
        for wid in self.tracker.stale_workers():
            log.warning("evicting stale worker %s", wid)
            orphan = self.tracker.remove_worker(wid)
            if orphan is not None and orphan.result is None:
                work = orphan.work
                if work is None and self.work_retriever is not None:
                    # payload lives in the WorkRetriever under the evicted
                    # worker's id; pull it back so the re-dispatch can
                    # re-save it under the new assignee
                    stored = self.work_retriever.load(wid)
                    if stored is not None:
                        work = stored.work
                    self.work_retriever.clear(wid)
                # fresh Job: the evicted worker may still be mutating the
                # old instance; sharing it would let a late completion
                # poison the reassigned copy
                self._orphan_jobs.append(Job(work=work,
                                             worker_id=orphan.worker_id,
                                             retries=orphan.retries,
                                             seq=orphan.seq))

    # ---------------------------------------------------------------- train
    def run(self, timeout: float = 120.0) -> np.ndarray:
        """Run to completion of the job stream; returns final averaged
        params (reference DeepLearning4jDistributed.train)."""
        self.start_workers()
        deadline = time.time() + timeout
        # wait for registration
        while len(self.tracker.workers()) < self.n_workers:
            self._tick()  # a crashed spawn must be respawnable even here
            if time.time() > deadline:
                raise TimeoutError("workers failed to register")
            time.sleep(self.interval)

        while time.time() < deadline:
            self._tick()
            self._evict_stale()
            n_updates = len(self.tracker.worker_updates())
            n_outstanding = len(self.tracker.jobs())
            if self.sync:
                if self._sync_tick(n_updates, n_outstanding):
                    break
            else:
                if n_updates:
                    self._aggregate_and_publish()
                if self._has_work():
                    if self.router.send_work():
                        self._dispatch_wave()
                elif not n_outstanding and not n_updates:
                    break
            if self.tracker.early_stop():
                log.info("early stop tripped")
                break
            time.sleep(self.interval)

        # drain any final updates
        if self.tracker.worker_updates():
            self._aggregate_and_publish()
        self.tracker.finish()
        for w in self.workers:
            w.join(timeout=5.0)
        return self.tracker.get_current()
