"""The scaleout API: the distributable-work contract.

Parity: reference deeplearning4j-scaleout-api (SURVEY §2.2) —
`Job` (…/scaleout/job/Job.java:24: {work, result, workerId}),
`JobIterator`/`JobIteratorFactory` (…/scaleout/job/),
`WorkerPerformer` (…/scaleout/perform/WorkerPerformer.java:
perform/update/setup), `JobAggregator` (…/scaleout/aggregator/),
`WorkRouter`/`BaseWorkRouter` (…/api/workrouter/: sendWork gate + routeJob),
`UpdateSaver` (…/api/statetracker/UpdateSaver.java: off-heap persistence of
pending updates).

These are deliberately plain-Python host-side objects: the heavy
parameter exchange rides the device collectives of the parallel trainers,
so the scaleout layer only moves small control records and (for
parameter-averaging parity mode) packed parameter vectors between host
threads/processes. A copy of the JAX package's module (the port imports
nothing of that package); the serving fleet's health store
(`statetracker.InMemoryStateTracker`) builds on it.
"""

from __future__ import annotations

import os
import tempfile
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


@dataclass
class Job:
    """Unit of distributable work (reference Job.java:24). `seq` is the
    job's position in the run's job stream (assigned at dispatch) — the
    stable identity that survives eviction/re-serve, so aggregation can
    fold updates in a canonical order and resume audits can account for
    every batch exactly once."""

    work: Any
    worker_id: str
    result: Any = None
    retries: int = 0
    seq: Optional[int] = None

    def __repr__(self):
        return (f"Job(worker_id={self.worker_id!r}, seq={self.seq}, "
                f"has_result={self.result is not None})")


class JobIterator:
    """Stream of Jobs bound to worker ids (reference JobIterator)."""

    def next(self, worker_id: str) -> Job:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def position(self) -> int:
        """Jobs consumed so far (the resume cursor)."""
        raise NotImplementedError

    def seek(self, position: int) -> None:
        """Jump the stream to `position` jobs consumed — how a resumed
        master skips the work a crashed run already aggregated
        (checkpoints record it as iterator_position; reference analog:
        re-reading the HDFS batch offset after ModelSavingActor
        restore)."""
        raise NotImplementedError


class CollectionJobIterator(JobIterator):
    """Iterate a fixed collection of work items
    (reference CollectionJobIterator)."""

    def __init__(self, items: List[Any]):
        self.items = list(items)
        self._pos = 0
        self._lock = threading.Lock()

    def next(self, worker_id: str) -> Job:
        with self._lock:
            if self._pos >= len(self.items):
                raise StopIteration
            item = self.items[self._pos]
            self._pos += 1
        return Job(work=item, worker_id=worker_id)

    def has_next(self) -> bool:
        with self._lock:
            return self._pos < len(self.items)

    def reset(self) -> None:
        with self._lock:
            self._pos = 0

    def position(self) -> int:
        with self._lock:
            return self._pos

    def seek(self, position: int) -> None:
        if not 0 <= position <= len(self.items):
            raise ValueError(f"seek({position}) outside 0..{len(self.items)}")
        with self._lock:
            self._pos = position


class DataSetJobIterator(JobIterator):
    """Wrap a DataSetIterator as a stream of mini-batch jobs (the reference's
    BatchActor pattern: each wave hands the next mini-batch to a worker,
    akka BatchActor.java:72-160)."""

    def __init__(self, dataset_iterator):
        self.it = dataset_iterator
        self._iter: Optional[Iterator] = None
        self._pending: Optional[Any] = None
        self._consumed = 0
        self._lock = threading.Lock()

    def _ensure(self):
        if self._iter is None:
            self.it.reset()
            self._iter = iter(self.it)

    def next(self, worker_id: str) -> Job:
        with self._lock:
            self._ensure()
            if self._pending is not None:
                ds, self._pending = self._pending, None
            else:
                ds = next(self._iter)
            self._consumed += 1
            return Job(work=ds, worker_id=worker_id)

    def has_next(self) -> bool:
        with self._lock:
            self._ensure()
            if self._pending is not None:
                return True
            try:
                self._pending = next(self._iter)
                return True
            except StopIteration:
                return False

    def reset(self) -> None:
        with self._lock:
            self.it.reset()
            self._iter = iter(self.it)
            # drop any batch has_next() prefetched from the OLD pass —
            # leaking it would also put position() off by one, and an
            # overshooting cursor makes a later resume skip a batch
            self._pending = None
            self._consumed = 0

    def position(self) -> int:
        with self._lock:
            return self._consumed

    def seek(self, position: int) -> None:
        """Reset the wrapped DataSetIterator and drain `position`
        batches — batch streams have no random access, so the resume
        cursor replays the prefix (cheap: host-side iteration only)."""
        with self._lock:
            self.it.reset()
            self._iter = iter(self.it)
            self._pending = None
            self._consumed = 0
            for _ in range(position):
                try:
                    next(self._iter)
                except StopIteration:
                    raise ValueError(
                        f"seek({position}) past end of dataset stream"
                    ) from None
                self._consumed += 1


class WorkerPerformer:
    """Pluggable compute (reference WorkerPerformer.java): `perform(job)`
    fills job.result; `update(*args)` installs new global state;
    `setup(conf)` wires from a config dict."""

    def perform(self, job: Job) -> None:
        raise NotImplementedError

    def update(self, *args: Any) -> None:
        raise NotImplementedError

    def setup(self, conf: Dict[str, Any]) -> None:
        raise NotImplementedError


class JobAggregator:
    """Reduce worker results (reference JobAggregator/WorkAccumulator)."""

    def accumulate(self, job: Job) -> None:
        raise NotImplementedError

    def aggregate(self) -> Any:
        raise NotImplementedError


class WorkRouter:
    """Policy for when/where work is sent (reference WorkRouter/
    BaseWorkRouter: sendWork gate + routeJob)."""

    WORK_ROUTER = "work_router"  # config key parity

    #: True = barrier-style waves (aggregate when all workers report);
    #: False = async/hogwild (merge updates as they arrive, send_work()
    #: gates each dispatch). Subclasses declare their semantics here.
    synchronous: bool = True

    def __init__(self, state_tracker):
        self.tracker = state_tracker

    def send_work(self) -> bool:
        raise NotImplementedError

    def route_job(self, job: Job) -> None:
        self.tracker.add_job(job)


class IterativeReduceWorkRouter(WorkRouter):
    """Synchronous DP: dispatch the next wave only when every registered
    worker has reported its update (reference
    IterativeReduceWorkRouter.java:46-57)."""

    def send_work(self) -> bool:
        workers = self.tracker.workers()
        if not workers:
            return False
        return len(self.tracker.worker_updates()) >= len(workers)


class HogWildWorkRouter(WorkRouter):
    """Asynchronous DP: always send — lock-free hogwild-style updates
    (reference HogWildWorkRouter.java:44-47)."""

    synchronous = False

    def send_work(self) -> bool:
        return True


class UpdateSaver:
    """Persistence for pending updates (reference UpdateSaver.java)."""

    def save(self, worker_id: str, update: Any) -> None:
        raise NotImplementedError

    def load(self, worker_id: str) -> Any:
        raise NotImplementedError

    def keys(self) -> List[str]:
        raise NotImplementedError

    def delete(self, worker_id: str) -> None:
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError


class InMemoryUpdateSaver(UpdateSaver):
    def __init__(self):
        self._updates: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def save(self, worker_id, update):
        with self._lock:
            self._updates[worker_id] = update

    def load(self, worker_id):
        with self._lock:
            return self._updates.get(worker_id)

    def keys(self):
        with self._lock:
            return list(self._updates)

    def delete(self, worker_id):
        with self._lock:
            self._updates.pop(worker_id, None)

    def clear(self):
        with self._lock:
            self._updates.clear()


class LocalFileUpdateSaver(UpdateSaver):
    """Spill worker updates to local files keyed by worker id — updates
    accumulate on disk, not RAM (reference LocalFileUpdateSaver.java:36-120)."""

    def __init__(self, directory: Optional[str] = None):
        self.dir = directory or tempfile.mkdtemp(prefix="dl4j_tpu_updates_")
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, worker_id: str) -> str:
        safe = worker_id.replace(os.sep, "_")
        return os.path.join(self.dir, f"{safe}.update.npy")

    def save(self, worker_id, update):
        with self._lock:
            with open(self._path(worker_id), "wb") as f:
                np.save(f, np.asarray(update), allow_pickle=False)

    def load(self, worker_id):
        path = self._path(worker_id)
        if not os.path.exists(path):
            return None
        with self._lock:
            with open(path, "rb") as f:
                return np.load(f, allow_pickle=False)

    def keys(self):
        with self._lock:
            return [f[:-len(".update.npy")] for f in os.listdir(self.dir)
                    if f.endswith(".update.npy")]

    def delete(self, worker_id):
        path = self._path(worker_id)
        with self._lock:
            if os.path.exists(path):
                os.unlink(path)

    def clear(self):
        with self._lock:
            for f in os.listdir(self.dir):
                if f.endswith(".update.npy"):
                    os.unlink(os.path.join(self.dir, f))


class WorkRetriever:
    """Per-worker dataset storage/retrieval — keeps job payloads OUT of
    the coordination plane so the tracker/RPC path carries only light
    job descriptors (reference WorkRetriever.java:33-62: save/load/clear/
    workers)."""

    def save(self, worker_id: str, job: "Job") -> None:
        raise NotImplementedError

    def load(self, worker_id: str) -> Optional["Job"]:
        raise NotImplementedError

    def clear(self, worker_id: str) -> None:
        raise NotImplementedError

    def workers(self) -> List[str]:
        raise NotImplementedError


class LocalWorkRetriever(WorkRetriever):
    """File-per-worker work store (reference LocalWorkRetriever.java) on
    any shared filesystem, using the no-pickle npz+JSON checkpoint codec
    so a shared work directory cannot execute code on read."""

    SUFFIX = ".work.bin"

    def __init__(self, directory: Optional[str] = None):
        self.dir = directory or tempfile.mkdtemp(prefix="dl4j_tpu_work_")
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, worker_id: str) -> str:
        return os.path.join(self.dir,
                            worker_id.replace(os.sep, "_") + self.SUFFIX)

    def save(self, worker_id, job):
        # late imports: rpc/checkpoint depend on api's Job
        from deeplearning4j_tpu_torch.scaleout.checkpoint import dump_payload
        from deeplearning4j_tpu_torch.scaleout.rpc import _to_wire

        data = dump_payload(_to_wire(job))
        with self._lock:
            tmp = self._path(worker_id) + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, self._path(worker_id))

    def load(self, worker_id):
        from deeplearning4j_tpu_torch.scaleout.checkpoint import load_payload
        from deeplearning4j_tpu_torch.scaleout.rpc import _from_wire

        path = self._path(worker_id)
        with self._lock:
            if not os.path.exists(path):
                return None
            with open(path, "rb") as f:
                return _from_wire(load_payload(f.read()))

    def clear(self, worker_id):
        with self._lock:
            path = self._path(worker_id)
            if os.path.exists(path):
                os.unlink(path)

    def workers(self):
        with self._lock:
            return [f[:-len(self.SUFFIX)] for f in os.listdir(self.dir)
                    if f.endswith(self.SUFFIX)]
