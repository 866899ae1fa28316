"""Supervised training-worker entrypoint, the counterpart of the JAX
package's `scaleout/worker.py`.

The process half of `scaleout/supervisor.py`: joins a registered run
(same ConfigRegistry/RemoteStateTracker bootstrap as
`scaleout/launcher.py`), then runs the worker loop with the supervisor's
two extra planes wired in:

- a **progress socket** back to the supervisor (`progress_address` in
  the run config): one long-lived TCP connection carrying NDJSON lines
  — a hello announcing `(worker_id, pid, start_time, performed,
  last_seq)`, then `{"performed", "job_s", "last_seq"}` after every job
  plus periodic idle beats from a dedicated reporter thread. The
  supervisor heartbeats the tracker on the worker's behalf while this
  socket is OPEN (kernel-held counts: that is the point — a SIGSTOP'd
  worker "heartbeats" until the progress watermark catches it); the
  worker itself never calls `tracker.heartbeat`.
- **chaos points** (`testing/chaos.py`, activated per process via
  `DL4J_TPU_CHAOS` in the spawn env): `worker.spawn` before
  registration, `worker.step` before each job's fit, `worker.heartbeat`
  before each progress line, and `worker.reconnect` before each rejoin
  attempt — so hang/delay/error schedules are seeded and replayable
  per worker.

Losing the supervisor is NOT fatal (docs/FAULT_TOLERANCE.md "Who
watches the watcher"): a dropped tracker connection or progress socket
sends the worker into a bounded-backoff **reconnect loop** — it
re-resolves the run from the registry (a restarted supervisor
incarnation re-registers the same run name with its new tracker and
progress addresses), reconnects both planes, and re-announces its
identity plus the last `Job.seq` it completed, so a restarted
supervisor re-adopts it WARM (its network and CUDA context survive). Any
in-flight job at crash time is abandoned un-published — the restarted
supervisor's journal+checkpoint cursor re-dispatches it, so no example
is lost or double-trained. Only after `reconnect_grace` seconds with no
supervisor returning does the worker exit cleanly.

Exit contract: clean exit when the master finishes (`is_done`), when
the run disappears from the registry, or when the reconnect grace
window expires with no supervisor; non-zero on a `worker.spawn` chaos
error or any bootstrap failure, which the supervisor turns into
eviction + respawn/backoff.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import socket
import threading
import time
from typing import Optional

from deeplearning4j_tpu_torch.scaleout.launcher import (PERFORMER_CLASS,
                                                  PERFORMER_CONF,
                                                  TRACKER_ADDRESS,
                                                  WORK_DIR,
                                                  _resolve_performer)
from deeplearning4j_tpu_torch.scaleout.registry import ConfigRegistry
from deeplearning4j_tpu_torch.scaleout.rpc import RemoteStateTracker
from deeplearning4j_tpu_torch.scaleout.runtime import perform_job
from deeplearning4j_tpu_torch.testing import chaos
from deeplearning4j_tpu_torch.utils import procs

log = logging.getLogger(__name__)


class _ProgressReporter:
    """Streams progress lines to the supervisor from its own thread —
    so a hung train step (chaos `worker.step` hang, a wedged device)
    keeps reporting idle beats while the performed-count stalls, which
    is exactly the hung-but-heartbeating shape the supervisor's
    watermark evicts.

    The hello line carries the worker's (pid, start_time) fingerprint
    and its cumulative (performed, last_seq) — a restarted supervisor
    incarnation uses the fingerprint to verify/adopt the process and
    the counters to reconstruct per-worker progress state."""

    def __init__(self, address: str, worker_id: str,
                 interval: float = 0.25, performed: int = 0,
                 last_seq: Optional[int] = None):
        host, port = address.rsplit(":", 1)
        self.worker_id = worker_id
        self.interval = float(interval)
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=10.0)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        self.performed = int(performed)
        self.last_job_s = None  # float | None
        self.last_seq = last_seq
        self._dirty = threading.Event()
        self._closed = threading.Event()
        #: the (pid, start_time) fingerprint rides EVERY line, not just
        #: the hello: a supervisor that dropped the hello (mid-init,
        #: restarting) must be able to judge adopt-or-kill from any
        #: later beat — an unfingerprinted stray could never be either
        self._fingerprint = {"pid": os.getpid(),
                             "start_time": procs.proc_start_time(
                                 os.getpid())}
        self._send(self._line())  # hello names + fingerprints the peer
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"progress-{worker_id}")
        self._thread.start()

    def _send(self, payload: dict) -> None:
        data = (json.dumps(payload) + "\n").encode()
        with self._lock:
            self._sock.sendall(data)

    def _line(self) -> dict:
        out = {"worker_id": self.worker_id, "performed": self.performed,
               **self._fingerprint}
        if self.last_job_s is not None:
            out["job_s"] = self.last_job_s
        if self.last_seq is not None:
            out["last_seq"] = int(self.last_seq)
        return out

    def _run(self) -> None:
        while not self._closed.is_set():
            self._dirty.wait(timeout=self.interval)
            self._dirty.clear()
            if self._closed.is_set():
                return
            try:
                chaos.hit("worker.heartbeat")
                self._send(self._line())
            except chaos.ChaosError:
                # injected reporter death: progress lines stop but the
                # socket stays OPEN — the hung-but-heartbeating shape
                return
            except OSError:
                # supervisor gone or connection severed: training
                # continues; liveness is the supervisor's call now
                return

    def report_job(self, job_s: float,
                   seq: Optional[int] = None) -> None:
        self.performed += 1
        self.last_job_s = float(job_s)
        if seq is not None:
            self.last_seq = int(seq)
        self._dirty.set()  # wake the reporter for an immediate line

    def close(self) -> None:
        self._closed.set()
        self._dirty.set()
        try:
            self._sock.close()
        except OSError:
            pass


class _Session:
    """One connected stint against one supervisor incarnation: the
    tracker RPC plus the progress reporter, torn down together."""

    def __init__(self, conf: dict, worker_id: str, performed: int,
                 last_seq: Optional[int]):
        self.tracker = RemoteStateTracker(conf[TRACKER_ADDRESS])
        self.reporter = None
        try:
            if conf.get("progress_address"):
                self.reporter = _ProgressReporter(
                    conf["progress_address"], worker_id,
                    performed=performed, last_seq=last_seq)
            # the first RPC doubles as the connectivity probe — and
            # (re-)registers us with whichever incarnation answered
            self.tracker.add_worker(worker_id)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        if self.reporter is not None:
            self.reporter.close()
            self.reporter = None
        try:
            self.tracker.close()
        except Exception:
            pass


def run_supervised_worker(*, registry_root: str, run_name: str,
                          worker_id: str,
                          heartbeat_interval: float = 0.05,
                          registration_timeout: float = 30.0,
                          reconnect_grace: float = 30.0,
                          reconnect_backoff: float = 0.25) -> int:
    """Join a supervised run and work until the master finishes —
    surviving the master's own death for up to `reconnect_grace`
    seconds per outage. Returns the number of jobs performed."""
    chaos.hit("worker.spawn")  # error kind = spawn crash (respawn drill)
    registry = ConfigRegistry(registry_root)
    conf = registry.retrieve_run(run_name, timeout=registration_timeout)
    performer_cls = _resolve_performer(conf[PERFORMER_CLASS])
    performer = performer_cls()
    if conf.get(PERFORMER_CONF):
        performer.setup(conf[PERFORMER_CONF])
    retriever = None
    if conf.get(WORK_DIR):
        from deeplearning4j_tpu_torch.scaleout.api import LocalWorkRetriever

        retriever = LocalWorkRetriever(conf[WORK_DIR])
    performed = 0
    last_seq: Optional[int] = None
    log.info("worker %s joined supervised run %s", worker_id, run_name)

    def work(session: _Session) -> None:
        """The job loop against one incarnation. Raises ConnectionError
        when that incarnation vanishes."""
        nonlocal performed, last_seq
        tracker = session.tracker
        if hasattr(performer, "bind_tracker"):
            performer.bind_tracker(tracker)
        while not tracker.is_done():
            if tracker.needs_replicate(worker_id):
                current = tracker.get_current()
                if current is not None:
                    performer.update(current)
                tracker.done_replicating(worker_id)
            job = tracker.job_for(worker_id)
            if job is None or job.result is not None:
                time.sleep(heartbeat_interval)
                continue
            # the chaos point runs INSIDE the timed window (via
            # before_perform): an injected delay models a slow step,
            # and the straggler stats must see it as one. The
            # execute/publish/bounded-retry contract is the ONE shared
            # implementation (runtime.perform_job); a ConnectionError
            # propagates to the reconnect loop below — the job it
            # interrupted is abandoned UN-PUBLISHED (the restarted
            # supervisor re-dispatches it from its journaled cursor,
            # so publishing it too would double-train the batch).
            t0 = time.perf_counter()
            if perform_job(tracker, worker_id, performer, job,
                           work_retriever=retriever,
                           before_perform=lambda j: chaos.hit(
                               "worker.step", worker=worker_id,
                               seq=j.seq)):
                performed += 1
                if job.seq is not None:
                    last_seq = int(job.seq)
                if session.reporter is not None:
                    session.reporter.report_job(
                        time.perf_counter() - t0, seq=job.seq)

    session: Optional[_Session] = None
    lost_at: Optional[float] = None
    backoff = reconnect_backoff
    try:
        while True:
            if session is None:
                # -------- (re)connect to whichever incarnation owns
                # the run now. The registry is the rendezvous: a
                # restarted supervisor re-registers the SAME run name
                # with fresh tracker/progress addresses.
                if lost_at is not None:
                    if (time.monotonic() - lost_at) >= reconnect_grace:
                        log.info(
                            "worker %s: no supervisor within %.1fs "
                            "grace, exiting cleanly", worker_id,
                            reconnect_grace)
                        break
                    try:
                        chaos.hit("worker.reconnect", worker=worker_id)
                    except chaos.ChaosError:
                        log.warning("worker %s: injected reconnect "
                                    "failure, exiting", worker_id)
                        break
                try:
                    conf = registry.retrieve_run(run_name)
                    session = _Session(conf, worker_id, performed,
                                       last_seq)
                except (KeyError, ConnectionError, OSError) as e:
                    # run not (re-)registered yet, or a stale config
                    # naming a dead incarnation: back off and retry
                    # within the grace window
                    if lost_at is None:
                        lost_at = time.monotonic()
                    log.debug("worker %s: reconnect attempt failed "
                              "(%s)", worker_id, e)
                    time.sleep(min(backoff, 2.0))
                    backoff = min(backoff * 2.0, 2.0)
                    continue
                if lost_at is not None:
                    log.info("worker %s: rejoined run %s after %.1fs "
                             "(performed=%d, last_seq=%s)", worker_id,
                             run_name, time.monotonic() - lost_at,
                             performed, last_seq)
                lost_at = None
                backoff = reconnect_backoff
            try:
                work(session)
                break  # is_done: the run finished — clean exit
            except ConnectionError as e:
                # master gone: NOT a shutdown anymore — enter the
                # bounded reconnect loop and survive a restart
                log.info("worker %s: master connection lost (%s); "
                         "reconnecting for up to %.1fs", worker_id, e,
                         reconnect_grace)
                session.close()
                session = None
                lost_at = time.monotonic()
                time.sleep(min(backoff, 2.0))
    finally:
        if session is not None:
            session.close()
    return performed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.scaleout.worker",
        description="Supervised elastic-training worker process "
                    "(spawned by scaleout.supervisor.TrainingSupervisor)")
    p.add_argument("--registry", required=True,
                   help="ConfigRegistry root directory")
    p.add_argument("--run", required=True, help="run name to join")
    p.add_argument("--worker-id", required=True)
    p.add_argument("--heartbeat-interval", type=float, default=0.05)
    p.add_argument("--registration-timeout", type=float, default=30.0)
    p.add_argument("--reconnect-grace", type=float, default=30.0,
                   help="seconds to outlive a vanished supervisor: "
                        "retry the registry/tracker with backoff and "
                        "re-announce, then exit cleanly if no "
                        "incarnation returns")
    p.add_argument("--reconnect-backoff", type=float, default=0.25,
                   help="initial reconnect backoff (doubles, capped)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    performed = run_supervised_worker(
        registry_root=args.registry, run_name=args.run,
        worker_id=args.worker_id,
        heartbeat_interval=args.heartbeat_interval,
        registration_timeout=args.registration_timeout,
        reconnect_grace=args.reconnect_grace,
        reconnect_backoff=args.reconnect_backoff)
    log.info("worker %s done: %d jobs", args.worker_id, performed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
