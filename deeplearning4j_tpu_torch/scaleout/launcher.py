"""Multi-process launcher: master / worker roles in separate processes,
the counterpart of the JAX package's `scaleout/launcher.py`.

Parity: reference `DeepLearning4jDistributedApp` (akka …/actor/runner/ —
main() with role "master" or "worker"), `DeepLearning4jDistributed.setup`
(master boots router/tracker/actors, :239; worker connects and heartbeats,
:322-345), with ZooKeeper supplying the startup Configuration
(ZooKeeperConfigurationRegister.java:100) and the performer class wired by
name through the config (WorkerPerformerFactory.WORKER_PERFORMER key).

Design: the master process owns the InMemoryStateTracker and
serves it over `rpc.StateTrackerServer`; its run configuration (tracker
endpoint + performer class + performer conf) is published through
`registry.ConfigRegistry` on a shared filesystem. Worker processes
resolve the run by name, connect a `RemoteStateTracker`, build their
performer reflectively (restricted to this package) and run the same
worker loop the in-process runtime uses. Device-level collectives are
orthogonal: across hosts each worker process additionally joins a
`torch.distributed` job through `parallel/multihost.initialize` (the JAX
launcher's flags, kept so its argv parses: --jax-coordinator /
--num-processes / --process-id) so in-worker training can shard over
the job's devices while THIS layer stays pure control plane.

A run config written for the JAX package names a `deeplearning4j_tpu.*`
performer. It is refused with the port's counterpart named, and never
imported: that would import JAX into a port worker.
"""

from __future__ import annotations

import argparse
import importlib
import logging
import time
from typing import Any, Dict, Optional

import numpy as np

from deeplearning4j_tpu_torch.scaleout.registry import ConfigRegistry
from deeplearning4j_tpu_torch.scaleout.rpc import (RemoteStateTracker,
                                             StateTrackerServer)
from deeplearning4j_tpu_torch.scaleout.runtime import DistributedRuntime, _Worker
from deeplearning4j_tpu_torch.scaleout.statetracker import InMemoryStateTracker

log = logging.getLogger(__name__)

#: config keys (reference WorkerPerformerFactory.WORKER_PERFORMER et al.)
PERFORMER_CLASS = "performer_class"
PERFORMER_CONF = "performer_conf"
TRACKER_ADDRESS = "tracker_address"
WORK_DIR = "work_dir"  # shared WorkRetriever directory (optional)


def _resolve_performer(class_path: str):
    """Import a performer class by dotted name, restricted to this package
    (the config file is data, not code — don't let it import arbitrary
    modules)."""
    if class_path.startswith("deeplearning4j_tpu."):
        raise ValueError(
            f"performer_class {class_path!r} names the JAX package, which "
            f"a port worker never imports; use its counterpart "
            f"{'deeplearning4j_tpu_torch.' + class_path.split('.', 1)[1]!r}")
    if not class_path.startswith("deeplearning4j_tpu_torch."):
        raise ValueError(
            f"performer_class must live under deeplearning4j_tpu_torch.*, "
            f"got {class_path!r}")
    module_name, _, cls_name = class_path.rpartition(".")
    module = importlib.import_module(module_name)
    return getattr(module, cls_name)


class MultiProcessMaster(DistributedRuntime):
    """DistributedRuntime whose workers live in OTHER processes: serves the
    tracker over TCP, publishes the run config, and runs the same
    dispatch/aggregate loop against remotely-registered workers."""

    def __init__(self, job_iterator, *, run_name: str,
                 registry: ConfigRegistry,
                 performer_class: str,
                 performer_conf: Optional[Dict[str, Any]] = None,
                 n_workers: int = 2,
                 host: str = "127.0.0.1", port: int = 0,
                 conf_json: Optional[str] = None,
                 work_dir: Optional[str] = None,
                 status_port: Optional[int] = None,
                 status_extra=None, status_health=None,
                 **kw):
        if work_dir is not None:
            from deeplearning4j_tpu_torch.scaleout.api import LocalWorkRetriever
            kw.setdefault("work_retriever", LocalWorkRetriever(work_dir))
        super().__init__(job_iterator, performer_factory=None,
                         n_workers=n_workers, **kw)
        self.conf_json = conf_json
        self.run_name = run_name
        self.registry = registry
        self.server = StateTrackerServer(self.tracker, host=host, port=port)
        self.server.start()
        # live status endpoint (reference: Dropwizard UI embedded in the
        # Hazelcast tracker, BaseHazelCastStateTracker.java:181-189).
        # status_port=0 picks an ephemeral port; None disables.
        self.status_server = None
        if status_port is not None:
            from deeplearning4j_tpu_torch.scaleout.status import StatusServer
            self.status_server = StatusServer(
                self.tracker, runtime=self, host=host,
                port=status_port, extra=status_extra,
                health=status_health).start()
        run_conf = {
            TRACKER_ADDRESS: self.server.address,
            PERFORMER_CLASS: performer_class,
            PERFORMER_CONF: performer_conf or {},
            "n_workers": n_workers,
        }
        if self.status_server is not None:
            run_conf["status_address"] = self.status_server.address
        if work_dir is not None:
            run_conf[WORK_DIR] = work_dir
        registry.register_run(run_name, run_conf)

    def start_workers(self):  # workers are separate processes
        pass

    def run(self, timeout: float = 120.0) -> np.ndarray:
        try:
            return super().run(timeout=timeout)
        finally:
            self.server.stop()
            if self.status_server is not None:
                self.status_server.stop()
            self.registry.unregister_run(self.run_name)


def run_worker(*, registry_root: str, run_name: str, worker_id: str,
               heartbeat_interval: float = 0.01,
               registration_timeout: float = 30.0) -> int:
    """Worker-process entry: resolve the run, connect, work until the
    master finishes. Returns the number of jobs performed."""
    registry = ConfigRegistry(registry_root)
    conf = registry.retrieve_run(run_name, timeout=registration_timeout)
    tracker = RemoteStateTracker(conf[TRACKER_ADDRESS])
    performer_cls = _resolve_performer(conf[PERFORMER_CLASS])
    performer = performer_cls()
    if conf.get(PERFORMER_CONF):
        performer.setup(conf[PERFORMER_CONF])
    retriever = None
    if conf.get(WORK_DIR):
        from deeplearning4j_tpu_torch.scaleout.api import LocalWorkRetriever
        retriever = LocalWorkRetriever(conf[WORK_DIR])
    worker = _Worker(worker_id, tracker, performer,
                     interval=heartbeat_interval,
                     work_retriever=retriever)
    log.info("worker %s joined run %s at %s", worker_id, run_name,
             conf[TRACKER_ADDRESS])
    try:
        worker.run()  # blocks until tracker.is_done()
    except ConnectionError as e:
        # master gone = shutdown signal for a remote worker. Server-side
        # tracker failures surface as RuntimeError and must NOT be
        # swallowed as a clean exit — let them propagate to a nonzero
        # process exit so the launcher/test harness sees the failure.
        log.info("worker %s: master connection lost (%s), exiting", worker_id,
                 e)
    finally:
        tracker.close()
    return worker.performed


def _maybe_init_distributed(args) -> None:
    """--jax-coordinator (the JAX launcher's flag name) joins this worker
    to a torch.distributed job through `parallel/multihost.initialize`."""
    if args.jax_coordinator:
        from deeplearning4j_tpu_torch.parallel import multihost
        multihost.initialize(args.jax_coordinator,
                             num_processes=args.num_processes,
                             process_id=args.process_id)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.scaleout.launcher",
        description="Launch a distributed-training worker process")
    p.add_argument("role", choices=["worker"],
                   help="master runs embedded in the training program via "
                        "MultiProcessMaster; only workers launch from the "
                        "CLI")
    p.add_argument("--registry", required=True,
                   help="ConfigRegistry root directory (shared filesystem)")
    p.add_argument("--run", required=True, help="run name to join")
    p.add_argument("--worker-id", required=True)
    p.add_argument("--heartbeat-interval", type=float, default=0.01)
    p.add_argument("--registration-timeout", type=float, default=30.0,
                   help="seconds to wait for the run to appear in the "
                        "registry (raise for later-phase runs, e.g. the "
                        "train phase behind a distributed vocab build)")
    p.add_argument("--jax-coordinator", default=None,
                   help="host:port of the torch.distributed job's "
                        "coordinator (process 0), joined through "
                        "parallel/multihost.initialize (multi-host "
                        "runs; the JAX launcher's flag name)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    _maybe_init_distributed(args)
    performed = run_worker(registry_root=args.registry, run_name=args.run,
                           worker_id=args.worker_id,
                           heartbeat_interval=args.heartbeat_interval,
                           registration_timeout=args.registration_timeout)
    log.info("worker %s done: %d jobs", args.worker_id, performed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
