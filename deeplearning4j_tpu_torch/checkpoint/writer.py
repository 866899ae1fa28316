"""Async checkpoint writer: snapshot on the caller, serialize + IO off
it; the counterpart of the JAX package's `checkpoint/writer.py`.

The step loop's only cost is `snapshot_tree`. For a tensor on a CUDA
device the snapshot is a `non_blocking` copy into pinned host memory on
the current stream, followed by one CUDA event; the fit thread does not
wait for it. The writer thread waits on that event before it reads a
byte, and the training steps that follow are ordered after the copies
because they run on the same stream (their in-place updates cannot
overtake the copy). A CPU tensor is copied whole at once. So the live
parameters may keep changing while a single background worker
serializes the snapshot into the sharded directory format and commits
it.

The pinned buffers are the writer's own and are reused: a save takes
them from a pool keyed by (shape, dtype) and the writer thread gives
them back once the checkpoint is written, so only the first saves pay
for allocating pinned memory (milliseconds a large leaf).

In-flight saves are BOUNDED: at most `max_in_flight` saves wait behind
the one being written. A save beyond that blocks BEFORE it takes its
snapshot until the worker frees a slot (backpressure rather than
unbounded host memory when the checkpoint cadence outruns the disk).
Rotation (`keep`) removes old committed steps and any uncommitted crash
leftovers after every commit. A worker failure is re-raised from the
next `save()` / `flush()` / `close()`.

Each save's record (`stats()["history"]`) holds what the fit thread
paid, `wait_s` (blocked for a slot) and `snapshot_s` (the copies
enqueued, of which `alloc_s` went to new pinned buffers), and what the
writer thread paid, `write_s` (the event wait included), with the most
saves ever in flight.

Telemetry, the JAX package's series: `dl4j_ckpt_saves`,
`dl4j_ckpt_bytes_written`, `dl4j_ckpt_errors`,
`dl4j_ckpt_snapshot_seconds` (the fit thread's snapshot),
`dl4j_ckpt_write_seconds` (the writer thread's serialize + IO), the
`dl4j_ckpt_in_flight` and `dl4j_ckpt_last_committed_step` gauges, and
the spans `ckpt_snapshot` (fit thread) and `ckpt_write` (writer thread).
The fit thread opens the snapshot span (a no-op while tracing is off)
and raises the in-flight gauge; every other series is updated from the
writer thread.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.checkpoint import format as ckfmt
from deeplearning4j_tpu_torch.telemetry.trace import span

__all__ = ["snapshot_tree", "mesh_spec_of", "AsyncCheckpointWriter"]


_M_SAVES = telemetry.counter(
    "dl4j_ckpt_saves", "sharded checkpoint saves committed")
_M_BYTES = telemetry.counter(
    "dl4j_ckpt_bytes_written", "checkpoint shard bytes written")
_M_ERRORS = telemetry.counter(
    "dl4j_ckpt_errors", "checkpoint saves that failed")
_M_SNAP_S = telemetry.histogram(
    "dl4j_ckpt_snapshot_seconds",
    "device->host snapshot duration (the synchronous step-loop stall)")
_M_WRITE_S = telemetry.histogram(
    "dl4j_ckpt_write_seconds",
    "background serialize+IO duration per checkpoint")
_M_IN_FLIGHT = telemetry.gauge(
    "dl4j_ckpt_in_flight", "checkpoint saves snapshot-taken but not yet "
    "committed")
_M_LAST_STEP = telemetry.gauge(
    "dl4j_ckpt_last_committed_step", "newest committed checkpoint step")


class _PinnedPool:
    """Pinned host buffers kept for reuse, keyed by (shape, dtype)."""

    def __init__(self):
        self._free: Dict[tuple, List[torch.Tensor]] = {}
        self._lock = threading.Lock()

    def take(self, shape, dtype) -> Optional[torch.Tensor]:
        with self._lock:
            free = self._free.get((tuple(shape), dtype))
            if free:
                return free.pop()
        return None

    def give(self, buffers: List[torch.Tensor]) -> None:
        with self._lock:
            for b in buffers:
                self._free.setdefault((tuple(b.shape), b.dtype), []).append(b)


class _Copies:
    """One snapshot's bookkeeping: the CUDA device its copies run on, the
    pinned buffers it holds, and the seconds spent allocating new ones."""

    def __init__(self, pool: Optional[_PinnedPool] = None):
        self.pool = pool
        self.device = None
        self.buffers: List[torch.Tensor] = []
        self.alloc_s = 0.0

    def pinned(self, t: torch.Tensor) -> torch.Tensor:
        if self.device is None:
            self.device = t.device
        host = self.pool.take(t.shape, t.dtype) if self.pool else None
        if host is None:
            t0 = time.perf_counter()
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.alloc_s += time.perf_counter() - t0
        self.buffers.append(host)
        return host


def _snapshot_tensor(t: torch.Tensor, copies: _Copies):
    """One tensor to the host: a numpy array, or a HostLeaf of raw bits
    for a dtype numpy cannot name (bfloat16). A CUDA tensor's copy is
    enqueued into pinned memory and may still be in flight."""
    t = t.detach()
    if t.device.type == "cuda":
        host = copies.pinned(t)
        host.copy_(t, non_blocking=True)
    else:
        host = t.clone()  # an owned copy: the live tensor keeps changing
    name, data = ckfmt._dtype_name(t.dtype), ckfmt.host_bits(host)
    if name not in ckfmt._RAW:
        return data
    full = tuple((None, None) for _ in data.shape)
    return ckfmt.HostLeaf(name, tuple(data.shape),
                          [ckfmt.HostShard(full, data)])


def _snapshot(payload, copies: _Copies):
    """The host tree (a checkpoint's tensors share one device and
    stream)."""
    if isinstance(payload, torch.Tensor):
        return _snapshot_tensor(payload, copies)
    if isinstance(payload, np.ndarray):
        return payload.copy()
    if isinstance(payload, np.generic):
        return np.asarray(payload)
    if hasattr(payload, "_fields"):  # NamedTuple
        return type(payload)(*(_snapshot(v, copies) for v in payload))
    if isinstance(payload, dict):
        return {k: _snapshot(v, copies) for k, v in payload.items()}
    if isinstance(payload, (list, tuple)):
        return type(payload)(_snapshot(v, copies) for v in payload)
    return payload  # scalars, HostLeafs; the codec raises on the rest


def _snapshot_async(payload, pool: Optional[_PinnedPool] = None):
    """(host tree, CUDA event or None, copies): the event completes when
    every device-to-host copy of the tree has landed."""
    copies = _Copies(pool)
    host = _snapshot(payload, copies)
    if copies.device is None:
        return host, None, copies
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(copies.device))
    return host, event, copies


def snapshot_tree(payload):
    """Device-to-host snapshot of a checkpoint payload tree (dicts,
    tuples, lists, NamedTuples; scalars pass through; tensors become
    numpy arrays, or HostLeafs of raw bits for bfloat16). Returns once
    every copy has landed."""
    host, event, _ = _snapshot_async(payload)
    if event is not None:
        event.synchronize()
    return host


def mesh_spec_of(mesh=None, strategy: Optional[str] = None
                 ) -> Optional[dict]:
    """JSON-able record of the SOURCE topology, informational only:
    restore never needs it. `mesh` is any object with `axis_names` and a
    `devices` array (the JAX package's Mesh); the port's own trainers
    run on one device, so it is usually None."""
    spec: Dict[str, Any] = {}
    if mesh is not None:
        spec["axes"] = {name: int(size)
                        for name, size in zip(mesh.axis_names,
                                              mesh.devices.shape)}
        spec["n_devices"] = int(np.prod(mesh.devices.shape))
    if strategy:
        spec["strategy"] = strategy
    return spec or None


class AsyncCheckpointWriter:
    """Background sharded-checkpoint writer for one checkpoint root.

    `save()` = a slot (bounded), the snapshot, an enqueue; a single
    daemon worker waits for the snapshot's copies, serializes, commits (marker rename),
    rotates old steps, and resolves the returned Future with the
    committed directory. A worker failure is (a) set on that save's
    Future and (b) re-raised from the NEXT save()/flush()/close() call,
    so a fit loop cannot silently train past a dead checkpoint stream.
    """

    def __init__(self, root: str, *, keep: int = 3, max_in_flight: int = 2):
        if max_in_flight < 1:
            raise ValueError(
                f"max_in_flight must be >= 1, got {max_in_flight}")
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.root = root
        self.keep = keep
        self.max_in_flight = max_in_flight
        os.makedirs(root, exist_ok=True)
        self._queue: "queue.Queue" = queue.Queue()  # bounded by the slots
        self._pool = _PinnedPool()
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._pending = 0  # slot taken, commit not yet resolved
        self._cond = threading.Condition()
        self._closed = False
        self._auto_step = None  # next auto step when save(step=None)
        #: per save: {"step", "wait_s", "snapshot_s", "alloc_s",
        #: "write_s", "bytes"}
        self.history: List[dict] = []
        self.max_in_flight_seen = 0
        #: test hook: called with each filename before it is written
        #: (crash-mid-save drills raise from it)
        self.between_files: Optional[Callable[[str], None]] = None
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="ckpt-writer")
        self._worker.start()

    # ------------------------------------------------------------------ api
    def save(self, payload, *, step: Optional[int] = None,
             mesh_spec: Optional[dict] = None,
             wait: bool = False) -> str:
        """Snapshot `payload` and schedule its write; returns the step
        directory the checkpoint will commit to. Blocks for a slot when
        `max_in_flight` saves already wait behind the one being written
        (backpressure), then for the snapshot's enqueue. `wait=True`
        blocks until the commit is durable: the preemption flush, where
        the process is about to die."""
        self._reraise()
        if self._closed:
            raise RuntimeError("AsyncCheckpointWriter is closed")
        if step is None:
            step = self._next_auto_step()
        t0 = time.perf_counter()
        with self._cond:
            self._cond.wait_for(
                lambda: self._pending <= self.max_in_flight)
            self._pending += 1
            self.max_in_flight_seen = max(self.max_in_flight_seen,
                                          self._pending)
        t1 = time.perf_counter()
        try:
            with span("ckpt_snapshot", step=int(step)):
                host, event, copies = _snapshot_async(payload, self._pool)
        except BaseException:
            with self._cond:
                self._pending -= 1
                self._cond.notify_all()
            raise
        record = {"step": int(step), "wait_s": t1 - t0,
                  "snapshot_s": time.perf_counter() - t1,
                  "alloc_s": copies.alloc_s}
        fut: Future = Future()
        _M_IN_FLIGHT.inc()
        self._queue.put((int(step), host, event, copies.buffers, mesh_spec,
                         fut, record))
        if wait:
            return fut.result()
        return os.path.join(self.root, ckfmt.step_dir_name(step))

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every enqueued save is committed (or failed)."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._pending == 0,
                                       timeout=timeout):
                raise TimeoutError(
                    f"checkpoint flush timed out after {timeout}s with "
                    f"{self._pending} saves pending")
        self._reraise()

    def close(self, timeout: Optional[float] = None) -> None:
        if self._closed:
            return
        self.flush(timeout)
        self._closed = True
        self._queue.put(None)  # wake + stop the worker
        self._worker.join(timeout=5.0)

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def in_flight(self) -> int:
        return self._pending

    def latest_step(self) -> Optional[int]:
        return ckfmt.latest_step(self.root)

    def stats(self) -> dict:
        """Saves committed, bytes of the last, the largest in-flight
        count, and each save's record (wait / snapshot / alloc / write
        seconds, bytes)."""
        return {"saves": len(self.history),
                "bytes_last": (self.history[-1]["bytes"]
                               if self.history else 0),
                "max_in_flight": self.max_in_flight_seen,
                "history": list(self.history)}

    # ------------------------------------------------------------- internals
    def _next_auto_step(self) -> int:
        if self._auto_step is None:
            latest = ckfmt.latest_step(self.root)
            self._auto_step = 0 if latest is None else latest + 1
        step = self._auto_step
        self._auto_step += 1
        return step

    def _reraise(self) -> None:
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(
                f"background checkpoint write failed: {err}") from err

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            step, host, event, buffers, mesh_spec, fut, record = item
            t0 = time.perf_counter()
            _M_SNAP_S.observe(record["snapshot_s"])
            try:
                with span("ckpt_write", step=step):
                    if event is not None:
                        event.synchronize()  # the snapshot's copies landed
                    path = ckfmt.write_checkpoint(
                        self.root, step, host, mesh_spec=mesh_spec,
                        between_files=self.between_files)
                manifest = ckfmt.read_manifest(self.root, step)
                record["bytes"] = manifest.get("total_bytes", 0)
                _M_BYTES.inc(record["bytes"])
                _M_SAVES.inc()
                _M_LAST_STEP.set(step)
                ckfmt.prune(self.root, self.keep, protect=(step,))
                record["write_s"] = time.perf_counter() - t0
                self.history.append(record)
                fut.set_result(path)
            except BaseException as e:  # noqa: BLE001 — relay, don't die
                _M_ERRORS.inc()
                with self._error_lock:
                    self._error = e
                fut.set_exception(e)
            finally:
                _M_IN_FLIGHT.dec()
                _M_WRITE_S.observe(time.perf_counter() - t0)
                if event is None or event.query():
                    self._pool.give(buffers)  # nothing reads them now
                with self._cond:
                    self._pending -= 1
                    self._cond.notify_all()
