"""Dynamic micro-batcher: coalesce concurrent requests into one batch.

Single-row requests waste a parallel chip; the batcher sits in front of
an engine (or replica set) and merges whatever arrives within a
`max_delay_ms` window — up to `max_batch_size` rows — into ONE forward,
then scatters the output rows back to per-request futures.

Scope: this is the **forward** (`/predict`) path only. Generate traffic
does NOT coalesce here — a decode is thousands of steps, so batching
whole requests would couple their lifetimes (one slow request holds the
batch). `/generate` routes to the slot scheduler instead
(serving/decode_loop.py), which batches at TOKEN granularity: requests
join and leave the shared compiled decode step between steps, which is
why `server.py` hands generate requests to `DecodeLoop.submit` rather
than `MicroBatcher.submit`.

Contract:

- `submit(x)` is thread-safe and returns a `concurrent.futures.Future`
  whose result has the same leading dim as `x` (a 1-D request is
  treated as one row and resolves to a (1, ...) result). Rows map back
  in submit order — coalescing never reorders or mixes rows between
  requests.
- **Per-request error isolation**: a request whose feature shape
  disagrees with its batch-mates fails alone (its future gets the
  ValueError); the rest of the batch still runs. A failure of the
  engine call itself fails only the futures in that batch — the worker
  survives and keeps serving subsequent batches.
- A request that would overflow `max_batch_size` is held for the next
  batch (never split across two forwards), so one future always maps to
  one contiguous row range of one engine call.
- **Admission backpressure**: with `max_queue=N`, a submit that finds N
  requests already waiting raises `OverloadedError` (503 + Retry-After
  on the HTTP surface, docs/FLEET.md) instead of queueing unboundedly —
  shedding at the door beats timing out after the queue.
- **SLO tiers** (`submit(x, tier=)`, docs/SERVING.md "Priority
  tiers"): the coalescing queue is shared (one engine pass serves every
  tier), so tiers bite at ADMISSION — batch sheds first, at the lower
  `batch_max_queue` water mark (default half of `max_queue`) — and the
  shed reply carries the shed tier plus a Retry-After derived from the
  queue depth it actually saw, not a global constant.
- **Deadlines** (docs/SERVING.md "Deadlines"): `submit(x, deadline=)`
  raises `DeadlineExceededError` for an already-expired budget, and the
  worker re-checks at DISPATCH — a request whose budget died while it
  queued fails without ever touching the engine (no compute is spent on
  an answer nobody is waiting for). Pinned by the engine's
  program-cache and the batcher's batch counters in tests.
- **Cancellation**: a future the client abandoned (`fut.cancel()` after
  a result timeout or disconnect) is dropped at dispatch — the standard
  `set_running_or_notify_cancel()` handshake — and counted in
  `dl4j_batcher_cancelled`.
- `close()` stops accepting submits, flushes everything already queued,
  and joins the worker. Also usable as a context manager.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, NamedTuple, Optional

import numpy as np

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.serving.errors import (TIER_BATCH,
                                               TIER_INTERACTIVE, TIERS,
                                               Deadline,
                                               DeadlineExceededError,
                                               OverloadedError,
                                               backlog_retry_ms)

__all__ = ["MicroBatcher"]

_CLOSE = object()
_batcher_seq = itertools.count()


class _Request(NamedTuple):
    x: np.ndarray
    future: Future
    deadline: Optional[Deadline] = None
    tier: str = TIER_INTERACTIVE


def _resolve(fut: Future, value=None, exc: Optional[BaseException] = None
             ) -> None:
    """set_result/set_exception tolerating a caller-cancelled future —
    a client giving up (fut.cancel() after a result timeout) must never
    kill the worker thread."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
    except Exception:  # InvalidStateError: cancelled/already done
        pass


class MicroBatcher:
    def __init__(self, run_batch: Callable[[np.ndarray], np.ndarray], *,
                 max_batch_size: int = 64, max_delay_ms: float = 2.0,
                 max_queue: Optional[int] = None,
                 batch_max_queue: Optional[int] = None,
                 name: str = "micro-batcher"):
        if max_batch_size < 1:
            raise ValueError(
                f"max_batch_size must be >= 1, got {max_batch_size}")
        if max_delay_ms < 0:
            raise ValueError(
                f"max_delay_ms must be >= 0, got {max_delay_ms}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if batch_max_queue is not None and batch_max_queue < 1:
            raise ValueError(
                f"batch_max_queue must be >= 1, got {batch_max_queue}")
        self._run = run_batch
        self.max_batch_size = int(max_batch_size)
        self.max_delay_s = max_delay_ms / 1000.0
        self.max_queue = None if max_queue is None else int(max_queue)
        # the bulk lane's lower water mark on the SHARED queue: batch
        # sheds first, keeping headroom for interactive arrivals
        if batch_max_queue is not None:
            self.batch_max_queue: Optional[int] = int(batch_max_queue)
        elif self.max_queue is not None:
            self.batch_max_queue = max(1, self.max_queue // 2)
        else:
            self.batch_max_queue = None
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        # counters live in the telemetry registry (labeled per batcher)
        # so /metrics and snapshot() read the same series — no parallel
        # stat mechanism (docs/OBSERVABILITY.md)
        reg = telemetry.get_registry()
        self.label = f"{name}-{next(_batcher_seq)}"
        lab = {"batcher": self.label}
        self._m_submitted = reg.counter(
            "dl4j_batcher_submitted", "requests submitted").labels(**lab)
        self._m_completed = reg.counter(
            "dl4j_batcher_completed", "requests completed").labels(**lab)
        self._m_failed = reg.counter(
            "dl4j_batcher_failed", "requests failed").labels(**lab)
        self._m_batches = reg.counter(
            "dl4j_batcher_batches", "coalesced engine forwards").labels(**lab)
        self._m_rows = reg.counter(
            "dl4j_batcher_rows", "rows shipped in coalesced batches"
        ).labels(**lab)
        self._m_shed = reg.counter(
            "dl4j_batcher_shed",
            "requests rejected at submit because the coalescing queue "
            "was at max_queue").labels(**lab)
        self._m_deadline = reg.counter(
            "dl4j_batcher_deadline_exceeded",
            "requests shed (at submit or at dispatch) because their "
            "deadline budget was already spent").labels(**lab)
        self._m_cancelled = reg.counter(
            "dl4j_batcher_cancelled",
            "abandoned requests (client-cancelled futures) dropped at "
            "dispatch").labels(**lab)
        _tier_req = reg.counter(
            "dl4j_tier_requests",
            "generate requests submitted per SLO tier (interactive "
            "goes ahead at admission; batch rides the weighted-fair "
            "bulk lane)")
        tscope = {"scope": f"batcher:{self.label}"}
        self._m_tier_requests = {
            t: _tier_req.labels(tier=t, **tscope) for t in TIERS}
        _tier_shed = reg.counter(
            "dl4j_tier_shed",
            "generate requests shed at submit per SLO tier (batch "
            "sheds first, at its own lower batch_max_waiting bound)")
        self._m_tier_shed = {
            t: _tier_shed.labels(tier=t, **tscope) for t in TIERS}
        self._m_queue = reg.gauge(
            "dl4j_batcher_queue_depth",
            "requests waiting in the coalescing queue").labels(**lab)
        # weak: the registry outlives every batcher; a dead batcher's
        # queue gauge must read 0, not pin the queue in memory
        import weakref
        qsize = weakref.WeakMethod(self._q.qsize)
        self._m_queue.set_function(lambda: (qsize() or (lambda: 0))())
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._worker.start()

    # registry-backed counter views (historical attribute surface)
    @property
    def submitted(self) -> int:
        return int(self._m_submitted.value)

    @property
    def completed(self) -> int:
        return int(self._m_completed.value)

    @property
    def failed(self) -> int:
        return int(self._m_failed.value)

    @property
    def batches(self) -> int:
        return int(self._m_batches.value)

    @property
    def batched_rows(self) -> int:
        return int(self._m_rows.value)

    # ----------------------------------------------------------- submit
    def submit(self, x, deadline: Optional[Deadline] = None,
               tier: str = TIER_INTERACTIVE) -> Future:
        """Enqueue one request; the future resolves to the engine output
        rows for exactly these input rows. An already-expired `deadline`
        raises DeadlineExceededError here (504 on the HTTP surface) —
        and is re-checked at dispatch, so a budget that dies in the
        queue never reaches the engine either. `tier="batch"` sheds at
        the lower `batch_max_queue` water mark (bulk traffic backs off
        before it can crowd out interactive admission); coalescing
        itself is tier-blind — one engine pass serves every tier."""
        if tier not in TIERS:
            raise ValueError(
                f"unknown tier {tier!r} (expected one of {TIERS})")
        if deadline is not None and deadline.expired:
            self._m_deadline.inc()
            deadline.check("batcher admission")  # raises
        fut: Future = Future()
        arr = np.asarray(x)
        if arr.ndim == 0:
            fut.set_exception(ValueError("scalar request"))
            return fut
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.shape[0] == 0:
            fut.set_exception(ValueError("empty request"))
            return fut
        with self._lock:
            if self._closed:
                fut.set_exception(RuntimeError("batcher is closed"))
                return fut
            bound = (self.batch_max_queue if tier == TIER_BATCH
                     else self.max_queue)
            depth = self._q.qsize()
            if bound is not None and depth >= bound:
                # shed at the door: raising (not poisoning the future)
                # lets callers that route/queue-manage see the signal
                # before any work is enqueued. The backoff is derived
                # from the depth this tier actually hit — each queued
                # request costs roughly one slice of a coalescing
                # window to drain — and the reply names the shed tier.
                self._m_shed.inc()
                self._m_tier_shed[tier].inc()
                raise OverloadedError(
                    f"batcher queue full for tier {tier!r} "
                    f"({depth} waiting, bound {bound})",
                    retry_after_ms=backlog_retry_ms(
                        depth + 1,
                        max(1.0, self.max_delay_s * 2000.0
                            / self.max_batch_size)),
                    tier=tier)
            self._m_submitted.inc()
            self._m_tier_requests[tier].inc()
            # enqueue under the lock: close() also takes it before
            # putting the sentinel, so no request can land AFTER _CLOSE
            # and strand its future in a dead queue
            self._q.put(_Request(arr, fut, deadline, tier))
        return fut

    # ----------------------------------------------------------- worker
    def _coalesce(self, first: _Request):
        """Collect batch-mates for up to max_delay_s; returns
        (requests, leftover-or-sentinel)."""
        batch = [first]
        rows = first.x.shape[0]
        deadline = time.monotonic() + self.max_delay_s
        while rows < self.max_batch_size:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is _CLOSE:
                return batch, _CLOSE
            if rows + item.x.shape[0] > self.max_batch_size:
                return batch, item  # hold for the next batch, unsplit
            batch.append(item)
            rows += item.x.shape[0]
        return batch, None

    def _run_group(self, batch) -> None:
        # dispatch-time gate: drop abandoned futures (the client gave
        # up — set_running_or_notify_cancel is the std handshake) and
        # fail queue-expired deadlines WITHOUT engine work; both are
        # decided before the batch's reference shape is picked so a
        # dead request never anchors the live ones' validation
        alive = []
        for req in batch:
            if not req.future.set_running_or_notify_cancel():
                self._m_cancelled.inc()
                continue
            if req.deadline is not None and req.deadline.expired:
                self._m_deadline.inc()
                self._m_failed.inc()
                _resolve(req.future, exc=DeadlineExceededError(
                    "deadline exceeded while queued in the batcher",
                    deadline_ms=req.deadline.budget_ms,
                    elapsed_ms=req.deadline.elapsed_ms()))
                continue
            alive.append(req)
        if not alive:
            return
        batch = alive
        # per-request validation against the batch's first request: a
        # mismatched request fails alone, the rest still run
        tail = batch[0].x.shape[1:]
        good, offsets, rows = [], [], 0
        for req in batch:
            if req.x.shape[1:] != tail:
                _resolve(req.future, exc=ValueError(
                    f"request feature shape {req.x.shape[1:]} does not "
                    f"match batch feature shape {tail}"))
                self._m_failed.inc()
                continue
            good.append(req)
            offsets.append(rows)
            rows += req.x.shape[0]
        if not good:
            return
        features = (good[0].x if len(good) == 1
                    else np.concatenate([r.x for r in good]))
        try:
            out = np.asarray(self._run(features))
        except Exception as e:
            # batch-level failure: poison only THIS batch's futures
            for req in good:
                _resolve(req.future, exc=e)
            self._m_failed.inc(len(good))
            return
        self._m_batches.inc()
        self._m_rows.inc(rows)
        self._m_completed.inc(len(good))
        for req, off in zip(good, offsets):
            _resolve(req.future, out[off:off + req.x.shape[0]])

    def _loop(self) -> None:
        pending: Optional[_Request] = None
        while True:
            if pending is not None:
                first, pending = pending, None
            else:
                first = self._q.get()
            if first is _CLOSE:
                return
            batch, leftover = self._coalesce(first)
            self._run_group(batch)
            if leftover is _CLOSE:
                return
            pending = leftover

    # -------------------------------------------------------- lifecycle
    def close(self, timeout: float = 10.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            # sentinel goes in under the same lock submit holds, so it
            # is strictly LAST: everything submitted before it flushes
            self._q.put(_CLOSE)
        self._worker.join(timeout=timeout)

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ stats
    def snapshot(self) -> dict:
        batches, rows = self.batches, self.batched_rows
        per_batch = (rows / batches) if batches else 0.0
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "batches": batches,
            "mean_rows_per_batch": round(per_batch, 2),
            "occupancy": round(per_batch / self.max_batch_size, 4),
            "shed": int(self._m_shed.value),
            "deadline_exceeded": int(self._m_deadline.value),
            "cancelled": int(self._m_cancelled.value),
            "queue_depth": self._q.qsize(),
            "max_batch_size": self.max_batch_size,
            "max_queue": self.max_queue,
            "batch_max_queue": self.batch_max_queue,
            "max_delay_ms": self.max_delay_s * 1000.0,
            "tiers": {
                "requests": {t: int(self._m_tier_requests[t].value)
                             for t in TIERS},
                "shed": {t: int(self._m_tier_shed[t].value)
                         for t in TIERS},
            },
        }
