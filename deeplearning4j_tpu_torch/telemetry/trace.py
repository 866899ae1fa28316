"""Span-based step tracing with Chrome-trace export and an xprof bridge.

`span("train_step")` wraps a host-side region; spans nest per thread
(parent/child from a thread-local stack), clock on
`time.perf_counter_ns` (monotonic), and land in a bounded in-memory
buffer. Export is Chrome trace format (`chrome://tracing` /
Perfetto-compatible `{"traceEvents": [...]}` with "X" complete events),
so a training run's host timeline opens in the same tooling as a device
profile.

Off by default: until `start_tracing()` (or the CLI's `--trace`), a
span is a no-op context manager — a couple of attribute loads per use,
cheap enough to leave in the hot fit/serve loops permanently.

Opt-in profiler bridge: `start_tracing(profiler_annotations=True)`
additionally enters `torch.profiler.record_function(name)` for every
span, so when a `torch.profiler` window is open
(optimize/listeners.ProfilerListener) the host spans line up against the
device timeline in the profiler's trace: step phases as first-class
trace data, not log lines.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import List, NamedTuple, Optional

__all__ = [
    "SpanRecord", "Tracer", "span", "start_tracing", "stop_tracing",
    "tracing", "active_tracer", "chrome_trace", "save_chrome_trace",
]


class SpanRecord(NamedTuple):
    """One closed span. Times are perf_counter nanoseconds; `depth` is
    the nesting level on its thread (0 = root)."""

    name: str
    start_ns: int
    dur_ns: int
    thread_id: int
    depth: int
    args: dict


class Tracer:
    """Bounded span buffer + per-thread nesting state."""

    def __init__(self, max_spans: int = 100_000,
                 profiler_annotations: bool = False):
        from collections import deque
        self.max_spans = int(max_spans)
        self.profiler_annotations = bool(profiler_annotations)
        self._spans = deque(maxlen=self.max_spans)
        self._local = threading.local()
        self._lock = threading.Lock()

    # ------------------------------------------------------------ record
    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    def _push(self) -> int:
        d = self._depth()
        self._local.depth = d + 1
        return d

    def _pop(self) -> None:
        self._local.depth = max(0, self._depth() - 1)

    def record(self, rec: SpanRecord) -> None:
        with self._lock:
            self._spans.append(rec)

    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # ------------------------------------------------------------ export
    def chrome_trace(self) -> dict:
        """Chrome trace format dict: "X" (complete) events, microsecond
        timestamps. Nesting is reconstructed by the viewer from
        timestamp containment per tid; `depth` rides in args for
        programmatic consumers."""
        pid = os.getpid()
        events = []
        for s in self.spans():
            args = dict(s.args)
            args["depth"] = s.depth
            events.append({
                "name": s.name,
                "ph": "X",
                "ts": s.start_ns / 1e3,
                "dur": s.dur_ns / 1e3,
                "pid": pid,
                "tid": s.thread_id,
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


_active: Optional[Tracer] = None


def start_tracing(max_spans: int = 100_000,
                  profiler_annotations: bool = False) -> Tracer:
    """Install (and return) the process tracer. Idempotent-ish: a second
    call replaces the tracer (fresh buffer)."""
    global _active
    _active = Tracer(max_spans=max_spans, profiler_annotations=profiler_annotations)
    return _active


def stop_tracing() -> Optional[Tracer]:
    """Stop recording; returns the tracer (buffer intact) for export."""
    global _active
    t, _active = _active, None
    return t


def tracing() -> bool:
    return _active is not None


def active_tracer() -> Optional[Tracer]:
    return _active


@contextmanager
def span(name: str, **args):
    """Time a host-side region. No-op (and allocation-light) while
    tracing is off; with `profiler_annotations` the region is also annotated
    onto the profiler's timeline."""
    tracer = _active
    if tracer is None:
        yield
        return
    ann = None
    if tracer.profiler_annotations:
        try:
            import torch
            ann = torch.profiler.record_function(name)
            ann.__enter__()
        except Exception:
            ann = None
    depth = tracer._push()
    start = time.perf_counter_ns()
    try:
        yield
    finally:
        dur = time.perf_counter_ns() - start
        tracer._pop()
        if ann is not None:
            try:
                ann.__exit__(None, None, None)
            except Exception:
                pass
        tracer.record(SpanRecord(name, start, dur,
                                 threading.get_ident(), depth, args))


def chrome_trace() -> dict:
    """Chrome trace of the active tracer ({} when tracing is off)."""
    return _active.chrome_trace() if _active else {"traceEvents": []}


def save_chrome_trace(path: str) -> Optional[str]:
    """Write the active tracer's Chrome trace; None when tracing is
    off."""
    return _active.save(path) if _active else None
