"""Span-based step tracing on the profiler's clock, with Chrome-trace
export.

`span("train_step")` wraps a host-side region; spans nest per thread
(depth from a thread-local counter), clock on `time.perf_counter_ns`
(monotonic), and land in a bounded in-memory buffer. Export is Chrome
trace format (`chrome://tracing` / Perfetto-compatible `{"traceEvents":
[...]}` with "X" complete events).

One clock with the profiler: `start_tracing()` reads one anchor pair,
`time.perf_counter_ns` beside the profiler's clock
(`profiler_clock_ns`: torch.profiler stamps its host and device events,
and `kineto_results.trace_start_ns()`, in Unix-epoch nanoseconds).
`Tracer.to_profiler_ns` converts a span's times with it, and the Chrome
export writes `ts` on the profiler's clock, so a span lies over the
CUDA calls and device work it enqueued (torch.profiler's own export
writes the same clock less its `baseTimeNanoseconds`).

Off by default: until `start_tracing()` (or the CLI's `--trace`),
`span()` returns one shared no-op context and allocates nothing, cheap
enough to leave in the hot fit/serve loops permanently. A span only
reads the host's clock: it adds no synchronize and changes nothing the
device runs.

The spans in the port, each on the thread that does the work:

- serving/decode_loop.py: `decode.tick` (one scheduler pass) over
  `decode.admit` (with one `decode.prefill` a prefill group: `rows`,
  `bucket`, `tokens`, `rids`), `decode.grant`, `decode.upload`,
  `decode.replay` (the region `dl4j_decode_step_seconds` times) and
  `decode.emit`;
- datasets/device_feed.py: `feed.fetch` (the source's next batch and its
  padding) and `feed.put` (the local slice to the device) over
  `feed.stage` (an array filled into its pinned slot) and `feed.copy`
  (the copy's enqueue), once for each array;
- parallel/data_parallel.py: `parallel_train_step` over `dp.grads`,
  `dp.allreduce` and `dp.update`;
- nn/multilayer.py `train_step`, `fit_scan`, `fit_scan_epoch`;
  serving/engine.py `engine_infer`; checkpoint/writer.py
  `ckpt_snapshot`, `ckpt_write`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import List, NamedTuple, Optional, Tuple

__all__ = [
    "SpanRecord", "Tracer", "span", "add_span", "start_tracing",
    "stop_tracing", "tracing", "active_tracer", "chrome_trace",
    "save_chrome_trace", "profiler_clock_ns",
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


def profiler_clock_ns() -> int:
    """A reading of torch.profiler's clock: Unix-epoch nanoseconds, the
    clock of its events and of `kineto_results.trace_start_ns()`."""
    return time.time_ns()


def _anchor() -> Tuple[int, int]:
    """(perf_counter_ns, profiler_clock_ns) of one instant: the
    profiler's clock read between two perf_counter readings, their
    midpoint taken, from the tightest of five tries."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        p = profiler_clock_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, p)
    return best[1], best[2]


class Tracer:
    """Bounded span buffer, per-thread nesting state and the anchor pair
    that puts its spans on the profiler's clock."""

    def __init__(self, max_spans: int = 100_000):
        self.max_spans = int(max_spans)
        self._spans = deque(maxlen=self.max_spans)
        self._local = threading.local()
        self._lock = threading.Lock()
        #: (perf_counter_ns, profiler_clock_ns) read together
        self.anchor = _anchor()

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

    def add(self, name: str, start_ns: int, end_ns: int, **args) -> None:
        """Record a span from two perf_counter_ns readings the caller
        took itself (a region another reader times too), nested at the
        calling thread's current depth."""
        self.record(SpanRecord(name, start_ns, end_ns - start_ns,
                               threading.get_ident(), self._depth(), args))

    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def to_profiler_ns(self, perf_ns: int) -> int:
        """A perf_counter_ns reading on the profiler's clock."""
        return perf_ns - self.anchor[0] + self.anchor[1]

    # ------------------------------------------------------------ export
    def chrome_trace(self) -> dict:
        """Chrome trace format dict: "X" (complete) events, `ts` in
        microseconds on the profiler's clock. Nesting is reconstructed
        by the viewer from timestamp containment per tid; `depth` rides
        in args for programmatic consumers."""
        pid = os.getpid()
        events = []
        for s in self.spans():
            args = dict(s.args)
            args["depth"] = s.depth
            events.append({
                "name": s.name,
                "ph": "X",
                "ts": self.to_profiler_ns(s.start_ns) / 1e3,
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


class _Span:
    """One open span of an active tracer; `with span(...) as sp` binds
    it, and `sp.args` may be filled before the region ends."""

    __slots__ = ("_tracer", "name", "args", "_start", "_depth")

    def __init__(self, tracer: Tracer, name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self._depth = self._tracer._push()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        tracer = self._tracer
        tracer._pop()
        tracer.record(SpanRecord(self.name, self._start, end - self._start,
                                 threading.get_ident(), self._depth,
                                 self.args))
        return False


#: what span() returns while tracing is off (`as` binds None)
_OFF = nullcontext()
_active: Optional[Tracer] = None


def start_tracing(max_spans: int = 100_000) -> Tracer:
    """Install (and return) the process tracer, with a fresh buffer and
    anchor pair. Idempotent-ish: a second call replaces the tracer."""
    global _active
    _active = Tracer(max_spans=max_spans)
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


def span(name: str, **args):
    """Time a host-side region: a context whose `as` binds the open span
    (None, and nothing recorded or allocated, while tracing is off)."""
    tracer = _active
    if tracer is None:
        return _OFF
    return _Span(tracer, name, args)


def add_span(name: str, start_ns: int, end_ns: int, **args) -> None:
    """`Tracer.add` on the active tracer; nothing while tracing is
    off."""
    tracer = _active
    if tracer is not None:
        tracer.add(name, start_ns, end_ns, **args)


def chrome_trace() -> dict:
    """Chrome trace of the active tracer ({} when tracing is off)."""
    return _active.chrome_trace() if _active else {"traceEvents": []}


def save_chrome_trace(path: str) -> Optional[str]:
    """Write the active tracer's Chrome trace; None when tracing is
    off."""
    return _active.save(path) if _active else None
