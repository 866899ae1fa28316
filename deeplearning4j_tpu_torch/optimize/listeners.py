"""Iteration listeners, the counterpart of the JAX package's
`optimize/listeners.py`.

Parity: reference core/optimize/api/IterationListener.java (hook invoked
from BaseOptimizer.java:168-170), ScoreIterationListener
(listeners/ScoreIterationListener.java:41), ComposableIterationListener;
beyond the reference, as in the JAX package: `CollectScoresListener`,
`StepTimeListener` (wall time between iterations), the guardian-event
listeners, and `ProfilerListener`, which traces a window of iterations
with `torch.profiler` (where the JAX package uses `jax.profiler`).

A listener is called with the score as a Python float, so attaching one
makes the solver read the score back to the host every iteration (the
eager path of `solvers.BaseOptimizer.optimize`).

Telemetry, as in the JAX package: the listeners keep their public API
and also publish into the process-global registry (`telemetry/`):
scores land on the `dl4j_train_loss` gauge, dispatches count in
`dl4j_listener_iterations`, and StepTimeListener's deltas go to the
`dl4j_train_step_seconds{source="listener"}` histogram. The score is
already a Python float here, so publishing it reads nothing back.
"""

from __future__ import annotations

import logging
import os
import statistics
import time
from typing import Iterable, Optional

from deeplearning4j_tpu_torch import telemetry

log = logging.getLogger(__name__)

_M_LOSS = telemetry.gauge(
    "dl4j_train_loss", "last host-synced training score")
_M_STEP_S = telemetry.histogram("dl4j_train_step_seconds")
_M_ITER = telemetry.counter(
    "dl4j_listener_iterations", "iteration_done listener dispatches")


class IterationListener:
    def iteration_done(self, model, iteration: int, score: float) -> None:
        raise NotImplementedError


class ScoreIterationListener(IterationListener):
    def __init__(self, print_every: int = 10):
        self.print_every = max(1, print_every)

    def iteration_done(self, model, iteration: int, score: float) -> None:
        _M_ITER.inc()
        _M_LOSS.set(score)
        if iteration % self.print_every == 0:
            log.info("Score at iteration %d is %s", iteration, score)


class ComposableIterationListener(IterationListener):
    def __init__(self, listeners: Iterable[IterationListener]):
        self.listeners = list(listeners)

    def iteration_done(self, model, iteration: int, score: float) -> None:
        for listener in self.listeners:
            listener.iteration_done(model, iteration, score)


class CollectScoresListener(IterationListener):
    """Test/diagnostic helper: records every (iteration, score)."""

    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration: int, score: float) -> None:
        score = float(score)
        _M_ITER.inc()
        _M_LOSS.set(score)
        self.scores.append((iteration, score))


class StepTimeListener(IterationListener):
    """Wall-clock time between consecutive iterations, measured
    listener to listener, so it includes everything in a step (the
    gradient, the update and the score's read-back)."""

    def __init__(self, log_every: int = 0):
        self.log_every = log_every
        self.step_times: list = []
        self._last: Optional[float] = None

    def iteration_done(self, model, iteration: int, score: float) -> None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.step_times.append(dt)
            _M_STEP_S.labels(source="listener").observe(dt)
            if self.log_every and len(self.step_times) % self.log_every == 0:
                log.info("step %d: %.3f ms", iteration, dt * 1e3)
        self._last = now

    def reset(self) -> None:
        self.step_times.clear()
        self._last = None

    def optimization_done(self, model) -> None:
        """Solver hook: the gap between two optimize() runs (batch
        preparation) is not a step, so nothing is timed across it."""
        self._last = None

    def summary(self) -> dict:
        """{count, mean_ms, median_ms, p90_ms, max_ms} over recorded
        steps."""
        if not self.step_times:
            return {"count": 0}
        ms = sorted(t * 1e3 for t in self.step_times)
        return {
            "count": len(ms),
            "mean_ms": statistics.fmean(ms),
            "median_ms": statistics.median(ms),
            "p90_ms": ms[min(len(ms) - 1, int(0.9 * len(ms)))],
            "max_ms": ms[-1],
        }


class GuardianListener(IterationListener):
    """Base for listeners that want guardian events (skips, rollbacks,
    autosaves, preemption flushes, aborts; optimize/guardian.py). Any
    listener exposing `guardian_event` is notified; subclassing this
    gives the no-op `iteration_done`."""

    def iteration_done(self, model, iteration: int, score: float) -> None:
        pass

    def guardian_event(self, model, event) -> None:
        raise NotImplementedError


class CollectGuardianEvents(GuardianListener):
    """Test/diagnostic helper: records every GuardianEvent."""

    def __init__(self):
        self.events = []

    def guardian_event(self, model, event) -> None:
        self.events.append(event)

    def kinds(self) -> list:
        return [e.kind for e in self.events]


class ProfilerListener(IterationListener):
    """Trace iterations [start, stop) with `torch.profiler` (CPU and,
    where there is a card, CUDA activity) and write the trace to
    `log_dir` as Chrome-trace JSON (`trace_<pid>_<ns>.json`).

    Iteration 0 is skipped by default: the hook fires after each
    iteration, so the trace starts once iteration `start - 1` has
    completed. If optimization ends before the window closes,
    `optimization_done` stops the trace."""

    def __init__(self, log_dir: str, start: int = 1, stop: int = 4):
        if stop <= start:
            raise ValueError(f"stop ({stop}) must be > start ({start})")
        if start < 1:
            raise ValueError("start must be >= 1 (the hook fires after "
                             "each iteration; iteration 0 cannot be traced)")
        self.log_dir = log_dir
        self.start = start
        self.stop = stop
        self._prof = None
        self.trace_path: Optional[str] = None

    @property
    def _active(self) -> bool:
        return self._prof is not None

    def iteration_done(self, model, iteration: int, score: float) -> None:
        if (not self._active
                and self.start - 1 <= iteration < self.stop - 1):
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
        elif self._active and iteration >= self.stop - 1:
            self._stop_trace()

    def optimization_done(self, model) -> None:
        """Solver hook: close an open trace when the loop ends early."""
        if self._active:
            self._stop_trace()

    def _stop_trace(self) -> None:
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(
            self.log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(self.trace_path)
