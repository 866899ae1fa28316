"""Process-global metrics registry: Counter / Gauge / Histogram.

The reference framework's observability stopped at SLF4J score logging
plus the Hazelcast tracker's ad-hoc counters
(BaseHazelCastStateTracker.java); this module is the single data model
every stat in the reproduction publishes into — train loops, the
guardian, the device feed, the serving engine/batcher — so one scrape
(`telemetry.exposition`) sees the whole system.

Hot-path design:

- **Counters are lock-free on the increment path**: each thread owns a
  private accumulator cell (handed out once under a lock, then cached in
  a `threading.local`), and `inc()` is a single float add on that cell —
  safe under the GIL because only the owning thread ever writes it.
  Reads (`value`, scrape) sum the cells; a scrape may lag an in-flight
  increment by one bytecode, never lose it.
- **Gauges** hold one value under a tiny lock, or a zero-arg callable
  (`set_function`) sampled at scrape time — how the device-memory and
  jit-program-cache gauges stay live without a background thread.
- **Histograms** keep fixed cumulative buckets (Prometheus semantics)
  plus a bounded reservoir for host-side percentile queries
  (`percentile(0.99)` — what EngineStats' p50/p99 read). One lock per
  observation; observations are per-request/per-step, not per-element.

A module-global kill switch (`set_enabled(False)`, or env
`DL4J_TPU_TELEMETRY=0` at import) turns every record call into an early
return — the "bare" side of `bench.py telemetry`. Instrumentation never
touches traced values either way: recording is host counters only, so
the computational path is bit-identical with telemetry on or off.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "get_registry", "set_enabled", "enabled",
    "DEFAULT_BUCKETS",
]

#: default histogram bucket bounds (seconds-flavored: 100 µs .. 10 s)
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_enabled = os.environ.get("DL4J_TPU_TELEMETRY", "1") != "0"


def set_enabled(on: bool) -> None:
    """Global record switch: False turns every inc/set/observe into an
    early return (registered series keep their last values)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter child (one labeled series)."""

    __slots__ = ("_shards", "_local", "_lock")

    def __init__(self):
        self._shards: Dict[int, list] = {}
        self._local = threading.local()
        self._lock = threading.Lock()

    def _cell(self) -> list:
        try:
            return self._local.cell
        except AttributeError:
            with self._lock:
                cell = self._shards.setdefault(
                    threading.get_ident(), [0.0])
            self._local.cell = cell
            return cell

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counters are monotonic; inc({n}) < 0")
        if not _enabled:
            return
        self._cell()[0] += n

    @property
    def value(self) -> float:
        with self._lock:
            return sum(cell[0] for cell in self._shards.values())


class Gauge:
    """Gauge child: last-set value, or a callable sampled at read."""

    __slots__ = ("_value", "_fn", "_lock")

    def __init__(self):
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value = float(v)
            self._fn = None

    def inc(self, n: float = 1.0) -> None:
        if not _enabled:
            return
        with self._lock:
            self._value += n
            self._fn = None

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Sample `fn` at every read/scrape (live gauges: queue depth,
        device memory, jit program cache). The callable must be cheap
        and must not raise; exceptions read as the last static value."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:
            return self._value


class Histogram:
    """Histogram child: cumulative fixed buckets + bounded percentile
    reservoir."""

    __slots__ = ("_bounds", "_counts", "_sum", "_count", "_reservoir",
                 "_lock")

    def __init__(self, bounds: Sequence[float], window: int):
        self._bounds = tuple(bounds)
        self._counts = [0] * (len(self._bounds) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0
        from collections import deque
        self._reservoir = deque(maxlen=window)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        if not _enabled:
            return
        v = float(v)
        i = 0
        for i, b in enumerate(self._bounds):
            if v <= b:
                break
        else:
            i = len(self._bounds)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._reservoir.append(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> float:
        """Percentile over the bounded reservoir (the most recent
        `window` observations); 0.0 when empty."""
        with self._lock:
            vals = sorted(self._reservoir)
        if not vals:
            return 0.0
        idx = min(len(vals) - 1, int(round(q * (len(vals) - 1))))
        return vals[idx]

    def cumulative_buckets(self) -> Iterable[Tuple[float, int]]:
        """[(le, cumulative_count), ..., (inf, total)] — Prometheus
        bucket semantics."""
        with self._lock:
            counts = list(self._counts)
        acc = 0
        out = []
        for bound, c in zip(self._bounds, counts):
            acc += c
            out.append((bound, acc))
        out.append((float("inf"), acc + counts[-1]))
        return out


class MetricFamily:
    """One named metric: children keyed by their label sets. Calling the
    record methods directly addresses the unlabeled child."""

    _CHILD = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self, name: str, kind: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 window: int = 2048):
        self.name = name
        self.kind = kind
        self.help = help
        self._buckets = tuple(buckets)
        self._window = int(window)
        self._children: Dict[tuple, object] = {}
        self._label_names: Optional[frozenset] = None
        self._lock = threading.Lock()

    def _make_child(self):
        if self.kind == "histogram":
            return Histogram(self._buckets, self._window)
        return self._CHILD[self.kind]()

    def labels(self, **labels):
        """Get-or-create the child for this label set. Label NAMES must
        be consistent across a family (Prometheus contract); values are
        free-form and escaped at exposition."""
        names = frozenset(labels)
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if self._label_names is None:
                    self._label_names = names
                elif names != self._label_names:
                    raise ValueError(
                        f"metric {self.name!r} uses label names "
                        f"{sorted(self._label_names)}, got {sorted(names)}")
                child = self._make_child()
                self._children[key] = child
            return child

    def _default(self):
        with self._lock:
            child = self._children.get(())
            if child is None:
                child = self._make_child()
                self._children[()] = child
            return child

    # unlabeled conveniences
    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def set(self, v: float) -> None:
        self._default().set(v)

    def dec(self, n: float = 1.0) -> None:
        self._default().dec(n)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._default().set_function(fn)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    @property
    def value(self):
        return self._default().value

    @property
    def count(self) -> int:
        return self._default().count

    @property
    def sum(self) -> float:
        return self._default().sum

    def percentile(self, q: float) -> float:
        return self._default().percentile(q)

    def remove(self, **labels) -> None:
        """Drop one labeled series (and its history). Long-lived
        processes that churn labeled owners — serving restarts creating
        fresh engine/batcher labels — use this to cap cardinality;
        nothing calls it implicitly, because post-mortem reads of a
        closed owner's counters are part of the stats contract."""
        with self._lock:
            self._children.pop(_label_key(labels), None)

    def children(self):
        """[(labels_dict, child)] snapshot, deterministic order."""
        with self._lock:
            items = sorted(self._children.items())
        return [(dict(k), c) for k, c in items]


class MetricsRegistry:
    """Thread-safe name -> MetricFamily map with get-or-create
    semantics, so independent modules can share a family by name."""

    def __init__(self):
        self._metrics: Dict[str, MetricFamily] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, kind: str, help: str,
                       **kw) -> MetricFamily:
        with self._lock:
            fam = self._metrics.get(name)
            if fam is None:
                fam = MetricFamily(name, kind, help, **kw)
                self._metrics[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"requested {kind}")
            return fam

    def counter(self, name: str, help: str = "") -> MetricFamily:
        return self._get_or_create(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> MetricFamily:
        return self._get_or_create(name, "gauge", help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  window: int = 2048) -> MetricFamily:
        return self._get_or_create(name, "histogram", help,
                                   buckets=buckets, window=window)

    def collect(self):
        """Name-sorted [(family, [(labels, child)])] snapshot."""
        with self._lock:
            fams = sorted(self._metrics.values(), key=lambda f: f.name)
        return [(fam, fam.children()) for fam in fams]

    def snapshot(self) -> dict:
        """JSON-safe dump of every series (the /snapshot API; the
        Prometheus text twin lives in telemetry.exposition)."""
        out = {}
        for fam, children in self.collect():
            series = []
            for labels, child in children:
                if fam.kind == "histogram":
                    series.append({
                        "labels": labels,
                        "count": child.count,
                        "sum": round(child.sum, 9),
                        "p50": child.percentile(0.50),
                        "p99": child.percentile(0.99),
                    })
                else:
                    series.append({"labels": labels,
                                   "value": child.value})
            out[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "series": series}
        return out


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry every built-in instrumentation point
    publishes into."""
    return _REGISTRY
