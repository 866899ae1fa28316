"""Per-device gauges: card memory stats + program counters.

- `dl4j_device_count` — `torch.cuda.device_count()` (0 on a host with no
  card).
- `dl4j_device_memory_bytes{device=...,stat=...}` — sampled at scrape
  time via gauge callables (no background thread) from the card's
  caching allocator: `bytes_in_use` and `peak_bytes_in_use` are
  `torch.cuda.memory_stats()`'s `allocated_bytes.all.current` and
  `allocated_bytes.all.peak`, `bytes_limit` is
  `torch.cuda.mem_get_info()[1]`. The `device` label is the
  `torch.device`'s string (`cuda:0`). A host with no card registers no
  memory gauges.
- `dl4j_jit_programs{cache=...}` — the port's program counters
  (`InferenceEngine.program_cache_size`: bucket shapes run;
  `DecodeLoop.decode_step_programs`: CUDA graphs captured) aggregated per
  cache label over every live owner. Owners register via
  `watch_jit_cache`; bound-method probes are held through weakrefs so
  watching never extends an engine's lifetime. A probe returning -1
  makes the whole label read -1 — "counter unavailable", never a fake 0.

`install()` is idempotent and cheap; `exposition.metrics_payload` calls
it so any /metrics mount gets device series without extra wiring.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                   get_registry)

__all__ = ["install", "watch_jit_cache", "jit_cache_total"]

_MEM_STATS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")

_lock = threading.Lock()
_watches: Dict[str, List] = {}
_installed_on: "weakref.WeakSet" = weakref.WeakSet()


def _probe_ref(probe: Callable[[], int]):
    """Weakly reference a bound-method probe (the common case: a
    network's / engine's cache-size method); plain callables are held
    strongly — callers own their lifetime."""
    if hasattr(probe, "__self__"):
        return weakref.WeakMethod(probe)
    return lambda: probe


def watch_jit_cache(label: str, probe: Callable[[], int],
                    registry: Optional[MetricsRegistry] = None) -> None:
    """Aggregate `probe()` (a program counter) into the `dl4j_jit_programs{cache=label}` gauge. Many
    owners may share one label (every MultiLayerNetwork watches
    "train_step"); dead owners fall out via their weakrefs."""
    reg = registry if registry is not None else get_registry()
    with _lock:
        refs = _watches.setdefault(label, [])
        refs.append(_probe_ref(probe))
        if len(refs) > 64:  # prune dead owners opportunistically
            refs[:] = [r for r in refs if r() is not None]
    reg.gauge(
        "dl4j_jit_programs",
        "compiled XLA programs per jitted-function cache (-1: counter "
        "unavailable)",
    ).labels(cache=label).set_function(lambda: jit_cache_total(label))


def jit_cache_total(label: str) -> int:
    """Sum of live probes under `label`; -1 if any live probe reports
    its counter unavailable."""
    with _lock:
        refs = list(_watches.get(label, ()))
    total = 0
    for ref in refs:
        probe = ref()
        if probe is None:
            continue
        try:
            size = int(probe())
        except Exception:
            continue
        if size < 0:
            return -1
        total += size
    return total


def _cuda_devices() -> list:
    import torch

    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _memory_stat(dev, stat: str) -> float:
    import torch

    if stat == "bytes_limit":
        return float(torch.cuda.mem_get_info(dev)[1])
    key = {"bytes_in_use": "allocated_bytes.all.current",
           "peak_bytes_in_use": "allocated_bytes.all.peak"}[stat]
    return float(torch.cuda.memory_stats(dev).get(key, 0))


def install(registry: Optional[MetricsRegistry] = None) -> None:
    """Register the device gauges on `registry` (default: the global).
    Idempotent per registry; gauge callables sample live at scrape."""
    reg = registry if registry is not None else get_registry()
    if reg in _installed_on:
        return
    try:
        devices = _cuda_devices()
    except Exception:
        return  # no backend yet: try again at the next scrape
    _installed_on.add(reg)

    reg.gauge("dl4j_device_count",
              "local accelerator devices").set(len(devices))
    if not devices:
        return
    mem = reg.gauge(
        "dl4j_device_memory_bytes",
        "per-device memory stats sampled from jax memory_stats()")
    for d in devices:
        for stat in _MEM_STATS:
            def sample(_d=d, _s=stat) -> float:
                try:
                    return _memory_stat(_d, _s)
                except Exception:
                    return 0.0

            mem.labels(device=str(d), stat=stat).set_function(sample)
