"""Telemetry plane of the port: metrics registry, span tracing,
Prometheus exposition, device gauges.

A copy of the JAX package's `telemetry/` with the same metric names,
help strings and labels, so a scrape of the port's server reads like a
scrape of the JAX server. Every hot path publishes into ONE
process-global `MetricsRegistry`:

- serving: `dl4j_serve_requests{engine=}`, rows/padded/errors,
  `dl4j_serve_latency_seconds`, `dl4j_serve_bucket_forwards`,
  `dl4j_batcher_*` + queue depth, the decode loop's `dl4j_decode_*`,
  `dl4j_kv_*` and `dl4j_tier_*` series, `dl4j_serve_reloads`;
- device: `dl4j_device_count`, `dl4j_device_memory_bytes{device=,stat=}`
  (sampled from `torch.cuda.memory_stats()` on the card) and
  `dl4j_jit_programs{cache=}` (programs built a cache: bucket shapes run,
  CUDA graphs captured);
- chaos: `dl4j_chaos_injected{point=,kind=}`;
- training: `dl4j_train_{steps,examples,epochs,loss}` and
  `dl4j_train_step_seconds{source=fit|scan|listener}` (nn/multilayer.py,
  optimize/listeners.py), `dl4j_listener_iterations`,
  `dl4j_guardian_events{kind=}`, the checkpoint writer's `dl4j_ckpt_*`,
  the device feed's `dl4j_feed_*`, and `dl4j_jit_programs{cache=
  "train_step"|"predict_step"}`;
- deployment: the controller's `dl4j_pipeline_*{pipeline=}` series
  (deploy/controller.py).

Export: `GET /metrics` (Prometheus text) and `GET /snapshot` (JSON) on
the serving server or a standalone `exposition.start_metrics_server()`.
Tracing: `span("name")` regions on the profiler's clock, with
Chrome-trace export (trace.py); the spans of the decode loop, the device
feed and the data-parallel step are listed there.
"""

from deeplearning4j_tpu_torch.telemetry.registry import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    enabled,
    get_registry,
    set_enabled,
)
from deeplearning4j_tpu_torch.telemetry.trace import (  # noqa: F401
    SpanRecord,
    Tracer,
    active_tracer,
    chrome_trace,
    save_chrome_trace,
    span,
    start_tracing,
    stop_tracing,
    tracing,
)

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "DEFAULT_BUCKETS",
    "get_registry", "set_enabled", "enabled",
    "counter", "gauge", "histogram",
    "span", "start_tracing", "stop_tracing", "tracing", "active_tracer",
    "chrome_trace", "save_chrome_trace", "Tracer", "SpanRecord",
]


def counter(name: str, help: str = ""):
    """Get-or-create a counter family on the global registry."""
    return get_registry().counter(name, help)


def gauge(name: str, help: str = ""):
    """Get-or-create a gauge family on the global registry."""
    return get_registry().gauge(name, help)


def histogram(name: str, help: str = "", **kw):
    """Get-or-create a histogram family on the global registry."""
    return get_registry().histogram(name, help, **kw)
