"""Prometheus text exposition + JSON snapshot of the metrics registry.

One renderer for every embedded server: the serving front end
(serving/server.py) and the scaleout StatusServer (scaleout/status.py)
both answer `GET /metrics` with `render_prometheus()` output, and
`GET /snapshot` with the JSON twin — so a Prometheus scrape config
pointed at either port sees the same catalogue
(docs/OBSERVABILITY.md). `start_metrics_server()` is the standalone
variant for processes with no HTTP surface of their own (training
entrypoints via `cli.py --metrics-port`).

Format notes (text format 0.0.4):

- counters render with the conventional `_total` suffix;
- histograms render cumulative `_bucket{le=...}` series ending in
  `le="+Inf"`, plus `_sum` and `_count`;
- label values escape backslash, double-quote and newline.
"""

from __future__ import annotations

import json
from typing import Optional

from deeplearning4j_tpu_torch.telemetry.registry import (MetricsRegistry,
                                                   get_registry)

__all__ = [
    "CONTENT_TYPE", "render_prometheus", "snapshot", "metrics_payload",
    "handle_metrics_get", "start_metrics_server",
]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n")


def _labels_text(labels: dict, extra: Optional[tuple] = None) -> str:
    items = sorted(labels.items())
    if extra is not None:
        items = items + [extra]
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in items)
    return "{" + body + "}"


def _fmt(v: float) -> str:
    f = float(v)
    if f != f:  # a NaN gauge (e.g. a diverged loss) must render, not
        return "NaN"  # 500 every scrape — the format allows literal NaN
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    i = int(f)
    return str(i) if i == f else repr(f)


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """The whole registry in Prometheus text format 0.0.4."""
    reg = registry if registry is not None else get_registry()
    lines = []
    for fam, children in reg.collect():
        name = fam.name
        if fam.kind == "counter" and not name.endswith("_total"):
            name = name + "_total"
        if fam.help:
            lines.append(f"# HELP {name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {name} {fam.kind}")
        for labels, child in children:
            if fam.kind == "histogram":
                for le, count in child.cumulative_buckets():
                    lines.append(
                        f"{name}_bucket"
                        f"{_labels_text(labels, ('le', _fmt(le)))} {count}")
                lines.append(
                    f"{name}_sum{_labels_text(labels)} {_fmt(child.sum)}")
                lines.append(
                    f"{name}_count{_labels_text(labels)} {child.count}")
            else:
                lines.append(
                    f"{name}{_labels_text(labels)} {_fmt(child.value)}")
    return "\n".join(lines) + "\n"


def snapshot(registry: Optional[MetricsRegistry] = None) -> dict:
    """JSON-safe dump of every series (the machine-readable twin of
    /metrics)."""
    reg = registry if registry is not None else get_registry()
    return reg.snapshot()


def metrics_payload(registry: Optional[MetricsRegistry] = None):
    """(body_bytes, content_type) for a /metrics response. Samples the
    device gauges (telemetry.device) so HBM pressure and recompile
    counters are one scrape away without a background sampler."""
    from deeplearning4j_tpu_torch.telemetry import device

    device.install(registry)
    return render_prometheus(registry).encode(), CONTENT_TYPE


def handle_metrics_get(path: str,
                       registry: Optional[MetricsRegistry] = None):
    """Shared route logic for embedded servers: returns
    (code, content_type, body_bytes) for /metrics and /snapshot paths,
    or None when the path is not a telemetry route."""
    if path.startswith("/metrics"):
        body, ctype = metrics_payload(registry)
        return 200, ctype, body
    if path.startswith("/snapshot"):
        body = json.dumps(snapshot(registry)).encode()
        return 200, "application/json", body
    return None


def start_metrics_server(host: str = "127.0.0.1", port: int = 0,
                         registry: Optional[MetricsRegistry] = None):
    """Standalone /metrics + /snapshot endpoint on the shared
    utils/httpd.py lifecycle (daemon thread, port-0 auto-assign,
    graceful close). Returns the ServerHandle; the caller owns
    close()."""
    from http.server import BaseHTTPRequestHandler

    from deeplearning4j_tpu_torch.utils.httpd import start_http_server

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def do_GET(self):
            try:
                hit = handle_metrics_get(self.path, registry)
                if hit is None:
                    code, ctype, body = 404, "text/plain", b"not found"
                else:
                    code, ctype, body = hit
            except Exception as e:  # surface, don't kill the thread
                code, ctype = 500, "text/plain"
                body = f"{type(e).__name__}: {e}".encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return start_http_server(Handler, host=host, port=port)
