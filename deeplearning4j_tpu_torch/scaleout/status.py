"""Live run-state status endpoint, the counterpart of the JAX package's
`scaleout/status.py`.

Parity: the reference's state tracker embeds a Dropwizard status web UI
on :8080/8180 (BaseHazelCastStateTracker.java:181-189) exposing cluster
state while a run is in flight.

A tiny stdlib ThreadingHTTPServer on the utils/httpd.py `ServerHandle`
lifecycle (graceful shutdown releases the listening socket), serving

- ``GET /status.json`` — machine-readable snapshot: workers with
  heartbeat ages, in-flight jobs, pending updates, counters, early-stop
  state, plus server uptime + package version, and the owner's
  ``extra`` hook (the deployment controller's state);
- ``GET /healthz`` — liveness: ok / uptime_s / version, merged with the
  owner's ``health`` verdict (``"ok": False`` answers 503);
- ``GET /metrics`` — Prometheus text exposition of the process-global
  telemetry registry (``/snapshot`` is the JSON twin);
- ``GET /`` — a self-contained HTML view that polls the JSON.

The deployment controller's `status_port=` and the elastic supervisor
(`scaleout/supervisor.py`, through `MultiProcessMaster`) serve through
it; the cluster runtime's `waves` section is filled only when an owner
passes a runtime.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from deeplearning4j_tpu_torch.telemetry import exposition
from deeplearning4j_tpu_torch.utils.httpd import ServerHandle

_PAGE = """<!doctype html>
<html><head><title>deeplearning4j-tpu-torch run status</title>
<style>
 body { font-family: monospace; margin: 2em; }
 table { border-collapse: collapse; margin: 1em 0; }
 td, th { border: 1px solid #999; padding: 2px 8px; text-align: left; }
 h2 { margin: 0.5em 0 0 0; font-size: 1em; }
</style></head>
<body>
<h1>run status</h1>
<div id="root">loading…</div>
<script>
function row(k, v) {
  return "<tr><td>" + k + "</td><td>" + JSON.stringify(v) + "</td></tr>";
}
function table(obj) {
  return "<table>" + Object.entries(obj).map(
    ([k, v]) => row(k, v)).join("") + "</table>";
}
async function tick() {
  const r = await fetch("status.json");
  const s = await r.json();
  let html = "";
  for (const [section, body] of Object.entries(s)) {
    html += "<h2>" + section + "</h2>";
    html += (body !== null && typeof body === "object" && !Array.isArray(body))
      ? table(body) : "<p>" + JSON.stringify(body) + "</p>";
  }
  document.getElementById("root").innerHTML = html;
}
tick(); setInterval(tick, 1000);
</script></body></html>
"""


def _jsonable(value: Any) -> Any:
    """Clamp tracker values to JSON-safe primitives (arrays and arbitrary
    objects are summarized, not serialized)."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    shape = getattr(value, "shape", None)
    if shape is not None:
        return f"<array shape={tuple(shape)}>"
    return f"<{type(value).__name__}>"


def snapshot(tracker, runtime=None,
             extra: Optional[Callable[[], Dict[str, Any]]] = None,
             started_at: Optional[float] = None) -> Dict[str, Any]:
    """One coherent status snapshot of a tracker (and optionally the
    master runtime driving it). `started_at` (the owning server's start
    time) adds uptime; the package version always rides along so a
    fleet scrape can tell which build each master runs."""
    from deeplearning4j_tpu_torch import __version__

    now = time.time()
    heartbeats = tracker.heartbeats()
    state: Dict[str, Any] = {
        "now": now,
        "workers": {
            w: {"heartbeat_age_s": round(now - hb, 3)}
            for w, hb in heartbeats.items()
        },
        "jobs_in_flight": sorted(j.worker_id for j in tracker.jobs()),
        "pending_updates": sorted(tracker.worker_updates()),
        "counters": _jsonable(tracker.counters()),
        "has_current_model": tracker.get_current() is not None,
        "early_stop": {
            "best_loss": _jsonable(tracker.best_loss()),
            "patience": tracker.patience(),
            "tripped": tracker.early_stop(),
        },
        "batch_size": tracker.batch_size(),
        "done": tracker.is_done(),
        "server": {
            "version": __version__,
            **({"uptime_s": round(now - started_at, 3)}
               if started_at is not None else {}),
        },
    }
    stale = tracker.stale_workers(now)
    if stale:
        state["stale_workers"] = sorted(stale)
    if runtime is not None:
        state["waves"] = {
            "completed": getattr(runtime, "waves", None),
            "open_wave_size": getattr(runtime, "_wave_size", None),
            "orphan_jobs": len(getattr(runtime, "_orphan_jobs", []) or []),
            "n_workers": getattr(runtime, "n_workers", None),
        }
    if extra is not None:
        state["extra"] = _jsonable(extra())
    return state


class StatusServer:
    """Serve `snapshot` over HTTP from a daemon thread (the Dropwizard
    status-UI equivalent, BaseHazelCastStateTracker.java:181-189), on
    the shared utils/httpd.py ServerHandle lifecycle. The socket binds
    at construction (so `address` is valid before `start()`); the serve
    thread runs between start() and stop()."""

    def __init__(self, tracker, runtime=None, host: str = "127.0.0.1",
                 port: int = 0,
                 extra: Optional[Callable[[], Dict[str, Any]]] = None,
                 health: Optional[Callable[[], Dict[str, Any]]] = None):
        self.tracker = tracker
        self.runtime = runtime
        self.extra = extra
        #: optional readiness verdict merged into /healthz: a dict whose
        #: "ok" key decides the status code (False -> 503). The training
        #: supervisor wires its quorum check here so a fleet scrape (or a
        #: cluster manager) sees quorum loss as unhealthy, not merely as
        #: a status.json detail.
        self.health = health
        self.started_at = time.time()
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                if self.path in ("/status.json", "/status"):
                    try:
                        body = json.dumps(snapshot(
                            outer.tracker, outer.runtime, outer.extra,
                            started_at=outer.started_at)).encode()
                        ctype = "application/json"
                        code = 200
                    except Exception as e:  # surface, don't kill the thread
                        body = json.dumps({"error": repr(e)}).encode()
                        ctype = "application/json"
                        code = 500
                elif self.path.startswith(("/healthz", "/metrics",
                                           "/snapshot")):
                    # same surface-don't-kill contract as /status.json:
                    # a rendering error must answer 500, not reset the
                    # scraper's connection
                    try:
                        if self.path.startswith("/healthz"):
                            from deeplearning4j_tpu_torch import __version__

                            verdict = (_jsonable(outer.health())
                                       if outer.health is not None else {})
                            payload = {
                                "ok": bool(verdict.get("ok", True)),
                                "uptime_s": round(
                                    time.time() - outer.started_at, 3),
                                "version": __version__,
                            }
                            payload.update(
                                {k: v for k, v in verdict.items()
                                 if k != "ok"})
                            body = json.dumps(payload).encode()
                            ctype = "application/json"
                            code = 200 if payload["ok"] else 503
                        else:
                            _, ctype, body = exposition.handle_metrics_get(
                                self.path)
                            code = 200
                    except Exception as e:
                        body = json.dumps({"error": repr(e)}).encode()
                        ctype = "application/json"
                        code = 500
                elif self.path == "/":
                    body = _PAGE.encode()
                    ctype = "text/html; charset=utf-8"
                    code = 200
                else:
                    body = b"not found"
                    ctype = "text/plain"
                    code = 404
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # quiet
                pass

        server = ThreadingHTTPServer((host, port), _Handler)
        thread = threading.Thread(
            target=server.serve_forever, name="status-server", daemon=True)
        self.handle = ServerHandle(server, thread)
        self.host, self.port = self.handle.host, self.handle.port

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "StatusServer":
        self.started_at = time.time()
        self.handle.thread.start()
        return self

    def stop(self) -> None:
        """Graceful: stop serving, release the socket, join the serve
        thread (ServerHandle.close)."""
        self.handle.close()
