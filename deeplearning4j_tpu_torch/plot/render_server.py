"""Lightweight coords render server.

Parity: reference nlp/plot/dropwizard/ — `RenderApplication` (Dropwizard
boot :37) + `ApiResource` GET /api/coords serving coords.csv
(ApiResource.java:44-60). Here: a stdlib ThreadingHTTPServer serving the
2D embedding + word labels as JSON at /api/coords and a minimal scatter
page at /.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler
from typing import Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.utils.httpd import ServerHandle, start_http_server

_PAGE = b"""<!doctype html><html><body>
<canvas id=c width=900 height=900></canvas><script>
fetch('/api/coords').then(r=>r.json()).then(d=>{
 const ctx=document.getElementById('c').getContext('2d');
 const xs=d.coords.map(p=>p[0]), ys=d.coords.map(p=>p[1]);
 const minx=Math.min(...xs),maxx=Math.max(...xs);
 const miny=Math.min(...ys),maxy=Math.max(...ys);
 d.coords.forEach((p,i)=>{
  const x=40+(p[0]-minx)/(maxx-minx+1e-9)*820;
  const y=40+(p[1]-miny)/(maxy-miny+1e-9)*820;
  ctx.fillText(d.labels[i]||'.',x,y);});});
</script></body></html>"""


def serve_coords(coords: np.ndarray, labels: Optional[Sequence[str]] = None,
                 port: int = 0) -> ServerHandle:
    """Start the render server (daemon thread) on an auto-assigned port
    by default; returns a ServerHandle — call handle.close() to stop and
    release the socket (it also unpacks as the historical
    (server, port) pair)."""
    coords = np.asarray(coords, np.float64)
    payload = json.dumps({
        "coords": coords[:, :2].tolist(),
        "labels": list(labels) if labels is not None else
        [""] * coords.shape[0],
    }).encode()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/api/coords"):
                body, ctype = payload, "application/json"
            else:
                body, ctype = _PAGE, "text/html"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet
            pass

    return start_http_server(Handler, port=port)
