"""Shared stdlib HTTP-server lifecycle helper.

Both embedded servers (plot/render_server.py, serving/server.py) follow
the same pattern: a ThreadingHTTPServer on a daemon thread, bound to
port 0 by default so tests never collide on a fixed port, and a close()
that actually releases the listening socket (`shutdown` alone leaves the
fd open until GC — the classic leaked-socket flake).
"""

from __future__ import annotations

import threading
from http.server import ThreadingHTTPServer


class ServerHandle:
    """A running HTTP server: (server, thread, port) + graceful close().

    Supports 2-tuple unpacking `server, port = handle` for callers of the
    historical serve_coords contract.
    """

    def __init__(self, server: ThreadingHTTPServer,
                 thread: threading.Thread):
        self.server = server
        self.thread = thread
        self.port = int(server.server_address[1])
        self.host = server.server_address[0]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self, timeout: float = 5.0) -> None:
        """Stop serving, release the socket, join the serve thread."""
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=timeout)

    def __iter__(self):
        return iter((self.server, self.port))

    def __enter__(self) -> "ServerHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_http_server(handler_cls, host: str = "127.0.0.1",
                      port: int = 0) -> ServerHandle:
    """Bind (port 0 = auto-assign), serve on a daemon thread, return the
    handle. The caller owns close()."""
    server = ThreadingHTTPServer((host, port), handler_cls)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name=f"httpd:{server.server_address[1]}")
    thread.start()
    return ServerHandle(server, thread)
