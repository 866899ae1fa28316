"""StateTracker RPC: the cross-process control plane, the counterpart of
the JAX package's `scaleout/rpc.py`.

Parity: the reference's control plane is Hazelcast replicated data
structures reached over the network (BaseHazelCastStateTracker.java
master/worker/embedded connection modes :470-530) plus Akka remoting.
Here the master process owns ONE InMemoryStateTracker and serves it over
a tiny framed-TCP protocol; workers in other processes (or other hosts)
talk to it through `RemoteStateTracker`, which duck-types the tracker
surface the worker loop uses.

This is deliberately a CONTROL plane: job descriptors, heartbeats,
counters and packed parameter vectors (host numpy, one copy per job).
Gradient exchange inside a worker rides the collectives of `parallel/`
(NCCL on the card), never this socket.

Wire format: 8-byte big-endian length + the checkpoint codec's npz bytes
(scaleout/checkpoint.py dump_payload — arrays as raw npy members, JSON
manifest, nothing unpickled on receive), so a malicious peer can at worst
cause a ValueError, never code execution. The codec is the JAX package's
byte for byte, so a tracker served by either package answers a client
of the other. `_to_wire` / `_from_wire` also serve
`scaleout/api.py`'s `LocalWorkRetriever`.
"""

from __future__ import annotations

import logging
import socket
import socketserver
import struct
import threading
import uuid
from typing import Any, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.scaleout.api import Job
from deeplearning4j_tpu_torch.scaleout.checkpoint import (dump_payload,
                                                          load_payload)

log = logging.getLogger(__name__)

#: Tracker methods reachable over RPC (everything else is a protocol error).
ALLOWED_METHODS = frozenset({
    "add_worker", "remove_worker", "workers", "heartbeat", "heartbeats",
    "stale_workers", "add_job", "job_for", "clear_job", "jobs",
    "add_update", "worker_updates", "load_update", "clear_update",
    "clear_updates", "set_current", "get_current", "needs_replicate",
    "done_replicating", "increment", "count", "counters", "define", "get",
    "set_patience", "patience", "report_loss", "best_loss", "early_stop",
    "input_split", "batch_size", "finish", "is_done",
})


# ------------------------------------------------------------------ codec
def _to_wire(obj: Any) -> Any:
    """Jobs (and DataSet-bearing work) -> codec-friendly dicts."""
    if isinstance(obj, Job):
        wire = {"__job__": True,
                "work": _to_wire(obj.work),
                "result": _to_wire(obj.result),
                "worker_id": obj.worker_id,
                "retries": obj.retries}
        if obj.seq is not None:  # omit-when-absent keeps old frames valid
            wire["seq"] = int(obj.seq)
        return wire
    if hasattr(obj, "features") and hasattr(obj, "labels"):  # DataSet
        return {"__dataset__": True,
                "features": np.asarray(obj.features),
                "labels": np.asarray(obj.labels)}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_wire(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_wire(v) for k, v in obj.items()}
    return obj


def _from_wire(obj: Any) -> Any:
    if isinstance(obj, dict):
        if obj.get("__job__"):
            seq = obj.get("seq")
            return Job(work=_from_wire(obj["work"]),
                       worker_id=obj["worker_id"],
                       result=_from_wire(obj["result"]),
                       retries=int(obj["retries"]),
                       seq=None if seq is None else int(seq))
        if obj.get("__dataset__"):
            from deeplearning4j_tpu_torch.datasets.api import DataSet
            return DataSet(obj["features"], obj["labels"])
        return {k: _from_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_wire(v) for v in obj)
    return obj


def _send_frame(sock: socket.socket, payload: dict) -> None:
    data = dump_payload(_to_wire(payload))
    sock.sendall(struct.pack(">Q", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed connection")
        buf += chunk
    return buf


MAX_FRAME = 1 << 31  # 2 GiB: larger than any packed parameter vector here


def _recv_frame(sock: socket.socket) -> dict:
    (length,) = struct.unpack(">Q", _recv_exact(sock, 8))
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    return _from_wire(load_payload(_recv_exact(sock, length)))


# ----------------------------------------------------------------- server
class _TrackerHandler(socketserver.BaseRequestHandler):
    def setup(self):
        with self.server.active_lock:  # type: ignore[attr-defined]
            self.server.active_conns.add(self.request)  # type: ignore

    def finish(self):
        with self.server.active_lock:  # type: ignore[attr-defined]
            self.server.active_conns.discard(self.request)  # type: ignore

    def handle(self):
        tracker = self.server.tracker  # type: ignore[attr-defined]
        dedup = self.server.dedup  # type: ignore[attr-defined]
        dedup_lock = self.server.dedup_lock  # type: ignore[attr-defined]
        while True:
            try:
                req = _recv_frame(self.request)
            except (ConnectionError, OSError):
                return
            # At-most-once execution: a client that lost the connection
            # after the server executed its call re-sends the SAME
            # (client, seq); replay the cached response instead of
            # re-executing non-idempotent methods (increment, add_update).
            # Clients serialize calls, so one cached entry per client
            # suffices.
            client, seq = req.get("client"), req.get("seq")
            if client is not None:
                with dedup_lock:
                    cached = dedup.get(client)
                if cached is not None and cached[0] == seq:
                    try:
                        _send_frame(self.request, cached[1])
                        continue
                    except (ConnectionError, OSError):
                        return
            try:
                method = req.get("method")
                if method not in ALLOWED_METHODS:
                    raise ValueError(f"method not allowed: {method!r}")
                value = getattr(tracker, method)(*req.get("args", []))
                resp = {"ok": True, "value": value}
            except Exception as e:  # report, keep serving
                log.exception("tracker RPC %s failed", req.get("method"))
                resp = {"ok": False,
                        "error": f"{type(e).__name__}: {e}"}
            if client is not None:
                with dedup_lock:
                    dedup[client] = (seq, resp)
            try:
                _send_frame(self.request, resp)
            except (ConnectionError, OSError):
                return


class StateTrackerServer:
    """Serve an InMemoryStateTracker over TCP (threaded, one thread per
    connected worker — workers hold one long-lived connection each)."""

    def __init__(self, tracker, host: str = "127.0.0.1", port: int = 0):
        self.tracker = tracker

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Server((host, port), _TrackerHandler)
        self._server.tracker = tracker  # type: ignore[attr-defined]
        self._server.dedup = {}  # type: ignore[attr-defined]
        self._server.dedup_lock = threading.Lock()  # type: ignore[attr-defined]
        self._server.active_conns = set()  # type: ignore[attr-defined]
        self._server.active_lock = threading.Lock()  # type: ignore[attr-defined]
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="tracker-server",
            daemon=True)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "StateTrackerServer":
        self._thread.start()
        log.info("StateTracker serving on %s", self.address)
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        # sever live worker connections too: a stopped master must look
        # to its workers exactly like a SIGKILLed one (kernel FIN), or
        # an in-process restart leaves them talking to a zombie tracker
        # through handler threads the shutdown never touches
        with self._server.active_lock:  # type: ignore[attr-defined]
            conns = list(self._server.active_conns)  # type: ignore
            self._server.active_conns.clear()  # type: ignore
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass


# ----------------------------------------------------------------- client
class RemoteStateTracker:
    """Client-side StateTracker: same surface as InMemoryStateTracker,
    every call an RPC to the master's tracker server."""

    def __init__(self, address: str, timeout: float = 30.0,
                 retries: int = 3):
        host, port = address.rsplit(":", 1)
        self._addr: Tuple[str, int] = (host, int(port))
        self._timeout = timeout
        self._retries = retries
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self.heartbeat_timeout = None  # server decides staleness
        self._client_id = uuid.uuid4().hex  # at-most-once dedup identity
        self._seq = 0

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self._addr, timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _call(self, method: str, *args: Any) -> Any:
        with self._lock:
            self._seq += 1  # same seq across retries of THIS call: the
            # server replays its cached response instead of re-executing
            last_err: Optional[Exception] = None
            for _ in range(self._retries):
                try:
                    if self._sock is None:
                        self._sock = self._connect()
                    _send_frame(self._sock, {"method": method,
                                             "args": list(args),
                                             "client": self._client_id,
                                             "seq": self._seq})
                    resp = _recv_frame(self._sock)
                    break
                except (ConnectionError, OSError) as e:
                    last_err = e
                    if self._sock is not None:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = None
            else:
                raise ConnectionError(
                    f"tracker RPC {method} failed after "
                    f"{self._retries} attempts: {last_err}")
        if not resp.get("ok"):
            raise RuntimeError(f"tracker RPC {method}: {resp.get('error')}")
        return resp.get("value")

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def __getattr__(self, name: str):
        if name in ALLOWED_METHODS:
            return lambda *args: self._call(name, *args)
        raise AttributeError(name)
