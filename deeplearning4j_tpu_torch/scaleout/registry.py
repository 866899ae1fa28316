"""Config registry: cluster bootstrap configuration, the counterpart of
the JAX package's `scaleout/registry.py` (host code, the same files: a
registry written by either package is read by the other).

Parity: reference scaleout-zookeeper — `ZooKeeperConfigurationRegister`
stores a serialized Configuration at a path derived from (host, port)
(ZooKeeperConfigurationRegister.java:56,:100) and
`ZookeeperConfigurationRetriever.retrieve` reads it back (:38,:59);
`ZookeeperPathBuilder` builds the node path.

Design: ZooKeeper earns its keep through watches and leader
election, none of which this control plane needs — runs are launched by a
coordinator that already knows the membership (the reference itself only
uses ZK as a blob store for the startup Configuration). So the registry
is a directory of atomically-written JSON files on any shared filesystem
(NFS or a fuse mount across hosts), keyed the same way ZK paths were. A
launched worker needs exactly one thing: the run's configuration, which
carries the tracker endpoint and performer wiring.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional


class ConfigRegistry:
    """Register/retrieve run configurations by (host, port) or run name."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # path semantics mirror ZookeeperPathBuilder: one node per (host, port)
    def _path(self, host: str, port: int) -> str:
        safe = host.replace(os.sep, "_").replace(":", "_")
        return os.path.join(self.root, f"{safe}_{port}.json")

    def register(self, host: str, port: int,
                 configuration: Dict[str, Any]) -> str:
        """Atomically publish a configuration (reference register :100)."""
        path = self._path(host, port)
        payload = {"host": host, "port": port, "registered_at": time.time(),
                   "configuration": configuration}
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path

    def retrieve(self, host: str, port: int) -> Dict[str, Any]:
        """reference ZookeeperConfigurationRetriever.retrieve :59."""
        path = self._path(host, port)
        if not os.path.exists(path):
            raise KeyError(f"no configuration registered for "
                           f"{host}:{port} under {self.root}")
        with open(path) as f:
            return json.load(f)["configuration"]

    def wait_for(self, host: str, port: int,
                 timeout: float = 30.0) -> Dict[str, Any]:
        """Block until a configuration appears (workers may start before
        the master has registered)."""
        deadline = time.time() + timeout
        while True:
            try:
                return self.retrieve(host, port)
            except KeyError:
                if time.time() > deadline:
                    raise
                time.sleep(0.05)

    def unregister(self, host: str, port: int) -> None:
        path = self._path(host, port)
        if os.path.exists(path):
            os.unlink(path)

    def entries(self) -> List[Dict[str, Any]]:
        out = []
        for name in sorted(os.listdir(self.root)):
            if name.endswith(".json"):
                with open(os.path.join(self.root, name)) as f:
                    out.append(json.load(f))
        return out

    # ------------------------------------------------- run-name convenience
    def register_run(self, run_name: str,
                     configuration: Dict[str, Any]) -> str:
        return self.register(f"run-{run_name}", 0, configuration)

    def retrieve_run(self, run_name: str,
                     timeout: Optional[float] = None) -> Dict[str, Any]:
        if timeout:
            return self.wait_for(f"run-{run_name}", 0, timeout)
        return self.retrieve(f"run-{run_name}", 0)

    def unregister_run(self, run_name: str) -> None:
        self.unregister(f"run-{run_name}", 0)
