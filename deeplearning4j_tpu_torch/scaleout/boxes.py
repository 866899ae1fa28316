"""Box creation: bring cloud worker hosts into existence, the
counterpart of the JAX package's `scaleout/boxes.py`.

Parity: reference `Ec2BoxCreator`
(deeplearning4j-aws/.../aws/ec2/Ec2BoxCreator.java:35,127-134 —
`create()` calls runInstances with AMI/size/security-group and collects
instance ids; `blowupBoxes()` terminates them) feeding `ClusterSetup`
(ClusterSetup.java:40: create boxes, then provision each).

Design: the cloud API is driven through its own CLI (`gcloud`
for TPU VMs) rather than an embedded SDK — the command runner is
injectable so tests (and air-gapped environments) record commands
instead of executing them. `GceTpuBoxCreator.create()` returns the
worker hostnames; hand them to `ClusterSetup` as `SshTransport`s (or let
`cluster_hosts()` do it) and the existing provisioning layer takes over.
`LocalBoxCreator` is the embedded tier: n "boxes" on this host. The
creators are the JAX package's, issuing the same commands; host code.
"""

from __future__ import annotations

import json
import logging
import subprocess
from typing import Callable, Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.scaleout.provision import (LocalTransport,
                                                         SshTransport,
                                                         Transport)

log = logging.getLogger(__name__)

__all__ = ["BoxCreator", "LocalBoxCreator", "GceTpuBoxCreator",
           "cluster_hosts"]

#: runner signature: (argv) -> stdout. Injectable for tests/air-gapped use.
Runner = Callable[[Sequence[str]], str]


def _subprocess_runner(argv: Sequence[str]) -> str:
    proc = subprocess.run(list(argv), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{argv[0]} failed (rc {proc.returncode}): {proc.stderr.strip()}")
    return proc.stdout


class BoxCreator:
    """Create/destroy worker hosts (reference Ec2BoxCreator.create /
    blowupBoxes)."""

    def create(self) -> List[str]:
        """Bring the boxes up; returns host identifiers for transports."""
        raise NotImplementedError

    def blow_away(self) -> None:
        """Terminate everything create() made (reference blowupBoxes)."""
        raise NotImplementedError

    def transport_for(self, host: str) -> Transport:
        raise NotImplementedError


class LocalBoxCreator(BoxCreator):
    """n logical boxes on this host — the embedded/test tier (boxes are
    free; transports are LocalTransport)."""

    def __init__(self, n_boxes: int = 2):
        self.n_boxes = n_boxes

    def create(self) -> List[str]:
        return [f"local-{i}" for i in range(self.n_boxes)]

    def blow_away(self) -> None:
        pass

    def transport_for(self, host: str) -> Transport:
        return LocalTransport()


class GceTpuBoxCreator(BoxCreator):
    """TPU-VM boxes via the gcloud CLI (the Ec2BoxCreator equivalent for
    the platform this framework targets).

    `create()` issues `gcloud compute tpus tpu-vm create` per box and
    returns the worker hostnames reported by `describe` (multi-host pod
    slices report one endpoint per host — all of them are returned, so a
    v5e-16 slice yields 4 hosts for ClusterSetup). AMI/instance-type/
    security-group become accelerator-type/runtime-version/network.
    """

    def __init__(self, name_prefix: str, *, zone: str,
                 accelerator_type: str = "v5litepod-8",
                 runtime_version: str = "v2-alpha-tpuv5-lite",
                 n_slices: int = 1, project: Optional[str] = None,
                 network: Optional[str] = None,
                 ssh_user: Optional[str] = None,
                 runner: Runner = _subprocess_runner):
        self.name_prefix = name_prefix
        self.zone = zone
        self.accelerator_type = accelerator_type
        self.runtime_version = runtime_version
        self.n_slices = n_slices
        self.project = project
        self.network = network
        self.ssh_user = ssh_user
        self.runner = runner
        self.created: List[str] = []  # slice names

    def _base(self, verb: str, name: str) -> List[str]:
        argv = ["gcloud", "compute", "tpus", "tpu-vm", verb, name,
                "--zone", self.zone]
        if self.project:
            argv += ["--project", self.project]
        return argv

    def _slice_name(self, i: int) -> str:
        return f"{self.name_prefix}-{i}"

    def create(self) -> List[str]:
        hosts: List[str] = []
        for i in range(self.n_slices):
            name = self._slice_name(i)
            argv = self._base("create", name) + [
                "--accelerator-type", self.accelerator_type,
                "--version", self.runtime_version]
            if self.network:
                argv += ["--network", self.network]
            self.runner(argv)
            self.created.append(name)
            hosts.extend(self._hosts_of(name))
        log.info("created %d slice(s) -> %d worker host(s)",
                 self.n_slices, len(hosts))
        return hosts

    def _hosts_of(self, name: str) -> List[str]:
        out = self.runner(self._base("describe", name) + ["--format", "json"])
        desc: Dict = json.loads(out)
        endpoints = desc.get("networkEndpoints", [])
        hosts = [e.get("ipAddress") for e in endpoints if e.get("ipAddress")]
        if not hosts:
            raise RuntimeError(f"no network endpoints reported for {name}")
        return hosts

    def blow_away(self) -> None:
        # every slice gets its delete attempt (one failure must not leak
        # the rest — these are billed machines); already-gone slices are
        # treated as success, other failures stay in `created` so a
        # retry converges, and the combined error is raised at the end
        errors = []
        remaining = []
        for name in self.created:
            try:
                self.runner(self._base("delete", name) + ["--quiet"])
            except RuntimeError as e:
                if "not found" in str(e).lower():
                    continue  # deleted out-of-band: goal state reached
                errors.append(f"{name}: {e}")
                remaining.append(name)
        self.created = remaining
        if errors:
            raise RuntimeError("blow_away left slice(s) running: "
                               + "; ".join(errors))

    def transport_for(self, host: str) -> Transport:
        return SshTransport(host, user=self.ssh_user)


def cluster_hosts(creator: BoxCreator,
                  worker_prefix: str = "w") -> Dict[str, Transport]:
    """create() boxes and shape them as the `hosts` mapping ClusterSetup
    takes (worker-id -> Transport)."""
    return {f"{worker_prefix}{i}": creator.transport_for(h)
            for i, h in enumerate(creator.create())}
