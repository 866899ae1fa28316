"""Cluster provisioning: bring worker hosts up and join them to a run,
the counterpart of the JAX package's `scaleout/provision.py`.

Parity: reference deeplearning4j-aws —
- `HostProvisioner` (aws/ec2/provision/HostProvisioner.java:40-260: JSch
  ssh/scp `uploadAndRun` :96, `runRemoteCommand` :105,
  `uploadForDeployment` :154)
- `ClusterSetup` (aws/ec2/provision/ClusterSetup.java:40-120: create
  boxes, then provision every worker host in parallel with a setup
  script)
- `Ec2BoxCreator` (cloud instance creation) and
  `DistributedDeepLearningTrainer` (main).

Design: box creation lives in `scaleout/boxes.py`
(GceTpuBoxCreator drives the gcloud CLI; LocalBoxCreator is the embedded
tier) and these classes do what the reference does AFTER instances
exist: copy artifacts to each host and start the worker process.
Transports are pluggable: `LocalTransport` (same-host process spawn —
the test tier and single-host multi-process runs) and `SshTransport`
(OpenSSH subprocess — multi-host; keys/agent handled by ssh itself, no
password prompts, no embedded JSch-style crypto).
Workers join the run through the ConfigRegistry + launcher, so
provisioning only needs to start `python -m
deeplearning4j_tpu_torch.scaleout.launcher worker` with the registry
root and run name. Host code: the worker it starts trains on the device
its run's performer conf names.
"""

from __future__ import annotations

import logging
import os
import shlex
import shutil
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Sequence, Tuple

log = logging.getLogger(__name__)

__all__ = ["LocalTransport", "SshTransport", "HostProvisioner",
           "ClusterSetup"]


class Transport:
    """upload + run on one host."""

    def upload(self, local_path: str, remote_path: str) -> None:
        raise NotImplementedError

    def run(self, command: Sequence[str],
            detach: bool = False) -> Tuple[int, str]:
        """Run a command; returns (returncode, output). With detach=True
        the process is left running and (0, pid-string) returns
        immediately."""
        raise NotImplementedError


class LocalTransport(Transport):
    """Same-host transport: file copy + subprocess. The provisioning
    equivalent of the reference's embedded test tier."""

    def upload(self, local_path, remote_path):
        parent = os.path.dirname(remote_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        if os.path.abspath(local_path) == os.path.abspath(remote_path):
            return  # already in place (same-host deploy into its own dir)
        shutil.copy2(local_path, remote_path)

    def run(self, command, detach=False):
        if detach:
            proc = subprocess.Popen(
                list(command), stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
                start_new_session=True)
            return 0, str(proc.pid)
        proc = subprocess.run(list(command), capture_output=True, text=True)
        return proc.returncode, proc.stdout + proc.stderr


class SshTransport(Transport):
    """OpenSSH subprocess transport (reference HostProvisioner's JSch
    channel, minus embedded credentials — auth is ssh-agent/keyfile via
    standard ssh config)."""

    def __init__(self, host: str, user: Optional[str] = None,
                 port: int = 22, key_file: Optional[str] = None,
                 connect_timeout: int = 10):
        self.target = f"{user}@{host}" if user else host
        self.port = port
        self.key_file = key_file
        self.connect_timeout = connect_timeout

    def _ssh_base(self) -> List[str]:
        cmd = ["ssh", "-p", str(self.port),
               "-o", f"ConnectTimeout={self.connect_timeout}",
               "-o", "BatchMode=yes"]
        if self.key_file:
            cmd += ["-i", self.key_file]
        return cmd + [self.target]

    def upload(self, local_path, remote_path):
        cmd = ["scp", "-P", str(self.port), "-o", "BatchMode=yes"]
        if self.key_file:
            cmd += ["-i", self.key_file]
        cmd += [local_path, f"{self.target}:{remote_path}"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(
                f"scp to {self.target} failed: OpenSSH client not "
                f"installed ({e})") from e
        if proc.returncode != 0:
            raise RuntimeError(f"scp to {self.target} failed: {proc.stderr}")

    def run(self, command, detach=False):
        # each element shell-quoted: the remote side runs through a shell,
        # so paths/run-names with spaces or metacharacters must not split
        # or be interpreted (the detach path additionally wraps in nohup)
        remote = " ".join(shlex.quote(c) for c in command)
        if detach:
            remote = f"nohup {remote} >/dev/null 2>&1 & echo $!"
        try:
            proc = subprocess.run(self._ssh_base() + [remote],
                                  capture_output=True, text=True)
        except FileNotFoundError as e:
            return 127, f"ssh client not installed: {e}"
        return proc.returncode, proc.stdout + proc.stderr


class HostProvisioner:
    """Upload artifacts to one host and run commands there (reference
    HostProvisioner.java: uploadAndRun :96, runRemoteCommand :105,
    uploadForDeployment :154)."""

    def __init__(self, transport: Transport, host: str = "localhost"):
        self.transport = transport
        self.host = host

    def upload_for_deployment(self, local_path: str,
                              remote_path: str) -> None:
        self.transport.upload(local_path, remote_path)

    def run_remote_command(self, command: Sequence[str]) -> Tuple[int, str]:
        return self.transport.run(command)

    def upload_and_run(self, script_path: str, remote_dir: str = "",
                       interpreter: str = "bash") -> Tuple[int, str]:
        """Copy a setup script to the host and execute it (reference
        uploadAndRun :96)."""
        remote = os.path.join(remote_dir or ".",
                              os.path.basename(script_path))
        self.transport.upload(script_path, remote)
        return self.transport.run([interpreter, remote])


class ClusterSetup:
    """Provision every worker host in parallel and start launcher worker
    processes joined to one run (reference ClusterSetup.java:77-120
    provisionWorkers: one async provisioning task per host).

    `hosts` maps worker-id -> Transport. Box creation (Ec2BoxCreator) is
    the platform's job (`boxes.py`, gcloud); this starts at "hosts
    exist"."""

    def __init__(self, hosts: Dict[str, Transport],
                 registry_root: str, run_name: str,
                 setup_script: Optional[str] = None,
                 python: str = sys.executable):
        self.hosts = dict(hosts)
        self.registry_root = registry_root
        self.run_name = run_name
        self.setup_script = setup_script
        self.python = python
        self.results: Dict[str, Tuple[int, str]] = {}

    def _worker_command(self, worker_id: str) -> List[str]:
        return [self.python, "-m",
                "deeplearning4j_tpu_torch.scaleout.launcher", "worker",
                "--registry", self.registry_root,
                "--run", self.run_name, "--worker-id", worker_id]

    def _provision_one(self, worker_id: str, transport: Transport,
                       detach: bool) -> None:
        try:
            prov = HostProvisioner(transport, host=worker_id)
            if self.setup_script:
                rc, out = prov.upload_and_run(self.setup_script)
                if rc != 0:
                    raise RuntimeError(f"setup script failed ({rc}): {out}")
            self.results[worker_id] = transport.run(
                self._worker_command(worker_id), detach=detach)
        except Exception as e:  # noqa: BLE001 — per-host isolation
            log.exception("provisioning %s failed", worker_id)
            self.results[worker_id] = (-1, str(e))

    def provision_workers(self, detach: bool = True) -> Dict[str, Tuple[int, str]]:
        """Parallel provisioning fan-out (reference provisionWorkers —
        Futures per host). Returns worker-id -> (rc, output/pid)."""
        threads = [
            threading.Thread(target=self._provision_one,
                             args=(wid, t, detach), daemon=True)
            for wid, t in self.hosts.items()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return dict(self.results)
