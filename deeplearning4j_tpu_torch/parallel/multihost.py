"""Multi-process bootstrap, the counterpart of the JAX package's
`parallel/multihost.py`.

Every rank is one process running the same program (as the JAX
package's multi-host worker is). `initialize` joins this process to a
`torch.distributed` job over TCP: process 0 binds the coordinator
address, every other process first probes it (the same fail-fast probe
as the JAX package's, so a dead coordinator is a bounded, catchable
error naming the address) and then joins, the join itself bounded by
`timeout`. The default process group is gloo: it carries the host-side
exchanges and group creation, and `parallel.mesh.make_mesh` builds the
groups the collectives run in, NCCL on the card.

`global_data_mesh`, `process_info` and `local_batch_slice` are the JAX
package's, over ranks: on a torch job one process drives one device, so
the local device count is 1.
"""

from __future__ import annotations

import datetime
import logging
import time
from typing import Dict, Optional

log = logging.getLogger(__name__)

__all__ = ["initialize", "shutdown", "global_data_mesh", "process_info",
           "local_batch_slice"]


def _wait_for_coordinator(coordinator_address: str, process_id: int,
                          num_processes: int, timeout: float,
                          retries: int, backoff: float) -> None:
    """Probe the coordinator's TCP port before joining, so a dead
    coordinator raises here instead of hanging in the rendezvous. Each
    attempt polls the port for up to `timeout` seconds (a coordinator
    still starting); attempts back off exponentially."""
    import socket

    host, _, port_s = coordinator_address.rpartition(":")
    # bracketed IPv6 ("[::1]:1234"): sockets want the bare host
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(
            f"coordinator_address must be host:port, got "
            f"{coordinator_address!r}") from None
    attempt = 0
    last_err: Optional[Exception] = None
    while True:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                with socket.create_connection(
                        (host or "127.0.0.1", port),
                        timeout=max(0.1, min(2.0, timeout))):
                    return
            except OSError as e:  # refused (instant) or unreachable
                last_err = e
                time.sleep(min(0.5, timeout / 4))
        attempt += 1
        if attempt > retries:
            raise RuntimeError(
                f"could not join the torch.distributed job as process "
                f"{process_id}/{num_processes}: coordinator "
                f"{coordinator_address} did not respond within "
                f"{timeout:g}s ({attempt} attempt(s)); is the coordinator "
                f"process up and the address reachable? "
                f"[{last_err}]") from last_err
        delay = backoff * (2 ** (attempt - 1))
        log.warning(
            "coordinator %s unreachable (attempt %d/%d: %s); retrying "
            "in %.1fs", coordinator_address, attempt, retries + 1,
            last_err, delay)
        time.sleep(delay)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *, timeout: float = 300.0,
               retries: int = 0, backoff: float = 2.0) -> None:
    """Join this process to the job as rank `process_id` of
    `num_processes`, the coordinator at `coordinator_address`
    ("host:port", served by process 0). Call once per process.

    Non-coordinator processes probe the coordinator first (up to
    `retries` + 1 attempts of `timeout` seconds, exponential `backoff`
    between them); the join itself is bounded by `timeout` too."""
    import torch.distributed as dist

    if process_id != 0:  # process 0 IS the coordinator: it binds the port
        _wait_for_coordinator(coordinator_address, process_id,
                              num_processes, timeout, retries, backoff)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=max(1.0, timeout)))
    log.info("joined torch.distributed job: process %d/%d", process_id,
             num_processes)


def shutdown() -> None:
    """Leave the job (destroys every process group)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def global_data_mesh(axis: str = "data", device=None):
    """One data axis over every rank of the job."""
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    return make_mesh({axis: -1}, device=device)


def process_info() -> Dict[str, int]:
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": n,
        "local_devices": 1,
        "global_devices": n,
    }


def local_batch_slice(n: int, process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> slice:
    """This process's contiguous share of a global batch of n examples.
    n must divide evenly by the process count."""
    info = process_info()
    pi = info["process_index"] if process_index is None else process_index
    pc = info["process_count"] if process_count is None else process_count
    if n % pc:
        raise ValueError(f"global batch {n} not divisible by "
                         f"{pc} processes")
    per = n // pc
    return slice(pi * per, (pi + 1) * per)
