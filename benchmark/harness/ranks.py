"""The benchmark's own rank launcher (after the port's
`testing/ranks.py`, which the yardstick does not depend on).

`run_ranks(fn, n, *args)` spawns `n` processes, joins them into one
`torch.distributed` job on a free local TCP port (the port's
`parallel.multihost.initialize`), calls `fn(rank, *args)` in each and
returns their results in rank order. A rank that raises fails the group
and every rank is killed; so is a group that overruns `timeout`. Every
process started is waited for before this returns."""

from __future__ import annotations

import multiprocessing as mp
import socket
import time
import traceback
from multiprocessing.connection import wait


class RankError(RuntimeError):
    """A rank failed or the group overran its time limit."""


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child(conn, fn, rank, n, port, timeout, args, threads) -> None:
    if threads is not None:
        # a forked child hangs in its first product if the parent had
        # already used its OpenMP pool
        import torch

        torch.set_num_threads(threads)
    try:
        from deeplearning4j_tpu_torch.parallel import multihost

        multihost.initialize(f"127.0.0.1:{port}", n, rank, timeout=timeout)
        result = fn(rank, *args)
        import torch.distributed as dist

        dist.barrier()
        conn.send(("ok", result))
    except Exception:  # noqa: BLE001 - relayed to the parent
        conn.send(("error", traceback.format_exc()))
    finally:
        try:
            from deeplearning4j_tpu_torch.parallel import multihost

            multihost.shutdown()
        except Exception:  # noqa: BLE001
            pass
        conn.close()


class Group:
    """Ranks started by `start_ranks`; `wait()` gathers their results."""

    def __init__(self, procs, conns, n, timeout):
        self.procs, self.conns, self.n = procs, conns, n
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def wait(self) -> list:
        n, procs = self.n, self.procs
        results = [None] * n
        pending = dict(zip(self.conns, range(n)))
        try:
            while pending:
                left = self.deadline - time.monotonic()
                if left <= 0:
                    raise RankError(
                        f"rank group of {n} overran {self.timeout:g} s; "
                        f"ranks {sorted(pending.values())} running")
                for conn in wait(list(pending), timeout=left):
                    rank = pending.pop(conn)
                    try:
                        status, payload = conn.recv()
                    except EOFError:
                        raise RankError(
                            f"rank {rank} died without a result (exit code "
                            f"{procs[rank].exitcode})") from None
                    if status != "ok":
                        raise RankError(f"rank {rank} failed:\n{payload}")
                    results[rank] = payload
            for p in procs:
                p.join(max(1.0, self.deadline - time.monotonic()))
            return results
        finally:
            self.stop()

    def stop(self) -> None:
        """Kill what still runs and wait for every process."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        for c in self.conns:
            c.close()


def start_ranks(fn, n: int, *args, timeout: float = 300.0,
                start: str = "spawn") -> Group:
    """Start the group; `fn(rank, *args)` runs in each rank."""
    ctx = mp.get_context(start)
    port = free_port()
    procs, conns = [], []
    for rank in range(n):
        parent, child = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_child, args=(
            child, fn, rank, n, port, timeout, args,
            1 if start == "fork" else None), daemon=True)
        p.start()
        child.close()
        procs.append(p)
        conns.append(parent)
    return Group(procs, conns, n, timeout)


def run_ranks(fn, n: int, *args, timeout: float = 300.0,
              start: str = "spawn") -> list:
    return start_ranks(fn, n, *args, timeout=timeout, start=start).wait()
