"""Rank launcher for the multi-rank tests and the card's smoke: the
port's stand-in for the JAX package's 8-device virtual mesh
(`tests/conftest.py`), which torch cannot reproduce in one process.

`run_ranks(fn, n, *args)` starts `n` processes, joins them into one
`torch.distributed` job through `parallel.multihost.initialize` on a
free local port, calls `fn(rank, *args)` in each and returns the ranks'
results in rank order. A rank that raises fails the group: every rank
is killed and `RankError` carries the first traceback. The group has a
hard time limit; a group still running at it is killed and raises
`RankError` too.

Start methods: `fork` (the CPU tests: `fn` may be a closure, and the
group starts in about 0.1 s) sets `torch.set_num_threads(1)` first in
the child, since a forked child hangs in its first matrix product if
the parent had already used its OpenMP pool; `spawn` for ranks that
touch CUDA (a forked child cannot initialise it), where `fn` and
`args` must pickle. Results travel back pickled: return numpy arrays
and plain values, not CUDA tensors.

This is no user feature and no trainer calls it.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
import time
import traceback
import warnings
from multiprocessing.connection import wait
from typing import Any, Callable, List, Optional

__all__ = ["run_ranks", "RankError", "free_port"]


class RankError(RuntimeError):
    """A rank failed or the group overran its time limit."""


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child(conn, fn, rank: int, n: int, port: int, timeout: float,
           threads: Optional[int], args, kwargs) -> None:
    import torch

    if threads is not None:
        torch.set_num_threads(threads)
    try:
        from deeplearning4j_tpu_torch.parallel import multihost

        multihost.initialize(f"127.0.0.1:{port}", n, rank, timeout=timeout)
        result = fn(rank, *args, **kwargs)
        _leave_together()
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


def _leave_together() -> None:
    """A barrier on the job's default group before a rank exits. Groups
    made in `fn` connect every pair of ranks, and a rank that finished
    first and closed its sockets would reset a slower peer's handshake
    still under way ("Gloo connectFullMesh failed ... Connection closed
    by peer"): a rank with little to do after its last group (a trainer
    that only checks its arguments) otherwise fails its group under
    load."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def _fork_main(conn, *a) -> None:
    try:
        _child(conn, *a)
    finally:
        # a forked child must not run the parent's exit handlers
        os._exit(0)


def run_ranks(fn: Callable[..., Any], n: int, *args, start: str = "fork",
              timeout: float = 120.0, **kwargs) -> List[Any]:
    """Run `fn(rank, *args, **kwargs)` on `n` ranks of one job; return
    the results in rank order. `timeout` bounds the whole group. A group
    whose coordinator port was taken between `free_port` and its bind
    (another group starting at the same moment) runs once more on a new
    port."""
    try:
        return _run_group(fn, n, args, kwargs, start, timeout)
    except RankError as e:
        if "Address already in use" not in str(e):
            raise
    return _run_group(fn, n, args, kwargs, start, timeout)


def _run_group(fn, n, args, kwargs, start, timeout) -> List[Any]:
    ctx = mp.get_context(start)
    port = free_port()
    threads = 1 if start == "fork" else None
    procs, conns = [], []
    target = _fork_main if start == "fork" else _child
    for rank in range(n):
        parent, child = ctx.Pipe(duplex=False)
        p = ctx.Process(target=target, args=(
            child, fn, rank, n, port, timeout, threads, args, kwargs),
            daemon=True)
        with warnings.catch_warnings():
            # the fork of a threaded parent is deliberate: the child
            # touches no parent thread's state and runs single-threaded
            warnings.filterwarnings("ignore", message=".*fork\\(\\)")
            p.start()
        child.close()
        procs.append(p)
        conns.append(parent)
    results: List[Any] = [None] * n
    pending = dict(zip(conns, range(n)))
    deadline = time.monotonic() + timeout
    try:
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RankError(
                    f"rank group of {n} overran its {timeout:g} s limit; "
                    f"ranks {sorted(pending.values())} had not finished")
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
            p.join(max(1.0, deadline - time.monotonic()))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        for c in conns:
            c.close()
