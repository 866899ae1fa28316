"""Spawned-process-group management shared by every subsystem that
launches sibling processes (the serving fleet's `ReplicaSpawner`, the
training supervisor's `WorkerSpawner`). A copy of the JAX package's
module: the port imports nothing of that package.

The pid/pgid-recycling-sensitive logic lives here ONCE:

- **Orphan sweep**: every spawn runs in its own session/process group
  (`start_new_session=True`) and registers here; a single atexit hook
  SIGKILLs whatever the owner never reaped, so a crash-exiting parent
  cannot leak live children holding ports. The sweep uses
  ``killpg(proc.pid)`` directly — never ``os.getpgid()``, which fails
  once the leader is reaped even while grandchildren keep the group
  (and their ports) alive; killpg works as long as ANY member lives.
- **Group stop** (`stop_process_group`): the group sweep runs BEFORE
  the leader is reaped — the un-reaped leader (alive or zombie) pins
  pid == pgid, so the sweep can never hit a recycled pid. After a
  reap, an emptied group's id is free for reuse and a blind killpg
  could SIGKILL an unrelated process group — so an already-reaped
  leader is only waited on, never group-swept.
- **Incarnation handoff** (`release_spawned` + `AdoptedProc`): a
  crash-safe control plane (utils/statefile.py journal) hands its live
  children to its NEXT incarnation instead of sweeping them — the
  exiting incarnation `release_spawned`s them (scoping the atexit
  sweep to processes the CURRENT incarnation still owns), and the
  restarted one re-adopts each journaled child as an `AdoptedProc`.
  An adopted child is NOT our waitpid-able child (it re-parented to
  init when its first parent died), so every signal/poll verifies
  **pid + start-time** (`pid_matches`) — a recycled pid must never be
  signalled, swept, or mistaken for a surviving worker.
"""

from __future__ import annotations

import atexit
import os
import signal
import subprocess
import threading
import time
from typing import Optional, Tuple

__all__ = ["register_spawned", "unregister_spawned", "release_spawned",
           "kill_spawned_orphans", "stop_process_group",
           "proc_start_time", "pid_matches", "classify_pid",
           "AdoptedProc", "SPAWNED_PROCS"]

#: spawned session-leader processes still alive (shared registry)
SPAWNED_PROCS: set = set()
_lock = threading.Lock()
_atexit_armed = False


def register_spawned(proc) -> None:
    global _atexit_armed
    with _lock:
        SPAWNED_PROCS.add(proc)
        if not _atexit_armed:
            atexit.register(kill_spawned_orphans)
            _atexit_armed = True


def unregister_spawned(proc) -> None:
    with _lock:
        SPAWNED_PROCS.discard(proc)


def release_spawned(proc) -> None:
    """Hand a live child to the NEXT control-plane incarnation: remove
    it from the atexit sweep WITHOUT stopping it. The caller must have
    journaled (pid, start_time) so the successor can re-adopt it —
    an unjournaled release is a leak."""
    unregister_spawned(proc)


def kill_spawned_orphans() -> None:
    """SIGKILL every registered group (what atexit runs). Only
    processes the current incarnation still OWNS are here — released
    (handed-off) children were unregistered and survive."""
    with _lock:
        procs = list(SPAWNED_PROCS)
        SPAWNED_PROCS.clear()
    for proc in procs:
        if isinstance(proc, AdoptedProc) and proc.poll() is not None:
            continue  # dead or recycled: a blind killpg could hit a stranger
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (OSError, ProcessLookupError):
            if proc.poll() is None:
                try:
                    proc.kill()
                except OSError:
                    pass


# ------------------------------------------------------ pid verification
def _proc_stat(pid: int) -> Optional[Tuple[str, int]]:
    """(state, starttime) from /proc/<pid>/stat, or None when the pid
    is gone or /proc is unavailable. The comm field may contain spaces
    and parens — parse from the LAST ')'."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            raw = f.read().decode("ascii", errors="replace")
    except OSError:
        return None
    try:
        rest = raw[raw.rindex(")") + 2:].split()
        # rest[0] is field 3 (state); field 22 (starttime) is rest[19]
        return rest[0], int(rest[19])
    except (ValueError, IndexError):
        return None


def proc_start_time(pid: int) -> Optional[int]:
    """Kernel start time (clock ticks since boot) of `pid`, or None.
    Journaled next to the pid so a restart can tell a surviving child
    from a recycled pid wearing its number."""
    stat = _proc_stat(pid)
    return stat[1] if stat is not None else None


def pid_matches(pid: int, start_time: Optional[int]) -> bool:
    """True iff `pid` names a LIVE process that is the same incarnation
    the journal recorded: alive (and not a zombie) AND, when a start
    time was journaled, carrying that exact start time. A pid alone is
    never proof — pids recycle."""
    if pid is None or pid <= 0:
        return False
    stat = _proc_stat(pid)
    if stat is None:
        # /proc unavailable (non-Linux): fall back to a signal-0 probe,
        # but only when there is no fingerprint to contradict
        if start_time is not None:
            return False
        try:
            os.kill(pid, 0)
            return True
        except ProcessLookupError:
            return False
        except PermissionError:
            return True
        except OSError:
            return False
    state, actual_start = stat
    if state in ("Z", "X", "x"):
        return False  # a zombie is a dead process wearing its pid
    if start_time is None:
        return True
    return int(start_time) == actual_start


def classify_pid(pid, start_time) -> str:
    """Adoption verdict for one journaled child — the ONE
    classification both control planes (supervisor and fleet) apply to
    every entry on restart:

    - ``"adopted"``: alive and wearing the journaled fingerprint —
      safe to re-adopt.
    - ``"recycled"``: alive but the start time disagrees — a stranger
      wearing the number; never signalled, only replaced.
    - ``"dead"``: nobody home (or an unusable pid).
    """
    if not pid:
        return "dead"
    pid = int(pid)
    if pid_matches(pid, start_time):
        return "adopted"
    return "recycled" if pid_matches(pid, None) else "dead"


class AdoptedProc:
    """Popen-shaped handle for a re-adopted child of a PREVIOUS
    control-plane incarnation.

    Not our waitpid-able child — when the first parent died the kernel
    re-parented it to init — so ``poll()`` is a /proc liveness check
    against the journaled (pid, start_time) fingerprint, ``wait()``
    polls, and every signal verifies the fingerprint first so a
    recycled pid is never touched. ``pid == pgid`` still holds (the
    child was spawned as its own session leader), so the shared
    group-kill discipline (`stop_process_group`) works unchanged."""

    #: returncode reported once the process is observed gone — the real
    #: exit status died with the first parent, so this is a sentinel
    UNKNOWN_RC = -257

    def __init__(self, pid: int, start_time: Optional[int] = None):
        self.pid = int(pid)
        self.start_time = (int(start_time) if start_time is not None
                           else proc_start_time(self.pid))
        self.returncode: Optional[int] = None
        self.adopted = True

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        if pid_matches(self.pid, self.start_time):
            return None
        self.returncode = self.UNKNOWN_RC
        return self.returncode

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else (
            time.monotonic() + timeout)
        while self.poll() is None:
            if deadline is not None and time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired(
                    cmd=f"adopted-pid-{self.pid}", timeout=timeout)
            time.sleep(0.02)
        return self.returncode

    def send_signal(self, sig: int) -> None:
        if self.poll() is None:  # fingerprint-verified before any kill
            os.kill(self.pid, sig)

    def terminate(self) -> None:
        self.send_signal(signal.SIGTERM)

    def kill(self) -> None:
        self.send_signal(signal.SIGKILL)

    def __repr__(self) -> str:
        return (f"AdoptedProc(pid={self.pid}, "
                f"start_time={self.start_time}, rc={self.returncode})")


def stop_process_group(proc, timeout: float = 10.0,
                       term_first: bool = True) -> None:
    """Terminate a spawned process and its whole group, then reap and
    unregister it. ``term_first=False`` goes straight to SIGKILL (for
    hung/SIGSTOP'd members that will never honor SIGTERM). Accepts a
    Popen or an `AdoptedProc` — for an adopted handle, poll() is the
    fingerprint check, so a recycled pid is never group-killed."""
    if proc.poll() is None:
        sig = signal.SIGTERM if term_first else signal.SIGKILL
        try:
            os.killpg(proc.pid, sig)
        except (OSError, ProcessLookupError):
            proc.send_signal(sig)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (OSError, ProcessLookupError):
                proc.kill()
            proc.wait(timeout=timeout)
    else:
        proc.wait()  # reaped or zombie: collect; group id is NOT swept
    unregister_spawned(proc)
