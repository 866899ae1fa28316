"""Durable control-plane journal: one crash-atomic JSON state file.

The checkpoint layer (checkpoint/format.py) made PARAMETERS survive any
crash with one idiom — write a temp file, fsync it, publish with an
atomic ``os.replace`` so a reader only ever sees the previous committed
state or the new one, never a torn write. This module applies the same
idiom to the CONTROL PLANE's own state: the training supervisor and the
serving fleet journal their membership (child pid/pgid/start-time,
generation, replica endpoints, incarnation) through a ``StateFile`` at
every transition, so a restarted incarnation can re-adopt the live
children its predecessor left behind (docs/FAULT_TOLERANCE.md "Who
watches the watcher").

Crash-atomicity contract:

- ``write()`` serializes to ``<path>.tmp``, fsyncs, then ``os.replace``s
  onto ``<path>``. A crash before the rename leaves the PREVIOUS
  committed state readable; a crash after it leaves the new one. There
  is no third outcome on a POSIX filesystem.
- ``read()`` returns the committed dict, or ``None`` when the file is
  missing — or unreadable (external corruption): a torn journal must
  degrade to the next rung of the failure ladder (elastic resume /
  fresh spawn), never crash the restarted control plane. ``torn`` is
  True after a read that found bytes it could not parse.
- Writers inject faults through the chaos layer: each ``StateFile``
  carries a named injection point (``supervisor.journal`` /
  ``fleet.journal``) hit once before the temp write (``op="write"``)
  and once before the commit rename (``op="rename"``) — the
  crash-at-every-ordinal drills in tests/test_controlplane.py.

Telemetry (docs/OBSERVABILITY.md): ``dl4j_controlplane_journal_writes``,
``dl4j_controlplane_journal_write_seconds`` (whole operation) and
``dl4j_controlplane_journal_commit_seconds`` (fsync + rename) — all
labelled by ``plane``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.testing import chaos

__all__ = ["StateFile", "controlplane_metrics"]

log = logging.getLogger(__name__)


def controlplane_metrics(plane: str, name: str, incarnation_fn,
                         kinds) -> tuple:
    """The `dl4j_controlplane_*` series both control planes register —
    ONE definition so metric names, help text, and label-name sets
    (`plane`, `name`; `kind` on adoptions) can never drift between the
    supervisor and the fleet. Returns (restarts_counter,
    {kind: adoptions_counter}); the incarnation gauge reads
    `incarnation_fn` at scrape (pass a weakref-safe callable)."""
    from deeplearning4j_tpu_torch import telemetry

    reg = telemetry.get_registry()
    cp = {"plane": plane, "name": name}
    restarts = reg.counter(
        "dl4j_controlplane_restarts",
        "control-plane incarnations that started on top of a prior "
        "journal").labels(**cp)
    adoptions = {
        kind: reg.counter(
            "dl4j_controlplane_adoptions",
            "journaled/announced children processed by a restarted "
            "control plane, by outcome").labels(kind=kind, **cp)
        for kind in kinds}
    reg.gauge(
        "dl4j_controlplane_incarnation",
        "control-plane incarnation number (0 = never restarted over "
        "a journal)").labels(**cp).set_function(incarnation_fn)
    return restarts, adoptions


class StateFile:
    """One crash-atomic JSON state file (the control-plane journal)."""

    def __init__(self, path: str, *, point: Optional[str] = None,
                 plane: Optional[str] = None):
        self.path = str(path)
        #: chaos injection point name (e.g. "supervisor.journal"); None
        #: disables fault injection for this file
        self.point = point
        self.plane = plane or (point.split(".", 1)[0] if point
                               else "statefile")
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        #: True when the last read() found a file it could not parse —
        #: distinguishes "no journal" (fresh start) from "torn journal"
        #: (fall back, and treat unknown children as adopt-or-kill)
        self.torn = False
        reg = None
        try:
            from deeplearning4j_tpu_torch import telemetry

            reg = telemetry.get_registry()
        except Exception:  # telemetry must never gate durability
            pass
        lab = {"plane": self.plane}
        self._m_writes = reg.counter(
            "dl4j_controlplane_journal_writes",
            "control-plane journal commits").labels(**lab) \
            if reg else None
        self._m_write_s = reg.histogram(
            "dl4j_controlplane_journal_write_seconds",
            "journal write wall time (serialize + commit)").labels(
                **lab) if reg else None
        self._m_commit_s = reg.histogram(
            "dl4j_controlplane_journal_commit_seconds",
            "journal commit portion (fsync + atomic rename)").labels(
                **lab) if reg else None

    # ---------------------------------------------------------------- write
    def write(self, state: Dict[str, Any]) -> str:
        """Commit `state` atomically. Raises on IO/injected faults — the
        caller decides whether a failed journal write is fatal (the
        control planes log and continue on the previous committed
        state; losing a journal write can only make a restart fall back
        one ladder rung, never corrupt it)."""
        t0 = time.perf_counter()
        if self.point is not None:
            chaos.hit(self.point, op="write")
        tmp = self.path + ".tmp"
        data = json.dumps(state, sort_keys=True)
        with open(tmp, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        t_commit = time.perf_counter()
        try:
            if self.point is not None:
                chaos.hit(self.point, op="rename")
            os.replace(tmp, self.path)
        except BaseException:
            # an aborted commit must not leave a stale tmp that a later
            # write would fsync-over confusingly
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        now = time.perf_counter()
        if self._m_writes is not None:
            self._m_writes.inc()
            self._m_write_s.observe(now - t0)
            self._m_commit_s.observe(now - t_commit)
        return self.path

    def try_write(self, state: Dict[str, Any]) -> bool:
        """`write()` with the control planes' shared failure policy:
        log and continue on the previous committed state. Losing a
        journal write can only make a restart fall back one ladder
        rung (it adopts slightly older membership and the pid
        fingerprints reject whatever changed) — it must never take the
        running control plane down."""
        try:
            self.write(state)
            return True
        except Exception:
            log.exception(
                "journal write to %s failed (continuing on the "
                "previous committed state)", self.path)
            return False

    # ----------------------------------------------------------------- read
    def read(self) -> Optional[Dict[str, Any]]:
        """The committed state, or None (missing OR torn — check
        ``self.torn`` to tell them apart)."""
        self.torn = False
        try:
            with open(self.path) as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        except OSError as e:
            log.warning("journal %s unreadable: %s", self.path, e)
            self.torn = True
            return None
        try:
            state = json.loads(raw)
        except ValueError:
            log.warning("journal %s is torn (unparsable); falling back",
                        self.path)
            self.torn = True
            return None
        if not isinstance(state, dict):
            self.torn = True
            return None
        return state

    # ---------------------------------------------------------------- clear
    def clear(self) -> None:
        """Remove the journal (a cleanly-finished run hands nothing to
        the next incarnation)."""
        for path in (self.path, self.path + ".tmp"):
            try:
                os.unlink(path)
            except OSError:
                pass

    def exists(self) -> bool:
        return os.path.exists(self.path)
