"""Training guardian: in-step fault defense, rollback, autosave,
preemption; the counterpart of the JAX package's `optimize/guardian.py`.

Three tiers, as in the JAX package:

1. **On-device guarded commit** (`all_finite` + `guarded_update`): the
   step reduces an all-leaves-finite predicate over the gradients and
   the loss to one 0-d bool tensor ON THE DEVICE (`torch.isfinite` of
   every element, as `jnp.isfinite`) and commits the update through
   `torch.where(ok, new, old)`: a non-finite step is skipped (params,
   updater state and the updater's iteration counter all keep their old
   values) and a device-side skip counter increments. Nothing is read
   back to the host. With no fault a guarded step gives the unguarded
   step's params bit for bit: the update is `p - u * lr_scale`, and at
   scale 1.0 that is the same subtraction as the unguarded `p -= u`.
2. **Host-side escalation ladder** (`GuardianPolicy` /
   `GuardianSession`): a last-good (params, updater state) snapshot is
   kept ON THE DEVICE (clones, no host round trip), refreshed every
   `snapshot_every` steps; every `check_every` steps the session reads
   two scalars (skip counter, score) and walks the ladder

       skip step  ->  rollback to last-good + LR backoff  ->  abort

   Persistent skips or a score blow-up (`DivergenceCondition`) restore
   the snapshot and multiply the step's `lr_scale` (a 0-d device
   tensor) by `lr_backoff`; after `max_rollbacks` rollbacks the session
   raises `GuardianAbort` carrying a report and the last-good state.
3. **Autosave + preemption flush** (`TrainingGuard`): `checkpoint_every=`
   on `fit` / `fit_scan` saves a resumable checkpoint (params, updater
   state, iterator cursor) through the rotating `DefaultModelSaver`, or
   through a `checkpoint.ShardedModelSaver` whose async writer leaves
   the step loop only the device-to-host snapshot. A SIGTERM handler
   defers to the next step boundary, flushes a final checkpoint
   (synchronously: the process is dying) and raises `TrainingPreempted`
   with its path. `signal.signal` works only on the main thread; from
   another thread `request_preemption()` does the same.

Guardian events (skips, rollbacks, saves, aborts) reach any listener
with a `guardian_event(model, event)` hook
(`optimize.listeners.GuardianListener` / `CollectGuardianEvents`), and
count in the `dl4j_guardian_events{kind=}` telemetry series, every
kind registered at 0 so a scrape sees it before the first fault.

Inside explicit per-rank code (the parallel trainers) `all_finite(
axis_name=...)` all-reduces the not-finite indicator over that axis of
the current mesh (`with mesh:`), so one rank's NaN vetoes the commit on
every rank; `make_guard(save_fn=)` lets a trainer save its own way (the
ZeRO-1 trainer gathers its flat optimizer state first).
"""

from __future__ import annotations

import logging
import signal as _signal
import threading
from collections import deque
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch import default_device, telemetry
from deeplearning4j_tpu_torch.optimize.terminations import DivergenceCondition

log = logging.getLogger(__name__)

# every guardian event flows through TrainingGuard._emit, so one counter
# covers skips/rollbacks/aborts/autosaves/preemptions; the known kinds
# are pre-seeded at 0 so a scrape sees the series before the first fault
_M_EVENTS = telemetry.counter(
    "dl4j_guardian_events", "guardian escalation/autosave events by kind")
for _kind in ("skip", "rollback", "abort", "autosave", "preempt"):
    _M_EVENTS.labels(kind=_kind)

__all__ = [
    "GuardianState", "guardian_state", "all_finite", "commit", "advance",
    "apply_lr_scale", "guarded_update", "GuardianEvent", "GuardianAbort",
    "TrainingPreempted", "GuardianPolicy", "GuardianSession",
    "TrainingGuard", "make_guard",
]


# ===================================================================== device
class GuardianState(NamedTuple):
    """Per-run guardian carry on the device: `skipped` counts
    non-committed steps (0-d int32); `lr_scale` rescales committed
    updates (0-d float32, the rollback backoff)."""

    skipped: torch.Tensor
    lr_scale: torch.Tensor


def guardian_state(lr_scale: float = 1.0, device=None) -> GuardianState:
    """A fresh carry on `device` (None = the CUDA device)."""
    device = default_device(device)
    return GuardianState(
        skipped=torch.zeros((), dtype=torch.int32, device=device),
        # a fill, not a host-to-device copy: no sync on a CUDA device
        lr_scale=torch.full((), lr_scale, dtype=torch.float32,
                            device=device))


def _tensor_leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return []


def all_finite(score, *trees, axis_name: Optional[str] = None):
    """0-d bool device tensor: True iff `score` and every element of
    every tensor leaf of `trees` is finite (`torch.isfinite`, no norm
    shortcut, which would overflow on large finite values). No host
    sync.

    Inside explicit per-rank code pass `axis_name` (an axis, or a tuple
    of axes, of the current mesh, `with mesh:`): the not-finite indicator
    is summed over it, so one rank's NaN vetoes the commit everywhere and
    every rank commits or skips together."""
    leaves = ([score] if score is not None else []) + [
        t for tree in trees for t in _tensor_leaves(tree)]
    if not leaves:
        ok = torch.tensor(True)
    else:
        ok = torch.stack([torch.isfinite(t).all() for t in leaves]).all()
    if axis_name is not None:
        from deeplearning4j_tpu_torch.parallel import collectives
        from deeplearning4j_tpu_torch.parallel.mesh import current_mesh

        mesh = current_mesh()
        bad = torch.logical_not(ok).to(torch.int32).reshape(1).to(
            mesh.device)
        ok = collectives.all_reduce_(bad, mesh, axis_name)[0] == 0
    return ok


def commit(ok, old, new, out=None):
    """Per-leaf guarded select, `new` where the step is clean, `old`
    where it must be skipped, over matching tensors, dicts, lists and
    (named) tuples. A `where`, not a blend: x * 0 does not clear a NaN.
    `out`, a matching tree, takes the result in place (the network's
    live tensors); else new tensors are returned."""
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old, out=out)
    pick = (lambda k: None) if out is None else (lambda k: out[k])
    if isinstance(new, dict):
        return {k: commit(ok, old[k], new[k], pick(k)) for k in new}
    if isinstance(new, (list, tuple)):
        items = [commit(ok, old[i], new[i], pick(i))
                 for i in range(len(new))]
        if hasattr(new, "_fields"):
            return type(new)(*items)
        return type(new)(items)
    return new


def advance(gstate: GuardianState, ok) -> GuardianState:
    """The skip counter +1 when the step was NOT committed."""
    return GuardianState(
        skipped=gstate.skipped + torch.logical_not(ok).to(torch.int32),
        lr_scale=gstate.lr_scale)


def apply_lr_scale(updates, gstate: GuardianState):
    """Each update tensor times the backoff factor, in the update's own
    dtype (a bf16 update is not promoted to float32); a list or a table
    {layer -> {name -> tensor}}."""
    if isinstance(updates, dict):
        return {k: apply_lr_scale(v, gstate) for k, v in updates.items()}
    if isinstance(updates, torch.Tensor):
        return updates * gstate.lr_scale.to(updates.dtype)
    return [u * gstate.lr_scale.to(u.dtype) for u in updates]


@torch.no_grad()
def guarded_update(params, upd_state, updates, new_state,
                   gstate: GuardianState, score, grads,
                   axis_name: Optional[str] = None):
    """The whole guarded commit over tables: the lr-scaled update applied
    where the step is clean, the old values where it must be skipped,
    the skip counter advanced. Returns (params, upd_state, gstate), new
    tensors; nothing is changed in place. (The network's train step does
    the same in place on its live tensors, `MultiLayerNetwork.
    _guarded_train_step`.)"""
    ok = all_finite(score, grads, axis_name=axis_name)
    scaled = apply_lr_scale(updates, gstate)
    new_params = {k: {n: p - scaled[k][n] for n, p in t.items()}
                  for k, t in params.items()}
    return (commit(ok, params, new_params), commit(ok, upd_state, new_state),
            advance(gstate, ok))


def _device_copy(tree):
    """A copy of a tree of device tensors, on the device (the snapshot
    and rollback primitive): fresh tensors, so the live ones may keep
    changing in place."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if hasattr(tree, "_fields"):
        return type(tree)(*(_device_copy(v) for v in tree))
    if isinstance(tree, dict):
        return {k: _device_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_device_copy(v) for v in tree)
    return tree


# ====================================================================== events
class GuardianEvent(NamedTuple):
    """kind: skip | rollback | abort | autosave | preempt. `step` is the
    guardian's step count at emit time; `info` carries kind-specific
    detail (counts, scores, checkpoint path)."""

    kind: str
    step: int
    info: dict


class GuardianAbort(RuntimeError):
    """The escalation ladder ran out of rollbacks. `report` is the
    diagnostic dict (steps, skips, rollbacks, scores, lr scale);
    `last_good` is the last-good (device) state tuple the network was
    restored to before raising."""

    def __init__(self, report: dict, last_good=None):
        super().__init__(f"guardian abort after {report.get('rollbacks')} "
                         f"rollbacks: {report}")
        self.report = report
        self.last_good = last_good


class TrainingPreempted(RuntimeError):
    """SIGTERM (or an explicit `request_preemption`) arrived mid-fit; a
    final checkpoint was flushed to `path` at batch `position` before
    raising."""

    def __init__(self, path: Optional[str], position: int):
        super().__init__(
            f"training preempted at batch {position}; "
            f"checkpoint flushed to {path!r}")
        self.path = path
        self.position = position


# ====================================================================== policy
class GuardianPolicy:
    """Host-side guardian configuration (one policy may serve many runs;
    per-run state lives in the `GuardianSession` a `TrainingGuard`
    builds from it).

    Parameters
    ----------
    check_every : read the skip counter + score every N guarded train
        steps, i.e. batches; a guarded fit_scan observes once per epoch
        but advances the counter by that epoch's batch count (two scalar
        reads, the ONLY host syncs the guardian adds).
    snapshot_every : refresh the on-device last-good snapshot every N
        steps (only at healthy check boundaries).
    max_skips_per_window : skipped steps within one check window that
        escalate from skip to rollback.
    lr_backoff : multiply the step's lr_scale by this on every rollback.
    max_rollbacks : rollbacks after which the session raises
        `GuardianAbort`.
    divergence : a `TerminationCondition` judging (new_score,
        best_recent_score); default `DivergenceCondition()`. Checked only
        in windows with zero skips (a skipped step's score is untrusted).
    divergence_window : rolling score window the best-recent is drawn
        from.
    listeners : objects with `guardian_event(model, event)`; the owning
        network's listeners with that hook are notified too.
    """

    def __init__(self, check_every: int = 10, snapshot_every: int = 50,
                 max_skips_per_window: int = 3, lr_backoff: float = 0.5,
                 max_rollbacks: int = 3, divergence=None,
                 divergence_window: int = 20,
                 listeners: Sequence = ()):
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        if snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1, got {snapshot_every}")
        if not 0.0 < lr_backoff <= 1.0:
            raise ValueError(f"lr_backoff must be in (0, 1], got {lr_backoff}")
        if max_skips_per_window < 1:
            # 0 would make every healthy window (delta == 0) roll back
            raise ValueError(
                f"max_skips_per_window must be >= 1, got "
                f"{max_skips_per_window}")
        if max_rollbacks < 0:
            raise ValueError(
                f"max_rollbacks must be >= 0, got {max_rollbacks}")
        self.check_every = check_every
        self.snapshot_every = snapshot_every
        self.max_skips_per_window = max_skips_per_window
        self.lr_backoff = lr_backoff
        self.max_rollbacks = max_rollbacks
        self.divergence = divergence if divergence is not None \
            else DivergenceCondition()
        self.divergence_window = divergence_window
        self.listeners = list(listeners)

    def session(self, emit: Callable[[str, int, dict], None], device=None
                ) -> "GuardianSession":
        return GuardianSession(self, emit, device=device)


class GuardianSession:
    """Per-run escalation-ladder state: the device carry, the last-good
    snapshot, the rolling score window, the rollback budget. The carry
    lives on `device` (None = the CUDA device)."""

    def __init__(self, policy: GuardianPolicy,
                 emit: Callable[[str, int, dict], None], device=None):
        self.policy = policy
        self._emit = emit
        self.gstate = guardian_state(device=device)
        self._snapshot = None
        self._snap_step = 0
        self._step = 0
        self._last_check = 0
        self._skipped_prev = 0
        self._scores: deque = deque(maxlen=policy.divergence_window)
        self._last_score: Optional[float] = None
        self.rollbacks = 0

    @property
    def armed(self) -> bool:
        return self._snapshot is not None

    def arm(self, live) -> None:
        """Capture the current state tuple as the last-good snapshot.
        Fit loops call this once, BEFORE the first guarded step."""
        self._snapshot = _device_copy(live)
        self._snap_step = self._step

    def observe(self, live, gstate: GuardianState, score, steps: int = 1
                ) -> Tuple[Any, bool]:
        """Called after every guarded step (or fit_scan epoch) with the
        live state tuple ((param table, updater state) for the network).
        Returns (live, rolled_back); `live` is replaced by a copy of the
        last-good snapshot on rollback. Reads two scalars at
        `check_every` boundaries only; raises `GuardianAbort` when the
        rollback budget is spent.

        `steps` is how many guarded train steps this observation covers
        (1 for the per-batch fit loop, n_batches for a fit_scan epoch),
        so the policy's cadences stay denominated in BATCHES."""
        self._step += steps
        self.gstate = gstate
        p = self.policy
        if self._step - self._last_check < p.check_every:
            return live, False
        window = self._step - self._last_check
        self._last_check = self._step
        # the skip threshold is per check_every batches; a coarse observer
        # (fit_scan: once per epoch) covers a wider window, so scale it to
        # keep the tolerated fault RATE the same at every granularity
        max_skips = p.max_skips_per_window * max(
            1, round(window / p.check_every))
        skipped = int(gstate.skipped)  # the two guardian host syncs
        s = float(score)
        delta = skipped - self._skipped_prev
        self._skipped_prev = skipped
        diverged = False
        if delta == 0:
            # a clean window: the score is trustworthy
            self._last_score = s
            best = min(self._scores) if self._scores else None
            if best is not None:
                diverged = p.divergence.terminate(s, best, 0.0)
            if not diverged:
                self._scores.append(s)
        if delta >= max_skips or diverged:
            reason = ("divergence" if diverged
                      else f"{delta} skips in one window")
            return self._rollback(reason, {"score": s, "skipped": skipped})
        if delta:
            self._emit("skip", self._step,
                       {"skipped_in_window": delta, "total_skipped": skipped})
        elif self._step - self._snap_step >= p.snapshot_every:
            # refresh only at HEALTHY boundaries (zero skips): a window
            # with sub-threshold skips may already sit inside the faulty
            # region, and rollback must land BEFORE the trouble started
            self._snapshot = _device_copy(live)
            self._snap_step = self._step
        return live, False

    def _rollback(self, reason: str, detail: dict) -> Tuple[Any, bool]:
        self.rollbacks += 1
        if self.rollbacks > self.policy.max_rollbacks:
            report = self.stats()
            report["reason"] = reason
            last_good = _device_copy(self._snapshot)
            self._emit("abort", self._step, report)
            raise GuardianAbort(report, last_good=last_good)
        self.gstate = GuardianState(
            skipped=self.gstate.skipped,
            lr_scale=self.gstate.lr_scale * self.policy.lr_backoff)
        self._scores.clear()
        self._emit("rollback", self._step,
                   {"reason": reason, "rollback": self.rollbacks,
                    "to_step": self._snap_step,
                    "lr_scale": float(self.gstate.lr_scale), **detail})
        return _device_copy(self._snapshot), True

    def stats(self) -> dict:
        """Diagnostic summary (abort reports, autosave metadata). Reads
        the skip counter."""
        return {
            "steps": self._step,
            "skipped": int(self.gstate.skipped),
            "rollbacks": self.rollbacks,
            "lr_scale": float(self.gstate.lr_scale),
            "last_score": self._last_score,
            "best_recent_score": min(self._scores) if self._scores else None,
        }


# ================================================================ fit driver
class TrainingGuard:
    """Per-fit host driver composing the three tiers for one training
    run: the guarded-session ladder, `checkpoint_every` autosave, and the
    SIGTERM / preemption flush. Built by `make_guard`; a context manager
    around the fit loop (installs and restores the signal handlers)."""

    signals = (_signal.SIGTERM,)

    def __init__(self, network, policy: Optional[GuardianPolicy] = None,
                 checkpoint_every: Optional[int] = None, saver=None,
                 save_fn: Optional[Callable] = None,
                 start_position: int = 0, start_epoch: int = 0,
                 start_epoch_batch: int = 0):
        if checkpoint_every is not None and checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}")
        from deeplearning4j_tpu_torch.scaleout import checkpoint as _ckpt
        _ckpt.register_namedtuple(GuardianState)
        self.network = network
        self.policy = policy
        self.checkpoint_every = checkpoint_every
        if saver is None and checkpoint_every:
            saver = _ckpt.DefaultModelSaver()  # reference default path
        self.saver = saver
        self._save_fn = save_fn
        self.session = (policy.session(self._emit, device=network.device)
                        if policy else None)
        #: TOTAL batches consumed, the checkpoint cursor. A resumed fit
        #: seeds it (and the epoch) from the restored checkpoint so new
        #: autosaves continue the step numbering.
        self.position = int(start_position)
        self.epoch = int(start_epoch)  # 0-based; fit loops call begin_epoch
        #: batches consumed within the current epoch, seeded on a
        #: mid-epoch resume (the feed was fast-forwarded past
        #: `start_epoch_batch` batches) so the NEXT checkpoint's
        #: epoch_batch stays truthful: a second resume must not
        #: fast-forward short and double-train
        self.epoch_position = int(start_epoch_batch)
        self._epochs_begun = 0
        self._preempt = threading.Event()
        self._prev_handlers: dict = {}

    # ------------------------------------------------------------ lifecycle
    def __enter__(self) -> "TrainingGuard":
        # the fit in progress is reachable from its listeners, which may
        # call request_preemption()
        self.network.guard = self
        if self.saver is not None:
            try:
                for sig in self.signals:
                    self._prev_handlers[sig] = _signal.signal(
                        sig, self._on_signal)
            except ValueError:
                # not the main thread: signal delivery is the main
                # thread's job; request_preemption() still works
                self._prev_handlers.clear()
        return self

    def __exit__(self, *exc) -> None:
        self.network.guard = None
        for sig, prev in self._prev_handlers.items():
            _signal.signal(sig, prev)
        self._prev_handlers.clear()
        # async savers (checkpoint.ShardedModelSaver): the fit loop paid
        # only the snapshot per autosave; make every pending write durable
        # before fit() returns. On an exceptional exit, still try, but
        # never mask the in-flight exception with a flush error.
        flush = getattr(self.saver, "flush", None)
        if flush is not None:
            if exc and exc[0] is not None:
                try:
                    flush()
                except Exception:
                    log.exception(
                        "checkpoint flush failed during exceptional exit")
            else:
                flush()

    def _on_signal(self, signum, frame) -> None:
        # defer: the flush happens at a step boundary
        self._preempt.set()

    def request_preemption(self) -> None:
        """Programmatic preemption notice (tests, cluster agents,
        non-main threads where no handler could be installed)."""
        self._preempt.set()

    # -------------------------------------------------------------- session
    @property
    def guarded(self) -> bool:
        return self.session is not None

    @property
    def gstate(self) -> GuardianState:
        return self.session.gstate

    def arm_once(self, live) -> None:
        if self.session is not None and not self.session.armed:
            self.session.arm(live)

    def post_step(self, live, gstate: GuardianState, score, steps: int = 1
                  ) -> Tuple[Any, bool]:
        return self.session.observe(live, gstate, score, steps=steps)

    # ---------------------------------------------------- autosave/preempt
    def begin_epoch(self) -> None:
        """Fit loops call this at each epoch start, so checkpoints carry
        a WITHIN-epoch cursor beside the total: `iterator_position` is
        the total batches consumed, metadata epoch / epoch_batch position
        a re-iterable source mid-epoch (`DeviceFeed.fast_forward`)."""
        if self._epochs_begun:  # NOT `if self.position`: a resumed fit
            self.epoch += 1     # starts mid-epoch with a nonzero cursor
            self.epoch_position = 0
        # the first begin_epoch keeps a seeded start_epoch_batch: the
        # resumed fit's first (partial) epoch is already mid-stream
        self._epochs_begun += 1

    def tick(self) -> None:
        """Call once per consumed batch (fit_scan: per epoch), AFTER the
        network reflects the step. Autosaves, and on a pending
        preemption flushes a final checkpoint and raises
        `TrainingPreempted`."""
        self.position += 1
        self.epoch_position += 1
        if self._preempt.is_set():
            path = self._save("preempt") if self.saver is not None else None
            raise TrainingPreempted(path, self.position)
        if (self.checkpoint_every and self.saver is not None
                and self.position % self.checkpoint_every == 0):
            self._save("autosave")

    def _save(self, kind: str) -> str:
        meta = {"guardian": self.session.stats()} if self.session else {}
        meta["epoch"] = self.epoch
        meta["epoch_batch"] = self.epoch_position
        # save_fns use this to avoid collectives on the preemption path
        # (SIGTERM reaches the ranks at different batches)
        meta["save_kind"] = kind
        if self._save_fn is not None:
            path = self._save_fn(self.saver, self.position, meta)
        else:
            path = self.saver.save(self.network,
                                   iterator_position=self.position,
                                   metadata=meta)
        self._emit(kind, self.position, {"path": path})
        return path

    # --------------------------------------------------------------- events
    def _emit(self, kind: str, step: int, info: Optional[dict] = None
              ) -> None:
        event = GuardianEvent(kind, step, dict(info or {}))
        _M_EVENTS.labels(kind=kind).inc()
        level = (logging.WARNING if kind in ("rollback", "abort", "preempt")
                 else logging.INFO)
        log.log(level, "guardian %s at step %d: %s", kind, step, event.info)
        targets = list(self.policy.listeners) if self.policy else []
        targets += [lst for lst in getattr(self.network, "listeners", [])
                    if hasattr(lst, "guardian_event") and lst not in targets]
        for t in targets:
            t.guardian_event(self.network, event)


def make_guard(network, guardian=None, checkpoint_every: Optional[int] = None,
               saver=None, save_fn: Optional[Callable] = None,
               start_position: int = 0, start_epoch: int = 0,
               start_epoch_batch: int = 0
               ) -> Optional[TrainingGuard]:
    """The per-fit TrainingGuard, or None when every guardian feature is
    off (callers then keep their unguarded code path).

    `guardian` is a GuardianPolicy, or True for defaults. A `saver`
    without `checkpoint_every` arms the preemption flush only.
    `start_position` / `start_epoch` / `start_epoch_batch` seed the
    cursor of a resumed fit. `save_fn(saver, position, metadata)`, when
    given, makes each save instead of `saver.save(network, ...)` (the
    parallel trainers gather sharded state and save on one rank)."""
    if guardian is None and not checkpoint_every and saver is None:
        return None
    policy = GuardianPolicy() if guardian is True else guardian
    return TrainingGuard(network, policy, checkpoint_every, saver, save_fn,
                         start_position=start_position,
                         start_epoch=start_epoch,
                         start_epoch_batch=start_epoch_batch)
