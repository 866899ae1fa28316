"""Data-parallel training over a mesh of ranks, the counterpart of the
JAX package's `parallel/data_parallel.py`.

`DataParallelTrainer` is per-step synchronous data parallelism: the
batch is split over the `data` axis, the parameters are replicated
(every rank holds the whole network), and each step all-reduces the
gradients. It is the tight-sync version of the reference's
IterativeReduceWorkRouter; `ParameterAveragingTrainer`
(parallel/averaging.py) is the epoch-wave averaging mode.

One rank a process, each running the same program. Every rank takes the
same GLOBAL iterator, and the global batch stays the unit of the math,
as under GSPMD: the trainer's `DeviceFeed` (`sharding=batch_sharding`)
hands each rank its rows of every global batch, `n_valid` is the global
real-row count, and the padding mask comes from global row indices. A
step on rank r:

1. the masked loss on the local rows, scaled by (real local rows /
   real global rows), so the ranks' losses and gradients sum to those of
   the global batch's mean (L2 included: the scales sum to 1);
2. one all-reduce over the data axis of every gradient and the loss,
   flattened into one buffer a dtype;
3. the per-layer updater with the GLOBAL count (AdaGrad's /batchSize)
   and `p -= update` in place on the network's live parameters.

At data-axis size 1 nothing is scaled, and the step is the network's
own `fit` step bit for bit. After `fit` every rank holds the same
parameters in `net`, so `net.output` and `net.params()` work as in the
JAX package.

The guarded step (`guardian=`) decides its commit on the all-reduced
gradients and loss, identical on every rank, so every rank commits or
skips together. Autosaves write from the mesh's first rank only; every
rank joins whatever gathers the save needs first (ZeRO-1's flat state,
TP's shards), so the collectives match.

Random numbers: the JAX package draws one key a step with
`net.next_key()`. The port draws one seed a step from
`net._next_seed()`, the same on every rank, and seeds this rank's
generator with (seed, rank), so the shards do not share dropout masks.

Telemetry: the `dl4j_train_*` series with
`dl4j_train_step_seconds{source="parallel"}`, and the span
`parallel_train_step` over `dp.grads` (the masked local loss and its
backward), `dp.allreduce` (the flat all-reduce) and `dp.update` (the
updater and the parameters' step); the device feed's `feed.fetch` and
`feed.put` run between steps. With a program store active (`compilecache`) the
step and the guarded step go through `compilecache.bind_program` under
`_aot_key(tag)` — config digest, trainer class, mesh, axis and device
set, the JAX package's key — so every subclass (ZeRO-1, TP) dispatches
through the store too.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import telemetry
from deeplearning4j_tpu_torch.datasets.device_feed import (DeviceFeed,
                                                           feed_mask)
from deeplearning4j_tpu_torch.optimize.guardian import (
    GuardianAbort, advance, all_finite, apply_lr_scale, commit, make_guard)
from deeplearning4j_tpu_torch.optimize.updater import NetworkGradientUpdater
from deeplearning4j_tpu_torch.parallel import collectives as C
from deeplearning4j_tpu_torch.parallel.mesh import (DATA_AXIS,
                                                    batch_sharding,
                                                    make_mesh)
from deeplearning4j_tpu_torch.telemetry.trace import span

# the trainers share the nn.multilayer step/example counters (same
# metric names, get-or-create) and tag their step time source="parallel"
_M_STEPS = telemetry.counter(
    "dl4j_train_steps", "supervised train steps dispatched")
_M_EXAMPLES = telemetry.counter(
    "dl4j_train_examples", "example rows dispatched (incl. bucket padding)")
_M_EPOCHS = telemetry.counter("dl4j_train_epochs", "training epochs run")
_M_LOSS = telemetry.gauge(
    "dl4j_train_loss", "last host-synced training score")
_M_STEP_S = telemetry.histogram("dl4j_train_step_seconds")

__all__ = ["DataParallelTrainer"]


def _leaves(table) -> List[torch.Tensor]:
    return [p for t in table.values() for p in t.values()]


def all_reduce_flat(tensors: List[torch.Tensor], mesh, axes) -> None:
    """All-reduce (sum) `tensors` in place over `axes`, one collective a
    dtype through a flat buffer."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        C.all_reduce_(flat, mesh, axes)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


class DataParallelTrainer:
    """Per-step synchronous data parallelism for a MultiLayerNetwork."""

    def __init__(self, network, mesh=None, axis: str = DATA_AXIS):
        self.network = network
        self.mesh = mesh if mesh is not None else make_mesh(
            device=network.device)
        if self.mesh.device.type != network.device.type:
            raise ValueError(f"the mesh's device {self.mesh.device} is not "
                             f"the network's {network.device}")
        self.axis = axis
        self.n_devices = self.mesh.size
        self.updater = NetworkGradientUpdater.for_network(network)
        self._gen = torch.Generator(device=network.device)
        #: program-store dispatchers by tag (compilecache), made at
        #: first use
        self._dispatchers: dict = {}

    def _aot_key(self, tag: str) -> Optional[str]:
        """Program-store key: config digest + class (subclasses change
        the sharding) + mesh/axis + device set. None (= no wrapping)
        when no store is active or the config won't serialize."""
        from deeplearning4j_tpu_torch import compilecache

        if compilecache.active_compiler() is None:
            return None
        try:
            digest = compilecache.config_digest(self.network.to_json())
        except Exception:
            return None
        shape = "x".join(str(s) for s in self.mesh.shape.values())
        return (f"{type(self).__name__}.{tag}:{digest}|mesh={shape}"
                f"|axis={self.axis}"
                f"|dev={self.network.device}x{self.n_devices}")

    def _program(self, tag: str, fn):
        """The bound method `fn` through the program store under `tag`,
        made once; `fn` itself, and nothing kept, with no store
        active."""
        d = self._dispatchers.get(tag)
        if d is None:
            from deeplearning4j_tpu_torch import compilecache

            d = compilecache.bind_program(fn, self._aot_key(tag))
            if d is None:
                return fn
            self._dispatchers[tag] = d
        return d

    #: axes the guarded step's finite predicate is reduced over beyond
    #: the all-reduced gradients (TP: its shards differ over `model`)
    _finite_axes = None

    # ---------------------------------------------------------- the step
    @property
    def _data_size(self) -> int:
        return self.mesh.shape[self.axis]

    def _params(self):
        """The (param table, updater state) a step updates in place."""
        net = self.network
        if net._updater_state is None:
            net._updater_state = self.updater.init(net.param_table)
        return net.param_table, net._updater_state

    def _loss(self, params, x, labels, weights):
        """This rank's loss on its rows (subclasses change the forward)."""
        return self.network.loss_fn(params, x, labels, rng=self._gen,
                                    training=True, weights=weights)

    def _reduce(self, score, grads: List[torch.Tensor]) -> torch.Tensor:
        """Sum the ranks' scaled losses and gradients over the data axis,
        in place; returns the global score."""
        score = score.reshape(1)
        with span("dp.allreduce"):
            all_reduce_flat([score, *grads], self.mesh, self.axis)
        return score[0]

    def _grads(self, params, x, labels, n_valid):
        """(global score, all-reduced grads as a table, count) of this
        rank's rows: the masked local loss scaled by its share of the
        global batch's real rows."""
        n = self._data_size
        rows = x.shape[0]
        offset = self.mesh.linear_index(self.axis) * rows
        weights, count = feed_mask(rows, n_valid, x.device, offset=offset)
        if n_valid is None:
            count = rows * n
        leaves = _leaves(params)
        with span("dp.grads"), torch.enable_grad():
            score = self._loss(params, x, labels, weights)
            if n > 1:
                share = (weights.sum() / count.to(weights.dtype)
                         if weights is not None else 1.0 / n)
                score = score * share
            flat = list(torch.autograd.grad(score, leaves, allow_unused=True,
                                            materialize_grads=True))
        score = self._reduce(score.detach(), flat)
        it = iter(flat)
        grads = {k: {name: next(it) for name in t} for k, t in params.items()}
        return score, grads, count

    @torch.no_grad()
    def _step(self, x, labels, n_valid=None) -> torch.Tensor:
        params, state = self._params()
        score, grads, count = self._grads(params, x, labels, n_valid)
        with span("dp.update"):
            updates, _ = self.updater.update(grads, state, params, count)
            for p, u in zip(_leaves(params), _leaves(updates)):
                p.sub_(u)
        return score

    @torch.no_grad()
    def _gstep(self, x, labels, n_valid, gstate):
        """The guarded step (MultiLayerNetwork._guarded_train_step's
        commit) on the all-reduced gradients: identical on every rank,
        so every rank commits or skips together."""
        params, state = self._params()
        score, grads, count = self._grads(params, x, labels, n_valid)
        with span("dp.update"):
            ok = all_finite(score, grads, axis_name=self._finite_axes)
            leaves = _leaves(params)
            hist = [t for s in state.values() for t in s.hist.values()]
            vel = [t for s in state.values() for t in s.velocity.values()]
            its = [s.iteration for s in state.values()]
            old_hist = torch._foreach_mul(hist, 1.0)
            old_vel = torch._foreach_mul(vel, 1.0)
            updates, _ = self.updater.update(grads, state, params, count)
            new = torch._foreach_sub(leaves, apply_lr_scale(
                _leaves(updates), gstate))
            commit(ok, leaves, new, out=leaves)
            commit(ok, old_hist + old_vel, hist + vel, out=hist + vel)
            skipped = torch.logical_not(ok).to(torch.int32)
            torch._foreach_sub_(its, [skipped] * len(its))
        return score, advance(gstate, ok)

    # ----------------------------------------------------------- batches
    def pad_batch(self, x: np.ndarray, labels: np.ndarray):
        """Pad the batch to a multiple of the mesh's rank count by
        repeating rows (the legacy path; the device feed masks instead)."""
        n = x.shape[0]
        rem = n % self.n_devices
        if rem:
            pad = self.n_devices - rem
            idx = np.arange(pad) % n  # tile when pad > n (tiny last batch)
            x = np.concatenate([x, x[idx]])
            labels = np.concatenate([labels, labels[idx]])
        return x, labels

    def _make_feed(self, iterator, device_feed) -> Optional[DeviceFeed]:
        """The per-rank device feed for fit(): buckets aligned to the
        data-axis size (equal slices), each rank fed its rows of every
        global batch. None = the legacy pad_batch path."""
        # the batch only splits over the DATA axis: aligning to the full
        # rank count would over-pad (and over-reject) tp x dp meshes
        data_shards = int(self.mesh.shape[self.axis])
        if isinstance(iterator, DeviceFeed):
            bad = [b for b in iterator.buckets if b % data_shards]
            if bad:
                raise ValueError(
                    f"DeviceFeed buckets {bad} are not multiples of the "
                    f"data-axis size {data_shards}; build the feed "
                    f"with align={data_shards} (or let the trainer "
                    "wrap the raw iterator itself)")
            return iterator
        if device_feed is False:
            return None
        return DeviceFeed(iterator, align=data_shards,
                          sharding=batch_sharding(self.mesh, self.axis),
                          device=self.network.device)

    def _local(self, a):
        return batch_sharding(self.mesh, self.axis).local(a)

    def _epoch_batches(self, iterator, feed):
        """One epoch of this rank's (x, labels, n_valid) device triples."""
        if feed is not None:
            for fb in feed:
                if feed.sharding is None:  # a global feed: take my rows
                    yield self._local(fb.features), self._local(fb.labels), \
                        fb.n_valid
                else:
                    yield fb.features, fb.labels, fb.n_valid
            return
        net = self.network
        iterator.reset()
        for ds in iterator:
            x, labels = self.pad_batch(np.asarray(ds.features),
                                       np.asarray(ds.labels))
            yield (net._tensor(self._local(x)),
                   net._tensor(self._local(labels)), None)

    # --------------------------------------------------------------- fit
    def _first_rank(self) -> bool:
        return self.mesh.rank == int(self.mesh.devices.reshape(-1)[0])

    def _save(self, saver, position, meta):
        """Autosave from the mesh's first rank (the parameters are
        replicated; every rank would write the same files)."""
        if not self._first_rank():
            return None
        return saver.save(self.network, iterator_position=position,
                          metadata=meta)

    def _begin_fit(self) -> None:
        """Hook run before the first step of a fit (TP slices here)."""

    def _end_fit(self) -> None:
        """Hook run after a fit, also an interrupted one (TP gathers)."""

    def _live(self):
        return self.network._live()

    def _restore_live(self, live) -> None:
        self.network._restore_live(live)

    def _observe(self, guard, score) -> None:
        try:
            live, rolled = guard.post_step(self._live(), guard.gstate, score)
        except GuardianAbort as e:
            self._restore_live(e.last_good)
            raise
        if rolled:
            self._restore_live(live)

    def fit(self, iterator, epochs: int = 1,
            device_feed: Optional[bool] = None, guardian=None,
            checkpoint_every: Optional[int] = None, saver=None) -> None:
        """Data-parallel fit. `guardian=` / `checkpoint_every=` /
        `saver=` arm the training guardian as in MultiLayerNetwork.fit;
        the guarded commit is decided on the all-reduced gradients, so
        every rank commits or skips each step together."""
        net = self.network
        guard = make_guard(net, guardian, checkpoint_every, saver,
                           save_fn=self._save)
        guarded = guard is not None and guard.guarded
        feed = self._make_feed(iterator, device_feed)
        rank = self.mesh.rank
        score = None
        steps = 0
        ctx = guard if guard is not None else contextlib.nullcontext()
        self._begin_fit()
        try:
            with ctx, self.mesh:
                if guarded:
                    self._params()
                    guard.arm_once(self._live())
                step_child = _M_STEP_S.labels(source="parallel")
                for _ in range(epochs):
                    _M_EPOCHS.inc()
                    if guard is not None:
                        guard.begin_epoch()
                    for x, labels, n_valid in self._epoch_batches(iterator,
                                                                  feed):
                        t0 = time.perf_counter()
                        self._gen.manual_seed(
                            (net._next_seed() * 1000003 + rank) % (1 << 63))
                        if guarded:
                            with span("parallel_train_step", guarded=True):
                                score, guard.session.gstate = \
                                    self._program("gstep", self._gstep)(
                                        x, labels, n_valid, guard.gstate)
                            self._observe(guard, score)
                        else:
                            with span("parallel_train_step"):
                                score = self._program("step", self._step)(
                                    x, labels, n_valid)
                        step_child.observe(time.perf_counter() - t0)
                        _M_STEPS.inc()
                        _M_EXAMPLES.inc(x.shape[0] * self._data_size)
                        steps += 1
                        if guard is not None:
                            guard.tick()
        finally:
            self._end_fit()
        if steps and net.listeners:  # float() only where it always was:
            score_f = float(score)   # no-listener fits stay sync-free
            _M_LOSS.set(score_f)
            for listener in net.listeners:
                listener.iteration_done(net, steps - 1, score_f)
