"""The stacked network, the counterpart of the JAX package's
`nn/multilayer.py`.

Parity: reference core/nn/multilayer/MultiLayerNetwork.java — init with
nIn/nOut inference (:331-386), `feedForward` (:457), `fit` (:1021/:1136),
`output`/`predict` (:1197/:1107), `score` (:1265), flat param pack/unpack
(params :784, setParameters :1420), and the parameter-averaging `merge`
(:1361).

An `nn.Module` holding its layers in `self.layers` (an `nn.ModuleList`,
so they are keyed "0", "1", ...), each layer's parameters under the JAX
package's names. The forward and the loss are also functions of an
explicit parameter table ({layer index -> {name -> tensor}}), as in the
JAX package. A train step is autograd of `loss_fn` at the live
parameters, then the per-layer updater and `p -= update`, in place
under `torch.no_grad()`; the loss stays a 0-d device tensor, so a step
reads nothing back to the host. `fit_scan`, one XLA program in the JAX
package, is a loop of those steps that synchronises with the host once,
after its last epoch.

The packed parameter vector (`params()` / `set_parameters()`) has the
JAX package's `ravel_pytree` order: layers by their index as a *string*
("10" packs before "2"), names sorted within a layer ("W" before "b"),
each tensor in row-major order. A vector from either package installs
in the other.

The batch solvers (`optimize/solver.py`) drive the other paths, as in
the JAX package: the line-search and Hessian-free algorithms of a
backprop fit (one `Solver` over the whole packed vector, the device
feed's row mask as an extra datum), `finetune` / `backprop=False` (the
output layer's solver over chunked frozen features) and layer-wise
`pretrain` (one cached `Solver` per RBM / autoencoder layer), which
`fit` runs first when `conf.pretrain` is set. Listeners
(`set_listeners`) are called after each `fit` batch and `fit_scan`
call, and by the solvers each iteration; calling one reads the score
back to the host.

The guardian (`optimize/guardian.py`) wraps `fit` and `fit_scan` as in
the JAX package: `guardian=` switches to the guarded step (all-finite
predicate and `torch.where` commit on the device, no host sync; with no
fault it gives the unguarded step's params bit for bit),
`checkpoint_every=` / `saver=` autosave and arm the preemption flush,
and `start_position` / `start_epoch` / `start_epoch_batch` seed the
cursor of a resumed run. With all of them off, `fit` and `fit_scan` run
the unguarded step.

Telemetry, the JAX package's series and spans: `dl4j_train_steps`,
`dl4j_train_examples` (padded rows included), `dl4j_train_epochs`,
`dl4j_train_step_seconds{source=fit|scan}` and `dl4j_train_loss`; the
spans `train_step` (a `fit` step), `fit_scan` and `fit_scan_epoch`;
`dl4j_jit_programs{cache="train_step"|"predict_step"}` over the
distinct batch shapes a step or a bucketed forward has run (the port's
count of what the JAX package compiles). All of it is host counters:
the loss is gauged only where a host read already happens (listeners,
`fit_scan(sync=True)`), so a step syncs as often, and leaves the same
params bit for bit, with telemetry on or off. The `train.batch` chaos
point poisons a `fit` batch before its step, as in the JAX package;
with no active plan it costs one global check. The compile cache is
left out (ROADMAP Queue 1 item 14c).
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch import default_device, telemetry
from deeplearning4j_tpu_torch.config.multi_layer_configuration import (
    MultiLayerConfiguration)
from deeplearning4j_tpu_torch.datasets.device_feed import (
    DEFAULT_MIN_BUCKET, DeviceFeed, bucket_for, feed_mask, pad_rows)
from deeplearning4j_tpu_torch.nn.api import merge_params
from deeplearning4j_tpu_torch.nn.layers import make_layer
from deeplearning4j_tpu_torch.optimize.guardian import (GuardianAbort,
                                                        all_finite, advance,
                                                        apply_lr_scale,
                                                        commit, make_guard)
from deeplearning4j_tpu_torch.optimize.solver import Solver
from deeplearning4j_tpu_torch.optimize.solvers import ravel_table
from deeplearning4j_tpu_torch.optimize.updater import NetworkGradientUpdater
from deeplearning4j_tpu_torch.telemetry.trace import span
from deeplearning4j_tpu_torch.testing import chaos
from deeplearning4j_tpu_torch.utils.sanitize import validate_batch

log = logging.getLogger(__name__)

# telemetry: host-side counters only. Nothing here reads a device value,
# so the training math is bit-identical with telemetry on or off, and
# the loss is gauged only where a float(score) host read already exists
# (listener dispatch, fit_scan's sync=True return).
_M_STEPS = telemetry.counter(
    "dl4j_train_steps", "supervised train steps dispatched")
_M_EXAMPLES = telemetry.counter(
    "dl4j_train_examples", "example rows dispatched (incl. bucket padding)")
_M_EPOCHS = telemetry.counter("dl4j_train_epochs", "training epochs run")
_M_STEP_S = telemetry.histogram(
    "dl4j_train_step_seconds",
    "wall time per train step; source=fit is per-step dispatch wall "
    "time, source=scan is the per-step average of a compiled epoch, "
    "source=parallel is the DP/ZeRO-1/TP trainer dispatch loop, "
    "source=listener is StepTimeListener's listener-to-listener time")
_M_LOSS = telemetry.gauge(
    "dl4j_train_loss", "last host-synced training score")


def _leaves(tree) -> List[torch.Tensor]:
    return [p for table in tree.values() for p in table.values()]


class MultiLayerNetwork(nn.Module):
    def __init__(self, conf: MultiLayerConfiguration, params=None,
                 device=None):
        """`params`, if given, is a packed flat vector (the reference's
        checkpoint constructor, MultiLayerNetwork.java:91). Parameters
        live on `device` (None = the CUDA device, raising without one).
        Initial weights come from a CPU generator seeded with the first
        layer's `seed`, so they are the same on every device; dropout
        draws from a generator on `device` with the same seed, and the
        solvers' per-call seeds from a third, on the host."""
        super().__init__()
        self.conf = conf
        self.device = default_device(device)
        self._infer_layer_sizes()
        self.layers = nn.ModuleList([make_layer(c, self.device)
                                     for c in conf.confs])
        seed = conf.confs[0].seed if conf.confs else 0
        self._init_gen = torch.Generator().manual_seed(seed)
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._seeds = torch.Generator().manual_seed(seed)
        self._pending_params = params
        self._iteration_count = 0
        self.listeners: List = []
        #: the TrainingGuard of the guarded / checkpointed fit in
        #: progress (None otherwise): a listener may call its
        #: request_preemption()
        self.guard = None
        #: distinct (batch shapes, dtype, masked, guarded) a fit step and
        #: a bucketed forward have run: the port's program counts
        self._train_programs: set = set()
        self._predict_programs: set = set()
        self.init()
        # program counters surface as dl4j_jit_programs{cache=...}
        # (weak-ref'd: watching never extends this network's lifetime)
        from deeplearning4j_tpu_torch.telemetry import device as _tdev
        _tdev.watch_jit_cache("train_step", self.train_step_cache_size)
        _tdev.watch_jit_cache("predict_step", self.predict_step_cache_size)

    # ------------------------------------------------------------- set-up
    def _infer_layer_sizes(self) -> None:
        """nIn/nOut inference from hiddenLayerSizes (reference
        init:331-386)."""
        sizes = self.conf.hidden_layer_sizes
        if not sizes:
            return
        confs = self.conf.confs
        if len(confs) != len(sizes) + 1:
            raise ValueError(
                f"hidden_layer_sizes of length {len(sizes)} requires "
                f"{len(sizes) + 1} layer confs, got {len(confs)}")
        dims = [confs[0].n_in, *sizes, confs[-1].n_out]
        for i, c in enumerate(confs):
            c.n_in, c.n_out = dims[i], dims[i + 1]

    def init(self) -> None:
        """Initialise the parameters (reference MultiLayerNetwork.init
        :331): each layer in order draws from the init generator; a
        pending packed vector is then installed."""
        for layer in self.layers:
            layer.init_params(self._init_gen)
        self._updater = None
        self._updater_state = None
        self._batch_solver = None
        self._finetune_solver = None
        self._pretrain_solvers: Dict[int, Solver] = {}
        if self._pending_params is not None:
            self.set_parameters(self._pending_params)
            self._pending_params = None

    def set_listeners(self, listeners: Sequence) -> None:
        self.listeners = list(listeners)

    def _next_seed(self) -> int:
        """A fresh seed for one solver call, drawn on the host (the JAX
        package's `next_key()`)."""
        return int(torch.randint(0, 1 << 62, (), generator=self._seeds))

    def _dispatch(self, score, read: bool = False):
        """Call the listeners with the last iteration and the score. The
        score is read back to the host (and gauged as dl4j_train_loss)
        only when there are listeners or the caller reads it anyway
        (`read`); returns the float then, else None."""
        if not (self.listeners or read):
            return None
        score = float(score)
        _M_LOSS.set(score)
        for listener in self.listeners:
            listener.iteration_done(self, self._iteration_count - 1, score)
        return score

    def train_step_cache_size(self) -> int:
        """Distinct batch shapes (with dtype, masking and guarding) the
        fit train step has run: the counterpart of the JAX package's
        compiled-program count, which bucketing keeps at the buckets
        hit. 0 before the first backprop step."""
        return len(self._train_programs)

    def predict_step_cache_size(self) -> int:
        """Distinct bucket shapes the bucketed forward (`output`) has run
        (the train_step_cache_size analogue for inference)."""
        return len(self._predict_programs)

    def _tensor(self, a) -> torch.Tensor:
        """An input on this network's device; float64 narrows to float32
        (as jnp.asarray does)."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.require(a, requirements=["C", "W"]))
        if t.dtype == torch.float64:
            t = t.float()
        return t.to(self.device)

    def _validate(self, x, labels=None, context="fit") -> None:
        has_pp = self.conf.input_preprocessors.get(0) is not None
        validate_batch(x, labels,
                       n_in=None if has_pp else self.layers[0].conf.n_in,
                       n_out=(self.layers[-1].conf.n_out
                              if labels is not None else None),
                       context=context)

    # ------------------------------------------------------------ forward
    def _layer_input(self, i: int, x, rng=None):
        pp = self.conf.input_preprocessors.get(i)
        return pp(x, rng=rng) if pp is not None else x

    def _layer_output(self, i: int, act, rng=None):
        pp = self.conf.output_preprocessors.get(i)
        return pp(act, rng=rng) if pp is not None else act

    def feed_forward_fn(self, params, x, rng: Optional[torch.Generator] = None,
                        training: bool = False) -> List[torch.Tensor]:
        """Feed-forward returning [input, act_0, ..., act_L] (reference
        feedForward :457), at the given parameter table."""
        acts = [x]
        cur = x
        for i, layer in enumerate(self.layers):
            cur = self._layer_input(i, cur, rng=rng)
            cur = layer.activate(params[str(i)], cur, rng=rng,
                                 training=training)
            cur = self._layer_output(i, cur)
            acts.append(cur)
        return acts

    def loss_fn(self, params, x, labels, rng: Optional[torch.Generator] = None,
                training: bool = False, weights=None):
        """Feed-forward into the output layer's configured loss (reference
        score :1265), plus each layer's L2 over its non-bias parameters
        (0.5 * l2 * sum(w^2), when `use_regularization`). `weights` (per
        example) masks the device feed's padding rows out of the loss."""
        n = len(self.layers)
        cur = x
        for i, layer in enumerate(self.layers[:-1]):
            cur = self._layer_input(i, cur, rng=rng)
            cur = layer.activate(params[str(i)], cur, rng=rng,
                                 training=training)
            cur = self._layer_output(i, cur)
        cur = self._layer_input(n - 1, cur, rng=rng)
        score = self.layers[-1].loss(params[str(n - 1)], cur, labels,
                                     rng=rng, training=training,
                                     weights=weights)
        for i, layer in enumerate(self.layers):
            c = layer.conf
            if c.use_regularization and c.l2 > 0:
                for name, value in params[str(i)].items():
                    if not layer.is_bias(name):
                        score = score + 0.5 * c.l2 * torch.square(value).sum()
        return score

    # -------------------------------------------------------------- train
    def has_pretrain_layers(self) -> bool:
        return any(hasattr(layer, "pretrain_loss") for layer in self.layers)

    def _iter_batches(self, data):
        """Feature tensors from a DataSetIterator or a single array."""
        if hasattr(data, "reset"):
            data.reset()
            for ds in data:
                yield self._tensor(ds.features)
        else:
            yield self._tensor(data)

    def _install(self, i: int, table) -> None:
        """Copy a solver's parameter table into layer `i`."""
        with torch.no_grad():
            for name, p in self.layers[i].param_dict().items():
                p.copy_(table[name])

    def _run_solver(self, solver: Solver, params, *data, **kw):
        """`solver.optimize` with this network's current listeners (the
        optimizer keeps its own list, so set_listeners() between fits
        must reach cached solvers)."""
        solver.get_optimizer().listeners = list(self.listeners)
        return solver.optimize(params, *data, **kw)

    def pretrain(self, data) -> None:
        """Layer-wise unsupervised pretraining (reference pretrain
        :142/:195): each batch goes through the already-trained lower
        layers, and each pretrain layer (RBM, autoencoder) below the
        output is fitted on the result by its own `Solver`, made once and
        kept across calls. `data` is a DataSetIterator or a feature
        array."""
        for i, layer in enumerate(self.layers[:-1]):
            if not hasattr(layer, "pretrain_loss"):
                continue
            solver = self._pretrain_solvers.get(i)
            if solver is None:
                _, unravel = ravel_table(layer.param_dict())

                def flat_loss(vec, gen, batch, *, _l=layer, _u=unravel):
                    return _l.pretrain_loss(_u(vec), batch, gen)

                solver = Solver(layer.conf, flat_loss,
                                listeners=self.listeners, model=self,
                                seed=self._next_seed())
                self._pretrain_solvers[i] = solver
            for x in self._iter_batches(data):
                with torch.no_grad():
                    cur = x
                    for j in range(i):
                        cur = self._layer_input(j, cur)
                        cur = self.layers[j].activate(
                            self.layers[j].param_dict(), cur)
                        cur = self._layer_output(j, cur)
                    cur = self._layer_input(i, cur)
                # sync=False: the score stays on the device; the lazy %s
                # reads it only at INFO verbosity
                new_params, score = self._run_solver(
                    solver, layer.param_dict(), cur, seed=self._next_seed(),
                    sync=False)
                self._install(i, new_params)
                log.info("Pretrained layer %d (score=%s)", i, score)

    def finetune(self, x, labels=None) -> None:
        """Optimise only the output layer on top of frozen features
        (reference finetune :1044/:1079 -> OutputLayer.fit), with the
        output layer's solver. Accepts (x, labels) arrays or a
        DataSetIterator; the frozen features are computed in chunks."""
        if labels is None:  # iterator protocol
            x.reset()
            for ds in x:
                self.finetune(ds.features, ds.labels)
            return
        hidden = self._frozen_features(self._tensor(x))
        out_layer = self.layers[-1]
        if self._finetune_solver is None:
            _, unravel = ravel_table(out_layer.param_dict())

            def flat_loss(vec, hid, lab, *, _u=unravel):
                return out_layer.loss(_u(vec), hid, lab)

            self._finetune_solver = Solver(out_layer.conf, flat_loss,
                                           listeners=self.listeners,
                                           model=self)
        new_params, _ = self._run_solver(
            self._finetune_solver, out_layer.param_dict(), hidden,
            self._tensor(labels), sync=False)
        self._install(len(self.layers) - 1, new_params)

    def _frozen_features(self, x, chunk_size: int = 4096) -> torch.Tensor:
        """Features under the output layer, computed in chunks so only
        (chunk, features) activations are live at once."""
        if len(self.layers) < 2:
            return x
        table = self.param_table
        with torch.no_grad():
            if x.shape[0] <= chunk_size:
                return self.feed_forward_fn(table, x)[-2]
            return torch.cat([self.feed_forward_fn(
                table, x[i:i + chunk_size])[-2]
                for i in range(0, x.shape[0], chunk_size)])

    def fit(self, x, labels=None, epochs: int = 1,
            device_feed: Optional[bool] = None, guardian=None,
            checkpoint_every: Optional[int] = None, saver=None,
            start_position: int = 0, start_epoch: int = 0,
            start_epoch_batch: int = 0) -> None:
        """Train on (x, labels) arrays or a DataSetIterator (reference
        fit(DataSet) :1172 / fit(DataSetIterator) :1021), `epochs` passes.
        When `conf.pretrain` is set and a layer can pretrain, layer-wise
        pretraining runs once over the data first.

        An iterator goes through a `DeviceFeed` by default: ragged batches
        are padded to the bucket ladder with their real count masked into
        the loss and the updater's ÷batchSize, and the next batches'
        copies run ahead of the step. `device_feed=False` copies each
        batch as it comes; a DeviceFeed passed as `x` is used as given.
        Pretraining reads the iterator itself, unpadded.

        Fault tolerance (optimize/guardian.py): `guardian=` (a
        GuardianPolicy, or True for defaults) takes the guarded step,
        which skips a step with a non-finite gradient or loss on the
        device; persistent trouble rolls back to a last-good snapshot
        with LR backoff, and `GuardianAbort` leaves the network on the
        last-good state. `checkpoint_every=N` autosaves a resumable
        checkpoint every N batches through `saver` (default: a rotating
        DefaultModelSaver); any saver also arms a SIGTERM hook that
        flushes a final checkpoint and raises `TrainingPreempted`. The
        guardian needs the iteration_gradient_descent algorithm.

        Resuming: `start_position` / `start_epoch` / `start_epoch_batch`
        take the restored checkpoint's `iterator_position` and metadata
        `epoch` / `epoch_batch`, so later autosaves continue the step
        numbering and record a truthful within-epoch cursor; pair them
        with `DeviceFeed.fast_forward(epoch_batch)`."""
        guard = make_guard(self, guardian, checkpoint_every, saver,
                           start_position=start_position,
                           start_epoch=start_epoch,
                           start_epoch_batch=start_epoch_batch)
        if guard is None:
            return self._fit_impl(x, labels, epochs, device_feed, None)
        with guard:
            return self._fit_impl(x, labels, epochs, device_feed, guard)

    def _fit_impl(self, x, labels, epochs, device_feed, guard) -> None:
        """One fit body for the guarded and the plain path; with
        guard=None every guard hook is skipped."""
        pretrain = self.conf.pretrain and self.has_pretrain_layers()
        if labels is None:  # iterator protocol
            if isinstance(x, DeviceFeed):
                feed, raw = x, x.source
            elif device_feed is False:
                feed, raw = None, x
            else:
                feed, raw = DeviceFeed(x, device=self.device), x
            if pretrain:
                self.pretrain(raw)  # host-driven per layer: unguarded
            for _ in range(epochs):
                _M_EPOCHS.inc()
                if guard is not None:
                    guard.begin_epoch()
                if feed is not None:
                    batches = ((fb.features, fb.labels, fb.n_valid)
                               for fb in feed)
                else:
                    x.reset()
                    batches = ((self._tensor(ds.features),
                                self._tensor(ds.labels), None) for ds in x)
                for bx, by, n_valid in batches:
                    self._fit_supervised(bx, by, n_valid, guard)
                    if guard is not None:
                        guard.tick()
            return
        x, labels = self._tensor(x), self._tensor(labels)
        self._validate(x, labels, "fit")
        if pretrain:
            self.pretrain(x)
        for _ in range(epochs):
            _M_EPOCHS.inc()
            if guard is not None:
                guard.begin_epoch()
            self._fit_supervised(x, labels, None, guard)
            if guard is not None:
                guard.tick()

    def _fit_supervised(self, x, labels, n_valid=None, guard=None) -> None:
        if self.conf.backprop:
            return self._backprop_fit(x, labels, n_valid, guard)
        if guard is not None and guard.guarded:
            raise ValueError(
                "guardian= requires the backprop iteration_gradient_"
                "descent path; the finetune path is host-driven "
                "(autosave via checkpoint_every= still works)")
        if n_valid is not None:
            # the finetune path strips the feed's padding rather than
            # threading a mask through the frozen-feature solver (a host
            # read of the count, as in the JAX package)
            n = int(n_valid)
            x, labels = x[:n], labels[:n]
        return self.finetune(x, labels)

    def _backprop_fit(self, x, labels, n_valid=None, guard=None) -> None:
        """iteration_gradient_descent: `num_iterations` train steps on
        one batch (standard minibatch SGD when it is 1), the updater
        state carried across batches; guarded steps when `guard` has a
        policy. Any other algorithm: the batch solver over the whole
        packed vector, made once and kept."""
        # chaos numeric-fault point: a "nan" rule poisons this batch (a
        # copy, on its device) before the step, producing the non-finite
        # grads the guardian's defense exists for; one global check
        # without an active plan
        x = chaos.maybe_nan("train.batch", x)
        conf0 = self.layers[-1].conf
        algo = conf0.optimization_algo.lower()
        guarded = guard is not None and guard.guarded
        if algo == "iteration_gradient_descent":
            if guarded:
                self._arm(guard)
            self._train_programs.add(
                (guarded, tuple(x.shape), x.dtype, tuple(labels.shape),
                 n_valid is None))
            score = None
            step_child = _M_STEP_S.labels(source="fit")
            for _ in range(conf0.num_iterations):
                t0 = time.perf_counter()
                if guarded:
                    with span("train_step", guarded=True):
                        score = self._guarded_step(guard, x, labels,
                                                   n_valid)
                    self._observe(guard, score, 1)
                else:
                    with span("train_step"):
                        score = self._train_step(x, labels, n_valid)
                step_child.observe(time.perf_counter() - t0)
                _M_STEPS.inc()
                _M_EXAMPLES.inc(x.shape[0])
            self._dispatch(score)
            return
        if guarded:
            raise ValueError(
                "guardian= supports only the iteration_gradient_descent "
                f"algorithm (got {algo!r}); the line-search solvers "
                "drive their own inner loop")
        if self._batch_solver is None:
            if algo == "hessian_free" and any(
                    layer.layer_name == "self_attention"
                    for layer in self.layers):
                raise ValueError(
                    "hessian_free needs second derivatives of the loss, "
                    "and the self_attention layer's flash attention is "
                    "differentiable once (its backward is the K2/K3 "
                    "kernels; the JAX package cannot take a jvp through "
                    "its custom_vjp either); use lbfgs, conjugate_"
                    "gradient or gradient_descent with this layer")
            _, unravel = ravel_table(self.param_table)

            def flat_loss(vec, gen, bx, by, *rest, _u=unravel):
                # rest, when present, is the device feed's row mask
                return self.loss_fn(_u(vec), bx, by, rng=gen, training=True,
                                    weights=rest[0] if rest else None)

            self._batch_solver = Solver(conf0, flat_loss,
                                        listeners=self.listeners,
                                        model=self, seed=self._next_seed())
        data = (x, labels)
        if n_valid is not None:
            data += (feed_mask(x.shape[0], n_valid, self.device)[0],)
        new_params, _ = self._run_solver(
            self._batch_solver, self.param_table, *data,
            seed=self._next_seed(), sync=False)
        self.param_table = new_params

    # ------------------------------------------------------------ guardian
    def _live(self):
        """The state the guardian snapshots and rolls back: (param table,
        updater state)."""
        return self.param_table, self._updater_state

    def _restore_live(self, live) -> None:
        """Install a (param table, updater state) the guardian handed
        back (a rollback, or the last-good state of an abort)."""
        self.param_table, self._updater_state = live

    def _arm(self, guard) -> None:
        if self._updater_state is None:
            self._updater_state = self._get_updater().init(self.param_table)
        guard.arm_once(self._live())

    def _guarded_step(self, guard, x, labels, n_valid) -> torch.Tensor:
        """One guarded train step, its carry kept in the guard's session;
        returns the score (a 0-d device tensor)."""
        score, guard.session.gstate = self._guarded_train_step(
            x, labels, n_valid, guard.gstate)
        return score

    def _observe(self, guard, score, steps: int) -> None:
        """The guardian's observation of `steps` guarded steps: it may
        roll the network back, or raise GuardianAbort with the network
        left on the last-good state."""
        try:
            live, rolled = guard.post_step(self._live(), guard.gstate, score,
                                           steps=steps)
        except GuardianAbort as e:
            self._restore_live(e.last_good)
            raise
        if rolled:
            self._restore_live(live)

    def _get_updater(self) -> NetworkGradientUpdater:
        if self._updater is None:
            self._updater = NetworkGradientUpdater.for_network(self)
        return self._updater

    def _grads(self, x, labels, n_valid):
        """(score, grads, live leaves, count): autograd of loss_fn at the
        live parameters; the updater state made on first use."""
        weights, count = feed_mask(x.shape[0], n_valid, self.device)
        params = self.param_table
        if self._updater_state is None:
            self._updater_state = self._get_updater().init(params)
        leaves = _leaves(params)
        with torch.enable_grad():
            score = self.loss_fn(params, x, labels, rng=self._rng,
                                 training=True, weights=weights)
            # a pretrain layer's visible bias is not on the supervised
            # path: its gradient is zero, as jax.grad gives it
            flat = iter(torch.autograd.grad(score, leaves, allow_unused=True,
                                            materialize_grads=True))
        grads = {k: {name: next(flat) for name in table}
                 for k, table in params.items()}
        return score.detach(), grads, leaves, count

    def _train_step(self, x, labels, n_valid=None) -> torch.Tensor:
        """One step: autograd of loss_fn at the live parameters, the
        per-layer updater, p -= update in place. The score comes back as
        a 0-d device tensor; nothing is read back to the host."""
        score, grads, leaves, count = self._grads(x, labels, n_valid)
        with torch.no_grad():
            updates, self._updater_state = self._get_updater().update(
                grads, self._updater_state, self.param_table, count)
            for p, u in zip(leaves, _leaves(updates)):
                p.sub_(u)
        self._iteration_count += 1
        return score

    @torch.no_grad()
    def _guarded_train_step(self, x, labels, n_valid, gstate):
        """The guarded step: the unguarded step's arithmetic, committed
        by `torch.where` on a 0-d all-finite flag reduced on the device.
        The updater changes hist / velocity / iteration in place, so
        their old values are copied first (x * 1.0, bit-exact) and put
        back where the step is skipped; the params take p - u * lr_scale
        (the unguarded p -= u bit for bit at scale 1.0) where it is
        clean. Returns (score, gstate); no host sync."""
        score, grads, leaves, count = self._grads(x, labels, n_valid)
        ok = all_finite(score, grads)
        state = self._updater_state
        hist = [t for s in state.values() for t in s.hist.values()]
        vel = [t for s in state.values() for t in s.velocity.values()]
        its = [s.iteration for s in state.values()]
        old_hist = torch._foreach_mul(hist, 1.0)
        old_vel = torch._foreach_mul(vel, 1.0)
        updates, _ = self._get_updater().update(grads, state,
                                                self.param_table, count)
        # scaled before velocity is committed: an update may BE velocity
        new = torch._foreach_sub(leaves, apply_lr_scale(_leaves(updates),
                                                        gstate))
        commit(ok, leaves, new, out=leaves)
        commit(ok, old_hist + old_vel, hist + vel, out=hist + vel)
        skipped = torch.logical_not(ok).to(torch.int32)
        torch._foreach_sub_(its, [skipped] * len(its))
        self._iteration_count += 1
        return score, advance(gstate, ok)

    def fit_scan(self, x, labels, batch_size: int, epochs: int = 1,
                 pad_partial: bool = False, guardian=None,
                 checkpoint_every: Optional[int] = None, saver=None,
                 sync: bool = True, start_position: int = 0,
                 start_epoch: int = 0, start_epoch_batch: int = 0):
        """Whole-epoch training: `epochs` passes over x cut into
        minibatches of `batch_size`, one train step a minibatch, the
        updater state carried through. Returns the last batch's score: a
        float (`sync=True`, the one host sync of the call), or the 0-d
        device tensor (`sync=False`: no host sync at all, unless listeners
        are attached, which are called with the score as a float).

        When the example count is not a multiple of batch_size the tail
        is dropped, unless `pad_partial=True`, which zero-pads the last
        minibatch and masks its padding rows out of the loss and the
        updater's ÷batchSize (the device feed's masking).

        `guardian=` takes the guarded step for every minibatch (a
        non-finite one is skipped on the device) and observes once per
        epoch, the ladder's cadences still counted in batches (each
        epoch advances them by n_batches); `checkpoint_every=` counts
        epochs, and the cursor (`start_*`) too."""
        conf0 = self.layers[-1].conf
        if conf0.optimization_algo.lower() != "iteration_gradient_descent":
            raise ValueError("fit_scan supports iteration_gradient_descent")
        if int(epochs) < 1:
            raise ValueError(f"epochs must be >= 1, got {epochs}")
        x, labels = self._tensor(x), self._tensor(labels)
        self._validate(x, labels, "fit_scan")
        tail = x.shape[0] % batch_size
        if pad_partial and tail:
            pad = batch_size - tail
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
            labels = torch.cat([labels,
                                labels.new_zeros((pad, *labels.shape[1:]))])
        n = x.shape[0] // batch_size * batch_size
        if n == 0:
            raise ValueError(
                f"batch_size {batch_size} exceeds {x.shape[0]} examples")
        n_batches = n // batch_size
        xb = x[:n].reshape(n_batches, batch_size, *x.shape[1:])
        yb = labels[:n].reshape(n_batches, batch_size, *labels.shape[1:])
        counts = None
        if pad_partial and tail:
            counts = torch.full((n_batches,), batch_size, dtype=torch.int32,
                                device=self.device)
            counts[-1] = tail
        batches = [(xb[i], yb[i], None if counts is None else counts[i])
                   for i in range(n_batches)]
        guard = make_guard(self, guardian, checkpoint_every, saver,
                           start_position=start_position,
                           start_epoch=start_epoch,
                           start_epoch_batch=start_epoch_batch)
        if guard is None:
            t0 = time.perf_counter()
            with span("fit_scan", epochs=int(epochs), batches=n_batches):
                score = self._scan_epochs(batches, int(epochs), None)
            steps = int(epochs) * n_batches
            _M_STEP_S.labels(source="scan").observe(
                (time.perf_counter() - t0) / max(1, steps))
            _M_STEPS.inc(steps)
            _M_EXAMPLES.inc(int(epochs) * n)
            _M_EPOCHS.inc(int(epochs))
        else:
            with guard:
                score = self._scan_epochs(batches, int(epochs), guard, n)
        score_f = self._dispatch(score, read=sync)
        return score_f if sync else score

    def _scan_epochs(self, batches, epochs: int, guard,
                     n: int = 0) -> torch.Tensor:
        """fit_scan's loop for the guarded and the plain path; with
        guard=None every guard hook is skipped (and the caller publishes
        the telemetry of the whole call), else each epoch publishes its
        own over its `n` rows. Returns the last score."""
        guarded = guard is not None and guard.guarded
        if guarded:
            self._arm(guard)
        score = None
        scan_child = _M_STEP_S.labels(source="scan")
        tags = {"guarded": True} if guarded else {}
        for _ in range(epochs):
            if guard is not None:
                guard.begin_epoch()
            t0 = time.perf_counter()
            with (span("fit_scan_epoch", **tags, batches=len(batches))
                  if guard is not None else contextlib.nullcontext()):
                for batch in batches:
                    if guarded:
                        score = self._guarded_step(guard, *batch)
                    else:
                        score = self._train_step(*batch)
            if guarded:
                self._observe(guard, score, len(batches))
            if guard is not None:
                scan_child.observe(
                    (time.perf_counter() - t0) / max(1, len(batches)))
                _M_STEPS.inc(len(batches))
                _M_EXAMPLES.inc(n)
                _M_EPOCHS.inc()
                guard.tick()
        return score

    # ----------------------------------------------------------- inference
    def feed_forward(self, x) -> List[torch.Tensor]:
        x = self._tensor(x)
        self._validate(x, context="feed_forward")
        with torch.no_grad():
            return self.feed_forward_fn(self.param_table, x)

    def output(self, x, bucketed: bool = True) -> torch.Tensor:
        """Output-layer activations (reference output :1197), on this
        network's device.

        `bucketed=True` (the default) zero-pads the batch up to the pow2
        bucket ladder and slices the padding back off (inference is per
        row), so a ragged stream meets a few batch shapes, as in the JAX
        package; `bucketed=False` runs the batch as it is."""
        if not bucketed:
            return self.feed_forward(x)[-1]
        x = self._tensor(x)
        self._validate(x, context="output")
        n = x.shape[0]
        b = bucket_for(n, (DEFAULT_MIN_BUCKET,))
        self._predict_programs.add((b, tuple(x.shape[1:]), x.dtype))
        with torch.no_grad():
            return self.feed_forward_fn(self.param_table,
                                        pad_rows(x, b))[-1][:n]

    def predict(self, x) -> np.ndarray:
        """Class predictions (reference predict :1107), on the host."""
        return self.output(x).argmax(dim=-1).cpu().numpy()

    def score(self, x, labels) -> float:
        """Mean loss on (x, labels) (reference score :1265)."""
        with torch.no_grad():
            return float(self.loss_fn(self.param_table, self._tensor(x),
                                      self._tensor(labels)))

    # ------------------------------------------------- params as flat vector
    @property
    def param_table(self) -> Dict[str, Dict[str, nn.Parameter]]:
        """The live parameters, {layer index -> {name -> tensor}}
        (reference paramTable). Assigning a table of the same names and
        shapes (tensors or numpy arrays) copies it in."""
        return {str(i): layer.param_dict()
                for i, layer in enumerate(self.layers)}

    @param_table.setter
    def param_table(self, table) -> None:
        live = self.param_table
        if set(table) != set(live):
            raise ValueError(f"param table has layers {sorted(table)}, "
                             f"the network {sorted(live)}")
        with torch.no_grad():
            for k, names in live.items():
                if set(table[k]) != set(names):
                    raise ValueError(
                        f"layer {k} has parameters {sorted(names)}, the "
                        f"table {sorted(table[k])}")
                for name, p in names.items():
                    v = table[k][name]
                    v = v if isinstance(v, torch.Tensor) else \
                        torch.tensor(np.asarray(v))
                    if tuple(v.shape) != tuple(p.shape):
                        raise ValueError(
                            f"{k}/{name}: shape {tuple(v.shape)}, the "
                            f"network's {tuple(p.shape)}")
                    p.copy_(v)

    def _packed_order(self):
        """(layer key, name, parameter) in ravel_pytree's order: sorted
        string keys at both levels."""
        table = self.param_table
        return [(k, name, table[k][name]) for k in sorted(table)
                for name in sorted(table[k])]

    def params(self) -> torch.Tensor:
        """Packed flat parameter vector (reference params :784 / pack
        :831), a new tensor on this network's device."""
        return torch.cat([p.detach().reshape(-1)
                          for _, _, p in self._packed_order()])

    def set_parameters(self, flat) -> None:
        """Install a packed vector (reference setParameters :1420 /
        unPack :920), a tensor or numpy array."""
        flat = flat if isinstance(flat, torch.Tensor) else \
            torch.tensor(np.asarray(flat))
        flat = flat.reshape(-1).to(self.device)
        if flat.numel() != self.num_params():
            raise ValueError(f"packed vector has {flat.numel()} values, the "
                             f"network {self.num_params()} parameters")
        offset = 0
        with torch.no_grad():
            for _, _, p in self._packed_order():
                p.copy_(flat[offset:offset + p.numel()].reshape(p.shape))
                offset += p.numel()

    def num_params(self) -> int:
        return sum(p.numel() for _, _, p in self._packed_order())

    def merge(self, other: "MultiLayerNetwork", n: int) -> None:
        """Parameter averaging: this += (other - this) / n (reference
        merge :1361)."""
        with torch.no_grad():
            other_table = {k: {name: p.to(self.device)
                               for name, p in t.items()}
                           for k, t in other.param_table.items()}
            self.param_table = merge_params(self.param_table, other_table, n)

    # -------------------------------------------------------- serialization
    def to_json(self) -> str:
        return self.conf.to_json()

    @classmethod
    def from_config_json(cls, s: str, params=None, device=None
                         ) -> "MultiLayerNetwork":
        return cls(MultiLayerConfiguration.from_json(s), params=params,
                   device=device)

    def clone(self) -> "MultiLayerNetwork":
        return MultiLayerNetwork.from_config_json(
            self.to_json(), params=self.params(), device=self.device)
