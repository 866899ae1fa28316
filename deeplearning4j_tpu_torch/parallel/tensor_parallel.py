"""Tensor (model) parallelism for the dense stack, the counterpart of the
JAX package's `parallel/tensor_parallel.py`.

The reference is data-parallel only (SURVEY §2.8). The plan is the JAX
package's `_param_specs`:

- eligible 2-D weight matrices (a layer whose parameters are exactly
  {W, b}, not the output layer) alternate a **column split**
  (W: P(None, model), b: P(None, model); the activations come out
  feature-split) and a **row split** (W: P(model, None), b replicated);
  a dimension the model axis does not divide leaves that layer
  replicated without flipping the alternation;
- the batch is split over the `data` axis at the same time (tp x dp on
  one 2-D mesh);
- the optimizer state (AdaGrad history, momentum) is split like its
  parameter, so the update is local to each shard.

Where GSPMD inserts the collectives from those shardings in the JAX
package, here they are Megatron's pair of autograd Functions: before a
column-split layer the input passes an identity whose backward
all-reduces over `model` (each shard saw only its columns' share of the
input's gradient), and after a row-split layer's product a `psum` over
`model` (identity backward), with the bias added after the reduce; a
replicated layer after a column split first gathers the features over
`model` (GSPMD's resharding). The loss is then the same on every rank of
a model group, the gradients of
the data axis are all-reduced as in `DataParallelTrainer`, and L2 over a
split weight sums its shards' squares over `model`.

Each rank holds its shards during `fit` (sliced from the network's full
parameters when the fit starts), and the full parameters and optimizer
state are gathered back into the network at its end (and before each
autosave), so `net.output` / `net.params()` work as in the JAX package.
The guarded step's finite predicate is reduced over both axes: a NaN on
any shard skips the update everywhere. `constrain_gradient_to_unit_norm`
needs a norm over split layers and is rejected here.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers import apply_dropout, torch_dtype
from deeplearning4j_tpu_torch.ops.activations import apply_activation
from deeplearning4j_tpu_torch.ops.products import matmul_f32
from deeplearning4j_tpu_torch.optimize.updater import UpdaterState
from deeplearning4j_tpu_torch.parallel import collectives as C
from deeplearning4j_tpu_torch.parallel.data_parallel import \
    DataParallelTrainer
from deeplearning4j_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, P,
                                                    Placement)

__all__ = ["TensorParallelTrainer"]


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce over the model axis
    backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        return C.all_reduce_(g, ctx.mesh, ctx.axis), None, None


class TensorParallelTrainer(DataParallelTrainer):
    """tp x dp training: batch over `data`, alternating column/row weight
    splits over `model`. The mesh must carry BOTH axes."""

    def __init__(self, network, mesh, model_axis: str = MODEL_AXIS,
                 axis: str = DATA_AXIS):
        if model_axis not in mesh.axis_names:
            raise ValueError(
                f"mesh {mesh.axis_names} has no {model_axis!r} axis")
        self.model_axis = model_axis
        self.tp = int(mesh.shape[model_axis])
        super().__init__(network, mesh, axis=axis)
        self._specs = self._param_specs()
        if not any(s != P() for table in self._specs.values()
                   for s in table.values()):
            raise ValueError(
                f"no layer is splittable over {self.tp} model shards "
                "(need 2-D dense weights with divisible dims)")
        if any(layer.conf.constrain_gradient_to_unit_norm
               for layer in network.layers):
            raise ValueError(
                "constrain_gradient_to_unit_norm needs a norm over split "
                "layers; use DataParallelTrainer")
        self._kinds = {}
        for k, t in self._specs.items():
            w = t.get("W")
            self._kinds[k] = ("col" if w == P(None, model_axis) else
                              "row" if w == P(model_axis, None) else None)
        self._tp_params = None
        self._tp_state = None

    # ------------------------------------------------------------ shardings
    def _param_specs(self):
        """Per-layer {name: PartitionSpec}, alternating col/row splits
        over eligible layers; the LAST layer (output head) replicates."""
        net = self.network
        table_all = net.param_table
        specs = {}
        col_next = True
        last = len(net.layers) - 1
        for i in range(len(net.layers)):
            table = table_all[str(i)]
            layer_spec = {name: P() for name in table}
            w = table.get("W")
            eligible = (w is not None and w.dim() == 2
                        and set(table) <= {"W", "b"} and i != last)
            if eligible:
                n_in, n_out = w.shape
                if col_next and n_out % self.tp == 0:
                    layer_spec["W"] = P(None, self.model_axis)
                    if "b" in table:  # b is (1, n_out): split its lanes
                        b = table["b"]
                        layer_spec["b"] = (P(None, self.model_axis)
                                           if b.dim() == 2
                                           else P(self.model_axis))
                    col_next = False
                elif not col_next and n_in % self.tp == 0:
                    layer_spec["W"] = P(self.model_axis, None)
                    # b adds to the psum-unsplit output: replicated
                    col_next = True
                # an indivisible dim leaves the layer replicated and the
                # alternation state unchanged (the chain stays coherent)
            specs[str(i)] = layer_spec
        return specs

    def sharding_summary(self):
        """{layer: {param: spec}} for logging/tests."""
        return {k: {n: str(s) for n, s in t.items()}
                for k, t in self._param_specs().items()}

    # --------------------------------------------------- shards in and out
    def _split(self, k, name, t):
        return Placement(self.mesh, self._specs[k][name]).local(t)

    def _gather(self, k, name, t):
        spec = self._specs[k][name]
        if spec == P():
            return t
        dim = list(spec).index(self.model_axis)
        return C.all_gather(t.detach().contiguous(), self.mesh,
                            self.model_axis, dim=dim)

    @torch.no_grad()
    def _begin_fit(self) -> None:
        net = self.network
        full = net.param_table
        if net._updater_state is None:
            net._updater_state = self.updater.init(full)
        self._tp_params = {
            k: {n: self._split(k, n, p).detach().clone().requires_grad_(True)
                for n, p in t.items()} for k, t in full.items()}
        self._tp_state = {
            k: UpdaterState(
                hist={n: self._split(k, n, h).clone()
                      for n, h in s.hist.items()},
                velocity={n: self._split(k, n, v).clone()
                          for n, v in s.velocity.items()},
                iteration=s.iteration.clone())
            for k, s in net._updater_state.items()}

    @torch.no_grad()
    def _end_fit(self) -> None:
        """Gather the full parameters and optimizer state into the
        network (every rank of the model axis joins)."""
        if self._tp_params is None:
            return
        net = self.network
        net.param_table = {k: {n: self._gather(k, n, p)
                               for n, p in t.items()}
                           for k, t in self._tp_params.items()}
        net._updater_state = {
            k: UpdaterState(
                hist={n: self._gather(k, n, h) for n, h in s.hist.items()},
                velocity={n: self._gather(k, n, v)
                          for n, v in s.velocity.items()},
                iteration=s.iteration.clone())
            for k, s in self._tp_state.items()}

    def _save(self, saver, position, meta):
        self._end_fit()  # every rank joins the gathers, then one writes
        return super()._save(saver, position, meta)

    def _params(self):
        return self._tp_params, self._tp_state

    def _live(self):
        return self._tp_params, self._tp_state

    @torch.no_grad()
    def _restore_live(self, live) -> None:
        params, state = live
        for k, t in params.items():
            for n, p in t.items():
                self._tp_params[k][n].copy_(p)
        for k, s in state.items():
            mine = self._tp_state[k]
            for n in s.hist:
                mine.hist[n].copy_(s.hist[n])
                mine.velocity[n].copy_(s.velocity[n])
            mine.iteration.copy_(s.iteration)

    _finite_axes = property(lambda self: (self.axis, self.model_axis))

    # -------------------------------------------------------------- forward
    def _gather_features(self, x):
        return C.all_gather(x.contiguous(), self.mesh, self.model_axis,
                            dim=x.dim() - 1)

    def _row_activate(self, layer, params, x, rng, training):
        """A row-split dense layer: the local product, psum over `model`,
        then the bias and the activation."""
        c = layer.conf
        cd = torch_dtype(c.compute_dtype)
        y = matmul_f32(x.to(cd), params["W"].to(cd))
        y = C.psum(y, self.mesh, self.model_axis)
        act = apply_activation(c.activation_function,
                               y.to(torch_dtype(c.dtype)) + params["b"])
        return apply_dropout(rng, act, c.dropout, training)

    def _loss(self, params, x, labels, weights):
        net = self.network
        rng = self._gen
        n = len(net.layers)
        cur = x
        split = False  # whether `cur` holds this rank's feature columns
        for i, layer in enumerate(net.layers[:-1]):
            k = str(i)
            if split and self._kinds[k] != "row":
                # a replicated layer after a column split: gather the
                # features (what GSPMD's resharding does)
                cur, split = self._gather_features(cur), False
            cur = net._layer_input(i, cur, rng=rng)
            if self._kinds[k] == "col":
                cur = layer.activate(
                    params[k], _CopyToModel.apply(cur, self.mesh,
                                                  self.model_axis),
                    rng=rng, training=True)
                split = True
            elif self._kinds[k] == "row":
                cur = self._row_activate(layer, params[k], cur, rng, True)
                split = False
            else:
                cur = layer.activate(params[k], cur, rng=rng, training=True)
            cur = net._layer_output(i, cur)
        if split:
            cur = self._gather_features(cur)
        cur = net._layer_input(n - 1, cur, rng=rng)
        score = net.layers[-1].loss(params[str(n - 1)], cur, labels,
                                    rng=rng, training=True, weights=weights)
        for i, layer in enumerate(net.layers):
            c = layer.conf
            if c.use_regularization and c.l2 > 0:
                for name, value in params[str(i)].items():
                    if not layer.is_bias(name):
                        sq = torch.square(value).sum()
                        if self._specs[str(i)][name] != P():
                            sq = C.psum(sq, self.mesh, self.model_axis)
                        score = score + 0.5 * c.l2 * sq
        return score
