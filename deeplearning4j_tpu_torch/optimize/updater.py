"""Per-variable gradient adjustment, the counterpart of the JAX
package's `optimize/updater.py`.

Parity: reference core/optimize/GradientAdjustment.
updateGradientAccordingToParams (GradientAdjustment.java:66-113):
AdaGrad-or-plain-lr scaling, momentum with an iteration-indexed
schedule, optional unit-norm constraint, and the final ÷batchSize,
which the JAX package keeps only on the AdaGrad branch (its losses are
means, so on the plain-lr branch the division is already done; AdaGrad
normalises the gradient's scale away, so there it is a real 1/B step
factor; see the JAX module's docstring). L2 lives in the loss.

State is {hist, velocity, iteration}: the AdaGrad accumulator and the
momentum buffer, two distinct buffers shaped like the parameters, and
the iteration count as a 0-d int32 tensor on the parameters' device.
`update` changes the state in place under `torch.no_grad()` and returns
the updates to subtract; the momentum schedule is picked on the device
from the iteration tensor, so a step reads nothing back to the host.

The arithmetic is the JAX package's, operation for operation, on lists
of tensors (`torch._foreach_*`): one launch an operation for all the
leaves of the layers that share an update rule, not one a leaf.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple

import torch

ADAGRAD_EPS = 1e-6


class UpdaterState(NamedTuple):
    hist: Any  # AdaGrad accumulator, same table as the layer's params
    velocity: Any  # momentum buffer
    iteration: torch.Tensor  # 0-d int32


def _rule(conf, divide_by_batch: bool) -> tuple:
    """What decides a layer's update arithmetic: layers with equal rules
    are updated together."""
    return (conf.lr, conf.use_adagrad, conf.momentum,
            tuple(sorted((int(k), v) for k, v in conf.momentum_after.items())),
            conf.dtype, _divides(conf, divide_by_batch))


def _divides(conf, divide_by_batch: bool) -> bool:
    """Whether the ÷batchSize applies: on AdaGrad, or when asked."""
    return bool(conf.use_adagrad or divide_by_batch)


def _momentum_at(conf, iteration):
    """Piecewise-constant momentum schedule (GradientAdjustment.java:79):
    a Python float without a schedule, else a float32 device scalar."""
    m = float(conf.momentum)
    for after, value in sorted(conf.momentum_after.items()):
        m = torch.where(iteration >= int(after), float(value), m)
    return m


@torch.no_grad()
def _adjust(conf, divide_by_batch, grads: List[torch.Tensor],
            hist: List[torch.Tensor], velocity: List[torch.Tensor],
            iteration, batch_size) -> List[torch.Tensor]:
    """One update over lists of leaves sharing `conf`'s rule: hist and
    velocity change in place; returns the updates."""
    if conf.use_adagrad:
        torch._foreach_add_(hist, torch._foreach_mul(grads, grads))
        denom = torch._foreach_sqrt(hist)
        torch._foreach_add_(denom, ADAGRAD_EPS)
        scaled = torch._foreach_mul(grads, conf.lr)
        torch._foreach_div_(scaled, denom)
    else:
        scaled = torch._foreach_mul(grads, conf.lr)
    torch._foreach_mul_(velocity, _momentum_at(conf, iteration))
    torch._foreach_add_(velocity, scaled)
    updates = velocity
    if conf.constrain_gradient_to_unit_norm:
        norm = torch.linalg.vector_norm(
            torch.cat([u.reshape(-1) for u in updates])) + 1e-12
        updates = torch._foreach_div(updates, norm)
    if _divides(conf, divide_by_batch):
        if isinstance(batch_size, (int, float)):
            if batch_size > 1:
                updates = torch._foreach_div(updates, float(batch_size))
        else:
            bs = torch.clamp_min(batch_size, 1).to(updates[0].dtype)
            updates = torch._foreach_div(updates, bs)
    return updates


class GradientUpdater:
    """The update transform of one layer's conf, over that layer's
    parameter table."""

    def __init__(self, conf, divide_by_batch: bool = False):
        self.conf = conf
        self.divide_by_batch = divide_by_batch

    def init(self, params) -> UpdaterState:
        device = next(iter(params.values())).device
        return UpdaterState(
            hist={k: torch.zeros_like(p) for k, p in params.items()},
            velocity={k: torch.zeros_like(p) for k, p in params.items()},
            iteration=torch.zeros((), dtype=torch.int32, device=device))

    @torch.no_grad()
    def update(self, grads, state: UpdaterState, params, batch_size=1):
        """Returns (updates, state), the state changed in place; apply as
        params -= updates (minimize).

        `batch_size` is a Python int (divides only when above 1) or a
        0-d int tensor on the device (the device feed's real count;
        clamped to at least 1 and divided in the leaves' dtype)."""
        names = list(params)
        ups = _adjust(self.conf, self.divide_by_batch,
                      [grads[k] for k in names],
                      [state.hist[k] for k in names],
                      [state.velocity[k] for k in names],
                      state.iteration, batch_size)
        state.iteration.add_(1)
        return dict(zip(names, ups)), state


class NetworkGradientUpdater:
    """Per-layer GradientAdjustment over {layer index -> param table}:
    each layer's update follows that layer's conf, so per-layer
    overrides such as `ListBuilder.override(0, lr=...)` hold on the
    whole-network backprop path too. Layers whose confs give the same
    rule are updated in one pass of list operations (a unit-norm
    constraint is per layer, so such a layer goes alone)."""

    def __init__(self, confs_by_key: Dict[str, object],
                 divide_by_batch: bool = False):
        self.updaters = {k: GradientUpdater(c, divide_by_batch)
                         for k, c in confs_by_key.items()}
        self.groups: Dict[tuple, List[str]] = {}
        for k, c in confs_by_key.items():
            rule = _rule(c, divide_by_batch)
            if c.constrain_gradient_to_unit_norm:
                rule += (k,)
            self.groups.setdefault(rule, []).append(k)

    @classmethod
    def for_network(cls, network) -> "NetworkGradientUpdater":
        return cls({str(i): layer.conf
                    for i, layer in enumerate(network.layers)})

    def init(self, params) -> Dict[str, UpdaterState]:
        return {k: upd.init(params[k]) for k, upd in self.updaters.items()}

    @torch.no_grad()
    def update(self, grads, state, params, batch_size=1):
        updates: Dict[str, Dict[str, torch.Tensor]] = {}
        for keys in self.groups.values():
            leaves = [(k, n) for k in keys for n in params[k]]
            upd = self.updaters[keys[0]]
            ups = _adjust(upd.conf, upd.divide_by_batch,
                          [grads[k][n] for k, n in leaves],
                          [state[k].hist[n] for k, n in leaves],
                          [state[k].velocity[n] for k, n in leaves],
                          state[keys[0]].iteration, batch_size)
            for (k, n), u in zip(leaves, ups):
                updates.setdefault(k, {})[n] = u
        torch._foreach_add_([s.iteration for s in state.values()], 1)
        # in the params' order: the groups interleave layers whose rules
        # differ, and callers zip the updates with the params' leaves
        return {k: {n: updates[k][n] for n in params[k]}
                for k in params}, state
