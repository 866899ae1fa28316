"""Epoch-wave parameter averaging over a mesh of ranks, the counterpart
of the JAX package's `parallel/averaging.py`.

Parity: the reference's iterative-reduce semantics: each worker takes K
local fit steps on its own batches, then the parameters are averaged
(`MultiLayerNetwork.merge` :1361 / INDArrayAggregator.java:35-59 /
Spark fold(Add)/n, SparkDl4jMultiLayer.java:172-174). A wave is
n_ranks * K consecutive batches of the iterator: rank r takes batches
[r*K, (r+1)*K) of it, steps through them, and the wave ends with a
`pmean` of the parameters and of the updater state (integer leaves, the
iteration counter, take `pmax` and stay integer).

As in the JAX package a local step passes no batch count to the updater
(AdaGrad's /batchSize does not apply), and a ragged tail wave is tiled
up to the full grid by repeating its batches, each batch's rows tiled
up to the wave's largest batch.

`DataParallelTrainer` (per-step gradient all-reduce) is the tighter-sync
mode that usually trains better per step.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.updater import NetworkGradientUpdater
from deeplearning4j_tpu_torch.parallel import collectives as C
from deeplearning4j_tpu_torch.parallel.data_parallel import all_reduce_flat
from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh

__all__ = ["ParameterAveragingTrainer"]


class ParameterAveragingTrainer:
    """K local steps per rank, then a pmean parameter average per wave."""

    def __init__(self, network, mesh=None, axis: str = DATA_AXIS,
                 local_steps: int = 4):
        self.network = network
        self.mesh = mesh if mesh is not None else make_mesh(
            device=network.device)
        self.axis = axis
        self.local_steps = local_steps
        self.n_devices = self.mesh.size
        self.updater = NetworkGradientUpdater.for_network(network)
        self._gen = torch.Generator(device=network.device)

    @torch.no_grad()
    def _wave(self, batches):
        """This rank's K steps, then the average; returns the pmean of the
        ranks' mean scores."""
        net = self.network
        params = net.param_table
        if net._updater_state is None:
            net._updater_state = self.updater.init(params)
        state = net._updater_state
        leaves = [p for t in params.values() for p in t.values()]
        scores = []
        for x, y in batches:
            with torch.enable_grad():
                score = net.loss_fn(params, x, y, rng=self._gen,
                                    training=True)
                grads_flat = torch.autograd.grad(
                    score, leaves, allow_unused=True,
                    materialize_grads=True)
            it = iter(grads_flat)
            grads = {k: {n: next(it) for n in t} for k, t in params.items()}
            updates, _ = self.updater.update(grads, state, params)
            for p, u in zip(leaves, [u for t in updates.values()
                                     for u in t.values()]):
                p.sub_(u)
            scores.append(score.detach())
        # THE iterative-reduce average; integer leaves (the updater's
        # iteration counter, identical on every rank) take the max
        n = self.mesh.axis_size(self.axis)
        floats = leaves + [t for s in state.values()
                           for t in (*s.hist.values(), *s.velocity.values())]
        all_reduce_flat(floats, self.mesh, self.axis)
        torch._foreach_div_(floats, float(n))
        for s in state.values():
            s.iteration.copy_(C.pmax(s.iteration.reshape(1), self.mesh,
                                     self.axis)[0])
        score = torch.stack(scores).mean().reshape(1)
        return C.pmean(score, self.mesh, self.axis)[0]

    def fit(self, iterator, epochs: int = 1) -> None:
        """Consume the iterator in waves of n_ranks * local_steps
        batches."""
        net = self.network
        score = None
        waves = 0
        need = self.n_devices * self.local_steps
        for _ in range(epochs):
            iterator.reset()
            batch = []
            for ds in iterator:
                batch.append((np.asarray(ds.features), np.asarray(ds.labels)))
                if len(batch) == need:
                    score = self._run_wave(batch)
                    waves += 1
                    batch = []
            if batch:  # tail wave: tile to fill the grid
                idx = np.arange(need) % len(batch)
                score = self._run_wave([batch[i] for i in idx])
                waves += 1
        if waves:
            for listener in net.listeners:
                listener.iteration_done(net, waves - 1, float(score))

    @staticmethod
    def _pad_rows(arr: np.ndarray, rows: int) -> np.ndarray:
        """Tile a ragged tail batch up to the wave's uniform batch size."""
        if arr.shape[0] == rows:
            return arr
        idx = np.arange(rows) % arr.shape[0]
        return arr[idx]

    def _run_wave(self, batch):
        net = self.network
        k = self.local_steps
        rows = max(b[0].shape[0] for b in batch)
        r = self.mesh.linear_index(self.axis)
        mine = [(net._tensor(self._pad_rows(x, rows)),
                 net._tensor(self._pad_rows(y, rows)))
                for x, y in batch[r * k:(r + 1) * k]]
        self._gen.manual_seed(
            (net._next_seed() * 1000003 + self.mesh.rank) % (1 << 63))
        with self.mesh:
            return self._wave(mine)
