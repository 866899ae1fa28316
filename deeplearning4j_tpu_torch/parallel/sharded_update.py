"""Weight-update (optimizer-state) sharding for data-parallel training,
the counterpart of the JAX package's `parallel/sharded_update.py`.

Technique: "Automatic Cross-Replica Sharding of Weight Update in
Data-Parallel Training" (Xu et al., arXiv:2004.13336), which became
ZeRO-1: instead of every rank holding the whole optimizer state and
applying the whole update, the update is sharded over the data axis.
The gradient all-reduce becomes a reduce-scatter, each rank updates its
shard, and an all-gather brings the new parameters back: the same math,
1/n of the optimizer memory and update work a rank.

The JAX package lets GSPMD place those collectives from two sharding
constraints; here they are explicit (`parallel/collectives.py`). The
optimizer state is FLAT: two float32 vectors (AdaGrad history, momentum
velocity) over the packed parameter vector (`ravel_table`'s order,
sorted string keys: layer "10" packs before "2"), padded to a multiple
of the data-axis size, of which each rank keeps its slice, plus the
iteration count. The update runs on the slice with per-element
hyperparameter tables (each layer's lr / AdaGrad flag / momentum
schedule over its own slice), reproducing NetworkGradientUpdater's
per-layer arithmetic, except `constrain_gradient_to_unit_norm`, which
needs a global norm and is rejected.

Checkpoints: autosaves gather the flat state (every rank joins the
all-gather, at the same batch) into the canonical per-layer form on the
network (`checkpoint/convert.py`), written from the first rank, so any
trainer on any rank count restores it (`restore_flat_state`). A
preemption flush on several ranks saves the parameters only and records
`zero1_flat_state_skipped`: SIGTERM reaches ranks at different batches,
and an all-gather entered there would mismatch across ranks. The step
and the guarded step go through DataParallelTrainer's program-store
hook (`_program`), under this class's own key.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.guardian import advance, all_finite
from deeplearning4j_tpu_torch.optimize.solvers import ravel_table
from deeplearning4j_tpu_torch.optimize.updater import ADAGRAD_EPS
from deeplearning4j_tpu_torch.parallel import collectives as C
from deeplearning4j_tpu_torch.parallel.data_parallel import \
    DataParallelTrainer

__all__ = ["ShardedUpdateTrainer"]


class ShardedUpdateTrainer(DataParallelTrainer):
    """DataParallelTrainer with ZeRO-1-style sharded optimizer state.

    Same fit() surface; the optimizer state lives as flat (padded)
    vectors, each rank holding its slice of the data axis."""

    def __init__(self, network, mesh=None, axis: str = "data"):
        self._prep_tables(network)
        super().__init__(network, mesh, axis)
        if any(layer.conf.constrain_gradient_to_unit_norm
               for layer in network.layers):
            raise ValueError(
                "constrain_gradient_to_unit_norm needs a global norm; "
                "use DataParallelTrainer")
        self._flat_state = None
        self._build_tables()

    def _prep_tables(self, network) -> None:
        # the flat order is ravel_table's: layers by SORTED string key
        # ('0', '1', '10', '11', '2', ...), so the tables follow it or
        # hyperparameters land on the wrong layers' slices at 11+ layers
        sizes = []
        lrs, adagrads, moms = [], [], []
        self._layer_confs = []
        table = network.param_table
        for key in sorted(table):
            c = network.layers[int(key)].conf
            size = sum(p.numel() for p in table[key].values())
            sizes.append(size)
            self._layer_confs.append(c)
            lrs.append(np.full(size, c.lr, np.float32))
            adagrads.append(np.full(size, float(c.use_adagrad), np.float32))
            moms.append(np.full(size, c.momentum, np.float32))
        self._sizes = sizes
        self._lr_vec = np.concatenate(lrs)
        self._adagrad_vec = np.concatenate(adagrads)
        self._mom_vec = np.concatenate(moms)

    # ------------------------------------------------------------- padding
    def _pad(self, n: int) -> int:
        return (n + self.n_devices - 1) // self.n_devices * self.n_devices

    def _shard(self) -> slice:
        """This rank's slice of the padded flat vectors."""
        size = self._n_pad // self._data_size
        i = self.mesh.linear_index(self.axis)
        return slice(i * size, (i + 1) * size)

    def _build_tables(self) -> None:
        dev = self.network.device
        self._n = int(sum(self._sizes))
        self._n_pad = self._pad(self._n)
        pad = self._n_pad - self._n
        sl = self._shard()

        def vec(a):
            return torch.from_numpy(np.pad(a, (0, pad))[sl].copy()).to(dev)

        self._lr_t = vec(self._lr_vec)
        self._ada_t = vec(self._adagrad_vec)
        self._mom_t = vec(self._mom_vec)
        offsets = np.cumsum([0, *self._sizes])
        # momentum_after schedules: (segment mask on my slice, base,
        # [(after, value), ...]) per scheduled layer
        self._sched = []
        for i, c in enumerate(self._layer_confs):
            if c.momentum_after:
                seg = np.zeros(self._n_pad, np.float32)
                seg[offsets[i]:offsets[i + 1]] = 1.0
                self._sched.append((
                    torch.from_numpy(seg[sl].copy()).to(dev),
                    float(c.momentum),
                    sorted((int(a), float(v))
                           for a, v in c.momentum_after.items())))

    def _mom_at(self, it):
        m = self._mom_t
        for seg, base, steps in self._sched:
            mi = torch.full((), base, dtype=torch.float32, device=m.device)
            for after, value in steps:
                mi = torch.where(it >= after, value, mi)
            m = m * (1 - seg) + mi * seg
        return m

    def _init_flat_state(self) -> None:
        dev = self.network.device
        size = self._n_pad // self._data_size
        self._flat_state = (torch.zeros(size, dtype=torch.float32,
                                        device=dev),
                            torch.zeros(size, dtype=torch.float32,
                                        device=dev),
                            torch.zeros((), dtype=torch.int32, device=dev))

    # ---------------------------------------------------------------- step
    def _reduce(self, score, grads):
        """Sum only the loss here: the gradient is reduce-scattered."""
        score = score.reshape(1)
        C.all_reduce_(score, self.mesh, self.axis)
        return score[0]

    def _flat_update(self, x, labels, n_valid, gstate=None):
        params = self.network.param_table
        score, grads, count = self._grads(params, x, labels, n_valid)
        if n_valid is not None:
            count = torch.clamp_min(count, 1).to(torch.float32)
        flat_g, _ = ravel_table(grads)
        flat_g = torch.nn.functional.pad(flat_g.float(),
                                         (0, self._n_pad - self._n))
        # the reduce-scatter point: this rank keeps its summed slice
        g = C.reduce_scatter(flat_g, self.mesh, self.axis)
        hist, vel, it = self._flat_state
        ada = self._ada_t > 0
        new_hist = hist + self._ada_t * torch.square(g)
        scaled = torch.where(
            ada, self._lr_t * g / (torch.sqrt(torch.clamp_min(new_hist, 0.0))
                                   + ADAGRAD_EPS),
            self._lr_t * g)
        new_vel = self._mom_at(it) * vel + scaled
        # the reference divides the whole velocity by batchSize on the
        # AdaGrad branch (as NetworkGradientUpdater does)
        update = torch.where(ada, new_vel / count, new_vel)
        flat_p, unravel = ravel_table(params)
        p = torch.nn.functional.pad(flat_p.float(),
                                    (0, self._n_pad - self._n))[self._shard()]
        if gstate is None:
            new_p, state = p - update, (new_hist, new_vel, it + 1)
        else:
            # the finite predicate over my slice, summed over the data
            # axis: every rank sees the same commit / skip decision
            ok = all_finite(score, g, axis_name=self.axis)
            new_p = torch.where(ok, p - update * gstate.lr_scale, p)
            state = (torch.where(ok, new_hist, hist),
                     torch.where(ok, new_vel, vel),
                     torch.where(ok, it + 1, it))
            gstate = advance(gstate, ok)
        self._flat_state = state
        # the all-gather point: every rank gets the whole new vector
        full = unravel(C.all_gather(new_p, self.mesh, self.axis)[:self._n])
        for k, t in params.items():
            for name, live in t.items():
                live.copy_(full[k][name])
        return score, gstate

    @torch.no_grad()
    def _step(self, x, labels, n_valid=None):
        return self._flat_update(x, labels, n_valid)[0]

    @torch.no_grad()
    def _gstep(self, x, labels, n_valid, gstate):
        return self._flat_update(x, labels, n_valid, gstate)

    def _live(self):
        return self.network.param_table, self._flat_state

    def _restore_live(self, live) -> None:
        self.network.param_table = live[0]
        self._flat_state = tuple(t.clone() for t in live[1])

    # ------------------------------------------------------------- state
    def gathered_flat_state(self):
        """(hist, velocity, iteration) as whole UNPADDED host arrays (an
        all-gather: every rank of the data axis must call it)."""
        hist, vel, it = self._flat_state
        return (C.all_gather(hist, self.mesh, self.axis)[:self._n].cpu()
                .numpy(),
                C.all_gather(vel, self.mesh, self.axis)[:self._n].cpu()
                .numpy(), np.asarray(it.cpu(), np.int32))

    def _save(self, saver, position, meta):
        from deeplearning4j_tpu_torch.checkpoint.convert import \
            flat_to_updater_state
        from deeplearning4j_tpu_torch.scaleout.checkpoint import map_arrays

        net = self.network
        meta = dict(meta)
        if meta.get("save_kind") == "preempt" and self._data_size > 1:
            meta["zero1_flat_state_skipped"] = (
                "multi-host preemption flush skips the optimizer-state "
                "allgather; resume optimizer state from the last "
                "periodic autosave")
        else:
            # every rank joins the gather; the vectors land UNPADDED in
            # the canonical per-layer form on the network
            hist, vel, it = self.gathered_flat_state()
            state = flat_to_updater_state(hist, vel, it, net.param_table)
            net._updater_state = map_arrays(
                lambda a: torch.as_tensor(np.asarray(a)).to(net.device),
                state)
        return super()._save(saver, position, meta)

    def fit(self, iterator, epochs: int = 1,
            device_feed: Optional[bool] = None, guardian=None,
            checkpoint_every: Optional[int] = None, saver=None) -> None:
        """ZeRO-1 fit; guardian / autosave as DataParallelTrainer.
        Autosaves gather the flat optimizer state into the checkpoint's
        canonical per-layer form (unpadded: any rank count restores it);
        reinstall it with `restore_flat_state(info['metadata'])` after
        rebuilding the trainer on the restored network."""
        if self._flat_state is None:
            self._init_flat_state()
        return super().fit(iterator, epochs, device_feed, guardian,
                           checkpoint_every, saver)

    def _params(self):
        return self.network.param_table, None

    def restore_flat_state(self, metadata: Optional[dict] = None) -> None:
        """Reinstall the optimizer state from a checkpoint, re-sliced over
        THIS trainer's mesh (the rank count it was saved under no longer
        matters):

        - `metadata` carrying `zero1_flat_state` (a legacy ZeRO-1
          autosave): the vectors taken unpadded, re-padded to this mesh,
          and this rank's slice kept;
        - otherwise the canonical per-layer UpdaterState tree on the
          network (a checkpoint of any trainer) is flattened
          (checkpoint/convert.py). Bit-identical either way."""
        from deeplearning4j_tpu_torch.checkpoint.convert import \
            updater_state_to_flat

        net = self.network
        n = self._n
        state = (metadata or {}).get("zero1_flat_state")
        if state is not None:
            hist = np.asarray(state["hist"])
            vel = np.asarray(state["velocity"])
            it = np.asarray(state["iteration"])
            if hist.size < n or vel.size < n:
                raise ValueError(
                    f"zero1_flat_state packs {min(hist.size, vel.size)} "
                    f"elements but this network packs {n} — checkpoint "
                    "does not match the architecture")
            hist, vel = hist[:n], vel[:n]
        else:
            if net._updater_state is None:
                raise ValueError(
                    "no optimizer state to restore: metadata carries no "
                    "zero1_flat_state and the network has no updater "
                    "state (checkpoint saved before any training step?)")
            hist, vel, it = updater_state_to_flat(net._updater_state,
                                                  net.param_table)
        pad = self._n_pad - n
        sl = self._shard()
        dev = net.device

        def vec(a):
            a = np.pad(np.asarray(a, np.float32), (0, pad))[sl]
            return torch.from_numpy(a.copy()).to(dev)

        self._flat_state = (vec(hist), vec(vel),
                            torch.as_tensor(np.asarray(it, np.int32)).to(dev))
