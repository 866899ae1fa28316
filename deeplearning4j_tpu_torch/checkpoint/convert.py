"""Canonical <-> flat optimizer-state conversion, the counterpart of the
JAX package's `checkpoint/convert.py`.

Checkpoints store optimizer state in one canonical form, the per-layer
``{layer: UpdaterState(hist, velocity, iteration)}`` tree mirroring the
parameter table. A trainer that keeps FLAT vectors instead (the ZeRO-1
trainer, `parallel/sharded_update.py`, of either package) converts
here: pure host reshapes, no arithmetic, so a conversion is bit-exact
both ways.

The flat order is `ravel_table`'s (optimize/solvers.py), which is the
JAX package's `ravel_pytree` order: sorted string keys at every level,
so layer "10" packs before layer "2" at 11 or more layers.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.updater import UpdaterState

__all__ = ["layer_slices", "flat_to_updater_state", "updater_state_to_flat",
           "ravel_tree"]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.float()  # the flat vectors are float32
        return a.numpy()
    return np.asarray(a)


def _leaves(tree):
    """(path, leaf) in ravel_table's order: sorted keys at every level."""
    if isinstance(tree, dict):
        return [(((k,) + p), leaf) for k in sorted(tree)
                for p, leaf in _leaves(tree[k])]
    return [((), tree)]


def ravel_tree(tree) -> np.ndarray:
    """A parameter tree ({layer: {name: array}}, or one array) as one
    flat host vector, leaves in sorted-key order: the packed vector the
    JAX package's `ravel_pytree` gives for the same tree (bfloat16 leaves
    widened to float32). Host reshapes only."""
    parts = [_host(leaf).reshape(-1) for _, leaf in _leaves(tree)]
    if not parts:
        raise ValueError("ravel_tree: the tree holds no array leaf")
    return np.concatenate(parts)


def _size(leaf) -> int:
    return int(np.prod(tuple(leaf.shape))) if tuple(leaf.shape) else 1


def layer_slices(params: Dict[str, dict]) -> Dict[str, Tuple[int, int]]:
    """{layer_key: (offset, size)} of each layer's slice of the packed
    vector, layers in sorted-key order."""
    out = {}
    offset = 0
    for key in sorted(params):
        size = sum(_size(leaf) for _, leaf in _leaves(params[key]))
        out[key] = (offset, size)
        offset += size
    return out


def _unravel(like_tree, vec: np.ndarray):
    """`vec` cut into `like_tree`'s structure and shapes (numpy leaves),
    in sorted-key order."""
    if not isinstance(like_tree, dict):
        return np.asarray(vec).reshape(tuple(like_tree.shape))
    out, off = {}, 0
    for path, leaf in _leaves(like_tree):
        n = _size(leaf)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.asarray(vec[off:off + n]).reshape(
            tuple(leaf.shape))
        off += n
    return out


def flat_to_updater_state(hist, velocity, iteration,
                          params: Dict[str, dict]) -> Dict[str, dict]:
    """Flat vectors -> the canonical per-layer UpdaterState tree.

    `hist`/`velocity` are the UNPADDED packed vectors (length == total
    param count; longer inputs are treated as device-count padding and
    sliced off); `iteration` is the shared scalar, given to every layer
    (the trainers advance all layers in lockstep). Leaves come back as
    host (numpy) arrays."""
    hist = _host(hist)
    velocity = _host(velocity)
    slices = layer_slices(params)
    total = sum(size for _, size in slices.values())
    if hist.size < total or velocity.size < total:
        raise ValueError(
            f"flat optimizer state has {min(hist.size, velocity.size)} "
            f"elements but the network packs {total} parameters — "
            "checkpoint does not match this architecture")
    it = np.asarray(_host(iteration), np.int32)
    state = {}
    for key, (off, size) in slices.items():
        state[key] = UpdaterState(
            hist=_unravel(params[key], hist[off:off + size]),
            velocity=_unravel(params[key], velocity[off:off + size]),
            iteration=it)
    return state


def updater_state_to_flat(state: Dict[str, dict], params: Dict[str, dict]
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The canonical per-layer UpdaterState tree -> flat vectors
    (UNPADDED). Returns (hist, velocity, iteration) host arrays."""
    hists, vels = [], []
    iteration = None
    for key in sorted(params):
        if key not in state:
            raise ValueError(
                f"updater state has no entry for layer {key!r} — "
                "checkpoint does not match this architecture")
        st = state[key]
        h = [_host(v).reshape(-1) for _, v in _leaves(st.hist)]
        v = [_host(x).reshape(-1) for _, x in _leaves(st.velocity)]
        n_h, n_v = sum(a.size for a in h), sum(a.size for a in v)
        n_p = layer_slices({key: params[key]})[key][1]
        if n_h != n_p or n_v != n_p:
            raise ValueError(
                f"layer {key!r}: updater state packs {n_h} "
                f"elements, params pack {n_p} — mismatched "
                "architecture")
        hists.extend(np.asarray(a, np.float32) for a in h)
        vels.extend(np.asarray(a, np.float32) for a in v)
        if iteration is None:
            iteration = np.asarray(_host(st.iteration), np.int32)
    return (np.concatenate(hists), np.concatenate(vels),
            np.asarray(iteration, np.int32))
