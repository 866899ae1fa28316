"""Carry parameters between the JAX package and the port, as numpy.

Both packages keep transformer parameters as the same nested structure of
dicts and lists with the same keys, so the transfer is a walk over that
structure: `params_from_jax` turns a tree of numpy arrays (e.g.
`jax.tree_util.tree_map(np.asarray, params)`) into torch tensors on a
device, `params_to_numpy` goes back. bfloat16 arrays (numpy's
`ml_dtypes` bfloat16, which JAX hands out) cross bit for bit; on the way
back a bfloat16 tensor becomes float32 numpy, since plain numpy has no
bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device

__all__ = ["params_from_jax", "params_to_numpy", "params_to_device",
           "tree_map"]


def tree_map(fn, tree):
    """The same nesting of dicts and lists with `fn` applied to every leaf,
    leaves visited in a fixed order (dict insertion order, list order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree, device=None, dtype=None):
    """Tree of numpy arrays -> the same tree of torch tensors on `device`
    (None = the CUDA device). `dtype`, when given, casts floating leaves."""
    device = default_device(device)

    def conv(a):
        t = _tensor(a)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(conv, tree)


def params_to_numpy(params):
    """Tree of torch tensors -> tree of numpy arrays on the host
    (bfloat16 leaves come back as float32)."""
    def conv(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(conv, params)


def params_to_device(params, device):
    """The same tree with every tensor on `device` (no copy where a leaf
    is already there)."""
    return tree_map(lambda t: t.to(device), params)
