"""Carry parameters between the JAX package and the port, as numpy.

Both packages keep transformer parameters as the same nested structure of
dicts and lists with the same keys, so the transfer is a walk over that
structure: `params_from_jax` turns a tree of numpy arrays (e.g.
`jax.tree_util.tree_map(np.asarray, params)`) into torch tensors on a
device, `params_to_numpy` goes back. A MultiLayerNetwork's table
({layer index -> {name -> array}}) crosses with
`multilayer_params_from_jax` / `multilayer_params_to_numpy`. bfloat16
arrays (numpy's `ml_dtypes` bfloat16, which JAX hands out) cross bit for
bit; on the way back a bfloat16 tensor becomes float32 numpy, since
plain numpy has no bfloat16. The word-vector models cross with
`word2vec_tables_from_jax` (syn0 and syn1 / syn1neg) and
`glove_state_from_jax` (GloVe's {"w", "c", "bw", "bc"} and its AdaGrad
accumulators). The RNTN's stacked parameters ({"W", "Wu", "T", "Wb",
"E"}) cross with `rntn_params_from_jax` / `rntn_params_to_numpy`, and
`rntn_state_from_jax` installs them into a port `RNTN` with the JAX
model's word and category indexes.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device

__all__ = ["params_from_jax", "params_to_numpy", "params_to_device",
           "tree_map", "multilayer_params_from_jax",
           "multilayer_params_to_numpy", "word2vec_tables_from_jax",
           "glove_state_from_jax", "rntn_params_from_jax",
           "rntn_params_to_numpy", "rntn_state_from_jax"]


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


def _check_table(table) -> None:
    if not isinstance(table, dict) or not all(
            isinstance(k, str) and k.isdigit() and isinstance(t, dict)
            for k, t in table.items()):
        raise ValueError("a MultiLayerNetwork table is {layer index as a "
                         "string -> {parameter name -> array}}")


def multilayer_params_from_jax(tree, device=None):
    """A JAX MultiLayerNetwork's table as numpy (e.g.
    `jax.tree_util.tree_map(np.asarray, net._params)`) -> the same table
    of torch tensors on `device` (None = the CUDA device), ready for the
    port's `net.param_table = ...`."""
    _check_table(tree)
    return params_from_jax(tree, device=device)


def multilayer_params_to_numpy(table):
    """The port's `net.param_table` -> the same table of numpy arrays,
    ready for the JAX package's
    `net._params = jax.tree_util.tree_map(jnp.asarray, table)`."""
    _check_table(table)
    return params_to_numpy(table)


WORD2VEC_TABLES = ("syn0", "syn1", "syn1neg")
GLOVE_PARAMS = ("w", "c", "bw", "bc")


def _float32_on(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def word2vec_tables_from_jax(model, tables):
    """A JAX Word2Vec's tables as numpy ({"syn0": ..., and "syn1" or
    "syn1neg"}, e.g. `{k: np.asarray(getattr(jax_w2v, k)) for k in
    ("syn0", "syn1", "syn1neg") if getattr(jax_w2v, k) is not None}`)
    -> the port model's (`Word2Vec` or `ParagraphVectors` with its vocab
    built), as float32 copies on the model's device. A table the dict
    lacks is cleared. Returns the model."""
    unknown = set(tables) - set(WORD2VEC_TABLES)
    if unknown or "syn0" not in tables:
        raise ValueError(f"word2vec tables are syn0 and syn1 / syn1neg, "
                         f"got {sorted(tables)}")
    n = model.vocab.num_words()
    for name in WORD2VEC_TABLES:
        a = tables.get(name)
        if a is not None and np.shape(a)[0] != n:
            raise ValueError(f"{name} has {np.shape(a)[0]} rows for a vocab "
                             f"of {n}")
        setattr(model, name,
                None if a is None else _float32_on(a, model.device))
    return model


def glove_state_from_jax(model, params, accum=None):
    """A JAX Glove's parameters as numpy ({"w", "c", "bw", "bc"}, e.g.
    `{k: np.asarray(v) for k, v in jax_glove._params.items()}`) and,
    optionally, its AdaGrad accumulators the same way -> the port
    `Glove`'s (after its `prepare()`), float32 copies on its device.
    Without `accum` the accumulators restart at 1e-8. Returns the
    model."""
    for tree in (params, accum):
        if tree is not None and set(tree) != set(GLOVE_PARAMS):
            raise ValueError(f"GloVe state is {GLOVE_PARAMS}, got "
                             f"{sorted(tree)}")
    model._params = {k: _float32_on(params[k], model.device)
                     for k in GLOVE_PARAMS}
    model._accum = ({k: torch.full_like(p, 1e-8)
                     for k, p in model._params.items()} if accum is None
                    else {k: _float32_on(accum[k], model.device)
                          for k in GLOVE_PARAMS})
    return model


def glove_work_state_from_jax(performer, params, accum=None):
    """A JAX `GloveWorkPerformer`'s tables as numpy ({"w", "c", "bw",
    "bc"}, e.g. `{k: np.asarray(v) for k, v in jax_perf._params.items()}`)
    and, optionally, its accumulators -> the port `GloveWorkPerformer`'s
    (after its `setup()`), float32 copies on its device, so both start a
    job from the same place. Without `accum` the accumulators restart at
    1e-8. Returns the performer."""
    have = performer._params
    if have is None:
        raise ValueError("GloveWorkPerformer.setup() first")
    for k in GLOVE_PARAMS:
        if k in params and np.shape(params[k]) != tuple(have[k].shape):
            raise ValueError(f"{k} has shape {np.shape(params[k])}, the "
                             f"performer's {tuple(have[k].shape)}")
    return glove_state_from_jax(performer, params, accum)


RNTN_PARAMS = ("W", "Wu", "T", "Wb", "E")


def _check_rntn(tree) -> None:
    if not {"W", "Wu", "E"} <= set(tree) <= set(RNTN_PARAMS):
        raise ValueError(f"RNTN parameters are W, Wu, E and optionally T, "
                         f"Wb; got {sorted(tree)}")


def rntn_params_from_jax(params, device=None):
    """A JAX RNTN's stacked parameters as numpy (e.g. `{k: np.asarray(v)
    for k, v in jax_rntn.params().items()}`) -> float32 tensors on
    `device` (None = the CUDA device)."""
    _check_rntn(params)
    device = default_device(device)
    return {k: _float32_on(v, device) for k, v in params.items()}


def rntn_params_to_numpy(params):
    """A port RNTN's `params()` -> the same dict of float32 numpy arrays,
    ready for the JAX package's `set_params` (as jnp arrays)."""
    _check_rntn(params)
    return params_to_numpy(params)


def rntn_state_from_jax(model, params, word_index, cat_index=None,
                        ccat_index=None, adagrad_hist=None):
    """Install a JAX RNTN's parameters (numpy, as `rntn_params_from_jax`
    takes them), its `word_index`, `cat_index` and `ccat_index` and,
    optionally, its AdaGrad history (the same dict of names) into the
    port `model`, on the model's device. Returns the model."""
    model._params = rntn_params_from_jax(params, model.device)
    model.word_index = dict(word_index)
    model.cat_index = None if cat_index is None else dict(cat_index)
    model.ccat_index = None if ccat_index is None else dict(ccat_index)
    if adagrad_hist is not None:
        if set(adagrad_hist) != set(params):
            raise ValueError(f"the AdaGrad history has {sorted(adagrad_hist)}"
                             f", the parameters {sorted(params)}")
        adagrad_hist = rntn_params_from_jax(adagrad_hist, model.device)
    model._adagrad_hist = adagrad_hist
    return model
