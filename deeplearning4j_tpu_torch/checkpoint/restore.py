"""Checkpoint restore, the counterpart of the JAX package's
`checkpoint/restore.py`.

A sharded checkpoint records GLOBAL logical arrays (as a shard table):
`format.load_tree` stitches each leaf's shards back into its global
array (crc-verified, coverage-checked, errors naming the leaf), and
`restore_network` rebuilds a MultiLayerNetwork on a device from the
conf, the params table, the canonical updater state and the cursor, so
a step written by either package restores in the port.

`restore_params_for` restores just the params tree placed under a
target placement (`parallel.mesh.Placement`, one for every leaf or a
tree of them): each rank gets its slice of a split leaf, a replicated
leaf whole, on the mesh's device.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.checkpoint import format as ckfmt
from deeplearning4j_tpu_torch.scaleout.checkpoint import map_arrays

__all__ = ["resolve_root", "discover_latest", "list_committed_steps",
           "load_payload_tree", "restore_network", "restore_params_for",
           "validate_like"]


def list_committed_steps(root: str) -> List[int]:
    """Ascending COMMITTED steps under `root`, hardened against a
    concurrent writer's rotation: a step directory (or its marker /
    manifest) deleted between the listdir and the per-entry checks is
    skipped, never raised."""
    try:
        entries = os.listdir(root)
    except (FileNotFoundError, NotADirectoryError):
        return []
    steps = []
    for name in entries:
        step = ckfmt.step_of(name)
        if step is None:
            continue
        step_dir = os.path.join(root, name)
        try:
            committed = (os.path.exists(os.path.join(step_dir, ckfmt.MARKER))
                         and os.path.exists(
                             os.path.join(step_dir, ckfmt.MANIFEST)))
        except OSError:
            continue
        if committed:
            steps.append(step)
    return sorted(steps)


def resolve_root(path: str) -> Tuple[str, Optional[int]]:
    """Accept either a checkpoint ROOT (holding step_* dirs) or one
    step directory; return (root, pinned_step_or_None)."""
    if os.path.exists(os.path.join(path, ckfmt.MANIFEST)):
        step = ckfmt.step_of(path)
        if step is None:
            raise ckfmt.CheckpointError(
                f"{path} holds a manifest but is not named step_<n>")
        return os.path.dirname(os.path.abspath(path)), step
    return path, None


def discover_latest(root: str) -> Tuple[str, int]:
    """The newest COMMITTED step under a checkpoint root (or a single
    step dir). Raises CheckpointError naming the torn step dirs when the
    root holds only uncommitted saves: "nothing to resume" and "saves
    exist but none ever committed" are different answers."""
    root, pinned = resolve_root(root)
    if pinned is not None:
        return root, pinned
    # newest first, re-verifying each candidate's manifest: a concurrent
    # writer's prune() can delete a step between our listdir and the
    # read; a lost race rescans before it may mean "nothing committed"
    for _ in range(3):
        steps = list_committed_steps(root)
        for step in reversed(steps):
            try:
                ckfmt.read_manifest(root, step)
            except (ckfmt.CheckpointError, OSError, ValueError):
                continue
            return root, step
        if not steps and not ckfmt.list_steps(root, committed_only=False):
            break  # truly empty root — not a race
    torn = ckfmt.list_steps(root, committed_only=False)
    if torn:
        raise ckfmt.CheckpointError(
            f"no COMMITTED checkpoint under {root!r}; found "
            f"{len(torn)} uncommitted (torn) step dir(s): "
            f"{[ckfmt.step_dir_name(s) for s in torn]} — these saves "
            "never reached their commit marker (crashed mid-write) and "
            "cannot be restored; delete them or point --resume at an "
            "older root")
    raise ckfmt.CheckpointError(
        f"no sharded checkpoint steps under {root!r}")


def load_payload_tree(path: str, step: Optional[int] = None
                      ) -> Tuple[Any, dict]:
    """(payload, manifest), every array leaf its global array as a CPU
    tensor."""
    root, pinned = resolve_root(path)
    return ckfmt.load_tree(root, step if step is not None else pinned)


def restore_network(path: str, step: Optional[int] = None, device=None):
    """Rebuild a MultiLayerNetwork (+ canonical updater state + cursor)
    from a sharded checkpoint on `device` (None = the CUDA device).
    Returns (network, info): iterator_position, metadata, saved_at, step
    and mesh (the SOURCE topology, informational)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    payload, manifest = load_payload_tree(path, step)
    if payload.get("conf_json") is None:
        raise ValueError(
            f"Checkpoint {path} step {manifest['step']} has no conf_json "
            "(params-only runtime checkpoint); rebuild the network from "
            "its config and install payload['params'] directly")
    params = payload["params"]
    if isinstance(params, dict):
        net = MultiLayerNetwork.from_config_json(payload["conf_json"],
                                                 device=device)
        net.param_table = params
    else:
        # a runtime-level packed vector: unflattened against the conf
        net = MultiLayerNetwork.from_config_json(
            payload["conf_json"], params=params.reshape(-1), device=device)
    if payload.get("updater_state") is not None:
        net._updater_state = map_arrays(lambda t: t.to(net.device),
                                        payload["updater_state"])
    net._iteration_count = payload.get("iteration_count", 0)
    info = {
        "iterator_position": payload.get("iterator_position"),
        "metadata": payload.get("metadata", {}),
        "saved_at": payload.get("saved_at"),
        "step": manifest["step"],
        "mesh": manifest.get("mesh"),
    }
    return net, info


def restore_params_for(path: str, shardings, step: Optional[int] = None):
    """Restore just the params tree, placed under `shardings`: one
    `Placement` applied to every leaf, or a tree of placements matching
    the params tree (the TP trainer's `_param_specs`, each spec wrapped
    in a Placement). This rank gets its slice of each split leaf and a
    replicated leaf whole, as tensors on the placement's mesh device.
    The explicit resharding entry point; the trainers slice for
    themselves."""
    from deeplearning4j_tpu_torch.parallel.mesh import Placement

    payload, _ = load_payload_tree(path, step)
    params = payload["params"]

    def place(a, placement):
        t = torch.as_tensor(np.asarray(a)) if not isinstance(
            a, torch.Tensor) else a
        return placement.local(t).contiguous().to(placement.mesh.device)

    if isinstance(shardings, Placement):
        return map_arrays(lambda a: place(a, shardings), params)

    def walk(tree, specs):
        if isinstance(tree, dict):
            return {k: walk(v, specs[k]) for k, v in tree.items()}
        return place(tree, specs)

    return walk(params, shardings)


def _flatten(tree, prefix=()) -> List[Tuple[str, Any]]:
    """(path, leaf) for every leaf; None is an empty subtree, as in a
    jax tree."""
    if tree is None:
        return []
    if hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [("/".join(prefix), tree)]
    return [kv for k, v in items for kv in _flatten(v, prefix + (str(k),))]


def _dtype_of(leaf) -> Optional[str]:
    dt = getattr(leaf, "dtype", None)
    if dt is None:
        return None
    return ckfmt._dtype_name(dt) if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def validate_like(restored, reference, *, context: str = "restore") -> None:
    """Per-leaf dtype/shape validation with the LEAF PATH in the error,
    instead of an opaque shape failure later. Tensors and numpy arrays
    compare by dtype name."""
    ref_paths = dict(_flatten(reference))
    got_paths = dict(_flatten(restored))
    missing = sorted(set(ref_paths) - set(got_paths))
    extra = sorted(set(got_paths) - set(ref_paths))
    if missing or extra:
        raise ValueError(
            f"{context}: checkpoint tree does not match the target — "
            f"missing leaves {missing[:4]}, unexpected leaves {extra[:4]}")
    for path, ref in ref_paths.items():
        got = got_paths[path]
        ref_shape = tuple(getattr(ref, "shape", ()))
        got_shape = tuple(getattr(got, "shape", ()))
        if ref_shape != got_shape:
            raise ValueError(
                f"{context}: leaf {path!r} has shape {got_shape} in the "
                f"checkpoint but the target expects {ref_shape}")
        ref_dt, got_dt = _dtype_of(ref), _dtype_of(got)
        if ref_dt is not None and got_dt is not None and ref_dt != got_dt:
            # same shapes but another dtype would silently change the
            # numerics downstream: refuse, naming the leaf
            raise ValueError(
                f"{context}: leaf {path!r} has dtype {got_dt} in the "
                f"checkpoint but the target expects {ref_dt}")
