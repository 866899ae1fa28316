"""Sharded checkpoint format: manifest + per-shard .npy files + commit
marker, the counterpart of the JAX package's `checkpoint/format.py`.

Layout of one checkpoint root (one directory per run):

    <root>/
      step_0000000008/
        manifest.json          # tree, per-leaf layout, mesh, cursor
        params__0__W.s00.npy   # one file per (leaf, shard)
        ...
        COMMITTED              # the commit marker, written LAST

Every file is written to a `.tmp` name and published with `os.replace`,
the marker last, so a reader (which only considers step directories that
carry the marker) never sees a torn checkpoint: a crash at any point
mid-save leaves the previous committed step as the restore target.

The manifest records, per array leaf, its logical dtype, its global
shape and a shard table of (file, index, crc32) entries, `index` a
per-dim [start, stop] slice ([null, null] = the whole dim). The port
writes one full shard a leaf (one device); it reads any shard table the
JAX package writes, reassembling the global array. The files and the
manifest are the JAX package's: a step written by either package loads
in the other.

Nothing is unpickled on load (`allow_pickle=False`). A bfloat16 leaf is
written as its raw 16 bits (uint16) with `"dtype": "bfloat16"` in the
manifest; on load the bits are viewed as `torch.bfloat16` (the JAX
package writes numpy's `V2` for the same bits and views whatever it
reads to its manifest dtype, so the crc32 over the bytes holds both
ways). `load_tree` returns every array leaf as a CPU tensor.

Chaos injection points, as in the JAX package (`testing/chaos.py`):
`checkpoint.write` before each shard file, and `checkpoint.rename`
before the manifest's publish and again before the `COMMITTED`
marker's. An error rule at either leaves the step uncommitted, so
readers never offer it. The `between_files` test hook runs just before
each point.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from deeplearning4j_tpu_torch.scaleout import checkpoint as _legacy
from deeplearning4j_tpu_torch.testing import chaos

__all__ = [
    "FORMAT_NAME", "FORMAT_VERSION", "MANIFEST", "MARKER", "HostShard",
    "HostLeaf", "CheckpointError", "CorruptShardError", "step_dir_name",
    "step_of", "list_steps", "latest_step", "write_checkpoint",
    "read_manifest", "load_tree", "leaf_summary", "prune",
]

FORMAT_NAME = "dl4j-sharded-checkpoint"
FORMAT_VERSION = 1
MANIFEST = "manifest.json"
MARKER = "COMMITTED"
_STEP_PREFIX = "step_"
_STEP_WIDTH = 10
#: logical dtypes numpy cannot name: stored as raw bits of this dtype
_RAW = {"bfloat16": (np.uint16, torch.bfloat16)}


class CheckpointError(RuntimeError):
    """Malformed / unreadable sharded checkpoint."""


class CorruptShardError(CheckpointError):
    """A shard file failed its checksum or shape validation; the message
    names the leaf so the operator knows WHAT was lost, not just that
    a read failed."""


class HostShard(NamedTuple):
    """One device's slice of a leaf, on host. ``index`` is a tuple of
    (start, stop) pairs per dim; (None, None) means the full dim."""

    index: Tuple[Tuple[Optional[int], Optional[int]], ...]
    data: np.ndarray


class HostLeaf(NamedTuple):
    """A host-side snapshot of one array leaf: logical dtype + global
    shape plus the shards that tile it (one full-index shard for an
    array of one device). A bfloat16 leaf's shards hold its raw bits
    (uint16)."""

    dtype: str
    shape: Tuple[int, ...]
    shards: List[HostShard]

    @classmethod
    def from_array(cls, arr) -> "HostLeaf":
        """One full shard of a numpy array or a tensor (a tensor is
        copied to the host, blocking)."""
        if isinstance(arr, torch.Tensor):
            name, data = _dtype_name(arr.dtype), host_bits(
                arr.detach().cpu().clone())
        else:
            data = np.asarray(arr)
            name = _dtype_name(data.dtype)
        full = tuple((None, None) for _ in data.shape)
        return cls(dtype=name, shape=tuple(data.shape),
                   shards=[HostShard(full, data)])


def host_bits(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's memory as the numpy array its shard file holds
    (no copy): the values, or for a dtype numpy cannot name (bfloat16)
    the raw bits."""
    if _dtype_name(t.dtype) in _RAW:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(dt) -> str:
    """Stable dtype token, numpy's canonical name ('float32', 'int32',
    'bfloat16', ...) for a numpy or a torch dtype."""
    if isinstance(dt, torch.dtype):
        return str(dt).rsplit(".", 1)[-1]
    return np.dtype(dt).name


def _storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf's shard files hold: the dtype itself, or
    for a name numpy cannot resolve, its raw bits."""
    if name in _RAW:
        return np.dtype(_RAW[name][0])
    try:
        return np.dtype(name)
    except TypeError as e:
        raise CheckpointError(f"unsupported leaf dtype {name!r}") from e


def _as_tensor(name: str, arr: np.ndarray) -> torch.Tensor:
    if name in _RAW:
        return torch.from_numpy(arr.view(np.int16)).view(_RAW[name][1])
    return torch.from_numpy(arr)


def step_dir_name(step: int) -> str:
    return f"{_STEP_PREFIX}{int(step):0{_STEP_WIDTH}d}"


def step_of(dirname: str) -> Optional[int]:
    base = os.path.basename(dirname.rstrip("/"))
    if not base.startswith(_STEP_PREFIX):
        return None
    try:
        return int(base[len(_STEP_PREFIX):])
    except ValueError:
        return None


def list_steps(root: str, committed_only: bool = True) -> List[int]:
    """Ascending step numbers under `root` (default: committed only)."""
    try:
        entries = os.listdir(root)
    except FileNotFoundError:
        return []
    steps = []
    for name in entries:
        step = step_of(name)
        if step is None:
            continue
        if committed_only and not os.path.exists(
                os.path.join(root, name, MARKER)):
            continue
        steps.append(step)
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    steps = list_steps(root)
    return steps[-1] if steps else None


# ---------------------------------------------------------------- tree codec
def _sanitize(part: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in part)


def _encode_tree(obj, path: str, leaves: Dict[str, HostLeaf]):
    """Encode a tree into a JSON-able manifest node, moving every array
    leaf (numpy array, tensor or HostLeaf) into `leaves` under a
    path-derived key, so errors and shard filenames name the leaf
    ('params/0/W'), not an opaque counter."""
    if obj is None or isinstance(obj, (bool, int, str, float)):
        return obj
    if isinstance(obj, HostLeaf):
        key = _leaf_key(path, leaves)
        leaves[key] = obj
        return {"__leaf__": key}
    if isinstance(obj, (np.ndarray, np.generic, torch.Tensor)):
        if not isinstance(obj, torch.Tensor) and np.asarray(
                obj).dtype.hasobject:
            raise TypeError(
                f"Cannot checkpoint object-dtype array at {path!r}")
        key = _leaf_key(path, leaves)
        leaves[key] = HostLeaf.from_array(obj)
        return {"__leaf__": key}
    if hasattr(obj, "_fields"):  # NamedTuple
        name = type(obj).__name__
        if name not in _legacy._NAMEDTUPLES:
            raise TypeError(
                f"Unregistered NamedTuple in checkpoint at {path!r}: {name} "
                "(scaleout.checkpoint.register_namedtuple)")
        return {"__nt__": name,
                "fields": {f: _encode_tree(getattr(obj, f), f"{path}/{f}",
                                           leaves)
                           for f in obj._fields}}
    if isinstance(obj, dict):
        for k in obj:
            if not isinstance(k, str):
                raise TypeError(
                    f"Checkpoint dict keys must be str at {path!r}, got "
                    f"{k!r} ({type(k).__name__})")
        return {"__dict__": {k: _encode_tree(v, f"{path}/{k}", leaves)
                             for k, v in obj.items()}}
    if isinstance(obj, tuple):
        return {"__tuple__": [_encode_tree(v, f"{path}/{i}", leaves)
                              for i, v in enumerate(obj)]}
    if isinstance(obj, list):
        return {"__list__": [_encode_tree(v, f"{path}/{i}", leaves)
                             for i, v in enumerate(obj)]}
    raise TypeError(
        f"Cannot checkpoint object of type {type(obj)!r} at {path!r}")


def _leaf_key(path: str, leaves: Dict[str, HostLeaf]) -> str:
    key = path.strip("/") or "root"
    if key in leaves:  # paths are unique by construction; belt+braces
        i = 1
        while f"{key}.{i}" in leaves:
            i += 1
        key = f"{key}.{i}"
    return key


def _decode_tree(node, arrays: Dict[str, Any]):
    if not isinstance(node, dict):
        return node
    if "__leaf__" in node:
        return arrays[node["__leaf__"]]
    if "__nt__" in node:
        cls = _legacy._NAMEDTUPLES.get(node["__nt__"])
        if cls is None:
            raise CheckpointError(
                f"Checkpoint contains unregistered NamedTuple "
                f"{node['__nt__']!r} — import the module that registers it "
                "before restoring")
        return cls(**{f: _decode_tree(v, arrays)
                      for f, v in node["fields"].items()})
    if "__dict__" in node:
        return {k: _decode_tree(v, arrays)
                for k, v in node["__dict__"].items()}
    if "__tuple__" in node:
        return tuple(_decode_tree(v, arrays) for v in node["__tuple__"])
    if "__list__" in node:
        return [_decode_tree(v, arrays) for v in node["__list__"]]
    raise CheckpointError(f"Malformed checkpoint manifest node: {node!r}")


# -------------------------------------------------------------------- write
def _publish_json(step_dir: str, name: str, obj) -> None:
    with open(os.path.join(step_dir, name + ".tmp"), "w") as f:
        json.dump(obj, f)
    os.replace(os.path.join(step_dir, name + ".tmp"),
               os.path.join(step_dir, name))


def write_checkpoint(root: str, step: int, payload: Any, *,
                     mesh_spec: Optional[dict] = None,
                     between_files: Optional[Callable[[str], None]] = None,
                     ) -> str:
    """Serialize `payload` (a tree whose array leaves are numpy arrays,
    tensors or pre-sharded `HostLeaf`s) as the sharded directory format
    and COMMIT it. Returns the committed step directory.

    `between_files` is a test hook called with each filename just before
    it is written: crash-mid-save drills raise from it and check that the
    step never becomes visible to readers."""
    leaves: Dict[str, HostLeaf] = {}
    tree = _encode_tree(payload, "", leaves)
    step_dir = os.path.join(root, step_dir_name(step))
    if os.path.exists(step_dir):
        # re-saving an existing step (resumed run): tear the old one down
        # first. Readers fall back to an OLDER committed step during the
        # window, never to a torn directory.
        shutil.rmtree(step_dir)
    os.makedirs(step_dir)

    manifest_leaves: Dict[str, dict] = {}
    total_bytes = 0
    for key, leaf in leaves.items():
        fname_base = _sanitize(key.replace("/", "__"))
        shard_entries = []
        seen_indices = set()
        for i, shard in enumerate(leaf.shards):
            idx_key = tuple(shard.index)
            if idx_key in seen_indices:  # replicated copies: save once
                continue
            seen_indices.add(idx_key)
            fname = f"{fname_base}.s{i:02d}.npy"
            if between_files is not None:
                between_files(fname)
            chaos.hit("checkpoint.write", file=fname)
            # NOT ascontiguousarray: it promotes 0-d scalars to 1-d;
            # tobytes() already yields C-order bytes for the crc
            data = np.asarray(shard.data)
            crc = zlib.crc32(data.tobytes())
            tmp = os.path.join(step_dir, fname + ".tmp")
            with open(tmp, "wb") as f:
                np.save(f, data)
            os.replace(tmp, os.path.join(step_dir, fname))
            total_bytes += data.nbytes
            shard_entries.append({
                "file": fname,
                "index": [[s[0], s[1]] for s in shard.index],
                "crc32": crc,
            })
        manifest_leaves[key] = {
            "dtype": leaf.dtype,
            "shape": list(leaf.shape),
            "shards": shard_entries,
        }

    manifest = {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "step": int(step),
        "saved_at": time.time(),
        "mesh": mesh_spec,
        "tree": tree,
        "leaves": manifest_leaves,
        "total_bytes": total_bytes,
    }
    if between_files is not None:
        between_files(MANIFEST)
    chaos.hit("checkpoint.rename", file=MANIFEST)
    _publish_json(step_dir, MANIFEST, manifest)
    # the commit point: the marker appears atomically, LAST
    if between_files is not None:
        between_files(MARKER)
    chaos.hit("checkpoint.rename", file=MARKER)
    _publish_json(step_dir, MARKER,
                  {"step": int(step), "committed_at": time.time()})
    return step_dir


# --------------------------------------------------------------------- read
def _resolve_step(root: str, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(
                f"no committed sharded checkpoint under {root!r}")
        return step
    step_dir = os.path.join(root, step_dir_name(step))
    if not os.path.exists(os.path.join(step_dir, MARKER)):
        raise FileNotFoundError(
            f"step {step} under {root!r} is missing or was never committed "
            f"(committed steps: {list_steps(root)})")
    return int(step)


def read_manifest(root: str, step: Optional[int] = None) -> dict:
    step = _resolve_step(root, step)
    path = os.path.join(root, step_dir_name(step), MANIFEST)
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT_NAME:
        raise CheckpointError(
            f"{path} is not a {FORMAT_NAME} manifest")
    return manifest


def _assemble_leaf(step_dir: str, key: str, entry: dict,
                   verify: bool) -> torch.Tensor:
    dtype = _storage_dtype(entry["dtype"])
    shape = tuple(entry["shape"])
    shards = entry["shards"]
    if not shards:
        raise CorruptShardError(f"leaf {key!r}: manifest lists no shards")

    def load_shard(sh) -> np.ndarray:
        path = os.path.join(step_dir, sh["file"])
        try:
            with open(path, "rb") as f:
                raw = np.load(f, allow_pickle=False)
        except (OSError, ValueError) as e:
            raise CorruptShardError(
                f"leaf {key!r}: shard {sh['file']} unreadable: {e}") from e
        if verify and zlib.crc32(raw.tobytes()) != sh["crc32"]:
            raise CorruptShardError(
                f"leaf {key!r}: shard {sh['file']} failed its crc32 check — "
                "the checkpoint is corrupt; restore an earlier step")
        if raw.dtype != dtype:  # raw bits (bf16 as V2 or uint16)
            raw = raw.view(dtype)
        return raw

    if len(shards) == 1 and all(s == [None, None]
                                for s in shards[0]["index"]):
        arr = load_shard(shards[0])
        if tuple(arr.shape) != shape:
            raise CorruptShardError(
                f"leaf {key!r}: shard {shards[0]['file']} has shape "
                f"{tuple(arr.shape)}, manifest says {shape}")
        return _as_tensor(entry["dtype"], arr)

    out = np.empty(shape, dtype)
    filled = 0
    for sh in shards:
        idx = tuple(slice(s[0], s[1]) for s in sh["index"])
        data = load_shard(sh)
        try:
            out[idx] = data
        except ValueError as e:
            raise CorruptShardError(
                f"leaf {key!r}: shard {sh['file']} (index {sh['index']}) "
                f"does not fit the global shape {shape}: {e}") from e
        filled += data.size
    if filled < int(np.prod(shape)):
        raise CorruptShardError(
            f"leaf {key!r}: shards cover {filled} of "
            f"{int(np.prod(shape))} elements — the shard table does not "
            "tile the global array")
    return _as_tensor(entry["dtype"], out)


def load_tree(root: str, step: Optional[int] = None, *,
              verify: bool = True) -> Tuple[Any, dict]:
    """Load a committed checkpoint: reassemble every leaf's GLOBAL array
    from its shards (crc-verified) and decode the tree, array leaves as
    CPU tensors. Returns (payload, manifest)."""
    step = _resolve_step(root, step)
    manifest = read_manifest(root, step)
    step_dir = os.path.join(root, step_dir_name(step))
    arrays = {key: _assemble_leaf(step_dir, key, entry, verify)
              for key, entry in manifest["leaves"].items()}
    return _decode_tree(manifest["tree"], arrays), manifest


def tree_scalars(manifest: dict):
    """Decode the manifest's payload tree WITHOUT touching any shard
    file: array leaves come back as None, every scalar/string/container
    node intact, so summarizing a large checkpoint costs only its
    manifest."""
    arrays = {key: None for key in manifest.get("leaves", {})}
    return _decode_tree(manifest["tree"], arrays)


def leaf_summary(manifest: dict) -> List[dict]:
    """[{leaf, dtype, shape, shards, bytes}], one row a leaf."""
    out = []
    for key, entry in sorted(manifest.get("leaves", {}).items()):
        itemsize = _storage_dtype(entry["dtype"]).itemsize
        n = int(np.prod(entry["shape"])) if entry["shape"] else 1
        out.append({"leaf": key, "dtype": entry["dtype"],
                    "shape": tuple(entry["shape"]),
                    "shards": len(entry["shards"]),
                    "bytes": n * itemsize})
    return out


# ----------------------------------------------------------------- rotation
def prune(root: str, keep: int, *, protect: Sequence[int] = ()) -> List[int]:
    """Delete committed steps beyond the newest `keep`, plus any
    UNCOMMITTED step directories (crash leftovers) not in `protect`.
    Returns the steps removed."""
    removed = []
    committed = list_steps(root)
    doomed = committed[:-keep] if keep > 0 else []
    for name in (os.listdir(root) if os.path.isdir(root) else []):
        step = step_of(name)
        if step is None or step in protect:
            continue
        path = os.path.join(root, name)
        uncommitted = not os.path.exists(os.path.join(path, MARKER))
        if uncommitted or step in doomed:
            shutil.rmtree(path, ignore_errors=True)
            removed.append(step)
    return sorted(removed)
