"""Checkpoint / resume, the single-file tier: the counterpart of the JAX
package's `scaleout/checkpoint.py`.

Parity: reference ModelSavingActor + DefaultModelSaver.java:34-70
(serialize the model to `nn-model.bin`, timestamp-rename the prior file)
and the checkpoint constructor `MultiLayerNetwork(confJson, params)`
(MultiLayerNetwork.java:91). As in the JAX package a checkpoint is more
than the reference's (conf, params): (conf_json, packed params, updater
state tree, data-iterator position, user metadata), so a resumed run
continues exactly.

Format: one `.npz` file, the arrays as plain npy members plus a JSON
manifest of the tree (`__manifest__`). Nothing is unpickled on load
(`allow_pickle=False`); an object-dtype leaf raises at save. The bytes
are the JAX package's: a file written by either package loads in the
other. A bfloat16 tensor is stored as its raw 16 bits (numpy's `V2`,
which is what numpy writes for JAX's bfloat16 arrays) and comes back as
a bfloat16 tensor.

This is the compatibility tier; the production path is the sharded
directory format of `deeplearning4j_tpu_torch.checkpoint`, and
`load_checkpoint` loads both. `OrbaxModelSaver` is not ported: orbax is
built on jax, which the port never imports; it raises.
"""

from __future__ import annotations

import io
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.updater import UpdaterState

__all__ = ["register_namedtuple", "dump_payload", "load_payload",
           "host_array", "to_tensor", "map_arrays", "ModelSaver",
           "DefaultModelSaver", "UriModelSaver", "OrbaxModelSaver",
           "load_checkpoint"]

#: NamedTuple node types that may appear in checkpointed trees.
_NAMEDTUPLES = {"UpdaterState": UpdaterState}


def register_namedtuple(cls) -> None:
    """Allow `cls` (a NamedTuple type) in checkpoint payload trees; it
    round-trips by field name through the manifest. Modules defining
    checkpointable carries (e.g. optimize.guardian.GuardianState) call
    this rather than this module importing them."""
    _NAMEDTUPLES[cls.__name__] = cls


# ------------------------------------------------------- host <-> tensor
def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as an owned numpy array on the host (a blocking copy);
    bfloat16 as its raw 16 bits in numpy's `V2`."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.cpu().view(torch.int16).numpy().copy().view("V2")
    return t.cpu().numpy().copy()


def to_tensor(a, device=None) -> torch.Tensor:
    """A loaded array as a tensor on `device` (None = the CPU here: the
    loaders place it); a 2-byte void array (a bfloat16 leaf, as numpy
    stores it) comes back as bfloat16."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.asarray(a)
        if a.dtype.kind == "V" and a.dtype.itemsize == 2:
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
    return t if device is None else t.to(device)


def map_arrays(fn: Callable, tree):
    """The same tree (dicts, lists, tuples, NamedTuples) with `fn` applied
    to every array leaf (numpy array or tensor); other leaves kept."""
    if isinstance(tree, (np.ndarray, np.generic, torch.Tensor)):
        return fn(tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_arrays(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: map_arrays(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_arrays(fn, v) for v in tree)
    return tree


# ------------------------------------------------------------ the codec
def _encode_tree(obj, arrays: Dict[str, np.ndarray]):
    """Encode a tree of arrays/scalars/containers into a JSON-able
    manifest, moving every array leaf into `arrays` under a fresh key."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (np.ndarray, np.generic, torch.Tensor)):
        arr = host_array(obj) if isinstance(obj, torch.Tensor) \
            else np.asarray(obj)
        if arr.dtype.hasobject:
            # np.savez would pickle it, and load_payload (allow_pickle=
            # False) could never read it back: fail at save time
            raise TypeError("Cannot checkpoint object-dtype array")
        key = f"a{len(arrays)}"
        arrays[key] = arr
        return {"__arr__": key}
    if hasattr(obj, "_fields"):  # NamedTuple
        name = type(obj).__name__
        if name not in _NAMEDTUPLES:
            raise TypeError(f"Unregistered NamedTuple in checkpoint: {name}")
        return {"__nt__": name,
                "fields": {f: _encode_tree(getattr(obj, f), arrays)
                           for f in obj._fields}}
    if isinstance(obj, dict):
        for k in obj:
            if not isinstance(k, str):
                raise TypeError(
                    f"Checkpoint dict keys must be str, got {k!r} "
                    f"({type(k).__name__}) — JSON round-trip would rekey it")
        return {"__dict__": {k: _encode_tree(v, arrays)
                             for k, v in obj.items()}}
    if isinstance(obj, tuple):
        return {"__tuple__": [_encode_tree(v, arrays) for v in obj]}
    if isinstance(obj, list):
        return {"__list__": [_encode_tree(v, arrays) for v in obj]}
    raise TypeError(f"Cannot checkpoint object of type {type(obj)!r}")


def _decode_tree(node, arrays):
    if not isinstance(node, dict):
        return node
    if "__arr__" in node:
        return arrays[node["__arr__"]]
    if "__nt__" in node:
        cls = _NAMEDTUPLES[node["__nt__"]]
        return cls(**{f: _decode_tree(v, arrays)
                      for f, v in node["fields"].items()})
    if "__dict__" in node:
        return {k: _decode_tree(v, arrays) for k, v in node["__dict__"].items()}
    if "__tuple__" in node:
        return tuple(_decode_tree(v, arrays) for v in node["__tuple__"])
    if "__list__" in node:
        return [_decode_tree(v, arrays) for v in node["__list__"]]
    raise ValueError(f"Malformed checkpoint manifest node: {node!r}")


def dump_payload(payload: Dict[str, Any]) -> bytes:
    """Serialize a checkpoint payload dict to npz bytes (no pickle)."""
    arrays: Dict[str, np.ndarray] = {}
    manifest = _encode_tree(payload, arrays)
    buf = io.BytesIO()
    np.savez(buf, __manifest__=np.frombuffer(
        json.dumps(manifest).encode(), np.uint8), **arrays)
    return buf.getvalue()


def load_payload(data: bytes) -> Dict[str, Any]:
    """The payload dict of npz bytes; array leaves as numpy."""
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__manifest__"}
    return _decode_tree(manifest, arrays)


# ---------------------------------------------------------------- savers
class ModelSaver:
    def save(self, network, **extra) -> str:
        raise NotImplementedError


class DefaultModelSaver(ModelSaver):
    """Save to a local path, timestamp-renaming any prior checkpoint
    (reference DefaultModelSaver.java:66-70)."""

    def __init__(self, path: str = "nn-model.ckpt", keep_old: bool = True):
        self.path = path
        self.keep_old = keep_old

    def _write(self, payload: Dict[str, Any]) -> str:
        """Timestamp-rename any prior checkpoint, then atomically publish."""
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        if self.keep_old and os.path.exists(self.path):
            os.replace(self.path, f"{self.path}.{int(time.time() * 1000)}")
        tmp = f"{self.path}.tmp"
        with open(tmp, "wb") as f:
            f.write(dump_payload(payload))
        os.replace(tmp, self.path)
        return self.path

    @staticmethod
    def _payload(*, conf_json, params, updater_state=None,
                 iteration_count=0, iterator_position=None, metadata=None):
        return {
            "format_version": 2,
            "conf_json": conf_json,
            "params": (host_array(params) if isinstance(params, torch.Tensor)
                       else np.asarray(params)),
            "updater_state": updater_state,
            "iteration_count": iteration_count,
            "iterator_position": iterator_position,
            "metadata": metadata or {},
            "saved_at": time.time(),
        }

    def save(self, network, *, iterator_position: Optional[int] = None,
             metadata: Optional[Dict[str, Any]] = None) -> str:
        return self._write(self._payload(
            conf_json=network.to_json(),
            params=network.params(),
            updater_state=(map_arrays(host_array, network._updater_state)
                           if network._updater_state is not None else None),
            iteration_count=network._iteration_count,
            iterator_position=iterator_position,
            metadata=metadata,
        ))

    def save_current(self, params, *, conf_json: Optional[str] = None,
                     iterator_position: Optional[int] = None,
                     metadata: Optional[Dict[str, Any]] = None) -> str:
        """Checkpoint a packed parameter vector directly (the runtime-level
        save path). Loadable by `load_checkpoint` when conf_json is given;
        `iterator_position` is the job-stream resume cursor."""
        return self._write(self._payload(
            conf_json=conf_json, params=params,
            iterator_position=iterator_position, metadata=metadata))


class UriModelSaver(DefaultModelSaver):
    """ModelSaver that treats its path as a storage URI (reference
    HdfsModelSaver / S3ModelSaver). `file://` and bare paths are local;
    `gs://`, `s3://` and `hdfs://` resolve through `mounts` (or the
    DL4J_TPU_ARTIFACT_ROOT env var) to a mounted directory, so everything
    downstream is plain file IO with DefaultModelSaver's atomic rename.
    No remote client is used."""

    REMOTE_SCHEMES = ("gs", "s3", "hdfs")

    def __init__(self, uri: str, keep_old: bool = True,
                 mounts: Optional[Dict[str, str]] = None):
        self.uri = uri
        mounts = dict(mounts or {})
        env_root = os.environ.get("DL4J_TPU_ARTIFACT_ROOT")
        if env_root:
            for scheme in self.REMOTE_SCHEMES:
                mounts.setdefault(scheme, env_root)
        super().__init__(self._resolve(uri, mounts), keep_old=keep_old)

    @classmethod
    def _resolve(cls, uri: str, mounts: Dict[str, str]) -> str:
        scheme, sep, rest = uri.partition("://")
        if not sep:
            return uri  # bare local path
        if scheme == "file":
            return rest if rest.startswith("/") else "/" + rest
        if scheme in cls.REMOTE_SCHEMES:
            root = mounts.get(scheme)
            if not root:
                raise ValueError(
                    f"{scheme}:// checkpoint URI needs a mount point: pass "
                    f"mounts={{'{scheme}': '/mnt/...'}} or set "
                    f"DL4J_TPU_ARTIFACT_ROOT (no direct {scheme} client in "
                    f"this environment)")
            return os.path.join(root, rest)  # _write makedirs at save time
        raise ValueError(f"Unknown checkpoint URI scheme: {scheme}://")


class OrbaxModelSaver(ModelSaver):
    """Not ported: orbax is built on jax, and the port never imports jax.
    Use `checkpoint.ShardedModelSaver` (per-leaf files, atomic commit,
    async writes) or DefaultModelSaver."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "OrbaxModelSaver is not ported: orbax is built on jax, which "
            "the PyTorch port never imports (ROADMAP Queue 1 item 14); use "
            "deeplearning4j_tpu_torch.checkpoint.ShardedModelSaver")


def load_checkpoint(path: str, device=None):
    """Restore a MultiLayerNetwork (+ updater state) from a checkpoint
    onto `device` (None = the CUDA device). Returns (network, info), info
    carrying iterator_position / metadata / saved_at for the caller to
    restore its data pipeline.

    `path` may be a single-file npz checkpoint (this module's format) or
    a sharded checkpoint directory, which goes to `restore_network`."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if os.path.isdir(path):
        from deeplearning4j_tpu_torch.checkpoint import restore_network

        return restore_network(path, device=device)
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x80\x04" or not data.startswith(b"PK"):
        raise ValueError(
            f"Checkpoint {path} is not in the npz format (format_version 2). "
            "v1 checkpoints were pickle streams, which are no longer loaded "
            "(arbitrary-code-execution risk on shared paths); re-save from "
            "the run that produced it, or convert offline with a trusted "
            "pickle.load + DefaultModelSaver.")
    payload = load_payload(data)
    if payload.get("conf_json") is None:
        raise ValueError(
            f"Checkpoint {path} has no conf_json (params-only runtime "
            "checkpoint saved without a config); rebuild the network from "
            "its config and call set_parameters(payload['params']) instead")
    net = MultiLayerNetwork.from_config_json(
        payload["conf_json"], params=to_tensor(payload["params"]),
        device=device)
    if payload.get("updater_state") is not None:
        net._updater_state = map_arrays(
            lambda a: to_tensor(a, net.device), payload["updater_state"])
    net._iteration_count = payload.get("iteration_count", 0)
    info = {
        "iterator_position": payload.get("iterator_position"),
        "metadata": payload.get("metadata", {}),
        "saved_at": payload.get("saved_at"),
    }
    return net, info
