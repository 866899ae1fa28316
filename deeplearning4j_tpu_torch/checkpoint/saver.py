"""ShardedModelSaver: the ModelSaver face of the async sharded writer,
the counterpart of the JAX package's `checkpoint/saver.py`.

A drop-in for the `saver=` of `MultiLayerNetwork.fit` / `fit_scan` and
the guardian's autosave, with DefaultModelSaver's two calls
(`save(network, ...)` / `save_current(params, ...)`), but the payload
lands in the sharded directory format (checkpoint/format.py) through the
bounded async writer (checkpoint/writer.py): the step loop pays only
the device-to-host snapshot.

The step number is the guard's `iterator_position` cursor when one is
passed (so `step_0000000008/` is "after batch 8"), else an
auto-incrementing counter. A preemption flush (`metadata["save_kind"]
== "preempt"`) is written synchronously: `save()` returns once the
marker is in place, since the process is about to die.

`sync=True` writes every save synchronously; `mesh=` and `strategy=`
(e.g. "zero1", "dp", "tp") record the saving topology in the manifest's
`mesh`, which `cli checkpoint inspect` reports. Under the parallel
trainers one rank writes (`parallel/data_parallel.py`).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.checkpoint import format as ckfmt
from deeplearning4j_tpu_torch.checkpoint.writer import (AsyncCheckpointWriter,
                                                       mesh_spec_of)
from deeplearning4j_tpu_torch.scaleout.checkpoint import ModelSaver

__all__ = ["ShardedModelSaver", "SHARDED_FORMAT_VERSION",
           "is_sharded_checkpoint"]

#: format_version 3 = sharded directory (1 = pickle [dead], 2 = npz)
SHARDED_FORMAT_VERSION = 3


class ShardedModelSaver(ModelSaver):
    def __init__(self, directory: str, *, keep: int = 3,
                 max_in_flight: int = 2, sync: bool = False,
                 mesh=None, strategy: Optional[str] = None):
        self.directory = directory
        self.writer = AsyncCheckpointWriter(directory, keep=keep,
                                            max_in_flight=max_in_flight,
                                            sync=sync)
        self._mesh_spec = mesh_spec_of(mesh, strategy)

    # ----------------------------------------------------------- lifecycle
    def flush(self, timeout: Optional[float] = None) -> None:
        self.writer.flush(timeout)

    def close(self) -> None:
        self.writer.close()

    def __enter__(self) -> "ShardedModelSaver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def latest_step(self) -> Optional[int]:
        return self.writer.latest_step()

    # ---------------------------------------------------------------- save
    def _save(self, *, conf_json, params, updater_state, iteration_count,
              iterator_position, metadata, step, wait) -> str:
        meta = dict(metadata or {})
        wait = wait or meta.get("save_kind") == "preempt"
        if step is None and iterator_position is not None:
            step = int(iterator_position)
        payload = {
            "format_version": SHARDED_FORMAT_VERSION,
            "conf_json": conf_json,
            "params": params,
            "updater_state": updater_state,
            "iteration_count": iteration_count,
            "iterator_position": iterator_position,
            "metadata": meta,
            "saved_at": time.time(),
        }
        return self.writer.save(payload, step=step,
                                mesh_spec=self._mesh_spec, wait=wait)

    def save(self, network, *, iterator_position: Optional[int] = None,
             metadata: Optional[Dict[str, Any]] = None,
             step: Optional[int] = None, wait: bool = False) -> str:
        """Checkpoint a network (its params TABLE, not the packed vector)
        + updater state + cursor. Returns the step directory (the commit
        may still be in flight unless wait=True or a preemption)."""
        return self._save(
            conf_json=network.to_json(), params=network.param_table,
            updater_state=network._updater_state,
            iteration_count=network._iteration_count,
            iterator_position=iterator_position, metadata=metadata,
            step=step, wait=wait)

    def save_current(self, params, *, conf_json: Optional[str] = None,
                     iterator_position: Optional[int] = None,
                     metadata: Optional[Dict[str, Any]] = None,
                     step: Optional[int] = None, wait: bool = False) -> str:
        """Checkpoint a bare parameter tree or packed vector
        (DefaultModelSaver.save_current's sharded twin)."""
        return self._save(
            conf_json=conf_json, params=params, updater_state=None,
            iteration_count=0, iterator_position=iterator_position,
            metadata=metadata, step=step, wait=wait)

    # ------------------------------------------------------------- inspect
    def manifest(self, step: Optional[int] = None) -> dict:
        return ckfmt.read_manifest(self.directory, step)

    @property
    def path(self) -> str:
        """The checkpoint root (DefaultModelSaver's `.path`)."""
        return self.directory


def is_sharded_checkpoint(path: str) -> bool:
    """True when `path` is a sharded checkpoint root (holds committed
    step dirs) or a single committed step directory."""
    if not os.path.isdir(path):
        return False
    if os.path.exists(os.path.join(path, ckfmt.MANIFEST)):
        return True
    return ckfmt.latest_step(path) is not None
