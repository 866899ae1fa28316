"""StateTracker RPC codec: `_to_wire` / `_from_wire`, which turn `Job`s and
DataSet-bearing work into trees the checkpoint codec
(`scaleout/checkpoint.py` `dump_payload`) can write and back.

`scaleout/api.py`'s `LocalWorkRetriever.save` / `load` use them. The rest
of the JAX package's `scaleout/rpc.py` (the framed-TCP tracker server and
`RemoteStateTracker`) comes with ROADMAP Queue 1 item 14b.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from deeplearning4j_tpu_torch.scaleout.api import Job


def _to_wire(obj: Any) -> Any:
    """Jobs (and DataSet-bearing work) -> codec-friendly dicts."""
    if isinstance(obj, Job):
        wire = {"__job__": True,
                "work": _to_wire(obj.work),
                "result": _to_wire(obj.result),
                "worker_id": obj.worker_id,
                "retries": obj.retries}
        if obj.seq is not None:  # omit-when-absent keeps old frames valid
            wire["seq"] = int(obj.seq)
        return wire
    if hasattr(obj, "features") and hasattr(obj, "labels"):  # DataSet
        return {"__dataset__": True,
                "features": np.asarray(obj.features),
                "labels": np.asarray(obj.labels)}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_wire(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_wire(v) for k, v in obj.items()}
    return obj


def _from_wire(obj: Any) -> Any:
    if isinstance(obj, dict):
        if obj.get("__job__"):
            seq = obj.get("seq")
            return Job(work=_from_wire(obj["work"]),
                       worker_id=obj["worker_id"],
                       result=_from_wire(obj["result"]),
                       retries=int(obj["retries"]),
                       seq=None if seq is None else int(seq))
        if obj.get("__dataset__"):
            from deeplearning4j_tpu_torch.datasets.api import DataSet
            return DataSet(obj["features"], obj["labels"])
        return {k: _from_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_wire(v) for v in obj)
    return obj
