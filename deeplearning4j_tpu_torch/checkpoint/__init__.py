"""Checkpoints of the port, the counterpart of the JAX package's
`checkpoint/`: the sharded directory format (one `.npy` a leaf with its
crc32, a JSON manifest, a `COMMITTED` marker published last by
`os.replace`), the async writer (the fit loop pays only the
device-to-host snapshot), `ShardedModelSaver`, `restore_network` and
the flat <-> per-layer updater-state conversion. Steps cross between
the packages both ways (docs/CHECKPOINTS.md describes the format).

The writer publishes the `dl4j_ckpt_*` telemetry series, and the
format carries the `checkpoint.write` / `checkpoint.rename` chaos
points. Held back: `restore_params_for` (target shardings, ROADMAP
Queue 1 item 12) raises.
"""

from deeplearning4j_tpu_torch.checkpoint.format import (  # noqa: F401
    CheckpointError,
    CorruptShardError,
    latest_step,
    leaf_summary,
    list_steps,
    load_tree,
    prune,
    read_manifest,
    tree_scalars,
    write_checkpoint,
)
from deeplearning4j_tpu_torch.checkpoint.writer import (  # noqa: F401
    AsyncCheckpointWriter,
    mesh_spec_of,
    snapshot_tree,
)
from deeplearning4j_tpu_torch.checkpoint.convert import (  # noqa: F401
    flat_to_updater_state,
    layer_slices,
    updater_state_to_flat,
)
from deeplearning4j_tpu_torch.checkpoint.restore import (  # noqa: F401
    discover_latest,
    list_committed_steps,
    load_payload_tree,
    restore_network,
    restore_params_for,
    validate_like,
)
from deeplearning4j_tpu_torch.checkpoint.saver import (  # noqa: F401
    ShardedModelSaver,
    is_sharded_checkpoint,
)

__all__ = [
    "CheckpointError", "CorruptShardError", "write_checkpoint", "load_tree",
    "read_manifest", "list_steps", "latest_step", "leaf_summary", "prune",
    "tree_scalars",
    "AsyncCheckpointWriter", "snapshot_tree", "mesh_spec_of",
    "flat_to_updater_state", "updater_state_to_flat", "layer_slices",
    "restore_network", "restore_params_for", "load_payload_tree",
    "discover_latest", "list_committed_steps",
    "validate_like", "ShardedModelSaver", "is_sharded_checkpoint",
]
