"""Scale-out pieces of the port: the single-file checkpoint tier
(`scaleout/checkpoint.py`), the distributable-work API (`scaleout/api.py`),
the in-memory state tracker the serving fleet uses as its health store
(`scaleout/statetracker.py`), the work codec (`scaleout/rpc.py`) and the
status endpoint the deployment controller serves (`scaleout/status.py`).
The cluster runtime, workers, the tracker's RPC server and the rest of
the JAX package's `scaleout/` are ROADMAP Queue 1 item 14b."""

from deeplearning4j_tpu_torch.scaleout.checkpoint import (  # noqa: F401
    DefaultModelSaver,
    ModelSaver,
    OrbaxModelSaver,
    UriModelSaver,
    dump_payload,
    load_checkpoint,
    load_payload,
    register_namedtuple,
)
