"""Scale-out pieces of the port. Only the single-file checkpoint tier
(`scaleout/checkpoint.py`) is here; the cluster runtime, workers and
state trackers of the JAX package's `scaleout/` are ROADMAP Queue 1
item 14."""

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
