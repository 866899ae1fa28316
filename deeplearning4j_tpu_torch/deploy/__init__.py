"""Deployment subsystem of the port: the train→serve conveyor
(docs/PIPELINE.md), the counterpart of the JAX package's `deploy/`.

`DeploymentController` closes the loop between the two halves: training
commits sharded checkpoints (`checkpoint/`), and the serving fleet
hot-reloads them with canary + rollback (`serving/fleet.py`). The
controller watches the checkpoint directory, gates each newly COMMITTED
step on a held-out evaluation, and drives the fleet's canary reload,
promoting on probe success and rolling back + quarantining on failure.
Its own decisions journal through `StateFile` (controller.journal) so a
killed controller restarts into the same verdict (`cli watchdog -- pipeline
... --state-dir S` restarts it automatically).
"""

from deeplearning4j_tpu_torch.deploy.controller import (  # noqa: F401
    CANARY,
    ControllerBusy,
    DeploymentController,
    EVALUATING,
    IDLE,
    PROMOTING,
    QUARANTINE_MARKER,
    ROLLING_BACK,
)

__all__ = ["DeploymentController", "ControllerBusy", "QUARANTINE_MARKER",
           "IDLE", "EVALUATING", "CANARY", "PROMOTING", "ROLLING_BACK"]
