"""Activations, weight initialisers, losses and the float32-output
product of the port's layer network."""

from deeplearning4j_tpu_torch.ops.activations import (  # noqa: F401
    ACTIVATIONS,
    apply_activation,
)
from deeplearning4j_tpu_torch.ops.initializers import (  # noqa: F401
    WeightInit,
    init_weights,
)
from deeplearning4j_tpu_torch.ops.losses import LOSS_FUNCTIONS, loss_fn  # noqa: F401
