"""The layer network: layers, preprocessors and MultiLayerNetwork."""

from deeplearning4j_tpu_torch.nn import preprocessors  # noqa: F401  (registers)
from deeplearning4j_tpu_torch.nn.layers import (  # noqa: F401
    LAYER_REGISTRY,
    make_layer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork  # noqa: F401
