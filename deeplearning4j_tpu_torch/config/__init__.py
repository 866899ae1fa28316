from deeplearning4j_tpu_torch.config.neural_net_configuration import (  # noqa: F401
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.config.multi_layer_configuration import (  # noqa: F401
    MultiLayerConfiguration,
)
