"""Model families of the port: the transformer LM, the convolution layer
and the pretraining layers (importing this package registers "conv",
"rbm", "autoencoder" and "recursive_autoencoder" in the layer
registry)."""

from deeplearning4j_tpu_torch.models.conv import (  # noqa: F401
    ConvolutionDownSampleLayer)
from deeplearning4j_tpu_torch.models.pretrain import (  # noqa: F401
    RBM, AutoEncoder, RecursiveAutoEncoder)
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, generate, init_transformer_params, transformer_logits)

__all__ = ["ConvolutionDownSampleLayer", "RBM", "AutoEncoder",
           "RecursiveAutoEncoder", "TransformerConfig", "generate",
           "init_transformer_params", "transformer_logits"]
