"""Model families of the port: the transformer LM, the convolution layer,
the pretraining layers and the LSTM (importing this package registers
"conv", "rbm", "autoencoder", "recursive_autoencoder" and "lstm" in the
layer registry)."""

from deeplearning4j_tpu_torch.models.conv import (  # noqa: F401
    ConvolutionDownSampleLayer)
from deeplearning4j_tpu_torch.models.lstm import LSTM  # noqa: F401
from deeplearning4j_tpu_torch.models.pretrain import (  # noqa: F401
    RBM, AutoEncoder, RecursiveAutoEncoder)
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, generate, init_transformer_params, transformer_logits)

__all__ = ["ConvolutionDownSampleLayer", "LSTM", "RBM", "AutoEncoder",
           "RecursiveAutoEncoder", "TransformerConfig", "generate",
           "init_transformer_params", "transformer_logits"]
