"""Model families of the port: the transformer LM and the convolution
layer (importing this package registers "conv" / "convolution" in the
layer registry)."""

from deeplearning4j_tpu_torch.models.conv import (  # noqa: F401
    ConvolutionDownSampleLayer)
from deeplearning4j_tpu_torch.models.transformer import (
    TransformerConfig, generate, init_transformer_params, transformer_logits)

__all__ = ["ConvolutionDownSampleLayer", "TransformerConfig", "generate",
           "init_transformer_params", "transformer_logits"]
