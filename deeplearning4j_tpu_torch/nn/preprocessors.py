"""Input/output preprocessors between layers, the counterpart of the JAX
package's `nn/preprocessors.py`, under the same registry names.

Parity: reference core/nn/conf/preprocessor/ (`ReshapePreProcessor`,
`BinomialSamplingPreProcessor`, `AggregatePreProcessor`) and the
convolution reshape pair (ConvolutionInputPreProcessor.java /
ConvolutionPostProcessor.java). Each is a callable on tensors,
serialized by registry name + args. Images are NHWC, as in the JAX
package.
"""

from __future__ import annotations

from typing import Sequence

import torch

from deeplearning4j_tpu_torch.config.multi_layer_configuration import (
    make_preprocessor, register_preprocessor)


class PreProcessor:
    registry_name = "base"

    def serializable_args(self) -> dict:
        return {}

    def __call__(self, x, *, rng=None):
        raise NotImplementedError


@register_preprocessor("reshape")
class ReshapePreProcessor(PreProcessor):
    """Reshape to a fixed shape, keeping the batch dimension if
    `keep_batch`."""

    def __init__(self, shape: Sequence[int], keep_batch: bool = True):
        self.shape = list(shape)
        self.keep_batch = keep_batch

    def serializable_args(self):
        return {"shape": self.shape, "keep_batch": self.keep_batch}

    def __call__(self, x, *, rng=None):
        if self.keep_batch:
            return x.reshape(x.shape[0], *self.shape)
        return x.reshape(*self.shape)


@register_preprocessor("binomial_sampling")
class BinomialSamplingPreProcessor(PreProcessor):
    """Bernoulli-sample activations (DBN-style stochastic binary units).
    With no generator (inference, scoring) the probabilities pass
    through: the expectation of the sample."""

    def __call__(self, x, *, rng=None):
        if rng is None:
            return x
        return torch.bernoulli(torch.clamp(x, 0.0, 1.0),
                               generator=rng).to(x.dtype)


@register_preprocessor("aggregate")
class AggregatePreProcessor(PreProcessor):
    """Chain preprocessors in order (reference AggregatePreProcessor.java)."""

    def __init__(self, preprocessors: Sequence):
        # live PreProcessors or their {"name", "args"} wire form (the
        # JSON round trip nests children inside this one's args)
        self.preprocessors = [
            p if isinstance(p, PreProcessor) else make_preprocessor(p)
            for p in preprocessors]

    def serializable_args(self):
        return {"preprocessors": [
            {"name": p.registry_name, "args": p.serializable_args()}
            for p in self.preprocessors]}

    def __call__(self, x, *, rng=None):
        for p in self.preprocessors:
            x = p(x, rng=rng)
        return x


@register_preprocessor("conv_input")
class ConvolutionInputPreProcessor(PreProcessor):
    """Flat (B, rows*cols*channels) -> NHWC (B, rows, cols, channels)."""

    def __init__(self, rows: int, cols: int, channels: int = 1):
        self.rows, self.cols, self.channels = rows, cols, channels

    def serializable_args(self):
        return {"rows": self.rows, "cols": self.cols,
                "channels": self.channels}

    def __call__(self, x, *, rng=None):
        return x.reshape(x.shape[0], self.rows, self.cols, self.channels)


@register_preprocessor("conv_output")
class ConvolutionPostProcessor(PreProcessor):
    """NHWC -> flat (B, H*W*C) after a conv stack."""

    def __call__(self, x, *, rng=None):
        return x.reshape(x.shape[0], -1)
