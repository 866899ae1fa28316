"""Feed-forward layers and the layer registry, the counterpart of the
JAX package's `nn/layers.py`.

Parity: reference core/nn/layers/BaseLayer.java (dense affine +
string-named activation, :176/:202), OutputLayer.java (losses via
ops.losses; gradients from autograd) and the factory dispatch of
core/nn/layers/factory/LayerFactories.java:20-30 (a name -> class
registry resolved from conf.layer).

Each layer is an `nn.Module` whose parameters keep the JAX package's
names ("W", "b", ...), created on the layer's device when it is built
and filled by `init_params`. The forward is also a function of an
explicit parameter table (`activate(params, x)`), as the JAX package's
is, so a network can run any table of the right names and shapes.
The affine runs its product in `conf.compute_dtype` with a float32
result (`ops/products.py`), cast to `conf.dtype` before the bias.
Dropout and dropconnect draw from an explicit `torch.Generator` on the
tensor's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Type

import torch
from torch import nn

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.ops.activations import apply_activation
from deeplearning4j_tpu_torch.ops.initializers import init_weights
from deeplearning4j_tpu_torch.ops.losses import loss_fn
from deeplearning4j_tpu_torch.ops.products import matmul_f32

LAYER_REGISTRY: Dict[str, Type["BaseLayer"]] = {}

#: layer types of the JAX package that this port has not taken yet
#: (name -> ROADMAP item); every one resolves now
NOT_PORTED: Dict[str, str] = {}


def register_layer(name: str) -> Callable[[Type["BaseLayer"]],
                                          Type["BaseLayer"]]:
    def deco(cls):
        LAYER_REGISTRY[name] = cls
        cls.layer_name = name
        return cls

    return deco


def torch_dtype(name: str) -> torch.dtype:
    """"float32" / "bfloat16" (a conf's dtype string) -> torch dtype."""
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"Unknown dtype {name!r}")
    return dtype


def apply_dropout(rng: Optional[torch.Generator], x, rate: float,
                  training: bool = True):
    """Inverted dropout: keep-mask + 1/(1-rate) scale. No-op when not
    training, rate == 0, or no generator is given (inference =
    expectation)."""
    if not training or rate <= 0 or rng is None:
        return x
    keep = torch.rand(x.shape, generator=rng, device=x.device) < 1.0 - rate
    return x * keep / (1.0 - rate)


def make_layer(conf, device=None) -> "BaseLayer":
    """Resolve conf.layer through the registry (LayerFactories parity);
    the layer's parameters live on `device` (None = the CUDA device)."""
    name = conf.layer.lower()
    if name not in LAYER_REGISTRY:
        # layer providers register on import; pull them in so configs
        # restored from JSON resolve
        import deeplearning4j_tpu_torch.attention  # noqa: F401
        import deeplearning4j_tpu_torch.models  # noqa: F401
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"layer type {conf.layer!r} is not ported yet: {NOT_PORTED[name]}")
    try:
        cls = LAYER_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown layer type {conf.layer!r}; known: "
            f"{sorted(LAYER_REGISTRY)}") from None
    return cls(conf, device=device)


@register_layer("dense")
class BaseLayer(nn.Module):
    """Dense affine + activation. Reference core/nn/layers/BaseLayer.java."""

    #: parameter names initialised to zero (the reference zeroes every
    #: bias-like variable: b, visible bias vb, encoder biases c/bU)
    BIAS_NAMES = ("b", "vb", "c", "bU", "bias")

    def __init__(self, conf, device=None):
        super().__init__()
        self.conf = conf
        dtype = torch_dtype(conf.dtype)
        device = default_device(device)
        for name, shape in sorted(self.param_shapes().items()):
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, dtype=dtype, device=device)))

    @classmethod
    def is_bias(cls, name: str) -> bool:
        return name in cls.BIAS_NAMES or name.startswith("b")

    # ------------------------------------------------------------- params
    def param_shapes(self) -> Dict[str, tuple]:
        c = self.conf
        return {"W": (c.n_in, c.n_out), "b": (1, c.n_out)}

    def param_dict(self) -> Dict[str, nn.Parameter]:
        """This layer's live parameters by name, in sorted name order."""
        return dict(sorted(self.named_parameters(recurse=False)))

    @torch.no_grad()
    def init_params(self, gen: torch.Generator):
        """DefaultParamInitializer parity: each weight by the conf's
        weight-init scheme, drawn from `gen` in sorted name order; biases
        zero (reference core/nn/params/DefaultParamInitializer.java:29-50).
        Returns the parameter table."""
        c = self.conf
        for name, p in self.param_dict().items():
            if self.is_bias(name):
                p.zero_()
            else:
                p.copy_(init_weights(gen, tuple(p.shape), c.weight_init,
                                     c.dist, p.dtype))
            c.variable(name)
        return self.param_dict()

    # ------------------------------------------------------------ forward
    def _affine(self, params, x, W_name="W", b_name="b"):
        c = self.conf
        cd = torch_dtype(c.compute_dtype)
        y = matmul_f32(x.to(cd), params[W_name].to(cd))
        return y.to(torch_dtype(c.dtype)) + params[b_name]

    def pre_output(self, params, x, *, rng: Optional[torch.Generator] = None,
                   training: bool = False):
        """x @ W + b, with dropconnect on W when training (reference
        MultiLayerNetwork dropconnect mask :515)."""
        c = self.conf
        if training and c.use_drop_connect and c.dropout > 0 \
                and rng is not None:
            w = params["W"]
            keep = torch.rand(w.shape, generator=rng,
                              device=w.device) < 1.0 - c.dropout
            params = dict(params, W=w * keep)
        return self._affine(params, x)

    def activate(self, params, x, *, rng: Optional[torch.Generator] = None,
                 training: bool = False):
        c = self.conf
        act = apply_activation(c.activation_function,
                               self.pre_output(params, x, rng=rng,
                                               training=training))
        if not c.use_drop_connect:
            act = apply_dropout(rng, act, c.dropout, training)
        return act

    def forward(self, x, *, rng: Optional[torch.Generator] = None,
                training: bool = False):
        return self.activate(self.param_dict(), x, rng=rng,
                             training=training)


@register_layer("output")
class OutputLayer(BaseLayer):
    """Classification/regression head (reference
    core/nn/layers/OutputLayer.java): the configured loss over the
    activated output."""

    def loss(self, params, x, labels, *, rng=None, training: bool = False,
             weights=None):
        """Unregularised data loss; L2 lives in MultiLayerNetwork.loss_fn.
        `weights` (per example) masks the device feed's padding rows out
        of the mean."""
        out = self.activate(params, x, rng=rng, training=training)
        return loss_fn(self.conf.loss_function)(labels, out, weights)
