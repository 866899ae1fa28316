"""Per-layer hyperparameter configuration with JSON round-trip: the
port's own copy of the JAX package's `config/neural_net_configuration.py`,
field for field, so a JSON string written by either package loads in the
other.

Parity: reference core/nn/conf/NeuralNetConfiguration.java (~40 fields,
fluent `Builder` at :939, Jackson toJson/fromJson at :837/:859). The JSON
form is the wire format: the canonical checkpoint is (config JSON, packed
param vector) (MultiLayerNetwork.java:91).

Deltas from the reference: `seed` seeds explicit generators in place of
the serialized Java `rng`/`dist` objects; `dtype` is the parameters'
dtype and `compute_dtype` the products' ("bfloat16" for the tensor
cores).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class OptimizationAlgorithm:
    """Parity: reference core/nn/api/OptimizationAlgorithm.java."""

    GRADIENT_DESCENT = "gradient_descent"
    CONJUGATE_GRADIENT = "conjugate_gradient"
    HESSIAN_FREE = "hessian_free"
    LBFGS = "lbfgs"
    ITERATION_GRADIENT_DESCENT = "iteration_gradient_descent"


@dataclass
class NeuralNetConfiguration:
    # --- learning-rate / regularization (GradientAdjustment.java:66-113) ---
    lr: float = 1e-1
    momentum: float = 0.5
    #: iteration -> momentum, the reference's `momentumAfter` schedule
    momentum_after: Dict[int, float] = field(default_factory=dict)
    l2: float = 0.0
    use_regularization: bool = False
    use_adagrad: bool = True
    constrain_gradient_to_unit_norm: bool = False
    # --- stochasticity ---
    dropout: float = 0.0
    use_drop_connect: bool = False
    #: denoising-AE corruption level (BasePretrainNetwork.getCorruptedInput)
    corruption_level: float = 0.3
    sparsity: float = 0.0
    #: contrastive-divergence steps (RBM CD-k)
    k: int = 1
    #: causal masking for attention layers (beyond-reference capability)
    causal: bool = False
    #: attention heads (self_attention layer; n_out must divide by it)
    n_heads: int = 1
    # --- architecture ---
    layer: str = "dense"  # layer type name, resolved via nn.layers registry
    n_in: int = 0
    n_out: int = 0
    activation_function: str = "sigmoid"
    weight_init: str = "vi"
    dist: Optional[Dict[str, Any]] = None
    #: RBM unit types: binary | gaussian | softmax | linear / rectified
    visible_unit: str = "binary"
    hidden_unit: str = "binary"
    # --- convolution (ConvolutionDownSampleLayer / ConvolutionParamInitializer) ---
    filter_size: Optional[List[int]] = None  # [h, w]
    stride: Optional[List[int]] = None  # pool stride [h, w]
    num_feature_maps: int = 1
    num_in_feature_maps: int = 1
    # --- training loop ---
    optimization_algo: str = OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT
    loss_function: str = "reconstruction_crossentropy"
    num_iterations: int = 100
    batch_size: int = 100
    minimize: bool = True
    num_line_search_iterations: int = 5
    # --- rng / dtypes ---
    seed: int = 123
    dtype: str = "float32"  # parameter dtype
    compute_dtype: str = "float32"  # products' dtype ("bfloat16": tensor cores)
    # --- bookkeeping (reference `variables` list: param names registered
    #     by ParamInitializers) ---
    variables: List[str] = field(default_factory=list)

    # ------------------------------------------------------------------ API
    def variable(self, name: str) -> None:
        """Register a named parameter (reference addVariable)."""
        if name not in self.variables:
            self.variables.append(name)

    def momentum_for_iteration(self, iteration: int) -> float:
        """Resolve the momentum schedule (reference GradientAdjustment.java:79)."""
        m = self.momentum
        for after, value in sorted(self.momentum_after.items()):
            if iteration >= int(after):
                m = value
        return m

    def copy(self, **overrides) -> "NeuralNetConfiguration":
        new = dataclasses.replace(self)
        # dataclasses.replace keeps shared mutable fields; deep-copy them
        new.momentum_after = dict(self.momentum_after)
        new.variables = list(self.variables)
        new.filter_size = list(self.filter_size) if self.filter_size else None
        new.stride = list(self.stride) if self.stride else None
        new.dist = dict(self.dist) if self.dist else None
        for k, v in overrides.items():
            if not hasattr(new, k):
                raise AttributeError(f"No config field {k!r}")
            setattr(new, k, v)
        return new

    # ----------------------------------------------------------- JSON wire
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["momentum_after"] = {str(k): v for k, v in self.momentum_after.items()}
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NeuralNetConfiguration":
        d = dict(d)
        if "momentum_after" in d and d["momentum_after"] is not None:
            d["momentum_after"] = {int(k): v for k, v in d["momentum_after"].items()}
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"Unknown NeuralNetConfiguration fields: {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "NeuralNetConfiguration":
        return cls.from_dict(json.loads(s))

    # ------------------------------------------------------------- builder
    @classmethod
    def builder(cls) -> "NeuralNetConfigurationBuilder":
        return NeuralNetConfigurationBuilder()


class NeuralNetConfigurationBuilder:
    """Fluent builder, parity with NeuralNetConfiguration.Builder (:939).

    Methods are snake_case field setters; `list(n)` hands off to the
    ListBuilder for stacked configs (reference `Builder.list(int)` :769).
    """

    def __init__(self):
        self._conf = NeuralNetConfiguration()

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if not hasattr(self._conf, name):
            raise AttributeError(f"No config field {name!r}")

        def setter(value):
            setattr(self._conf, name, value)
            return self

        return setter

    def list(self, n_layers: int) -> "ListBuilder":
        return ListBuilder(self._conf, n_layers)

    def build(self) -> NeuralNetConfiguration:
        return self._conf.copy()


class ListBuilder:
    """Builds a MultiLayerConfiguration from a base conf + per-layer overrides.

    Parity: reference NeuralNetConfiguration.ListBuilder.override(ConfOverride)
    (:769,:804-806) — each layer starts as a copy of the base conf and an
    override callback or kwargs dict mutates it.
    """

    def __init__(self, base: NeuralNetConfiguration, n_layers: int):
        self._base = base
        self._n = n_layers
        self._overrides: List[Any] = []
        self._hidden_layer_sizes: List[int] = []
        self._pretrain = True
        self._backprop = True
        self._input_preprocessors: Dict[int, Any] = {}

    def hidden_layer_sizes(self, sizes: List[int]) -> "ListBuilder":
        self._hidden_layer_sizes = list(sizes)
        return self

    def pretrain(self, flag: bool) -> "ListBuilder":
        self._pretrain = flag
        return self

    def backprop(self, flag: bool) -> "ListBuilder":
        self._backprop = flag
        return self

    def override(self, layer_index: int = -1, fn=None, **kwargs) -> "ListBuilder":
        """Override layer `layer_index` (or all if -1) with kwargs or callback."""
        self._overrides.append((layer_index, fn, kwargs))
        return self

    def input_preprocessor(self, layer_index: int, preprocessor) -> "ListBuilder":
        self._input_preprocessors[layer_index] = preprocessor
        return self

    def build(self):
        from deeplearning4j_tpu_torch.config.multi_layer_configuration import (
            MultiLayerConfiguration,
        )

        confs = []
        for i in range(self._n):
            conf = self._base.copy()
            for idx, fn, kwargs in self._overrides:
                if idx in (-1, i):
                    for k, v in kwargs.items():
                        setattr(conf, k, v)
                    if fn is not None:
                        fn(i, conf)
            confs.append(conf)
        return MultiLayerConfiguration(
            confs=confs,
            hidden_layer_sizes=self._hidden_layer_sizes,
            pretrain=self._pretrain,
            backprop=self._backprop,
            input_preprocessors=self._input_preprocessors,
        )
