"""Whole-network configuration with JSON round-trip: the port's own copy
of the JAX package's `config/multi_layer_configuration.py`. The JSON is
the same wire format, so a configuration written by either package
loads in the other.

Parity: reference core/nn/conf/MultiLayerConfiguration.java:29-41
(hiddenLayerSizes, per-layer conf list, pretrain flag, per-layer
`OutputPreProcessor` map, toJson:141 / fromJson:155). Preprocessors
serialize by registry name, so the JSON stays self-contained.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List

from deeplearning4j_tpu_torch.config.neural_net_configuration import (
    NeuralNetConfiguration)

# Registry: name -> kw-arg factory for input/output preprocessors
# (filled by deeplearning4j_tpu_torch.nn.preprocessors when imported).
PREPROCESSOR_REGISTRY: Dict[str, Any] = {}


def register_preprocessor(name: str):
    def deco(cls):
        PREPROCESSOR_REGISTRY[name] = cls
        cls.registry_name = name
        return cls

    return deco


def make_preprocessor(spec: Dict[str, Any]):
    """A preprocessor from its {"name", "args"} wire form."""
    # the registry fills when the preprocessors module is imported
    import deeplearning4j_tpu_torch.nn.preprocessors  # noqa: F401
    try:
        factory = PREPROCESSOR_REGISTRY[spec["name"]]
    except KeyError:
        raise ValueError(
            f"Unknown preprocessor {spec['name']!r}; known: "
            f"{sorted(PREPROCESSOR_REGISTRY)}") from None
    return factory(**spec.get("args", {}))


@dataclass
class MultiLayerConfiguration:
    confs: List[NeuralNetConfiguration] = field(default_factory=list)
    hidden_layer_sizes: List[int] = field(default_factory=list)
    pretrain: bool = True
    backprop: bool = True
    use_drop_connect: bool = False
    damping_factor: float = 10.0
    #: layer index -> preprocessor applied to that layer's input
    input_preprocessors: Dict[int, Any] = field(default_factory=dict)
    #: layer index -> preprocessor applied to that layer's output
    output_preprocessors: Dict[int, Any] = field(default_factory=dict)

    @property
    def n_layers(self) -> int:
        return len(self.confs)

    def conf(self, i: int) -> NeuralNetConfiguration:
        return self.confs[i]

    # ----------------------------------------------------------- JSON wire
    def to_dict(self) -> Dict[str, Any]:
        def pp_map(d):
            return {
                str(i): {"name": p.registry_name, "args": p.serializable_args()}
                for i, p in d.items()
            }

        return {
            "confs": [c.to_dict() for c in self.confs],
            "hidden_layer_sizes": list(self.hidden_layer_sizes),
            "pretrain": self.pretrain,
            "backprop": self.backprop,
            "use_drop_connect": self.use_drop_connect,
            "damping_factor": self.damping_factor,
            "input_preprocessors": pp_map(self.input_preprocessors),
            "output_preprocessors": pp_map(self.output_preprocessors),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MultiLayerConfiguration":
        def pp_map(m):
            return {int(i): make_preprocessor(spec)
                    for i, spec in (m or {}).items()}

        return cls(
            confs=[NeuralNetConfiguration.from_dict(c) for c in d["confs"]],
            hidden_layer_sizes=list(d.get("hidden_layer_sizes", [])),
            pretrain=d.get("pretrain", True),
            backprop=d.get("backprop", True),
            use_drop_connect=d.get("use_drop_connect", False),
            damping_factor=d.get("damping_factor", 10.0),
            input_preprocessors=pp_map(d.get("input_preprocessors")),
            output_preprocessors=pp_map(d.get("output_preprocessors")),
        )

    @classmethod
    def from_json(cls, s: str) -> "MultiLayerConfiguration":
        return cls.from_dict(json.loads(s))
