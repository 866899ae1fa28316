"""Parameter tables and the parameter-averaging merge, the counterpart
of the JAX package's `nn/api.py`.

A layer's parameters are a named table ({"W": ..., "b": ...}); a
network's are {layer index as a string -> that layer's table}.
"""

from __future__ import annotations

from typing import Any, Dict

Params = Dict[str, Any]


def merge_params(a: Params, b: Params, n: int) -> Params:
    """Parameter averaging, a + (b - a) / n leaf by leaf, as a new tree.

    Parity: reference MultiLayerNetwork.merge (core/nn/multilayer/
    MultiLayerNetwork.java:1361) and BaseLayer.merge (:270)."""
    if isinstance(a, dict):
        return {k: merge_params(a[k], b[k], n) for k in a}
    return a + (b - a) / n

