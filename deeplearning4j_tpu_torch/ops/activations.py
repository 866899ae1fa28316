"""String-named activation functions, the counterpart of the JAX
package's `ops/activations.py`: the same 16 names, each a plain PyTorch
op on the tensor it is given.

Parity: the reference stores `conf.activationFunction` as a string and
resolves it at run time (reference core/nn/layers/BaseLayer.java:202-210).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _leakyrelu(x):
    # jax.nn.leaky_relu: x where x >= 0, else 0.01 x
    return torch.where(x >= 0, x, 0.01 * x)


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0), with no linear cut-over
    return torch.logaddexp(x, torch.zeros_like(x))


ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "leakyrelu": _leakyrelu,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "linear": lambda x: x,
    "identity": lambda x: x,
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "softplus": _softplus,
    "softsign": F.softsign,
    "exp": torch.exp,
    "abs": torch.abs,
    "round": torch.round,   # half to even, as jnp.round
    "sign": torch.sign,
    "sqrt": torch.sqrt,
    # the JAX package's maxout is max(x, 0) (no unit groups in a conf)
    "maxout": torch.relu,
}


def apply_activation(name: str, x):
    """Apply the activation named `name` (case-insensitive)."""
    try:
        return ACTIVATIONS[name.lower()](x)
    except KeyError:
        raise ValueError(
            f"Unknown activation {name!r}; known: {sorted(ACTIVATIONS)}"
        ) from None
