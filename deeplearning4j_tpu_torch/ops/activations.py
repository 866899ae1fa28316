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


def _hardtanh(x):
    # jnp.clip is maximum then minimum, each splitting a tie's gradient
    # 0.5/0.5 (torch.clamp would give the whole gradient to x)
    return torch.minimum(torch.maximum(x, x.new_full((), -1.0)),
                         x.new_full((), 1.0))


def _maxout(x):
    # jnp.maximum(x, 0.0): gradient 0.5 at x == 0 (torch.relu gives 0)
    return torch.maximum(x, x.new_zeros(()))


def _abs(x):
    # jnp.abs: gradient 1 at x == 0 (torch.abs gives 0)
    return torch.where(x >= 0, x, -x)


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
    "hardtanh": _hardtanh,
    "softplus": _softplus,
    "softsign": F.softsign,
    "exp": torch.exp,
    "abs": _abs,
    "round": torch.round,   # half to even, as jnp.round
    "sign": torch.sign,
    "sqrt": torch.sqrt,
    # the JAX package's maxout is max(x, 0) (no unit groups in a conf)
    "maxout": _maxout,
}


def apply_activation(name: str, x):
    """Apply the activation named `name` (case-insensitive)."""
    try:
        return ACTIVATIONS[name.lower()](x)
    except KeyError:
        raise ValueError(
            f"Unknown activation {name!r}; known: {sorted(ACTIVATIONS)}"
        ) from None
