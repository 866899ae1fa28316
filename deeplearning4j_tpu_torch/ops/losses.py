"""Loss functions, the counterpart of the JAX package's `ops/losses.py`:
the reference's seven output losses plus NLL (reference
core/nn/layers/OutputLayer.java:131-163), each the mean per-example
score, with probabilities clipped to [EPS, 1 - EPS] before a log.
Gradients come from autograd.

Every loss takes an optional `weights` vector over the batch dimension:
the score is then sum(w_i * loss_i) / sum(w), so rows of weight 0 (the
device feed's padding) change neither value nor gradient and the
denominator is the real example count. `weights=None` is the plain
sum / B.
"""

from __future__ import annotations

import torch

EPS = 1e-7


def _clip(p):
    # jnp.clip's tie rule: maximum then minimum, each splitting the
    # gradient 0.5/0.5 at p == EPS or 1 - EPS (torch.clamp gives it all)
    return torch.minimum(torch.maximum(p, p.new_full((), EPS)),
                         p.new_full((), 1.0 - EPS))


def _reduce(pointwise, weights, denom_scale: float = 1.0):
    """sum(pointwise) / (denom_scale * B), optionally example-weighted.
    The weighted denominator is floored at the dtype's `tiny`, so an
    all-masked batch gives 0 rather than 0/0."""
    if weights is None:
        return pointwise.sum() / (denom_scale * pointwise.shape[0])
    per_example = pointwise.reshape(pointwise.shape[0], -1).sum(dim=1)
    w = weights.to(per_example.dtype)
    denom = torch.clamp_min(w.sum(), torch.finfo(per_example.dtype).tiny)
    return (per_example * w).sum() / (denom_scale * denom)


def mcxent(labels, output, weights=None):
    """Multi-class cross entropy: -sum(labels * log(p))."""
    return _reduce(-labels * torch.log(_clip(output)), weights)


def xent(labels, output, weights=None):
    """Binary cross entropy."""
    p = _clip(output)
    return _reduce(-(labels * torch.log(p)
                     + (1.0 - labels) * torch.log(1.0 - p)), weights)


def mse(labels, output, weights=None):
    return _reduce(torch.square(labels - output), weights, 2.0)


def expll(labels, output, weights=None):
    """Exponential log-likelihood (Poisson-style): sum(p - labels*log(p))."""
    p = _clip(output)
    return _reduce(p - labels * torch.log(p), weights)


def rmse_xent(labels, output, weights=None):
    return _reduce(torch.sqrt(torch.square(labels - output) + EPS), weights)


def squared_loss(labels, output, weights=None):
    return _reduce(torch.square(labels - output), weights)


def negativeloglikelihood(labels, output, weights=None):
    """NLL over softmax output: the same form as MCXENT."""
    return _reduce(-labels * torch.log(_clip(output)), weights)


def reconstruction_crossentropy(labels, output, weights=None):
    """Reconstruction cross-entropy (the pretrain layers' score)."""
    p = _clip(output)
    return _reduce(-(labels * torch.log(p)
                     + (1.0 - labels) * torch.log(1.0 - p)), weights)


LOSS_FUNCTIONS = {
    "mcxent": mcxent,
    "xent": xent,
    "mse": mse,
    "expll": expll,
    "rmse_xent": rmse_xent,
    "squared_loss": squared_loss,
    "negativeloglikelihood": negativeloglikelihood,
    "reconstruction_crossentropy": reconstruction_crossentropy,
}


def loss_fn(name: str):
    try:
        return LOSS_FUNCTIONS[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown loss function {name!r}; known: {sorted(LOSS_FUNCTIONS)}"
        ) from None
