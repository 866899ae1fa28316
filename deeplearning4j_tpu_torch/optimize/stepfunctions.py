"""Step functions: how a search direction is applied to parameters, the
counterpart of the JAX package's `optimize/stepfunctions.py`.

Parity: reference core/optimize/stepfunctions/ (DefaultStepFunction,
NegativeDefaultStepFunction, GradientStepFunction,
NegativeGradientStepFunction). Each takes a parameter table (nested
dicts of tensors, as `MultiLayerNetwork.param_table`) or a single
tensor, and a direction of the same structure, and returns a new
structure; nothing is changed in place.
"""

from __future__ import annotations


def _map2(fn, params, direction):
    if isinstance(params, dict):
        return {k: _map2(fn, v, direction[k]) for k, v in params.items()}
    return fn(params, direction)


def default_step(params, direction, step: float = 1.0):
    """params + step * direction (reference DefaultStepFunction)."""
    return _map2(lambda p, d: p + step * d, params, direction)


def negative_default_step(params, direction, step: float = 1.0):
    return _map2(lambda p, d: p - step * d, params, direction)


def gradient_step(params, direction, step: float = 1.0):
    """params + direction, ignoring step (reference GradientStepFunction)."""
    return _map2(lambda p, d: p + d, params, direction)


def negative_gradient_step(params, direction, step: float = 1.0):
    return _map2(lambda p, d: p - d, params, direction)


STEP_FUNCTIONS = {
    "default": default_step,
    "negative_default": negative_default_step,
    "gradient": gradient_step,
    "negative_gradient": negative_gradient_step,
}
