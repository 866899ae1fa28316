"""Weight initialisation schemes, the counterpart of the JAX package's
`ops/initializers.py`: the six schemes of the reference's WeightInit
enum (VI, ZERO, SIZE, DISTRIBUTION, NORMALIZED, UNIFORM) with the same
fans and ranges.

Random numbers come from an explicit `torch.Generator` (on the CPU, so a
seed gives the same weights on every device) and are drawn in float32,
then cast. They are not the JAX package's numbers: carry weights across
with `weights.multilayer_params_from_jax`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


class WeightInit:
    VI = "vi"
    ZERO = "zero"
    SIZE = "size"
    DISTRIBUTION = "distribution"
    NORMALIZED = "normalized"
    UNIFORM = "uniform"


def _fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) == 4:  # conv HWIO, the JAX package's filter layout
        receptive = shape[0] * shape[1]
        return shape[2] * receptive, shape[3] * receptive
    n = math.prod(shape)
    return n, n


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen) * (hi - lo) + lo


def init_weights(gen: torch.Generator, shape: Tuple[int, ...],
                 scheme: str = WeightInit.VI, dist: Optional[dict] = None,
                 dtype=torch.float32, device=None):
    """A weight tensor of `shape` drawn from `gen` by `scheme`. `dist`
    is the reference's `conf.dist` for DISTRIBUTION: {"type": "normal" |
    "uniform", ...params}."""
    scheme = scheme.lower()
    shape = tuple(int(s) for s in shape)
    fan_in, fan_out = _fans(shape)
    if scheme == WeightInit.ZERO:
        w = torch.zeros(shape)
    elif scheme == WeightInit.VI:
        # uniform in +-sqrt(6 / (fan_in + fan_out)) (Glorot/Bengio)
        r = math.sqrt(6.0 / (fan_in + fan_out))
        w = _uniform(gen, shape, -r, r)
    elif scheme in (WeightInit.SIZE, WeightInit.UNIFORM):
        r = 1.0 / math.sqrt(float(fan_in))
        w = _uniform(gen, shape, -r, r)
    elif scheme == WeightInit.NORMALIZED:
        w = (torch.rand(shape, generator=gen) - 0.5) / float(fan_in)
    elif scheme == WeightInit.DISTRIBUTION:
        d = dist or {"type": "normal", "mean": 0.0, "std": 0.01}
        if d.get("type", "normal") == "uniform":
            w = _uniform(gen, shape, d.get("lower", -1.0), d.get("upper", 1.0))
        else:
            w = d.get("mean", 0.0) + d.get("std", 0.01) * torch.randn(
                shape, generator=gen)
    else:
        raise ValueError(f"Unknown weight init scheme {scheme!r}")
    return w.to(device=device, dtype=dtype)
