"""`config_digest`: a copy of the JAX package's
`compilecache/aot.py` function of that name (that module imports jax).
The decode loop's and the engine's `cache_key` embed it, so two programs
built from different configs never share a key."""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

__all__ = ["config_digest"]


def config_digest(obj: Any) -> str:
    """Short stable digest of a config-ish object (dataclass, dict, or
    anything with a deterministic repr) for embedding in program keys.
    Two configs that produce different programs at identical input
    shapes — different layer sizes, kernels, horizons — must land on
    different keys."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = dataclasses.asdict(obj)
    if isinstance(obj, dict):
        text = repr(sorted(obj.items()))
    else:
        text = repr(obj)
    return hashlib.sha256(text.encode()).hexdigest()[:16]
