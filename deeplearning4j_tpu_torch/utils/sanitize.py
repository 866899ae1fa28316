"""Input validation, the port's copy of `validate_batch` from the JAX
package's `utils/sanitize.py:68-95`.

Parity: the reference's shape asserts (e.g. MultiLayerNetwork.java:889),
raised before any product runs, so the message names the config field
instead of a matmul shape mismatch.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["validate_batch"]


def validate_batch(x, labels=None, *, n_in: Optional[int] = None,
                   n_out: Optional[int] = None,
                   context: str = "fit") -> None:
    """Raise ValueError for features that are not at least 2-D or whose
    last dim is not `n_in`, and for labels that are not 2-D one-hot rows
    matching the features' count and `n_out`."""
    if x.ndim < 2:
        raise ValueError(
            f"{context}: features must be at least 2-D (batch, features), "
            f"got shape {tuple(x.shape)}")
    if n_in and x.shape[-1] != n_in:
        raise ValueError(
            f"{context}: features have {x.shape[-1]} columns but the "
            f"first layer's n_in is {n_in}")
    if labels is not None:
        if labels.ndim != 2:
            raise ValueError(
                f"{context}: labels must be 2-D one-hot (batch, classes), "
                f"got shape {tuple(labels.shape)}")
        if labels.shape[0] != x.shape[0]:
            raise ValueError(
                f"{context}: {x.shape[0]} examples but "
                f"{labels.shape[0]} label rows")
        if n_out and labels.shape[-1] != n_out:
            raise ValueError(
                f"{context}: labels have {labels.shape[-1]} columns but "
                f"the output layer's n_out is {n_out}")
