"""Array-ecosystem interchange for DataSets.

Parity: reference `spark/util/MLLibUtil.java` — INDArray <-> MLlib
Vector/Matrix and DataSet <-> LabeledPoint conversions, the glue that
let reference models ride another ecosystem's data structures. The
port's counterpart of the JAX package's `utils/interop.py`: numpy (the
host interchange format), torch CPU tensors, device-resident tensors
(`to_device`, where the JAX package's `to_jax` gives jax arrays), and
the (label, features) "labeled point" row form
(MLLibUtil.toLabeledPoint:129: label = argmax of the one-hot row).

numpy <-> torch CPU tensors share memory where the arrays allow it;
`to_device` copies host -> device.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.datasets.api import DataSet


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ------------------------------------------------------------------ numpy
def to_numpy(ds: DataSet) -> Tuple[np.ndarray, np.ndarray]:
    """(features, labels) host arrays (device tensors are fetched)."""
    return _host(ds.features), _host(ds.labels)


def from_numpy(features, labels) -> DataSet:
    f = np.asarray(features)
    y = np.asarray(labels)
    if f.shape[0] != y.shape[0]:
        raise ValueError(f"features rows {f.shape[0]} != labels rows "
                         f"{y.shape[0]}")
    return DataSet(f, y)


# ----------------------------------------------------------------- device
def to_device(ds: DataSet, device=None):
    """Device-resident (features, labels) tensors on `device` (None = the
    CUDA device, raising without one)."""
    dev = default_device(device)
    f, y = to_numpy(ds)
    return (torch.as_tensor(np.ascontiguousarray(f), device=dev),
            torch.as_tensor(np.ascontiguousarray(y), device=dev))


# ------------------------------------------------------------------ torch
def to_torch(ds: DataSet):
    """(features, labels) torch CPU tensors. Sharing is BEST-EFFORT:
    contiguous host-numpy arrays are wrapped zero-copy
    (torch.from_numpy), while non-contiguous or device-backed arrays
    are copied first — mutations through the tensors only reach the
    DataSet in the zero-copy case."""
    f, y = to_numpy(ds)
    return (torch.from_numpy(np.ascontiguousarray(f)),
            torch.from_numpy(np.ascontiguousarray(y)))


def from_torch(features, labels) -> DataSet:
    """DataSet from torch tensors (detached, moved to CPU)."""
    return from_numpy(features.detach().cpu().numpy(),
                      labels.detach().cpu().numpy())


# ---------------------------------------------------------- labeled points
def to_labeled_points(ds: DataSet) -> List[Tuple[int, np.ndarray]]:
    """One (label_index, feature_vector) row per example — the MLlib
    LabeledPoint form (label = argmax of the one-hot labels row,
    MLLibUtil.toLabeledPoint:129-138)."""
    f, y = to_numpy(ds)
    if y.ndim != 2:
        raise ValueError("labels must be one-hot (N, classes)")
    idx = y.argmax(axis=1)
    return [(int(lab), f[i]) for i, lab in enumerate(idx)]


def from_labeled_points(points: Iterable[Tuple[int, Sequence[float]]],
                        num_labels: int) -> DataSet:
    """Rebuild a DataSet from (label_index, features) rows
    (MLLibUtil.fromLabeledPoint:146-170: one-hot at the label index)."""
    labels, feats = [], []
    for lab, vec in points:
        lab = int(lab)
        if not 0 <= lab < num_labels:
            raise ValueError(f"label {lab} outside 0..{num_labels - 1}")
        labels.append(lab)
        feats.append(np.asarray(vec, np.float32))
    if not feats:
        raise ValueError("no labeled points given")
    f = np.stack(feats)
    y = np.eye(num_labels, dtype=np.float32)[labels]
    return DataSet(f, y)


__all__ = ["to_numpy", "from_numpy", "to_device", "to_torch", "from_torch",
           "to_labeled_points", "from_labeled_points"]
