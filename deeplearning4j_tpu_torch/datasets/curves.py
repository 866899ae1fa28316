"""Curves dataset (Hinton's synthetic-curves benchmark used by the
deep-autoencoder literature).

Parity: reference datasets/fetchers/CurvesDataFetcher.java (downloads a
java-serialized `curves.ser` DataSet from S3) + the iterator around it.
The serialized-java artifact is unusable off-JVM and the fetcher never
downloads: it loads a local `.npz` (keys: features, labels)
when given one and otherwise GENERATES curves the way the original
dataset was built: random cubic Bezier curves rasterized into 28x28
grayscale images; labels = features (the dataset is for unsupervised
reconstruction training).

The port's own copy of the JAX package's `datasets/curves.py`.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator

IMAGE_DIM = 28


def _rasterize_bezier(control: np.ndarray, dim: int = IMAGE_DIM,
                      samples: int = 200) -> np.ndarray:
    """Rasterize one cubic Bezier curve (4 control points in [0,1]^2)."""
    t = np.linspace(0.0, 1.0, samples)[:, None]
    p0, p1, p2, p3 = control
    pts = ((1 - t) ** 3 * p0 + 3 * (1 - t) ** 2 * t * p1
           + 3 * (1 - t) * t ** 2 * p2 + t ** 3 * p3)
    img = np.zeros((dim, dim), np.float32)
    ij = np.clip((pts * (dim - 1)).round().astype(int), 0, dim - 1)
    img[ij[:, 1], ij[:, 0]] = 1.0
    return img


def synthetic_curves(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    control = rng.rand(n, 4, 2)
    return np.stack([_rasterize_bezier(c) for c in control]).reshape(n, -1)


class CurvesDataFetcher:
    def __init__(self, n_examples: int = 1000, path: Optional[str] = None,
                 seed: int = 0):
        if path and os.path.exists(path):
            with np.load(path) as z:
                features = np.asarray(z["features"], np.float32)
                labels = (np.asarray(z["labels"], np.float32)
                          if "labels" in z else features)
        else:
            features = synthetic_curves(n_examples, seed)
            labels = features
        self.data = DataSet(features, labels)
        self.total_examples = self.data.num_examples


class CurvesDataSetIterator(DataSetIterator):
    def __init__(self, batch_size: int, num_examples: int = 1000,
                 path: Optional[str] = None, seed: int = 0):
        self.fetcher = CurvesDataFetcher(num_examples, path, seed)
        super().__init__(batch_size,
                         min(num_examples, self.fetcher.total_examples))

    def input_columns(self) -> int:
        return int(self.fetcher.data.features.shape[1])

    def total_outcomes(self) -> int:
        return int(self.fetcher.data.labels.shape[1])

    def _fetch(self, start: int, end: int) -> DataSet:
        return DataSet(self.fetcher.data.features[start:end],
                       self.fetcher.data.labels[start:end])
