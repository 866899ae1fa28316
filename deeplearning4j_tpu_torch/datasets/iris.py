"""Iris dataset (reference base/IrisUtils.java + fetchers/
IrisDataFetcher.java), the port's copy of the JAX package's
`datasets/iris.py`.

Loads `data/iris.csv` (sepal_l, sepal_w, petal_l, petal_w, label) if
present, otherwise generates the same deterministic 150-example 3-class
Gaussian dataset as the JAX package, matching the published per-class
feature means and stds of the real Iris data. Nothing is fetched.
Host-side numpy, like the rest of the iterator API.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator

NUM_EXAMPLES = 150
NUM_FEATURES = 4
NUM_CLASSES = 3

# Published per-class feature means/stds (setosa, versicolor, virginica)
_CLASS_MEANS = np.array([
    [5.006, 3.428, 1.462, 0.246],
    [5.936, 2.770, 4.260, 1.326],
    [6.588, 2.974, 5.552, 2.026],
], np.float32)
_CLASS_STDS = np.array([
    [0.352, 0.379, 0.174, 0.105],
    [0.516, 0.314, 0.470, 0.198],
    [0.636, 0.322, 0.552, 0.275],
], np.float32)


def load_iris(data_dir: str = "data", num_examples: Optional[int] = None,
              normalize: bool = True) -> DataSet:
    path = os.path.join(data_dir, "iris.csv")
    if os.path.exists(path):
        raw = np.loadtxt(path, delimiter=",", dtype=np.float32)
        features = raw[:, :NUM_FEATURES]
        raw_labels = raw[:, NUM_FEATURES].astype(int)
    else:
        rng = np.random.RandomState(6)
        per_class = NUM_EXAMPLES // NUM_CLASSES
        features = np.concatenate([
            _CLASS_MEANS[c] + _CLASS_STDS[c] * rng.randn(per_class,
                                                         NUM_FEATURES)
            for c in range(NUM_CLASSES)
        ]).astype(np.float32)
        raw_labels = np.repeat(np.arange(NUM_CLASSES), per_class)
    labels = np.zeros((features.shape[0], NUM_CLASSES), np.float32)
    labels[np.arange(features.shape[0]), raw_labels] = 1.0
    # deterministic shuffle so class order doesn't leak into batch order
    idx = np.random.RandomState(0).permutation(features.shape[0])
    features, labels = features[idx], labels[idx]
    if normalize:
        features = (features - features.mean(0)) / (features.std(0) + 1e-8)
    if num_examples is not None:
        features, labels = features[:num_examples], labels[:num_examples]
    return DataSet(features, labels)


class IrisDataSetIterator(DataSetIterator):
    def __init__(self, batch_size: int, num_examples: int = NUM_EXAMPLES,
                 data_dir: str = "data"):
        super().__init__(batch_size, min(num_examples, NUM_EXAMPLES))
        self.data = load_iris(data_dir, num_examples=num_examples)
        self._num_examples = self.data.num_examples

    def input_columns(self) -> int:
        return NUM_FEATURES

    def total_outcomes(self) -> int:
        return NUM_CLASSES

    def _fetch(self, start: int, end: int) -> DataSet:
        return DataSet(self.data.features[start:end],
                       self.data.labels[start:end])
