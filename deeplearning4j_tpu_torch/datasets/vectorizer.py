"""Vectorizers: turn raw artifacts into DataSets.

Parity: reference datasets/vectorizer/Vectorizer.java + ImageVectorizer.java
:32-100 (image file + label -> DataSet, with fluent binarize()/normalize()).

The port's own copy of the JAX package's `datasets/vectorizer.py`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet


class Vectorizer:
    def vectorize(self) -> DataSet:
        raise NotImplementedError


class ImageVectorizer(Vectorizer):
    """One image file + its label -> a one-example DataSet."""

    def __init__(self, image_path: str, num_labels: int, label: int,
                 height: Optional[int] = None, width: Optional[int] = None):
        from deeplearning4j_tpu_torch.utils.image_loader import \
            ImageLoader

        self.image_path = image_path
        self.num_labels = num_labels
        self.label = label
        self.loader = ImageLoader(height=height, width=width)
        self._binarize_threshold: Optional[int] = None
        self._normalize = False

    def binarize(self, threshold: int = 30) -> "ImageVectorizer":
        self._binarize_threshold = threshold
        self._normalize = False
        return self

    def normalize(self) -> "ImageVectorizer":
        self._normalize = True
        self._binarize_threshold = None
        return self

    def vectorize(self) -> DataSet:
        x = self.loader.as_row_vector(self.image_path)
        if self._binarize_threshold is not None:
            x = (x > self._binarize_threshold).astype(np.float32)
        elif self._normalize:
            x = x / 255.0
        label = np.zeros((1, self.num_labels), np.float32)
        label[0, self.label] = 1.0
        return DataSet(x[None, :], label)
