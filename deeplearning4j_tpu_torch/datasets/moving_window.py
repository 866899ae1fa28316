"""Moving-window dataset expansion: every example image is sliced into all
rotated sub-windows to generate more training examples.

Parity: reference datasets/iterator/impl/MovingWindowDataSetFetcher.java
(each example -> MovingWindowMatrix(..., addRotate=true).windows(true),
labels copied) + MovingWindowBaseDataSetIterator.java. The reference's
inner loop indexed windows.get(i) instead of .get(j) (an alpha-era bug
that duplicated one window per example); not reproduced.

The port's own copy of the JAX package's `datasets/moving_window.py`.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.utils.moving_window_matrix import \
    MovingWindowMatrix


def expand_with_windows(data: DataSet, rows: int, cols: int,
                        window_rows: int, window_cols: int) -> DataSet:
    """All rotated windows of every (rows x cols) example; labels are
    copied to each derived window. (The reference also re-appended the
    raw example, whose width differs from the windows' — merging that
    into one matrix is shape-inconsistent, so only windows are kept; pass
    window == image size to include originals.)"""
    feats, labels = [], []
    for x, y in zip(data.features, data.labels):
        img = np.asarray(x, np.float32).reshape(rows, cols)
        windows = MovingWindowMatrix(img, window_rows, window_cols,
                                     add_rotate=True).windows(flattened=True)
        for w in windows:
            feats.append(w)
            labels.append(y)
    return DataSet(np.stack(feats), np.stack(labels))


class MovingWindowDataSetIterator(DataSetIterator):
    def __init__(self, batch_size: int, data: DataSet, rows: int, cols: int,
                 window_rows: int, window_cols: int):
        self.data = expand_with_windows(data, rows, cols, window_rows,
                                        window_cols)
        super().__init__(batch_size, self.data.num_examples)

    def input_columns(self) -> int:
        return int(self.data.features.shape[1])

    def total_outcomes(self) -> int:
        return int(self.data.labels.shape[1])

    def _fetch(self, start: int, end: int) -> DataSet:
        return DataSet(self.data.features[start:end],
                       self.data.labels[start:end])
