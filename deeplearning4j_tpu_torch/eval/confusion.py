"""Confusion matrix (reference core/eval/ConfusionMatrix.java, 258 LoC).

Backed by a dense numpy counts matrix so whole batches accumulate in one
`np.add.at` scatter instead of a per-row Python loop. The port's own
copy of the JAX package's `eval/confusion.py`.
"""

from __future__ import annotations

from typing import List

import numpy as np


class ConfusionMatrix:
    def __init__(self, classes: List[int]):
        self.classes = sorted(classes)
        self._index = {c: i for i, c in enumerate(self.classes)}
        n = len(self.classes)
        self._counts = np.zeros((n, n), np.int64)

    def add(self, actual: int, predicted: int, count: int = 1) -> None:
        self._counts[self._index[actual], self._index[predicted]] += count

    def add_batch(self, actual, predicted) -> None:
        """Accumulate whole label vectors at once (vectorized scatter-add)."""
        cls = np.asarray(self.classes)

        def to_index(vals, name):
            vals = np.asarray(vals).ravel()
            idx = np.searchsorted(cls, vals)
            bad = (idx >= len(cls)) | (cls[np.minimum(idx, len(cls) - 1)]
                                       != vals)
            if bad.any():
                raise KeyError(
                    f"Unknown {name} label(s) {np.unique(vals[bad])!r}; "
                    f"classes are {self.classes}")
            return idx

        a = to_index(actual, "actual")
        p = to_index(predicted, "predicted")
        np.add.at(self._counts, (a, p), 1)

    def count(self, actual: int, predicted: int) -> int:
        return int(self._counts[self._index[actual], self._index[predicted]])

    def actual_total(self, actual: int) -> int:
        return int(self._counts[self._index[actual]].sum())

    def predicted_total(self, predicted: int) -> int:
        return int(self._counts[:, self._index[predicted]].sum())

    def total(self) -> int:
        return int(self._counts.sum())

    def __str__(self) -> str:
        header = "actual\\pred " + " ".join(f"{c:>6}" for c in self.classes)
        rows = [header]
        for a in self.classes:
            rows.append(f"{a:>11} " + " ".join(
                f"{self.count(a, p):>6}" for p in self.classes))
        return "\n".join(rows)
