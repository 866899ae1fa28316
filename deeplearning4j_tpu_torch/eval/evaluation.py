"""Classification metrics from confusion counts.

Parity: reference core/eval/Evaluation.java — `eval(realOutcomes, guesses)`
(:46), `precision`/`recall`/`f1`/`accuracy` (:160-244), `stats()` (:97).
Inputs are one-hot (or probability) matrices like the reference's INDArray
outcome/guess pairs; tensors (on any device) and numpy arrays are
accepted and pulled to the host once. The port's copy of the JAX
package's `eval/evaluation.py`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.eval.confusion import ConfusionMatrix


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


class Evaluation:
    def __init__(self, num_classes: Optional[int] = None):
        self.num_classes = num_classes
        self.confusion: Optional[ConfusionMatrix] = None

    def eval(self, real_outcomes, guesses) -> None:
        """Accumulate a batch of (one-hot truth, predicted scores)."""
        truth, guess = _host(real_outcomes), _host(guesses)
        n_classes = self.num_classes or truth.shape[-1]
        if self.confusion is None:
            self.confusion = ConfusionMatrix(list(range(n_classes)))
        self.confusion.add_batch(truth.argmax(-1), guess.argmax(-1))

    # ------------------------------------------------------------ metrics
    def _tp(self, c: int) -> int:
        return self.confusion.count(c, c)

    def precision(self, c: Optional[int] = None) -> float:
        if c is not None:
            denom = self.confusion.predicted_total(c)
            return self._tp(c) / denom if denom else 0.0
        vals = [self.precision(c) for c in self.confusion.classes]
        return float(np.mean(vals))

    def recall(self, c: Optional[int] = None) -> float:
        if c is not None:
            denom = self.confusion.actual_total(c)
            return self._tp(c) / denom if denom else 0.0
        vals = [self.recall(c) for c in self.confusion.classes]
        return float(np.mean(vals))

    def f1(self, c: Optional[int] = None) -> float:
        p, r = self.precision(c), self.recall(c)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def accuracy(self) -> float:
        total = self.confusion.total()
        correct = sum(self._tp(c) for c in self.confusion.classes)
        return correct / total if total else 0.0

    def stats(self) -> str:
        """Human-readable summary (reference stats() :97)."""
        lines = ["==========================Scores=====================",
                 str(self.confusion),
                 f" Accuracy:  {self.accuracy():.4f}",
                 f" Precision: {self.precision():.4f}",
                 f" Recall:    {self.recall():.4f}",
                 f" F1 Score:  {self.f1():.4f}",
                 "====================================================="]
        return "\n".join(lines)
