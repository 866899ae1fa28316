"""KMeans clustering.

Parity: reference core/clustering/kmeans/KMeansClustering.java (+ the
strategy/condition machinery of clustering/algorithm/BaseClusteringAlgorithm:
iterate until max iterations or distribution-variation convergence).
The port's counterpart of the JAX package's `clustering/kmeans.py`.

Design: k-means++ seeding on the host, from the same
`np.random.RandomState(seed)` draws as the JAX package, so both seed
identically; then each Lloyd iteration is ONE torch function on the
device (`lloyd_step`): the (n, k) squared distances by the expansion
trick (a float32 matmul: the package turns TF32 off), `argmin`, the
centroid update as a one-hot matmul, empty clusters kept where they
were, and the largest centroid shift. `fit` reads the shift back once
an iteration, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import default_device


def lloyd_step(x: torch.Tensor, centroids: torch.Tensor):
    """One assign/update step: (new centroids, assignment, largest shift
    as a 0-d tensor), all on x's device."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(centroids * centroids, dim=1)[None, :]
    d2 = x2 + c2 - 2.0 * (x @ centroids.T)
    assign = torch.argmin(d2, dim=1)
    one_hot = F.one_hot(assign, centroids.shape[0]).to(x.dtype)
    sizes = one_hot.sum(dim=0)
    new_centroids = (one_hot.T @ x) / torch.clamp_min(sizes, 1.0)[:, None]
    # keep empty clusters where they were
    new_centroids = torch.where((sizes == 0)[:, None], centroids,
                                new_centroids)
    shift = torch.linalg.vector_norm(new_centroids - centroids, dim=1).max()
    return new_centroids, assign, shift


class KMeansClustering:
    """`device` (None = the card, raising without one) runs the Lloyd
    iterations; `centroids` is host numpy after `fit`, as in the JAX
    package, and `n_iter_` the number of iterations run."""

    def __init__(self, k: int, max_iterations: int = 100, tol: float = 1e-4,
                 seed: int = 0, device=None):
        self.k = k
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.device = default_device(device)
        self.centroids: Optional[np.ndarray] = None
        self.n_iter_ = 0

    # ------------------------------------------------------------- seeding
    def _init_centroids(self, x: np.ndarray, rng: np.random.RandomState
                        ) -> np.ndarray:
        """k-means++ seeding."""
        n = x.shape[0]
        centroids = [x[rng.randint(n)]]
        for _ in range(1, self.k):
            d2 = np.min(
                ((x[:, None, :] - np.stack(centroids)[None]) ** 2).sum(-1),
                axis=1)
            total = d2.sum()
            if total <= 0:  # fewer distinct points than k: uniform fallback
                centroids.append(x[rng.randint(n)])
            else:
                centroids.append(x[rng.choice(n, p=d2 / total)])
        return np.stack(centroids)

    # ------------------------------------------------------------ training
    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=self.device)

    def fit(self, x) -> "KMeansClustering":
        x = np.asarray(x, np.float32)
        if x.shape[0] < self.k:
            raise ValueError(f"k={self.k} > n={x.shape[0]} points")
        rng = np.random.RandomState(self.seed)
        centroids = self._on_device(self._init_centroids(x, rng))
        xt = self._on_device(x)
        self.n_iter_ = 0
        for _ in range(self.max_iterations):
            centroids, _, shift = lloyd_step(xt, centroids)
            self.n_iter_ += 1
            if float(shift) < self.tol:
                break
        self.centroids = centroids.cpu().numpy()
        return self

    def predict(self, x) -> np.ndarray:
        if self.centroids is None:
            raise RuntimeError("call fit() first")
        _, assign, _ = lloyd_step(self._on_device(np.asarray(x, np.float32)),
                                  self._on_device(self.centroids))
        return assign.cpu().numpy()
