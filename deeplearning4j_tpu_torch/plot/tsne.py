"""t-SNE: exact (on the device) and Barnes-Hut (quadtree) variants.

Parity: reference core/plot/Tsne.java (calculate :342 — perplexity binary
search for conditional affinities, early exaggeration, momentum gradient
iterations; plot :441 writes coords) and BarnesHutTsne.java:58 (theta-
approximated repulsive forces via QuadTree, implements Model). The
port's counterpart of the JAX package's `plot/tsne.py`.

Design: the affinities (`binary_search_affinities`, `_hbeta`) are the
JAX package's host numpy, so P is the same. The exact variant then keeps
the WHOLE iteration loop on the device (`device=None` is the card): the
(n, n) Student-t numerators with a zero diagonal, Q floored at 1e-12,
the gradient `4 (diag(rowsum PQ) - PQ) Y`, momentum and re-centring, as
plain torch, with nothing read back until the loop ends. The Barnes-Hut
variant is the JAX package's host numpy over `clustering/quadtree.py`.
The initial embedding is `1e-4` times a standard normal draw from a
torch generator seeded with `seed` (`_initial_y`; the JAX package draws
from `jax.random`, so the two embeddings start apart unless its draw is
handed in).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.clustering.quadtree import QuadTree


def _hbeta(d_row: np.ndarray, beta: float):
    p = np.exp(-d_row * beta)
    sum_p = max(p.sum(), 1e-12)
    h = np.log(sum_p) + beta * float((d_row * p).sum()) / sum_p
    return h, p / sum_p


def binary_search_affinities(x: np.ndarray, perplexity: float = 30.0,
                             tol: float = 1e-5) -> np.ndarray:
    """Conditional P with per-point beta search (reference Tsne d2p)."""
    n = x.shape[0]
    x2 = (x * x).sum(1)
    d = x2[:, None] + x2[None, :] - 2 * x @ x.T
    np.fill_diagonal(d, 0.0)
    target = np.log(perplexity)
    p = np.zeros((n, n))
    for i in range(n):
        idx = np.concatenate([np.arange(i), np.arange(i + 1, n)])
        d_row = d[i, idx]
        beta, beta_min, beta_max = 1.0, -np.inf, np.inf
        for _ in range(50):
            h, this_p = _hbeta(d_row, beta)
            diff = h - target
            if abs(diff) < tol:
                break
            if diff > 0:
                beta_min = beta
                beta = beta * 2 if beta_max == np.inf else (beta + beta_max) / 2
            else:
                beta_max = beta
                beta = beta / 2 if beta_min == -np.inf else (beta + beta_min) / 2
        p[i, idx] = this_p
    p = (p + p.T) / (2 * n)
    return np.maximum(p, 1e-12)


class Tsne:
    """Exact t-SNE, iterations on `device` (None = the card, raising
    without one) (reference Tsne.java)."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, n_iter: int = 500,
                 momentum: float = 0.5, final_momentum: float = 0.8,
                 switch_momentum_iteration: int = 250,
                 early_exaggeration: float = 12.0,
                 stop_lying_iteration: int = 100, seed: int = 42,
                 device=None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.switch_momentum_iteration = switch_momentum_iteration
        self.early_exaggeration = early_exaggeration
        self.stop_lying_iteration = stop_lying_iteration
        self.seed = seed
        self.device = default_device(device)
        self.embedding_: Optional[np.ndarray] = None

    def _initial_y(self, n: int) -> np.ndarray:
        """The starting embedding, (n, n_components) float32."""
        gen = torch.Generator().manual_seed(self.seed)
        return (1e-4 * torch.randn(n, self.n_components,
                                   generator=gen)).numpy()

    def affinities(self, x) -> torch.Tensor:
        """The joint P of `x` (host numpy, float64) as float32 on the
        device."""
        x = np.asarray(x, np.float32)
        p = binary_search_affinities(x.astype(np.float64), self.perplexity)
        return torch.as_tensor(p.astype(np.float32), device=self.device)

    def grad_step(self, y, velocity, p_eff, momentum: float):
        """One momentum step: (y re-centred, velocity), on y's device."""
        y2 = torch.sum(y * y, dim=1)
        num = 1.0 / (1.0 + y2[:, None] + y2[None, :] - 2.0 * (y @ y.T))
        num.fill_diagonal_(0.0)
        q = torch.clamp_min(num / torch.sum(num), 1e-12)
        pq = (p_eff - q) * num  # (n, n)
        grad = 4.0 * ((torch.diag(pq.sum(dim=1)) - pq) @ y)
        velocity = momentum * velocity - self.learning_rate * grad
        y = y + velocity
        return y - torch.mean(y, dim=0), velocity

    def iterate(self, p, y, velocity, start: int, stop: int):
        """Iterations start..stop-1 from (y, velocity) over P; reads
        nothing back from the device."""
        p_lying = p * self.early_exaggeration
        for it in range(start, stop):
            p_eff = p_lying if it < self.stop_lying_iteration else p
            momentum = self.momentum \
                if it < self.switch_momentum_iteration \
                else self.final_momentum
            y, velocity = self.grad_step(y, velocity, p_eff, momentum)
        return y, velocity

    def calculate(self, x) -> np.ndarray:
        p = self.affinities(x)
        y = torch.as_tensor(
            np.array(self._initial_y(p.shape[0]), np.float32),
            device=self.device)
        y, _ = self.iterate(p, y, torch.zeros_like(y), 0, self.n_iter)
        self.embedding_ = y.cpu().numpy()
        return self.embedding_

    def fit_transform(self, x) -> np.ndarray:
        return self.calculate(x)  # dispatches to the subclass's calculate

    def plot(self, x, labels=None, path: str = "tsne.png") -> str:
        """Render the embedding to an image (reference plot :441 shells to
        matplotlib; here it's a direct call)."""
        y = self.calculate(x) if self.embedding_ is None else self.embedding_
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 8))
        if labels is not None:
            labels = np.asarray(labels)
            for lbl in np.unique(labels):
                m = labels == lbl
                ax.scatter(y[m, 0], y[m, 1], s=8, label=str(lbl))
            ax.legend(markerscale=2)
        else:
            ax.scatter(y[:, 0], y[:, 1], s=8)
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path


class BarnesHutTsne(Tsne):
    """theta-approximate t-SNE over a QuadTree
    (reference BarnesHutTsne.java:58), on the host."""

    def __init__(self, theta: float = 0.5, **kw):
        kw.setdefault("n_iter", 300)
        kw.setdefault("device", "cpu")  # host numpy throughout
        super().__init__(**kw)
        self.theta = theta

    def calculate(self, x) -> np.ndarray:
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        p = binary_search_affinities(x, self.perplexity)
        rng = np.random.RandomState(self.seed)
        y = 1e-4 * rng.randn(n, 2)
        velocity = np.zeros_like(y)
        for it in range(self.n_iter):
            exag = self.early_exaggeration \
                if it < self.stop_lying_iteration else 1.0
            momentum = self.momentum if it < self.switch_momentum_iteration \
                else self.final_momentum
            # attractive forces (exact over nonzero P; P is dense here)
            y2 = (y * y).sum(1)
            num = 1.0 / (1.0 + y2[:, None] + y2[None, :] - 2 * y @ y.T)
            np.fill_diagonal(num, 0.0)
            pn = (exag * p) * num
            attr = pn.sum(1)[:, None] * y - pn @ y
            # repulsive forces via the quadtree
            tree = QuadTree(points=y)
            rep = np.zeros_like(y)
            z_total = 0.0
            for i in range(n):
                neg_f = np.zeros(2)
                z_total += tree.compute_non_edge_forces(
                    y[i], self.theta, neg_f)
                rep[i] = neg_f
            grad = 4.0 * (attr - rep / max(z_total, 1e-12))
            velocity = momentum * velocity - self.learning_rate * grad
            y = y + velocity
            y -= y.mean(0)
        self.embedding_ = y.astype(np.float32)
        return self.embedding_
