"""Network visualization: weight histograms, activation renders, filter grids.

Parity: reference core/plot/NeuralNetPlotter.java (plotWeightHistograms
:164, plotActivations :196, renderGraph via Runtime.exec("python plot.py")
:245 + bundled scripts/plot.py|render.py) and FilterRenderer (557 LoC
weight-grid images). Matplotlib is invoked in-process (Agg backend) instead
of shelling out, and a hook is provided as an IterationListener so renders
happen during training like NeuralNetPlotterIterationListener. The
port's counterpart of the JAX package's `plot/plotter.py`: the network's
parameter tables and activations are tensors (on the card, perhaps), so
they come to host numpy before matplotlib sees them; matplotlib is
imported at first use.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

import torch

from deeplearning4j_tpu_torch.optimize.listeners import IterationListener


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


class NeuralNetPlotter:
    def __init__(self, out_dir: str = "plots"):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def plot_weight_histograms(self, network, path: Optional[str] = None
                               ) -> str:
        """One histogram per named parameter (plotWeightHistograms :164)."""
        plt = _plt()
        tables = network.param_table
        names = [(li, name) for li, t in tables.items() for name in t]
        cols = max(1, min(4, len(names)))
        rows = math.ceil(len(names) / cols)
        fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows),
                                 squeeze=False)
        for ax in axes.flat:
            ax.axis("off")
        for k, (li, name) in enumerate(names):
            ax = axes[k // cols][k % cols]
            ax.axis("on")
            ax.hist(_host(tables[li][name]).ravel(), bins=50)
            ax.set_title(f"layer {li} / {name}", fontsize=8)
        path = path or os.path.join(self.out_dir, "weight_histograms.png")
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return path

    def plot_activations(self, network, x, path: Optional[str] = None) -> str:
        """Heatmap of each layer's activations on a batch
        (plotActivations :196)."""
        plt = _plt()
        acts = network.feed_forward(_host(x))
        fig, axes = plt.subplots(1, len(acts), figsize=(4 * len(acts), 4),
                                 squeeze=False)
        for i, act in enumerate(acts):
            a = _host(act)
            if a.ndim > 2:
                a = a.reshape(a.shape[0], -1)
            axes[0][i].imshow(a, aspect="auto", cmap="viridis")
            axes[0][i].set_title("input" if i == 0 else f"layer {i - 1}",
                                 fontsize=8)
        path = path or os.path.join(self.out_dir, "activations.png")
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return path

    def render_filters(self, weights, image_shape, path: Optional[str] = None,
                       cols: int = 10) -> str:
        """Tile first-layer weights as image patches
        (reference FilterRenderer)."""
        plt = _plt()
        w = _host(weights)
        if w.ndim == 4:  # HWIO conv filters -> one (fh*fw*cin,) row per map
            filters = np.transpose(w, (3, 0, 1, 2)).reshape(w.shape[3], -1)
            image_shape = image_shape or (w.shape[0], w.shape[1] * w.shape[2])
        else:  # dense W (n_in, n_out): each column is a filter over the input
            filters = w.T
        n = filters.shape[0]
        rows = math.ceil(n / cols)
        fig, axes = plt.subplots(rows, cols, figsize=(cols, rows),
                                 squeeze=False)
        for ax in axes.flat:
            ax.axis("off")
        for k in range(n):
            img = filters[k].reshape(image_shape)
            axes[k // cols][k % cols].imshow(img, cmap="gray")
        path = path or os.path.join(self.out_dir, "filters.png")
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return path


class PlotterIterationListener(IterationListener):
    """Render every N iterations during training
    (reference NeuralNetPlotterIterationListener)."""

    def __init__(self, plotter: Optional[NeuralNetPlotter] = None,
                 every: int = 10):
        self.plotter = plotter or NeuralNetPlotter()
        self.every = every

    def iteration_done(self, model, iteration: int, score: float) -> None:
        if iteration % self.every == 0 and model is not None:
            try:
                self.plotter.plot_weight_histograms(model)
            except Exception:  # rendering must never kill training
                pass
