"""Visualization: t-SNE, network plotters, render server.

Parity: reference core/plot/ — `Tsne` (Tsne.java: gradient t-SNE with
perplexity-searched affinities), `BarnesHutTsne` (BarnesHutTsne.java:
quadtree-approximated O(n log n) gradient), `NeuralNetPlotter`
(NeuralNetPlotter.java shells out to python/matplotlib scripts — here
matplotlib is called directly, no Runtime.exec), `FilterRenderer` (weight
grids) and the dropwizard coords server (nlp/plot/dropwizard/
RenderApplication.java — here a stdlib http.server). The port's
counterpart of the JAX package's `plot/`, with the same names; the exact
t-SNE iterates on the device, matplotlib is imported at first use.
"""

from deeplearning4j_tpu_torch.plot.tsne import BarnesHutTsne, Tsne  # noqa: F401
from deeplearning4j_tpu_torch.plot.plotter import NeuralNetPlotter  # noqa: F401
from deeplearning4j_tpu_torch.plot.render_server import serve_coords  # noqa: F401
