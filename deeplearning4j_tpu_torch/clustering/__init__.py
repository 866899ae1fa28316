"""Clustering + spatial indexes.

Parity: reference core/clustering/ — KMeans (kmeans/KMeansClustering.java
over the BaseClusteringAlgorithm strategy machinery), KDTree
(kdtree/KDTree.java), VPTree (vptree/VpTreeNode.java), QuadTree
(quadtree/QuadTree.java — the Barnes-Hut t-SNE accelerator). The port's
counterpart of the JAX package's `clustering/`, with the same names.

Design: KMeans runs its Lloyd iterations on the device (`device=None` is
the card), one torch function an iteration; the spatial indexes are the
JAX package's host-side numpy structures, copied — pointer-chasing trees
don't belong on the accelerator, and their consumers (neighbor queries,
Barnes-Hut) are host-side too.
"""

from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering  # noqa: F401
from deeplearning4j_tpu_torch.clustering.kdtree import KDTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.vptree import VPTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.quadtree import QuadTree  # noqa: F401
