"""Vantage-point tree for metric nearest-neighbor search.

Parity: reference core/clustering/vptree/VpTreeNode.java (306 LoC):
build by random vantage point + median-distance split; k-NN search with
triangle-inequality pruning.
"""

from __future__ import annotations

import heapq
from typing import Callable, List, Optional, Tuple

import numpy as np


class _VPNode:
    __slots__ = ("index", "threshold", "inside", "outside")

    def __init__(self, index: int):
        self.index = index
        self.threshold = 0.0
        self.inside: Optional["_VPNode"] = None
        self.outside: Optional["_VPNode"] = None


class VPTree:
    def __init__(self, points, distance: Optional[Callable] = None,
                 seed: int = 0):
        self.points = np.asarray(points, np.float64)
        self.distance = distance or (
            lambda a, b: float(np.linalg.norm(a - b)))
        rng = np.random.RandomState(seed)
        self.root = self._build(list(range(self.points.shape[0])), rng)

    def _build(self, idxs: List[int], rng) -> Optional[_VPNode]:
        if not idxs:
            return None
        vp = idxs[rng.randint(len(idxs))]
        rest = [i for i in idxs if i != vp]
        node = _VPNode(vp)
        if not rest:
            return node
        dists = np.array([self.distance(self.points[vp], self.points[i])
                          for i in rest])
        node.threshold = float(np.median(dists))
        inside = [i for i, d in zip(rest, dists) if d < node.threshold]
        outside = [i for i, d in zip(rest, dists) if d >= node.threshold]
        node.inside = self._build(inside, rng)
        node.outside = self._build(outside, rng)
        return node

    def knn(self, query, k: int) -> List[Tuple[float, int]]:
        """k nearest: [(distance, point index)] ascending."""
        query = np.asarray(query, np.float64)
        heap: List[Tuple[float, int]] = []  # max-heap by -dist

        def rec(node: Optional[_VPNode]):
            if node is None:
                return
            d = self.distance(query, self.points[node.index])
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index))
            tau = -heap[0][0] if len(heap) == k else np.inf
            if d < node.threshold:
                rec(node.inside)
                if d + tau >= node.threshold:
                    rec(node.outside)
            else:
                rec(node.outside)
                if d - tau <= node.threshold:
                    rec(node.inside)

        rec(self.root)
        return sorted([(-nd, i) for nd, i in heap], key=lambda t: t[0])
