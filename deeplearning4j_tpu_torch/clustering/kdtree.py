"""KD-tree for nearest-neighbor queries.

Parity: reference core/clustering/kdtree/KDTree.java (368 LoC): insert,
nearest-neighbor, k-NN, range query. Host-side numpy (see package
docstring for why trees stay off-device).
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("point", "index", "left", "right")

    def __init__(self, point: np.ndarray, index: int):
        self.point = point
        self.index = index
        self.left: Optional["_Node"] = None
        self.right: Optional["_Node"] = None


class KDTree:
    def __init__(self, dims: int):
        self.dims = dims
        self.root: Optional[_Node] = None
        self.size = 0

    @classmethod
    def build(cls, points) -> "KDTree":
        points = np.asarray(points, np.float64)
        tree = cls(points.shape[1])
        # median build for balance
        def rec(idxs: np.ndarray, depth: int) -> Optional[_Node]:
            if idxs.size == 0:
                return None
            axis = depth % tree.dims
            order = idxs[np.argsort(points[idxs, axis])]
            mid = order.size // 2
            node = _Node(points[order[mid]], int(order[mid]))
            node.left = rec(order[:mid], depth + 1)
            node.right = rec(order[mid + 1:], depth + 1)
            return node

        tree.root = rec(np.arange(points.shape[0]), 0)
        tree.size = points.shape[0]
        return tree

    def insert(self, point) -> None:
        point = np.asarray(point, np.float64)
        if point.shape != (self.dims,):
            raise ValueError(f"expected dim {self.dims}, got {point.shape}")
        new = _Node(point, self.size)
        self.size += 1
        if self.root is None:
            self.root = new
            return
        node, depth = self.root, 0
        while True:
            axis = depth % self.dims
            if point[axis] < node.point[axis]:
                if node.left is None:
                    node.left = new
                    return
                node = node.left
            else:
                if node.right is None:
                    node.right = new
                    return
                node = node.right
            depth += 1

    def nn(self, query) -> Tuple[float, np.ndarray]:
        """Nearest neighbor: (distance, point)."""
        res = self.knn(query, 1)
        return res[0]

    def knn(self, query, k: int) -> List[Tuple[float, np.ndarray]]:
        query = np.asarray(query, np.float64)
        heap: List[Tuple[float, int, np.ndarray]] = []  # max-heap by -dist

        def rec(node: Optional[_Node], depth: int):
            if node is None:
                return
            d = float(np.linalg.norm(node.point - query))
            if len(heap) < k:
                heapq.heappush(heap, (-d, node.index, node.point))
            elif d < -heap[0][0]:
                heapq.heapreplace(heap, (-d, node.index, node.point))
            axis = depth % self.dims
            diff = query[axis] - node.point[axis]
            near, far = ((node.left, node.right) if diff < 0
                         else (node.right, node.left))
            rec(near, depth + 1)
            if len(heap) < k or abs(diff) < -heap[0][0]:
                rec(far, depth + 1)

        rec(self.root, 0)
        return sorted([(-nd, pt) for nd, _, pt in heap], key=lambda t: t[0])

    def range(self, lower, upper) -> List[np.ndarray]:
        """All points inside the axis-aligned box [lower, upper]."""
        lower = np.asarray(lower, np.float64)
        upper = np.asarray(upper, np.float64)
        out: List[np.ndarray] = []

        def rec(node: Optional[_Node], depth: int):
            if node is None:
                return
            if np.all(node.point >= lower) and np.all(node.point <= upper):
                out.append(node.point)
            axis = depth % self.dims
            if node.point[axis] >= lower[axis]:
                rec(node.left, depth + 1)
            if node.point[axis] <= upper[axis]:
                rec(node.right, depth + 1)

        rec(self.root, 0)
        return out
