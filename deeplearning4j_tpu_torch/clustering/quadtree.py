"""Quad-tree over 2D points — the Barnes-Hut t-SNE accelerator.

Parity: reference core/clustering/quadtree/QuadTree.java (491 LoC):
insert with cell subdivision, center-of-mass accumulation, and the
Barnes-Hut `computeNonEdgeForces` traversal (theta criterion).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class _Cell:
    __slots__ = ("x", "y", "hw", "hh")

    def __init__(self, x, y, hw, hh):
        self.x, self.y, self.hw, self.hh = x, y, hw, hh

    def contains(self, px, py) -> bool:
        return (abs(self.x - px) <= self.hw + 1e-12
                and abs(self.y - py) <= self.hh + 1e-12)


class QuadTree:
    QT_NODE_CAPACITY = 1

    def __init__(self, cell: Optional[_Cell] = None, points=None):
        if points is not None:
            points = np.asarray(points, np.float64)
            cx, cy = points[:, 0].mean(), points[:, 1].mean()
            hw = max(points[:, 0].max() - cx, cx - points[:, 0].min()) + 1e-5
            hh = max(points[:, 1].max() - cy, cy - points[:, 1].min()) + 1e-5
            cell = _Cell(cx, cy, hw, hh)
        self.cell = cell
        self.center_of_mass = np.zeros(2)
        self.cum_size = 0
        self.point: Optional[np.ndarray] = None
        self.children = None  # [nw, ne, sw, se]
        if points is not None:
            for p in points:
                self.insert(p)

    # ------------------------------------------------------------- insert
    def insert(self, p) -> bool:
        p = np.asarray(p, np.float64)
        if not self.cell.contains(p[0], p[1]):
            return False
        self.cum_size += 1
        self.center_of_mass += (p - self.center_of_mass) / self.cum_size
        if self.point is None and self.children is None:
            self.point = p
            return True
        if self.children is None:
            if self.point is not None and np.allclose(self.point, p):
                return True  # coincident point: merge into this leaf's mass
            self._subdivide()
        return any(child.insert(p) for child in self.children)

    def _subdivide(self):
        c = self.cell
        hw, hh = c.hw / 2, c.hh / 2
        self.children = [
            QuadTree(_Cell(c.x - hw, c.y - hh, hw, hh)),
            QuadTree(_Cell(c.x + hw, c.y - hh, hw, hh)),
            QuadTree(_Cell(c.x - hw, c.y + hh, hw, hh)),
            QuadTree(_Cell(c.x + hw, c.y + hh, hw, hh)),
        ]
        old, self.point = self.point, None
        for child in self.children:
            if child.insert(old):
                break

    # -------------------------------------------------- Barnes-Hut forces
    def compute_non_edge_forces(self, point, theta: float = 0.5,
                                neg_f=None) -> float:
        """Accumulate repulsive forces on `point`; returns the Z partial sum
        (reference computeNonEdgeForces)."""
        if neg_f is None:
            neg_f = np.zeros(2)
        if self.cum_size == 0:
            return 0.0
        point = np.asarray(point, np.float64)
        diff = point - self.center_of_mass
        d2 = float(diff @ diff)
        is_leaf_same = (self.point is not None
                        and np.allclose(self.point, point))
        max_width = max(self.cell.hw, self.cell.hh) * 2
        if is_leaf_same and self.children is None:
            return 0.0
        if self.children is None or max_width / np.sqrt(d2 + 1e-12) < theta:
            # treat the cell as one body
            q = 1.0 / (1.0 + d2)
            mult = self.cum_size * q
            z = mult
            neg_f += mult * q * diff
            return z
        return sum(child.compute_non_edge_forces(point, theta, neg_f)
                   for child in self.children)
