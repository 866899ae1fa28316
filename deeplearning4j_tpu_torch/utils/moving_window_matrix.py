"""Sliding sub-matrix extraction (reference core/util/
MovingWindowMatrix.java:38-120 — all windowRowSize x windowColumnSize
sub-matrices of a matrix, optionally with three extra 90-degree rotations
of each window).

Vectorized: one stride-tricks view + reshape produces every window in a
single O(1)-copy operation instead of the reference's per-offset slicing
loop.

The port's own copy of the JAX package's `utils/moving_window_matrix.py`.
"""

from __future__ import annotations

from typing import List

import numpy as np


class MovingWindowMatrix:
    def __init__(self, to_slice, window_row_size: int,
                 window_column_size: int, add_rotate: bool = False):
        self.matrix = np.asarray(to_slice)
        if self.matrix.ndim != 2:
            raise ValueError(f"Expected a matrix, got ndim={self.matrix.ndim}")
        r, c = self.matrix.shape
        if window_row_size > r or window_column_size > c:
            raise ValueError(
                f"Window ({window_row_size}, {window_column_size}) exceeds "
                f"matrix shape {self.matrix.shape}")
        self.window_row_size = window_row_size
        self.window_column_size = window_column_size
        self.add_rotate = add_rotate

    def windows(self, flattened: bool = False) -> List[np.ndarray]:
        """Every contiguous window, row-major by top-left offset; with
        add_rotate, each window is followed by its 3 successive 90-degree
        rotations (reference windows(boolean) :88)."""
        wr, wc = self.window_row_size, self.window_column_size
        view = np.lib.stride_tricks.sliding_window_view(
            self.matrix, (wr, wc))
        wins = view.reshape(-1, wr, wc)
        out: List[np.ndarray] = []
        for w in wins:
            out.append(w.copy())
            if self.add_rotate:
                rot = w
                for _ in range(3):
                    rot = np.rot90(rot)
                    out.append(rot.copy())
        if flattened:
            out = [w.ravel() for w in out]
        return out
