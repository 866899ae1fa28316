"""Image file -> array loading (reference core/util/ImageLoader.java —
asRowVector/asMatrix with optional resize; the LFW pipeline's decoder).

Uses PIL for decoding; arrays come back float32 in [0, 255] like the
reference's BufferedImage RGB extraction.

The port's own copy of the JAX package's `utils/image_loader.py`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class ImageLoader:
    def __init__(self, height: Optional[int] = None,
                 width: Optional[int] = None, grayscale: bool = True):
        self.height = height
        self.width = width
        self.grayscale = grayscale

    def _load(self, path) -> "np.ndarray":
        from PIL import Image

        with Image.open(path) as img:
            img = img.convert("L" if self.grayscale else "RGB")
            if self.height and self.width:
                img = img.resize((self.width, self.height))
            return np.asarray(img, np.float32)

    def as_matrix(self, path) -> np.ndarray:
        """(H, W) grayscale or (H, W, 3) RGB float32 (asMatrix parity)."""
        return self._load(path)

    def as_row_vector(self, path) -> np.ndarray:
        """Flattened image (asRowVector parity)."""
        return self._load(path).ravel()

    @property
    def shape(self) -> Tuple[int, ...]:
        if not (self.height and self.width):
            raise ValueError("shape requires fixed height/width")
        return ((self.height, self.width) if self.grayscale
                else (self.height, self.width, 3))
