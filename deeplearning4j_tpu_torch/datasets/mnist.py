"""MNIST: IDX binary readers + iterator.

Parity: reference core/datasets/mnist/ (MnistManager / MnistDbFile /
MnistImageFile / MnistLabelFile — IDX readers), fetchers/MnistDataFetcher.java:37
and base/MnistFetcher.java. Nothing is downloaded: when the IDX files are
absent a deterministic synthetic MNIST-shaped dataset (28x28
class-structured images) is generated instead; real files are used when
present at `data_dir`. The port's own copy of the JAX package's
`datasets/mnist.py`: the same readers and the same synthetic images for
a seed.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator

NUM_EXAMPLES = 60000
NUM_TEST = 10000
IMAGE_SIZE = 28 * 28
NUM_CLASSES = 10


def read_idx_images(path: str) -> np.ndarray:
    """Parse an IDX3 image file (reference MnistImageFile.java)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"Bad IDX image magic {magic} in {path}")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows * cols)


def read_idx_labels(path: str) -> np.ndarray:
    """Parse an IDX1 label file (reference MnistLabelFile.java)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"Bad IDX label magic {magic} in {path}")
        return np.frombuffer(f.read(n), dtype=np.uint8)


def _find(data_dir: str, names) -> Optional[str]:
    for name in names:
        for suffix in ("", ".gz"):
            p = os.path.join(data_dir, name + suffix)
            if os.path.exists(p):
                return p
    return None


def synthetic_mnist(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-shaped data: each class is a distinct smoothed
    template + pixel noise, so models can actually learn the classes."""
    rng = np.random.RandomState(seed)
    templates = rng.rand(NUM_CLASSES, IMAGE_SIZE).astype(np.float32)
    # smooth templates spatially so they look image-like
    t = templates.reshape(NUM_CLASSES, 28, 28)
    t = (t + np.roll(t, 1, 1) + np.roll(t, -1, 1) + np.roll(t, 1, 2)
         + np.roll(t, -1, 2)) / 5.0
    templates = (t.reshape(NUM_CLASSES, IMAGE_SIZE) > 0.5).astype(np.float32)
    labels = rng.randint(0, NUM_CLASSES, n)
    images = templates[labels] * 0.8 + 0.2 * rng.rand(n, IMAGE_SIZE)
    onehot = np.zeros((n, NUM_CLASSES), np.float32)
    onehot[np.arange(n), labels] = 1.0
    return images.astype(np.float32), onehot


def load_mnist(data_dir: str = "data/mnist", train: bool = True,
               num_examples: Optional[int] = None,
               binarize: bool = False) -> DataSet:
    img_names = (["train-images-idx3-ubyte", "train-images.idx3-ubyte"]
                 if train else ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"])
    lbl_names = (["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"]
                 if train else ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"])
    img_path = _find(data_dir, img_names)
    lbl_path = _find(data_dir, lbl_names)
    if img_path and lbl_path:
        images = read_idx_images(img_path).astype(np.float32) / 255.0
        raw = read_idx_labels(lbl_path)
        labels = np.zeros((raw.shape[0], NUM_CLASSES), np.float32)
        labels[np.arange(raw.shape[0]), raw] = 1.0
    else:
        n = num_examples or (NUM_EXAMPLES if train else NUM_TEST)
        images, labels = synthetic_mnist(n, seed=0 if train else 1)
    if binarize:
        images = (images > 0.5).astype(np.float32)
    if num_examples is not None:
        images, labels = images[:num_examples], labels[:num_examples]
    return DataSet(images, labels)


class MnistDataSetIterator(DataSetIterator):
    """Reference MnistDataSetIterator (fetchers/MnistDataFetcher.java:37)."""

    def __init__(self, batch_size: int, num_examples: int,
                 data_dir: str = "data/mnist", train: bool = True,
                 binarize: bool = False):
        super().__init__(batch_size, num_examples)
        self.data = load_mnist(data_dir, train=train,
                               num_examples=num_examples, binarize=binarize)
        self._num_examples = self.data.num_examples

    def input_columns(self) -> int:
        return IMAGE_SIZE

    def total_outcomes(self) -> int:
        return NUM_CLASSES

    def _fetch(self, start: int, end: int) -> DataSet:
        return DataSet(self.data.features[start:end],
                       self.data.labels[start:end])


class RawMnistDataSetIterator(MnistDataSetIterator):
    """MNIST without binarization (reference iterator/impl/
    RawMnistDataSetIterator.java — the raw-pixel variant)."""

    def __init__(self, batch_size: int, num_examples: int,
                 data_dir: str = "data/mnist", train: bool = True):
        super().__init__(batch_size, num_examples, data_dir=data_dir,
                         train=train, binarize=False)
