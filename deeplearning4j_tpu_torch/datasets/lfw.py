"""LFW (Labeled Faces in the Wild) pipeline.

Parity: reference base/LFWLoader.java:1-214 (download + untar lfw.tgz,
'each subdir is a person', per-image vectors via ImageLoader, one-hot
person labels) and datasets/fetchers/LFWDataFetcher.java:31-96 +
LFWDataSetIterator.

The loader never downloads: it reads
an existing LFW-layout directory (person subdirectories of images; a
downloaded lfw.tgz is unpacked via utils.unzip_file_to if present), and
`synthetic_lfw` writes a deterministic face-shaped fixture with the same
layout for tests — mirroring the synthetic-MNIST approach in mnist.py.

The port's own copy of the JAX package's `datasets/lfw.py`.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.datasets.records import ImageRecordReader


def synthetic_lfw(root: str, num_people: int = 5, images_per_person: int = 4,
                  height: int = 28, width: int = 28, seed: int = 0) -> str:
    """Write an LFW-layout directory of synthetic 'face' images (one blob
    pattern per person + noise) and return its path."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    yy, xx = np.mgrid[0:height, 0:width]
    for p in range(num_people):
        person_dir = os.path.join(root, f"person_{p:03d}")
        os.makedirs(person_dir, exist_ok=True)
        cy, cx = rng.randint(height // 4, 3 * height // 4, 2)
        base = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2)
                        / (2.0 * (2 + p) ** 2)))
        for i in range(images_per_person):
            img = base * 200 + rng.rand(height, width) * 55
            Image.fromarray(img.astype(np.uint8), mode="L").save(
                os.path.join(person_dir, f"img_{i:04d}.png"))
    return root


class LFWLoader:
    """Loads an LFW-layout directory into (features, one-hot labels)."""

    def __init__(self, path: str, height: int = 28, width: int = 28):
        if not os.path.isdir(path):
            archive = path if os.path.isfile(path) else None
            if archive and archive.endswith((".tgz", ".tar.gz")):
                from deeplearning4j_tpu_torch.utils.archive import \
                    unzip_file_to

                dest = archive.rsplit(".", 1)[0] + "_extracted"
                unzip_file_to(archive, dest)
                entries = [os.path.join(dest, d) for d in os.listdir(dest)]
                dirs = [d for d in entries if os.path.isdir(d)]
                path = dirs[0] if len(dirs) == 1 else dest
            else:
                raise FileNotFoundError(
                    f"LFW directory {path} not found (the loader never "
                    "downloads — provide an unpacked LFW tree or a local "
                    "lfw.tgz; synthetic_lfw() writes a test fixture)")
        self.path = path
        self.reader = ImageRecordReader(path, height=height, width=width)
        self.height, self.width = height, width

    @property
    def num_names(self) -> int:
        return len(self.reader.labels)

    @property
    def num_pixel_columns(self) -> int:
        return self.height * self.width

    def get_all_images(self) -> DataSet:
        feats: List[np.ndarray] = []
        idx: List[int] = []
        label_to_i = {name: i for i, name in enumerate(self.reader.labels)}
        for rec in self.reader.records():
            feats.append(np.asarray(rec[:-1], np.float32))
            idx.append(label_to_i[rec[-1]])
        features = np.stack(feats) / 255.0
        labels = np.zeros((len(idx), self.num_names), np.float32)
        labels[np.arange(len(idx)), idx] = 1.0
        return DataSet(features, labels)


class LFWDataFetcher:
    """reference LFWDataFetcher.java:31 — cursor-based fetch over the
    loaded images."""

    def __init__(self, path: str, height: int = 28, width: int = 28):
        self.loader = LFWLoader(path, height, width)
        self.data = self.loader.get_all_images()
        self.cursor = 0

    @property
    def total_examples(self) -> int:
        return self.data.num_examples

    def fetch(self, num_examples: int) -> DataSet:
        end = min(self.cursor + num_examples, self.total_examples)
        ds = DataSet(self.data.features[self.cursor:end],
                     self.data.labels[self.cursor:end])
        self.cursor = end
        return ds

    def reset(self) -> None:
        self.cursor = 0


class LFWDataSetIterator(DataSetIterator):
    """reference LFWDataSetIterator (iterator/impl/)."""

    def __init__(self, batch_size: int, path: str,
                 num_examples: Optional[int] = None,
                 height: int = 28, width: int = 28):
        self.fetcher = LFWDataFetcher(path, height, width)
        total = min(num_examples or self.fetcher.total_examples,
                    self.fetcher.total_examples)
        super().__init__(batch_size, total)

    def input_columns(self) -> int:
        return self.fetcher.loader.num_pixel_columns

    def total_outcomes(self) -> int:
        return self.fetcher.loader.num_names

    def _fetch(self, start: int, end: int) -> DataSet:
        return DataSet(self.fetcher.data.features[start:end],
                       self.fetcher.data.labels[start:end])
