"""Artifact plane: URI-addressed blob storage for datasets/checkpoints,
the counterpart of the JAX package's `scaleout/storage.py`.

Parity: reference deeplearning4j-aws S3 stack — `S3Downloader` /
`S3Uploader` (aws/s3/reader/, aws/s3/uploader/), `BucketIterator`
(iterate a bucket's objects), `BaseS3DataSetIterator` (DataSets streamed
from bucket objects), `DataSetLoader`; and the HDFS twins
(hadoop/util/HdfsUtils, BaseHdfsDataSetIterator).

Design: the artifact plane of a cluster is a bucket (GCS or S3).
Remote schemes (`gs://`, `s3://`, `hdfs://`) resolve to local mount
roots (gcsfuse et al.) via the same mount table `UriModelSaver` uses —
after resolution everything is plain file IO with atomic-rename
publication, so the one code path is testable without cloud credentials
and identical on a real cluster. Host code: a DataSet is stored as host
numpy arrays (a tensor is copied to the host first, wherever it lives)
and read back as numpy, as the JAX package's.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.scaleout.checkpoint import (UriModelSaver,
                                                          dump_payload,
                                                          load_payload)
from deeplearning4j_tpu_torch.utils.interop import to_numpy

__all__ = ["ArtifactStore", "StorageDataSetIterator"]


class ArtifactStore:
    """get/put/list over a URI root (reference S3Downloader/S3Uploader/
    BucketIterator rolled into one store object)."""

    def __init__(self, root_uri: str,
                 mounts: Optional[Dict[str, str]] = None):
        self.root_uri = root_uri
        mounts = dict(mounts or {})
        env_root = os.environ.get("DL4J_TPU_ARTIFACT_ROOT")
        if env_root:
            for scheme in UriModelSaver.REMOTE_SCHEMES:
                mounts.setdefault(scheme, env_root)
        self.root = UriModelSaver._resolve(root_uri, mounts)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        path = os.path.normpath(os.path.join(self.root, key))
        if not path.startswith(os.path.normpath(self.root) + os.sep) \
                and path != os.path.normpath(self.root):
            raise ValueError(f"key {key!r} escapes the store root")
        return path

    # ------------------------------------------------------------- blobs
    def put_bytes(self, key: str, data: bytes) -> str:
        """Atomic publish (reference S3Uploader.upload)."""
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return path

    def get_bytes(self, key: str) -> bytes:
        """reference S3Downloader.download."""
        with open(self._path(key), "rb") as f:
            return f.read()

    def upload_file(self, local_path: str, key: Optional[str] = None) -> str:
        with open(local_path, "rb") as f:
            return self.put_bytes(key or os.path.basename(local_path),
                                  f.read())

    def download_file(self, key: str, local_path: str) -> str:
        data = self.get_bytes(key)
        parent = os.path.dirname(local_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(local_path, "wb") as f:
            f.write(data)
        return local_path

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def delete(self, key: str) -> None:
        path = self._path(key)
        if os.path.exists(path):
            os.unlink(path)

    # ----------------------------------------------------------- listing
    def keys(self, prefix: str = "") -> List[str]:
        """Sorted object keys under a prefix (reference BucketIterator).
        Skips in-flight `.tmp` files — they are unpublished."""
        base = self._path(prefix) if prefix else self.root
        out: List[str] = []
        if not os.path.isdir(base):
            return out
        for dirpath, _dirs, files in os.walk(base):
            for name in files:
                if name.endswith(".tmp"):
                    continue
                full = os.path.join(dirpath, name)
                out.append(os.path.relpath(full, self.root))
        return sorted(out)

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    # ----------------------------------------------------------- datasets
    def put_dataset(self, key: str, ds: DataSet) -> str:
        """Publish a DataSet with the no-pickle npz+JSON codec
        (reference DataSetLoader/S3 dataset staging)."""
        features, labels = to_numpy(ds)
        return self.put_bytes(key, dump_payload(
            {"features": features, "labels": labels}))

    def get_dataset(self, key: str) -> DataSet:
        tree = load_payload(self.get_bytes(key))
        return DataSet(np.asarray(tree["features"]),
                       np.asarray(tree["labels"]))


class StorageDataSetIterator(DataSetIterator):
    """Stream DataSets from a store prefix, one object per batch
    (reference BaseS3DataSetIterator / BaseHdfsDataSetIterator: iterate
    bucket objects, parse each into a DataSet)."""

    def __init__(self, store: ArtifactStore, prefix: str = ""):
        self.store = store
        self.prefix = prefix
        self._keys = store.keys(prefix)
        if not self._keys:
            raise ValueError(
                f"no datasets under prefix {prefix!r} in {store.root_uri}")
        first = store.get_dataset(self._keys[0])
        self._input_columns = int(first.features.shape[-1])
        self._total_outcomes = int(first.labels.shape[-1])
        super().__init__(batch_size=first.num_examples,
                         num_examples=len(self._keys))

    def input_columns(self) -> int:
        return self._input_columns

    def total_outcomes(self) -> int:
        return self._total_outcomes

    def has_next(self) -> bool:
        return self.cursor < len(self._keys)

    def next(self, num: Optional[int] = None) -> DataSet:
        if not self.has_next():
            raise StopIteration
        ds = self.store.get_dataset(self._keys[self.cursor])
        self.cursor += 1
        if self.pre_processor is not None:
            ds = self.pre_processor(ds)
        return ds
