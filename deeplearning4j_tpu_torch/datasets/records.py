"""Pluggable record readers + the record -> DataSet bridge.

Parity: the external Canova library's RecordReader contract and the
reference's bridge iterator (core/datasets/canova/
RecordReaderDataSetIterator.java:1-199 — batchSize/labelIndex/
numPossibleLabels, records as value lists with the label at labelIndex)
plus Canova-style readers: CSV/line/list readers and an image-directory
reader (per-label subdirectories, decoded via utils ImageLoader).

Streaming design: readers yield records one at a time and the bridge
assembles batches on the fly — a reader over a directory of images never
materializes the whole dataset in RAM (the reference's next(num) loop
semantics, without its per-record INDArray churn).

The port's own copy of the JAX package's `datasets/records.py`.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import (DataSet,
                                                   DataSetIterator,
                                                   DataSetPreProcessor)

Record = List[Union[float, str]]


class RecordReader:
    """A stream of records (value lists). Subclasses implement `_iter()`;
    `reset()` restarts the stream."""

    def _iter(self) -> Iterable[Record]:
        raise NotImplementedError

    def __init__(self):
        self._gen = None
        self._pending = None

    def reset(self) -> None:
        self._gen = iter(self._iter())
        self._pending = None

    def has_next(self) -> bool:
        if self._gen is None:
            self.reset()
        if self._pending is None:
            try:
                self._pending = next(self._gen)
            except StopIteration:
                self._pending = None
                return False
        return True

    def next_record(self) -> Record:
        if not self.has_next():
            raise StopIteration
        rec, self._pending = self._pending, None
        return rec

    def peek(self) -> Optional[Record]:
        """First pending record without consuming it (None if exhausted)."""
        return self._pending if self.has_next() else None

    def count(self) -> Optional[int]:
        """Total record count if cheaply known up front, else None.

        Streaming readers return None; composing iterators
        (MultipleEpochs/Reconstruction) need this to size themselves, so
        in-memory readers override it.
        """
        return None

    def records(self) -> Iterable[Record]:
        self.reset()
        while self.has_next():
            yield self.next_record()


class ListRecordReader(RecordReader):
    """In-memory record collection."""

    def __init__(self, records: Sequence[Record]):
        super().__init__()
        self._records = list(records)

    def _iter(self):
        return iter(self._records)

    def count(self) -> int:
        return len(self._records)


class CSVRecordReader(RecordReader):
    """Delimited text file; fields stay strings (the bridge handles
    numeric/label conversion)."""

    def __init__(self, path: str, delimiter: str = ",", skip_lines: int = 0):
        super().__init__()
        self.path = path
        self.delimiter = delimiter
        self.skip_lines = skip_lines

    def _iter(self):
        with open(self.path) as f:
            for i, line in enumerate(f):
                if i < self.skip_lines:
                    continue
                line = line.strip()
                if line:
                    yield line.split(self.delimiter)


class LineRecordReader(RecordReader):
    """One record per line across a list of files (Canova LineRecordReader)."""

    def __init__(self, paths: Sequence[str]):
        super().__init__()
        self.paths = list(paths)

    def _iter(self):
        for path in self.paths:
            with open(path) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if line:
                        yield [line]


class ImageRecordReader(RecordReader):
    """Walks a root directory whose immediate subdirectories are labels
    (the LFW layout); each record is [*pixels, label_name]. Decoding via
    utils ImageLoader (reference ImageRecordReader + LFWLoader.java:104-118
    'each subdir is a person')."""

    def __init__(self, root: str, height: int = 28, width: int = 28,
                 grayscale: bool = True,
                 extensions: Sequence[str] = (".png", ".jpg", ".jpeg",
                                              ".pgm", ".ppm", ".bmp")):
        from deeplearning4j_tpu_torch.utils.image_loader import \
            ImageLoader

        super().__init__()
        self.root = root
        self.loader = ImageLoader(height=height, width=width,
                                  grayscale=grayscale)
        self.extensions = tuple(extensions)
        self.labels = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        if not self.labels:
            raise ValueError(f"No label subdirectories under {root}")

    def _iter(self):
        for label in self.labels:
            folder = os.path.join(self.root, label)
            for name in sorted(os.listdir(folder)):
                if name.lower().endswith(self.extensions):
                    pixels = self.loader.as_row_vector(
                        os.path.join(folder, name))
                    yield list(pixels) + [label]


class RecordReaderDataSetIterator(DataSetIterator):
    """Record stream -> DataSet batches (reference
    RecordReaderDataSetIterator.java:1-199).

    label_index: column holding the label (-1 = last column; None = no
    label, features double as labels for reconstruction training).
    num_possible_labels: one-hot width for classification; None with a
    label_index means regression (label kept as a float column). String
    label values are mapped to indices in first-seen order (or pass
    `labels` for a fixed ordering).
    """

    def __init__(self, reader: RecordReader, batch_size: int = 10,
                 label_index: Optional[int] = -1,
                 num_possible_labels: Optional[int] = None,
                 labels: Optional[Sequence[str]] = None):
        super().__init__(batch_size, -1)
        self.reader = reader
        self.label_index = label_index
        self.num_possible_labels = num_possible_labels
        self.label_map = ({str(v): i for i, v in enumerate(labels)}
                          if labels else {})
        self.pre_processor: Optional[DataSetPreProcessor] = None
        self.reader.reset()
        self._seen = 0
        self._record_width: Optional[int] = None

    # Totals: use the reader's up-front count when it has one (in-memory
    # readers); for true streams fall back to the count seen so far, which
    # only becomes the total after exhaustion — composing iterators that
    # size themselves at construction should load_all() streams first.
    def total_examples(self) -> int:
        n = self.reader.count()
        return self._seen if n is None else n

    def num_examples(self) -> int:
        return self.total_examples()

    def input_columns(self) -> int:
        """Feature width, learned by peeking the first record (the
        reference CSVDataSetIterator knows its column count up front);
        cached so it stays known after the stream is drained."""
        if self._record_width is None:
            rec = self.reader.peek()
            if rec is None:
                raise ValueError(
                    "cannot determine input_columns: stream empty")
            self._record_width = len(rec)
        return self._record_width - (0 if self.label_index is None else 1)

    def total_outcomes(self) -> int:
        if self.num_possible_labels:
            return self.num_possible_labels
        if self.label_index is None:  # reconstruction: labels = features
            return self.input_columns()
        return 1  # regression: single float column

    def reset(self) -> None:
        self.reader.reset()
        self._seen = 0

    def has_next(self) -> bool:
        return self.reader.has_next()

    def _label_value(self, raw) -> float:
        if isinstance(raw, str):
            try:
                return float(raw)
            except ValueError:
                if raw not in self.label_map:
                    if self.label_map and self.num_possible_labels and \
                            len(self.label_map) >= self.num_possible_labels:
                        raise ValueError(
                            f"Unseen label {raw!r} beyond "
                            f"num_possible_labels={self.num_possible_labels}")
                    self.label_map[raw] = len(self.label_map)
                return float(self.label_map[raw])
        return float(raw)

    def next(self, num: Optional[int] = None) -> DataSet:
        n = num or self.batch_size
        feats, labels = [], []
        while len(feats) < n and self.reader.has_next():
            rec = self.reader.next_record()
            if self._record_width is None:
                self._record_width = len(rec)
            if self.label_index is None:
                feats.append([float(v) for v in rec])
                continue
            li = self.label_index if self.label_index >= 0 else len(rec) - 1
            labels.append(self._label_value(rec[li]))
            feats.append([float(v) for i, v in enumerate(rec) if i != li])
        if not feats:
            raise StopIteration
        self._seen += len(feats)
        features = np.asarray(feats, np.float32)
        if self.label_index is None:
            ds = DataSet(features, features)
        elif self.num_possible_labels:
            idx = np.asarray(labels, np.int64)
            if idx.min() < 0 or idx.max() >= self.num_possible_labels:
                raise ValueError(
                    f"Label index out of range [0, "
                    f"{self.num_possible_labels}): {idx.min()}..{idx.max()}")
            one_hot = np.zeros((len(idx), self.num_possible_labels),
                               np.float32)
            one_hot[np.arange(len(idx)), idx] = 1.0
            ds = DataSet(features, one_hot)
        else:  # regression
            ds = DataSet(features,
                         np.asarray(labels, np.float32)[:, None])
        return self.pre_processor(ds) if self.pre_processor else ds

    def load_all(self) -> DataSet:
        """Drain the stream into one DataSet (empty-shaped if no records)."""
        self.reset()
        batches = [ds for ds in self]
        if not batches:
            return DataSet(np.zeros((0, 0), np.float32),
                           np.zeros((0, 0), np.float32))
        return DataSet.merge(batches)
