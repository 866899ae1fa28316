"""Dataset pipeline: DataSet container + iterator protocol.

Parity: reference core/datasets/iterator/DataSetIterator.java:52 (batch /
totalExamples / inputColumns / totalOutcomes / reset / numExamples), the
`BaseDatasetIterator`/`BaseDataFetcher` pair, `ListDataSetIterator`,
`SamplingDataSetIterator`, `MultipleEpochsIterator` (iterator/
MultipleEpochsIterator.java), `TestDataSetIterator` fixture
(core/datasets/test/TestDataSetIterator.java), and `DataSetPreProcessor`.

Host-side numpy throughout: batches cross to the device once, at fit
time. The port's own copy of the JAX package's `datasets/api.py`.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np


class DataSet(NamedTuple):
    """(features, labels) pair — the reference's ND4J `DataSet`."""

    features: np.ndarray
    labels: np.ndarray

    @property
    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_test_and_train(self, n_train: int):
        return (DataSet(self.features[:n_train], self.labels[:n_train]),
                DataSet(self.features[n_train:], self.labels[n_train:]))

    def shuffle(self, seed: int = 0) -> "DataSet":
        idx = np.random.RandomState(seed).permutation(self.num_examples)
        return DataSet(self.features[idx], self.labels[idx])

    def sample(self, n: int, seed: int = 0) -> "DataSet":
        idx = np.random.RandomState(seed).choice(self.num_examples, n,
                                                 replace=n > self.num_examples)
        return DataSet(self.features[idx], self.labels[idx])

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        return DataSet(np.concatenate([d.features for d in datasets]),
                       np.concatenate([d.labels for d in datasets]))


class DataSetPreProcessor:
    def __call__(self, ds: DataSet) -> DataSet:
        raise NotImplementedError


class DataSetIterator:
    """Iterator over minibatches. Subclasses implement `_fetch(i)` or
    override `__next__`."""

    def __init__(self, batch_size: int, num_examples: int):
        self.batch_size = batch_size
        self._num_examples = num_examples
        self.cursor = 0
        self.pre_processor: Optional[DataSetPreProcessor] = None

    # -- reference DataSetIterator surface ------------------------------
    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return self._num_examples

    def num_examples(self) -> int:
        return self._num_examples

    def input_columns(self) -> int:
        raise NotImplementedError

    def total_outcomes(self) -> int:
        raise NotImplementedError

    def reset(self) -> None:
        self.cursor = 0

    def has_next(self) -> bool:
        return self.cursor < self._num_examples

    def next(self, num: Optional[int] = None) -> DataSet:
        if not self.has_next():
            raise StopIteration
        n = num or self.batch_size
        ds = self._fetch(self.cursor, min(self.cursor + n, self._num_examples))
        self.cursor += n
        if self.pre_processor is not None:
            ds = self.pre_processor(ds)
        return ds

    def _fetch(self, start: int, end: int) -> DataSet:
        raise NotImplementedError

    # -- python iterator protocol ---------------------------------------
    def __iter__(self) -> Iterator[DataSet]:
        return self

    def __next__(self) -> DataSet:
        try:
            return self.next()
        except StopIteration:
            raise


class ListDataSetIterator(DataSetIterator):
    """In-memory iterator over a full DataSet (reference ListDataSetIterator)."""

    def __init__(self, data: DataSet, batch_size: int = 10):
        super().__init__(batch_size, data.num_examples)
        self.data = data

    def input_columns(self) -> int:
        return int(np.prod(self.data.features.shape[1:]))

    def total_outcomes(self) -> int:
        return int(self.data.labels.shape[-1])

    def _fetch(self, start: int, end: int) -> DataSet:
        return DataSet(self.data.features[start:end], self.data.labels[start:end])


class TestDataSetIterator(ListDataSetIterator):
    """Alias fixture (reference core/datasets/test/TestDataSetIterator.java)."""


class SamplingDataSetIterator(DataSetIterator):
    """Draws `total_batches` random-with-replacement batches from a DataSet
    (reference SamplingDataSetIterator)."""

    def __init__(self, data: DataSet, batch_size: int, total_batches: int,
                 seed: int = 0):
        super().__init__(batch_size, batch_size * total_batches)
        self.data = data
        self.total_batches = total_batches
        self._rng = np.random.RandomState(seed)
        self._emitted = 0

    def input_columns(self) -> int:
        return int(np.prod(self.data.features.shape[1:]))

    def total_outcomes(self) -> int:
        return int(self.data.labels.shape[-1])

    def reset(self) -> None:
        super().reset()
        self._emitted = 0

    def has_next(self) -> bool:
        return self._emitted < self.total_batches

    def next(self, num: Optional[int] = None) -> DataSet:
        if not self.has_next():
            raise StopIteration
        self._emitted += 1
        idx = self._rng.choice(self.data.num_examples, num or self.batch_size)
        ds = DataSet(self.data.features[idx], self.data.labels[idx])
        return self.pre_processor(ds) if self.pre_processor else ds


class MultipleEpochsIterator(DataSetIterator):
    """Replays an underlying iterator for N epochs
    (reference iterator/MultipleEpochsIterator.java)."""

    def __init__(self, epochs: int, inner: DataSetIterator):
        super().__init__(inner.batch_size, epochs * inner.num_examples())
        self.epochs = epochs
        self.inner = inner
        self._epoch = 0

    def input_columns(self) -> int:
        return self.inner.input_columns()

    def total_outcomes(self) -> int:
        return self.inner.total_outcomes()

    def reset(self) -> None:
        self._epoch = 0
        self.inner.reset()

    def has_next(self) -> bool:
        return self._epoch < self.epochs - 1 or self.inner.has_next()

    def next(self, num: Optional[int] = None) -> DataSet:
        if not self.inner.has_next():
            if self._epoch >= self.epochs - 1:
                raise StopIteration
            self._epoch += 1
            self.inner.reset()
        return self.inner.next(num)


class ReconstructionDataSetIterator(DataSetIterator):
    """Labels == features, for autoencoder training
    (reference ReconstructionDataSetIterator)."""

    def __init__(self, inner: DataSetIterator):
        super().__init__(inner.batch_size, inner.num_examples())
        self.inner = inner

    def input_columns(self) -> int:
        return self.inner.input_columns()

    def total_outcomes(self) -> int:
        return self.inner.input_columns()

    def reset(self) -> None:
        self.inner.reset()

    def has_next(self) -> bool:
        return self.inner.has_next()

    def next(self, num: Optional[int] = None) -> DataSet:
        ds = self.inner.next(num)
        return DataSet(ds.features, ds.features)
