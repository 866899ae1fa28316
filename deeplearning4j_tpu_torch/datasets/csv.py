"""CSV dataset iterator.

Parity: reference `CSVDataSetIterator` (core/datasets/fetchers CSV path).
Built on the pluggable record-reader protocol in datasets/records.py
(CSVRecordReader is re-exported from there for back-compat).

The port's own copy of the JAX package's `datasets/csv.py`.
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.datasets.records import (  # noqa: F401
    CSVRecordReader,
    RecordReaderDataSetIterator,
)


class CSVDataSetIterator(RecordReaderDataSetIterator):
    def __init__(self, path: str, batch_size: int, label_index: int = -1,
                 num_classes: Optional[int] = None, delimiter: str = ",",
                 skip_lines: int = 0):
        if label_index is not None and not num_classes:
            raise ValueError(
                "label_index given without num_classes; pass num_classes "
                "for classification or label_index=None for reconstruction")
        super().__init__(CSVRecordReader(path, delimiter, skip_lines),
                         batch_size, label_index=label_index,
                         num_possible_labels=num_classes)
