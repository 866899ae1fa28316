"""Datasets of the port: the iterator API, MNIST, Iris and the device
feed."""

from deeplearning4j_tpu_torch.datasets.api import (  # noqa: F401
    DataSet,
    DataSetIterator,
    ListDataSetIterator,
    MultipleEpochsIterator,
    ReconstructionDataSetIterator,
    SamplingDataSetIterator,
    TestDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.device_feed import (  # noqa: F401
    DeviceFeed,
    FeedBatch,
    bucket_for,
    feed_mask,
    pad_rows,
    pow2_buckets,
)
from deeplearning4j_tpu_torch.datasets.iris import (  # noqa: F401
    IrisDataSetIterator,
    load_iris,
)
from deeplearning4j_tpu_torch.datasets.mnist import (  # noqa: F401
    MnistDataSetIterator,
    RawMnistDataSetIterator,
    synthetic_mnist,
)
