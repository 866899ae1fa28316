"""Datasets of the port: the iterator API, the record readers and CSV,
MNIST, Iris, LFW, curves, moving windows, the async iterator and the
device feed — what the JAX package's `datasets/__init__.py` exports."""

from deeplearning4j_tpu_torch.datasets.api import (  # noqa: F401
    DataSet,
    DataSetIterator,
    ListDataSetIterator,
    MultipleEpochsIterator,
    ReconstructionDataSetIterator,
    SamplingDataSetIterator,
    TestDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.async_iterator import (  # noqa: F401
    AsyncDataSetIterator,
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
from deeplearning4j_tpu_torch.datasets.csv import (  # noqa: F401
    CSVDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.records import (  # noqa: F401
    CSVRecordReader,
    ImageRecordReader,
    LineRecordReader,
    ListRecordReader,
    RecordReader,
    RecordReaderDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.lfw import (  # noqa: F401
    LFWDataFetcher,
    LFWDataSetIterator,
    LFWLoader,
    synthetic_lfw,
)
from deeplearning4j_tpu_torch.datasets.curves import (  # noqa: F401
    CurvesDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.moving_window import (  # noqa: F401
    MovingWindowDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.vectorizer import (  # noqa: F401
    ImageVectorizer,
)
