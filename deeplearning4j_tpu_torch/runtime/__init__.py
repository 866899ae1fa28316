"""Host-side native runtime of the port (C++ via ctypes): IDX/CSV
decoding and the bounded producer/consumer queue that double-buffers
input batches ahead of the device step. Every entry point has a numpy
fallback for a box without a toolchain; `native_available()` says which
is live."""

from deeplearning4j_tpu_torch.runtime.native_loader import (  # noqa: F401
    BatchQueue,
    library_path,
    native_available,
    read_csv,
    read_idx,
)
