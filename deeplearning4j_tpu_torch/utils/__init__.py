"""Helpers of the port: input validation, and its own copies of the JAX
package's moving-window matrix, image loader (PIL, imported at first
use), archive extraction, embedded HTTP servers (`httpd`), the
crash-safe journal (`statefile`) and spawned-process groups (`procs`)."""

from deeplearning4j_tpu_torch.utils.archive import unzip_file_to  # noqa: F401
from deeplearning4j_tpu_torch.utils.image_loader import (  # noqa: F401
    ImageLoader,
)
from deeplearning4j_tpu_torch.utils.moving_window_matrix import (  # noqa: F401
    MovingWindowMatrix,
)
