"""Helpers of the port: input validation, and its own copies of the JAX
package's moving-window matrix, image loader (PIL, imported at first
use), archive extraction, embedded HTTP servers (`httpd`), the
crash-safe journal (`statefile`), spawned-process groups (`procs`), the
math helpers (`math_utils`), the spill-to-disk queue (`disk_based_queue`),
the Viterbi decoder (`viterbi`, on a device), pickle-free object
serialization (`serialization`), string tables (`string_grid`) and
DataSet interchange (`interop`)."""

from deeplearning4j_tpu_torch.utils import math_utils  # noqa: F401
from deeplearning4j_tpu_torch.utils.archive import unzip_file_to  # noqa: F401
from deeplearning4j_tpu_torch.utils.disk_based_queue import (  # noqa: F401
    DiskBasedQueue,
)
from deeplearning4j_tpu_torch.utils.image_loader import (  # noqa: F401
    ImageLoader,
)
from deeplearning4j_tpu_torch.utils.moving_window_matrix import (  # noqa: F401
    MovingWindowMatrix,
)
from deeplearning4j_tpu_torch.utils.statefile import StateFile  # noqa: F401
from deeplearning4j_tpu_torch.utils.serialization import (  # noqa: F401
    from_bytes,
    read_object,
    save_object,
    to_bytes,
)
from deeplearning4j_tpu_torch.utils.viterbi import Viterbi  # noqa: F401
