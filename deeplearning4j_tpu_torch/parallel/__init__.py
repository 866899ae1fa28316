"""Parallel training over ranks of a `torch.distributed` job, the
counterpart of the JAX package's `parallel/`: the mesh and its explicit
collectives, the multi-process bootstrap, data parallelism (per-step
all-reduce, epoch-wave averaging, ZeRO-1 sharded update), tensor
parallelism, and the pipeline and expert-parallel primitives."""

from deeplearning4j_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from deeplearning4j_tpu_torch.parallel.data_parallel import (  # noqa: F401
    DataParallelTrainer,
)
from deeplearning4j_tpu_torch.parallel.averaging import (  # noqa: F401
    ParameterAveragingTrainer,
)
from deeplearning4j_tpu_torch.parallel import multihost  # noqa: F401
from deeplearning4j_tpu_torch.parallel.sharded_update import (  # noqa: F401
    ShardedUpdateTrainer,
)
from deeplearning4j_tpu_torch.parallel.tensor_parallel import (  # noqa: F401
    TensorParallelTrainer,
)
from deeplearning4j_tpu_torch.parallel import pipeline  # noqa: F401
from deeplearning4j_tpu_torch.parallel import expert_parallel  # noqa: F401
