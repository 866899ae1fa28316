"""Scaleout: the distributed-training contract and runtimes, the
counterpart of the JAX package's `scaleout/`.

Parity: reference deeplearning4j-scaleout — the scaleout API (Job,
WorkerPerformer, JobAggregator, StateTracker, WorkRouter), the Akka
runtime's master/worker heartbeat choreography and the iterative-reduce
variants, all of which implement data-parallel parameter averaging.

The HOST-side control plane: job routing, the worker registry,
heartbeats and eviction, update accumulation, counters, early-stop
state, checkpointing (`checkpoint.py`, the single-file tier), the
in-process runtime (`runtime.py`), the tracker served over TCP
(`rpc.py`), worker processes (`launcher.py`, `worker.py`) and the
elastic supervisor (`supervisor.py`) with its status endpoint
(`status.py`). The compute runs inside each worker's performer, on the
device its conf names (`perform.py`). The artifact plane
(`storage.py`), host provisioning and box creation (`provision.py`,
`boxes.py`), and the distributed NLP performers with the corpus-to-vectors
pipeline (`perform_nlp.py`, `text_pipeline.py`) sit on the same control
plane; the Word2Vec and GloVe performers train on their conf's device.
"""

from deeplearning4j_tpu_torch.scaleout.api import (  # noqa: F401
    CollectionJobIterator,
    DataSetJobIterator,
    HogWildWorkRouter,
    InMemoryUpdateSaver,
    IterativeReduceWorkRouter,
    Job,
    JobAggregator,
    JobIterator,
    LocalFileUpdateSaver,
    LocalWorkRetriever,
    WorkerPerformer,
    WorkRetriever,
    WorkRouter,
)
from deeplearning4j_tpu_torch.scaleout.statetracker import (  # noqa: F401
    InMemoryStateTracker,
)
from deeplearning4j_tpu_torch.scaleout.aggregator import (  # noqa: F401
    ParameterAveragingAggregator,
)
from deeplearning4j_tpu_torch.scaleout.perform import (  # noqa: F401
    NeuralNetWorkPerformer,
)
from deeplearning4j_tpu_torch.scaleout.runtime import (  # noqa: F401
    DistributedRuntime,
)
from deeplearning4j_tpu_torch.scaleout.checkpoint import (  # noqa: F401
    DefaultModelSaver,
    ModelSaver,
    OrbaxModelSaver,
    UriModelSaver,
    dump_payload,
    load_checkpoint,
    load_payload,
    register_namedtuple,
)
from deeplearning4j_tpu_torch.scaleout.registry import (  # noqa: F401
    ConfigRegistry,
)
from deeplearning4j_tpu_torch.scaleout.supervisor import (  # noqa: F401
    SupervisorAbort,
    TrainingSupervisor,
    WorkerSpawner,
)
from deeplearning4j_tpu_torch.scaleout.storage import (  # noqa: F401
    ArtifactStore,
    StorageDataSetIterator,
)
from deeplearning4j_tpu_torch.scaleout.provision import (  # noqa: F401
    ClusterSetup,
    HostProvisioner,
    LocalTransport,
    SshTransport,
)
