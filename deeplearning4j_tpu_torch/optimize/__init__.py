"""Optimisation of the layer network, the counterpart of the JAX
package's `optimize/`: the per-layer gradient updater, the batch
solvers (line search, CG, L-BFGS, Hessian-free) behind `Solver`, the
termination conditions, the iteration listeners and the training
guardian (`optimize/guardian.py`)."""

from deeplearning4j_tpu_torch.optimize.solver import Solver  # noqa: F401
from deeplearning4j_tpu_torch.optimize.updater import GradientUpdater  # noqa: F401
from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: F401
    IterationListener,
    ScoreIterationListener,
    ComposableIterationListener,
    CollectScoresListener,
    CollectGuardianEvents,
    GuardianListener,
    StepTimeListener,
    ProfilerListener,
)
from deeplearning4j_tpu_torch.optimize.guardian import (  # noqa: F401
    GuardianAbort,
    GuardianPolicy,
    TrainingPreempted,
)
