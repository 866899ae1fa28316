"""Optimisation of the layer network, the counterpart of the JAX
package's `optimize/`: the per-layer gradient updater, the batch
solvers (line search, CG, L-BFGS, Hessian-free) behind `Solver`, the
termination conditions and the iteration listeners. The guardian
(`optimize/guardian.py`) is not ported yet (ROADMAP Queue 1 item 5b)."""

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
