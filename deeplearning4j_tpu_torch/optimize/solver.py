"""Solver facade: pick an optimizer from conf.optimization_algo, the
counterpart of the JAX package's `optimize/solver.py`.

Parity: reference core/optimize/Solver.java:37-60 (`Solver.Builder`, the
algorithm switch in `getOptimizer`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from deeplearning4j_tpu_torch.config.neural_net_configuration import \
    OptimizationAlgorithm
from deeplearning4j_tpu_torch.optimize.solvers import (
    BaseOptimizer, ConjugateGradient, GradientAscent,
    IterationGradientDescent, LBFGS, StochasticHessianFree)

_ALGOS = {
    OptimizationAlgorithm.GRADIENT_DESCENT: GradientAscent,
    OptimizationAlgorithm.ITERATION_GRADIENT_DESCENT: IterationGradientDescent,
    OptimizationAlgorithm.CONJUGATE_GRADIENT: ConjugateGradient,
    OptimizationAlgorithm.LBFGS: LBFGS,
    OptimizationAlgorithm.HESSIAN_FREE: StochasticHessianFree,
}


class Solver:
    def __init__(self, conf, loss: Callable,
                 listeners: Optional[Sequence] = None,
                 terminations: Optional[Sequence] = None, model=None,
                 **optimizer_kwargs):
        self.conf = conf
        self.loss = loss
        self.listeners = listeners
        self.terminations = terminations
        self.model = model
        self.optimizer_kwargs = optimizer_kwargs
        self._optimizer: Optional[BaseOptimizer] = None

    def get_optimizer(self) -> BaseOptimizer:
        """One optimizer per Solver, made at the first call and reused
        for every later optimize() (mini-batch)."""
        if self._optimizer is None:
            algo = self.conf.optimization_algo.lower()
            try:
                cls = _ALGOS[algo]
            except KeyError:
                raise ValueError(
                    f"Unknown optimization algorithm {algo!r}; "
                    f"known: {sorted(_ALGOS)}"
                ) from None
            self._optimizer = cls(
                self.conf, self.loss, listeners=self.listeners,
                terminations=self.terminations, model=self.model,
                **self.optimizer_kwargs)
        return self._optimizer

    def optimize(self, params, *data, seed: Optional[int] = None,
                 sync: bool = True):
        return self.get_optimizer().optimize(params, *data, seed=seed,
                                             sync=sync)
