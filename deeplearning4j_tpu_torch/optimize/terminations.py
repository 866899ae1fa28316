"""Termination conditions, the port's copy of the JAX package's
`optimize/terminations.py`: host predicates over Python floats.

Parity: reference core/optimize/terminations/ — `EpsTermination`
(relative score change below eps), `ZeroDirection` (zero gradient
direction), `Norm2Termination` (gradient L2 norm below tolerance),
checked each iteration in BaseOptimizer.optimize
(BaseOptimizer.java:176-186); `DivergenceCondition` is the training
guardian's rollback trigger. The solvers' sync-free loop evaluates the
first three on the device instead (`solvers.BaseOptimizer.
_terminate_on_device`), with the same arithmetic.
"""

from __future__ import annotations

import math


class TerminationCondition:
    def terminate(self, new_score: float, old_score: float,
                  grad_norm: float) -> bool:
        raise NotImplementedError


class EpsTermination(TerminationCondition):
    def __init__(self, eps: float = 1e-4, tolerance: float = 1e-8):
        self.eps = eps
        self.tolerance = tolerance

    def terminate(self, new_score, old_score, grad_norm) -> bool:
        if not (math.isfinite(new_score) and math.isfinite(old_score)):
            return False
        denom = abs(old_score) + abs(new_score) + self.tolerance
        return 2.0 * abs(new_score - old_score) / denom < self.eps


class ZeroDirection(TerminationCondition):
    def terminate(self, new_score, old_score, grad_norm) -> bool:
        return grad_norm == 0.0


class Norm2Termination(TerminationCondition):
    def __init__(self, gradient_tolerance: float = 1e-8):
        self.gradient_tolerance = gradient_tolerance

    def terminate(self, new_score, old_score, grad_norm) -> bool:
        return grad_norm < self.gradient_tolerance


class DivergenceCondition(TerminationCondition):
    """EpsTermination's inverse: fires when the score has blown up.

    `terminate(new_score, best_score, grad_norm)` is True when
    `new_score` is non-finite, or exceeds `best_score` (the best recent
    score the caller tracks) by more than `factor` times its magnitude
    (the |score| + tolerance normalisation of EpsTermination, so a score
    hovering near zero does not trip on noise)."""

    def __init__(self, factor: float = 3.0, tolerance: float = 1e-8):
        if factor <= 0:
            raise ValueError(f"factor must be > 0, got {factor}")
        self.factor = factor
        self.tolerance = tolerance

    def terminate(self, new_score, old_score, grad_norm) -> bool:
        if not math.isfinite(new_score):
            return True
        if not math.isfinite(old_score):
            return False
        return (new_score - old_score) > self.factor * (abs(old_score)
                                                        + self.tolerance)
