"""Backtracking line search, the counterpart of the JAX package's
`optimize/line_search.py`.

Parity: reference core/optimize/solvers/BackTrackLineSearch.java:142 —
Armijo-condition backtracking along a search direction with step
halving, used by the GRADIENT_DESCENT / CONJUGATE_GRADIENT / LBFGS
solvers.

The JAX package's search is a `lax.while_loop` that stops at the first
trial the Armijo test accepts. Stopping there would need the host to
read the test's outcome, so this search runs a fixed trip of
`max_iterations` trials on the device: once a trial is accepted (or the
step falls below STEP_MIN), `torch.where` freezes (step, score, done),
so the chosen step and score equal the JAX package's exactly, and the
trials after it are computed and thrown away. A search therefore costs
`max_iterations` evaluations of the loss, whatever the data, and reads
nothing back to the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

ALF = 1e-4  # Armijo sufficient-decrease constant (reference ALF)
STEP_MIN = 1e-10


class LineSearchResult(NamedTuple):
    step: torch.Tensor  # chosen step size, 0-d (0.0 if no improvement)
    score: torch.Tensor  # score at the accepted point, 0-d


def backtrack_line_search(
    loss_flat: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    score0: torch.Tensor,
    grad0: torch.Tensor,
    direction: torch.Tensor,
    initial_step: float = 1.0,
    max_iterations: int = 5,
    max_step: float = 100.0,
) -> LineSearchResult:
    """Find a step `a` so that loss(x + a*d) sufficiently decreases;
    x, grad0 and direction are flat vectors, score0 a 0-d tensor.

    `direction` should be a descent direction (slope = <grad0, d> < 0);
    if it is not, the result is step 0 like the reference's slope check.
    `loss_flat` is evaluated under `torch.no_grad()`."""
    dnorm = torch.linalg.vector_norm(direction)
    # Truncate overly long steps (reference: scale direction to maxStep)
    direction = torch.where(dnorm > max_step,
                            direction * (max_step / (dnorm + 1e-12)),
                            direction)
    slope = torch.dot(grad0, direction)
    a = torch.full((), initial_step, dtype=x.dtype, device=x.device)
    score = score0
    done = torch.zeros((), dtype=torch.bool, device=x.device)
    with torch.no_grad():
        for _ in range(max_iterations):
            new_score = loss_flat(x + a * direction)
            ok = (new_score <= score0 + ALF * a * slope) \
                & torch.isfinite(new_score)
            next_a = torch.where(ok, a, a * 0.5)
            new_done = ok | (next_a < STEP_MIN)
            score = torch.where(done, score, torch.where(ok, new_score,
                                                         score0))
            a = torch.where(done, a, next_a)
            done = done | new_done
    # If no trial satisfied Armijo, report zero step.
    ok = done & (slope < 0)
    return LineSearchResult(step=torch.where(ok, a, torch.zeros_like(a)),
                            score=torch.where(ok, score, score0))
