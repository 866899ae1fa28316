"""Batch optimizers, the counterpart of the JAX package's
`optimize/solvers.py`.

Parity: reference core/optimize/solvers/ — `BaseOptimizer.optimize` main
loop (BaseOptimizer.java:128-195: gradientAndScore -> termination checks
-> line-search step -> listeners -> re-score), `IterationGradientDescent`,
`GradientAscent` (line-search gradient descent), `ConjugateGradient`
(Polak-Ribiere), `LBFGS` (two-loop recursion), `StochasticHessianFree`
(CG-minimised curvature, StochasticHessianFree.java:87-184).

The optimizers work on the flat parameter vector in the JAX package's
`ravel_pytree` order (`ravel_table`: sorted keys at every level, each
tensor row-major), the order of `MultiLayerNetwork.params()`. A loss is
a function of that vector; gradients come from autograd at a detached
copy of it, and Hessian-free's curvature products from double backward
(`torch.autograd.grad(..., create_graph=True)`), the same product as the
JAX package's jvp of its gradient. Each optimizer's step is a function
of (x, state, *data) that changes nothing in place.

`optimize()` takes one of two paths, chosen as the JAX package chooses:

- the sync-free path, the counterpart of its compiled `make_loop`:
  taken when no listener is attached, every termination is one of
  EpsTermination / ZeroDirection / Norm2Termination, and
  `num_iterations > 1`. A Python loop of `num_iterations` steps that
  reads nothing back to the host: the termination test is a 0-d device
  flag, and once it is set `torch.where` freezes x, the optimizer state
  and the score, so the steps after it are computed and thrown away.
  With `sync=False` the score comes back as a 0-d device tensor.
- the eager path: reads the score back every iteration, calls the
  listeners, and stops at the first termination.

Both paths give the same parameters.

Randomness: a stochastic loss (dropout, CD sampling, corruption) is
built with `seed=` and takes (x, generator, *data). The optimizer owns a
`torch.Generator` on the parameters' device and reseeds it from
(seed, iteration) before every evaluation of the loss, so the gradient
and every line-search or shrink trial of one step draw the same masks,
and each step draws fresh ones: the JAX package's
`fold_in(key, iteration)`, one key a step. The draws cannot equal
jax's. Reseeding sets only the generator's host-side state (seed and
offset), so it needs no host sync; and since a step's draws depend only
on (seed, iteration), both paths of `optimize()` draw the same masks
whether or not they stop early.
"""

from __future__ import annotations

import functools
import logging
from typing import Callable, List, Optional, Sequence

import torch

from deeplearning4j_tpu_torch.optimize.line_search import \
    backtrack_line_search
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
from deeplearning4j_tpu_torch.optimize.terminations import (
    EpsTermination, Norm2Termination, TerminationCondition, ZeroDirection)
from deeplearning4j_tpu_torch.optimize.updater import (GradientUpdater,
                                                       UpdaterState)

log = logging.getLogger(__name__)

_SEED_MASK = (1 << 63) - 1


def ravel_table(tree):
    """(flat, unravel) for a tensor or a nested dict of tensors, in
    `ravel_pytree`'s order: sorted keys at every level, each tensor
    row-major. `flat` is a new tensor (detached) in the leaves' promoted
    dtype; `unravel(v)` gives the same structure as views of `v`, each
    cast back to its leaf's dtype where that differs."""
    leaves, paths = [], []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            leaves.append(node)
            paths.append(path)

    walk(tree, ())
    dtype = functools.reduce(torch.promote_types,
                             [t.dtype for t in leaves])
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in leaves])
    specs = [(p, t.shape, t.numel(), t.dtype) for p, t in zip(paths, leaves)]

    def unravel(v):
        if not isinstance(tree, dict):
            return v.view(tree.shape).to(tree.dtype)
        out, offset = {}, 0
        for path, shape, n, leaf_dtype in specs:
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = v[offset:offset + n].view(shape).to(leaf_dtype)
            offset += n
        return out

    return flat, unravel


def _where(cond, a, b):
    """a where the 0-d bool `cond` is set, else b, over matching tensors,
    dicts and (named) tuples."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    if isinstance(a, dict):
        return {k: _where(cond, a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        items = [_where(cond, p, q) for p, q in zip(a, b)]
        return type(a)(*items) if hasattr(a, "_fields") else tuple(items)
    return a


class BaseOptimizer:
    """Shared loop: iterate the step until `num_iterations` or a
    termination.

    `loss` maps the flat parameter vector (and the `data` given to
    `optimize`) to a 0-d score; when `seed` is given at construction the
    loss is stochastic and takes (x, generator, *data)."""

    #: the terminations the sync-free loop evaluates on the device
    _SYNC_FREE_TERMS = (EpsTermination, ZeroDirection, Norm2Termination)

    def __init__(
        self,
        conf,
        loss: Callable[..., torch.Tensor],
        listeners: Optional[Sequence[IterationListener]] = None,
        terminations: Optional[Sequence[TerminationCondition]] = None,
        model=None,
        seed: Optional[int] = None,
    ):
        self.conf = conf
        self.loss = loss
        self.listeners: List[IterationListener] = list(listeners or [])
        self.terminations = list(
            terminations
            if terminations is not None
            else [EpsTermination(), ZeroDirection()]
        )
        self.model = model
        self.seed = seed
        self._gen: Optional[torch.Generator] = None
        self._step_seed = 0

    # subclasses: (x, state, *data) -> (x, state, score, grad_norm),
    # changing none of their inputs
    def _step(self, x, state, *data):
        raise NotImplementedError

    def init_state(self, x):
        return ()

    # ------------------------------------------------------ evaluations
    def _loss_at(self, x, data):
        """The loss at x, its draws (if stochastic) those of this step."""
        if self._gen is None:
            return self.loss(x, *data)
        self._gen.manual_seed(self._step_seed)
        return self.loss(x, self._gen, *data)

    def _value_and_grad(self, x, data):
        """(score, gradient) at x, both detached."""
        with torch.enable_grad():
            xv = x.detach().requires_grad_(True)
            score = self._loss_at(xv, data)
            (g,) = torch.autograd.grad(score, xv)
        return score.detach(), g

    def _line_search(self, x, data, score, g, d, initial_step):
        return backtrack_line_search(
            lambda xx: self._loss_at(xx, data), x, score, g, d,
            initial_step=initial_step,
            max_iterations=self.conf.num_line_search_iterations)

    # --------------------------------------------------------- the loop
    def _sync_free_eligible(self) -> bool:
        return (not self.listeners
                and all(isinstance(t, self._SYNC_FREE_TERMS)
                        for t in self.terminations))

    def _terminate_on_device(self, new_score, old_score, gnorm):
        """The termination trio as a 0-d device flag: the arithmetic of
        terminations.py on tensors."""
        out = torch.zeros((), dtype=torch.bool, device=new_score.device)
        for t in self.terminations:
            if isinstance(t, EpsTermination):
                finite = torch.isfinite(new_score) & torch.isfinite(old_score)
                denom = old_score.abs() + new_score.abs() + t.tolerance
                out = out | (finite & (2.0 * (new_score - old_score).abs()
                                       / denom < t.eps))
            elif isinstance(t, ZeroDirection):
                out = out | (gnorm == 0.0)
            elif isinstance(t, Norm2Termination):
                out = out | (gnorm < t.gradient_tolerance)
        return out

    def _begin_step(self, base_seed: int, i: int) -> None:
        """Seed step i's draws: every evaluation of the loss in the step
        reseeds the generator with this (the JAX package's
        `fold_in(key, i)`)."""
        self._step_seed = (base_seed * 1_000_003 + i) & _SEED_MASK

    def _run_sync_free(self, x, data, base_seed):
        """`num_iterations` steps with the termination flag on the
        device: the same steps and checks as the eager loop, without
        reading anything back."""
        state = self.init_state(x)
        inf = torch.full((), float("inf"), dtype=torch.float32,
                         device=x.device)
        score, old = inf, inf
        gnorm = torch.zeros((), dtype=torch.float32, device=x.device)
        done = torch.zeros((), dtype=torch.bool, device=x.device)
        for i in range(self.conf.num_iterations):
            self._begin_step(base_seed, i)
            new_x, new_state, new_score, new_gnorm = self._step(
                x, state, *data)
            x = torch.where(done, x, new_x)
            state = _where(done, state, new_state)
            old = torch.where(done, old, score)
            score = torch.where(done, score, new_score.float())
            gnorm = torch.where(done, gnorm, new_gnorm.float())
            done = done | self._terminate_on_device(score, old, gnorm)
        return x, score

    def optimize(self, params, *data, seed: Optional[int] = None,
                 sync: bool = True):
        """Run the loop on `params` (a tensor or a nested dict of
        tensors, left unchanged); returns (new params of the same
        structure, final score). `data` is forwarded to the loss; `seed`
        overrides the construction-time seed (fresh draws per
        mini-batch).

        On the sync-free path (no listeners, device-checkable
        terminations, num_iterations > 1) the score is a float when
        `sync` is True and the 0-d device tensor when it is False; the
        eager path returns a float."""
        x, unravel = ravel_table(params)
        base_seed = seed if seed is not None else (self.seed or 0)
        if self.seed is not None:
            if self._gen is None or self._gen.device != x.device:
                self._gen = torch.Generator(device=x.device)
        if self._sync_free_eligible() and self.conf.num_iterations > 1:
            x, score = self._run_sync_free(x, data, base_seed)
            self._optimization_done()
            return unravel(x), (float(score) if sync else score)
        state = self.init_state(x)
        old_score = float("inf")
        score = None
        for i in range(self.conf.num_iterations):
            self._begin_step(base_seed, i)
            x, state, score_t, gnorm_t = self._step(x, state, *data)
            score, gnorm = float(score_t), float(gnorm_t)
            for listener in self.listeners:
                listener.iteration_done(self.model, i, score)
            if any(t.terminate(score, old_score, gnorm)
                   for t in self.terminations):
                log.debug("Terminated at iteration %d (score=%s)", i, score)
                break
            old_score = score
        self._optimization_done()
        return unravel(x), score

    def _optimization_done(self) -> None:
        for listener in self.listeners:
            done = getattr(listener, "optimization_done", None)
            if done is not None:
                done(self.model)


class IterationGradientDescent(BaseOptimizer):
    """Plain SGD with GradientAdjustment semantics (reference
    IterationGradientDescent + GradientAdjustment.java:66-113), through
    the port's `optimize/updater.py`."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._updater = GradientUpdater(self.conf)

    def init_state(self, x):
        return self._updater.init({"x": x})

    def _step(self, x, state, *data):
        score, g = self._value_and_grad(x, data)
        # data[0] (when present) is the mini-batch: its leading dim is
        # the reference's ÷batchSize denominator (AdaGrad branch)
        bs = (data[0].shape[0] if data and getattr(data[0], "ndim", 0) >= 1
              else 1)
        state = UpdaterState(
            hist={k: h.clone() for k, h in state.hist.items()},
            velocity={k: v.clone() for k, v in state.velocity.items()},
            iteration=state.iteration.clone())
        updates, state = self._updater.update({"x": g}, state, {"x": x}, bs)
        sign = 1.0 if self.conf.minimize else -1.0
        return (x - sign * updates["x"], state, score,
                torch.linalg.vector_norm(g))


class GradientAscent(BaseOptimizer):
    """Line-search steepest descent (reference GradientAscent solver: the
    GRADIENT_DESCENT algorithm — normalised gradient direction +
    backtracking line search)."""

    def _step(self, x, state, *data):
        score, g = self._value_and_grad(x, data)
        gnorm = torch.linalg.vector_norm(g)
        d = -g / (gnorm + 1e-12)
        res = self._line_search(x, data, score, g, d, self.conf.lr)
        return x + res.step * d, state, res.score, gnorm


class ConjugateGradient(BaseOptimizer):
    """Nonlinear CG, Polak-Ribiere+ with a steepest-descent restart
    (reference ConjugateGradient solver)."""

    def init_state(self, x):
        return (torch.zeros_like(x), torch.zeros_like(x),
                torch.ones((), dtype=torch.bool, device=x.device))

    def _step(self, x, state, *data):
        g_prev, d_prev, first = state
        score, g = self._value_and_grad(x, data)
        gnorm = torch.linalg.vector_norm(g)
        denom = torch.dot(g_prev, g_prev)
        zero = g.new_zeros(())
        beta = torch.where(first | (denom < 1e-20), zero, torch.maximum(
            zero, torch.dot(g, g - g_prev) / denom))
        d = -g + beta * d_prev
        # restart with steepest descent when d is not a descent direction
        d = torch.where(torch.dot(g, d) < 0, d, -g)
        dn = d / (torch.linalg.vector_norm(d) + 1e-12)
        res = self._line_search(x, data, score, g, dn, 1.0)
        return (x + res.step * dn, (g, d, torch.zeros_like(first)),
                res.score, gnorm)


class LBFGS(BaseOptimizer):
    """Limited-memory BFGS with the two-loop recursion (reference LBFGS
    solver).

    The history is the JAX package's ring buffer of (s, y) pairs in
    device tensors: a new pair is pushed by `torch.roll` and a write to
    row m - 1 (the newest). The two loops are fixed loops of m with
    `use` masks for the rows the history does not fill yet."""

    def __init__(self, *args, history: int = 10, **kwargs):
        super().__init__(*args, **kwargs)
        self.history = history

    def init_state(self, x):
        m, n = self.history, x.shape[0]
        return (
            x.new_zeros((m, n)),  # S
            x.new_zeros((m, n)),  # Y
            x.new_zeros((m,)),  # rho
            torch.zeros((), dtype=torch.int32, device=x.device),  # count
            x,  # x_prev
            torch.zeros_like(x),  # g_prev
        )

    def _step(self, x, state, *data):
        m = self.history
        S, Y, rho, count, x_prev, g_prev = state
        score, g = self._value_and_grad(x, data)
        gnorm = torch.linalg.vector_norm(g)

        # push (s, y) from the last accepted step
        s = x - x_prev
        y = g - g_prev
        sy = torch.dot(s, y)
        valid = (count > 0) & (sy > 1e-10)
        pushed = [torch.roll(a, -1, 0) for a in (S, Y, rho)]
        pushed[0][-1] = s
        pushed[1][-1] = y
        pushed[2][-1] = 1.0 / sy
        S, Y, rho = (torch.where(valid, p, a)
                     for p, a in zip(pushed, (S, Y, rho)))
        hist_len = torch.clamp(count, max=m)

        # two-loop recursion; the newest pair is row m - 1
        zero = x.new_zeros(())
        q = g
        alphas = [zero] * m
        for i in range(m):
            idx = m - 1 - i
            a = torch.where(i < hist_len, rho[idx] * torch.dot(S[idx], q),
                            zero)
            q = q - a * Y[idx]
            alphas[idx] = a
        alphas = torch.stack(alphas)
        gamma = torch.where(valid, sy / (torch.dot(y, y) + 1e-12),
                            torch.ones_like(sy))
        r = gamma * q
        for i in range(m):
            use = i < hist_len
            # oldest valid -> newest; past the history the index would
            # run beyond m - 1 (masked out, and clamped as jax's gather
            # clamps: a CUDA index out of range is a device-side assert)
            idx = torch.clamp(m - hist_len + i, max=m - 1).long().view(1)
            s_i = S.index_select(0, idx)[0]
            b = torch.where(use, rho.index_select(0, idx)[0]
                            * torch.dot(Y.index_select(0, idx)[0], r), zero)
            r = r + torch.where(use, alphas.index_select(0, idx)[0] - b,
                                zero) * s_i
        d = -r
        d = torch.where(torch.dot(g, d) < 0, d, -g)
        res = self._line_search(x, data, score, g, d, 1.0)
        new_x = x + res.step * d
        # the JAX package counts every step, accepted pair or not
        # (solvers.py:402), so hist_len can include rows never pushed;
        # kept as it is (ROADMAP Queue 3)
        new_count = count + 1
        return new_x, (S, Y, rho, new_count, x, g), res.score, gnorm


class StochasticHessianFree(BaseOptimizer):
    """Hessian-free (truncated-Newton) optimisation (reference
    StochasticHessianFree.java:87-184): CG-minimise the local quadratic
    model with a curvature-vector product and Levenberg-Marquardt
    damping.

    The curvature product is a Hessian-vector product by double
    backward (or a caller-supplied `matvec(x, v)`); CG runs a fixed
    `cg_iterations`, and the backtracking over the CG solution a fixed
    trip of 10 halvings frozen by `torch.where` once the score no longer
    exceeds the start, as the line search is. A loss with a part that is
    differentiable only once (the flash attention's kernels) cannot give
    the product: autograd raises, and MultiLayerNetwork refuses the
    combination before it starts."""

    SHRINK_TRIALS = 10

    def __init__(self, *args, matvec: Optional[Callable] = None,
                 cg_iterations: int = 30, initial_lambda: float = 1.0,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self._user_matvec = matvec
        self.cg_iterations = cg_iterations
        self.initial_lambda = initial_lambda

    def init_state(self, x):
        return torch.full((), self.initial_lambda, dtype=x.dtype,
                          device=x.device)

    def _step(self, x, lam, *data):
        with torch.enable_grad():
            xv = x.detach().requires_grad_(True)
            score = self._loss_at(xv, data)
            (g,) = torch.autograd.grad(score, xv, create_graph=True)

        def hvp(v):
            if self._user_matvec is not None:
                return self._user_matvec(x, v)
            if not g.requires_grad:  # the gradient does not depend on x
                return torch.zeros_like(v)
            (hv,) = torch.autograd.grad(g, xv, grad_outputs=v,
                                        retain_graph=True, allow_unused=True)
            return torch.zeros_like(v) if hv is None else hv

        score = score.detach()
        g0 = g.detach()
        gnorm = torch.linalg.vector_norm(g0)
        zero = x.new_zeros(())

        def Av(v):
            return hvp(v) + lam * v

        # plain CG on A delta = -g (reference conjGradient :87)
        delta = torch.zeros_like(x)
        r = p = -g0
        for _ in range(self.cg_iterations):
            Ap = Av(p)
            pAp = torch.dot(p, Ap)
            rr = torch.dot(r, r)
            alpha = torch.where(pAp > 1e-20, rr / pAp, zero)
            delta = delta + alpha * p
            r_new = r - alpha * Ap
            beta = torch.where(rr > 1e-20, torch.dot(r_new, r_new) / rr, zero)
            r, p = r_new, r_new + beta * p

        # backtrack over the CG solution (reference cgBackTrack :184)
        with torch.no_grad():
            new_score = self._loss_at(x + delta, data)
            scale = torch.ones_like(zero)
            for _ in range(self.SHRINK_TRIALS):
                active = new_score > score
                trial = scale * 0.5
                trial_score = self._loss_at(x + trial * delta, data)
                scale = torch.where(active, trial, scale)
                new_score = torch.where(active, trial_score, new_score)

        # Levenberg-Marquardt damping update via the reduction ratio
        step = scale * delta
        pred = -(torch.dot(g0, step) + 0.5 * torch.dot(step, Av(step)))
        ratio = torch.where(pred > 1e-20, (score - new_score) / pred, zero)
        lam = torch.where(ratio > 0.75, lam * 2.0 / 3.0,
                          torch.where(ratio < 0.25, lam * 1.5, lam))
        improved = new_score < score
        return (torch.where(improved, x + step, x), lam.detach(),
                torch.where(improved, new_score, score), gnorm)
