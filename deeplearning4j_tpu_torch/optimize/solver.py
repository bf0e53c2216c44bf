"""Solver: line-search-based optimizers over the flat parameter vector.

Port of ``deeplearning4j_tpu/optimize/solver.py`` (reference
optimize/Solver.java:42 + solvers/{BaseOptimizer.java:55 (main loop
:163-226), LineGradientDescent, ConjugateGradient (Polak-Ribiere), LBFGS
(m=4 two-loop recursion), StochasticHessianFree, BackTrackLineSearch.java
(Armijo backtracking)}).

The SGD path is not here: it is the networks' train step. These
optimizers run a host loop over one flat vector (``params_flat``, in the
JAX package's ``ravel_pytree`` order), evaluating the loss and its
gradient eagerly through autograd at each probe; each evaluation reads
its score back to the host, as JAX's loop does.

The Hessian-vector product of :class:`StochasticHessianFree` is a double
backward (``torch.autograd.grad`` with ``create_graph``, then the
gradient of ``g . v``; JAX differentiates forward-over-reverse). It
never runs through K1's CUDA kernels: their backward raises under
``create_graph``, naming the cause, as the JAX package raises
("Higher-order AD not supported") for HF through its Pallas flash
kernel. On a net whose attention takes K1 on the card, set
``use_flash=False`` to run HF through dense attention.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.enums import OptimizationAlgorithm
from deeplearning4j_tpu_torch.nn.multilayer import ravel_params, unravel_params
from deeplearning4j_tpu_torch.nn.streaming import tree_map
from deeplearning4j_tpu_torch.optimize.telemetry import (
    batch_counts,
    host_grad_health,
)
from deeplearning4j_tpu_torch.optimize.terminations import DEFAULT_CONDITIONS


def _first_conf(net):
    """The conf holding the solver knobs: confs[0] for MultiLayerNetwork;
    any layer-vertex conf for ComputationGraph (the knobs are global)."""
    confs = getattr(net.conf, "confs", None)
    if confs:
        return confs[0]
    return next(iter(net._layer_vertices.values())).conf


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> of two flat vectors, a 0-dim tensor on their device."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def backtrack_line_search(
    f: Callable[[torch.Tensor], float],
    x: torch.Tensor,
    fx: float,
    grad: torch.Tensor,
    direction: torch.Tensor,
    max_iterations: int = 5,
    initial_step: float = 1.0,
    c1: float = 1e-4,
    rho: float = 0.5,
    minimize: bool = True,
    move=None,
) -> Tuple[float, float]:
    """Armijo backtracking (reference BackTrackLineSearch.java), as in
    the JAX package. Returns (step, f(x + step*direction)).

    ``minimize=False`` is the reference's sufficient-increase branch
    (:257-263) for score-ascent objectives, evaluated as the minimize
    formulas on -f. Quadratic-then-cubic interpolation (:278-303) with
    lambda clamped to [0.1, 0.5] of the previous one, the best step
    kept for the max-iterations exit (:239-245), non-finite jumps scaled
    back (:266-273); ``rho`` is the fallback shrink when interpolation
    degenerates. ``move(x, direction, step)`` is the optimizer's step
    function, so the probes describe the point actually stepped to.
    When nothing improves, the smallest probed step is returned (JAX's
    deliberate deviation from the reference's 0.0: a zero step makes
    EpsTermination read the stalled score as converged)."""
    if move is None:
        move = lambda xx, d, s: xx + s * d  # noqa: E731
    sign = 1.0 if minimize else -1.0

    def phi(s: float) -> float:
        return sign * float(f(move(x, direction, s)))

    delta = move(x, direction, 1.0) - x
    slope = sign * float(_dot(grad, delta))
    phi0 = sign * float(fx)
    step = float(initial_step)
    step_prev = phi_prev = None
    best_step, best_phi = 0.0, phi0
    for _ in range(max_iterations):
        phin = phi(step)
        if not np.isfinite(phin):
            step_prev = phi_prev = None
            step *= 0.2
            continue
        if phin < best_phi:
            best_step, best_phi = step, phin
        if phin <= phi0 + c1 * step * slope:
            return step, sign * phin
        if step_prev is None:
            denom = 2.0 * (phin - phi0 - slope * step)
            tmp = (-slope * step * step / denom
                   if denom != 0.0 else rho * step)
            tmp = min(tmp, 0.5 * step)
        else:
            rhs1 = phin - phi0 - step * slope
            rhs2 = phi_prev - phi0 - step_prev * slope
            a = (rhs1 / step**2 - rhs2 / step_prev**2) / (step - step_prev)
            b = (-step_prev * rhs1 / step**2
                 + step * rhs2 / step_prev**2) / (step - step_prev)
            if a == 0.0:
                tmp = -slope / (2.0 * b) if b != 0.0 else rho * step
            else:
                disc = b * b - 3.0 * a * slope
                if disc < 0.0:
                    tmp = 0.5 * step
                elif b <= 0.0:
                    tmp = (-b + np.sqrt(disc)) / (3.0 * a)
                else:
                    tmp = -slope / (b + np.sqrt(disc))
            tmp = min(tmp, 0.5 * step)
        step_prev, phi_prev = step, phin
        if not np.isfinite(tmp):
            tmp = rho * step
        step = max(tmp, 0.1 * step)
    if best_step > 0.0:
        return best_step, sign * best_phi
    if step_prev is not None:
        return step_prev, sign * phi_prev
    return 0.0, fx


class FlatProblem:
    """A network's loss on one batch as f(flat params): the batch moved
    to the device once, the params tree rebuilt from the flat vector as
    views (:func:`unravel_params`) at each evaluation."""

    def __init__(self, net, ds):
        net.init()
        self._net = net
        if hasattr(net, "_coerce_multi"):
            (self._feats, self._labels, self._masks,
             self._lmasks) = net._coerce_multi(ds)
        else:
            self._feats = net._tensor(ds.features, net._dtype)
            self._labels = net._tensor(ds.labels, net._dtype)
            self._masks = net._tensor(ds.features_mask)
            self._lmasks = net._tensor(ds.labels_mask)
        self._like = net.params
        self.x0 = ravel_params(net.params)

    def _loss(self, flat):
        params = unravel_params(self._like, flat)
        score, _, _ = self._net._loss_fn(
            params, self._net.state, None, self._feats, self._labels,
            self._masks, self._lmasks)
        return score

    def value_and_grad(self, flat):
        x = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            score = self._loss(x)
            (g,) = torch.autograd.grad(score, x)
        return score.detach(), g

    def value(self, flat):
        with torch.no_grad():
            return self._loss(flat)

    def hessian_vector_product(self, flat, v):
        """H(flat) v by a double backward (the reference's R-op,
        MultiLayerNetwork.computeDeltasR :728). Raises when the loss
        runs through K1's CUDA kernels (see the module docstring)."""
        x = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            score = self._loss(x)
            (g,) = torch.autograd.grad(score, x, create_graph=True)
            (hv,) = torch.autograd.grad(g, x, grad_outputs=v)
        return hv.detach()

    def write_back(self, flat) -> None:
        self._net.params = tree_map(torch.clone,
                                    unravel_params(self._like, flat))
        self._net.params_version += 1


class BaseOptimizer:
    """Shared loop (reference BaseOptimizer.optimize :163-226):
    gradientAndScore -> direction -> line search -> step -> listeners ->
    termination."""

    def __init__(self, net, max_iterations: Optional[int] = None,
                 terminations=DEFAULT_CONDITIONS, step_function=None,
                 problem_factory=None):
        from deeplearning4j_tpu_torch.optimize import stepfunctions

        self.net = net
        conf = _first_conf(net)
        self.max_iterations = max_iterations or conf.num_iterations
        self.max_ls_iterations = conf.max_num_line_search_iterations
        self.terminations = list(terminations)
        self.step_function = (
            stepfunctions.from_name(step_function) if step_function
            else stepfunctions.DefaultStepFunction())
        #: an alternate problem with FlatProblem's surface (value,
        #: value_and_grad, hessian_vector_product, write_back, x0)
        self.problem_factory = problem_factory

    def direction(self, x, grad, it: int) -> torch.Tensor:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def optimize(self, ds) -> float:
        from deeplearning4j_tpu_torch.optimize import stepfunctions as SF

        problem = (self.problem_factory(self.net, ds)
                   if self.problem_factory is not None
                   else FlatProblem(self.net, ds))
        self._problem = problem
        x = problem.x0
        self.reset()
        telemetry = getattr(self.net, "train_telemetry", None)
        feats = getattr(ds, "features", None)
        if isinstance(feats, (list, tuple)):
            feats = feats[0] if feats else None
        examples, tokens = batch_counts(feats)
        for it in range(self.max_iterations):
            t_step = time.perf_counter()
            x_prev = x
            score, grad = problem.value_and_grad(x)
            score = float(score)
            direction = self.direction(x, grad, it)
            # the solvers' directions descend; a configured Negative*
            # step function subtracts, so it gets the gradient-oriented
            # direction (reference minObjectiveFunction,
            # BackTrackLineSearch.java:163)
            if isinstance(self.step_function,
                          (SF.NegativeDefaultStepFunction,
                           SF.NegativeGradientStepFunction)):
                direction = -direction
            # constant step functions ignore the step: one probe
            ls_iters = self.max_ls_iterations
            if isinstance(self.step_function,
                          (SF.GradientStepFunction,
                           SF.NegativeGradientStepFunction)):
                ls_iters = 1
            step, new_score = backtrack_line_search(
                problem.value, x, score, grad, direction, ls_iters,
                move=self.step_function.step)
            x = self.step_function.step(x, direction, step)
            self._ls_scores = (score, new_score)
            self._post_step(x, grad, direction, step)
            problem.write_back(x)
            if telemetry is not None:
                telemetry.record_step(
                    dispatch_s=time.perf_counter() - t_step,
                    examples=examples, tokens=tokens,
                    health=functools.partial(
                        host_grad_health, grad, x_prev, x))
            self.net.score_value = new_score
            self.net.iteration += 1
            for listener in self.net.listeners:
                listener.iteration_done(self.net, self.net.iteration)
            if any(t.terminate(new_score, score, direction)
                   for t in self.terminations):
                break
        return float(self.net.score_value)

    def _post_step(self, x, grad, direction, step) -> None:
        pass


class LineGradientDescent(BaseOptimizer):
    """Steepest descent + line search (reference
    solvers/LineGradientDescent.java)."""

    def direction(self, x, grad, it):
        return -grad


class ConjugateGradient(BaseOptimizer):
    """Nonlinear CG with Polak-Ribiere beta (reference
    solvers/ConjugateGradient.java)."""

    def reset(self):
        self._prev_grad = None
        self._prev_dir = None

    def direction(self, x, grad, it):
        if self._prev_grad is None:
            d = -grad
        else:
            y = grad - self._prev_grad
            beta = float(torch.clamp(
                _dot(grad, y) / torch.clamp(
                    _dot(self._prev_grad, self._prev_grad), min=1e-12),
                min=0.0))
            d = -grad + beta * self._prev_dir
            if float(_dot(grad, d)) >= 0.0:
                # not a descent direction: restart with steepest descent
                # (ConjugateGradient.java:69-72)
                d = -grad
        self._prev_grad = grad
        self._prev_dir = d
        return d


class LBFGS(BaseOptimizer):
    """Limited-memory BFGS, m=4 history, two-loop recursion (reference
    solvers/LBFGS.java)."""

    m = 4

    def reset(self):
        self._s: List[torch.Tensor] = []
        self._y: List[torch.Tensor] = []
        self._prev_x = None
        self._prev_grad = None

    def direction(self, x, grad, it):
        if self._prev_x is not None:
            s = x - self._prev_x
            y = grad - self._prev_grad
            if float(_dot(s, y)) > 1e-10:
                self._s.append(s)
                self._y.append(y)
                if len(self._s) > self.m:
                    self._s.pop(0)
                    self._y.pop(0)
        self._prev_x = x
        self._prev_grad = grad
        q = grad
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / float(_dot(y, s))
            a = rho * float(_dot(s, q))
            alphas.append((a, rho, s, y))
            q = q - a * y
        if self._s:
            s, y = self._s[-1], self._y[-1]
            gamma = float(_dot(s, y) / torch.clamp(_dot(y, y), min=1e-12))
            q = gamma * q
        for a, rho, s, y in reversed(alphas):
            b = rho * float(_dot(y, q))
            q = q + (a - b) * s
        return -q


class StochasticHessianFree(BaseOptimizer):
    """Hessian-free (truncated-Newton) optimization: the direction
    solves (H + lambda I) d = -grad by conjugate gradient using only
    Hessian-vector products (reference solvers/StochasticHessianFree
    .java); lambda adapts Levenberg-Marquardt-style on the reduction
    ratio. The product is :meth:`FlatProblem.hessian_vector_product`."""

    def __init__(self, net, max_iterations: Optional[int] = None,
                 terminations=DEFAULT_CONDITIONS, cg_iterations: int = 50,
                 initial_lambda: float = 0.01, problem_factory=None):
        super().__init__(net, max_iterations, terminations,
                         problem_factory=problem_factory)
        self.cg_iterations = cg_iterations
        self.lam = initial_lambda
        self._last_quad = 0.0

    def direction(self, x, grad, it):
        lam = self.lam
        hvp = self._problem.hessian_vector_product

        def av(v):
            return hvp(x, v) + lam * v

        d = torch.zeros_like(x)
        r = -grad
        p = r
        rs = _dot(r, r)
        for _ in range(self.cg_iterations):
            ap = av(p)
            denom = float(_dot(p, ap))
            if denom <= 0:
                # nonpositive curvature: truncated-Newton CG stops;
                # steepest descent if it made no progress
                if float(_dot(d, d)) == 0.0:
                    d = -grad
                break
            alpha = rs / denom
            d = d + alpha * p
            r = r - alpha * ap
            rs_new = _dot(r, r)
            if float(rs_new) < 1e-10:
                break
            p = r + (rs_new / rs) * p
            rs = rs_new
        self._last_quad = float(_dot(grad, d) + 0.5 * _dot(d, av(d)))
        return d

    def _post_step(self, x, grad, direction, step) -> None:
        # Levenberg-Marquardt on the ratio of the actual reduction (the
        # line search's) to the CG quadratic model's (Martens 2010)
        before, after = self._ls_scores
        predicted = self._last_quad
        if predicted >= -1e-12:
            self.lam = min(1e6, self.lam * 1.5)
            return
        rho = (after - before) / predicted
        if rho > 0.75:
            self.lam = max(1e-6, self.lam * (2 / 3))
        elif rho < 0.25:
            self.lam = min(1e6, self.lam * 1.5)


_OPTIMIZERS = {
    OptimizationAlgorithm.LINE_GRADIENT_DESCENT: LineGradientDescent,
    OptimizationAlgorithm.CONJUGATE_GRADIENT: ConjugateGradient,
    OptimizationAlgorithm.LBFGS: LBFGS,
    OptimizationAlgorithm.HESSIAN_FREE: StochasticHessianFree,
}


class Solver:
    """Facade: build the right optimizer from the conf and run it
    (reference optimize/Solver.java:42)."""

    def __init__(self, net):
        self.net = net

    def optimize(self, ds) -> float:
        algo = _first_conf(self.net).optimization_algo
        if algo == OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            fit = getattr(self.net, "_fit_batch", None) or self.net._fit_one
            fit(ds)
            return float(self.net.score_value)
        try:
            cls = _OPTIMIZERS[algo]
        except KeyError:
            raise ValueError(f"Unsupported optimization algorithm {algo}")
        return cls(self.net).optimize(ds)
