"""Updater implementations and gradient normalization.

Port of ``deeplearning4j_tpu/nn/updater/updaters.py``: the six rules
(SGD, NONE, NESTEROVS, ADAGRAD, RMSPROP, ADADELTA, ADAM), the
schedules (piecewise-constant maps and the ``warmup_cosine`` lr policy)
and the six gradient-normalization modes, over ``{name: Tensor}`` dicts.

Schedules are host floats computed from the Python iteration count (the
JAX package computes them inside the jitted step from a traced counter;
the values agree to float32 rounding). :meth:`LayerUpdater.step_scalars`
gives the per-step ones a rule reads, so that a captured train step can
take them as device tensors instead of baking in one step's floats.
"""

from __future__ import annotations

import math

import torch

from deeplearning4j_tpu_torch.nn.conf.enums import (
    GradientNormalization,
    Updater,
)


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _tree_zeros(params):
    return _tree_map(torch.zeros_like, params)


class LayerUpdater:
    """One layer's updater: rule + hyperparams resolved from its conf."""

    def __init__(self, rule: Updater, hp: dict):
        self.rule = rule
        self.hp = hp

    def init(self, params):
        if self.rule in (Updater.SGD, Updater.NONE):
            return {}
        if self.rule == Updater.NESTEROVS:
            return {"v": _tree_zeros(params)}
        if self.rule in (Updater.ADAGRAD, Updater.RMSPROP):
            return {"g2": _tree_zeros(params)}
        if self.rule == Updater.ADADELTA:
            return {"g2": _tree_zeros(params), "dx2": _tree_zeros(params)}
        if self.rule == Updater.ADAM:
            return {"m": _tree_zeros(params), "v": _tree_zeros(params)}
        raise ValueError(f"Unsupported updater {self.rule}")

    def step_scalars(self, lr: float, iteration: int) -> dict:
        """The per-step scalars this rule reads, as host floats computed
        exactly as before (float64): ``lr``; NESTEROVS adds ``mu`` and
        ``mu1`` = 1 + mu; ADAM adds ``lr_bias`` = lr times the bias
        correction. ``fit_scan`` uploads a window of them as float32
        tensors, which round to the same float32 values these floats
        take as operands of float32 tensors."""
        sc = {"lr": lr}
        if self.rule == Updater.NESTEROVS:
            mu = _resolve_schedule(self.hp["momentum"],
                                   self.hp.get("momentum_schedule"),
                                   iteration)
            sc.update(mu=mu, mu1=1.0 + mu)
        elif self.rule == Updater.ADAM:
            b1, b2 = self.hp["adam_mean_decay"], self.hp["adam_var_decay"]
            t = iteration + 1
            sc["lr_bias"] = lr * (math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t))
        return sc

    def update(self, grads, state, lr: float, iteration: int):
        """-> (updates, new_state); caller applies ``params -= updates``."""
        return self.apply(grads, state, self.step_scalars(lr, iteration))

    def apply(self, grads, state, sc):
        """The rule with its per-step scalars ``sc`` (see
        :meth:`step_scalars`: host floats, or float32 0-dim device
        tensors, which read nothing back to the host)."""
        hp = self.hp
        lr = sc["lr"]
        if self.rule == Updater.SGD:
            return _tree_map(lambda g: lr * g, grads), state
        if self.rule == Updater.NONE:
            return grads, state
        if self.rule == Updater.NESTEROVS:
            mu, mu1 = sc["mu"], sc["mu1"]
            v_prev = state["v"]
            v_new = _tree_map(lambda v, g: mu * v - lr * g, v_prev, grads)
            # params += -mu*v_prev + (1+mu)*v_new  (Sutskever NAG, as in
            # the reference NesterovsUpdater)
            updates = _tree_map(lambda vp, vn: mu * vp - mu1 * vn,
                                v_prev, v_new)
            return updates, {"v": v_new}
        if self.rule == Updater.ADAGRAD:
            eps = hp["epsilon"]
            g2 = _tree_map(lambda a, g: a + g * g, state["g2"], grads)
            updates = _tree_map(lambda g, a: lr * g / (torch.sqrt(a) + eps),
                                grads, g2)
            return updates, {"g2": g2}
        if self.rule == Updater.RMSPROP:
            d, eps = hp["rms_decay"], hp["epsilon"]
            g2 = _tree_map(lambda a, g: d * a + (1 - d) * g * g,
                           state["g2"], grads)
            updates = _tree_map(lambda g, a: lr * g / torch.sqrt(a + eps),
                                grads, g2)
            return updates, {"g2": g2}
        if self.rule == Updater.ADADELTA:
            rho, eps = hp["rho"], hp["epsilon"]
            g2 = _tree_map(lambda a, g: rho * a + (1 - rho) * g * g,
                           state["g2"], grads)
            dx = _tree_map(
                lambda g, a, d2: g * torch.sqrt(d2 + eps)
                / torch.sqrt(a + eps), grads, g2, state["dx2"])
            dx2 = _tree_map(lambda d2, d: rho * d2 + (1 - rho) * d * d,
                            state["dx2"], dx)
            return dx, {"g2": g2, "dx2": dx2}
        if self.rule == Updater.ADAM:
            b1, b2 = hp["adam_mean_decay"], hp["adam_var_decay"]
            eps = hp["epsilon"]
            lr_bias = sc["lr_bias"]
            m = _tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g,
                          state["m"], grads)
            v = _tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g,
                          state["v"], grads)
            updates = _tree_map(
                lambda m_, v_: lr_bias * m_ / (torch.sqrt(v_) + eps), m, v)
            return updates, {"m": m, "v": v}
        raise ValueError(f"Unsupported updater {self.rule}")


def _resolve_schedule(base: float, sched, iteration: int) -> float:
    """Piecewise-constant schedule lookup (reference ``momentumAfter`` /
    ``learningRateAfter`` map semantics)."""
    val = float(base)
    if not sched:
        return val
    for it_key, v in sorted((int(k), float(v)) for k, v in sched.items()):
        if iteration >= it_key:
            val = v
    return val


def make_layer_updater(conf) -> LayerUpdater:
    """Build a LayerUpdater from a NeuralNetConfiguration, honoring
    layer-over-global hyperparameter overrides."""
    rule = conf.resolved("updater")
    hp = {
        "momentum": float(conf.resolved("momentum")),
        "momentum_schedule": conf.momentum_schedule,
        "rho": float(conf.resolved("rho")),
        "rms_decay": float(conf.resolved("rms_decay")),
        "adam_mean_decay": float(conf.resolved("adam_mean_decay")),
        "adam_var_decay": float(conf.resolved("adam_var_decay")),
        "epsilon": float(conf.epsilon),
    }
    return LayerUpdater(Updater(rule), hp)


def resolve_lr(conf, iteration: int) -> float:
    """Learning rate with an optional integer-keyed schedule or the
    ``warmup_cosine`` lr policy: linear warmup from 0 over
    ``lr_warmup_steps``, then a cosine to ``lr_min_fraction`` * lr at
    ``lr_total_steps`` (so the lr is 0 at iteration 0)."""
    base = float(conf.resolved("learning_rate"))
    policy = getattr(conf, "lr_policy", None)
    if policy:
        if conf.learning_rate_schedule:
            raise ValueError(
                "lr_policy and learning_rate_schedule are mutually "
                "exclusive")
        if policy != "warmup_cosine":
            raise ValueError(
                f"unknown lr_policy {policy!r} (known: 'warmup_cosine')")
        warm = int(conf.lr_warmup_steps)
        total = int(conf.lr_total_steps)
        if total <= warm:
            raise ValueError(
                f"lr_policy='warmup_cosine' needs lr_total_steps "
                f"({total}) > lr_warmup_steps ({warm}) — an unset "
                "horizon would silently train at the min-fraction floor")
        frac = float(conf.lr_min_fraction)
        it = float(iteration)
        ramp = min(it / warm, 1.0) if warm > 0 else 1.0
        prog = min(max((it - warm) / (total - warm), 0.0), 1.0)
        cos = frac + (1.0 - frac) * 0.5 * (1.0 + math.cos(math.pi * prog))
        return base * ramp * cos
    return _resolve_schedule(base, conf.learning_rate_schedule, iteration)


def normalize_gradients(mode: GradientNormalization, grads,
                        threshold: float):
    """Per-layer gradient normalization (reference GradientNormalization)."""
    if mode == GradientNormalization.NONE:
        return grads
    if mode == GradientNormalization.CLIP_ELEMENT_WISE_ABSOLUTE_VALUE:
        return _tree_map(lambda g: torch.clamp(g, -threshold, threshold),
                         grads)
    if mode == GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE:
        return _tree_map(
            lambda g: g / (torch.linalg.vector_norm(g) + 1e-8), grads)
    if mode == GradientNormalization.CLIP_L2_PER_PARAM_TYPE:

        def clip(g):
            n = torch.linalg.vector_norm(g)
            return torch.where(n > threshold, g * (threshold / (n + 1e-8)),
                               g)

        return _tree_map(clip, grads)
    # Whole-layer modes: norm over every parameter in the layer.
    leaves = list(_leaves(grads))
    if not leaves:
        return grads
    total = torch.sqrt(sum((g * g).sum() for g in leaves))
    if mode == GradientNormalization.RENORMALIZE_L2_PER_LAYER:
        return _tree_map(lambda g: g / (total + 1e-8), grads)
    if mode == GradientNormalization.CLIP_L2_PER_LAYER:
        scale = torch.where(total > threshold, threshold / (total + 1e-8),
                            torch.ones_like(total))
        return _tree_map(lambda g: g * scale, grads)
    raise ValueError(f"Unknown gradient normalization {mode}")


def aggregate_updater_states(states: list):
    """Element-wise mean of updater states across workers (reference
    UpdaterAggregator / UpdaterAggregatorCombiner)."""
    n = len(states)
    return _tree_map(lambda *xs: sum(xs) / n, *states)
