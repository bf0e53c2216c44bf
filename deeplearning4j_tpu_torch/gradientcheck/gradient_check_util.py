"""Central finite-difference gradient checker.

Port of ``deeplearning4j_tpu/gradientcheck/gradient_check_util.py``
(reference gradientcheck/GradientCheckUtil.java:48): perturb each
parameter by +-epsilon and compare the centred difference of the score
with the analytic gradient. The analytic side is autograd of the same
loss, so the check validates the loss, regularization and masking
wiring rather than chain rules. It runs in float64, as the reference
requires: a float64 copy of the params, the layer state and the data,
and the net's loss evaluated on them (the net itself is untouched; a
``compute_dtype`` cast applies as in the JAX package).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.multilayer import (
    ravel_params,
    unravel_params,
)
from deeplearning4j_tpu_torch.nn.streaming import tree_map


def check_gradients(
    net,
    ds,
    epsilon: float = 1e-6,
    max_rel_error: float = 1e-3,
    min_abs_error: float = 1e-8,
    max_params_to_check: Optional[int] = None,
    print_results: bool = False,
    seed: int = 0,
) -> bool:
    """True iff all (sampled) parameters pass the relative-error gate.

    rel_err = |analytic - numeric| / (|analytic| + |numeric|), skipped
    when both magnitudes are below ``min_abs_error``, as the reference's
    GradientCheckUtil gates. With ``max_params_to_check`` the indices are
    ``numpy.random.default_rng(seed).choice`` over the flat vector in the
    JAX package's ``ravel_pytree`` order, so both packages check the same
    parameters from the same seed.
    """
    net.init()

    def f64(a):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.detach().to(torch.float64)
        return a

    params64 = tree_map(f64, net.params)
    state64 = tree_map(f64, net.state)

    def data(a):
        if a is None:
            return None
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=net.device)

    feats, labels = data(ds.features), data(ds.labels)
    fm, lm = data(ds.features_mask), data(ds.labels_mask)
    flat0 = ravel_params(params64)

    def loss(flat):
        score, _, _ = net._loss_fn(unravel_params(params64, flat),
                                   state64, None, feats, labels, fm, lm)
        return score

    x = flat0.clone().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(loss(x), x)
    analytic = g.detach().cpu().numpy()
    base = flat0.detach().cpu().numpy()

    n = base.shape[0]
    if max_params_to_check is not None and max_params_to_check < n:
        rng = np.random.default_rng(seed)
        idxs = rng.choice(n, size=max_params_to_check, replace=False)
    else:
        idxs = np.arange(n)

    n_pass = n_fail = 0
    max_err = 0.0
    with torch.no_grad():
        for i in idxs:
            e = np.zeros_like(base)
            e[i] = epsilon
            s_plus = float(loss(torch.as_tensor(base + e,
                                                device=net.device)))
            s_minus = float(loss(torch.as_tensor(base - e,
                                                 device=net.device)))
            numeric = (s_plus - s_minus) / (2.0 * epsilon)
            a = float(analytic[i])
            denom = abs(a) + abs(numeric)
            if denom < min_abs_error:
                n_pass += 1
                continue
            rel = abs(a - numeric) / denom
            max_err = max(max_err, rel)
            if rel > max_rel_error:
                n_fail += 1
                if print_results:
                    print(f"param[{i}] FAIL rel={rel:.3e} "
                          f"analytic={a:.6e} numeric={numeric:.6e}")
            else:
                n_pass += 1
    if print_results:
        print(f"Gradient check: {n_pass} passed, {n_fail} failed, "
              f"max rel err {max_err:.3e}")
    return n_fail == 0
