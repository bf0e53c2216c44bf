"""Loss functions.

Port of ``deeplearning4j_tpu/ops/losses.py``: the ``LossFunction`` enum
(the same wire values, so output-layer beans round-trip through the conf
JSON) and the eleven losses.

Convention (the reference's scoring): each loss returns the *mean
per-example* loss where the per-example loss sums over output units.
Time series of shape [N, C, T] are scored per (example, timestep) with
an optional ``mask`` of shape [N, T].

``loss_fn(name)(activations, labels, mask)`` returns a scalar tensor.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import torch

_EPS = 1e-8


class LossFunction(str, enum.Enum):
    MSE = "mse"
    EXPLL = "expll"
    XENT = "xent"
    MCXENT = "mcxent"
    RMSE_XENT = "rmse_xent"
    SQUARED_LOSS = "squared_loss"
    RECONSTRUCTION_CROSSENTROPY = "reconstruction_crossentropy"
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    COSINE_PROXIMITY = "cosine_proximity"
    L1 = "l1"
    HINGE = "hinge"


def _flatten_time(a: torch.Tensor) -> torch.Tensor:
    """[N, C, T] -> [N*T, C] so losses see a 2-d (example, unit) matrix."""
    if a.ndim == 3:
        return a.permute(0, 2, 1).reshape(-1, a.shape[1])
    return a


def _flatten_mask(mask: Optional[torch.Tensor],
                  n_rows: int) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    return mask.reshape(-1)[:n_rows]


def _reduce(per_example: torch.Tensor,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over (possibly masked) examples of a per-example loss vector."""
    if mask is None:
        return per_example.mean()
    mask = mask.to(per_example.dtype)
    return (per_example * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _make(per_example_fn: Callable):
    def loss(activations, labels, mask=None):
        a = _flatten_time(activations)
        y = _flatten_time(labels)
        m = _flatten_mask(mask, a.shape[0])
        return _reduce(per_example_fn(a, y), m)

    return loss


def _mse(a, y):
    return ((y - a) ** 2).sum(dim=-1) / a.shape[-1]


def _squared(a, y):
    return ((y - a) ** 2).sum(dim=-1)


def _xent(a, y):
    a = torch.clamp(a, _EPS, 1.0 - _EPS)
    return -(y * torch.log(a) + (1.0 - y) * torch.log(1.0 - a)).sum(dim=-1)


def _mcxent(a, y):
    return -(y * torch.log(torch.clamp(a, min=_EPS))).sum(dim=-1)


def _expll(a, y):
    # Poisson-style exponential log likelihood.
    return (a - y * torch.log(torch.clamp(a, min=_EPS))).sum(dim=-1)


def _rmse_xent(a, y):
    return torch.sqrt(_mse(a, y))


def _cosine(a, y):
    an = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + _EPS)
    yn = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + _EPS)
    return -(an * yn).sum(dim=-1)


def _l1(a, y):
    return (y - a).abs().sum(dim=-1)


def _hinge(a, y):
    # labels in {0,1} one-hot -> {-1,+1}
    return torch.clamp(1.0 - (2.0 * y - 1.0) * a, min=0.0).sum(dim=-1)


_LOSSES: dict = {
    LossFunction.MSE: _make(_mse),
    LossFunction.SQUARED_LOSS: _make(_squared),
    LossFunction.XENT: _make(_xent),
    LossFunction.MCXENT: _make(_mcxent),
    LossFunction.NEGATIVELOGLIKELIHOOD: _make(_mcxent),
    LossFunction.RECONSTRUCTION_CROSSENTROPY: _make(_xent),
    LossFunction.EXPLL: _make(_expll),
    LossFunction.RMSE_XENT: _make(_rmse_xent),
    LossFunction.COSINE_PROXIMITY: _make(_cosine),
    LossFunction.L1: _make(_l1),
    LossFunction.HINGE: _make(_hinge),
}


def loss_fn(which) -> Callable[..., torch.Tensor]:
    """Look up ``(activations, labels, mask=None) -> scalar`` by name."""
    if isinstance(which, str):
        which = LossFunction(which.lower())
    return _LOSSES[which]
