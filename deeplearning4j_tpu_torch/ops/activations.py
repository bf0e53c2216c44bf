"""Activation registry.

Port of ``deeplearning4j_tpu/ops/activations.py``: the same
reference-compatible string names, each a ``Tensor -> Tensor`` function.
Softmax and logsoftmax reduce over the feature axis 1 ([N, C], [N, C, T]).

``gelu`` is the tanh approximation, as ``jax.nn.gelu`` is by default;
the exact erf form differs from it by about 1e-3.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

FEATURE_AXIS = 1


def _softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=FEATURE_AXIS if x.ndim > 1 else -1)


def _logsoftmax(x: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(x, dim=FEATURE_AXIS if x.ndim > 1 else -1)


def _hard_sigmoid(x):
    # jax.nn.hard_sigmoid: relu6(x + 3) / 6
    return F.relu6(x + 3.0) / 6.0


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "identity": lambda x: x,
    "linear": lambda x: x,
    "sigmoid": torch.sigmoid,
    "hardsigmoid": _hard_sigmoid,
    "tanh": torch.tanh,
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "elu": F.elu,
    "softplus": F.softplus,
    "softsign": F.softsign,
    "cube": lambda x: x * x * x,
    "softmax": _softmax,
    "logsoftmax": _logsoftmax,
    "timesoneminus": lambda x: x * (1.0 - x),
    "exp": torch.exp,
    "sign": torch.sign,
    "abs": torch.abs,
    "sqrt": torch.sqrt,
    "floor": torch.floor,
    "round": torch.round,
    "log": torch.log,
    "negative": torch.neg,
    "stabilize": lambda x: torch.clamp(x, -50.0, 50.0),
}


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Look up an activation by its reference-compatible string name."""
    try:
        return ACTIVATIONS[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown activation {name!r}. Known: {sorted(ACTIVATIONS)}"
        ) from None
