"""Shared layer-impl machinery: dropout, dropconnect, activation
resolution.

Port of ``deeplearning4j_tpu/nn/layers/base.py``. Impls are stateless
classes of classmethods over plain ``{name: Tensor}`` parameter dicts,
the same contract as the JAX package:

- ``init(gen, conf, dtype, device) -> params``
- ``init_state(conf, dtype, device) -> state | None``
- ``apply(conf, params, x, state, train, rng, mask) -> (out, state)``
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops.activations import activation as act_fn


def apply_dropout(x: torch.Tensor, rate: float,
                  rng: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout on input activations; ``rate`` is the DROP
    probability. No-op when ``rng`` is None (inference)."""
    if rate <= 0.0 or rng is None:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=rng, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def apply_dropconnect(w: torch.Tensor, rate: float,
                      rng: Optional[torch.Generator]) -> torch.Tensor:
    """DropConnect on a weight matrix: the same inverted Bernoulli mask
    as :func:`apply_dropout`, drawn over the weights."""
    return apply_dropout(w, rate, rng)


class LayerImplBase:
    """Default no-param, identity-state implementation skeleton."""

    @classmethod
    def init(cls, gen, conf, dtype=torch.float32, device="cpu") -> dict:
        return {}

    @classmethod
    def init_state(cls, conf, dtype=torch.float32, device="cpu"):
        return None

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        raise NotImplementedError

    @staticmethod
    def activation_of(conf):
        return act_fn(conf.resolved("activation"))

    @staticmethod
    def dropout_of(conf) -> float:
        return float(conf.resolved("dropout") or 0.0)

    @staticmethod
    def maybe_dropout(conf, x, train, rng):
        if train and rng is not None:
            return apply_dropout(x, LayerImplBase.dropout_of(conf), rng)
        return x
