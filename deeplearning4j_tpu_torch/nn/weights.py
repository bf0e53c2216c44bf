"""Weight initialization schemes.

Port of ``deeplearning4j_tpu/nn/weights.py``: the same schemes, shapes
and scales, drawn from an explicit ``torch.Generator``. The numbers
differ from ``jax.random``'s for the same seed; a net that must match
the JAX package loads its weights from a model zip instead.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from deeplearning4j_tpu_torch.nn.conf.enums import WeightInit


def _fans(shape: Sequence[int]) -> tuple[int, int]:
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def init_weights(gen: torch.Generator, shape: Sequence[int],
                 scheme: WeightInit, dist=None, dtype=torch.float32,
                 device="cpu") -> torch.Tensor:
    """Draw one weight tensor (reference WeightInitUtil.initWeights).
    ``gen`` must live on ``device``."""
    shape = tuple(int(s) for s in shape)
    fan_in, fan_out = _fans(shape)

    def normal():
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    def uniform(lo, hi):
        u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
        return lo + (hi - lo) * u

    if scheme == WeightInit.ZERO:
        return torch.zeros(shape, dtype=dtype, device=device)
    if scheme == WeightInit.XAVIER:
        return math.sqrt(2.0 / (fan_in + fan_out)) * normal()
    if scheme == WeightInit.RELU:
        return math.sqrt(2.0 / fan_in) * normal()
    if scheme == WeightInit.UNIFORM:
        a = 1.0 / math.sqrt(fan_in)
        return uniform(-a, a)
    if scheme == WeightInit.VI:
        r = math.sqrt(6.0 / (fan_in + fan_out))
        return uniform(-r, r)
    if scheme == WeightInit.SIZE:
        a = 1.0 / math.sqrt(fan_in + fan_out)
        return uniform(-a, a)
    if scheme == WeightInit.NORMALIZED:
        return (uniform(0.0, 1.0) - 0.5) / float(max(fan_in, 1))
    if scheme == WeightInit.DISTRIBUTION:
        if dist is None:
            raise ValueError("WeightInit.DISTRIBUTION requires a distribution")
        return dist.sample(gen, shape, dtype, device)
    raise ValueError(f"Unknown weight init scheme {scheme}")
