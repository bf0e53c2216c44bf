"""Weight-init distributions as config beans.

Port of ``deeplearning4j_tpu/nn/conf/distribution.py``: the same bean
names and fields (so the conf JSON parses unchanged), sampled from an
explicit ``torch.Generator`` instead of a ``jax.random`` key. The draws
differ from the JAX package's for the same seed; weights are carried
across with ``util.model_serializer.load_numpy_params``.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.conf.serde import register_bean


@register_bean("NormalDistribution")
@dataclasses.dataclass
class NormalDistribution:
    mean: float = 0.0
    std: float = 1.0

    def sample(self, gen, shape, dtype=torch.float32, device="cpu"):
        x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return self.mean + self.std * x


@register_bean("UniformDistribution")
@dataclasses.dataclass
class UniformDistribution:
    lower: float = -1.0
    upper: float = 1.0

    def sample(self, gen, shape, dtype=torch.float32, device="cpu"):
        u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
        return self.lower + (self.upper - self.lower) * u


@register_bean("BinomialDistribution")
@dataclasses.dataclass
class BinomialDistribution:
    number_of_trials: int = 1
    probability_of_success: float = 0.5

    def sample(self, gen, shape, dtype=torch.float32, device="cpu"):
        u = torch.rand((self.number_of_trials,) + tuple(shape),
                       generator=gen, device=device)
        draws = u < self.probability_of_success
        return draws.sum(dim=0).to(dtype)


Distribution = NormalDistribution | UniformDistribution | BinomialDistribution
