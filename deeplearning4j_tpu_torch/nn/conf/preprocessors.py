"""Input preprocessors: shape adapters between heterogeneous layers.

Port of ``deeplearning4j_tpu/nn/conf/preprocessors.py``: every bean is
registered under the same name with the same fields, so a conf JSON that
carries preprocessors parses and re-serializes unchanged, and each
``pre_process`` is the JAX forward in torch ops (the backward is
autograd's). ``rng`` is a ``torch.Generator`` (training) or None.

Layouts as in the JAX package: feed-forward [N, C]; CNN [N, C, H, W];
RNN [N, C, T].
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from deeplearning4j_tpu_torch.nn.conf.serde import register_bean


@dataclasses.dataclass
class InputPreProcessor:
    def pre_process(self, x, rng=None):
        raise NotImplementedError(
            f"{type(self).__name__} has no pre_process")


@register_bean("CnnToFeedForwardPreProcessor")
@dataclasses.dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    input_height: int = 0
    input_width: int = 0
    num_channels: int = 0

    def pre_process(self, x, rng=None):
        return x.reshape(x.shape[0], -1)


@register_bean("FeedForwardToCnnPreProcessor")
@dataclasses.dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    input_height: int = 0
    input_width: int = 0
    num_channels: int = 1

    def pre_process(self, x, rng=None):
        if x.ndim == 4:
            return x
        return x.reshape(x.shape[0], self.num_channels, self.input_height,
                         self.input_width)


@register_bean("RnnToFeedForwardPreProcessor")
@dataclasses.dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """[N, C, T] -> [N*T, C]."""

    def pre_process(self, x, rng=None):
        return x.permute(0, 2, 1).reshape(-1, x.shape[1])


@register_bean("FeedForwardToRnnPreProcessor")
@dataclasses.dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    minibatch_size: int = 0

    def pre_process(self, x, rng=None):
        n = self.minibatch_size or 1
        t = x.shape[0] // n
        return x.reshape(n, t, x.shape[1]).permute(0, 2, 1)


@register_bean("CnnToRnnPreProcessor")
@dataclasses.dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    input_height: int = 0
    input_width: int = 0
    num_channels: int = 0
    minibatch_size: int = 0

    def pre_process(self, x, rng=None):
        # [N*T, C, H, W] -> [N, C*H*W, T]
        n = self.minibatch_size or 1
        t = x.shape[0] // n
        return x.reshape(n, t, -1).permute(0, 2, 1)


@register_bean("RnnToCnnPreProcessor")
@dataclasses.dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    input_height: int = 0
    input_width: int = 0
    num_channels: int = 0

    def pre_process(self, x, rng=None):
        # [N, C*H*W, T] -> [N*T, C, H, W]
        n, _, t = x.shape
        return x.permute(0, 2, 1).reshape(n * t, self.num_channels,
                                          self.input_height,
                                          self.input_width)


@register_bean("ReshapePreProcessor")
@dataclasses.dataclass
class ReshapePreProcessor(InputPreProcessor):
    shape: Sequence[int] = ()

    def pre_process(self, x, rng=None):
        return x.reshape(tuple(self.shape))


@register_bean("ZeroMeanPrePreProcessor")
@dataclasses.dataclass
class ZeroMeanPrePreProcessor(InputPreProcessor):
    def pre_process(self, x, rng=None):
        return x - x.mean(dim=0, keepdim=True)


@register_bean("ZeroMeanAndUnitVariancePreProcessor")
@dataclasses.dataclass
class ZeroMeanAndUnitVariancePreProcessor(InputPreProcessor):
    def pre_process(self, x, rng=None):
        mu = x.mean(dim=0, keepdim=True)
        sd = x.std(dim=0, keepdim=True, correction=0) + 1e-8
        return (x - mu) / sd


@register_bean("UnitVarianceProcessor")
@dataclasses.dataclass
class UnitVarianceProcessor(InputPreProcessor):
    def pre_process(self, x, rng=None):
        return x / (x.std(dim=0, keepdim=True, correction=0) + 1e-8)


@register_bean("BinomialSamplingPreProcessor")
@dataclasses.dataclass
class BinomialSamplingPreProcessor(InputPreProcessor):
    """Bernoulli-sample the input probabilities (``uniform < x``, so a
    value outside [0, 1] clamps as in ``jax.random.bernoulli``) from the
    generator given; identity when there is none."""

    def pre_process(self, x, rng=None):
        if rng is None:
            return x
        u = torch.rand(x.shape, generator=rng, device=x.device)
        return (u < x).to(x.dtype)


@register_bean("ComposableInputPreProcessor")
@dataclasses.dataclass
class ComposableInputPreProcessor(InputPreProcessor):
    components: Sequence[InputPreProcessor] = ()

    def pre_process(self, x, rng=None):
        for p in self.components:
            x = p.pre_process(x, rng)
        return x
