"""Input preprocessor beans.

Port of the bean half of ``deeplearning4j_tpu/nn/conf/preprocessors.py``:
every bean is registered under the same name with the same fields, so a
conf JSON that carries preprocessors parses and re-serializes unchanged.
Their forward reshapes are not ported yet; a network whose conf uses one
raises when it runs.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from deeplearning4j_tpu_torch.nn.conf.serde import bean_name, register_bean


@dataclasses.dataclass
class InputPreProcessor:
    def pre_process(self, x, rng=None):
        raise NotImplementedError(
            f"input preprocessor {bean_name(self)} is not ported to the "
            "torch package yet")


@register_bean("CnnToFeedForwardPreProcessor")
@dataclasses.dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    input_height: int = 0
    input_width: int = 0
    num_channels: int = 0


@register_bean("FeedForwardToCnnPreProcessor")
@dataclasses.dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    input_height: int = 0
    input_width: int = 0
    num_channels: int = 1


@register_bean("RnnToFeedForwardPreProcessor")
@dataclasses.dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    pass


@register_bean("FeedForwardToRnnPreProcessor")
@dataclasses.dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    minibatch_size: int = 0


@register_bean("CnnToRnnPreProcessor")
@dataclasses.dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    input_height: int = 0
    input_width: int = 0
    num_channels: int = 0
    minibatch_size: int = 0


@register_bean("RnnToCnnPreProcessor")
@dataclasses.dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    input_height: int = 0
    input_width: int = 0
    num_channels: int = 0


@register_bean("ReshapePreProcessor")
@dataclasses.dataclass
class ReshapePreProcessor(InputPreProcessor):
    shape: Sequence[int] = ()


@register_bean("ZeroMeanPrePreProcessor")
@dataclasses.dataclass
class ZeroMeanPrePreProcessor(InputPreProcessor):
    pass


@register_bean("ZeroMeanAndUnitVariancePreProcessor")
@dataclasses.dataclass
class ZeroMeanAndUnitVariancePreProcessor(InputPreProcessor):
    pass


@register_bean("UnitVarianceProcessor")
@dataclasses.dataclass
class UnitVarianceProcessor(InputPreProcessor):
    pass


@register_bean("BinomialSamplingPreProcessor")
@dataclasses.dataclass
class BinomialSamplingPreProcessor(InputPreProcessor):
    pass


@register_bean("ComposableInputPreProcessor")
@dataclasses.dataclass
class ComposableInputPreProcessor(InputPreProcessor):
    components: Sequence[InputPreProcessor] = ()
