"""MultiLayerConfiguration + ListBuilder.

Mirror of reference nn/conf/MultiLayerConfiguration.java (345 LoC; toJson :96,
fromJson :110) and the ``NeuralNetConfiguration.Builder.list()`` ->
``ListBuilder`` flow the reference uses to assemble stacked networks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.enums import BackpropType
from deeplearning4j_tpu_torch.nn.conf.neural_net import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.preprocessors import InputPreProcessor
from deeplearning4j_tpu_torch.nn.conf.serde import (
    from_json as _from_json,
    register_bean,
    to_json as _to_json,
)


@register_bean("MultiLayerConfiguration")
@dataclasses.dataclass
class MultiLayerConfiguration:
    confs: List[NeuralNetConfiguration] = dataclasses.field(default_factory=list)
    input_preprocessors: Dict[str, InputPreProcessor] = dataclasses.field(
        default_factory=dict
    )
    backprop: bool = True
    pretrain: bool = False
    backprop_type: BackpropType = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_bwd_length: int = 20
    # Rematerialize per-layer activations in backward: trades recompute
    # FLOPs for device memory on deep stacks / long sequences (training
    # slice; the flag round-trips through the conf JSON).
    remat: bool = False

    def __post_init__(self):
        # JSON object keys are strings; keep them that way internally and
        # expose int-keyed access via preprocessor_for().
        self.input_preprocessors = {
            str(k): v for k, v in self.input_preprocessors.items()
        }

    def conf(self, i: int) -> NeuralNetConfiguration:
        return self.confs[i]

    def preprocessor_for(self, i: int) -> Optional[InputPreProcessor]:
        return self.input_preprocessors.get(str(i))

    @property
    def seed(self) -> int:
        return self.confs[0].seed if self.confs else 12345

    @property
    def dtype(self) -> str:
        return self.confs[0].dtype if self.confs else "float32"

    @property
    def compute_dtype(self):
        return self.confs[0].compute_dtype if self.confs else None

    def to_json(self) -> str:
        return _to_json(self)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        obj = _from_json(s)
        if not isinstance(obj, MultiLayerConfiguration):
            raise ValueError("JSON does not encode a MultiLayerConfiguration")
        return obj

    def clone(self) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_json(self.to_json())


class ListBuilder:
    """Reference ``NeuralNetConfiguration.ListBuilder``: per-index layer
    beans + preprocessors + backprop/pretrain flags."""

    def __init__(self, base: NeuralNetConfiguration):
        self._base = base
        self._layers: Dict[int, L.Layer] = {}
        self._preprocessors: Dict[int, InputPreProcessor] = {}
        self._backprop = True
        self._pretrain = False
        self._backprop_type = BackpropType.STANDARD
        self._tbptt_fwd = 20
        self._tbptt_bwd = 20
        self._remat = False
        self._input_type = None

    def layer(self, index: int, layer_bean: L.Layer) -> "ListBuilder":
        self._layers[index] = layer_bean
        return self

    def input_pre_processor(
        self, index: int, pp: InputPreProcessor
    ) -> "ListBuilder":
        self._preprocessors[index] = pp
        return self

    def backprop(self, flag: bool) -> "ListBuilder":
        self._backprop = flag
        return self

    def pretrain(self, flag: bool) -> "ListBuilder":
        self._pretrain = flag
        return self

    def backprop_type(self, t: BackpropType) -> "ListBuilder":
        self._backprop_type = t
        return self

    def t_bptt_forward_length(self, n: int) -> "ListBuilder":
        self._tbptt_fwd = n
        return self

    def t_bptt_backward_length(self, n: int) -> "ListBuilder":
        self._tbptt_bwd = n
        return self

    def remat(self, flag: bool = True) -> "ListBuilder":
        self._remat = flag
        return self

    def set_input_type(self, input_type) -> "ListBuilder":
        """Enable shape inference + automatic preprocessor insertion
        (``nn/conf/inputs.py:setup_shapes``, run by :meth:`build`)."""
        self._input_type = input_type
        return self

    def cnn_input_size(self, height: int, width: int,
                       channels: int) -> "ListBuilder":
        from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

        return self.set_input_type(
            InputType.convolutional(height, width, channels))

    def build(self) -> MultiLayerConfiguration:
        if not self._layers:
            raise ValueError("No layers configured")
        n = max(self._layers) + 1
        missing = [i for i in range(n) if i not in self._layers]
        if missing:
            raise ValueError(f"Missing layer indices: {missing}")
        confs = []
        for i in range(n):
            c = self._base.clone()
            # Copy the bean so shape inference never mutates caller-owned
            # objects (they may be reused across builders).
            c.layer = dataclasses.replace(self._layers[i])
            confs.append(c)
        conf = MultiLayerConfiguration(
            confs=confs,
            input_preprocessors={str(k): v for k, v in self._preprocessors.items()},
            backprop=self._backprop,
            pretrain=self._pretrain,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_bwd_length=self._tbptt_bwd,
            remat=self._remat,
        )
        if self._input_type is not None:
            from deeplearning4j_tpu_torch.nn.conf.inputs import setup_shapes

            setup_shapes(conf, self._input_type)
        return conf
