"""ComputationGraph configuration: DAG of layer + structural vertices.

Port of ``deeplearning4j_tpu/nn/conf/graph_conf.py`` (reference
nn/conf/ComputationGraphConfiguration.java:56 and the
``NeuralNetConfiguration.Builder.graphBuilder()`` flow): the same vertex
beans under the same registered names and fields, so a graph conf JSON
written by either package parses in the other and re-serializes to the
same string, and the same ``topological_order`` (Kahn over a sorted
ready queue, children appended in ``vertex_inputs`` order), so both
packages walk a graph's vertices in one order.
"""

from __future__ import annotations

import dataclasses
import enum
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


# ----------------------------------------------------------------------
# Vertex beans
# ----------------------------------------------------------------------
@dataclasses.dataclass
class GraphVertex:
    pass


@register_bean("LayerVertex")
@dataclasses.dataclass
class LayerVertex(GraphVertex):
    conf: Optional[NeuralNetConfiguration] = None
    preprocessor: Optional[InputPreProcessor] = None


@register_bean("MergeVertex")
@dataclasses.dataclass
class MergeVertex(GraphVertex):
    """Concatenate inputs along the feature axis (axis 1)."""


class ElementWiseOp(str, enum.Enum):
    ADD = "add"
    SUBTRACT = "subtract"
    PRODUCT = "product"
    AVERAGE = "average"
    MAX = "max"


@register_bean("ElementWiseVertex")
@dataclasses.dataclass
class ElementWiseVertex(GraphVertex):
    op: ElementWiseOp = ElementWiseOp.ADD


@register_bean("SubsetVertex")
@dataclasses.dataclass
class SubsetVertex(GraphVertex):
    """Feature-axis slice [from, to] inclusive (reference SubsetVertex)."""

    from_index: int = 0
    to_index: int = 0


@register_bean("PreprocessorVertex")
@dataclasses.dataclass
class PreprocessorVertex(GraphVertex):
    preprocessor: Optional[InputPreProcessor] = None


@register_bean("LastTimeStepVertex")
@dataclasses.dataclass
class LastTimeStepVertex(GraphVertex):
    """[N, C, T] -> [N, C] at the last (mask-aware) timestep. ``mask_input``
    names the network input whose mask selects the step."""

    mask_input: Optional[str] = None


@register_bean("DuplicateToTimeSeriesVertex")
@dataclasses.dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """[N, C] -> [N, C, T], T taken from the named reference input."""

    reference_input: Optional[str] = None


@register_bean("InputVertexMarker")
@dataclasses.dataclass
class InputVertexMarker(GraphVertex):
    """Marks a network input (reference InputVertex is runtime-only)."""


# ----------------------------------------------------------------------
# Graph configuration
# ----------------------------------------------------------------------
@register_bean("ComputationGraphConfiguration")
@dataclasses.dataclass
class ComputationGraphConfiguration:
    network_inputs: List[str] = dataclasses.field(default_factory=list)
    network_outputs: List[str] = dataclasses.field(default_factory=list)
    vertices: Dict[str, GraphVertex] = dataclasses.field(default_factory=dict)
    vertex_inputs: Dict[str, List[str]] = dataclasses.field(
        default_factory=dict
    )
    backprop: bool = True
    pretrain: bool = False
    backprop_type: BackpropType = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_bwd_length: int = 20

    def to_json(self) -> str:
        return _to_json(self)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        obj = _from_json(s)
        if not isinstance(obj, ComputationGraphConfiguration):
            raise ValueError(
                "JSON does not encode a ComputationGraphConfiguration"
            )
        return obj

    def clone(self) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_json(self.to_json())

    # -- validation + ordering -----------------------------------------
    def topological_order(self) -> List[str]:
        """Kahn topological sort over vertices (reference
        ComputationGraph.topologicalSortOrder :593)."""
        indeg = {name: 0 for name in self.vertices}
        children: Dict[str, List[str]] = {name: [] for name in self.vertices}
        for name, inputs in self.vertex_inputs.items():
            for inp in inputs:
                if inp in self.network_inputs:
                    continue
                if inp not in self.vertices:
                    raise ValueError(
                        f"Vertex {name!r} consumes unknown input {inp!r}"
                    )
                indeg[name] += 1
                children[inp].append(name)
        queue = sorted(n for n, d in indeg.items() if d == 0)
        order: List[str] = []
        while queue:
            n = queue.pop(0)
            order.append(n)
            for ch in children[n]:
                indeg[ch] -= 1
                if indeg[ch] == 0:
                    queue.append(ch)
        if len(order) != len(self.vertices):
            raise ValueError("Graph has a cycle")
        return order

    def validate(self) -> None:
        if not self.network_inputs:
            raise ValueError("Graph has no network inputs")
        if not self.network_outputs:
            raise ValueError("Graph has no network outputs")
        for out in self.network_outputs:
            if out not in self.vertices:
                raise ValueError(f"Unknown network output {out!r}")
        for name in self.vertices:
            if name not in self.vertex_inputs or not self.vertex_inputs[name]:
                raise ValueError(f"Vertex {name!r} has no inputs")
        self.topological_order()


class GraphBuilder:
    """Reference ``ComputationGraphConfiguration.GraphBuilder`` via
    ``NeuralNetConfiguration.Builder().graphBuilder()``."""

    def __init__(self, base: NeuralNetConfiguration):
        self._base = base
        self._conf = ComputationGraphConfiguration()

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._conf.network_inputs.extend(names)
        return self

    def add_layer(
        self,
        name: str,
        layer_bean: L.Layer,
        *inputs: str,
        preprocessor: Optional[InputPreProcessor] = None,
    ) -> "GraphBuilder":
        c = self._base.clone()
        c.layer = layer_bean
        self._conf.vertices[name] = LayerVertex(conf=c, preprocessor=preprocessor)
        self._conf.vertex_inputs[name] = list(inputs)
        return self

    def add_vertex(
        self, name: str, vertex: GraphVertex, *inputs: str
    ) -> "GraphBuilder":
        self._conf.vertices[name] = vertex
        self._conf.vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._conf.network_outputs = list(names)
        return self

    def backprop(self, flag: bool) -> "GraphBuilder":
        self._conf.backprop = flag
        return self

    def pretrain(self, flag: bool) -> "GraphBuilder":
        self._conf.pretrain = flag
        return self

    def backprop_type(self, t: BackpropType) -> "GraphBuilder":
        self._conf.backprop_type = t
        return self

    def t_bptt_forward_length(self, n: int) -> "GraphBuilder":
        self._conf.tbptt_fwd_length = n
        return self

    def t_bptt_backward_length(self, n: int) -> "GraphBuilder":
        self._conf.tbptt_bwd_length = n
        return self

    def build(self) -> ComputationGraphConfiguration:
        self._conf.validate()
        return self._conf
