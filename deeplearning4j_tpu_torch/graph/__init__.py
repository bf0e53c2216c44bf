from deeplearning4j_tpu_torch.graph.api import Edge, Graph, NoEdgeHandling, Vertex
from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk

__all__ = ["Edge", "Graph", "NoEdgeHandling", "Vertex", "DeepWalk"]
