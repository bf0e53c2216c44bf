"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

A second package beside the JAX one, held against it: the same conf
builders and conf JSON (shape inference included), the same
``[N, C]``, ``[N, C, H, W]`` and ``[N, C, T]`` layouts and param keys,
the same ``model.zip``, the same MNIST data, and the same paged-KV
serving engine. Entry
points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``. Kernels are hand-written CUDA C++ for Hopper under
``csrc/``, built at first use (``cuda_build.py``); each has a plain
PyTorch version beside its wrapper that CPU tensors take.

This package imports neither ``jax`` nor ``deeplearning4j_tpu``.
"""

__version__ = "0.1.0"

from deeplearning4j_tpu_torch.nn.conf.neural_net import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration,
)
# importing the layer registry registers the attention and MoE beans
# with serde
from deeplearning4j_tpu_torch.nn.layers import get_impl  # noqa: F401
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (  # noqa: F401
    ComputationGraphConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph  # noqa: F401
from deeplearning4j_tpu_torch.util.model_serializer import (
    load_numpy_params,
    restore_model,
    write_model,
)
