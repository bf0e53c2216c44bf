"""Configuration system: JSON-serializable beans + fluent builders.

Copy of ``deeplearning4j_tpu/nn/conf`` for the torch package. The bean
names, fields and defaults are the JAX package's, so a conf JSON written
by either package parses in the other and re-serializes to the same
string.
"""

from deeplearning4j_tpu_torch.nn.conf.neural_net import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.multi_layer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers
from deeplearning4j_tpu_torch.nn.conf import preprocessors
from deeplearning4j_tpu_torch.nn.conf.enums import (
    BackpropType,
    GradientNormalization,
    OptimizationAlgorithm,
    Updater,
)
