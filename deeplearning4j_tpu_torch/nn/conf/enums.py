"""Core configuration enums.

Mirrors of: reference nn/conf/Updater.java, nn/weights/WeightInit.java:37,
nn/api/OptimizationAlgorithm.java:26, nn/conf/BackpropType.java,
nn/conf/GradientNormalization.java, and nn/api/Layer.java ``Type``.
"""

from __future__ import annotations

import enum


class Updater(str, enum.Enum):
    SGD = "sgd"
    ADAM = "adam"
    ADADELTA = "adadelta"
    NESTEROVS = "nesterovs"
    ADAGRAD = "adagrad"
    RMSPROP = "rmsprop"
    NONE = "none"
    CUSTOM = "custom"


class WeightInit(str, enum.Enum):
    DISTRIBUTION = "distribution"
    NORMALIZED = "normalized"
    SIZE = "size"
    UNIFORM = "uniform"
    VI = "vi"
    ZERO = "zero"
    XAVIER = "xavier"
    RELU = "relu"


class OptimizationAlgorithm(str, enum.Enum):
    STOCHASTIC_GRADIENT_DESCENT = "stochastic_gradient_descent"
    LINE_GRADIENT_DESCENT = "line_gradient_descent"
    CONJUGATE_GRADIENT = "conjugate_gradient"
    LBFGS = "lbfgs"
    HESSIAN_FREE = "hessian_free"


class BackpropType(str, enum.Enum):
    STANDARD = "standard"
    TRUNCATED_BPTT = "truncated_bptt"


class GradientNormalization(str, enum.Enum):
    NONE = "none"
    RENORMALIZE_L2_PER_LAYER = "renormalize_l2_per_layer"
    RENORMALIZE_L2_PER_PARAM_TYPE = "renormalize_l2_per_param_type"
    CLIP_ELEMENT_WISE_ABSOLUTE_VALUE = "clip_element_wise_absolute_value"
    CLIP_L2_PER_LAYER = "clip_l2_per_layer"
    CLIP_L2_PER_PARAM_TYPE = "clip_l2_per_param_type"


class LayerType(str, enum.Enum):
    """Reference nn/api/Layer.java ``Type`` enum."""

    FEED_FORWARD = "feed_forward"
    RECURRENT = "recurrent"
    CONVOLUTIONAL = "convolutional"
    SUBSAMPLING = "subsampling"
    RECURSIVE = "recursive"
    MULTILAYER = "multilayer"
    NORMALIZATION = "normalization"
