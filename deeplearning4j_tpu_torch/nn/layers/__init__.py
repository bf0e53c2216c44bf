"""Runtime layer implementations: a registry from conf-bean class to a
stateless impl class (port of ``deeplearning4j_tpu/nn/layers``).

The torch package holds the impls of the transformer path (attention
blocks, LayerNorm, the per-timestep output layer) and of the CNN path
(dense, output, convolution and pooling); any other bean raises
``ValueError`` naming it.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers import (
    attention,
    convolution,
    dense,
    normalization,
    recurrent,
)

_IMPLS = {
    L.DenseLayer: dense.DenseImpl,
    L.OutputLayer: dense.OutputImpl,
    L.ConvolutionLayer: convolution.ConvolutionImpl,
    L.SubsamplingLayer: convolution.SubsamplingImpl,
    L.LayerNormalization: normalization.LayerNormImpl,
    L.RnnOutputLayer: recurrent.RnnOutputImpl,
    attention.MultiHeadSelfAttention: attention.AttentionImpl,
    attention.TransformerBlock: attention.TransformerBlockImpl,
}


def get_impl(layer_bean: L.Layer):
    """conf bean -> runtime impl."""
    try:
        return _IMPLS[type(layer_bean)]
    except KeyError:
        raise ValueError(
            f"No runtime implementation for layer bean "
            f"{type(layer_bean).__name__} in the torch package (it holds "
            f"{sorted(c.__name__ for c in _IMPLS)})") from None
