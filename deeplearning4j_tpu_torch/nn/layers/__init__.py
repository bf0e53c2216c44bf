"""Runtime layer implementations: a registry from conf-bean class to a
stateless impl class (port of ``deeplearning4j_tpu/nn/layers``).

Every layer of the JAX package has its impl here: dense and output,
embedding, convolution and pooling, the normalizations (batch, layer,
local response), the recurrent family (GravesLSTM, its bidirectional
form, GRU, ImageLSTM, the per-timestep output layer), the pretrainable
layers (RBM, AutoEncoder, RecursiveAutoEncoder), attention and the
transformer block, and the mixture-of-experts dense layer. Any other
bean raises ``ValueError`` naming the ones it holds.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers import (
    attention,
    convolution,
    dense,
    embedding,
    moe,
    normalization,
    pretrain,
    recurrent,
)

_IMPLS = {
    L.DenseLayer: dense.DenseImpl,
    L.OutputLayer: dense.OutputImpl,
    L.EmbeddingLayer: embedding.EmbeddingImpl,
    L.ConvolutionLayer: convolution.ConvolutionImpl,
    L.SubsamplingLayer: convolution.SubsamplingImpl,
    L.LocalResponseNormalization: normalization.LRNImpl,
    L.LayerNormalization: normalization.LayerNormImpl,
    L.BatchNormalization: normalization.BatchNormImpl,
    L.GravesLSTM: recurrent.LSTMImpl,
    L.ImageLSTM: recurrent.ImageLSTMImpl,
    L.GravesBidirectionalLSTM: recurrent.BiLSTMImpl,
    L.GRU: recurrent.GRUImpl,
    L.RnnOutputLayer: recurrent.RnnOutputImpl,
    L.RBM: pretrain.RBMImpl,
    L.AutoEncoder: pretrain.AutoEncoderImpl,
    L.RecursiveAutoEncoder: pretrain.RecursiveAutoEncoderImpl,
    attention.MultiHeadSelfAttention: attention.AttentionImpl,
    attention.TransformerBlock: attention.TransformerBlockImpl,
    moe.MoeDense: moe.MoeDenseImpl,
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
