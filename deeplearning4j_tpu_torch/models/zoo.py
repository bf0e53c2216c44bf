"""Model zoo: the MLP, LeNet-5 and transformer LM builders.

Port of ``mlp``, ``lenet5``, ``transformer_lm`` and
``transformer_lm_flagship`` from ``deeplearning4j_tpu/models/zoo.py``:
the same builders, producing the same conf JSON.
"""

from __future__ import annotations

from typing import Sequence

from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration, Updater
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.enums import WeightInit
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.ops.losses import LossFunction


def mlp(
    sizes: Sequence[int] = (784, 500, 10),
    activation: str = "relu",
    lr: float = 0.1,
    seed: int = 12345,
    updater: Updater = Updater.NESTEROVS,
):
    """MLP 784-500-10 on MNIST: dense layers and a softmax output."""
    b = (
        NeuralNetConfiguration.Builder()
        .seed(seed)
        .learning_rate(lr)
        .updater(updater)
        .momentum(0.9)
        .weight_init(WeightInit.XAVIER)
        .list()
    )
    for i in range(len(sizes) - 2):
        b.layer(
            i,
            L.DenseLayer(
                n_in=sizes[i], n_out=sizes[i + 1], activation=activation
            ),
        )
    b.layer(
        len(sizes) - 2,
        L.OutputLayer(
            n_in=sizes[-2], n_out=sizes[-1], activation="softmax",
            loss_function=LossFunction.MCXENT,
        ),
    )
    return b.build()


def lenet5(
    height: int = 28,
    width: int = 28,
    channels: int = 1,
    n_classes: int = 10,
    lr: float = 0.05,
    seed: int = 12345,
):
    """LeNet-5-style CNN on MNIST: conv 5x5 (20) - max-pool 2x2 - conv
    5x5 (50) - max-pool 2x2 - dense 500 - softmax, shapes inferred from
    the input type (a ``CnnToFeedForwardPreProcessor`` at layer 4).
    conv1 (one input channel) runs on K3, ``conv_taps``."""
    return (
        NeuralNetConfiguration.Builder()
        .seed(seed)
        .learning_rate(lr)
        .updater(Updater.NESTEROVS)
        .momentum(0.9)
        .weight_init(WeightInit.XAVIER)
        .list()
        .layer(
            0,
            L.ConvolutionLayer(
                n_out=20, kernel_size=(5, 5), stride=(1, 1),
                activation="identity",
            ),
        )
        .layer(
            1,
            L.SubsamplingLayer(
                pooling_type=L.PoolingType.MAX,
                kernel_size=(2, 2), stride=(2, 2),
            ),
        )
        .layer(
            2,
            L.ConvolutionLayer(
                n_out=50, kernel_size=(5, 5), stride=(1, 1),
                activation="identity",
            ),
        )
        .layer(
            3,
            L.SubsamplingLayer(
                pooling_type=L.PoolingType.MAX,
                kernel_size=(2, 2), stride=(2, 2),
            ),
        )
        .layer(4, L.DenseLayer(n_out=500, activation="relu"))
        .layer(
            5,
            L.OutputLayer(
                n_out=n_classes, activation="softmax",
                loss_function=LossFunction.MCXENT,
            ),
        )
        .set_input_type(InputType.convolutional(height, width, channels))
        .build()
    )


def transformer_lm(
    n_in: int = 64,
    width: int = 128,
    n_layers: int = 4,
    n_heads: int = 4,
    n_classes: int = 64,
    lr: float = 1e-3,
    seed: int = 12345,
    ring_axis=None,
    remat: bool = False,
):
    """Causal transformer over [N, C, T] sequences: stacked causal
    multi-head self-attention and a softmax output layer. ``remat``
    recomputes each layer's activations in the backward
    (``torch.utils.checkpoint``); ``ring_axis`` is carried in the conf
    (sequence parallelism is not ported yet)."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        MultiHeadSelfAttention,
    )

    b = (
        NeuralNetConfiguration.Builder()
        .seed(seed)
        .learning_rate(lr)
        .updater(Updater.ADAM)
        .activation("identity")
        .weight_init(WeightInit.XAVIER)
        .list()
    )
    for i in range(n_layers):
        b.layer(
            i,
            MultiHeadSelfAttention(
                n_in=n_in if i == 0 else width,
                n_out=width,
                n_heads=n_heads,
                causal=True,
                ring_axis=ring_axis,
            ),
        )
    b.layer(
        n_layers,
        L.RnnOutputLayer(
            n_in=width, n_out=n_classes, activation="softmax",
            loss_function=LossFunction.MCXENT,
        ),
    )
    return b.remat(remat).build()


def transformer_lm_flagship(
    vocab: int = 64,
    width: int = 1024,
    n_layers: int = 8,
    n_heads: int = 16,
    lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 1000,
    seed: int = 12345,
    remat: bool = False,
    ring_axis=None,
):
    """The flagship: a pre-LN TransformerBlock stack (attention + 4x
    FFN + residuals), a final LayerNorm and a softmax output layer, with
    Adam and linear-warmup + cosine lr decay in the conf. ``remat``
    recomputes each layer's activations in the backward."""
    from deeplearning4j_tpu_torch.nn.layers.attention import TransformerBlock

    b = (
        NeuralNetConfiguration.Builder()
        .seed(seed)
        .learning_rate(lr)
        .lr_policy("warmup_cosine")
        .lr_warmup_steps(warmup_steps)
        .lr_total_steps(total_steps)
        .updater(Updater.ADAM)
        .activation("identity")
        .weight_init(WeightInit.XAVIER)
        .list()
    )
    for i in range(n_layers):
        b.layer(
            i,
            TransformerBlock(
                n_in=vocab if i == 0 else width,
                n_out=width,
                n_heads=n_heads,
                causal=True,
                ring_axis=ring_axis,
            ),
        )
    b.layer(n_layers, L.LayerNormalization(n_in=width, n_out=width))
    b.layer(
        n_layers + 1,
        L.RnnOutputLayer(
            n_in=width, n_out=vocab, activation="softmax",
            loss_function=LossFunction.MCXENT,
        ),
    )
    return b.remat(remat).build()
