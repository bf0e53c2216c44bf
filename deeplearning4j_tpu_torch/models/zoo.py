"""Model zoo: the MLP, LeNet-5, wide CNN, recurrent, transformer,
mixture-of-experts and DBN builders.

Port of ``mlp``, ``lenet5``, ``wide_cnn``, ``image_captioner``,
``lstm_classifier``,
``transformer_lm``, ``transformer_lm_flagship``, ``moe_transformer_lm``
and ``dbn`` from ``deeplearning4j_tpu/models/zoo.py``: the same
builders, producing the same conf JSON.
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


def wide_cnn(
    height: int = 32,
    width: int = 32,
    channels: int = 3,
    n_classes: int = 10,
    lr: float = 0.05,
    seed: int = 12345,
):
    """CIFAR-scale modern-width CNN (64/128-channel 3x3 convs): the
    conv-MFU control experiment — same conv machinery as lenet5 but
    with contraction sizes a matrix unit can fill, demonstrating the
    framework's conv ceiling when the ARCHITECTURE permits. Its convs
    have three or more input channels, so none runs on K3 (which takes
    one-channel images): they are cuDNN's, as JAX computes them with
    ``lax.conv`` outside Pallas."""
    return (
        NeuralNetConfiguration.Builder()
        .seed(seed)
        .learning_rate(lr)
        .updater(Updater.NESTEROVS)
        .momentum(0.9)
        .weight_init(WeightInit.XAVIER)
        .list()
        .layer(0, L.ConvolutionLayer(
            n_out=64, kernel_size=(3, 3), stride=(1, 1),
            padding=(1, 1), activation="relu"))
        .layer(1, L.ConvolutionLayer(
            n_out=64, kernel_size=(3, 3), stride=(1, 1),
            padding=(1, 1), activation="relu"))
        .layer(2, L.SubsamplingLayer(
            pooling_type=L.PoolingType.MAX,
            kernel_size=(2, 2), stride=(2, 2)))
        .layer(3, L.ConvolutionLayer(
            n_out=128, kernel_size=(3, 3), stride=(1, 1),
            padding=(1, 1), activation="relu"))
        .layer(4, L.ConvolutionLayer(
            n_out=128, kernel_size=(3, 3), stride=(1, 1),
            padding=(1, 1), activation="relu"))
        .layer(5, L.SubsamplingLayer(
            pooling_type=L.PoolingType.MAX,
            kernel_size=(2, 2), stride=(2, 2)))
        .layer(6, L.DenseLayer(n_out=256, activation="relu"))
        .layer(7, L.OutputLayer(
            n_out=n_classes, activation="softmax",
            loss_function=LossFunction.MCXENT))
        .set_input_type(InputType.convolutional(height, width, channels))
        .build()
    )


def image_captioner(
    embed_dim: int = 32,
    n_hidden: int = 32,
    vocab: int = 64,
    lr: float = 1e-2,
    seed: int = 12345,
):
    """Karpathy-style captioning stack on ImageLSTM: input [N, embed_dim,
    1+T] whose step 0 is the image embedding and steps 1.. are word
    embeddings; the ImageLSTM decodes the word steps to vocab logits
    [N, vocab, T], which the RnnOutputLayer turns into per-step softmax
    + MCXENT against next-word labels [N, vocab, T]."""
    return (
        NeuralNetConfiguration.Builder()
        .seed(seed)
        .learning_rate(lr)
        .updater(Updater.ADAM)
        .weight_init(WeightInit.XAVIER)
        .list()
        .layer(0, L.ImageLSTM(n_in=embed_dim, n_out=vocab,
                              n_hidden=n_hidden, activation="tanh"))
        .layer(
            1,
            L.RnnOutputLayer(
                n_in=vocab, n_out=vocab, activation="softmax",
                loss_function=LossFunction.MCXENT,
            ),
        )
        .build()
    )


def lstm_classifier(
    n_in: int,
    n_hidden: int,
    n_classes: int,
    lr: float = 0.05,
    seed: int = 12345,
):
    """Sequence classifier: GravesLSTM -> RnnOutputLayer."""
    return (
        NeuralNetConfiguration.Builder()
        .seed(seed)
        .learning_rate(lr)
        .updater(Updater.ADAM)
        .activation("tanh")
        .list()
        .layer(0, L.GravesLSTM(n_in=n_in, n_out=n_hidden))
        .layer(
            1,
            L.RnnOutputLayer(
                n_in=n_hidden, n_out=n_classes, activation="softmax",
                loss_function=LossFunction.MCXENT,
            ),
        )
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


def moe_transformer_lm(
    n_in: int = 64,
    width: int = 128,
    n_blocks: int = 2,
    n_heads: int = 4,
    n_classes: int = 64,
    n_experts: int = 8,
    n_hidden: int = 0,
    capacity_factor: float = 1.25,
    top_k: int = 1,
    lr: float = 1e-3,
    seed: int = 12345,
    ring_axis=None,
    ep_axis=None,
    remat: bool = False,
):
    """Mixture-of-experts transformer: each block is causal multi-head
    self-attention followed by a residual capacity-routed MoE FFN
    (``nn/layers/moe.py``). ``ep_axis`` and ``ring_axis`` are carried in
    the conf (expert and sequence parallelism over a mesh are not ported
    yet)."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        MultiHeadSelfAttention,
    )
    from deeplearning4j_tpu_torch.nn.layers.moe import MoeDense

    b = (
        NeuralNetConfiguration.Builder()
        .seed(seed)
        .learning_rate(lr)
        .updater(Updater.ADAM)
        .activation("identity")
        .weight_init(WeightInit.XAVIER)
        .list()
    )
    li = 0
    for blk in range(n_blocks):
        b.layer(
            li,
            MultiHeadSelfAttention(
                n_in=n_in if blk == 0 else width,
                n_out=width,
                n_heads=n_heads,
                causal=True,
                ring_axis=ring_axis,
            ),
        )
        li += 1
        b.layer(
            li,
            MoeDense(
                n_in=width, n_out=width,
                n_experts=n_experts, n_hidden=n_hidden,
                capacity_factor=capacity_factor, top_k=top_k,
                ep_axis=ep_axis,
            ),
        )
        li += 1
    b.layer(
        li,
        L.RnnOutputLayer(
            n_in=width, n_out=n_classes, activation="softmax",
            loss_function=LossFunction.MCXENT,
        ),
    )
    return b.remat(remat).build()


def dbn(
    sizes: Sequence[int] = (784, 500, 250, 10),
    lr: float = 0.05,
    seed: int = 12345,
    updater: Updater = Updater.SGD,
    momentum: float = 0.9,
):
    """DBN: stacked binary RBMs and a softmax output, pretrain then
    finetune (reference MultiLayerNetwork.pretrain :150). ``momentum``
    takes effect only with ``updater=Updater.NESTEROVS``."""
    b = (
        NeuralNetConfiguration.Builder()
        .seed(seed)
        .learning_rate(lr)
        .updater(updater)
        .momentum(momentum)
        .activation("sigmoid")
        .list()
    )
    for i in range(len(sizes) - 2):
        b.layer(
            i,
            L.RBM(
                n_in=sizes[i], n_out=sizes[i + 1],
                hidden_unit=L.HiddenUnit.BINARY,
                visible_unit=L.VisibleUnit.BINARY,
                loss_function=LossFunction.RECONSTRUCTION_CROSSENTROPY,
            ),
        )
    b.layer(
        len(sizes) - 2,
        L.OutputLayer(
            n_in=sizes[-2], n_out=sizes[-1], activation="softmax",
            loss_function=LossFunction.MCXENT,
        ),
    )
    return b.pretrain(True).backprop(True).build()
