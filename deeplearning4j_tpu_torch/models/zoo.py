"""Model zoo: the transformer LM builders.

Port of ``transformer_lm`` and ``transformer_lm_flagship`` from
``deeplearning4j_tpu/models/zoo.py``: the same builders, producing the
same conf JSON.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration, Updater
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.enums import WeightInit
from deeplearning4j_tpu_torch.ops.losses import LossFunction


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
