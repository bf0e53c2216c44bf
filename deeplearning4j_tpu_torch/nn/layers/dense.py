"""Dense + Output layer implementations.

Port of ``deeplearning4j_tpu/nn/layers/dense.py``: ``x @ W + b`` with
W [n_in, n_out], then the activation; the output layer's loss goes
through :func:`deeplearning4j_tpu_torch.ops.losses.loss_fn`.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers.base import (
    LayerImplBase,
    apply_dropconnect,
)
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.losses import loss_fn


class DenseImpl(LayerImplBase):
    @classmethod
    def init(cls, gen, conf, dtype=torch.float32, device="cpu") -> dict:
        lc = conf.layer
        w = init_weights(gen, (lc.n_in, lc.n_out),
                         conf.resolved("weight_init"),
                         conf.resolved("dist"), dtype, device)
        b = torch.full((lc.n_out,), float(conf.resolved("bias_init")),
                       dtype=dtype, device=device)
        return {"W": w, "b": b}

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        x = cls.maybe_dropout(conf, x, train, rng)
        w = params["W"]
        if train and rng is not None and conf.use_drop_connect:
            w = apply_dropconnect(w, cls.dropout_of(conf), rng)
        z = x @ w + params["b"]
        return cls.activation_of(conf)(z), state


class OutputImpl(DenseImpl):
    """Dense layer whose conf carries the loss function; the network's
    loss calls :meth:`loss` on its activations."""

    @classmethod
    def loss(cls, conf, activations, labels, mask=None):
        return loss_fn(conf.layer.loss_function)(activations, labels, mask)
