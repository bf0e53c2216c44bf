"""Dense + Output layer implementations.

Port of ``deeplearning4j_tpu/nn/layers/dense.py``: ``x @ W + b`` with
W [n_in, n_out], then the activation; the output layer's loss goes
through :func:`deeplearning4j_tpu_torch.ops.losses.loss_fn`.

In a tensor-parallel step a hidden Dense layer holds the shard
``tp_param_specs`` gives it and plays its Megatron role (the step's
``ParallelScope.dense_roles``): a column layer (W's columns, b's
entries) takes Megatron's *f* on its input and gives local columns,
all-gathered when the next layer takes whole activations; a row layer
(W's rows) takes local columns (its own columns of whole activations,
behind *f*) and sums its partial products with *g* before the bias.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers.base import (
    LayerImplBase,
    apply_dropconnect,
)
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.losses import loss_fn
from deeplearning4j_tpu_torch.parallel.collectives import (
    copy_to_group,
    current_scope,
    gather_replicas,
    reduce_from_group,
)


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
        scope = current_scope()
        role = (None if scope is None or scope.tp is None
                else scope.dense_roles.get(id(conf.layer)))
        if role is None:
            z = x @ w + params["b"]
            return cls.activation_of(conf)(z), state
        tp = scope.tp_axis
        group = tp.group
        if role == "row_full":
            # whole activations in: this rank's columns of them
            x = copy_to_group(x, group).chunk(tp.size, 1)[tp.index]
        if role in ("row", "row_full"):
            z = reduce_from_group(x @ w, group) + params["b"]
            return cls.activation_of(conf)(z), state
        z = copy_to_group(x, group) @ w + params["b"]
        if role == "col_gather":
            z = gather_replicas(z, group, 1)
        return cls.activation_of(conf)(z), state


class OutputImpl(DenseImpl):
    """Dense layer whose conf carries the loss function; the network's
    loss calls :meth:`loss` on its activations."""

    @classmethod
    def loss(cls, conf, activations, labels, mask=None):
        return loss_fn(conf.layer.loss_function)(activations, labels, mask)
