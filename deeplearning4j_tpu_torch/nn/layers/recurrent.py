"""Per-timestep output layer.

Port of ``RnnOutputImpl`` from ``deeplearning4j_tpu/nn/layers/
recurrent.py`` (forward and loss); the LSTM/GRU family belongs to a
later slice.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers.base import LayerImplBase
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.losses import loss_fn


class RnnOutputImpl(LayerImplBase):
    """Per-timestep dense + loss activation over [N, C, T]."""

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
        # [N, C, T] x [C, O] -> [N, O, T]
        ct = torch.promote_types(x.dtype, params["W"].dtype)
        z = (torch.einsum("nct,co->not", x.to(ct), params["W"].to(ct))
             + params["b"][None, :, None])
        out = cls.activation_of(conf)(z)
        if mask is not None:
            out = out * mask[:, None, :]
        return out, state

    @classmethod
    def loss(cls, conf, activations, labels, mask=None):
        return loss_fn(conf.layer.loss_function)(activations, labels, mask)
