"""Embedding layer.

Port of ``deeplearning4j_tpu/nn/layers/embedding.py`` (reference
nn/layers/feedforward/embedding/EmbeddingLayer.java): the input is a
column of integer indices [N, 1] (or [N]); the output is the
activation of W[idx] + b. The lookup is an index gather, whose
backward is autograd's scatter-add into W.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers.base import LayerImplBase
from deeplearning4j_tpu_torch.nn.weights import init_weights


class EmbeddingImpl(LayerImplBase):
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
        idx = x.to(torch.int64)
        if idx.ndim == 2:
            idx = idx[:, 0]
        z = params["W"][idx] + params["b"]
        return cls.activation_of(conf)(z), state
