"""Normalization layers: batch norm, LayerNorm and local response
normalization.

Port of ``deeplearning4j_tpu/nn/layers/normalization.py`` (reference
nn/layers/normalization/BatchNormalization.java and
LocalResponseNormalization.java). Batch-norm running statistics live in
the network's state tree: a train step returns new ones (never written
in place), so a captured ``fit_scan`` step hands them out of the replay
like its params. Moments are population moments (``correction=0``, as
``jnp.var``). LayerNorm takes its moments in at least float32, then
casts the result back to the input's dtype (the bf16 compute path keeps
a stable normalizer).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.layers.base import LayerImplBase


class BatchNormImpl(LayerImplBase):
    @classmethod
    def init(cls, gen, conf, dtype=torch.float32, device="cpu") -> dict:
        lc = conf.layer
        n = lc.n_out or lc.n_in
        return {"gamma": torch.full((n,), float(lc.gamma), dtype=dtype,
                                    device=device),
                "beta": torch.full((n,), float(lc.beta), dtype=dtype,
                                   device=device)}

    @classmethod
    def init_state(cls, conf, dtype=torch.float32, device="cpu"):
        lc = conf.layer
        n = lc.n_out or lc.n_in
        return {"mean": torch.zeros((n,), dtype=dtype, device=device),
                "var": torch.ones((n,), dtype=dtype, device=device)}

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        lc = conf.layer
        # normalize over every axis but the channel axis 1 ([N, C] or
        # [N, C, H, W])
        axes = (0,) if x.ndim == 2 else (0, 2, 3)
        shape = (1, -1) if x.ndim == 2 else (1, -1, 1, 1)
        if train:
            mean = x.mean(dim=axes)
            var = x.var(dim=axes, correction=0)
            decay = lc.decay
            new_state = {
                "mean": decay * state["mean"] + (1 - decay) * mean,
                "var": decay * state["var"] + (1 - decay) * var,
            }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        xhat = (x - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + lc.eps)
        if lc.lock_gamma_beta:
            out = xhat
        else:
            out = (params["gamma"].reshape(shape) * xhat
                   + params["beta"].reshape(shape))
        return out, new_state


def layer_norm(x, g, b, axis: int = -1, eps: float = 1e-5):
    """LayerNorm over ``axis``; shared by LayerNormImpl (axis 1 on
    [N, C, T]) and TransformerBlockImpl (trailing axis on [N, T, C])."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct)
    mu = xf.mean(dim=axis, keepdim=True)
    var = xf.var(dim=axis, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    shape = [1] * x.ndim
    shape[axis] = -1
    return (y * g.to(ct).reshape(shape)
            + b.to(ct).reshape(shape)).to(x.dtype)


class LayerNormImpl(LayerImplBase):
    """Per-example LayerNorm over the channel axis (conf bean
    LayerNormalization); works on [N, C] and [N, C, T]."""

    @classmethod
    def init(cls, gen, conf, dtype=torch.float32, device="cpu") -> dict:
        lc = conf.layer
        n = lc.n_out or lc.n_in
        return {"g": torch.ones(n, dtype=dtype, device=device),
                "b": torch.zeros(n, dtype=dtype, device=device)}

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        y = layer_norm(x, params["g"], params["b"], axis=1,
                       eps=conf.layer.eps)
        return y, None


class LRNImpl(LayerImplBase):
    """Across-channel local response normalization (reference
    LocalResponseNormalization.java) on [N, C, H, W]:
    y = x / (k + alpha * sum_{j in window} x_j^2)^beta, the window
    ``n // 2`` channels either side, zero-padded at the ends."""

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        lc = conf.layer
        half = int(lc.n) // 2
        sq = F.pad(x * x, (0, 0, 0, 0, half, half))
        s = sq.unfold(1, 2 * half + 1, 1).sum(dim=-1)
        return x / torch.pow(lc.k + lc.alpha * s, lc.beta), state
