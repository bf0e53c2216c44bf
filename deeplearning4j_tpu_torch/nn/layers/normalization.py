"""LayerNorm.

Port of ``layer_norm`` and ``LayerNormImpl`` from
``deeplearning4j_tpu/nn/layers/normalization.py``. Moments are taken in
at least float32 with the population variance, then the result is cast
back to the input's dtype (the bf16 compute path keeps a stable
normalizer).
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.layers.base import LayerImplBase


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
