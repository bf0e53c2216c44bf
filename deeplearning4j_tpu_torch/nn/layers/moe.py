"""Mixture-of-experts dense layer (conf bean + impl).

Port of ``deeplearning4j_tpu/nn/layers/moe.py``: a capacity-factored
top-k MoE FFN block that slots into a stack next to attention layers
(``models/zoo.py:moe_transformer_lm``). The dispatch math is
``parallel/expert_parallel.py``; this layer adapts it to the layer
contract:

- it takes [N, C] or [N, C, T] activations (tokens = N·T, n-major:
  token n·T + t is example n's step t, the order capacity seats them);
- the load-balancing loss leaves through the layer-state channel
  (``{"aux_loss": ...}``) and ``MultiLayerNetwork._aux_score`` adds it
  to the training score weighted by ``aux_weight``;
- ``ep_axis`` names a live mesh axis of the step: this rank's tokens
  and its slice of the experts, exchanged with two all-to-alls
  (``parallel/expert_parallel.py:moe_apply``);
- under ``ParallelTrainer(ep_axis=...)`` (the bean's ``ep_axis``
  unset) the batch is the same on every rank of the ep axis and each
  rank holds ``n_experts / ep`` experts: routing runs over every token
  and each rank runs its own experts
  (``moe_apply_expert_sharded``), as JAX's ep shardings do under GSPMD.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.layers import FeedForwardLayer
from deeplearning4j_tpu_torch.nn.conf.serde import register_bean
from deeplearning4j_tpu_torch.nn.layers.base import LayerImplBase
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.parallel.collectives import current_scope
from deeplearning4j_tpu_torch.parallel.expert_parallel import (
    moe_apply,
    moe_apply_expert_sharded,
)


@register_bean("MoeDense")
@dataclasses.dataclass
class MoeDense(FeedForwardLayer):
    """Conf bean: n_in must equal n_out (the block is residual-shaped:
    route -> expert FFN (n_in -> n_hidden -> n_out) -> combine [+ x])."""

    n_experts: int = 8
    n_hidden: int = 0           # 0 => 4 * n_in
    capacity_factor: float = 1.25
    top_k: int = 1
    aux_weight: float = 0.01    # weight of the load-balancing loss
    residual: bool = True
    ep_axis: Optional[str] = None  # expert-parallel mesh axis


class MoeDenseImpl(LayerImplBase):
    @classmethod
    def init(cls, gen, conf, dtype=torch.float32, device="cpu") -> dict:
        lc = conf.layer
        if lc.n_out and lc.n_out != lc.n_in:
            raise ValueError(
                f"MoeDense needs n_in == n_out, got {lc.n_in}/{lc.n_out}")
        d, e = lc.n_in, lc.n_experts
        h = lc.n_hidden or 4 * d
        scheme = conf.resolved("weight_init")
        dist = conf.resolved("dist")
        return {
            "router": init_weights(gen, (d, e), scheme, dist, dtype, device),
            "W_up": init_weights(gen, (e, d, h), scheme, dist, dtype,
                                 device),
            "W_down": init_weights(gen, (e, h, d), scheme, dist, dtype,
                                   device),
        }

    @classmethod
    def init_state(cls, conf, dtype=torch.float32, device="cpu"):
        # registers the layer in the state tree, so _forward_fn threads
        # the batch's aux loss out to the loss
        return {"aux_loss": torch.zeros((), dtype=dtype, device=device)}

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        lc = conf.layer
        x = cls.maybe_dropout(conf, x, train, rng)
        recurrent = x.ndim == 3  # [N, C, T]
        if recurrent:
            n, c, t = x.shape
            tokens = x.permute(0, 2, 1).reshape(n * t, c)
        else:
            tokens = x
        scope = current_scope()
        if lc.ep_axis is None and scope is not None and scope.ep:
            y, aux = moe_apply_expert_sharded(
                params, tokens, lc.capacity_factor, lc.top_k,
                scope.ep_axis)
        else:
            y, aux = moe_apply(params, tokens,
                               capacity_factor=lc.capacity_factor,
                               top_k=lc.top_k, ep_axis=lc.ep_axis)
        if lc.residual:
            y = y + tokens
        y = cls.activation_of(conf)(y)
        if recurrent:
            y = y.reshape(n, t, c).permute(0, 2, 1)
            if mask is not None:
                y = y * mask[:, None, :]
        return y, {"aux_loss": aux}
