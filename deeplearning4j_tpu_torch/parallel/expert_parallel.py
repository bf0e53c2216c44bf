"""Capacity-factored mixture-of-experts, and expert parallelism.

Port of ``deeplearning4j_tpu/parallel/expert_parallel.py``:
``init_moe_params``, ``expert_capacity``, ``route_top_k``,
``_expert_ffn``, ``moe_apply`` (with ``ep_axis``, the explicit
two-all-to-all schedule), the dense reference ``moe_apply_dense``,
``make_ep_moe`` and ``ep_param_shardings``. Routing builds dispatch and
combine tensors [B, E, C] with C = ceil(capacity_factor · B · k / E);
the dispatch einsum gathers tokens into per-expert buffers [E, C, D],
the expert FFN runs batched over the expert axis, and the combine
einsum returns the weighted results. Tokens past an expert's capacity
are dropped (combine weight zero). Routing is first-come in token
order over the whole batch of a call, so a token's expert seat depends
on what else that forward carries.

The one-hots are comparisons against an ``arange``, masked by ``keep``:
``torch.nn.functional.one_hot`` raises on the -1 positions of tokens
routed elsewhere and checks its range with a device-to-host read, which
a captured CUDA graph (a decode round, a ``fit_scan`` step) cannot
hold. A position at or past the capacity matches no slot, as
``jax.nn.one_hot`` gives a zero row there.

With ``ep_axis`` (a live mesh axis: :func:`make_ep_moe`, or a layer's
``ep_axis`` inside a ``ParallelTrainer`` step) each rank holds its own
tokens and its ``E / n_ep`` experts: after local routing, one
``all_to_all`` sends expert block j's capacity buffers to rank j, the
rank runs its experts, and a second returns the results (GShard's
schedule; capacity is per rank). :func:`moe_apply_expert_sharded` is the
``ParallelTrainer(ep_axis=...)`` route, where every rank of the axis
sees the same tokens (JAX's GSPMD ep shardings): routing over all of
them, each rank's experts on its slice, and the expert outputs
all-gathered.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.parallel.collectives import (
    AxisGroup,
    all_reduce_sum,
    all_to_all,
    copy_to_group,
    current_scope,
    gather_replicas,
)


def init_moe_params(gen: torch.Generator, n_experts: int, d_in: int,
                    d_hidden: int, dtype=torch.float32, device="cpu"):
    """Router [D, E], W_up [E, D, H], W_down [E, H, D] from normals
    scaled by 1/sqrt(fan-in), drawn from ``gen`` (on ``device``)."""
    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    scale = 1.0 / math.sqrt(d_in)
    return {
        "router": scale * normal(d_in, n_experts),
        "W_up": scale * normal(n_experts, d_in, d_hidden),
        "W_down": (1.0 / math.sqrt(d_hidden)) * normal(n_experts, d_hidden,
                                                       d_in),
    }


def expert_capacity(n_tokens: int, n_experts: int, capacity_factor: float,
                    top_k: int = 1) -> int:
    """Per-expert buffer length C: tokens each expert can accept."""
    c = int(math.ceil(capacity_factor * n_tokens * top_k / n_experts))
    return max(1, min(c, n_tokens))


def route_top_k(logits: torch.Tensor, capacity: int, top_k: int = 1,
                normalize_gates: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k capacity routing: logits [B, E] -> (dispatch [B, E, C],
    combine [B, E, C], aux scalar).

    ``dispatch`` is a {0,1} token->slot assignment (each token at most k
    slots, each expert at most C tokens, first-come in batch order);
    ``combine`` is dispatch weighted by the router gate (renormalized
    over the k choices when ``normalize_gates`` and k > 1). Routing runs
    at float32 or wider: the cumsum slot positions are exact integers,
    which bfloat16 cannot hold past 256. ``aux`` is the Switch
    load-balancing loss E · Σ_e f_e·p_e over first-choice fractions."""
    f32 = torch.promote_types(logits.dtype, torch.float32)
    probs = torch.softmax(logits.to(f32), dim=-1)              # [B, E]
    b, e = probs.shape
    experts = torch.arange(e, device=probs.device)
    seats = torch.arange(capacity, device=probs.device, dtype=f32)
    remaining = probs
    counts = torch.zeros((e,), dtype=f32, device=probs.device)
    dispatch = torch.zeros((b, e, capacity), dtype=f32, device=probs.device)
    combine = torch.zeros_like(dispatch)
    gate_total = torch.zeros((b,), dtype=f32, device=probs.device)
    aux = torch.zeros((), dtype=f32, device=probs.device)
    for k in range(top_k):
        expert = torch.argmax(remaining, dim=-1)                # [B]
        oh = (expert[:, None] == experts[None, :]).to(f32)      # [B, E]
        gate = (probs * oh).sum(dim=-1)                         # [B]
        # the slot within the chosen expert, after the seats earlier
        # choice rounds took; rows where oh == 0 give positions that may
        # collide with real slots, so every write is masked by keep
        pos = torch.cumsum(oh, dim=0) - 1.0 + counts[None, :]   # [B, E]
        keep = oh * (pos < capacity).to(f32)
        slot = (pos[..., None] == seats).to(f32) * keep[..., None]
        dispatch = dispatch + slot
        combine = combine + slot * gate[:, None, None]
        gate_total = gate_total + gate
        counts = counts + keep.sum(dim=0)
        if k == 0:
            f = oh.mean(dim=0)
            p = probs.mean(dim=0)
            aux = e * (f * p).sum()
        remaining = remaining * (1.0 - oh)
    if normalize_gates and top_k > 1:
        combine = combine / torch.clamp(gate_total[:, None, None],
                                        min=1e-9)
    return dispatch, combine, aux


def _expert_ffn(xe: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """Batched per-expert FFN on capacity buffers [E, C, D]. Mixed
    dtypes promote, as ``jnp.einsum``'s do (the streaming forward hands
    float32 activations to bfloat16 weights)."""
    ct = torch.promote_types(xe.dtype, w_up.dtype)
    h = torch.relu(torch.einsum("ecd,edh->ech", xe.to(ct), w_up.to(ct)))
    ct = torch.promote_types(h.dtype, w_down.dtype)
    return torch.einsum("ech,ehd->ecd", h.to(ct), w_down.to(ct))


def moe_apply(params, x: torch.Tensor, capacity_factor: float = 1.25,
              top_k: int = 1, ep_axis: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-dispatched MoE: x [B, D] -> (y [B, D], aux scalar).
    The dispatch and combine einsums cost capacity_factor·k·B²·D each,
    the expert FFN capacity_factor·k·B·D·H: neither grows with E.

    With ``ep_axis`` (a live axis name or an :class:`AxisGroup`) x and
    the router are this rank's, W_up/W_down its local expert slice, and
    the dispatch buffers travel by two ``all_to_all``s."""
    axis = _ep_axis(ep_axis)
    b = x.shape[0]
    e = params["router"].shape[1]
    capacity = expert_capacity(b, e, capacity_factor, top_k)
    rdt = torch.promote_types(x.dtype, torch.float32)
    logits = x.to(rdt) @ params["router"].to(rdt)
    dispatch, combine, aux = route_top_k(logits, capacity, top_k)
    xe = torch.einsum("bec,bd->ecd", dispatch.to(x.dtype), x)
    if axis is not None:
        # [E, C, D] -> [E/n_ep, n_ep·C, D]: rank j receives expert block
        # j's tokens from every peer
        xe = all_to_all(xe, axis.group, 0, 1)
    ye = _expert_ffn(xe, params["W_up"], params["W_down"])
    if axis is not None:
        # back to [E, C, D] on the tokens' home ranks, in expert order
        ye = all_to_all(ye, axis.group, 1, 0)
    y = torch.einsum("bec,ecd->bd", combine.to(ye.dtype), ye)
    return y, aux


def _ep_axis(ep_axis) -> Optional[AxisGroup]:
    if ep_axis is None or isinstance(ep_axis, AxisGroup):
        return ep_axis
    scope = current_scope()
    if scope is None:
        raise ValueError(
            f"ep_axis={ep_axis!r} runs only over a live mesh axis "
            "(make_ep_moe, or a ParallelTrainer step); clear ep_axis to "
            "run the experts on one device")
    return scope.axis(ep_axis)


def moe_apply_expert_sharded(params, x: torch.Tensor,
                             capacity_factor: float, top_k: int,
                             axis: AxisGroup
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply`` with the experts split over ``axis`` and the tokens
    the same on every rank of it: routing and capacity over all tokens
    (exact single-device semantics), this rank's experts (its W_up /
    W_down slice, experts ``index·E/n .. (index+1)·E/n``) on their
    buffers, and the expert outputs all-gathered. The dispatch input
    takes Megatron's *f* (the experts of the other ranks add their part
    of x's gradient)."""
    b = x.shape[0]
    e = params["router"].shape[1]
    e_local = params["W_up"].shape[0]
    capacity = expert_capacity(b, e, capacity_factor, top_k)
    rdt = torch.promote_types(x.dtype, torch.float32)
    logits = x.to(rdt) @ params["router"].to(rdt)
    dispatch, combine, aux = route_top_k(logits, capacity, top_k)
    lo = axis.index * e_local
    xe = torch.einsum("bec,bd->ecd",
                      dispatch[:, lo:lo + e_local].to(x.dtype),
                      copy_to_group(x, axis.group))
    ye = gather_replicas(_expert_ffn(xe, params["W_up"], params["W_down"]),
                         axis.group, 0)
    y = torch.einsum("bec,ecd->bd", combine.to(ye.dtype), ye)
    return y, aux


def moe_apply_dense(params, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense one-hot top-1 dispatch (every token x every expert, masked
    after): the semantic reference of :func:`moe_apply` at a capacity
    that drops nothing; its FLOPs grow with E."""
    logits = x @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, 1, expert[:, None])[:, 0]
    e = probs.shape[-1]
    onehot = (expert[:, None] == torch.arange(e, device=x.device)).to(
        x.dtype)
    h = torch.relu(torch.einsum("be,bd,edf->bef", onehot, x,
                                params["W_up"]))
    y = torch.einsum("bef,efd->bd", h, params["W_down"])
    y = y * gate[:, None]
    f = onehot.mean(dim=0)
    p = probs.mean(dim=0)
    aux = e * (f * p).sum()
    return y, aux


def make_ep_moe(mesh, ep_axis: str = "ep",
                token_axes: Optional[Sequence[str]] = None,
                capacity_factor: float = 1.25, top_k: int = 1):
    """Explicit expert-parallel MoE over ``mesh``: returns ``fn(params,
    x) -> (y, aux)`` taking this rank's tokens [B_local, D] and its
    params (the whole router, its ``E / n_ep`` experts of W_up/W_down:
    :func:`ep_param_shardings`), returning its outputs and the aux loss
    averaged over the token axes (default: ``ep_axis`` alone; pass
    ``("dp", "ep")`` for a dp x ep mesh)."""
    from deeplearning4j_tpu_torch.parallel.mesh import (
        axes_size,
        axis_group,
        axis_of,
    )

    if ep_axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {ep_axis!r}")
    axes = tuple(token_axes) if token_axes else (ep_axis,)
    axis = axis_of(mesh, ep_axis)
    n_ep = axis.size
    token_group = axis_group(mesh, axes)
    n_tok = axes_size(mesh, axes)

    def fn(params, x):
        e = params["router"].shape[1]
        if e % n_ep:
            raise ValueError(f"n_experts {e} not divisible by ep={n_ep}")
        y, aux = moe_apply(params, x, capacity_factor, top_k, ep_axis=axis)
        return y, all_reduce_sum(aux, token_group) / n_tok

    return fn


def ep_param_shardings(mesh, ep_axis: str = "ep"):
    """The placements of a MoE param dict: the expert axis of W_up and
    W_down on ``ep_axis``, the router replicated."""
    from deeplearning4j_tpu_torch.parallel.mesh import P, Sharding

    return {"router": Sharding(mesh, P()),
            "W_up": Sharding(mesh, P(ep_axis, None, None)),
            "W_down": Sharding(mesh, P(ep_axis, None, None))}
