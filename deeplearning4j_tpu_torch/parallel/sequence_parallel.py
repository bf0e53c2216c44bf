"""Sequence (context) parallelism: ring attention, Ulysses attention and
the distributed scan.

Port of ``deeplearning4j_tpu/parallel/sequence_parallel.py``. The time
axis of a batch is split over the mesh's sp axis; each rank holds its
chunk [B, H, T/P, dh] and only boundary state crosses ranks.

- :func:`ring_attention`: the K/V block hops round the ring
  (``batch_isend_irecv``: each rank sends its visiting block to the
  previous rank and receives the next one, the exchange of hop s + 1
  overlapping the attention of hop s). Each hop attends this rank's
  queries to the visiting block and yields a partial (O, LSE) pair;
  the pairs are merged in torch (a few elementwise ops, as JAX's
  ``_online_softmax_block`` is XLA). Causal: the diagonal block runs
  causal, blocks of earlier positions run full, later ones are skipped.
  The backward hops again with the ring's merged O and LSE, each hop's
  dQ adding up at home and each block's dK/dV travelling with it until
  they are back at their rank after P hops. On the card, where K1's
  dispatch says so (:func:`~deeplearning4j_tpu_torch.nn.layers.attention.
  _should_use_flash`: CUDA, no key mask, a head width it takes, T/P >=
  ``FLASH_MIN_T`` unless ``use_flash`` forces it), each hop is K1:
  ``flash_attention_fwd`` forward and ``flash_attention_bwd(q, k, v, o,
  lse, do, causal)`` backward. Otherwise each hop is the plain block
  (:func:`_plain_block_fwd` / :func:`_plain_block_bwd`, the online
  softmax of JAX's ``_online_softmax_block`` with the key mask), also
  sub-chunked by ``block_size``.
- :func:`ulysses_attention`: two ``all_to_all``s swap the split from
  time to heads, attention runs over the whole T on H/P heads (K1
  where it dispatches), and the output swaps back.
- :func:`sp_scan`: each rank scans its time chunk from the carry the
  previous rank sends, and sends its final carry on; the backward
  passes the carry's gradient back the same way. Exact full BPTT with
  O(T/P) activations a rank; the ring is serial by nature.
- :func:`make_ring_attention`: ring attention over a mesh axis by name.

The point-to-point hops use global ranks (``AxisGroup.ranks``).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel.collectives import (
    AxisGroup,
    _gather_dim,
    all_to_all,
    current_scope,
)

_NEG = float("-inf")


def _axis(axis) -> AxisGroup:
    """An :class:`AxisGroup`, or the live axis of that name."""
    if isinstance(axis, AxisGroup):
        return axis
    scope = current_scope()
    if scope is None:
        raise ValueError(
            f"sequence parallelism over {axis!r} needs a live mesh axis "
            "(a ParallelTrainer step or make_ring_attention)")
    return scope.axis(axis)


def _hop(tensors, axis: AxisGroup):
    """Send each tensor to the previous rank of the ring and receive the
    next rank's: returns (requests, received tensors); wait on the
    requests before reading them."""
    n = axis.size
    ranks = axis.ranks
    prev_r = ranks[(axis.index - 1) % n]
    next_r = ranks[(axis.index + 1) % n]
    recv = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
            for t in tensors]
    ops = []
    for t, rv in zip(tensors, recv):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), prev_r))
        ops.append(dist.P2POp(dist.irecv, rv, next_r))
    return dist.batch_isend_irecv(ops), recv


def _wait(reqs) -> None:
    for r in reqs:
        r.wait()


def _block_mode(causal: bool, src: int, me: int) -> Optional[str]:
    """How this rank's queries meet block ``src``: "full", "causal"
    (the diagonal), or None (a block of later positions, skipped)."""
    if not causal or src < me:
        return "full"
    return "causal" if src == me else None


def _scores_mask(tq: int, tk: int, mode: str, key_mask, device):
    """Boolean [B?, 1, Tq, Tk] validity (None: everything valid)."""
    ok = None
    if mode == "causal":
        ok = torch.tril(torch.ones((tq, tk), dtype=torch.bool,
                                   device=device))[None, None]
    if key_mask is not None:
        km = (key_mask > 0)[:, None, None, :]
        ok = km if ok is None else (ok & km)
    return ok


def _plain_block_fwd(q, k, v, mode, key_mask, block_size=None):
    """(O f32, LSE f32 [B, H, Tq]) of q over one visiting block, the
    scores scaled by dh**-0.5 and masked; a row with no valid key has
    LSE -inf and O 0. ``block_size`` sub-chunks the block's keys
    through the same merge (identical math, smaller score buffers)."""
    tk = k.shape[2]
    bs = tk if not block_size else min(block_size, tk)
    if tk % bs:
        raise ValueError(
            f"block_size {bs} must divide the local shard length {tk}")
    o = lse = None
    for s0 in range(0, tk, bs):
        ks, vs = k[:, :, s0:s0 + bs].float(), v[:, :, s0:s0 + bs].float()
        kms = None if key_mask is None else key_mask[:, s0:s0 + bs]
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), ks) \
            * q.shape[-1] ** -0.5
        ok = _scores_mask(q.shape[2], bs, mode, kms, q.device)
        if mode == "causal" and bs != tk:
            # the diagonal block's causal rule in global key positions
            qp = torch.arange(q.shape[2], device=q.device)[:, None]
            kp = torch.arange(s0, s0 + bs, device=q.device)[None, :]
            ok = (qp >= kp)[None, None]
            if kms is not None:
                ok = ok & (kms > 0)[:, None, None, :]
        if ok is not None:
            scores = scores.masked_fill(~ok, _NEG)
        l_i = torch.logsumexp(scores, dim=-1)
        fin = torch.isfinite(l_i)
        p = torch.exp(scores - torch.where(fin, l_i, 0.0)[..., None])
        p = torch.where(fin[..., None], p, 0.0)
        o_i = torch.einsum("bhqk,bhkd->bhqd", p, vs)
        o, lse = (o_i, l_i) if o is None else merge_partials(o, lse, o_i,
                                                             l_i)
    return o, lse


def _plain_block_bwd(q, k, v, o, lse, do, mode, key_mask):
    """(dQ, dK, dV) f32 of one block given the ring's merged O and LSE
    (flash attention's backward: P from the scores and LSE, dS = P ∘
    (dO·Vᵀ - rowsum(dO ∘ O)))."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    ok = _scores_mask(q.shape[2], k.shape[2], mode, key_mask, q.device)
    fin = torch.isfinite(lse)
    p = torch.exp(scores - torch.where(fin, lse, 0.0)[..., None])
    p = torch.where(fin[..., None], p, 0.0)
    if ok is not None:
        p = p.masked_fill(~ok, 0.0)
    di = (dof * o.float()).sum(-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - di)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq, dk, dv


def merge_partials(o_a, lse_a, o_b, lse_b):
    """Merge two normalized partial attentions over disjoint key sets:
    (O, LSE) of their union. Rows with no key on either side stay
    (0, -inf)."""
    m = torch.maximum(lse_a, lse_b)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    wa = torch.exp(lse_a - m_safe)
    wb = torch.exp(lse_b - m_safe)
    s = wa + wb
    lse = m_safe + torch.log(s)
    lse = torch.where(s > 0, lse, _NEG)
    inv = torch.where(s > 0, 1.0 / torch.where(s > 0, s, 1.0), 0.0)
    o = (o_a.float() * wa[..., None] + o_b.float() * wb[..., None]) \
        * inv[..., None]
    return o, lse


def _kernel_hop(q, k, v, mode):
    from deeplearning4j_tpu_torch.nn.layers import attention as A

    o, lse = A.flash_attention_fwd(A._kernel_ready(q), A._kernel_ready(k),
                                   A._kernel_ready(v), mode == "causal")
    return o, lse


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, axis, causal, block_size,
                use_kernel):
        n, me = axis.size, axis.index
        o = lse = None
        blk = [k, v] + ([] if key_mask is None else [key_mask])
        for s in range(n):
            reqs, nxt = (_hop(blk, axis) if s < n - 1 else ([], None))
            src = (me + s) % n
            mode = _block_mode(causal, src, me)
            if mode is not None:
                km = blk[2] if key_mask is not None else None
                if use_kernel:
                    o_i, l_i = _kernel_hop(q, blk[0], blk[1], mode)
                else:
                    o_i, l_i = _plain_block_fwd(q, blk[0], blk[1], mode,
                                                km, block_size)
                o, lse = ((o_i.float(), l_i) if o is None
                          else merge_partials(o, lse, o_i, l_i))
            _wait(reqs)
            if nxt is not None:
                blk = nxt
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse,
                              *([] if key_mask is None else [key_mask]))
        ctx.args = (axis, causal, use_kernel, key_mask is not None)
        return out

    @staticmethod
    def backward(ctx, do):
        axis, causal, use_kernel, masked = ctx.args
        q, k, v, o, lse = ctx.saved_tensors[:5]
        key_mask = ctx.saved_tensors[5] if masked else None
        n, me = axis.size, axis.index
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        blk = [k, v] + ([] if key_mask is None else [key_mask])
        if use_kernel:
            from deeplearning4j_tpu_torch.nn.layers import attention as A

            qk, ok_, dok = (A._kernel_ready(q), A._kernel_ready(o),
                            A._kernel_ready(do))
        for s in range(n):
            src = (me + s) % n
            mode = _block_mode(causal, src, me)
            if mode is not None:
                km = blk[2] if key_mask is not None else None
                if use_kernel:
                    dq_i, dk_i, dv_i = A.flash_attention_bwd(
                        qk, A._kernel_ready(blk[0]),
                        A._kernel_ready(blk[1]), ok_, lse.contiguous(),
                        dok, mode == "causal")
                else:
                    dq_i, dk_i, dv_i = _plain_block_bwd(
                        q, blk[0], blk[1], o, lse, do, mode, km)
                dq += dq_i.float()
                dk += dk_i.float()
                dv += dv_i.float()
            if n > 1:
                # the visiting block's dK/dV travel with it; after P hops
                # they are home
                moving = (blk + [dk, dv]) if s < n - 1 else [dk, dv]
                reqs, got = _hop(moving, axis)
                _wait(reqs)
                if s < n - 1:
                    blk, (dk, dv) = got[:-2], got[-2:]
                else:
                    dk, dv = got
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def _use_kernel(use_flash, q, key_mask) -> bool:
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        _should_use_flash,
    )

    return _should_use_flash(use_flash, q, key_mask)


def ring_attention(q, k, v, axis_name="sp", causal: bool = True,
                   key_mask=None, block_size: Optional[int] = None,
                   use_flash=None):
    """Blockwise ring attention over this rank's time chunk.

    q/k/v: the LOCAL chunk [B, H, T_local, dh] of rank i of the ring
    ``axis_name`` (a live axis name or an :class:`AxisGroup`); returns
    the local output chunk. ``key_mask`` [B, T_local] (1 = valid) hops
    with its K/V block. ``block_size`` sub-chunks each visiting block on
    the plain path (the same math). ``use_flash`` is the layer's K1
    toggle (None: auto)."""
    axis = _axis(axis_name)
    b, h, t, d = q.shape
    if block_size is not None and (block_size < 1 or t % min(block_size,
                                                             t)):
        raise ValueError(
            f"block_size {block_size} must be positive and divide the "
            f"local shard length {t}")
    use_kernel = _use_kernel(use_flash, q, key_mask)
    return _RingAttention.apply(q, k, v, key_mask, axis, bool(causal),
                                block_size, use_kernel)


def ulysses_attention(q, k, v, axis_name="sp", causal: bool = True,
                      key_mask=None, use_flash=None):
    """DeepSpeed-Ulysses sequence parallelism: q/k/v are the LOCAL time
    chunk [B, H, T_local, dh]; one all-to-all of the stacked q/k/v
    swaps the split from time to heads ([3, B, H/P, T, dh]), attention
    runs over the full sequence on H/P heads (K1 where it dispatches,
    else the masked dense path), and a second all-to-all swaps the
    output back. ``key_mask`` [B, T_local] is all-gathered."""
    from deeplearning4j_tpu_torch.nn.layers import attention as A

    axis = _axis(axis_name)
    n = axis.size
    h = q.shape[1]
    if h % n:
        raise ValueError(
            f"ulysses needs n_heads ({h} local) divisible by the "
            f"{axis.name} axis size {n}; use ring attention otherwise")
    qkv = all_to_all(torch.stack([q, k, v]), axis.group, 2, 3)
    qg, kg, vg = qkv[0], qkv[1], qkv[2]
    mask = (None if key_mask is None
            else _gather_dim(key_mask, axis.group, 1))
    if A._should_use_flash(use_flash, qg, mask):
        og = A.flash_attention(qg, kg, vg, causal)
    else:
        og = A._dense_attention(qg, kg, vg, causal, mask)
        if mask is not None:
            # a query row with no valid key gets 0, as JAX guards it
            any_ok = (mask > 0).any(-1)[:, None, None, None]
            og = torch.where(any_ok, og, torch.zeros_like(og))
    return all_to_all(og, axis.group, 2, 1)


def make_ring_attention(mesh, axis_name: str = "sp", causal: bool = True,
                        masked: bool = False,
                        block_size: Optional[int] = None):
    """Ring attention over ``mesh``'s ``axis_name``: the returned fn
    takes this rank's [B, H, T_local, dh] q/k/v (and, with ``masked``,
    its [B, T_local] key mask) and returns its output chunk."""
    from deeplearning4j_tpu_torch.parallel.mesh import axis_of

    if axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {axis_name!r}")
    axis = axis_of(mesh, axis_name)
    if masked:
        return lambda q, k, v, m: ring_attention(
            q, k, v, axis, causal=causal, key_mask=m, block_size=block_size)
    return functools.partial(ring_attention, axis_name=axis, causal=causal,
                             block_size=block_size)


# ---------------------------------------------------------------------------
# the distributed scan
# ---------------------------------------------------------------------------

def _flat(carry):
    return list(carry) if isinstance(carry, (tuple, list)) else [carry]


def _unflat(like, leaves):
    return type(like)(leaves) if isinstance(like, (tuple, list)) \
        else leaves[0]


class _SpBoundary(torch.autograd.Function):
    """Ties a rank's chunk outputs to its boundary carries. Forward:
    sends the final carry to the next rank, returns ``ys``. Backward:
    receives the final carry's gradient from the next rank, takes the
    chunk's gradient to its incoming carry (a pass of its own over the
    chunk's graph) and sends it to the previous rank, then lets the
    outer backward run through the chunk to the parameters."""

    @staticmethod
    def forward(ctx, ys, axis, carry_in, *carry_out):
        ctx.axis, ctx.carry_in = axis, carry_in
        ctx.carry_out, ctx.ys_ref = carry_out, ys
        n, me = axis.size, axis.index
        if me < n - 1:
            nxt = axis.ranks[me + 1]
            for c in carry_out:
                dist.send(c.detach().contiguous(), nxt)
        return ys.view_as(ys)

    @staticmethod
    def backward(ctx, g_ys):
        axis = ctx.axis
        n, me = axis.size, axis.index
        g_out = []
        for c in ctx.carry_out:
            g = torch.zeros_like(c)
            if me < n - 1:
                dist.recv(g, axis.ranks[me + 1])
            g_out.append(g)
        if me > 0:
            grads = torch.autograd.grad(
                [ctx.ys_ref] + list(ctx.carry_out),
                ctx.carry_in, [g_ys] + g_out, retain_graph=True,
                allow_unused=True)
            prv = axis.ranks[me - 1]
            for gi, c in zip(grads, ctx.carry_in):
                dist.send((torch.zeros_like(c) if gi is None
                           else gi).contiguous(), prv)
        return (g_ys, None, None) + tuple(g_out)


def sp_scan(step_fn: Callable, carry_init, xs_local, axis_name="sp"):
    """Distributed sequential scan over a time-split sequence.

    ``step_fn(carry, x_t) -> (carry, y_t)``; ``xs_local`` is this rank's
    chunk, indexed by local step (a tensor [T_local, ...] or a list).
    Rank 0 scans from ``carry_init``, sends its final carry to rank 1,
    and so on; under autograd the carry's gradient hops back the same
    way (rank i computes its chunk's gradient to the incoming carry
    before its parameters' gradients, one extra backward pass over the
    chunk). Returns (final carry of the last rank, broadcast to every
    rank and detached; ys stacked [T_local, ...])."""
    axis = _axis(axis_name)
    n, me = axis.size, axis.index
    init = _flat(carry_init)
    if me > 0:
        prv = axis.ranks[me - 1]
        got = []
        for c in init:
            r = torch.empty_like(c)
            dist.recv(r, prv)
            got.append(r)
        init = got
    grad = torch.is_grad_enabled() and me > 0
    carry_in = [c.detach().requires_grad_(True) if grad else c
                for c in init]
    carry = _unflat(carry_init, carry_in)
    ys = []
    for t in range(len(xs_local)):
        carry, y = step_fn(carry, xs_local[t])
        ys.append(y)
    ys = torch.stack(ys)
    out = _flat(carry)
    if torch.is_grad_enabled() and ys.requires_grad:
        tied = _SpBoundary.apply(ys, axis, carry_in if grad else [], *out)
    else:
        tied = ys
        if me < n - 1:
            for c in out:
                dist.send(c.detach().contiguous(), axis.ranks[me + 1])
    final = [c.detach().clone().contiguous() for c in out]
    if n > 1:
        for c in final:
            dist.broadcast(c, axis.ranks[-1], group=axis.group)
    return _unflat(carry_init, final), tied
