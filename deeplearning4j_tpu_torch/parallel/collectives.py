"""The collectives of the port's mesh, each a ``torch.autograd.Function``.

In the JAX package XLA derives these from shardings (GSPMD) or
``shard_map`` code; the port runs one process per rank and calls them
itself, over ``torch.distributed`` groups of a :func:`make_mesh` mesh:

- :func:`copy_to_group` (Megatron's *f*): identity forward, all-reduce
  of the gradient backward; it goes before a column-parallel matmul.
- :func:`reduce_from_group` (Megatron's *g*): all-reduce forward,
  identity backward; it goes after a row-parallel matmul.
- :func:`gather_shards` (fsdp): all-gather of a parameter's shards
  forward, reduce-scatter of its gradient backward.
- :func:`gather_replicas`: all-gather forward, the rank's own slice of
  the gradient backward (the ranks of the group compute the same loss
  on the gathered tensor, so each holds the whole gradient already).
- :func:`all_to_all` (ep, Ulysses sp): JAX's ``lax.all_to_all(...,
  split_axis, concat_axis, tiled=True)``; its backward is the reverse
  exchange.
- :func:`all_reduce_sum` (the dp gradient mean's sum, the sp masked
  counts): sum forward and backward, the adjoint when every rank's loss
  adds into one total.
- :func:`count_weighted_mean`: one rank's share of a global mean,
  ``data * count / total``: the sum over ranks of the shares is the
  mean over every rank's rows (JAX's ``_fit_sync`` divides by the
  global batch; ``divide_gradient`` keeps its meaning through it).

Every function takes ``group=None`` for the plain single-rank meaning
(no communication): the CPU tests hold each Function at world size 1
against it.

:class:`ParallelScope` tells the layers of one train step which mesh
axes are live (``tp``, ``ep`` and each ``ring_axis`` name); a layer
reads it through :func:`current_scope`. ``ParallelTrainer`` enters it
around its forward and backward.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def group_ranks(group) -> list:
    """The global ranks of ``group`` in group-rank order."""
    if group is None:
        return [0]
    return dist.get_process_group_ranks(group)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*: identity forward, all-reduce backward."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g*: all-reduce (sum) forward, identity backward."""
    return _ReduceFromGroup.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group forward and backward."""
    return _AllReduceSum.apply(x, group)


def _gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x.clone()
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * front.shape[0],) + tuple(front.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim)


def _reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x.clone()
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((front.shape[0] // n,) + tuple(front.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, front, group=group)
    return out.movedim(0, dim)


def _own_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    return x.chunk(n, dim)[group_rank(group)].contiguous()


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, ctx.group, ctx.dim), None, None


class _GatherReplicas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group, ctx.dim), None, None


def gather_shards(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """fsdp: the whole tensor from the group's shards along ``dim``
    (all-gather); the gradient reduce-scatters back to the shards."""
    return _GatherShards.apply(x, group, dim)


def gather_replicas(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather along ``dim``; the gradient of a rank's part is its
    slice of the (identical) gradient of the whole."""
    return _GatherReplicas.apply(x, group, dim)


def _all_to_all(x: torch.Tensor, group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1:
        return x.clone()
    if x.shape[split_dim] % n:
        raise ValueError(
            f"all_to_all: dim {split_dim} of {tuple(x.shape)} is not "
            f"divisible by the group's {n} ranks")
    send = torch.stack(x.chunk(n, split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return (_all_to_all(g.contiguous(), group, concat_dim, split_dim),
                None, None, None)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """JAX's tiled ``lax.all_to_all``: ``x`` split in n along
    ``split_dim``, piece j to rank j, the received pieces concatenated
    along ``concat_dim`` in rank order."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def count_weighted_mean(data: torch.Tensor, count, total):
    """One rank's share ``data * count / total`` of a global mean, where
    ``data`` is the rank's mean over its ``count`` rows and ``total``
    the rows of every rank (floats, or 0-dim tensors for masked
    counts). A share of the whole is ``data`` itself, bit for bit."""
    if isinstance(count, torch.Tensor) or isinstance(total, torch.Tensor):
        return data * (torch.clamp(torch.as_tensor(count), min=1.0)
                       / torch.clamp(torch.as_tensor(total), min=1.0))
    w = max(float(count), 1.0) / max(float(total), 1.0)
    return data if w == 1.0 else data * w


def reduce_tensors(tensors: Sequence[torch.Tensor], group) -> list:
    """Sum each tensor over ``group`` in one all-reduce of one flat
    buffer per dtype (no autograd): the gradients of a dp step."""
    if group is None or not tensors:
        return list(tensors)
    out = list(tensors)
    by_dtype: Dict[torch.dtype, list] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        at = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[at:at + n].view(tensors[i].shape)
            at += n
    return out


# ---------------------------------------------------------------------------
# the scope layers read
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AxisGroup:
    """One live mesh axis: its process group, size and this rank's
    index on it."""

    name: str
    group: object
    size: int
    index: int

    @property
    def ranks(self) -> list:
        return group_ranks(self.group)


@dataclasses.dataclass
class ParallelScope:
    """The mesh axes one step runs over: ``axes`` by name (every axis a
    layer's ``ring_axis`` may name), ``tp`` / ``ep`` the axis names of
    tensor and expert parallelism (or None), and ``dense_roles``, the
    Megatron role of each tensor-parallel ``DenseLayer`` bean by
    ``id``: ``"col"``, ``"row"`` or ``"col_gather"`` (a column layer
    whose next layer takes whole activations)."""

    axes: Dict[str, AxisGroup]
    tp: Optional[str] = None
    ep: Optional[str] = None
    dense_roles: Dict[int, str] = dataclasses.field(default_factory=dict)

    def axis(self, name: str) -> AxisGroup:
        if name not in self.axes:
            raise ValueError(
                f"mesh axis {name!r} is not live in this step (live: "
                f"{sorted(self.axes)})")
        return self.axes[name]

    @property
    def tp_axis(self) -> Optional[AxisGroup]:
        return None if self.tp is None else self.axes[self.tp]

    @property
    def ep_axis(self) -> Optional[AxisGroup]:
        return None if self.ep is None else self.axes[self.ep]


_local = threading.local()


def current_scope() -> Optional[ParallelScope]:
    """The scope of the step running on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def parallel_scope(scope: Optional[ParallelScope]):
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(scope)
    try:
        yield scope
    finally:
        stack.pop()


def ring_axis_group(name: str) -> AxisGroup:
    """The live axis a layer's ``ring_axis`` names; raises outside a
    sequence-parallel step, as JAX raises on an unbound axis name."""
    scope = current_scope()
    if scope is None:
        raise ValueError(
            f"ring_axis={name!r} runs only inside a sequence-parallel "
            "step (ParallelTrainer(sp_axis=...)); clear ring_axis to run "
            "the layer on one device (net.unsharded_clone())")
    return scope.axis(name)


def tp_local(total: int, axis: Optional[AxisGroup]) -> int:
    """This rank's count of ``total`` items (heads) split over
    ``axis``."""
    if axis is None:
        return total
    if total % axis.size:
        raise ValueError(
            f"tensor parallelism over {axis.name!r} needs tp ({axis.size}) "
            f"to divide {total}: head sharding slices whole heads")
    return total // axis.size
