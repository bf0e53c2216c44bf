"""Device meshes over ``torch.distributed``.

Port of ``deeplearning4j_tpu/parallel/mesh.py``. JAX runs one
controller over many devices and XLA derives the collectives from
shardings; the port runs one process per rank (``torchrun``, or
:func:`~deeplearning4j_tpu_torch.parallel.multihost.initialize_multihost`
with explicit arguments), one rank per device: NCCL with one rank per
card in production, gloo in the CPU tests. :func:`make_mesh` lays the
initialised world out as a ``torch.distributed.device_mesh.DeviceMesh``
with named dims; :func:`axis_group` gives the process group of one
axis or of several axes together (the dp x sp group of a
sequence-parallel gradient, for instance).

:class:`PartitionSpec` and :class:`Sharding` are the placement
descriptors the trainer reads: a spec names, per tensor dim, the mesh
axis it is split over (or None), as JAX's ``PartitionSpec`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from deeplearning4j_tpu_torch.parallel.collectives import (
    AxisGroup,
    _gather_dim,
)


@dataclasses.dataclass
class MeshSpec:
    """Named axis sizes, e.g. {"dp": 4, "tp": 2}. Size -1 means "absorb
    remaining devices" (at most one axis)."""

    axes: Dict[str, int]

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = dict(self.axes)
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError("At most one axis may be -1")
        fixed = int(np.prod([v for v in sizes.values() if v != -1]))
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        return sizes


class PartitionSpec(tuple):
    """Per tensor dim, the mesh axis (or tuple of axes) it is split over,
    or None: ``PartitionSpec(None, "tp")`` splits a matrix's columns.
    Compares equal to JAX's ``PartitionSpec`` as a tuple."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's placement on a mesh (JAX's ``NamedSharding``)."""

    mesh: DeviceMesh
    spec: PartitionSpec


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(spec, device_type: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` over the initialised world with ``spec``'s named
    dims (a :class:`MeshSpec` or a dict), one rank per device, ranks
    laid out row-major in the dims' order (the last dim varies
    fastest). ``device_type`` defaults to the default group's backend's
    device ("cuda" for NCCL, "cpu" for gloo); pass "cuda" for a gloo
    group whose tensors live on a card."""
    if isinstance(spec, dict):
        spec = MeshSpec(spec)
    if not dist.is_initialized():
        raise ValueError(
            "make_mesh needs an initialised process group: launch under "
            "torchrun and call initialize_multihost(), or call "
            "initialize_multihost(address, world_size, rank, backend=...)")
    n = world_size()
    sizes = spec.resolve(n)
    total = int(np.prod(list(sizes.values())))
    if total > n:
        raise ValueError(
            f"Mesh needs {total} devices, have {n}"
        )
    if total < n:
        raise ValueError(
            f"Mesh spans {total} of the world's {n} ranks: every rank "
            "holds one device of the mesh")
    if device_type is None:
        device_type = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    layout = torch.arange(n).reshape(tuple(sizes.values()))
    mesh = DeviceMesh(device_type, layout,
                      mesh_dim_names=tuple(sizes.keys()))
    return mesh


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """{axis name: size}, in the mesh's dim order."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_coordinate(mesh: DeviceMesh) -> Dict[str, int]:
    """This rank's index on each axis."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def axis_group(mesh: DeviceMesh, axes):
    """The process group of the ranks that share this rank's
    coordinates on every axis but ``axes`` (a name or a sequence of
    names; empty: None, the single-rank meaning). Every rank must ask
    for the same axes in the same order (the groups are made
    collectively) and the group is cached on the mesh."""
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in axes if a)
    if not axes:
        return None
    names = list(mesh.mesh_dim_names)
    for a in axes:
        if a not in names:
            raise ValueError(f"mesh has no axis {a!r} (axes {names})")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_dl4j_groups", {})
    key = tuple(sorted(axes, key=names.index))
    if key not in cache:
        layout = mesh.mesh
        keep = [names.index(a) for a in key]
        rest = [i for i in range(len(names)) if i not in keep]
        moved = layout.permute(rest + keep).reshape(
            -1, int(np.prod([layout.shape[i] for i in keep])))
        me = dist.get_rank()
        mine = None
        for row in moved.tolist():
            g = dist.new_group(row)
            if me in row:
                mine = g
        cache[key] = mine
    return cache[key]


def axis_of(mesh: DeviceMesh, name: str) -> AxisGroup:
    """The :class:`AxisGroup` (group, size, this rank's index) of one
    of ``mesh``'s axes."""
    return AxisGroup(name, axis_group(mesh, name), mesh_shape(mesh)[name],
                     mesh_coordinate(mesh)[name])


def axes_size(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in axes if a])) if axes else 1


def axes_index(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    """This rank's index over ``axes`` taken together, the first axis
    major (JAX's ``PartitionSpec(("dp", "fsdp"))`` order)."""
    shape, coord = mesh_shape(mesh), mesh_coordinate(mesh)
    idx = 0
    for a in axes:
        if a:
            idx = idx * shape[a] + coord[a]
    return idx


def replicated(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, PartitionSpec())


def batch_sharding(mesh: DeviceMesh, axis: str = "dp") -> Sharding:
    """Shard the leading (example) axis over the data-parallel mesh axis."""
    return Sharding(mesh, PartitionSpec(axis))


def shard_of(full: torch.Tensor, mesh: DeviceMesh, spec) -> torch.Tensor:
    """This rank's piece of ``full`` under ``spec`` (a new tensor)."""
    out = full
    for dim, axes in enumerate(tuple(spec or ())):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n, i = axes_size(mesh, axes), axes_index(mesh, axes)
        if out.shape[dim] % n:
            raise ValueError(
                f"dim {dim} of {tuple(full.shape)} is not divisible by the "
                f"{n} ranks of {axes}")
        out = out.chunk(n, dim)[i]
    return out.contiguous().clone()


def gather_for_host(mesh: DeviceMesh, leaf: torch.Tensor,
                    spec=None) -> torch.Tensor:
    """The whole tensor from this rank's piece ``leaf`` under ``spec``:
    one all-gather per split dim over its axes' group
    (``all_gather_into_tensor``; a replicated
    ``spec`` returns ``leaf``). Every rank must call this in lockstep
    over the same leaves."""
    out = leaf
    for dim, axes in enumerate(tuple(spec or ())):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        out = _gather_dim(out, axis_group(mesh, axes), dim)
    return out
