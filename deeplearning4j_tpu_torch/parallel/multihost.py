"""Joining the process group, and moving batches between a rank's rows
and the global batch.

Port of ``deeplearning4j_tpu/parallel/multihost.py``. Where JAX joins
one process per host to ``jax.distributed``, the port joins one process
per rank to a ``torch.distributed`` group: ``torchrun`` (or ``python -m
torch.distributed.run``) sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``, or the caller passes the address,
world size and rank. One process with nothing set is a no-op, so the
same code runs on one rank and on many.

The backend follows the device: NCCL for ``device="cuda"`` (one rank
per card: a rank whose ``LOCAL_RANK`` has no card raises, it never
drops to gloo or the CPU), gloo for ``device="cpu"``. A gloo group
over CUDA tensors exists only where the caller names
``backend="gloo"``.

:class:`MultiHostContext` rides on the scale-out coordinator, which is
a later slice: it raises, naming that ROADMAP item.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device: str = "cuda",
                         local_rank: Optional[int] = None) -> int:
    """Join the process group; idempotent; returns this process's rank.

    ``coordinator_address`` is an ``init_method`` URL
    (``tcp://host:port``) or ``host:port``; without it the launcher's
    environment is read. With no arguments and no ``WORLD_SIZE`` above
    1 in the environment this is a no-op returning 0. On ``device=
    "cuda"`` the rank binds to card ``LOCAL_RANK`` (``torch.cuda.
    set_device``) before the group forms."""
    if dist.is_initialized():
        return dist.get_rank()
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None or backend is not None)
    if not explicit and env_world <= 1:
        return 0  # single process
    world = int(num_processes if num_processes is not None else env_world)
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", "0"))
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    if backend is None:
        backend = "nccl" if str(device).startswith("cuda") else "gloo"
    if backend == "nccl" or str(device).startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"initialize_multihost(device={device!r}, backend="
                f"{backend!r}): no CUDA device; pass device='cpu' for gloo "
                "on the CPU")
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and local_rank >= n_cards:
            raise RuntimeError(
                f"NCCL needs one card per rank: local rank {local_rank} "
                f"but {n_cards} card(s) on this host")
        torch.cuda.set_device(local_rank % n_cards)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kwargs)
    log.info("torch.distributed up: rank %d/%d, backend %s", rank, world,
             backend)
    return rank


def shutdown_multihost() -> None:
    """Leave the process group (a no-op when none was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def host_local_to_global(arr: torch.Tensor, mesh, pspec) -> torch.Tensor:
    """The global batch from every rank's rows: ``arr`` is this rank's
    slice under ``pspec`` (its leading dim split over the named axes);
    the result is the whole array on every rank (one all-gather per
    split dim). One process: ``arr`` itself."""
    from deeplearning4j_tpu_torch.parallel.mesh import gather_for_host

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return arr
    return gather_for_host(mesh, arr, pspec)


def global_to_host_local(arr: torch.Tensor, mesh, pspec) -> torch.Tensor:
    """This rank's slice of the global ``arr`` under ``pspec``."""
    from deeplearning4j_tpu_torch.parallel.mesh import shard_of

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return arr
    return shard_of(torch.as_tensor(arr), mesh, pspec)


def sync_hosts(name: str = "barrier") -> None:
    """A barrier over every rank (a no-op in one process)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


class MultiHostContext:
    """The gang tied to the scale-out control plane (coordinator
    registration, heartbeats, elastic restart from a checkpoint): rides
    on ``scaleout.coordinator``, a later slice."""

    def __init__(self, coordinator_url: Optional[str] = None,
                 heartbeat_interval: float = 1.0):
        raise NotImplementedError(
            "MultiHostContext rides on the scale-out coordinator "
            "(scaleout/*), not ported to the torch package yet (ROADMAP "
            "Queue 1 item 11d); use initialize_multihost() for the data "
            "plane")
