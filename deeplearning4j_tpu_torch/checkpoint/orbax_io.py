"""Sharded checkpoints of (conf JSON, params, updater state, layer state,
iteration), one directory per step.

Port of ``deeplearning4j_tpu/checkpoint/orbax_io.py``; the module path
and the ``OrbaxCheckpointer`` name are kept so a reader finds it, but the
format is torch-native: ``torch.distributed.checkpoint`` (DCP). Under a
``ParallelTrainer`` every rank writes its own shards (each leaf a
``DTensor`` over the trainer's mesh with its ``PartitionSpec`` as
placements; whole leaves are written once), and ``meta.json`` (conf
JSON, kind, iteration, step) beside them. A checkpoint written at one
world size restores at another (:meth:`OrbaxCheckpointer.restore_into`
a trainer: DCP reshards on load) and into a single-device network
(:meth:`OrbaxCheckpointer.restore`, which needs no process group).

``save`` writes synchronously: it returns when the step's files are
complete, whatever ``wait`` says (``wait_until_finished`` is then a
no-op). ``max_to_keep`` keeps the newest steps.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch.distributed as dist

_META = "meta.json"


def _is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _placements(mesh, spec):
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, part in enumerate(tuple(spec or ())):
        if part is None:
            continue
        if not isinstance(part, str):
            raise ValueError(
                f"spec {tuple(spec)}: a dim split over several axes has no "
                "DTensor placement")
        where[part] = d
    return [Shard(where[n]) if n in where else Replicate()
            for n in mesh.mesh_dim_names]


class OrbaxCheckpointer:
    """Save / restore a network's training state through DCP, one
    directory per step under ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        if _is_rank0():
            os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    # -- save -----------------------------------------------------------
    def save(self, step: int, net, wait: bool = False) -> None:
        """Write ``net`` (a MultiLayerNetwork / ComputationGraph, or a
        ``ParallelTrainer``, whose ranks all call this) at ``step``."""
        import torch.distributed.checkpoint as dcp

        trainer = None
        if hasattr(net, "param_specs") and hasattr(net, "mesh"):
            trainer, net = net, net.net
        kind = "graph" if hasattr(net, "_layer_vertices") else "multilayer"
        payload = self._payload(net, trainer)
        path = self._step_dir(step)
        if _is_rank0():
            os.makedirs(path, exist_ok=True)
        if dist.is_initialized():
            dist.barrier()
        dcp.save(payload, checkpoint_id=path,
                 no_dist=not dist.is_initialized())
        if _is_rank0():
            meta = {"kind": kind, "conf_json": net.conf.to_json(),
                    "iteration": int(net.iteration), "step": int(step)}
            with open(os.path.join(path, _META), "w") as f:
                json.dump(meta, f)
            steps = self.all_steps()
            if self.max_to_keep > 0:
                for old in steps[:-self.max_to_keep]:
                    shutil.rmtree(self._step_dir(old), ignore_errors=True)
        if dist.is_initialized():
            dist.barrier()

    @staticmethod
    def _payload(net, trainer) -> Dict[str, Any]:
        """The state dict DCP writes: params, updater state and layer
        state; under a trainer each split leaf is a DTensor."""
        state = {"params": net.params, "updater_state": net.updater_state,
                 "state": net.state or {}}
        if trainer is None:
            return _tensors_only(state)
        from torch.distributed.tensor import DTensor

        specs = trainer.param_specs()
        mesh = trainer.mesh

        def wrap(si, name, t):
            return DTensor.from_local(t, mesh, _placements(
                mesh, specs[si][name]), run_check=False)

        params = {si: {n: wrap(si, n, t) for n, t in sub.items()}
                  for si, sub in net.params.items()}
        upd = {}
        for si, moments in net.updater_state.items():
            upd[si] = {}
            for mk, sub in (moments or {}).items():
                if isinstance(sub, dict) and set(sub) == set(specs.get(si,
                                                                        {})):
                    upd[si][mk] = {n: wrap(si, n, t) for n, t in sub.items()}
                else:
                    upd[si][mk] = sub
        out = {"params": params, "updater_state": upd,
               "state": net.state or {}}
        return _tensors_only(out)

    def wait_until_finished(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    # -- inspect --------------------------------------------------------
    def all_steps(self):
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(
                          os.path.join(self.directory, d, _META)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _meta(self, step: Optional[int]):
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints under {self.directory}")
        with open(os.path.join(self._step_dir(step), _META)) as f:
            return step, json.load(f)

    # -- restore --------------------------------------------------------
    def restore(self, step: Optional[int] = None, device="cuda"):
        """A single-device network (MultiLayerNetwork or ComputationGraph,
        on ``device``) from the checkpoint at ``step`` (default: latest),
        whatever world size wrote it, its beans' mesh-axis fields
        (``ring_axis``, ``ep_axis``) cleared: the serving and eval view,
        as ``unsharded_clone`` gives. Needs no process group; under one,
        only the calling rank reads."""
        import torch.distributed.checkpoint as dcp

        step, meta = self._meta(step)
        net = _build(meta, device)
        target = _tensors_only({"params": net.params,
                                "updater_state": net.updater_state,
                                "state": net.state or {}})
        dcp.load(target, checkpoint_id=self._step_dir(step), no_dist=True)
        _assign(net, target)
        net.iteration = int(meta["iteration"])
        net.params_version += 1
        return net

    def restore_into(self, trainer, step: Optional[int] = None) -> None:
        """Load the checkpoint at ``step`` into a ``ParallelTrainer``'s
        shards (every rank calls this; the writing world size may
        differ: DCP reshards)."""
        import torch.distributed.checkpoint as dcp

        step, meta = self._meta(step)
        net = trainer.net
        target = self._payload(net, trainer)
        dcp.load(target, checkpoint_id=self._step_dir(step),
                 no_dist=not dist.is_initialized())
        from torch.distributed.tensor import DTensor

        local = _map(lambda t: t.to_local() if isinstance(t, DTensor)
                     else t, target)
        _assign(net, local)
        net.iteration = int(meta["iteration"])
        net.params_version += 1

    def close(self) -> None:
        """Nothing to release (JAX's manager holds threads)."""


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tensors_only(tree):
    """Drop empty dicts (DCP has nothing to write for them)."""
    if isinstance(tree, dict):
        out = {k: _tensors_only(v) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if not (isinstance(v, dict) and not v)}
    return tree


def _assign(net, loaded) -> None:
    """Copy the loaded leaves into ``net``'s trees in place of the old
    tensors (new tensors, so no alias of the load buffers remains)."""
    def put(tree, got):
        for k, v in got.items():
            if isinstance(v, dict):
                put(tree[k], v)
            else:
                tree[k] = v.detach().clone()

    put(net.params, loaded.get("params", {}))
    put(net.updater_state, loaded.get("updater_state", {}))
    if loaded.get("state"):
        put(net.state, loaded["state"])


def _build(meta, device):
    if meta.get("kind", "multilayer") == "graph":
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
            ComputationGraphConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        conf = ComputationGraphConfiguration.from_json(meta["conf_json"])
        net = ComputationGraph(conf, device=device)
    else:
        from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
            MultiLayerConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        conf = MultiLayerConfiguration.from_json(meta["conf_json"])
        net = MultiLayerNetwork(conf, device=device)
    net.init()
    for beans in ([v.conf.layer for v in net._layer_vertices.values()]
                  if hasattr(net, "_layer_vertices")
                  else [c.layer for c in net.conf.confs]):
        for axis_field in ("ring_axis", "ep_axis"):
            if getattr(beans, axis_field, None):
                setattr(beans, axis_field, None)
    return net

