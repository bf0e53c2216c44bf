"""Data, tensor, fully-sharded, expert and sequence parallel training over
a ``torch.distributed`` mesh.

Port of ``deeplearning4j_tpu/parallel/data_parallel.py``. JAX runs one
program over the mesh and XLA derives the collectives from shardings;
the port runs :class:`ParallelTrainer` in every rank (SPMD, one process
per device) and calls the collectives of ``parallel/collectives.py``
itself. The trainer hooks into the network's train step between its
gradient and its update (``BaseNetwork._step_body`` asks
``net._parallel`` for the value and gradient), so the updater, the
captured ``fit_scan`` window and the telemetry are the network's own:

- **dp** (and **fsdp**, which is a data axis too): ``fit`` takes the
  GLOBAL batch on every rank and keeps this rank's rows; each rank's
  loss is its count-weighted share of the global (masked) mean
  (``count_weighted_mean``: JAX's ``_fit_sync`` divides by the global
  batch), so the sum of the ranks' gradients, one all-reduce per dtype
  over the data axes, is the global batch's gradient. The score is the
  same sum. l1/l2 and the MoE auxiliary loss are divided by the data
  ranks (the auxiliary loss is then the mean of the ranks' own, where
  JAX computes it over the global batch; the two agree when the batch
  is not split, as on an ep axis). Layer state (BatchNormalization's
  running statistics) is averaged over the data ranks after the step;
  its batch statistics are each rank's own.
- **tp**: each rank holds the shards of ``tp_param_specs`` (Megatron:
  attention heads whole, Wq/Wk/Wv columns and Wo rows; FFN W1 columns
  and W2 rows; hidden Dense layers alternating column and row), and the
  layers run on their local heads and columns with Megatron's *f* and
  *g* (``nn/layers/attention.py``, ``nn/layers/dense.py``): K1 runs on
  [B, H/T, T, dh]. Replicated parameters get the same whole gradient on
  every rank of the tp axis.
- **fsdp**: every parameter leaf tp/ep left whole is split over the
  fsdp axis along its largest divisible dim (``fsdp_param_specs``); the
  step all-gathers each at use and reduce-scatters its gradient
  (``gather_shards``), and the updater (Adam's moments included) runs on
  the shard.
- **ep**: the experts of each ``MoeDense`` are split over the ep axis;
  the batch is the same on every rank of it (routing over all tokens,
  as JAX's GSPMD ep shardings), each rank runs its experts, and their
  outputs are all-gathered (``moe_apply_expert_sharded``).
- **sp**: the TIME axis of [N, C, T] batches is split over sp (the
  batch over dp); attention layers with ``ring_axis=sp_axis`` run ring
  or Ulysses attention, GravesLSTM/GRU an ``sp_scan``, and the loss is
  the global masked mean through count-weighted sums (JAX's
  ``_sp_body_core``).
- ``average_each_iteration=False`` with ``local_steps=K``: K plain
  local steps on this rank's rows, then the params and updater state
  averaged over the data ranks (the reference's average-at-end).

``fit`` returns the global mean score on every rank. ``fit_scan`` runs
K synchronous steps over [K, B, ...] batches: under NCCL it replays one
captured CUDA graph per key (``self.train_graphs``; the all-reduces
inside the graph), as the network's ``fit_scan`` does; under gloo its
steps run eagerly, since gloo's collectives are host calls a graph
cannot hold.

After training, :meth:`full_params` / :meth:`unsharded_net` gather the
shards (every rank, in lockstep).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.enums import GradientNormalization
from deeplearning4j_tpu_torch.nn.cuda_graphs import GraphRunner
from deeplearning4j_tpu_torch.nn.streaming import tree_leaves, tree_map
from deeplearning4j_tpu_torch.optimize.telemetry import (
    batch_counts,
    emit_step_span,
    mesh_args,
)
from deeplearning4j_tpu_torch.parallel.collectives import (
    ParallelScope,
    count_weighted_mean,
    gather_shards,
    parallel_scope,
    reduce_tensors,
)
from deeplearning4j_tpu_torch.parallel.mesh import (
    P,
    axes_index,
    axes_size,
    axis_group,
    axis_of,
    gather_for_host,
    mesh_shape,
    shard_of,
)


def _layer_items(net):
    """(param key, layer bean) of a MultiLayerNetwork (keys "0".."N-1")
    or a ComputationGraph (layer-vertex names, sorted)."""
    if hasattr(net, "_layer_vertices"):
        for name in sorted(net._layer_vertices):
            yield name, net._layer_vertices[name].conf.layer
    else:
        for i, c in enumerate(net.conf.confs):
            yield str(i), c.layer


def _is_graph(net) -> bool:
    return hasattr(net, "_coerce_multi")


def tp_param_specs(net, mesh_axis: str = "tp"):
    """PartitionSpec tree of a MultiLayerNetwork's params: attention
    layers shard over HEADS (Wq/Wk/Wv columns, so each rank owns
    n_heads/T whole heads, and Wo rows), a TransformerBlock's FFN W1
    columns (and b1) and W2 rows, hidden Dense layers alternate column
    and row; everything else is replicated. MultiLayerNetwork only."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        MultiHeadSelfAttention,
        TransformerBlock,
    )

    if _is_graph(net):
        raise ValueError(
            "tp_param_specs requires a MultiLayerNetwork: Megatron "
            "column/row alternation follows the sequential layer chain; "
            "for ComputationGraphs shard expert (ep) or data (dp) axes")
    specs = {}
    col = True
    for key, lc in _layer_items(net):
        layer_specs = {}
        if isinstance(lc, MultiHeadSelfAttention):
            layer_specs["Wq"] = P(None, mesh_axis)
            layer_specs["Wk"] = P(None, mesh_axis)
            layer_specs["Wv"] = P(None, mesh_axis)
            layer_specs["Wo"] = P(mesh_axis, None)
            layer_specs["b"] = P()
        elif isinstance(lc, TransformerBlock):
            layer_specs["Wq"] = P(None, mesh_axis)
            layer_specs["Wk"] = P(None, mesh_axis)
            layer_specs["Wv"] = P(None, mesh_axis)
            layer_specs["Wo"] = P(mesh_axis, None)
            layer_specs["W1"] = P(None, mesh_axis)
            layer_specs["b1"] = P(mesh_axis)
            layer_specs["W2"] = P(mesh_axis, None)
        elif isinstance(lc, L.DenseLayer) and not isinstance(
                lc, L.OutputLayer):
            if col:
                layer_specs["W"] = P(None, mesh_axis)
                layer_specs["b"] = P(mesh_axis)
            else:
                layer_specs["W"] = P(mesh_axis, None)
                layer_specs["b"] = P()
            col = not col
        for name in net.params[key]:
            layer_specs.setdefault(name, P())
        specs[key] = layer_specs
    return specs


def fsdp_param_specs(net, mesh, mesh_axis: str = "fsdp",
                     base: Optional[dict] = None):
    """Overlay ZeRO-3/FSDP sharding onto a spec tree: every parameter
    leaf's LARGEST dim divisible by the axis size F is split over
    ``mesh_axis`` (leaves ``base`` already splits are left alone; leaves
    with no divisible dim stay whole). Raises when nothing is split."""
    F = int(mesh_shape(mesh)[mesh_axis])
    specs = dict(base) if base else {}
    for key, _ in _layer_items(net):
        layer_specs = dict(specs.get(key, {}))
        for name, p in net.params[key].items():
            existing = layer_specs.get(name)
            if existing is not None and any(existing):
                continue  # tp/ep laid this tensor out already
            shape = tuple(p.shape)
            best = None
            for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
                if shape[d] % F == 0 and shape[d] >= F:
                    best = d
                    break
            if best is None:
                layer_specs[name] = P()
            else:
                spec = [None] * len(shape)
                spec[best] = mesh_axis
                layer_specs[name] = P(*spec)
        specs[key] = layer_specs
    if not any(mesh_axis in tuple(sp)
               for layer in specs.values() for sp in layer.values()):
        raise ValueError(
            f"fsdp_axis={mesh_axis!r} (size {F}) shards NOTHING: no "
            "parameter dimension is divisible by it — training would "
            "run fully replicated while promising 1/F memory. Pick a "
            "divisor of the layer widths or drop the axis.")
    return specs


def ep_param_specs(net, mesh_axis: str = "ep", base: Optional[dict] = None):
    """Overlay expert sharding onto a spec tree: MoeDense expert tensors
    carry their leading expert axis on ``mesh_axis``."""
    from deeplearning4j_tpu_torch.nn.layers.moe import MoeDense

    n_ep = None
    specs = dict(base) if base else {}
    for key, lc in _layer_items(net):
        layer_specs = dict(specs.get(key, {}))
        if isinstance(lc, MoeDense):
            layer_specs["W_up"] = P(mesh_axis, None, None)
            layer_specs["W_down"] = P(mesh_axis, None, None)
            n_ep = lc.n_experts
        for name in net.params[key]:
            layer_specs.setdefault(name, P())
        specs[key] = layer_specs
    if n_ep is None:
        raise ValueError(
            "ep_axis was configured but the network has no MoeDense "
            "layers to shard")
    return specs


def _axes_of(spec) -> set:
    out = set()
    for part in tuple(spec or ()):
        if part is None:
            continue
        out.update((part,) if isinstance(part, str) else part)
    return out


#: gradient normalizations that read norms over a whole tensor or layer
#: (a shard's norm is not the tensor's)
_NORM_MODES = (GradientNormalization.RENORMALIZE_L2_PER_LAYER,
               GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE,
               GradientNormalization.CLIP_L2_PER_LAYER,
               GradientNormalization.CLIP_L2_PER_PARAM_TYPE)


class ParallelTrainer:
    """Synchronous SPMD trainer over a mesh (see the module docstring);
    every rank constructs it over its copy of the net (the same
    parameters on every rank: build it from one seed or one model zip)
    and calls the same methods with the same global batches.

    ``average_each_iteration=True`` (reference default): one global step
    per iteration. ``average_each_iteration=False`` with
    ``local_steps=K``: K independent local steps, then parameter +
    updater-state averaging. ``accumulate_gradients`` with
    ``divide_gradient=False`` applies the data workers' gradient SUM
    (the reference's engine flags)."""

    def __init__(self, net, mesh, dp_axis: str = "dp",
                 tp_axis: Optional[str] = None,
                 ep_axis: Optional[str] = None,
                 fsdp_axis: Optional[str] = None,
                 sp_axis: Optional[str] = None,
                 average_each_iteration: bool = True,
                 local_steps: int = 1,
                 accumulate_gradients: bool = False,
                 divide_gradient: bool = True, tracer=None):
        net.init()
        self.net = net
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.tracer = tracer
        names = tuple(mesh.mesh_dim_names)
        self.is_graph = _is_graph(net)

        def live(a):
            return a if (a and a in names) else None

        self.tp_axis = live(tp_axis)
        self.ep_axis = live(ep_axis)
        self.fsdp_axis = live(fsdp_axis)
        self.sp_axis = live(sp_axis)
        if self.sp_axis:
            self._validate_sp(net)
        # the fsdp axis IS a data axis (torch FSDP / ZeRO-3): the batch
        # splits over dp x fsdp jointly
        self._batch_axes = tuple(
            a for a in (live(dp_axis),
                        self.fsdp_axis if self.fsdp_axis != dp_axis
                        else None) if a)
        if self.is_graph and self.tp_axis:
            raise ValueError(
                "tensor parallelism (tp_axis) supports MultiLayerNetwork "
                "only: the Megatron column/row alternation follows the "
                "sequential layer chain; ComputationGraphs compose dp "
                "and ep axes")
        shape = mesh_shape(mesh)
        if self.tp_axis:
            from deeplearning4j_tpu_torch.nn.layers.attention import (
                ATTENTION_BEANS,
            )

            T = int(shape[self.tp_axis])
            for _, lc in _layer_items(net):
                if isinstance(lc, ATTENTION_BEANS):
                    if lc.n_heads % T:
                        raise ValueError(
                            f"n_heads {lc.n_heads} not divisible by mesh "
                            f"tp={T}: head sharding needs whole heads "
                            "per device")
                    if (lc.ring_axis
                            and getattr(lc, "sp_mode", "ring")
                            == "ulysses"):
                        raise ValueError(
                            "ulysses sp_mode all-to-alls the HEAD axis "
                            "over sp; it cannot compose with tp head "
                            "sharding — use sp_mode='ring' with tp")
                    if lc.ring_axis and lc.ring_axis != self.sp_axis:
                        raise ValueError(
                            "ring attention (ring_axis) composes with "
                            "head-sharded tp only through "
                            "ParallelTrainer(sp_axis=ring_axis)")
        if self.ep_axis:
            from deeplearning4j_tpu_torch.nn.layers.moe import MoeDense

            for _, lc in _layer_items(net):
                if (isinstance(lc, MoeDense)
                        and lc.n_experts % shape[self.ep_axis]):
                    raise ValueError(
                        f"n_experts {lc.n_experts} not divisible "
                        f"by mesh ep={shape[self.ep_axis]}")
                if isinstance(lc, MoeDense) and lc.ep_axis:
                    raise ValueError(
                        "MoeDense.ep_axis (explicit all-to-all) and "
                        "ParallelTrainer ep_axis (expert-sharded params) "
                        "are alternative dispatch paths; configure one")
        self.average_each_iteration = average_each_iteration
        self.local_steps = max(1, local_steps)
        self.accumulate_gradients = accumulate_gradients
        self.divide_gradient = divide_gradient
        if accumulate_gradients and not average_each_iteration:
            raise ValueError(
                "accumulate_gradients applies to the per-step synchronous "
                "mode; K-local-steps mode averages parameters instead")
        if (self.ep_axis or self.fsdp_axis) and not average_each_iteration:
            raise ValueError(
                "expert-/fsdp-sharded params require the per-step "
                "synchronous mode (K-local-steps runs with replicated "
                "params)")
        if self.sp_axis and not average_each_iteration:
            raise ValueError(
                "sequence parallelism (sp_axis) is a per-step "
                "synchronous mode: the ring exchanges K/V blocks inside "
                "every step, so K-independent-local-steps semantics do "
                "not apply")
        if self.sp_axis and accumulate_gradients:
            raise ValueError(
                "accumulate_gradients (per-worker gradient SUM) is a dp "
                "engine flag; the sp step applies the exact global mean "
                "gradient")
        if not average_each_iteration and net.state:
            raise ValueError(
                "K-local-steps-then-average mode does not support layers "
                "with running state (BatchNormalization); use "
                "average_each_iteration=True"
            )
        if not average_each_iteration and self.tp_axis:
            raise ValueError(
                "K-local-steps-then-average mode runs with replicated "
                "params; drop tp_axis")
        # the groups, made in the same order on every rank
        self._axes = {a: axis_of(mesh, a) for a in names}
        self._data_axes = self._batch_axes + (
            (self.sp_axis,) if self.sp_axis else ())
        self._data_group = axis_group(mesh, self._data_axes)
        self._ndev = axes_size(mesh, self._data_axes)
        self._dense_group = (axis_group(mesh, tuple(
            a for a in self._data_axes if a != self.fsdp_axis))
            if self.fsdp_axis else self._data_group)
        self._specs = self._param_specs()
        if any(_axes_of(s) for layer in self._specs.values()
               for s in layer.values()):
            for key, c in self._confs():
                mode = c.resolved("gradient_normalization")
                if mode in _NORM_MODES:
                    raise ValueError(
                        f"layer {key}: gradient_normalization {mode.value} "
                        "reads norms over whole tensors, which tp/ep/fsdp "
                        "shards do not hold; use none or "
                        "clip_element_wise_absolute_value")
        self._scope = ParallelScope(
            axes=self._axes, tp=self.tp_axis, ep=self.ep_axis,
            dense_roles=self._dense_roles())
        self.backend = dist.get_backend()
        #: the captured synchronous steps of ``fit_scan`` under NCCL,
        #: one per key (see the network's ``fit_scan``)
        self.train_graphs = GraphRunner()
        self._place_params()

    # ------------------------------------------------------------------
    def _confs(self):
        net = self.net
        if self.is_graph:
            return [(n, net._layer_vertices[n].conf)
                    for n in sorted(net._layer_vertices)]
        return [(str(i), c) for i, c in enumerate(net.conf.confs)]

    def _param_specs(self) -> dict:
        net = self.net
        if self.tp_axis:
            specs = tp_param_specs(net, self.tp_axis)
        else:
            specs = {k: {n: P() for n in sub} for k, sub in
                     net.params.items()}
        if self.ep_axis:
            specs = ep_param_specs(net, self.ep_axis, base=specs)
        if self.fsdp_axis:
            specs = fsdp_param_specs(net, self.mesh, self.fsdp_axis,
                                     base=specs)
        return specs

    def param_specs(self) -> dict:
        """The PartitionSpec of every parameter leaf, by layer key."""
        return {k: dict(v) for k, v in self._specs.items()}

    def _dense_roles(self) -> dict:
        """Megatron roles of the tp-split hidden Dense layers, by bean
        id (see ``ParallelScope``)."""
        if not self.tp_axis:
            return {}
        items = list(_layer_items(self.net))
        kinds = []
        for key, lc in items:
            spec = self._specs[key].get("W") if isinstance(
                lc, L.DenseLayer) and not isinstance(
                lc, L.OutputLayer) else None
            kinds.append(None if spec is None
                         else ("col" if spec == P(None, self.tp_axis)
                               else "row"))
        roles = {}
        for i, ((key, lc), kind) in enumerate(zip(items, kinds)):
            if kind == "col":
                nxt = kinds[i + 1] if i + 1 < len(kinds) else None
                roles[id(lc)] = "col" if nxt == "row" else "col_gather"
            elif kind == "row":
                prev = roles.get(id(items[i - 1][1])) if i else None
                roles[id(lc)] = "row" if prev == "col" else "row_full"
        return roles

    def _place_params(self) -> None:
        """Each leaf becomes this rank's shard under its spec; each
        updater moment that mirrors a layer's params takes the same
        shards."""
        net, mesh = self.net, self.mesh
        net.params = {k: {n: shard_of(p, mesh, self._specs[k][n])
                          for n, p in sub.items()}
                      for k, sub in net.params.items()}
        for si, moments in net.updater_state.items():
            for mk, sub in (moments or {}).items():
                if isinstance(sub, dict) and set(sub) == set(
                        self._specs.get(si, {})):
                    moments[mk] = {n: shard_of(t, mesh, self._specs[si][n])
                                   for n, t in sub.items()}
        net.params_version += 1
        net._cast_cache = (None, None)
        net.train_graphs.drop()

    # ------------------------------------------------------------------
    # gathering
    # ------------------------------------------------------------------
    def full_params(self) -> dict:
        """Every parameter whole (all-gathered over its split axes), on
        every rank; every rank must call it."""
        return {k: {n: gather_for_host(self.mesh, p, self._specs[k][n])
                    for n, p in sub.items()}
                for k, sub in self.net.params.items()}

    def full_updater_state(self) -> dict:
        out = {}
        for si, moments in self.net.updater_state.items():
            out[si] = {}
            for mk, sub in (moments or {}).items():
                if isinstance(sub, dict) and set(sub) == set(
                        self._specs.get(si, {})):
                    out[si][mk] = {n: gather_for_host(
                        self.mesh, t, self._specs[si][n])
                        for n, t in sub.items()}
                else:
                    out[si][mk] = sub
        return out

    def unsharded_net(self, device=None):
        """A single-device copy of the net with whole params and updater
        state (every rank must call it; each gets its copy), its beans'
        mesh-axis fields cleared: the serving and eval view."""
        params, upd = self.full_params(), self.full_updater_state()
        net = self.net
        clone = (net.unsharded_clone() if hasattr(net, "unsharded_clone")
                 else net.clone())
        dev = clone.device if device is None else torch.device(device)
        clone.params = tree_map(lambda t: t.to(dev).clone(), params)
        clone.updater_state = tree_map(lambda t: t.to(dev).clone(), upd)
        clone.state = tree_map(lambda t: t.to(dev).clone(), net.state)
        clone.device = dev
        clone.params_version += 1
        return clone

    # ------------------------------------------------------------------
    # batches
    # ------------------------------------------------------------------
    def _rows(self, a, dim: int):
        """This rank's rows of ``a`` along ``dim`` over the batch axes."""
        n = axes_size(self.mesh, self._batch_axes)
        if a is None or n == 1:
            return a
        if a.shape[dim] % n:
            raise ValueError(
                f"global batch of {a.shape[dim]} does not split over the "
                f"{n} data ranks of {self._batch_axes}")
        i = axes_index(self.mesh, self._batch_axes)
        return a.narrow(dim, i * (a.shape[dim] // n), a.shape[dim] // n)

    def _steps_of(self, a, dim: int):
        """This rank's time chunk of ``a`` along ``dim`` over sp."""
        if a is None or not self.sp_axis:
            return a
        ax = self._axes[self.sp_axis]
        if a.shape[dim] % ax.size:
            raise ValueError(
                f"time axis of {a.shape[dim]} steps does not split over "
                f"sp={ax.size}")
        t = a.shape[dim] // ax.size
        return a.narrow(dim, ax.index * t, t)

    def _local(self, a, stacked: bool, mask: bool, is_float=True):
        net = self.net
        if a is None:
            return None
        t = net._tensor(a, net._dtype if is_float else None)
        off = 1 if stacked else 0
        t = self._rows(t, off)
        if self.sp_axis:
            t = self._steps_of(t, off + (1 if mask else 2))
        return t.contiguous()

    def _sp_check_ranks(self, inputs, labels, fm, lm, stacked=False):
        """Refuse sp-graph leaves of the wrong rank with a named error."""
        net = self.net
        rank = 4 if stacked else 3
        shape_x = "[K, B, C, T]" if stacked else "[B, C, T]"
        shape_m = "[K, B, T]" if stacked else "[B, T]"
        for what, leaves in (("input", inputs.items()),
                             ("label", zip(net.conf.network_outputs,
                                           labels))):
            for name, a in leaves:
                if np.ndim(a) != rank:
                    raise ValueError(
                        f"sp_axis graph {what} {name!r} must be "
                        f"{shape_x} (got rank {np.ndim(a)}); static "
                        "inputs have no time axis to shard")
        for what, masks in (("feature mask", fm), ("label mask", lm)):
            for name, a in (masks or {}).items():
                if np.ndim(a) != rank - 1:
                    raise ValueError(
                        f"sp_axis graph {what} {name!r} must be "
                        f"{shape_m} (got rank {np.ndim(a)}) to shard "
                        "its time axis")

    def _local_batch(self, ds, stacked: bool = False):
        """(features, labels, feature masks, label masks) of this rank
        from a global batch (a DataSet / MultiDataSet; stacked: the
        [K, ...] arrays of ``fit_scan``)."""
        net = self.net
        if stacked:
            x, y, fm, lm = ds
        elif self.is_graph:
            x, y, fm, lm = net._coerce_multi(ds, host=True)
        else:
            x, y, fm, lm = (ds.features, ds.labels, ds.features_mask,
                            ds.labels_mask)
        if self.is_graph:
            if not isinstance(x, dict):
                x = {net.conf.network_inputs[0]: x}
            if not isinstance(y, (list, tuple)):
                y = [y]
            if self.sp_axis:
                self._sp_check_ranks(x, y, fm, lm, stacked)
            conv = self._local
            return ({k: conv(a, stacked, False) for k, a in x.items()},
                    tuple(conv(a, stacked, False) for a in y),
                    None if fm is None else {k: conv(a, stacked, True, False)
                                             for k, a in fm.items()},
                    None if lm is None else {k: conv(a, stacked, True, False)
                                             for k, a in lm.items()})
        return (self._local(x, stacked, False), self._local(y, stacked, False),
                self._local(fm, stacked, True, False),
                self._local(lm, stacked, True, False))

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _hooked(self):
        self.net._parallel = self
        try:
            yield
        finally:
            self.net._parallel = None

    def _grad_scale(self) -> float:
        if self.accumulate_gradients and not self.divide_gradient:
            return float(axes_size(self.mesh, self._batch_axes))
        return 1.0

    def _view(self, leaves):
        """The params the forward sees: fsdp shards all-gathered."""
        if not self.fsdp_axis:
            return leaves
        group = self._axes[self.fsdp_axis].group
        out = {}
        for k, sub in leaves.items():
            out[k] = {}
            for n, p in sub.items():
                spec = tuple(self._specs[k][n])
                dim = next((d for d, a in enumerate(spec)
                            if a == self.fsdp_axis), None)
                out[k][n] = (p if dim is None
                             else gather_shards(p, group, dim))
        return out

    def _global_term(self, data, out, lm_term):
        """This rank's count-weighted share of a global (masked) mean
        (JAX's ``global_masked_term``)."""
        if lm_term is None:
            rows = out.shape[0] * (out.shape[2] if out.ndim == 3 else 1)
            return count_weighted_mean(data, rows, rows * self._ndev)
        count = lm_term.to(data.dtype).sum()
        total = count.detach().clone()
        if self._data_group is not None:
            dist.all_reduce(total, group=self._data_group)
        return count_weighted_mean(data, count, total)

    def _local_loss(self, p, state, rng, f, y, fm, lm):
        """This rank's part of the global loss and the new layer state;
        the sum over the data ranks is the global loss."""
        from deeplearning4j_tpu_torch.nn.multilayer import _cast_floating

        net = self.net
        if self.is_graph:
            acts, new_state, _ = net._forward_fn(p, state, f, rng, True, fm)
            local = 0.0
            for out_name, yy in zip(net.conf.network_outputs, y):
                v = net._layer_vertices[out_name]
                lm_o = None if lm is None else lm.get(out_name)
                out = acts[out_name]
                if net._compute_dtype is not None:
                    out = _cast_floating(out, net._dtype)
                data = net._impls[out_name].loss(v.conf, out, yy, lm_o)
                local = local + self._global_term(data, out, lm_o)
        else:
            out, new_state, _ = net._forward_fn(p, state, f, rng, True, fm)
            if net._compute_dtype is not None:
                out = _cast_floating(out, net._dtype)
            data = net._impls[-1].loss(net.conf.confs[-1], out, y, lm)
            local = self._global_term(data, out, lm)
        extra = net._reg_score(p) + net._aux_score(new_state)
        if self._ndev != 1:
            extra = extra / self._ndev
        return local + extra, new_state

    def value_and_grad(self, params, state, rng, features, labels,
                       feature_mask, label_mask):
        """The network's ``_value_and_grad`` for one synchronous step
        over the mesh: (global score, this rank's gradients reduced over
        the data ranks, new layer state averaged over them)."""
        leaves = {si: {k: p.detach().requires_grad_(True)
                       for k, p in sub.items()}
                  for si, sub in params.items()}
        with torch.enable_grad(), parallel_scope(self._scope):
            local, new_state = self._local_loss(
                self._view(leaves), state, rng, features, labels,
                feature_mask, label_mask)
            flat = [p for sub in leaves.values() for p in sub.values()]
            gflat = torch.autograd.grad(local, flat, allow_unused=True)
        with torch.no_grad():
            keys = [(si, k) for si, sub in leaves.items() for k in sub]
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(flat, gflat)]
            dense, split = [], []
            for i, (si, k) in enumerate(keys):
                in_fsdp = (self.fsdp_axis
                           and self.fsdp_axis in _axes_of(self._specs[si][k]))
                (split if in_fsdp else dense).append(i)
            for idx, group in ((dense, self._data_group),
                               (split, self._dense_group)):
                red = reduce_tensors([grads[i] for i in idx], group)
                for i, g in zip(idx, red):
                    grads[i] = g
            out = {}
            for (si, k), g in zip(keys, grads):
                out.setdefault(si, {})[k] = g
            score = local.detach().clone()
            if self._data_group is not None:
                dist.all_reduce(score, group=self._data_group)
            new_state = tree_map(torch.Tensor.detach, new_state or {})
            if new_state and self._data_group is not None:
                new_state = tree_map(self._mean_over_data, new_state)
        return score, out, new_state

    def _mean_over_data(self, t):
        if not t.is_floating_point():
            return t
        t = t.clone()
        dist.all_reduce(t, group=self._data_group)
        return t / self._ndev

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def _trace_args(self, **extra):
        axes = {name: ax for name, ax in (
            ("dp", self.dp_axis if self.dp_axis in self.mesh.mesh_dim_names
             else None), ("tp", self.tp_axis), ("ep", self.ep_axis),
            ("fsdp", self.fsdp_axis), ("sp", self.sp_axis)) if ax}
        return mesh_args(self.mesh, "data", **axes, **extra)

    def _emit_step_span(self, dispatch_s: float, **extra) -> None:
        if self.tracer is not None:
            emit_step_span(self.tracer, dispatch_s,
                           self._trace_args(**extra))

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def fit(self, data, labels=None) -> float:
        """One (or more) global synchronous steps on the given GLOBAL
        batch (a DataSet, a MultiDataSet for a graph, or an iterator of
        them); returns the last step's global score."""
        from deeplearning4j_tpu_torch.datasets.dataset import (
            DataSet,
            MultiDataSet,
        )

        if labels is not None:
            data = DataSet(data, labels)
        batches = [data] if isinstance(data, (DataSet, MultiDataSet)) \
            else data
        score = float("nan")
        for ds in batches:
            if self.average_each_iteration:
                score = self._fit_sync(ds)
            else:
                score = self._fit_local_then_average(ds)
        return score

    def _fit_sync(self, ds) -> float:
        net = self.net
        x, y, fm, lm = self._local_batch(ds)
        feats = ds.features if not self.is_graph else (
            ds.features if not isinstance(ds.features, (list, tuple))
            else ds.features[0])
        examples, tokens = batch_counts(np.asarray(feats)
                                        if not isinstance(feats,
                                                          torch.Tensor)
                                        else feats)
        with self._hooked():
            dispatch_s = net._sgd_step(x, y, fm, lm, examples, tokens,
                                       self._grad_scale())
        self._emit_step_span(dispatch_s, iteration=net.iteration)
        return float(net.score_value)

    def _fit_local_then_average(self, ds) -> float:
        """K plain local steps on this rank's rows, then the params and
        updater state averaged over the data ranks (the reference's
        average-at-end)."""
        net = self.net
        x, y, fm, lm = self._local_batch(ds)
        t0 = time.perf_counter()
        params, state, upd = net.params, net.state, net.updater_state
        score = None
        for k in range(self.local_steps):
            params, state, upd, score, _ = net._step_body(
                params, state, upd, net.iteration + k, net._gen, x, y,
                fm, lm)
        with torch.no_grad():
            leaves = tree_leaves(params) + tree_leaves(upd)
            summed = reduce_tensors(leaves, self._data_group)
            n = float(self._ndev)
            it = iter([s / n if n != 1.0 else s for s in summed])
            net.params = tree_map(lambda _: next(it), params)
            net.updater_state = tree_map(lambda _: next(it), upd)
            net.state = state
            score = score.detach().clone()
            if self._data_group is not None:
                dist.all_reduce(score, group=self._data_group)
                score = score / n
        net.params_version += 1
        dispatch_s = time.perf_counter() - t0
        examples, tokens = batch_counts(np.asarray(ds.features))
        net.train_telemetry.record_step(
            dispatch_s=dispatch_s, steps=self.local_steps,
            examples=examples * self.local_steps,
            tokens=tokens * self.local_steps)
        self._emit_step_span(
            dispatch_s, steps=self.local_steps,
            iteration=net.iteration + self.local_steps,
            mode="local_then_average")
        net.score_value = score
        net.iteration += self.local_steps
        for listener in net.listeners:
            listener.iteration_done(net, net.iteration)
        return float(score)

    def _capturable(self) -> bool:
        return self.backend == "nccl" and self.net.device.type == "cuda"

    def fit_scan(self, features_stacked, labels_stacked,
                 features_mask_stacked=None, labels_mask_stacked=None):
        """K fused global steps over pre-stacked GLOBAL batches ([K, B,
        ...]; for a graph, dicts / lists of them), through the network's
        ``fit_scan``. Under NCCL each step replays one captured CUDA
        graph per key from ``self.train_graphs`` with the gradient
        all-reduces inside it; under gloo the steps run eagerly (gloo's
        collectives are host calls). Returns the K global scores."""
        if not self.average_each_iteration:
            raise ValueError(
                "fit_scan is the per-step-synchronous path; "
                "K-local-steps mode already fuses via local_steps")
        net = self.net
        t0 = time.perf_counter()
        x, y, fm, lm = self._local_batch(
            (features_stacked, labels_stacked, features_mask_stacked,
             labels_mask_stacked), stacked=True)
        saved = net.train_graphs
        net.train_graphs = self.train_graphs if self._capturable() else None
        try:
            with self._hooked():
                if self.is_graph:
                    scores = net.fit_scan(x, list(y), masks_stacked=fm,
                                          label_masks_stacked=lm,
                                          grad_scale=self._grad_scale())
                else:
                    scores = net.fit_scan(
                        x, y, features_mask_stacked=fm,
                        labels_mask_stacked=lm,
                        grad_scale=self._grad_scale())
        finally:
            net.train_graphs = saved
        lead = (next(iter(x.values())) if isinstance(x, dict) else x)
        self._emit_step_span(time.perf_counter() - t0,
                             steps=int(lead.shape[0]),
                             iteration=net.iteration, fused="scan")
        return scores

    # ------------------------------------------------------------------
    # sequence parallelism: which layers the time split admits
    # ------------------------------------------------------------------
    def _validate_sp(self, net) -> None:
        """sp_axis splits the TIME axis of [N, C, T] batches, so every
        layer must be time-splittable: attention cores run the
        ring/Ulysses schedule, LSTM/GRU recurrences a distributed
        ``sp_scan``, per-timestep layers (RnnOutputLayer, MoeDense,
        LayerNormalization) run on their chunk unchanged. Bidirectional
        LSTM and cross-time preprocessors cannot."""
        from deeplearning4j_tpu_torch.nn.conf.enums import (
            BackpropType,
            OptimizationAlgorithm,
        )
        from deeplearning4j_tpu_torch.nn.layers.attention import (
            ATTENTION_BEANS,
        )
        from deeplearning4j_tpu_torch.nn.layers.moe import MoeDense

        if self.sp_axis == self.dp_axis:
            raise ValueError(
                f"sp_axis {self.sp_axis!r} must name a mesh axis "
                "distinct from dp_axis: the batch axis shards over dp "
                "and the time axis over sp")
        if self.ep_axis or self.fsdp_axis:
            raise ValueError(
                "sp_axis composes with dp (batch/time axes) and tp, but "
                "not with ep/fsdp param sharding")
        first = (next(iter(net._layer_vertices.values())).conf
                 if self.is_graph else net.conf.confs[0])
        algo = first.optimization_algo
        if algo != OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            raise ValueError(
                f"sp_axis is a plain-SGD-family path (got {algo}); "
                "second-order solvers need unsharded line searches")
        if net.conf.backprop_type == BackpropType.TRUNCATED_BPTT:
            raise ValueError(
                "sp_axis replaces tBPTT as the long-sequence device: "
                "full-BPTT with the time axis sharded")
        shardable = ATTENTION_BEANS + (L.GravesLSTM, L.GRU)
        per_step = (L.RnnOutputLayer, MoeDense, L.LayerNormalization)
        if self.is_graph:
            self._validate_sp_graph(net, shardable, per_step)
            return
        for i, c in enumerate(net.conf.confs):
            lc = c.layer
            if net.conf.preprocessor_for(i) is not None:
                raise ValueError(
                    f"layer {i}: input preprocessors reshape across the "
                    "sharded time axis and are not supported under "
                    "sp_axis")
            if isinstance(lc, shardable):
                if lc.ring_axis != self.sp_axis:
                    raise ValueError(
                        f"layer {i}: {type(lc).__name__}.ring_axis="
                        f"{lc.ring_axis!r} must equal sp_axis="
                        f"{self.sp_axis!r} so the time axis runs "
                        "the sp schedule over the mesh's sp devices")
            elif not isinstance(lc, per_step):
                raise ValueError(
                    f"layer {i} ({type(lc).__name__}) is not "
                    "time-shardable: sp_axis supports "
                    "MultiHeadSelfAttention, TransformerBlock, "
                    "GravesLSTM, and GRU (each with "
                    "ring_axis=sp_axis), plus MoeDense, "
                    "LayerNormalization, and RnnOutputLayer")
        self._refuse_running_state(net, "layers")
        if not hasattr(net._impls[-1], "loss"):
            raise ValueError(
                "last layer must be an output layer to compute a score "
                f"(got {type(net.conf.confs[-1].layer).__name__})")

    def _validate_sp_graph(self, net, shardable, per_step) -> None:
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
            DuplicateToTimeSeriesVertex,
            LastTimeStepVertex,
            LayerVertex,
            PreprocessorVertex,
        )

        for name, vertex in net.conf.vertices.items():
            if isinstance(vertex, (LastTimeStepVertex, PreprocessorVertex,
                                   DuplicateToTimeSeriesVertex)):
                raise ValueError(
                    f"vertex {name!r} ({type(vertex).__name__}) "
                    "crosses the sharded time axis (global-timestep "
                    "gather / reshape / static-to-time broadcast) and "
                    "cannot run under sp_axis")
            if not isinstance(vertex, LayerVertex):
                continue
            if vertex.preprocessor is not None:
                raise ValueError(
                    f"vertex {name!r}: input preprocessors reshape "
                    "across the sharded time axis and are not "
                    "supported under sp_axis")
            lc = vertex.conf.layer
            if isinstance(lc, shardable):
                if lc.ring_axis != self.sp_axis:
                    raise ValueError(
                        f"vertex {name!r}: {type(lc).__name__}"
                        f".ring_axis={lc.ring_axis!r} must equal "
                        f"sp_axis={self.sp_axis!r} so the time axis "
                        "runs the sp schedule over the mesh's sp "
                        "devices")
            elif not isinstance(lc, per_step):
                raise ValueError(
                    f"vertex {name!r} ({type(lc).__name__}) is not "
                    "time-shardable: sp_axis graphs support "
                    "MultiHeadSelfAttention, TransformerBlock, "
                    "GravesLSTM, and GRU (each with "
                    "ring_axis=sp_axis), plus MoeDense, "
                    "LayerNormalization, and RnnOutputLayer vertices")
        self._refuse_running_state(net, "vertices")

    @staticmethod
    def _refuse_running_state(net, what: str) -> None:
        stateful = [
            si for si, st in (net.state or {}).items()
            if not (isinstance(st, dict) and set(st) <= {"aux_loss"})
        ]
        if stateful:
            raise ValueError(
                f"{what} {stateful} carry running state; sp_axis "
                f"supports stateless / aux-only-state {what}")

