"""MultiLayerNetwork: the sequential-stack network.

Port of ``deeplearning4j_tpu/nn/multilayer.py``: ``init`` (params and
updater state), the mixed-precision forward ``_forward_fn`` (with
``remat`` as activation checkpointing), ``output``, ``param_table``,
``set_param``, ``feed_forward``, ``predict``, ``evaluate``, training:
``fit`` (a ``DataSet``, features and labels, or an iterator of
``DataSet``), ``fit_scan`` (K steps over stacked batches, replayed on
the card from one captured CUDA graph of the train step), ``score``
and ``compute_gradient_and_score``, truncated BPTT (``_fit_tbptt``)
and greedy layer-wise ``pretrain`` (``optimize/pretrainer.py``), and
streaming: ``rnn_time_step``, ``rnn_clear_previous_state`` and
``generate``, whose decode scan runs on the card as one captured CUDA
graph per pow2 bucket (``nn/cuda_graphs.py``).
Parameters are plain ``{layer_index: {name: Tensor}}`` dicts with the
JAX package's keys, on the net's ``device``.

A train step is the JAX step written eagerly: forward and loss under
autograd (the compute-dtype cast of the f32 master params happens inside
autograd every step, so gradients land in f32 as through JAX's cast
transpose), ``torch.autograd.grad``, then per layer normalize -> updater
-> ``params - updates`` (new tensors, as JAX returns new arrays), and
the step's gradient-health scalars (``optimize/telemetry.py:
grad_health``). The loss adds each layer's l1/l2 penalty and the
auxiliary losses layers emit through the state channel (``MoeDense``'s
load-balancing loss, ``_aux_score``). Every parameter write bumps
``params_version``.

Dropout in ``fit`` draws from one ``torch.Generator`` per layer per
step, seeded from the net's host generator (JAX splits one key per
layer); ``fit_scan`` draws from one persistent generator per layer on
the net's device, which its captured graph registers. With dropout 0
(the flagship) trajectories match the JAX package; with dropout they
match only in distribution.

Truncated BPTT runs each window's step eagerly, the carried recurrent
state detached between windows. A conf whose ``optimization_algo`` is not
SGD trains through the line-search solvers (``optimize/solver.py``) over
the flat parameter vector (``params_flat``, in the JAX package's
``ravel_pytree`` order). Still out of the port: ``fit_stream`` (ROADMAP
Queue 1 item 10).

:class:`BaseNetwork` holds what ``MultiLayerNetwork`` and
``ComputationGraph`` share: the train step under autograd, the captured
``fit_scan`` window, the flat-parameter surface and the listeners.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.enums import (
    BackpropType,
    OptimizationAlgorithm,
)
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.cuda_graphs import GraphRunner
from deeplearning4j_tpu_torch.nn.gradient import Gradient
from deeplearning4j_tpu_torch.nn.layers import get_impl
from deeplearning4j_tpu_torch.nn.layers.attention import guard_streamable
from deeplearning4j_tpu_torch.nn.streaming import (
    make_bucketed_generate,
    reset_streaming_state,
    scan_length_bucket,
    tree_map,
)
from deeplearning4j_tpu_torch.nn.updater.updaters import (
    make_layer_updater,
    normalize_gradients,
    resolve_lr,
)
from deeplearning4j_tpu_torch.optimize.listeners import fire_crossed
from deeplearning4j_tpu_torch.optimize.telemetry import (
    HEALTH_KEYS,
    TrainTelemetry,
    batch_counts,
    grad_health,
    window_counts,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def _dtype_of(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(
            f"unknown dtype {name!r} (dtype/compute_dtype accepts "
            f"{sorted(_DTYPES)})")
    return _DTYPES[name]


def _cast_floating(a, dtype):
    """Cast floating tensors, leave ints/bools (masks, indices) alone."""
    if isinstance(a, torch.Tensor) and a.is_floating_point():
        return a.to(dtype)
    return a


def _cast_tree(tree, dtype):
    return tree_map(lambda a: _cast_floating(a, dtype), tree)


def _detach_tree(tree):
    return tree_map(torch.Tensor.detach, tree)


def _layer_generator(seed: Optional[int], device):
    """A layer's dropout generator for one step (None at inference)."""
    if seed is None:
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _sorted_leaves(tree) -> list:
    """The tensors of a nested dict in ``jax.flatten_util.ravel_pytree``'s
    order: at every level the keys sorted as strings (so layers go "0",
    "1", "10", "2", ...; a graph's vertices by name)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in
                _sorted_leaves(tree[k])]
    return [tree]


def ravel_params(params) -> torch.Tensor:
    """One flat vector of every parameter, in the JAX package's
    ``ravel_pytree`` order (:func:`_sorted_leaves`)."""
    leaves = _sorted_leaves(params)
    if not leaves:
        return torch.zeros((0,))
    return torch.cat([p.reshape(-1) for p in leaves])


def unravel_params(like, flat: torch.Tensor):
    """A params tree shaped like ``like`` whose leaves are views of
    ``flat`` (:func:`ravel_params`'s inverse; gradients flow back to
    ``flat``)."""
    offset = 0

    def take(tree):
        nonlocal offset
        if isinstance(tree, dict):
            return {k: take(tree[k]) for k in sorted(tree)}
        n = tree.numel()
        leaf = flat[offset:offset + n].view(tree.shape)
        offset += n
        return leaf

    out = take(like)
    if offset != flat.numel():
        raise ValueError(f"flat vector of {flat.numel()} values for "
                         f"{offset} parameters")
    # the caller's key order, not the sorted one
    return _reorder_like(like, out)


def _reorder_like(like, tree):
    if isinstance(like, dict):
        return {k: _reorder_like(v, tree[k]) for k, v in like.items()}
    return tree


#: the weights l1/l2 apply to (the LSTMs' recurrent and backward ones
#: too)
_REGULARIZED_KEYS = ("W", "RW", "W_bwd", "RW_bwd")


def layer_reg_score(c, layer_params):
    """l1/l2 penalty of ONE layer's params."""
    if not c.use_regularization:
        return 0.0
    l1 = float(c.resolved("l1") or 0.0)
    l2 = float(c.resolved("l2") or 0.0)
    if l1 == 0.0 and l2 == 0.0:
        return 0.0
    reg = 0.0
    for name, p in layer_params.items():
        if name not in _REGULARIZED_KEYS:
            continue
        if l1:
            reg = reg + l1 * p.abs().sum()
        if l2:
            reg = reg + 0.5 * l2 * (p * p).sum()
    return reg


def layer_update(c, updater, grads, upd_state, iteration: int,
                 grad_scale=1.0, scalars=None):
    """normalize -> scale -> updater rule for ONE layer; returns
    (updates, new_state) and the caller applies ``params - updates``.

    ``grad_scale`` multiplies the normalized gradients, as in JAX (the
    data-parallel ACCUM_GRADIENT sum; 1.0 normally, and then skipped:
    a product with 1 changes no bit); a float32 0-dim tensor in a
    captured step. ``scalars`` are the rule's per-step scalars
    (``LayerUpdater.step_scalars``); None computes them on the host from
    ``iteration`` and the lr schedule."""
    g = normalize_gradients(
        c.resolved("gradient_normalization"), grads,
        float(c.resolved("gradient_normalization_threshold")))
    if isinstance(grad_scale, torch.Tensor) or grad_scale != 1.0:
        g = tree_map(lambda a: a * grad_scale, g)
    if scalars is None:
        scalars = updater.step_scalars(resolve_lr(c, iteration), iteration)
    return updater.apply(g, upd_state, scalars)


class BaseNetwork:
    """The training machinery ``MultiLayerNetwork`` and
    ``ComputationGraph`` share. A subclass provides ``_loss_fn(params,
    state, rng, inputs, labels, masks, label_masks, rnn_state=None) ->
    (score, new_state, new_rnn_state)``, :meth:`_units` (its trainable
    units in updater order) and :meth:`_dropout_order` (the units whose
    dropout generators ``rng`` lists), and holds ``params``, ``state``,
    ``updater_state``, ``iteration``, ``listeners``, ``train_graphs``,
    ``params_version``, ``device`` and the host generator ``_gen``."""

    def _units(self) -> list:
        """[(params key, conf, updater)] in updater order."""
        raise NotImplementedError

    def _dropout_order(self) -> list:
        """The params keys whose dropout generators a list ``rng``
        holds, in order."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # The train step
    # ------------------------------------------------------------------
    def _value_and_grad(self, params, state, rng, features, labels,
                        feature_mask, label_mask):
        """(score, grads, new_state) of the loss from each layer's
        initial carry (:meth:`_grads`)."""
        score, grads, new_state, _ = self._grads(
            params, state, rng, features, labels, feature_mask, label_mask)
        return score, grads, new_state

    def _grads(self, params, state, rng, features, labels, feature_mask,
               label_mask, rnn_state=None):
        """(score, grads, new_state, new_rnn_state): the loss under
        autograd at requires-grad aliases of ``params`` (no copy),
        differentiated with ``torch.autograd.grad``; a param the loss
        does not reach gets a zero gradient. The states come out
        detached: a carried recurrent state passes no gradient into the
        next truncated-BPTT window."""
        leaves = {si: {k: p.detach().requires_grad_(True)
                       for k, p in sub.items()}
                  for si, sub in params.items()}
        with torch.enable_grad():
            score, new_state, new_rnn = self._loss_fn(
                leaves, state, rng, features, labels, feature_mask,
                label_mask, rnn_state)
            flat = [p for sub in leaves.values() for p in sub.values()]
            gflat = torch.autograd.grad(score, flat, allow_unused=True)
        it = iter(gflat)
        grads = {}
        for si, sub in leaves.items():
            grads[si] = {}
            for k, p in sub.items():
                g = next(it)
                grads[si][k] = torch.zeros_like(p) if g is None else g
        return (score.detach(), grads, _detach_tree(new_state),
                _detach_tree(new_rnn))

    def _apply_updates(self, params, upd_state, grads, iteration,
                       grad_scale=1.0, scalars=None):
        """Per unit (layer or layer vertex, :meth:`_units`) normalize ->
        scale -> updater -> subtract; ``scalars`` is None (each unit's
        from ``iteration``) or one dict per unit in :meth:`_units`
        order (see :func:`layer_update`)."""
        new_params, new_upd = {}, {}
        with torch.no_grad():
            for i, (key, c, upd) in enumerate(self._units()):
                updates, new_upd[key] = layer_update(
                    c, upd, grads[key], upd_state[key], iteration,
                    grad_scale, None if scalars is None else scalars[i])
                new_params[key] = {k: p - updates[k]
                                   for k, p in params[key].items()}
        # in the params' own key order, which the health scalars and a
        # captured step's outputs pair leaf by leaf with the inputs
        return ({k: new_params[k] for k in params},
                {k: new_upd[k] for k in upd_state})

    def _step_body(self, params, state, upd_state, iteration, rng,
                   features, labels, feature_mask, label_mask,
                   grad_scale=1.0, scalars=None):
        """One SGD step; returns (new_params, new_state, new_upd_state,
        score, health): the gradient-health scalars come out of every
        step (:func:`grad_health`), fetched only by a consumer."""
        score, grads, new_state = self._value_and_grad(
            params, state, rng, features, labels, feature_mask, label_mask)
        new_params, new_upd = self._apply_updates(
            params, upd_state, grads, iteration, grad_scale, scalars)
        with torch.no_grad():
            health = grad_health(grads, params, new_params)
        return new_params, new_state, new_upd, score, health

    def _tensor(self, a, dtype=None):
        if a is None:
            return None
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _tbptt_step(self, params, state, upd_state, iteration, rng, f, y,
                    fm, lm, rnn_state):
        """One window: (new_params, new_state, new_upd_state,
        new_rnn_state, score, health)."""
        score, grads, new_state, new_rnn = self._grads(
            params, state, rng, f, y, fm, lm, rnn_state)
        new_params, new_upd = self._apply_updates(params, upd_state, grads,
                                                  iteration)
        with torch.no_grad():
            health = grad_health(grads, params, new_params)
        return new_params, new_state, new_upd, new_rnn, score, health

    def _pretrain_generator(self) -> torch.Generator:
        """The generator of pretraining's draws, on the net's device,
        seeded once from the net's host generator."""
        if self._pretrain_gen is None:
            seed = int(torch.randint(0, 2 ** 62, (1,),
                                     generator=self._gen))
            self._pretrain_gen = _layer_generator(seed, self.device)
        return self._pretrain_gen

    def _scan_window(self, key, k: int, batch_at, start: int,
                     grad_scale: float):
        """The step loop of ``fit_scan``: ``k`` steps from iteration
        ``start``, step j's batch ``batch_at(j)`` = {x, y, fm, lm}; on
        the card each step replays the captured graph of ``key`` (see
        ``MultiLayerNetwork.fit_scan``). Sets the params, state and
        updater state after the window and returns (scores [k], health
        [k, 4])."""
        layout, table = self._window_scalars(start, k)
        gens = self._scan_generators()
        graphs = self.train_graphs
        key = key + (tuple(tuple(names) for names in layout),)
        ops = {"params": self.params, "state": self.state,
               "upd": self.updater_state, "grad_scale": torch.full(
                   (), float(grad_scale), dtype=torch.float32,
                   device=self.device)}
        fresh = graphs is not None and key not in graphs
        scores = health = None

        def body(o):
            return self._scan_step(o, layout, gens)

        with torch.no_grad():
            for j in range(k):
                ops.update(batch_at(j), scalars=table[j])
                if fresh:
                    # a capture's tensors become the graph's static
                    # inputs, which later steps overwrite: never the
                    # net's params or the caller's batches
                    ops, fresh = tree_map(torch.clone, ops), False
                res = (body(ops) if graphs is None
                       else graphs.run(key, body, ops))
                if scores is None:
                    scores = torch.empty((k,), dtype=res["score"].dtype,
                                         device=self.device)
                    health = torch.empty((k, len(HEALTH_KEYS)),
                                         dtype=torch.float32,
                                         device=self.device)
                scores[j].copy_(res["score"])
                health[j].copy_(res["health"])
                ops.update(params=res["params"], state=res["state"],
                           upd=res["upd"])
                self.params_version += 1
                self.iteration += 1
        carry = {"params": ops["params"], "state": ops["state"],
                 "upd": ops["upd"]}
        if graphs is not None and key in graphs:
            # the graph's outputs are overwritten by its next replay
            carry = tree_map(torch.clone, carry)
        self.params, self.state, self.updater_state = (
            carry["params"], carry["state"], carry["upd"])
        return scores, health

    def _scan_step(self, ops, layout, gens):
        """One ``fit_scan`` step over ``ops`` = {params, state, upd, x,
        y, fm, lm, scalars: the step's [S] row of the window table,
        grad_scale: f32 0-dim}, the body of the captured graph and of
        the eager run alike: it reads nothing back to the host. Returns
        the new params, state and updater state, the score and the [4]
        health row."""
        row = ops["scalars"]
        scalars, col = [], 0
        for names in layout:
            scalars.append({name: row[col + n]
                            for n, name in enumerate(names)})
            col += len(names)
        params, state, upd, score, health = self._step_body(
            ops["params"], ops["state"], ops["upd"], None, gens,
            ops["x"], ops["y"], ops["fm"], ops["lm"], ops["grad_scale"],
            scalars)
        return {"params": params, "state": state, "upd": upd,
                "score": score,
                "health": torch.stack([health[n] for n in HEALTH_KEYS])}

    def _window_scalars(self, start: int, k: int):
        """The per-step updater scalars of steps ``start`` .. ``start +
        k - 1``: (layout, one list of names per layer; table, float32
        [k, S] on the device, row j the names' values at step start + j
        in layout order), computed on the host as ``fit`` computes them
        and uploaded in one copy."""
        layout, rows = None, []
        for it in range(start, start + k):
            per = [upd.step_scalars(resolve_lr(c, it), it)
                   for _, c, upd in self._units()]
            if layout is None:
                layout = [list(sc) for sc in per]
            rows.append([v for sc in per for v in sc.values()])
        host = torch.from_numpy(np.asarray(rows, dtype=np.float32))
        if self.device.type == "cuda":
            # pinned, so the copy neither waits for the device nor
            # races a later window (the caching host allocator keeps the
            # block until the copy has run)
            return layout, host.pin_memory().to(self.device,
                                                non_blocking=True)
        return layout, host.to(self.device)

    def _scan_generators(self) -> List[torch.Generator]:
        """``fit_scan``'s per-unit dropout generators on the net's
        device (in :meth:`_dropout_order`), seeded once from the net's
        host generator and registered with ``train_graphs``, so a replay
        draws fresh masks."""
        if self._scan_gens is None:
            seeds = torch.randint(0, 2 ** 62, (len(self._dropout_order()),),
                                  generator=self._gen).tolist()
            self._scan_gens = [_layer_generator(sd, self.device)
                               for sd in seeds]
        if self.train_graphs is not None:
            self.train_graphs.generators = tuple(self._scan_gens)
        return self._scan_gens

    def _fire_listeners(self) -> None:
        """After one step: each listener whose cadence the iteration
        meets."""
        for listener in self.listeners:
            if listener.invoked_every <= 1 or (
                    self.iteration % listener.invoked_every == 0):
                listener.iteration_done(self, self.iteration)

    def set_listeners(self, *listeners) -> None:
        self.listeners = list(listeners)

    def add_listener(self, listener) -> None:
        self.listeners.append(listener)

    # ------------------------------------------------------------------
    # Parameter pack/unpack (reference params() :984-1063)
    # ------------------------------------------------------------------
    def params_flat(self) -> torch.Tensor:
        """Every parameter in one new flat tensor on the net's device, in
        the JAX package's ``ravel_pytree`` order (keys sorted as strings
        at every level), so a JAX flat vector lands on the same
        parameters through :meth:`set_params_flat`."""
        self.init()
        return ravel_params(self.params)

    def set_params_flat(self, flat) -> None:
        """Set every parameter from a flat vector in :meth:`params_flat`'s
        order (each parameter a copy, cast to the master dtype on the
        net's device)."""
        self.init()
        flat = torch.as_tensor(flat, dtype=self._dtype, device=self.device)
        self.params = tree_map(torch.clone,
                               unravel_params(self.params, flat))
        self.params_version += 1

    def num_params(self) -> int:
        self.init()
        return sum(p.numel() for p in _sorted_leaves(self.params))


class MultiLayerNetwork(BaseNetwork):
    """Sequential network over layer conf beans, on ``device`` (default
    ``"cuda"``; raises when CUDA is absent, so pass ``device="cpu"`` to
    run on the CPU)."""

    def __init__(self, conf: MultiLayerConfiguration, device="cuda"):
        self.device = resolve_device(device)
        self.conf = conf
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        self.state: Dict[str, Any] = {}
        self.updater_state: Dict[str, Any] = {}
        self.iteration = 0
        self.score_value: Any = float("nan")
        self.listeners: List = []
        #: host-side per-step phase clock, stamped by every fit path
        self.train_telemetry = TrainTelemetry()
        self._impls = [get_impl(c.layer) for c in conf.confs]
        self._updaters = [make_layer_updater(c) for c in conf.confs]
        self._initialized = False
        #: bumped by every parameter write (set_param, fit, a restore);
        #: the compute-dtype copy ``output()`` uses is rebuilt when it
        #: moves
        self.params_version = 0
        self._dtype = _dtype_of(conf.dtype)
        cd = _dtype_of(conf.compute_dtype) if conf.compute_dtype else None
        self._compute_dtype = cd if cd != self._dtype else None
        self._cast_cache = (None, None)
        #: seeds each step's per-layer dropout generators
        self._gen = torch.Generator()
        self._gen.manual_seed(int(conf.seed))
        #: the carried streaming state of ``rnn_time_step``/``generate``
        self._rnn_state: Dict[str, Any] = {}
        #: ``generate``'s captured decode graphs, one per (bucket, batch,
        #: dtype, params version); dropped when ``params_version`` moves
        self.generate_graphs = GraphRunner()
        self._graphs_version = self.params_version
        #: ``fit_scan``'s captured train steps, one per (batch shapes,
        #: dtype, masks, updater layout); None runs the step eagerly on
        #: any device (a private switch for checks on the card)
        self.train_graphs: Optional[GraphRunner] = GraphRunner()
        #: ``fit_scan``'s per-layer dropout generators on the device,
        #: made at its first call
        self._scan_gens: Optional[List[torch.Generator]] = None
        #: the draws of ``pretrain`` (RBM CD-k, autoencoder corruption),
        #: made at its first call
        self._pretrain_gen: Optional[torch.Generator] = None

    def init(self) -> "MultiLayerNetwork":
        """Draw every layer's parameters from one ``torch.Generator`` on
        the net's device seeded with the conf's seed (the numbers differ
        from the JAX package's; load a model zip to match it), and build
        each layer's updater state on the device."""
        if self._initialized:
            return self
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.conf.seed))
        for i, (c, impl) in enumerate(zip(self.conf.confs, self._impls)):
            self.params[str(i)] = impl.init(gen, c, self._dtype,
                                            self.device)
            st = impl.init_state(c, self._dtype, self.device)
            if st is not None:
                self.state[str(i)] = st
        for i, upd in enumerate(self._updaters):
            self.updater_state[str(i)] = upd.init(self.params[str(i)])
        self._initialized = True
        self.params_version += 1
        return self

    @property
    def n_layers(self) -> int:
        return len(self.conf.confs)

    def _units(self) -> list:
        return [(str(i), c, upd) for i, (c, upd) in
                enumerate(zip(self.conf.confs, self._updaters))]

    def _dropout_order(self) -> list:
        return [str(i) for i in range(self.n_layers)]

    def _out_f32(self) -> bool:
        # the output layer always runs at the master dtype: a bf16
        # softmax quantizes probabilities too coarsely
        return (self._compute_dtype is not None
                and isinstance(self.conf.confs[-1].layer,
                               L.BaseOutputLayer))

    def _compute_params(self, params):
        """Params at the compute dtype (the output layer stays at the
        master dtype). Outside autograd the cast of ``self.params`` is
        cached until the next parameter write; under autograd (training)
        the cast is rebuilt on every call, so its gradient flows back to
        the f32 master params."""
        cd = self._compute_dtype
        if cd is None:
            return params
        cacheable = params is self.params and not torch.is_grad_enabled()
        if cacheable:
            version, cast = self._cast_cache
            if version == self.params_version:
                return cast
        last = str(self.n_layers - 1)
        out_f32 = self._out_f32()
        cast = {si: (sub if (out_f32 and si == last)
                     else _cast_tree(sub, cd))
                for si, sub in params.items()}
        if cacheable:
            self._cast_cache = (self.params_version, cast)
        return cast

    def _forward_fn(self, params, state, x, rng, train: bool,
                    feature_mask=None, rnn_state=None, collect=False):
        """Returns (final activations, new_state, new_rnn_state); with
        ``collect`` the first is the list of every layer's activations.

        Mixed precision as in the JAX package: compute-dtype params and
        input, except the output layer, which runs at the master dtype;
        carried streaming state is cast back to the master dtype (which
        is why the paged KV pool is float32 while the queries are
        bfloat16 under ``compute_dtype="bfloat16"``).

        ``rng`` (training only) is a host ``torch.Generator`` that seeds
        one dropout generator per layer (``fit``), or a list of one
        persistent generator per layer on the device (``fit_scan``).
        With ``conf.remat`` each layer's apply runs under
        ``torch.utils.checkpoint`` (its activations are recomputed in
        the backward; the layer's generator is rebuilt from its seed, or
        a persistent one rewound to its state before the layer, so the
        rerun draws the same dropout mask)."""
        cd = self._compute_dtype
        out_f32 = self._out_f32()
        last_si = str(self.n_layers - 1)
        params = self._compute_params(params)
        if cd is not None:
            x = _cast_floating(x, cd)
        seeds = [None] * self.n_layers
        gens = [None] * self.n_layers
        if train and isinstance(rng, torch.Generator):
            seeds = torch.randint(0, 2 ** 62, (self.n_layers,),
                                  generator=rng).tolist()
        elif train and rng is not None:
            gens = list(rng)
        remat = bool(self.conf.remat) and train and torch.is_grad_enabled()
        acts = []
        new_state = dict(state) if state else {}
        new_rnn = {}
        for i, (c, impl) in enumerate(zip(self.conf.confs, self._impls)):
            si = str(i)
            pp = self.conf.preprocessor_for(i)
            if pp is not None:
                x = pp.pre_process(
                    x, gens[i] or _layer_generator(seeds[i], x.device)
                    if train else None)
            layer_state = None
            if state and si in state:
                layer_state = state[si]
            elif rnn_state and si in rnn_state:
                layer_state = rnn_state[si]
            is_recurrent = isinstance(c.layer, L.RECURRENT_LAYER_TYPES)
            mask = feature_mask if is_recurrent else None
            if out_f32 and si == last_si:
                x = _cast_floating(x, self._dtype)

            gen_state = None
            if remat and gens[i] is not None and impl.dropout_of(c) > 0:
                if (gens[i].device.type == "cuda"
                        and torch.cuda.is_current_stream_capturing()):
                    raise NotImplementedError(
                        "fit_scan with remat and dropout is not captured "
                        "into a CUDA graph (a persistent generator cannot "
                        "be rewound for the recompute under capture)")
                gen_state = gens[i].get_state()

            def apply(p, xin, _c=c, _impl=impl, _lst=layer_state,
                      _seed=seeds[i], _gen=gens[i], _gst=gen_state,
                      _mask=mask):
                if _gst is not None:
                    _gen.set_state(_gst)   # the recompute redraws
                gen = _gen or _layer_generator(_seed, xin.device)
                return _impl.apply(_c, p, xin, state=_lst, train=train,
                                   rng=gen, mask=_mask)

            if remat:
                x, st = checkpoint(apply, params[si], x, use_reentrant=False)
            else:
                x, st = apply(params[si], x)
            if st is not None:
                if cd is not None:
                    st = _cast_tree(st, self._dtype)
                if state and si in state:
                    new_state[si] = st
                else:
                    new_rnn[si] = st
            if collect:
                acts.append(x)
        return (acts if collect else x), new_state, new_rnn

    def _loss_fn(self, params, state, rng, features, labels, feature_mask,
                 label_mask, rnn_state=None):
        """(score, new_state, new_rnn_state) of the training forward from
        the carried recurrent state ``rnn_state`` (None: each layer's
        initial carry)."""
        out, new_state, new_rnn = self._forward_fn(
            params, state, features, rng, True, feature_mask,
            rnn_state=rnn_state)
        impl = self._impls[-1]
        if not hasattr(impl, "loss"):
            raise ValueError(
                "Last layer must be an output layer to compute a score")
        if self._compute_dtype is not None:
            out = _cast_floating(out, self._dtype)  # loss in f32
        score = impl.loss(self.conf.confs[-1], out, labels, label_mask)
        score = score + self._reg_score(params)
        score = score + self._aux_score(new_state)
        return score, new_state, new_rnn

    def _reg_score(self, params):
        reg = 0.0
        for i, c in enumerate(self.conf.confs):
            reg = reg + layer_reg_score(c, params[str(i)])
        return reg

    def _aux_score(self, new_state):
        """The auxiliary training losses layers emit through the state
        channel (``MoeDense``'s load-balancing loss), each weighted by
        its conf's ``aux_weight``."""
        aux = 0.0
        for i, c in enumerate(self.conf.confs):
            w = getattr(c.layer, "aux_weight", None)
            st = new_state.get(str(i)) if new_state else None
            if w and st and "aux_loss" in st:
                aux = aux + w * st["aux_loss"]
        return aux

    # ------------------------------------------------------------------
    # Public training API
    # ------------------------------------------------------------------
    def fit(self, data, labels=None) -> None:
        """fit(DataSet) / fit(features, labels) / fit(iterable of
        DataSet)."""
        self.init()
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet

        if labels is not None:
            self._fit_batch(DataSet(data, labels))
        elif isinstance(data, DataSet):
            self._fit_batch(data)
        else:
            if self.conf.pretrain:
                self.pretrain(data)
                data.reset()
            if self.conf.backprop:
                it = iter(data)
                while True:
                    t0 = time.perf_counter()
                    ds = next(it, None)
                    self.train_telemetry.add_data_wait(
                        time.perf_counter() - t0)
                    if ds is None:
                        break
                    self._fit_batch(ds)

    def _fit_batch(self, ds) -> None:
        if self.conf.backprop_type == BackpropType.TRUNCATED_BPTT:
            self._fit_tbptt(ds)
            return
        algo = self.conf.confs[0].optimization_algo
        if algo != OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            from deeplearning4j_tpu_torch.optimize.solver import Solver

            Solver(self).optimize(ds)
            return
        n_iter = max(1, self.conf.confs[0].num_iterations)
        feats = self._tensor(ds.features, self._dtype)
        labels = self._tensor(ds.labels, self._dtype)
        fm = self._tensor(ds.features_mask)
        lm = self._tensor(ds.labels_mask)
        examples, tokens = batch_counts(feats)
        for _ in range(n_iter):
            t0 = time.perf_counter()
            (self.params, self.state, self.updater_state,
             score, health) = self._step_body(
                self.params, self.state, self.updater_state,
                self.iteration, self._gen, feats, labels, fm, lm)
            self.params_version += 1
            self.train_telemetry.record_step(
                dispatch_s=time.perf_counter() - t0, examples=examples,
                tokens=tokens, health=health)
            self.score_value = score
            self.iteration += 1
            self._fire_listeners()

    def _fit_tbptt(self, ds) -> None:
        """Truncated BPTT (reference doTruncatedBPTT :1262-1320): the
        time axis in windows of ``tbptt_fwd_length``, one train step a
        window, the recurrent state carried from window to window
        detached (no gradient crosses a window's start). Each window's
        step runs eagerly."""
        length = self.conf.tbptt_fwd_length
        feats = self._tensor(ds.features, self._dtype)
        labels = self._tensor(ds.labels, self._dtype)
        fm = self._tensor(ds.features_mask)
        lm = self._tensor(ds.labels_mask)
        rnn_state = None
        for start in range(0, feats.shape[2], length):
            end = min(start + length, feats.shape[2])
            fw, lw = feats[:, :, start:end], labels[:, :, start:end]
            fmw = None if fm is None else fm[:, start:end]
            lmw = None if lm is None else lm[:, start:end]
            t0 = time.perf_counter()
            (self.params, self.state, self.updater_state, rnn_state,
             score, health) = self._tbptt_step(
                self.params, self.state, self.updater_state,
                self.iteration, self._gen, fw, lw, fmw, lmw, rnn_state)
            self.params_version += 1
            self.train_telemetry.record_step(
                dispatch_s=time.perf_counter() - t0,
                examples=int(fw.shape[0]),
                tokens=int(fw.shape[0]) * int(fw.shape[2]), health=health)
            self.score_value = score
            self.iteration += 1
            for listener in self.listeners:
                listener.iteration_done(self, self.iteration)

    def pretrain(self, data_iter) -> None:
        """Greedy layer-wise pretraining of the RBM / autoencoder layers
        (reference pretrain :150; ``optimize/pretrainer.py``)."""
        self.init()
        from deeplearning4j_tpu_torch.optimize.pretrainer import (
            pretrain_network,
        )

        pretrain_network(self, data_iter)

    def fit_scan(self, features_stacked, labels_stacked,
                 features_mask_stacked=None, labels_mask_stacked=None,
                 grad_scale: float = 1.0) -> torch.Tensor:
        """K train steps over pre-stacked batches ([K, B, ...] features
        and labels, optional [K, B, T] masks), one after another on the
        device with no host sync; returns the K per-step scores as one
        tensor. ``grad_scale`` multiplies the normalized gradients (JAX's
        ACCUM_GRADIENT sum; see :func:`layer_update`). The K steps' health
        scalars go to ``train_telemetry`` as [K] tensors. Listeners fire
        once per call (``fire_crossed``). The SGD path only: tBPTT and
        second-order solvers raise, as in JAX.

        On the card the step replays one captured CUDA graph per key
        (batch shapes, dtype, masks present, updater layout), held in
        ``train_graphs``: each step copies its batch into the graph's
        static inputs, and the window's per-step scalars (learning
        rate, Adam's lr times bias correction, momentum) go up once, as
        a float32 [K, S] table computed on the host in float64 exactly
        as ``fit`` computes them, so the params after a window are those
        of the eager loop bit for bit. On the CPU the same step runs
        eagerly. A graph holds the conf as it was captured: after
        changing a conf bean, ``train_graphs.drop()``."""
        if self.conf.backprop_type == BackpropType.TRUNCATED_BPTT:
            raise ValueError(
                "fit_scan is the full-BPTT SGD fast path; truncated-BPTT "
                "configs train through fit()")
        algo = self.conf.confs[0].optimization_algo
        if algo != OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            raise ValueError(
                f"fit_scan only supports SGD, not {algo}; use fit()")
        self.init()
        feats = self._tensor(features_stacked, self._dtype)
        labels = self._tensor(labels_stacked, self._dtype)
        fms = self._tensor(features_mask_stacked)
        lms = self._tensor(labels_mask_stacked)
        start = self.iteration
        t0 = time.perf_counter()
        key = (tuple(feats.shape[1:]), tuple(labels.shape[1:]),
               feats.dtype, None if fms is None else tuple(fms.shape[1:]),
               None if lms is None else tuple(lms.shape[1:]))
        scores, health = self._scan_window(
            key, int(feats.shape[0]),
            lambda j: dict(x=feats[j], y=labels[j],
                           fm=None if fms is None else fms[j],
                           lm=None if lms is None else lms[j]),
            start, grad_scale)
        k, examples, tokens = window_counts(feats.shape)
        self.train_telemetry.record_step(
            dispatch_s=time.perf_counter() - t0, steps=k,
            examples=examples, tokens=tokens,
            health={name: health[:, i] for i, name in
                    enumerate(HEALTH_KEYS)})
        self.score_value = scores[-1]
        fire_crossed(self.listeners, self, start, self.iteration)
        return scores

    def score(self, ds=None) -> float:
        """The last training score, or the loss (plus regularization) of
        ``ds`` under the inference forward."""
        if ds is None:
            return float(self.score_value)
        self.init()
        feats = self._tensor(ds.features, self._dtype)
        labels = self._tensor(ds.labels, self._dtype)
        fm = self._tensor(ds.features_mask)
        lm = self._tensor(ds.labels_mask)
        with torch.no_grad():
            out, _, _ = self._forward_fn(self.params, self.state, feats,
                                         None, False, fm)
            if self._compute_dtype is not None:
                out = _cast_floating(out, self._dtype)  # loss in f32
            s = self._impls[-1].loss(self.conf.confs[-1], out, labels, lm)
            s = s + self._reg_score(self.params)
        return float(s)

    def compute_gradient_and_score(self, ds) -> Tuple[float, Gradient]:
        """Score and per-parameter gradient of ``ds`` under the training
        forward, without updating (reference computeGradientAndScore)."""
        self.init()
        score, grads, _ = self._value_and_grad(
            self.params, self.state, None,
            self._tensor(ds.features, self._dtype),
            self._tensor(ds.labels, self._dtype),
            self._tensor(ds.features_mask), self._tensor(ds.labels_mask))
        return float(score), Gradient.from_tree(grads)

    # ------------------------------------------------------------------
    # Inference and parameters
    # ------------------------------------------------------------------
    def output(self, x, train: bool = False) -> torch.Tensor:
        """Forward pass on [N, C], [N, C, H, W] or [N, C, T] input;
        returns the last layer's activations as a tensor on the net's
        device."""
        self.init()
        x = torch.as_tensor(x, dtype=self._dtype, device=self.device)
        with torch.no_grad():
            y, _, _ = self._forward_fn(self.params, self.state, x, None,
                                       False)
        return y

    def feed_forward(self, x, train: bool = False) -> List[torch.Tensor]:
        """All layer activations, input first (reference feedForward)."""
        self.init()
        x = torch.as_tensor(x, dtype=self._dtype, device=self.device)
        with torch.no_grad():
            acts, _, _ = self._forward_fn(self.params, self.state, x, None,
                                          False, collect=True)
        return [x] + acts

    def predict(self, x) -> np.ndarray:
        """Argmax class predictions (reference Classifier.predict)."""
        return self.output(x).argmax(dim=1).cpu().numpy()

    def evaluate(self, data_iter):
        """Classification metrics over an iterable of ``DataSet``: each
        batch's output comes back to the host as float32 numpy and
        accumulates into one :class:`Evaluation`."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

        self.init()
        ev = Evaluation()
        for ds in data_iter:
            out = self.output(ds.features).float().cpu().numpy()
            if ds.labels_mask is not None or (
                    np.asarray(ds.labels).ndim == 3):
                ev.eval_time_series(ds.labels, out, ds.labels_mask)
            else:
                ev.eval(ds.labels, out)
        return ev

    # ------------------------------------------------------------------
    # Streaming (reference rnnTimeStep, rnnClearPreviousState)
    # ------------------------------------------------------------------
    def _stream_step(self, x, rnn):
        """(out, new_rnn) of one streaming forward from ``rnn``."""
        out, _, new_rnn = self._forward_fn(self.params, self.state, x, None,
                                           False, rnn_state=rnn or None)
        return out, new_rnn

    def rnn_time_step(self, x) -> torch.Tensor:
        """Stateful single/multi-step inference carrying the attention
        KV caches and the recurrent layers' ``(h, c)`` / ``h`` between
        calls (reference rnnTimeStep). ``x`` is [N, C] (one step) or
        [N, C, T]; returns the output [N, n_out, T]. A first call
        prefills (K1 for an unmasked T >= ``FLASH_MIN_T`` on the card);
        later calls continue through ``AttentionImpl._stream_attend``
        and from each recurrent layer's carry."""
        self.init()
        guard_streamable(
            (str(i), c.layer) for i, c in enumerate(self.conf.confs))
        x = torch.as_tensor(x, dtype=self._dtype, device=self.device)
        if x.ndim == 2:
            x = x[:, :, None]
        with torch.no_grad():
            out, self._rnn_state = self._stream_step(x, self._rnn_state)
        return out

    def rnn_clear_previous_state(self, slots=None) -> None:
        """Reset streaming state (reference rnnClearPreviousState).
        ``slots=None`` wipes the whole batch; ``slots=[...]`` zeroes only
        those batch rows, in place (``nn/streaming.py``: a zeroed
        attention row is the empty-cache state, a zeroed recurrent row
        the initial carry)."""
        self._rnn_state = reset_streaming_state(self._rnn_state, slots)

    def generate(self, prompt, n_tokens: int) -> torch.Tensor:
        """Greedy autoregressive generation: prefill the one-hot prompt
        [B, V, Tp] through ``rnn_time_step``, take the first token by
        argmax, then decode the rest in one scan of
        ``scan_length_bucket(n_tokens - 1)`` steps with the true
        remaining length a device tensor (steps past it freeze the
        carry). On the card the scan is one captured CUDA graph per
        (bucket, batch, dtype, params version), so the graph count stays
        O(log max_tokens); on the CPU the same body runs eagerly. The
        per-token equivalent is an ``rnn_time_step`` loop, with the same
        ids.

        Requires an LM-shaped net (n_classes == n_in, one-hot io).
        Returns int32 ids [B, n_tokens]; leaves the rnn state at the
        post-generation position."""
        return self._generate(prompt, n_tokens, self.generate_graphs)

    def _generate(self, prompt, n_tokens: int, graphs):
        """``generate`` through ``graphs`` (a :class:`GraphRunner`), or
        the eager body on any device when ``graphs`` is None."""
        if n_tokens < 1:
            raise ValueError(f"n_tokens {n_tokens} < 1")
        self.init()
        vocab = self.conf.confs[0].layer.n_in
        out = self.rnn_time_step(prompt)   # prefill (guards streamable)
        tok0 = torch.argmax(out[:, :, -1], dim=1).to(torch.int32)
        if n_tokens == 1:
            return tok0[:, None]
        n_rem = n_tokens - 1
        bucket = scan_length_bucket(n_rem)
        body = make_bucketed_generate(self._stream_step, vocab,
                                      self._dtype, bucket)
        ops = {"rnn": self._rnn_state, "tok": tok0,
               "n_rem": torch.full((), n_rem, dtype=torch.int32,
                                   device=self.device)}
        with torch.no_grad():
            if graphs is None:
                res = body(ops)
            else:
                if self._graphs_version != self.params_version:
                    # a captured graph reads the params (and the cast
                    # copy) it was captured with
                    graphs.drop()
                    self._graphs_version = self.params_version
                key = (bucket, int(tok0.shape[0]), self._dtype,
                       self.params_version)
                res = graphs.run(key, body, ops)
            # the graph's outputs are overwritten by its next replay
            self._rnn_state = tree_map(torch.clone, res["rnn"])
            return torch.cat([tok0[:, None], res["toks"][:, :n_rem]], dim=1)

    def param_table(self) -> Dict[str, torch.Tensor]:
        """Flat "idx_name" -> tensor view (reference paramTable())."""
        out = {}
        for idx in sorted(self.params, key=int):
            for name, p in self.params[idx].items():
                out[f"{idx}_{name}"] = p
        return out

    def set_param(self, key: str, value) -> None:
        idx, name = key.split("_", 1)
        self.params[idx][name] = torch.as_tensor(
            value, dtype=self._dtype, device=self.device).clone()
        self.params_version += 1

    def clone(self) -> "MultiLayerNetwork":
        """A deep copy on the same device: the conf (``conf.clone()``),
        params, updater state, layer state and iteration as new tensors,
        so training either net never touches the other."""
        net = MultiLayerNetwork(self.conf.clone(), device=self.device)
        net.params = tree_map(torch.clone, self.params)
        net.updater_state = tree_map(torch.clone, self.updater_state)
        net.state = tree_map(torch.clone, self.state)
        net.iteration = self.iteration
        net._initialized = True
        net.params_version += 1
        return net

    def unsharded_clone(self) -> "MultiLayerNetwork":
        """A clone with every bean's mesh-axis fields (``ring_axis``,
        ``ep_axis``) cleared: the single-device serving and eval view of
        a mesh-trained net (JAX's ``unsharded_clone``)."""
        net = self.clone()
        for c in net.conf.confs:
            for axis_field in ("ring_axis", "ep_axis"):
                if getattr(c.layer, axis_field, None):
                    setattr(c.layer, axis_field, None)
        return net

    def save(self, path: str) -> None:
        """One-zip checkpoint in the JAX package's format."""
        from deeplearning4j_tpu_torch.util.model_serializer import (
            write_model,
        )

        write_model(self, path)

    @staticmethod
    def load(path: str, device="cuda") -> "MultiLayerNetwork":
        from deeplearning4j_tpu_torch.util.model_serializer import (
            restore_model,
        )

        return restore_model(path, device=device)
