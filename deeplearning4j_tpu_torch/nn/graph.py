"""ComputationGraph: the DAG network.

Port of ``deeplearning4j_tpu/nn/graph.py`` (reference
nn/graph/ComputationGraph.java:59) on the MultiLayerNetwork machinery of
``nn/multilayer.py`` (:class:`BaseNetwork`): ``init``, the
topological-order forward ``_forward_fn`` (mixed precision with the
network-output vertices at the master dtype, carried state cast back to
the master dtype, time masks along each vertex's first input edge,
``stop_at``), the multi-output loss with l1/l2 and the auxiliary losses,
``fit`` (SGD, the line-search solvers for another ``optimization_algo``,
truncated BPTT), ``fit_scan`` (one captured train step per key on the
card), ``rnn_time_step``, ``generate``, ``pretrain``, ``output``,
``feed_forward``, ``score``, ``compute_gradient_and_score``,
``evaluate``, the flat-parameter surface, ``clone`` and ``save`` /
``load``, and ``fit_stream`` (host-fed windows of DataSet / MultiDataSet
batches, as ``MultiLayerNetwork.fit_stream``).

Parameters are ``{vertex name: {name: Tensor}}`` dicts with the JAX
package's keys, on the net's ``device``. ``init`` draws every layer
vertex's params, in sorted vertex order, from one ``torch.Generator``
seeded with the first layer vertex's seed (the numbers differ from
JAX's; load a model zip to match it). Training dropout draws one
generator per layer vertex per step in sorted vertex order, as JAX
splits its key; trajectories with dropout match JAX only in
distribution.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.enums import (
    BackpropType,
    OptimizationAlgorithm,
)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
    DuplicateToTimeSeriesVertex,
    ElementWiseOp,
    ElementWiseVertex,
    LastTimeStepVertex,
    LayerVertex,
    MergeVertex,
    PreprocessorVertex,
    SubsetVertex,
)
from deeplearning4j_tpu_torch.nn.cuda_graphs import GraphRunner
from deeplearning4j_tpu_torch.nn.gradient import Gradient
from deeplearning4j_tpu_torch.nn.layers import get_impl
from deeplearning4j_tpu_torch.nn.layers.attention import guard_streamable
from deeplearning4j_tpu_torch.nn.multilayer import (
    BaseNetwork,
    _cast_floating,
    _cast_tree,
    _dtype_of,
    _layer_generator,
    layer_reg_score,
)
from deeplearning4j_tpu_torch.nn.streaming import (
    make_bucketed_generate,
    reset_streaming_state,
    scan_length_bucket,
    tree_map,
)
from deeplearning4j_tpu_torch.nn.updater.updaters import make_layer_updater
from deeplearning4j_tpu_torch.optimize.listeners import fire_crossed
from deeplearning4j_tpu_torch.optimize.telemetry import (
    HEALTH_KEYS,
    TrainTelemetry,
    batch_counts,
    window_counts,
)


class ComputationGraph(BaseNetwork):
    """DAG network over vertex beans, on ``device`` (default ``"cuda"``;
    raises when CUDA is absent, so pass ``device="cpu"`` to run on the
    CPU). Every network output must be an output-layer vertex."""

    def __init__(self, conf: ComputationGraphConfiguration, device="cuda"):
        conf.validate()
        for out in conf.network_outputs:
            v = conf.vertices[out]
            if not (isinstance(v, LayerVertex)
                    and isinstance(v.conf.layer, L.BaseOutputLayer)):
                raise ValueError(
                    f"Network output {out!r} must be an output layer vertex "
                    "(OutputLayer/RnnOutputLayer) to compute a loss")
        self.device = resolve_device(device)
        self.conf = conf
        self.order = conf.topological_order()
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        self.state: Dict[str, Any] = {}
        self.updater_state: Dict[str, Any] = {}
        self.iteration = 0
        self.score_value: Any = float("nan")
        self.listeners: List = []
        self.train_telemetry = TrainTelemetry()
        self._rnn_state: Dict[str, Any] = {}
        self._layer_vertices = {name: v for name, v in conf.vertices.items()
                                if isinstance(v, LayerVertex)}
        self._impls = {name: get_impl(v.conf.layer)
                       for name, v in self._layer_vertices.items()}
        self._updaters = {name: make_layer_updater(v.conf)
                          for name, v in self._layer_vertices.items()}
        first = next(iter(self._layer_vertices.values()), None)
        self._dtype = _dtype_of(first.conf.dtype if first else "float32")
        cd_name = first.conf.compute_dtype if first else None
        cd = _dtype_of(cd_name) if cd_name else None
        self._compute_dtype = cd if cd != self._dtype else None
        self._seed = int(first.conf.seed) if first else 12345
        self._initialized = False
        #: bumped by every parameter write (see MultiLayerNetwork)
        self.params_version = 0
        self._cast_cache = (None, None)
        #: seeds each step's per-vertex dropout generators
        self._gen = torch.Generator()
        self._gen.manual_seed(self._seed)
        #: ``generate``'s captured decode graphs (see MultiLayerNetwork)
        self.generate_graphs = GraphRunner()
        self._graphs_version = self.params_version
        #: ``fit_scan``'s captured train steps; None runs the step
        #: eagerly on any device (a private switch for checks on the card)
        self.train_graphs: Optional[GraphRunner] = GraphRunner()
        self._scan_gens: Optional[List[torch.Generator]] = None
        self._pretrain_gen: Optional[torch.Generator] = None

    # ------------------------------------------------------------------
    def init(self) -> "ComputationGraph":
        if self._initialized:
            return self
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._seed)
        for name in sorted(self._layer_vertices):
            c = self._layer_vertices[name].conf
            impl = self._impls[name]
            self.params[name] = impl.init(gen, c, self._dtype, self.device)
            st = impl.init_state(c, self._dtype, self.device)
            if st is not None:
                self.state[name] = st
            self.updater_state[name] = self._updaters[name].init(
                self.params[name])
        self._initialized = True
        self.params_version += 1
        return self

    def _units(self) -> list:
        return [(name, v.conf, self._updaters[name])
                for name, v in self._layer_vertices.items()]

    def _dropout_order(self) -> list:
        return sorted(self._layer_vertices)

    def _compute_params(self, params):
        """Params at the compute dtype, the network-output vertices at
        the master dtype; cached outside autograd as in
        ``MultiLayerNetwork._compute_params``."""
        cd = self._compute_dtype
        if cd is None:
            return params
        cacheable = params is self.params and not torch.is_grad_enabled()
        if cacheable:
            version, cast = self._cast_cache
            if version == self.params_version:
                return cast
        outs = set(self.conf.network_outputs)
        cast = {k: (sub if k in outs else _cast_tree(sub, cd))
                for k, sub in params.items()}
        if cacheable:
            self._cast_cache = (self.params_version, cast)
        return cast

    # ------------------------------------------------------------------
    def _forward_fn(self, params, state, inputs: Dict[str, torch.Tensor],
                    rng, train: bool, masks=None, rnn_state=None,
                    stop_at: Optional[str] = None):
        """Topological-order forward; returns (activations by vertex and
        input name, new_state, new_rnn_state). ``rnn_state`` is each
        vertex's carried recurrent state (streaming, truncated-BPTT
        windows). ``rng`` (training) is a host ``torch.Generator`` that
        seeds one dropout generator per layer vertex, or a list of
        persistent generators in sorted vertex order (``fit_scan``).
        A vertex inherits its first input's time mask; a
        ``LastTimeStepVertex`` drops it. ``stop_at`` ends the walk after
        that vertex."""
        cd = self._compute_dtype
        out_f32 = set(self.conf.network_outputs) if cd is not None else set()
        params = self._compute_params(params)
        if cd is not None:
            inputs = {k: _cast_floating(v, cd) for k, v in inputs.items()}
        acts: Dict[str, torch.Tensor] = dict(inputs)
        new_state = dict(state) if state else {}
        new_rnn: Dict[str, Any] = {}
        vmasks: Dict[str, Any] = dict(masks or {})
        names = self._dropout_order()
        seeds: Dict[str, Optional[int]] = {}
        gens: Dict[str, Optional[torch.Generator]] = {}
        if train and isinstance(rng, torch.Generator):
            seeds = dict(zip(names, torch.randint(
                0, 2 ** 62, (max(1, len(names)),), generator=rng).tolist()))
        elif train and rng is not None:
            gens = dict(zip(names, rng))
        for name in self.order:
            vertex = self.conf.vertices[name]
            in_names = self.conf.vertex_inputs[name]
            xs = [acts[i] for i in in_names]
            in_mask = vmasks.get(in_names[0])
            vmasks[name] = (None if isinstance(vertex, LastTimeStepVertex)
                            else in_mask)
            if isinstance(vertex, LayerVertex):
                gen = None
                if train:
                    gen = gens.get(name) or _layer_generator(
                        seeds.get(name), xs[0].device)
                x = xs[0]
                if vertex.preprocessor is not None:
                    x = vertex.preprocessor.pre_process(x, gen)
                layer_state = new_state.get(name)
                if layer_state is None and rnn_state:
                    layer_state = rnn_state.get(name)
                is_recurrent = isinstance(vertex.conf.layer,
                                          L.RECURRENT_LAYER_TYPES)
                if name in out_f32:
                    x = _cast_floating(x, self._dtype)
                out, st = self._impls[name].apply(
                    vertex.conf, params[name], x, state=layer_state,
                    train=train, rng=gen,
                    mask=in_mask if is_recurrent else None)
                if st is not None:
                    if cd is not None:
                        # carried state stays at the master dtype
                        st = _cast_tree(st, self._dtype)
                    if name in new_state:
                        new_state[name] = st
                    else:
                        new_rnn[name] = st
                acts[name] = out
            elif isinstance(vertex, MergeVertex):
                acts[name] = torch.cat(xs, dim=1)
            elif isinstance(vertex, ElementWiseVertex):
                acts[name] = _elementwise(vertex.op, xs)
            elif isinstance(vertex, SubsetVertex):
                acts[name] = xs[0][:, vertex.from_index:vertex.to_index + 1]
            elif isinstance(vertex, PreprocessorVertex):
                acts[name] = vertex.preprocessor.pre_process(xs[0])
            elif isinstance(vertex, LastTimeStepVertex):
                acts[name] = _last_time_step(
                    xs[0], vmasks.get(vertex.mask_input))
            elif isinstance(vertex, DuplicateToTimeSeriesVertex):
                ref = acts[vertex.reference_input]
                acts[name] = xs[0][:, :, None].expand(
                    *xs[0].shape, ref.shape[-1])
            else:
                raise ValueError(
                    f"Unknown vertex type {type(vertex).__name__}")
            if name == stop_at:
                break
        return acts, new_state, new_rnn

    def _loss_fn(self, params, state, rng, inputs, labels, masks,
                 label_masks, rnn_state=None):
        """(score, new_state, new_rnn_state) of the training forward:
        the sum of every network output's loss (in the master dtype),
        the l1/l2 penalty and the auxiliary losses."""
        acts, new_state, new_rnn = self._forward_fn(
            params, state, inputs, rng, True, masks, rnn_state)
        score = 0.0
        for out_name, y in zip(self.conf.network_outputs, labels):
            v = self._layer_vertices[out_name]
            lm = None if label_masks is None else label_masks.get(out_name)
            out = acts[out_name]
            if self._compute_dtype is not None:
                out = _cast_floating(out, self._dtype)   # loss in f32
            score = score + self._impls[out_name].loss(v.conf, out, y, lm)
        score = score + self._reg_score(params)
        score = score + self._aux_score(new_state)
        return score, new_state, new_rnn

    def _aux_score(self, new_state):
        """The auxiliary losses vertices emit through the state channel
        (``MoeDense``'s load-balancing loss), weighted per conf."""
        aux = 0.0
        for name, v in self._layer_vertices.items():
            w = getattr(v.conf.layer, "aux_weight", None)
            st = new_state.get(name) if new_state else None
            if w and st and "aux_loss" in st:
                aux = aux + w * st["aux_loss"]
        return aux

    def _reg_score(self, params):
        reg = 0.0
        for name, v in self._layer_vertices.items():
            reg = reg + layer_reg_score(v.conf, params[name])
        return reg

    # ------------------------------------------------------------------
    def _coerce_multi(self, data, host: bool = False) -> Tuple[
            Dict, List, Optional[Dict], Optional[Dict]]:
        """(inputs by name, labels per output, feature masks by input
        name or None, label masks by output name or None) from a
        ``DataSet`` (single input and output), a ``MultiDataSet`` or a
        (features list, labels list) pair, as tensors on the device; with
        ``host``, as numpy arrays in their own dtype and with no device
        transfer, so a ``fit_stream`` window keeps its wire format (u8
        pixels, integer ids) until its one upload."""
        from deeplearning4j_tpu_torch.datasets.dataset import (
            DataSet,
            MultiDataSet,
        )

        ins, outs = self.conf.network_inputs, self.conf.network_outputs
        if host:
            conv = mask_conv = np.asarray
        else:
            conv = lambda a: self._tensor(a, self._dtype)  # noqa: E731
            mask_conv = self._tensor

        def named(names, arrays, to):
            if arrays is None:
                return None
            return {n: to(a) for n, a in zip(names, arrays)
                    if a is not None} or None

        if isinstance(data, MultiDataSet):
            if len(data.features) != len(ins):
                raise ValueError(
                    f"MultiDataSet has {len(data.features)} feature arrays "
                    f"but graph has {len(ins)} inputs")
            if len(data.labels) != len(outs):
                raise ValueError(
                    f"MultiDataSet has {len(data.labels)} label arrays but "
                    f"graph has {len(outs)} outputs")
            return (named(ins, data.features, conv),
                    [conv(y) for y in data.labels],
                    named(ins, data.features_masks, mask_conv),
                    named(outs, data.labels_masks, mask_conv))
        if isinstance(data, DataSet):
            return ({ins[0]: conv(data.features)}, [conv(data.labels)],
                    named(ins[:1], [data.features_mask], mask_conv),
                    named(outs[:1], [data.labels_mask], mask_conv))
        features, labels = data
        return (named(ins, features, conv), [conv(y) for y in labels],
                None, None)

    def _inputs(self, features) -> Dict[str, torch.Tensor]:
        return {n: torch.as_tensor(f, dtype=self._dtype, device=self.device)
                for n, f in zip(self.conf.network_inputs, features)}

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def fit(self, data, labels=None) -> None:
        """fit(DataSet | MultiDataSet | (features, labels) lists) /
        fit(features, labels) / fit(iterator): an iterator pretrains
        first when the conf says so, then trains batch by batch."""
        self.init()
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        from deeplearning4j_tpu_torch.datasets.iterator import (
            DataSetIterator,
        )

        if labels is not None:
            data = DataSet(data, labels)
        if isinstance(data, DataSetIterator):
            if self.conf.pretrain:
                self.pretrain(data)
                data.reset()
            if not self.conf.backprop:
                return
            it = iter(data)
            while True:
                t0 = time.perf_counter()
                ds = next(it, None)
                self.train_telemetry.add_data_wait(time.perf_counter() - t0)
                if ds is None:
                    break
                self._fit_one(ds)
        else:
            self._fit_one(data)

    def _fit_one(self, data) -> None:
        if self.conf.backprop_type == BackpropType.TRUNCATED_BPTT:
            self._fit_tbptt(data)
            return
        first_conf = next(iter(self._layer_vertices.values())).conf
        if (first_conf.optimization_algo
                != OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT):
            from deeplearning4j_tpu_torch.optimize.solver import Solver

            Solver(self).optimize(data)
            return
        inputs, labels, masks, lmasks = self._coerce_multi(data)
        n_iter = max(1, first_conf.num_iterations)
        examples, tokens = batch_counts(next(iter(inputs.values())))
        for _ in range(n_iter):
            self._sgd_step(inputs, labels, masks, lmasks, examples, tokens)

    def _fit_tbptt(self, data) -> None:
        """Truncated BPTT (reference ComputationGraph.doTruncatedBPTT
        :1349): the time axis in ``tbptt_fwd_length`` windows, one train
        step a window, each vertex's recurrent state carried detached
        from window to window; 2-D inputs and labels go whole into every
        window. Each window's step runs eagerly."""
        inputs, labels, masks, lmasks = self._coerce_multi(data)
        length = self.conf.tbptt_fwd_length
        temporal = [v.shape[2] for v in list(inputs.values()) + labels
                    if v.ndim == 3]
        if not temporal:
            raise ValueError(
                "truncated BPTT requires at least one [B, C, T] input or "
                "label")
        t_total = max(temporal)
        rnn_state = None
        for start in range(0, t_total, length):
            end = min(start + length, t_total)
            iw = {k: (v[:, :, start:end] if v.ndim == 3 else v)
                  for k, v in inputs.items()}
            lw = [y[:, :, start:end] if y.ndim == 3 else y for y in labels]
            mw = (None if masks is None
                  else {k: m[:, start:end] for k, m in masks.items()})
            lmw = (None if lmasks is None
                   else {k: m[:, start:end] for k, m in lmasks.items()})
            t0 = time.perf_counter()
            (self.params, self.state, self.updater_state, rnn_state,
             score, health) = self._tbptt_step(
                self.params, self.state, self.updater_state,
                self.iteration, self._gen, iw, lw, mw, lmw, rnn_state)
            self.params_version += 1
            first_in = next(iter(iw.values()))
            self.train_telemetry.record_step(
                dispatch_s=time.perf_counter() - t0,
                examples=int(first_in.shape[0]),
                tokens=int(first_in.shape[0]) * (end - start),
                health=health)
            self.score_value = score
            self.iteration += 1
            self._fire_listeners()

    def fit_scan(self, inputs_stacked, labels_stacked, masks_stacked=None,
                 label_masks_stacked=None,
                 grad_scale: float = 1.0) -> torch.Tensor:
        """K train steps over pre-stacked batches: ``inputs_stacked`` a
        dict input name -> [K, B, ...] (or one tensor for a single-input
        graph), ``labels_stacked`` a list of [K, B, ...] per output (or
        one tensor), optional masks dicts (or one tensor) of [K, B, T].
        As ``MultiLayerNetwork.fit_scan``: one captured CUDA graph of the
        train step per key on the card, replayed per step, the window's
        updater scalars as one table; eager on the CPU. SGD only."""
        if self.conf.backprop_type == BackpropType.TRUNCATED_BPTT:
            raise ValueError(
                "fit_scan is the full-BPTT SGD fast path; truncated-BPTT "
                "graphs must train via fit()")
        for name, v in self._layer_vertices.items():
            algo = v.conf.optimization_algo
            if algo != OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
                raise ValueError(
                    f"fit_scan only supports SGD, but vertex {name!r} is "
                    f"configured with {algo}; use fit()")
        self.init()
        ins, outs = self.conf.network_inputs, self.conf.network_outputs
        if not isinstance(inputs_stacked, dict):
            inputs_stacked = {ins[0]: inputs_stacked}
        if not isinstance(labels_stacked, (list, tuple)):
            labels_stacked = [labels_stacked]
        if set(inputs_stacked) != set(ins):
            raise ValueError(
                f"fit_scan got inputs {sorted(inputs_stacked)} but graph "
                f"has inputs {sorted(ins)}")
        if len(labels_stacked) != len(outs):
            raise ValueError(
                f"fit_scan got {len(labels_stacked)} label arrays but "
                f"graph has {len(outs)} outputs")
        if masks_stacked is not None and not isinstance(masks_stacked, dict):
            masks_stacked = {ins[0]: masks_stacked}
        if (label_masks_stacked is not None
                and not isinstance(label_masks_stacked, dict)):
            label_masks_stacked = {outs[0]: label_masks_stacked}
        for what, given, names in (("masks_stacked", masks_stacked, ins),
                                   ("label_masks_stacked",
                                    label_masks_stacked, outs)):
            bad = set(given or {}) - set(names)
            if bad:
                raise ValueError(
                    f"{what} has keys {sorted(bad)} that are not network "
                    f"{'inputs' if names is ins else 'outputs'} "
                    f"{sorted(names)}")
        xs = {k: self._tensor(v, self._dtype)
              for k, v in inputs_stacked.items()}
        ys = [self._tensor(y, self._dtype) for y in labels_stacked]
        ms = {k: self._tensor(v) for k, v in (masks_stacked or {}).items()}
        lms = {k: self._tensor(v)
               for k, v in (label_masks_stacked or {}).items()}
        first = xs[ins[0]]
        start = self.iteration
        t0 = time.perf_counter()

        def shapes(d):
            return tuple((k, tuple(v.shape[1:]), v.dtype)
                         for k, v in sorted(d.items()))

        key = (shapes(xs), tuple(tuple(y.shape[1:]) for y in ys),
               shapes(ms), shapes(lms))
        scores, health = self._scan_window(
            key, int(first.shape[0]),
            # labels as a tuple: a graph's static inputs are the
            # tensors of dicts and tuples (a list would stay the
            # capture's)
            lambda j: dict(x={k: v[j] for k, v in xs.items()},
                           y=tuple(y[j] for y in ys),
                           fm={k: v[j] for k, v in ms.items()} or None,
                           lm={k: v[j] for k, v in lms.items()} or None),
            start, grad_scale)
        k, examples, tokens = window_counts(first.shape)
        self.train_telemetry.record_step(
            dispatch_s=time.perf_counter() - t0, steps=k,
            examples=examples, tokens=tokens,
            health={name: health[:, i] for i, name in
                    enumerate(HEALTH_KEYS)})
        self.score_value = scores[-1]
        fire_crossed(self.listeners, self, start, self.iteration)
        return scores

    def fit_stream(self, iterator, scan_steps: int = 16, ingest=None,
                   ingest_labels=None,
                   sync_each_window: bool = False) -> torch.Tensor:
        """Host-fed graph training, ``MultiLayerNetwork.fit_stream`` for
        DataSet / MultiDataSet batches: ``scan_steps`` batches stacked
        into [K, B, ...] arrays per input and output on the host, one
        upload per window (``_upload_window``), one ``fit_scan`` call.
        ``ingest`` gets the stacked input dict and ``ingest_labels`` the
        label list, both on the device, on fused windows and on ragged
        tails alike (stacked [1, B, ...], then trained batch by batch
        with ``fit``). A window that mixes batches with and without
        masks, or mask name sets, raises. Returns the last window's
        scores."""
        from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
        from deeplearning4j_tpu_torch.nn.multilayer import (
            device_batch,
            window_masks,
        )
        from deeplearning4j_tpu_torch.nn.streaming_fit import (
            drive_stream_windows,
        )

        self.init()
        ins, outs = self.conf.network_inputs, self.conf.network_outputs
        scores = None

        def stack_masks(per_batch, what):
            per_batch = window_masks(per_batch, what)
            if per_batch is None:
                return None
            names = sorted(per_batch[0])
            if any(sorted(m) != names for m in per_batch):
                raise ValueError(
                    f"fit_stream window mixes {what} name sets")
            ups = self._upload_window(
                [[m[k] for m in per_batch] for k in names], False)
            return dict(zip(names, ups))

        def stacked(window):
            multi = [self._coerce_multi(b, host=True) for b in window]
            fm = stack_masks([c[2] for c in multi], "feature masks")
            lm = stack_masks([c[3] for c in multi], "label masks")
            names = list(multi[0][0])
            n_out = len(multi[0][1])
            ups = self._upload_window(
                [[c[0][k] for c in multi] for k in names]
                + [[c[1][i] for c in multi] for i in range(n_out)],
                sync_each_window)
            inputs = dict(zip(names, ups[:len(names)]))
            labels = ups[len(names):]
            if ingest is not None:
                inputs = ingest(inputs)
            if ingest_labels is not None:
                labels = ingest_labels(labels)
            return inputs, list(labels), fm, lm

        def flush(window, fused):
            nonlocal scores
            if fused:
                inputs, labels, fm, lm = stacked(window)
                scores = self.fit_scan(inputs, labels, masks_stacked=fm,
                                       label_masks_stacked=lm)
                if sync_each_window:
                    float(scores[-1])
                return
            for b in window:   # ragged: correctness over throughput
                inputs, labels, fm, lm = stacked([b])
                self._fit_one(device_batch(
                    MultiDataSet,
                    features=[inputs[n][0] for n in ins],
                    labels=[y[0] for y in labels],
                    features_masks=None if fm is None else [
                        fm[n][0] if n in fm else None for n in ins],
                    labels_masks=None if lm is None else [
                        lm[n][0] if n in lm else None for n in outs]))
            scores = self._last_score()

        def batch_shape(ds):
            # label shapes too: identical features with variable-length
            # labels must also break a window
            inputs, labels, _, _ = self._coerce_multi(ds, host=True)
            return ({k: np.shape(v) for k, v in inputs.items()},
                    tuple(np.shape(y) for y in labels))

        drive_stream_windows(iterator, scan_steps, flush, batch_shape,
                             telemetry=self.train_telemetry)
        return scores

    # ------------------------------------------------------------------
    # Streaming inference (reference rnnTimeStep :1196)
    # ------------------------------------------------------------------
    def rnn_time_step(self, *features) -> List[torch.Tensor]:
        """Stateful step-by-step forward carrying every vertex's state
        between calls. A 2-D input consumed only by recurrent vertices is
        one time step ([B, C] -> [B, C, 1]); outputs are squeezed back to
        2-D when every input was 2-D."""
        self.init()
        guard_streamable((name, lv.conf.layer)
                         for name, lv in self._layer_vertices.items())
        consumers: Dict[str, List[str]] = {}
        for vname, in_names in self.conf.vertex_inputs.items():
            for inp in in_names:
                consumers.setdefault(inp, []).append(vname)
        inputs, ranks = {}, []
        for n, f in zip(self.conf.network_inputs, features):
            x = torch.as_tensor(f, dtype=self._dtype, device=self.device)
            ranks.append(x.ndim)
            if x.ndim == 2:
                cons = consumers.get(n, [])
                rec = [c for c in cons
                       if isinstance(self.conf.vertices[c], LayerVertex)
                       and isinstance(self.conf.vertices[c].conf.layer,
                                      L.RECURRENT_LAYER_TYPES)]
                if rec and len(rec) == len(cons):
                    x = x[:, :, None]
                elif rec:
                    raise ValueError(
                        f"Input {n!r} feeds both recurrent ({rec}) and "
                        f"non-recurrent vertices; pass it as 3-D [B, C, 1] "
                        f"to disambiguate one-time-step intent")
            inputs[n] = x
        squeeze = bool(ranks) and all(r == 2 for r in ranks)
        with torch.no_grad():
            acts, _, self._rnn_state = self._forward_fn(
                self.params, self.state, inputs, None, False,
                rnn_state=self._rnn_state or None)
        outs = [acts[name] for name in self.conf.network_outputs]
        if squeeze:
            outs = [o[:, :, 0] if o.ndim == 3 else o for o in outs]
        return outs

    def rnn_clear_previous_state(self, slots=None) -> None:
        """Reset streaming state; ``slots=[...]`` zeroes only those batch
        rows of every vertex's carried state, in place."""
        self._rnn_state = reset_streaming_state(self._rnn_state, slots)

    def lm_shape(self):
        """(input name, output name, vocab) for an LM-shaped graph:
        single input, single output, the first layer's n_in equal to the
        output's n_out. Raises ValueError for any other topology."""
        if (len(self.conf.network_inputs) != 1
                or len(self.conf.network_outputs) != 1):
            raise ValueError(
                "requires a single-input/single-output LM-shaped graph")
        in_name = self.conf.network_inputs[0]
        out_name = self.conf.network_outputs[0]
        first = None
        for vname, ins in self.conf.vertex_inputs.items():
            if in_name in ins and vname in self._layer_vertices:
                first = self._layer_vertices[vname]
                break
        vocab = getattr(first.conf.layer, "n_in", None) if first else None
        out_bean = self._layer_vertices[out_name].conf.layer
        if vocab is None or vocab != getattr(out_bean, "n_out", None):
            raise ValueError(
                "LM-shaped graph requires input n_in == output n_out "
                f"(got {vocab} vs {getattr(out_bean, 'n_out', None)})")
        return in_name, out_name, vocab

    def _lm_forward(self):
        """The streaming forward of an LM-shaped graph, ``(x, rnn) ->
        (out [B, V, T], new_rnn)``."""
        in_name, out_name, _ = self.lm_shape()

        def step(x, rnn):
            acts, _, new_rnn = self._forward_fn(
                self.params, self.state, {in_name: x}, None, False,
                rnn_state=rnn or None)
            return acts[out_name], new_rnn

        return step

    def generate(self, prompt, n_tokens: int) -> torch.Tensor:
        """Greedy generation on an LM-shaped graph, as
        ``MultiLayerNetwork.generate``: the prompt prefilled through
        ``rnn_time_step``, the rest decoded in one scan of
        ``scan_length_bucket(n_tokens - 1)`` steps, on the card replayed
        from one captured CUDA graph per (bucket, batch, dtype, params
        version). Returns int32 ids [B, n_tokens]."""
        return self._generate(prompt, n_tokens, self.generate_graphs)

    def _generate(self, prompt, n_tokens: int, graphs):
        """``generate`` through ``graphs``, or the eager body on any
        device when ``graphs`` is None."""
        if n_tokens < 1:
            raise ValueError(f"n_tokens {n_tokens} < 1")
        self.init()
        _, _, vocab = self.lm_shape()
        out = self.rnn_time_step(prompt)[0]
        tok0 = torch.argmax(out[:, :, -1], dim=1).to(torch.int32)
        if n_tokens == 1:
            return tok0[:, None]
        n_rem = n_tokens - 1
        bucket = scan_length_bucket(n_rem)
        body = make_bucketed_generate(self._lm_forward(), vocab,
                                      self._dtype, bucket)
        ops = {"rnn": self._rnn_state, "tok": tok0,
               "n_rem": torch.full((), n_rem, dtype=torch.int32,
                                   device=self.device)}
        with torch.no_grad():
            if graphs is None:
                res = body(ops)
            else:
                if self._graphs_version != self.params_version:
                    graphs.drop()
                    self._graphs_version = self.params_version
                key = (bucket, int(tok0.shape[0]), self._dtype,
                       self.params_version)
                res = graphs.run(key, body, ops)
            self._rnn_state = tree_map(torch.clone, res["rnn"])
            return torch.cat([tok0[:, None], res["toks"][:, :n_rem]], dim=1)

    # ------------------------------------------------------------------
    # Greedy layer-wise pretraining (reference ComputationGraph.pretrain
    # :341-427)
    # ------------------------------------------------------------------
    def pretrain(self, data_iter) -> None:
        self.init()
        from deeplearning4j_tpu_torch.optimize.pretrainer import (
            pretrain_graph,
        )

        pretrain_graph(self, data_iter)

    def _pretrain_input(self, name: str, ds) -> torch.Tensor:
        """The activations feeding vertex ``name`` (inference mode) with
        the vertex's own preprocessor applied; the forward stops at the
        feeding vertex."""
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet

        if isinstance(ds, DataSet) and ds.labels is None:
            in0 = self.conf.network_inputs[0]
            inputs = {in0: self._tensor(ds.features, self._dtype)}
            masks = (None if ds.features_mask is None
                     else {in0: self._tensor(ds.features_mask)})
        else:
            inputs, _, masks, _ = self._coerce_multi(ds)
        vertex = self.conf.vertices[name]
        in_name = self.conf.vertex_inputs[name][0]
        if in_name in inputs:
            x = inputs[in_name]
        else:
            with torch.no_grad():
                acts, _, _ = self._forward_fn(
                    self.params, self.state, inputs, None, False, masks,
                    stop_at=in_name)
            x = acts[in_name]
        if vertex.preprocessor is not None:
            x = vertex.preprocessor.pre_process(x)
        return x

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------
    def output(self, *features) -> List[torch.Tensor]:
        """The network outputs (inference forward), one tensor each."""
        self.init()
        with torch.no_grad():
            acts, _, _ = self._forward_fn(
                self.params, self.state, self._inputs(features), None, False)
        return [acts[name] for name in self.conf.network_outputs]

    def feed_forward(self, *features) -> Dict[str, torch.Tensor]:
        """Every vertex's activations (and the inputs) by name."""
        self.init()
        with torch.no_grad():
            acts, _, _ = self._forward_fn(
                self.params, self.state, self._inputs(features), None, False)
        return acts

    def score(self, data=None) -> float:
        """The last training score, or the loss of ``data`` (the training
        forward without dropout, as JAX's graph scores)."""
        if data is None:
            return float(self.score_value)
        self.init()
        inputs, labels, masks, lmasks = self._coerce_multi(data)
        with torch.no_grad():
            s, _, _ = self._loss_fn(self.params, self.state, None, inputs,
                                    labels, masks, lmasks)
        return float(s)

    def compute_gradient_and_score(self, data) -> Tuple[float, Gradient]:
        """Score and per-parameter gradient keyed ``vertex_param``."""
        self.init()
        inputs, labels, masks, lmasks = self._coerce_multi(data)
        score, grads, _ = self._value_and_grad(
            self.params, self.state, None, inputs, labels, masks, lmasks)
        flat = {}
        for name in sorted(grads):
            for pname, g in grads[name].items():
                flat[f"{name}_{pname}"] = g
        return float(score), Gradient(flat)

    def evaluate(self, data_iter):
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

        self.init()
        ev = Evaluation()
        for ds in data_iter:
            out = self.output(ds.features)[0].float().cpu().numpy()
            if np.asarray(ds.labels).ndim == 3:
                ev.eval_time_series(ds.labels, out, ds.labels_mask)
            else:
                ev.eval(ds.labels, out)
        return ev

    # ------------------------------------------------------------------
    def clone(self) -> "ComputationGraph":
        """A deep copy on the same device (conf, params, updater and
        layer state, iteration)."""
        net = ComputationGraph(self.conf.clone(), device=self.device)
        net.params = tree_map(torch.clone, self.params)
        net.updater_state = tree_map(torch.clone, self.updater_state)
        net.state = tree_map(torch.clone, self.state)
        net.iteration = self.iteration
        net._initialized = True
        net.params_version += 1
        return net

    def save(self, path: str) -> None:
        """One-zip checkpoint in the JAX package's format."""
        from deeplearning4j_tpu_torch.util.model_serializer import (
            write_model,
        )

        write_model(self, path)

    @staticmethod
    def load(path: str, device="cuda") -> "ComputationGraph":
        from deeplearning4j_tpu_torch.util.model_serializer import (
            restore_model,
        )

        net = restore_model(path, device=device)
        if not isinstance(net, ComputationGraph):
            raise TypeError(f"{path} holds a {type(net).__name__}")
        return net


def _elementwise(op: ElementWiseOp, xs: Sequence[torch.Tensor]):
    if op == ElementWiseOp.ADD:
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out
    if op == ElementWiseOp.SUBTRACT:
        if len(xs) != 2:
            raise ValueError("SUBTRACT requires exactly 2 inputs")
        return xs[0] - xs[1]
    if op == ElementWiseOp.PRODUCT:
        out = xs[0]
        for x in xs[1:]:
            out = out * x
        return out
    if op == ElementWiseOp.AVERAGE:
        return sum(xs) / len(xs)
    if op == ElementWiseOp.MAX:
        out = xs[0]
        for x in xs[1:]:
            out = torch.maximum(out, x)
        return out
    raise ValueError(f"Unknown elementwise op {op}")


def _last_time_step(x: torch.Tensor, mask) -> torch.Tensor:
    """[N, C, T] -> [N, C] at each row's last step whose mask is > 0 (the
    last step when the row's mask is all 0, or with no mask), by a
    gather: no host read, so the step captures."""
    if mask is None:
        return x[:, :, -1]
    t = mask.shape[1]
    flipped = (torch.flip(mask, dims=(1,)) > 0).to(torch.int32)
    idx = t - 1 - torch.argmax(flipped, dim=1)
    idx = idx[:, None, None].expand(x.shape[0], x.shape[1], 1)
    return torch.gather(x, 2, idx)[:, :, 0]
