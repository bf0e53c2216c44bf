"""MultiLayerNetwork: the sequential-stack network.

Port of ``deeplearning4j_tpu/nn/multilayer.py``: ``init`` (params and
updater state), the mixed-precision forward ``_forward_fn`` (with
``remat`` as activation checkpointing), ``output``, ``param_table``,
``set_param``, ``feed_forward``, ``predict``, ``evaluate``, and
training: ``fit`` (a ``DataSet``, features and labels, or an iterator
of ``DataSet``), ``fit_scan`` (K steps over stacked batches), ``score``
and ``compute_gradient_and_score``.
Parameters are plain ``{layer_index: {name: Tensor}}`` dicts with the
JAX package's keys, on the net's ``device``.

A train step is the JAX step written eagerly: forward and loss under
autograd (the compute-dtype cast of the f32 master params happens inside
autograd every step, so gradients land in f32 as through JAX's cast
transpose), ``torch.autograd.grad``, then per layer normalize -> updater
-> ``params - updates`` (new tensors, as JAX returns new arrays). Every
parameter write bumps ``params_version``.

Dropout draws from one ``torch.Generator`` per layer per step, seeded
from the net's host generator (JAX splits one key per layer): with
dropout 0 (the flagship) trajectories match the JAX package; with
dropout they match only in distribution.

Still out of this slice: truncated BPTT, the second-order ``Solver``,
``fit_stream``, ``pretrain`` and the streaming
``rnn_time_step``/``generate``.
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
from deeplearning4j_tpu_torch.nn.gradient import Gradient
from deeplearning4j_tpu_torch.nn.layers import get_impl
from deeplearning4j_tpu_torch.nn.updater.updaters import (
    make_layer_updater,
    normalize_gradients,
    resolve_lr,
)
from deeplearning4j_tpu_torch.optimize.listeners import fire_crossed
from deeplearning4j_tpu_torch.optimize.telemetry import (
    TrainTelemetry,
    batch_counts,
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
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return _cast_floating(tree, dtype)


def _detach_tree(tree):
    if isinstance(tree, dict):
        return {k: _detach_tree(v) for k, v in tree.items()}
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def _layer_generator(seed: Optional[int], device):
    """A layer's dropout generator for one step (None at inference)."""
    if seed is None:
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


#: the weights l1/l2 apply to; the recurrent ones (RW, W_bwd, RW_bwd)
#: join with the recurrent layers that carry them
_REGULARIZED_KEYS = ("W",)


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


def layer_update(c, updater, grads, upd_state, iteration: int):
    """normalize -> updater rule for ONE layer; returns (updates,
    new_state) and the caller applies ``params - updates``."""
    g = normalize_gradients(
        c.resolved("gradient_normalization"), grads,
        float(c.resolved("gradient_normalization_threshold")))
    lr = resolve_lr(c, iteration)
    return updater.update(g, upd_state, lr, iteration)


class MultiLayerNetwork:
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
        one dropout generator per layer. With ``conf.remat`` each
        layer's apply runs under ``torch.utils.checkpoint`` (its
        activations are recomputed in the backward; the layer's
        generator is rebuilt from its seed, so the rerun draws the same
        dropout mask)."""
        cd = self._compute_dtype
        out_f32 = self._out_f32()
        last_si = str(self.n_layers - 1)
        params = self._compute_params(params)
        if cd is not None:
            x = _cast_floating(x, cd)
        seeds = [None] * self.n_layers
        if train and rng is not None:
            seeds = torch.randint(0, 2 ** 62, (self.n_layers,),
                                  generator=rng).tolist()
        remat = bool(self.conf.remat) and train and torch.is_grad_enabled()
        acts = []
        new_state = dict(state) if state else {}
        new_rnn = {}
        for i, (c, impl) in enumerate(zip(self.conf.confs, self._impls)):
            si = str(i)
            pp = self.conf.preprocessor_for(i)
            if pp is not None:
                x = pp.pre_process(
                    x, _layer_generator(seeds[i], x.device) if train
                    else None)
            layer_state = None
            if state and si in state:
                layer_state = state[si]
            elif rnn_state and si in rnn_state:
                layer_state = rnn_state[si]
            is_recurrent = isinstance(c.layer, L.RECURRENT_LAYER_TYPES)
            mask = feature_mask if is_recurrent else None
            if out_f32 and si == last_si:
                x = _cast_floating(x, self._dtype)

            def apply(p, xin, _c=c, _impl=impl, _lst=layer_state,
                      _seed=seeds[i], _mask=mask):
                return _impl.apply(_c, p, xin, state=_lst, train=train,
                                   rng=_layer_generator(_seed, xin.device),
                                   mask=_mask)

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
                 label_mask):
        out, new_state, _ = self._forward_fn(params, state, features, rng,
                                             True, feature_mask)
        impl = self._impls[-1]
        if not hasattr(impl, "loss"):
            raise ValueError(
                "Last layer must be an output layer to compute a score")
        if self._compute_dtype is not None:
            out = _cast_floating(out, self._dtype)  # loss in f32
        score = impl.loss(self.conf.confs[-1], out, labels, label_mask)
        score = score + self._reg_score(params)
        return score, new_state

    def _reg_score(self, params):
        reg = 0.0
        for i, c in enumerate(self.conf.confs):
            reg = reg + layer_reg_score(c, params[str(i)])
        return reg

    # ------------------------------------------------------------------
    # The train step
    # ------------------------------------------------------------------
    def _value_and_grad(self, params, state, rng, features, labels,
                        feature_mask, label_mask):
        """(score, grads, new_state): the loss under autograd at
        requires-grad aliases of ``params`` (no copy), differentiated
        with ``torch.autograd.grad``; a param the loss does not reach
        gets a zero gradient."""
        leaves = {si: {k: p.detach().requires_grad_(True)
                       for k, p in sub.items()}
                  for si, sub in params.items()}
        with torch.enable_grad():
            score, new_state = self._loss_fn(leaves, state, rng, features,
                                             labels, feature_mask,
                                             label_mask)
            flat = [p for sub in leaves.values() for p in sub.values()]
            gflat = torch.autograd.grad(score, flat, allow_unused=True)
        it = iter(gflat)
        grads = {}
        for si, sub in leaves.items():
            grads[si] = {}
            for k, p in sub.items():
                g = next(it)
                grads[si][k] = torch.zeros_like(p) if g is None else g
        return score.detach(), grads, _detach_tree(new_state)

    def _apply_updates(self, params, upd_state, grads, iteration: int):
        """Per-layer normalize -> updater -> subtract."""
        new_params, new_upd = {}, {}
        with torch.no_grad():
            for i, (c, upd) in enumerate(zip(self.conf.confs,
                                             self._updaters)):
                si = str(i)
                updates, new_upd[si] = layer_update(
                    c, upd, grads[si], upd_state[si], iteration)
                new_params[si] = {k: p - updates[k]
                                  for k, p in params[si].items()}
        return new_params, new_upd

    def _step_body(self, params, state, upd_state, iteration, rng,
                   features, labels, feature_mask, label_mask):
        """One SGD step; returns (new_params, new_state, new_upd_state,
        score). The JAX step also returns gradient-health scalars; they
        join with the tracing listener that reads them."""
        score, grads, new_state = self._value_and_grad(
            params, state, rng, features, labels, feature_mask, label_mask)
        new_params, new_upd = self._apply_updates(
            params, upd_state, grads, iteration)
        return new_params, new_state, new_upd, score

    def _tensor(self, a, dtype=None):
        if a is None:
            return None
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _check_sgd(self, what: str) -> None:
        if self.conf.backprop_type == BackpropType.TRUNCATED_BPTT:
            raise NotImplementedError(
                f"{what}: truncated BPTT (_fit_tbptt) is not ported to the "
                "torch package yet; use backprop_type STANDARD")
        algo = self.conf.confs[0].optimization_algo
        if algo != OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            raise NotImplementedError(
                f"{what}: {algo} needs the second-order Solver, which is "
                "not ported to the torch package yet; use SGD")

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
                raise NotImplementedError(
                    "pretrain is not ported to the torch package yet")
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
        self._check_sgd("fit")
        n_iter = max(1, self.conf.confs[0].num_iterations)
        feats = self._tensor(ds.features, self._dtype)
        labels = self._tensor(ds.labels, self._dtype)
        fm = self._tensor(ds.features_mask)
        lm = self._tensor(ds.labels_mask)
        examples, tokens = batch_counts(feats)
        for _ in range(n_iter):
            t0 = time.perf_counter()
            (self.params, self.state, self.updater_state,
             score) = self._step_body(
                self.params, self.state, self.updater_state,
                self.iteration, self._gen, feats, labels, fm, lm)
            self.params_version += 1
            self.train_telemetry.record_step(
                dispatch_s=time.perf_counter() - t0, examples=examples,
                tokens=tokens)
            self.score_value = score
            self.iteration += 1
            for listener in self.listeners:
                if listener.invoked_every <= 1 or (
                        self.iteration % listener.invoked_every == 0):
                    listener.iteration_done(self, self.iteration)

    def fit_scan(self, features_stacked, labels_stacked,
                 features_mask_stacked=None, labels_mask_stacked=None
                 ) -> torch.Tensor:
        """K train steps over pre-stacked batches ([K, B, ...] features
        and labels, optional [K, B, T] masks), one after another on the
        device with no host sync; returns the K per-step scores as one
        tensor. Listeners fire once per call (``fire_crossed``). The
        SGD path only: tBPTT and second-order solvers raise."""
        self._check_sgd("fit_scan")
        self.init()
        feats = self._tensor(features_stacked, self._dtype)
        labels = self._tensor(labels_stacked, self._dtype)
        fms = self._tensor(features_mask_stacked)
        lms = self._tensor(labels_mask_stacked)
        start = self.iteration
        t0 = time.perf_counter()
        scores = []
        for j in range(feats.shape[0]):
            (self.params, self.state, self.updater_state,
             score) = self._step_body(
                self.params, self.state, self.updater_state,
                self.iteration, self._gen, feats[j], labels[j],
                None if fms is None else fms[j],
                None if lms is None else lms[j])
            self.params_version += 1
            self.iteration += 1
            scores.append(score)
        scores = torch.stack(scores)
        k, examples, tokens = window_counts(feats.shape)
        self.train_telemetry.record_step(
            dispatch_s=time.perf_counter() - t0, steps=k,
            examples=examples, tokens=tokens)
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

    def set_listeners(self, *listeners) -> None:
        self.listeners = list(listeners)

    def add_listener(self, listener) -> None:
        self.listeners.append(listener)

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
