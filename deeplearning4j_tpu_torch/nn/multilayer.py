"""MultiLayerNetwork: the sequential-stack network.

Port of the inference surface of ``deeplearning4j_tpu/nn/
multilayer.py``: ``init``, the mixed-precision forward ``_forward_fn``,
``output``, ``param_table`` and ``set_param``. Parameters are plain
``{layer_index: {name: Tensor}}`` dicts with the JAX package's keys, on
the net's ``device``. Training (``fit``, updaters, losses) and the
streaming ``rnn_time_step``/``generate`` belong to later slices.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import get_impl

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
        self._impls = [get_impl(c.layer) for c in conf.confs]
        self._initialized = False
        #: bumped by every parameter write; the compute-dtype copy of the
        #: params is rebuilt when it moves
        self.params_version = 0
        self._dtype = _dtype_of(conf.dtype)
        cd = _dtype_of(conf.compute_dtype) if conf.compute_dtype else None
        self._compute_dtype = cd if cd != self._dtype else None
        self._cast_cache = (None, None)

    def init(self) -> "MultiLayerNetwork":
        """Draw every layer's parameters from one ``torch.Generator`` on
        the net's device seeded with the conf's seed (the numbers differ
        from the JAX package's; load a model zip to match it)."""
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
        master dtype). The cast of ``self.params`` is cached until the
        next parameter write."""
        cd = self._compute_dtype
        if cd is None:
            return params
        if params is self.params:
            version, cast = self._cast_cache
            if version == self.params_version:
                return cast
        last = str(self.n_layers - 1)
        out_f32 = self._out_f32()
        cast = {si: (sub if (out_f32 and si == last)
                     else _cast_tree(sub, cd))
                for si, sub in params.items()}
        if params is self.params:
            self._cast_cache = (self.params_version, cast)
        return cast

    def _forward_fn(self, params, state, x, rng, train: bool,
                    feature_mask=None, rnn_state=None):
        """Returns (final activations, new_state, new_rnn_state).

        Mixed precision as in the JAX package: compute-dtype params and
        input, except the output layer, which runs at the master dtype;
        carried streaming state is cast back to the master dtype (which
        is why the paged KV pool is float32 while the queries are
        bfloat16 under ``compute_dtype="bfloat16"``)."""
        cd = self._compute_dtype
        out_f32 = self._out_f32()
        last_si = str(self.n_layers - 1)
        params = self._compute_params(params)
        if cd is not None:
            x = _cast_floating(x, cd)
        new_state = dict(state) if state else {}
        new_rnn = {}
        for i, (c, impl) in enumerate(zip(self.conf.confs, self._impls)):
            si = str(i)
            pp = self.conf.preprocessor_for(i)
            if pp is not None:
                x = pp.pre_process(x, rng if train else None)
            layer_state = None
            if state and si in state:
                layer_state = state[si]
            elif rnn_state and si in rnn_state:
                layer_state = rnn_state[si]
            is_recurrent = isinstance(c.layer, L.RECURRENT_LAYER_TYPES)
            mask = feature_mask if is_recurrent else None
            if out_f32 and si == last_si:
                x = _cast_floating(x, self._dtype)
            x, st = impl.apply(c, params[si], x, state=layer_state,
                               train=train, rng=rng if train else None,
                               mask=mask)
            if st is not None:
                if cd is not None:
                    st = _cast_tree(st, self._dtype)
                if state and si in state:
                    new_state[si] = st
                else:
                    new_rnn[si] = st
        return x, new_state, new_rnn

    def output(self, x, train: bool = False) -> torch.Tensor:
        """Forward pass on [N, C, T] (or [N, C]) input; returns the last
        layer's activations as a tensor on the net's device."""
        self.init()
        x = torch.as_tensor(x, dtype=self._dtype, device=self.device)
        with torch.no_grad():
            y, _, _ = self._forward_fn(self.params, self.state, x, None,
                                       False)
        return y

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
