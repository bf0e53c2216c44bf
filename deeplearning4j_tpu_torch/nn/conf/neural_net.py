"""NeuralNetConfiguration: global hyperparameters + one layer bean.

Mirror of reference nn/conf/NeuralNetConfiguration.java:52-683. The fluent
``Builder`` exposes the same knob set as the reference builder (:286-628:
activation :502, weightInit :510, learningRate :529, l1/l2 :548/:554,
dropOut :559, momentum :565, updater :580, rho/rmsDecay/adam :590-609,
gradientNormalization :618) with snake_case names.

A ``NeuralNetConfiguration`` is pure data. This is the torch package's
copy of ``deeplearning4j_tpu/nn/conf/neural_net.py``: same fields, same
defaults, same JSON.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.conf.distribution import (
    BinomialDistribution,
    NormalDistribution,
    UniformDistribution,
)
from deeplearning4j_tpu_torch.nn.conf.enums import (
    GradientNormalization,
    OptimizationAlgorithm,
    Updater,
    WeightInit,
)
from deeplearning4j_tpu_torch.nn.conf.serde import from_json as _from_json
from deeplearning4j_tpu_torch.nn.conf.serde import register_bean, to_json as _to_json

Distribution = NormalDistribution | UniformDistribution | BinomialDistribution


@register_bean("NeuralNetConfiguration")
@dataclasses.dataclass
class NeuralNetConfiguration:
    layer: Optional[L.Layer] = None

    # Global hyperparameters (overridable per layer bean).
    activation: str = "sigmoid"
    weight_init: WeightInit = WeightInit.XAVIER
    dist: Optional[Distribution] = None
    bias_init: float = 0.0
    learning_rate: float = 1e-1
    learning_rate_schedule: Optional[Dict[int, float]] = None
    # Smooth lr policy (TPU-native addition; the reference only has the
    # piecewise ``learningRateAfter`` map above): "warmup_cosine" ramps
    # linearly from 0 over ``lr_warmup_steps`` then follows a cosine to
    # ``lr_min_fraction``*lr at ``lr_total_steps`` — the standard
    # schedule for transformer convergence at width >= 1024, where a
    # flat lr diverges (BENCHMARKS.md flagship section). Mutually
    # exclusive with learning_rate_schedule.
    lr_policy: Optional[str] = None
    lr_warmup_steps: int = 0
    lr_total_steps: int = 0
    lr_min_fraction: float = 0.1
    momentum: float = 0.5
    momentum_schedule: Optional[Dict[int, float]] = None
    l1: float = 0.0
    l2: float = 0.0
    use_regularization: bool = False
    dropout: float = 0.0
    use_drop_connect: bool = False
    updater: Updater = Updater.SGD
    rho: float = 0.95
    rms_decay: float = 0.95
    adam_mean_decay: float = 0.9
    adam_var_decay: float = 0.999
    epsilon: float = 1e-8
    gradient_normalization: GradientNormalization = GradientNormalization.NONE
    gradient_normalization_threshold: float = 1.0

    # Optimization loop.
    optimization_algo: OptimizationAlgorithm = (
        OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT
    )
    num_iterations: int = 1
    max_num_line_search_iterations: int = 5
    minimize: bool = True
    mini_batch: bool = True

    # Determinism / numerics (TPU-native additions).
    seed: int = 12345
    dtype: str = "float32"
    # Mixed precision: run forward/backward math in this dtype while
    # params/updater state stay in ``dtype`` (f32 master weights). On the
    # card the usual setting is "bfloat16" — matmuls and convs run on the
    # tensor cores; grads reach the f32 masters through the cast.
    compute_dtype: Optional[str] = None

    # ------------------------------------------------------------------
    # Per-layer hyperparameter resolution (layer override -> global).
    # ------------------------------------------------------------------
    def resolved(self, name: str):
        """Value of hyperparameter ``name`` for this conf's layer, applying
        the reference's layer-over-global override rule."""
        if self.layer is not None:
            v = getattr(self.layer, name, None)
            if v is not None:
                return v
        return getattr(self, name)

    # ------------------------------------------------------------------
    # JSON serde (reference toJson :96 / fromJson :110 on the multi-layer
    # conf; single-conf serde also exists there).
    # ------------------------------------------------------------------
    def to_json(self) -> str:
        return _to_json(self)

    @staticmethod
    def from_json(s: str) -> "NeuralNetConfiguration":
        obj = _from_json(s)
        if not isinstance(obj, NeuralNetConfiguration):
            raise ValueError("JSON does not encode a NeuralNetConfiguration")
        return obj

    def clone(self) -> "NeuralNetConfiguration":
        return dataclasses.replace(
            self, layer=dataclasses.replace(self.layer) if self.layer else None
        )

    # ------------------------------------------------------------------
    # Fluent builder (reference NeuralNetConfiguration.Builder :286).
    # ------------------------------------------------------------------
    class Builder:
        def __init__(self):
            self._conf = NeuralNetConfiguration()

        def __getattr__(self, name):
            # Generic chained setter for any dataclass field.
            fields = {f.name for f in dataclasses.fields(NeuralNetConfiguration)}
            if name in fields:

                def setter(value):
                    # Accept the enum member or its name/value as a
                    # string ("LBFGS", "lbfgs") — the tolerance the
                    # reference gets from Jackson enum deserialization.
                    from deeplearning4j_tpu_torch.nn.conf.serde import (
                        coerce_enum_value,
                    )

                    setattr(self._conf, name, coerce_enum_value(
                        NeuralNetConfiguration, name, value))
                    return self

                return setter
            raise AttributeError(name)

        # Named setters with semantics beyond plain assignment.
        def drop_out(self, p: float):
            self._conf.dropout = p
            return self

        def regularization(self, use: bool):
            self._conf.use_regularization = use
            return self

        def iterations(self, n: int):
            self._conf.num_iterations = n
            return self

        def layer(self, layer_bean: L.Layer):
            self._conf.layer = layer_bean
            return self

        def list(self):
            """Start a multi-layer list builder (reference ``.list(n)``)."""
            from deeplearning4j_tpu_torch.nn.conf.multi_layer import ListBuilder

            return ListBuilder(self._conf)

        def graph_builder(self):
            """Start a ComputationGraph configuration builder
            (reference ``.graphBuilder()``)."""
            from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
                GraphBuilder,
            )

            return GraphBuilder(self._conf)

        def build(self) -> "NeuralNetConfiguration":
            return self._conf
