"""Updaters: per-parameter learning rules (port of
``deeplearning4j_tpu/nn/updater``): ``init(params) -> state``;
``update(grads, state, lr, it) -> (updates, state)``, the caller
applying ``params -= updates``."""

from deeplearning4j_tpu_torch.nn.updater.updaters import (  # noqa: F401
    LayerUpdater,
    aggregate_updater_states,
    make_layer_updater,
    normalize_gradients,
)
