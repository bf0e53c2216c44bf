"""Loss-function names.

The ``LossFunction`` enum of ``deeplearning4j_tpu/ops/losses.py``, with
the same wire values so output-layer beans round-trip through the conf
JSON. The loss functions themselves belong to the training slice and are
not ported yet.
"""

from __future__ import annotations

import enum


class LossFunction(str, enum.Enum):
    MSE = "mse"
    EXPLL = "expll"
    XENT = "xent"
    MCXENT = "mcxent"
    RMSE_XENT = "rmse_xent"
    SQUARED_LOSS = "squared_loss"
    RECONSTRUCTION_CROSSENTROPY = "reconstruction_crossentropy"
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    COSINE_PROXIMITY = "cosine_proximity"
    L1 = "l1"
    HINGE = "hinge"
