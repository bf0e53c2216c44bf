"""Gradient checking (finite differences against autograd)."""

from deeplearning4j_tpu_torch.gradientcheck.gradient_check_util import (  # noqa: F401
    check_gradients,
)
