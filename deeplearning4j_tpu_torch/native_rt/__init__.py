"""Host-side data runtime of the torch package: the IDX reader and the
ingest transforms MNIST loading calls (``lib.py``)."""

from deeplearning4j_tpu_torch.native_rt.lib import (  # noqa: F401
    one_hot,
    read_idx,
    u8_to_f32,
)
