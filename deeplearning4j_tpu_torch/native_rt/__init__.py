"""Host-side data runtime of the torch package (``lib.py``, ctypes over
the C++ library ``native/dl4j_native.cpp``, built at first use into
``_build/``): IDX/CSV/CIFAR/netpbm decoding, ingest transforms,
skip-gram pair mining, a vocab tokenizer, shuffling and the prefetch
ring buffer under :class:`NativeAsyncDataSetIterator`. Every entry point
has a numpy fallback, used when the library is off or failed to build;
``native_available()`` says which path is live."""

from deeplearning4j_tpu_torch.native_rt.lib import (  # noqa: F401
    NativeLib,
    NativeVocab,
    RingBuffer,
    mine_pairs,
    native_available,
    one_hot,
    read_cifar_bin,
    read_csv,
    read_idx,
    read_image_dir,
    shuffle_indices,
    u8_to_f32,
)
from deeplearning4j_tpu_torch.native_rt.iterator import (  # noqa: F401
    NativeAsyncDataSetIterator,
)

__all__ = [
    "NativeLib",
    "NativeVocab",
    "RingBuffer",
    "mine_pairs",
    "native_available",
    "one_hot",
    "read_cifar_bin",
    "read_csv",
    "read_idx",
    "read_image_dir",
    "shuffle_indices",
    "u8_to_f32",
    "NativeAsyncDataSetIterator",
]
