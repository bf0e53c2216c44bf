"""IDX decoding and ingest transforms, numpy only.

Copy of the numpy paths of ``deeplearning4j_tpu/native_rt/lib.py``
(``read_idx``, ``u8_to_f32``, ``one_hot``): the JAX package runs them
when ``native/libdl4j_native.so`` is absent, and they give the same
arrays as its native decode. The ctypes binding of ``native/`` is not
in the torch package yet.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np


def read_idx(path: str) -> np.ndarray:
    """IDX file (optionally gzipped) -> ndarray, for all six element
    types (reference datasets/mnist/MnistDbFile.java)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        head = f.read(4)
        if len(head) != 4:
            raise ValueError(f"truncated IDX header in {path}")
        zero, dtype_code, nd = struct.unpack(">HBB", head)
        if zero != 0:
            raise ValueError(f"bad IDX magic in {path}")
        try:
            dtype = {
                0x08: np.uint8, 0x09: np.int8, 0x0B: np.int16,
                0x0C: np.int32, 0x0D: np.float32, 0x0E: np.float64,
            }[dtype_code]
        except KeyError:
            raise ValueError(
                f"unknown IDX element type 0x{dtype_code:02x} in {path}")
        dims = struct.unpack(">" + "I" * nd, f.read(4 * nd))
        data = np.frombuffer(f.read(),
                             dtype=np.dtype(dtype).newbyteorder(">"))
        expected = int(np.prod(dims)) if dims else 0
        if data.size != expected:
            raise ValueError(
                f"IDX payload has {data.size} elements, header promises "
                f"{expected} in {path}")
        return data.reshape(dims)


def u8_to_f32(src: np.ndarray, scale: float = 1.0 / 255.0) -> np.ndarray:
    """uint8 -> float32 * scale (image normalization)."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    return src.astype(np.float32) * np.float32(scale)


def one_hot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """int labels [N] -> one-hot float32 [N, num_classes]. Labels are
    range-checked before any narrowing, so 300 or -1 raise."""
    labels64 = np.ascontiguousarray(labels, dtype=np.int64)
    if labels64.size and (labels64.min() < 0
                          or labels64.max() >= num_classes):
        raise ValueError(
            f"labels outside [0, {num_classes}) for one_hot")
    flat = labels64.ravel()
    out = np.zeros((flat.size, num_classes), dtype=np.float32)
    out[np.arange(flat.size), flat] = 1.0
    return out.reshape(*labels64.shape, num_classes)
