"""ctypes bindings for the native data library, with numpy fallbacks.

A copy of ``deeplearning4j_tpu/native_rt/lib.py`` that differs in how
the library is built. The source is ``native/dl4j_native.cpp`` at the
repo root, a framework-free C++ library with a plain C interface (IDX,
CSV, CIFAR-binary and netpbm decoding, ingest transforms, skip-gram
pair mining, a vocab tokenizer, shuffling and the prefetch ring). At
first use, never at import, it is compiled with ``g++ -O3 -std=c++17
-fPIC -shared -pthread`` into ``_build/`` beside this package's
``__init__.py``, named by a hash of the source and the flags, under a
file lock (concurrent processes never load a half-written library or
compile twice); nothing is written to ``native/``. A build that fails
prints the compiler's output once, and ``native_available()`` is then
False. ``DL4J_TPU_DISABLE_NATIVE`` set to anything non-empty turns the
library off: every entry point then runs its numpy fallback, which gives
the same arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "dl4j_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

RING_CLOSED = -(2 ** 63)  # INT64_MIN sentinel from the C side


def library_path() -> Path:
    """Where the build of the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdl4j_native-{digest.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile ``native/dl4j_native.cpp`` into :func:`library_path`
    unless that build exists; raises ``RuntimeError`` with the
    compiler's output when it fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"no g++ on PATH to build {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    import fcntl

    with open(BUILD_DIR / ".native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():   # another process built it while we waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


class NativeLib:
    """Lazily-loaded singleton around the shared library."""

    _lock = threading.Lock()
    _instance: Optional["NativeLib"] = None
    _load_failed = False

    def __init__(self, cdll: ctypes.CDLL):
        self.lib = cdll
        self._declare()

    def _declare(self) -> None:
        lib = self.lib
        c_i32, c_i64, c_vp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
        p_i32 = ctypes.POINTER(ctypes.c_int32)
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        p_u8 = ctypes.POINTER(ctypes.c_uint8)
        lib.dl4j_free.argtypes = [c_vp]
        lib.dl4j_read_idx.restype = c_vp
        lib.dl4j_read_idx.argtypes = [ctypes.c_char_p, p_i32, p_i64, p_i32]
        lib.dl4j_read_csv.restype = c_vp
        lib.dl4j_read_csv.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                      p_i64, p_i64]
        lib.dl4j_u8_to_f32.argtypes = [c_vp, c_vp, c_i64, ctypes.c_float]
        lib.dl4j_one_hot.restype = c_i32
        lib.dl4j_one_hot.argtypes = [c_vp, c_i64, c_i32, c_vp]
        lib.dl4j_shuffle_indices.argtypes = [c_i64, ctypes.c_uint64, c_vp]
        lib.dl4j_ring_create.restype = c_vp
        lib.dl4j_ring_create.argtypes = [c_i32]
        lib.dl4j_ring_push.restype = c_i32
        lib.dl4j_ring_push.argtypes = [c_vp, c_i64]
        lib.dl4j_ring_pop.restype = c_i64
        lib.dl4j_ring_pop.argtypes = [c_vp]
        lib.dl4j_ring_size.restype = c_i64
        lib.dl4j_ring_size.argtypes = [c_vp]
        lib.dl4j_ring_close.argtypes = [c_vp]
        lib.dl4j_ring_destroy.argtypes = [c_vp]
        lib.dl4j_native_abi_version.restype = c_i32
        lib.dl4j_mine_pairs.restype = c_i64
        lib.dl4j_mine_pairs.argtypes = [
            c_vp, c_vp, c_i64, c_i32, c_vp, ctypes.c_uint64,
            ctypes.POINTER(p_i32), ctypes.POINTER(p_i32)]
        lib.dl4j_read_cifar_bin.restype = c_vp
        lib.dl4j_read_cifar_bin.argtypes = [ctypes.c_char_p, p_i64,
                                            ctypes.POINTER(p_u8)]
        lib.dl4j_read_image_dir.restype = c_vp
        lib.dl4j_read_image_dir.argtypes = [
            ctypes.c_char_p, p_i64, p_i32, p_i32, p_i32,
            ctypes.POINTER(p_u8)]
        lib.dl4j_vocab_new.restype = c_vp
        lib.dl4j_vocab_new.argtypes = [ctypes.c_char_p, c_vp, c_vp, c_i32]
        lib.dl4j_vocab_free.argtypes = [c_vp]
        lib.dl4j_tokenize.restype = c_i64
        lib.dl4j_tokenize.argtypes = [
            c_vp, ctypes.c_char_p, c_i64, ctypes.POINTER(p_i32),
            ctypes.POINTER(p_i32)]

    @classmethod
    def load(cls) -> Optional["NativeLib"]:
        if os.environ.get("DL4J_TPU_DISABLE_NATIVE"):
            return None
        with cls._lock:
            if cls._instance is not None:
                return cls._instance
            if cls._load_failed:
                return None
            try:
                cdll = ctypes.CDLL(str(build_library()))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                # once: later calls see _load_failed and stay quiet
                print(f"native data library unavailable, numpy fallbacks "
                      f"in use: {e}", file=sys.stderr, flush=True)
                cls._load_failed = True
                return None
            cls._instance = cls(cdll)
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        """Forget the loaded library and any failed load (the next
        ``load`` tries again)."""
        with cls._lock:
            cls._instance = None
            cls._load_failed = False


def native_available() -> bool:
    return NativeLib.load() is not None


# ---------------------------------------------------------------------------
# loaders / transforms with fallbacks
# ---------------------------------------------------------------------------

def read_idx(path: str) -> np.ndarray:
    """IDX file -> ndarray. Plain uint8 files (the MNIST hot path)
    decode natively; gzipped or non-uint8 element types take the Python
    parser. ``datasets/mnist`` delegates here."""
    nl = NativeLib.load()
    if nl is not None and not path.endswith(".gz"):
        ndim = ctypes.c_int32()
        shape = (ctypes.c_int64 * 8)()
        elem = ctypes.c_int32()
        ptr = nl.lib.dl4j_read_idx(path.encode(), ctypes.byref(ndim), shape,
                                   ctypes.byref(elem))
        if ptr:
            try:
                dims = tuple(shape[i] for i in range(ndim.value))
                n = int(np.prod(dims))
                view = np.ctypeslib.as_array(
                    ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
                    shape=(n,))
                return view.reshape(dims).copy()  # one copy: view->owned
            finally:
                nl.lib.dl4j_free(ptr)
        # native decode failed (non-uint8 dtype, truncation, bad magic):
        # the Python parser below produces the authoritative error/result
    return _read_idx_py(path)


def _read_idx_py(path: str) -> np.ndarray:
    """Full IDX parser: optional gzip, all six element-type codes
    (reference datasets/mnist/MnistDbFile.java)."""
    import gzip
    import struct

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


def read_csv(path: str, delimiter: str = ",") -> np.ndarray:
    """Numeric CSV -> float64 [rows, cols]. '#' comment lines skipped,
    space/tab padding tolerated (np.loadtxt parity)."""
    nl = NativeLib.load()
    if nl is None:
        return np.loadtxt(path, delimiter=delimiter, dtype=np.float64,
                          ndmin=2)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    ptr = nl.lib.dl4j_read_csv(path.encode(), delimiter.encode(),
                               ctypes.byref(rows), ctypes.byref(cols))
    if not ptr:
        # the native parser is stricter than loadtxt in corners (e.g.
        # '+1.5': from_chars takes no leading plus): the Python path is
        # the authoritative accept/reject decision
        try:
            return np.loadtxt(path, delimiter=delimiter, dtype=np.float64,
                              ndmin=2)
        except Exception as e:
            raise ValueError(f"failed to parse CSV {path}: {e}") from e
    try:
        n = rows.value * cols.value
        view = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_double)), shape=(n,))
        return view.reshape(rows.value, cols.value).copy()  # one copy
    finally:
        nl.lib.dl4j_free(ptr)


def read_cifar_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 binary batch file -> (images u8 [N,3,32,32], labels u8
    [N]). Native decode when available; numpy fallback otherwise.
    Reference datasets/iterator/impl/CifarDataSetIterator.java."""
    nl = NativeLib.load()
    if nl is not None:
        n = ctypes.c_int64()
        labels_ptr = ctypes.POINTER(ctypes.c_uint8)()
        ptr = nl.lib.dl4j_read_cifar_bin(
            path.encode(), ctypes.byref(n), ctypes.byref(labels_ptr))
        if ptr:
            try:
                imgs = np.ctypeslib.as_array(
                    ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
                    shape=(n.value * 3072,)).reshape(n.value, 3, 32, 32
                                                     ).copy()
                labels = np.ctypeslib.as_array(
                    labels_ptr, shape=(n.value,)).copy()
                return imgs, labels
            finally:
                nl.lib.dl4j_free(ptr)
                nl.lib.dl4j_free(
                    ctypes.cast(labels_ptr, ctypes.c_void_p))
        # fall through: the numpy parser raises the authoritative error
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size == 0 or raw.size % 3073:
        raise ValueError(
            f"{path} is not a CIFAR-10 binary batch "
            f"({raw.size} bytes, not a multiple of 3073)")
    rows = raw.reshape(-1, 3073)
    return (rows[:, 1:].reshape(-1, 3, 32, 32).copy(),
            rows[:, 0].copy())


def read_image_dir(root: str
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Class-per-subdirectory netpbm (P5/P6) image tree -> (images u8
    [N,C,H,W], labels u8 [N]); class ids follow sorted subdirectory
    names. Returns None when the native library is unavailable or the
    tree holds no readable netpbm images (callers fall back to the
    PIL reader, which also handles JPEG/PNG)."""
    nl = NativeLib.load()
    if nl is None:
        return None
    n = ctypes.c_int64()
    c = ctypes.c_int32()
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    labels_ptr = ctypes.POINTER(ctypes.c_uint8)()
    ptr = nl.lib.dl4j_read_image_dir(
        root.encode(), ctypes.byref(n), ctypes.byref(c),
        ctypes.byref(h), ctypes.byref(w), ctypes.byref(labels_ptr))
    if not ptr:
        return None
    try:
        shape = (n.value, c.value, h.value, w.value)
        imgs = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
            shape=(int(np.prod(shape)),)).reshape(shape).copy()
        labels = np.ctypeslib.as_array(
            labels_ptr, shape=(n.value,)).copy()
        return imgs, labels
    finally:
        nl.lib.dl4j_free(ptr)
        nl.lib.dl4j_free(ctypes.cast(labels_ptr, ctypes.c_void_p))


def u8_to_f32(src: np.ndarray, scale: float = 1.0 / 255.0) -> np.ndarray:
    """uint8 -> float32 * scale (image normalization hot path)."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    nl = NativeLib.load()
    if nl is None:
        return src.astype(np.float32) * np.float32(scale)
    out = np.empty(src.shape, dtype=np.float32)
    nl.lib.dl4j_u8_to_f32(
        src.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), src.size,
        ctypes.c_float(scale))
    return out


def one_hot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """int labels [N] -> one-hot float32 [N, num_classes]. Labels are
    range-checked BEFORE any dtype narrowing so values like 300 or -1
    raise instead of silently wrapping modulo 256."""
    labels64 = np.ascontiguousarray(labels, dtype=np.int64)
    if labels64.size and (labels64.min() < 0
                          or labels64.max() >= num_classes):
        raise ValueError(
            f"labels outside [0, {num_classes}) for one_hot")
    nl = NativeLib.load()
    if nl is None or num_classes > 256:
        # no np.eye: identity would be num_classes² (10 GB at vocab sizes)
        flat = labels64.ravel()
        out = np.zeros((flat.size, num_classes), dtype=np.float32)
        out[np.arange(flat.size), flat] = 1.0
        return out.reshape(*labels64.shape, num_classes)
    u8 = np.ascontiguousarray(labels64.ravel().astype(np.uint8))
    out = np.empty((u8.size, num_classes), dtype=np.float32)
    rc = nl.lib.dl4j_one_hot(
        u8.ctypes.data_as(ctypes.c_void_p), u8.size,
        num_classes, out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError("label out of range for one_hot")
    return out.reshape(*labels64.shape, num_classes)


def mine_pairs(flat: np.ndarray, seq_id: np.ndarray, window: int,
               keep_prob: Optional[np.ndarray], seed: int
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Skip-gram (center, context) pair mining in C++ (subsampling,
    random window shrink, cross-sequence fencing, shuffle). Returns None
    when the native library is unavailable — callers fall back to a
    vectorized numpy miner."""
    nl = NativeLib.load()
    if nl is None:
        return None
    flat = np.ascontiguousarray(flat, np.int32)
    seq_id = np.ascontiguousarray(seq_id, np.int32)
    kp = (None if keep_prob is None
          else np.ascontiguousarray(keep_prob, np.float32))
    cen = ctypes.POINTER(ctypes.c_int32)()
    ctx = ctypes.POINTER(ctypes.c_int32)()
    n = nl.lib.dl4j_mine_pairs(
        flat.ctypes.data_as(ctypes.c_void_p),
        seq_id.ctypes.data_as(ctypes.c_void_p),
        len(flat), int(window),
        None if kp is None else kp.ctypes.data_as(ctypes.c_void_p),
        int(seed) & (2 ** 64 - 1),
        ctypes.byref(cen), ctypes.byref(ctx))
    if n < 0:
        return None
    if n == 0:
        nl.lib.dl4j_free(cen)  # malloc(0) chunks still need freeing
        nl.lib.dl4j_free(ctx)
        return np.empty(0, np.int32), np.empty(0, np.int32)
    centers = np.ctypeslib.as_array(cen, (n,)).copy()
    contexts = np.ctypeslib.as_array(ctx, (n,)).copy()
    nl.lib.dl4j_free(cen)
    nl.lib.dl4j_free(ctx)
    return centers, contexts


class NativeVocab:
    """C++ word->index hash for dl4j_tokenize; frees itself on gc.
    ``create`` returns None when the native library is unavailable."""

    def __init__(self, nl: "NativeLib", handle: int):
        self._nl = nl
        self._handle = handle

    @classmethod
    def create(cls, words: List[str],
               indices: np.ndarray) -> Optional["NativeVocab"]:
        nl = NativeLib.load()
        if nl is None:
            return None
        enc = [w.encode("utf-8") for w in words]
        buf = b"".join(enc)
        offsets = np.zeros(len(enc) + 1, np.int64)
        np.cumsum([len(e) for e in enc], out=offsets[1:])
        idx = np.ascontiguousarray(indices, np.int32)
        handle = nl.lib.dl4j_vocab_new(
            buf, offsets.ctypes.data_as(ctypes.c_void_p),
            idx.ctypes.data_as(ctypes.c_void_p), len(enc))
        if not handle:
            return None
        return cls(nl, handle)

    def tokenize(self, text: bytes
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Newline-separated sequences of whitespace-separated tokens ->
        (vocab ids, sequence ids); out-of-vocab tokens are skipped."""
        ids = ctypes.POINTER(ctypes.c_int32)()
        sid = ctypes.POINTER(ctypes.c_int32)()
        n = self._nl.lib.dl4j_tokenize(
            self._handle, text, len(text),
            ctypes.byref(ids), ctypes.byref(sid))
        if n < 0:
            return None
        if n == 0:
            self._nl.lib.dl4j_free(ids)
            self._nl.lib.dl4j_free(sid)
            return np.empty(0, np.int32), np.empty(0, np.int32)
        out = (np.ctypeslib.as_array(ids, (n,)).copy(),
               np.ctypeslib.as_array(sid, (n,)).copy())
        self._nl.lib.dl4j_free(ids)
        self._nl.lib.dl4j_free(sid)
        return out

    def __del__(self):
        try:
            self._nl.lib.dl4j_vocab_free(self._handle)
        except Exception:
            pass


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    """Deterministic permutation of [0, n) (SplitMix64 Fisher-Yates)."""
    nl = NativeLib.load()
    out = np.empty(n, dtype=np.int64)
    if nl is None:
        # same algorithm in Python so native/fallback agree bit-for-bit
        out[:] = np.arange(n)
        x = (seed + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        for i in range(n - 1, 0, -1):
            x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
            z = x
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
            z = z ^ (z >> 31)
            j = z % (i + 1)
            out[i], out[j] = out[j], out[i]
        return out
    nl.lib.dl4j_shuffle_indices(n, ctypes.c_uint64(seed),
                                out.ctypes.data_as(ctypes.c_void_p))
    return out


class RingBuffer:
    """Bounded blocking token queue backed by the native MPMC ring;
    pure-Python queue fallback. Tokens are int64."""

    def __init__(self, capacity: int = 4):
        self._nl = NativeLib.load()
        if self._nl is not None:
            self._ring = self._nl.lib.dl4j_ring_create(capacity)
            self._q = None
        else:
            import queue

            self._ring = None
            self._q = queue.Queue(maxsize=capacity)
            self._closed = threading.Event()

    def push(self, token: int) -> bool:
        if self._ring is not None:
            return self._nl.lib.dl4j_ring_push(self._ring, token) == 0
        while not self._closed.is_set():
            try:
                self._q.put(token, timeout=0.05)
                return True
            except Exception:
                continue
        return False

    def pop(self) -> Optional[int]:
        """Blocking; None once closed and drained."""
        if self._ring is not None:
            v = self._nl.lib.dl4j_ring_pop(self._ring)
            return None if v == RING_CLOSED else v
        while True:
            try:
                return self._q.get(timeout=0.05)
            except Exception:
                if self._closed.is_set() and self._q.empty():
                    return None

    def size(self) -> int:
        if self._ring is not None:
            return int(self._nl.lib.dl4j_ring_size(self._ring))
        return self._q.qsize()

    def close(self) -> None:
        if self._ring is not None:
            self._nl.lib.dl4j_ring_close(self._ring)
        else:
            self._closed.set()

    def destroy(self) -> None:
        if self._ring is not None:
            self._nl.lib.dl4j_ring_destroy(self._ring)
            self._ring = None

    def __del__(self):
        try:
            if getattr(self, "_ring", None) is not None:
                self.close()
                self.destroy()
        except Exception:
            pass
