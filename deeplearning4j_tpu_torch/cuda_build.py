"""Build and load the package's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` has a plain C interface. At first use it
is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``_build/`` beside this file, named by a hash of the source and
the flags, so a changed source rebuilds and an unchanged one loads the
library already built. Libraries are loaded with ``ctypes``; callers set
``argtypes`` on the functions they bind.

Nothing here runs at import time, and nothing falls back: a build that
fails raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: shared memory one block may use on the card (H100: 227 KB), which
#: the wrappers check a launch's need against
SMEM_PER_BLOCK = 232448

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are compiled at first use on a "
            "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, cmd


def _finish(name: str, job, t0: float) -> float:
    if job is None:
        return 0.0
    proc, tmp, out, cmd = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build_all(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source that has no current build, one
    ``nvcc`` per source, all started together; returns the seconds each
    took (0.0 for an existing build)."""
    with _LOCK:
        t0 = time.perf_counter()
        jobs = [(n, _start(n)) for n in names]
        secs, errors = {}, []
        for n, job in jobs:   # wait for every compiler, even after a failure
            try:
                secs[n] = _finish(n, job, t0)
            except RuntimeError as e:
                errors.append(e)
    if errors:
        raise errors[0]
    return secs


class KernelNotExportable(RuntimeError):
    """A forward being exported (``native_rt/aoti.py``) reaches one of
    these kernels: a ctypes call, which ``torch.export`` cannot trace."""


def refuse_tracing(kernel: str, t) -> None:
    """Raise :class:`KernelNotExportable` naming ``kernel`` when ``t`` is
    a meta tensor (the route probe ``native_rt/aoti.py`` runs before it
    traces an export) rather than a tensor on the card: an export never
    swaps in a plain version."""
    if t.is_meta:
        raise KernelNotExportable(
            f"the forward reaches {kernel}, a ctypes call that torch.export "
            "cannot trace; export a forward that stays off it (for K1 a "
            "shorter sequence or use_flash=False; for K3 another route) "
            "until the kernels are registered as TORCH_LIBRARY ops")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib
