"""What ``nvcc`` made of the port's CUDA kernels.

    python3 scripts/torch_kernel_sass.py [name ...]

Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), not a card. For each
named source ``deeplearning4j_tpu_torch/csrc/<name>.cu`` (default:
``flash_attention``) it compiles the source once more with the flags of
``cuda_build`` plus ``-Xptxas -v`` into a scratch file under ``_build/``
and prints what ``ptxas`` says of each kernel (registers, shared memory,
spills, and any warning such as a serialised ``wgmma``); then it builds
the library as ``cuda_build`` does and counts, in each kernel's SASS
(``cuobjdump -sass``), the instructions that show how it runs: HGMMA
(wgmma), HMMA (mma.sync), UTMALDG (TMA tile loads), UBLKCP (bulk
copies between global and shared memory), SYNCS (mbarrier operations),
FFMA, LDS/STS (shared-memory loads and stores), ATOMS (shared-memory
atomics), and STL/LDL (local-memory stores and loads: register spills).
The counts are of the SASS as compiled (a loop's body once), not of
instructions executed. Ends with one JSON line of the counts. Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from deeplearning4j_tpu_torch import cuda_build  # noqa: E402

OPCODES = ("HGMMA", "HMMA", "UTMALDG", "UBLKCP", "SYNCS", "FFMA", "LDS",
           "STS", "ATOMS", "STL", "LDL")


def ptxas_report(name: str) -> list:
    """ptxas -v's lines for ``csrc/<name>.cu``, compiled with
    cuda_build's flags into a scratch library that is then removed."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = cuda_build.BUILD_DIR / f"ptxas-{name}-{os.getpid()}.so"
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
           "-o", str(out), str(cuda_build.CSRC / f"{name}.cu")]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             check=True, timeout=600)
    finally:
        out.unlink(missing_ok=True)
    lines, kernel = [], None
    for ln in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            kernel = _demangled(m.group(1))
        elif "Used" in ln or "spill" in ln or "stack" in ln:
            lines.append(f"{kernel}: {ln.split(':', 1)[-1].strip()}")
        elif "warning" in ln.lower() or "Performance Loss" in ln:
            sym = _mangled(ln)
            lines.append(ln.replace(sym, _demangled(sym)) if sym else ln)
    return lines


def _mangled(line: str):
    """The mangled kernel name a ptxas message quotes, or None."""
    m = re.search(r"'(_Z\w+)'", line)
    return m.group(1) if m else None


def _demangled(sym: str) -> str:
    filt = shutil.which("cu++filt") or str(
        Path(cuda_build.nvcc_path()).parent / "cu++filt")
    try:
        return subprocess.run([filt, sym], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return sym


def sass_counts(name: str) -> dict:
    """{kernel: {opcode: count}} from cuobjdump -sass of the library
    cuda_build builds for ``csrc/<name>.cu``."""
    cuda_build.build_all([name])
    lib = cuda_build.library_path(name)
    tool = Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=600).stdout
    counts, kernel = {}, None
    for ln in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            kernel = _demangled(m.group(1))
            counts[kernel] = dict.fromkeys(OPCODES, 0)
            continue
        if kernel is None:
            continue
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", ln)
        if m and m.group(1) in OPCODES:
            counts[kernel][m.group(1)] += 1
    return counts


def main(argv) -> int:
    names = argv or ["flash_attention"]
    report = {}
    for name in names:
        print(f"== {name}: ptxas -v ({' '.join(cuda_build.NVCC_FLAGS)})")
        for ln in ptxas_report(name):
            print(ln)
        counts = sass_counts(name)
        print(f"== {name}: SASS instructions per kernel "
              f"({', '.join(OPCODES)})")
        for kernel, c in counts.items():
            print(f"{kernel}: " + ", ".join(f"{op} {c[op]}"
                                           for op in OPCODES))
        report[name] = counts
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
