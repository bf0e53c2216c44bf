"""Device selection for the package's entry points.

Entry points take an explicit ``device`` and default to ``"cuda"``: the
package serves on the card unless the caller asks for the CPU (the tests
do). A CUDA device on a machine without CUDA raises instead of running
elsewhere.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available "
            f"(torch {torch.__version__}, CUDA build "
            f"{torch.version.cuda}); pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
