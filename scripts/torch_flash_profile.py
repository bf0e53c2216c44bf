"""Where K1's (flash attention's) time goes on the card, kernel by kernel.

    python3 scripts/torch_flash_profile.py [T ...]

Needs a CUDA card. At the training path's shape (B=2, H=8, dh=128, bf16,
causal) and each T given (default: training A's 2048 and training B's
32768), runs K1's forward and backward once to build and warm up, then
profiles 3 more with ``torch.profiler`` and prints each device kernel's
mean time per call: the forward kernel, the backward's dK/dV and dQ
kernels, and the torch ops around them (Di = rowsum(dO * O)). Ends with
one JSON line of the same. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from deeplearning4j_tpu_torch.nn.layers.attention import (  # noqa: E402
    flash_attention_bwd,
    flash_attention_fwd,
)

B, H, DH, REPS = 2, 8, 128, 3


def profile_t(t: int) -> dict:
    """{kernel name: mean device ms per call} over REPS fwd + bwd."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(t)
    q, k, v, do = (torch.randn((B, H, t, DH), generator=gen, device="cuda")
                   .bfloat16() for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, True)
    flash_attention_bwd(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            o, lse = flash_attention_fwd(q, k, v, True)
            flash_attention_bwd(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / 1e3 / REPS
            for e in prof.key_averages() if e.device_time_total > 0}


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    report = {}
    for t in [int(a) for a in argv] or [2048, 32768]:
        times = profile_t(t)
        print(f"T={t} (B={B}, H={H}, dh={DH}, bf16, causal), device ms per "
              f"fwd + bwd call [{card}]:")
        for name, ms in sorted(times.items(), key=lambda kv: -kv[1]):
            print(f"  {ms:10.4f}  {name[:100]}")
        report[t] = times
    print(json.dumps({"card": card, "ms": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
