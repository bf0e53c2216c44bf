"""K3's time at LeNet's conv1 shape, to hold two trees against each other.

    python3 scripts/torch_conv_taps_time.py [--dtype float32|bfloat16]
                                            [--rounds N]

Needs a CUDA card and ``nvcc``. Imports the port, and the shape and the
CUDA-graph timer of ``torch_conv_taps_variants.py`` beside it, from the
tree this file sits in, so a copy of it inside an unpacked older tree
(which has that script too) times that tree's kernel; run the trees in
turns (old, new, new, old) within one call. At ``chip_smoke.py``'s main
K3 case (B=2048, 28x28 -> 24x24, 20 channels,
5x5; x from ``torch.rand`` and bf16-valued W from ``0.1 * torch.randn``
on a card generator seeded 23) with W in f32, so that ``conv_taps``
takes its CUDA-core kernel, and x in ``--dtype`` (default float32), it
prints for each round the kernel's time eagerly (CUDA events over 100
calls) and on the device (a CUDA graph of 20 calls), then the output's
largest distance from the plain version over the plain version's
largest value, and a SHA-256 of the output's bytes (the same digest from
two trees: the same bits), with the card's name and power limit. Ends
with one JSON line of the same. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from deeplearning4j_tpu_torch.nn.layers.convolution import (  # noqa: E402
    conv_taps,
    conv_taps_reference,
)
from torch_conv_taps_variants import (  # noqa: E402
    B,
    HW,
    K,
    O,
    SEED,
    graph_ms,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def eager_ms(fn, iters: int = 100, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    x = torch.rand(B, 1, HW, HW, generator=gen, device="cuda").to(
        DTYPES[args.dtype])
    w = (torch.randn(O, K, K, generator=gen, device="cuda")
         * 0.1).bfloat16().float()
    got = conv_taps(x, w)
    torch.cuda.synchronize()
    want = conv_taps_reference(x, w)
    rel = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    digest = hashlib.sha256(got.cpu().contiguous().view(torch.uint8)
                            .numpy().tobytes()).hexdigest()
    eager, device = [], []
    for _ in range(args.rounds):
        eager.append(eager_ms(lambda: conv_taps(x, w)))
        device.append(graph_ms(lambda: conv_taps(x, w)))
    res = dict(tree=ROOT, card=card, dtype=args.dtype, eager_ms=eager,
               device_ms=device, eager_ms_median=statistics.median(eager),
               device_ms_median=statistics.median(device),
               rel_err=rel, sha256=digest)
    print(f"[{card}] conv_taps B={B}, {HW}x{HW}, {K}x{K}, x {args.dtype}, "
          f"W float32 ({ROOT}): eager ms {[round(t, 5) for t in eager]}, "
          f"device ms {[round(t, 5) for t in device]}; / max|ref| "
          f"{rel:.3e}; output sha256 {digest[:16]}", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
