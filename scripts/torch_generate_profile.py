"""Where B=1 ``generate``'s time goes in the PyTorch port.

    python3 scripts/torch_generate_profile.py [--dtype float32] [--eager]

Needs a CUDA card. Builds bench.py's ``bench_decode`` configuration (the
width-1024, 8-block transformer flagship with a 2048-token window, bf16
compute unless ``--dtype float32``; random weights from seed 11),
captures ``generate``'s graph for a 128-token prompt and 128 new tokens
with one warm call, then times one unprofiled call and profiles one
more with ``torch.profiler``: the prompt's prefill (eager) and one
replay of the bucket-128 decode graph, or with ``--eager`` the decode
body run eagerly (the private ``_generate(..., None)``). Prints the wall
per generated token, the device's busy and idle shares of the profiled
wall (the sum of kernel times over it: one stream), the kernels per
generated token and the kernels that take the most device time, then
one JSON line of the same. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from deeplearning4j_tpu_torch.models.zoo import (  # noqa: E402
    transformer_lm_flagship,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)

VOCAB, WIDTH, N_LAYERS, N_HEADS, WINDOW = 64, 1024, 8, 8, 2048
PROMPT_LEN, N_GEN = 128, 128


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--eager", action="store_true",
                    help="run the decode body eagerly, not as its graph")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    conf = transformer_lm_flagship(vocab=VOCAB, width=WIDTH,
                                   n_layers=N_LAYERS, n_heads=N_HEADS,
                                   seed=11)
    for c in conf.confs:
        if args.dtype != "float32":
            c.compute_dtype = args.dtype
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    net = MultiLayerNetwork(conf, device="cuda").init()
    ids = np.random.default_rng(0).integers(0, VOCAB, PROMPT_LEN)
    prompt = torch.zeros((1, VOCAB, PROMPT_LEN))
    prompt[0, torch.as_tensor(ids), torch.arange(PROMPT_LEN)] = 1.0
    prompt = prompt.cuda()
    graphs = None if args.eager else net.generate_graphs

    def call():
        net.rnn_clear_previous_state()
        return net._generate(prompt, N_GEN, graphs)

    call()                       # warm: captures the bucket's graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    n_kernels = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.device_time_total)
            n_kernels += 1
    busy_s = sum(kernels.values()) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    summary = {
        "card": card, "dtype": args.dtype,
        "decode": "eager" if args.eager else "graph",
        "graphs": len(net.generate_graphs), "tokens": N_GEN,
        "ms_per_token": wall / N_GEN * 1e3,
        "unprofiled_ms_per_token": plain_wall / N_GEN * 1e3,
        "unprofiled_tokens_per_s": N_GEN / plain_wall,
        "device_busy_share": busy_s / wall,
        "device_idle_share": 1.0 - busy_s / wall,
        "kernels_per_token": n_kernels / N_GEN,
        "top_kernels_ms": [(k[:80], v * 1e-3) for k, v in top],
    }
    print(f"[{card}] generate B=1, {args.dtype}, {summary['decode']} "
          f"decode: {PROMPT_LEN}-token prefill + {N_GEN} tokens in "
          f"{wall:.4f} s profiled: {summary['ms_per_token']:.3f} ms per "
          f"token ({summary['unprofiled_ms_per_token']:.3f} ms, "
          f"{summary['unprofiled_tokens_per_s']:.1f} tokens/s unprofiled),"
          f" device busy {summary['device_busy_share']:.1%} (idle "
          f"{summary['device_idle_share']:.1%}), "
          f"{summary['kernels_per_token']:.0f} kernels per token")
    for name, ms in summary["top_kernels_ms"]:
        print(f"  {ms:9.3f} ms  {name}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
