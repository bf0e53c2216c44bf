"""Where a LeNet-5 training step's time goes in the PyTorch port.

    python3 scripts/torch_lenet_profile.py

Needs a CUDA card. Builds the configuration ``chip_smoke.py``'s LeNet
phase trains (bench.py's LeNet row: ``lenet5(lr=0.002)``, bf16 compute
with an f32 head, B=2048 synthetic MNIST), warms up with one
``fit_scan`` window, and profiles the next with ``torch.profiler``.
Prints the wall time per step, the device's busy and idle shares of
that wall (the sum of kernel times over it: training runs on one
stream), K3's (``conv_taps``) share of busy time, kernel launches per
step and the kernels that take the most device time, then one JSON line
of the same. Imports nothing of JAX.
"""

from __future__ import annotations

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

from deeplearning4j_tpu_torch.datasets.mnist import (  # noqa: E402
    mnist_dataset,
)
from deeplearning4j_tpu_torch.models.zoo import lenet5  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers.convolution import (  # noqa: E402
    conv_taps,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)

BATCH, WINDOW = 2048, 16


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf = lenet5(lr=0.002)
    for c in conf.confs:
        c.compute_dtype = "bfloat16"
    net = MultiLayerNetwork(conf, device="cuda").init()
    ds = mnist_dataset(train=True, num_examples=BATCH * WINDOW,
                       as_image=True)
    feats = torch.as_tensor(np.stack([b.features for b in
                                      ds.batch_by(BATCH)]), device="cuda")
    labels = torch.as_tensor(np.stack([b.labels for b in
                                       ds.batch_by(BATCH)]), device="cuda")
    net.fit_scan(feats, labels)      # warm-up: cuDNN plans, the build
    torch.cuda.synchronize()
    launches0 = conv_taps.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit_scan(feats, labels)
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
    k3_s = sum(v for k, v in kernels.items() if "conv_taps" in k) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    summary = {
        "card": card, "steps": WINDOW, "batch": BATCH,
        "ms_per_step": wall / WINDOW * 1e3,
        "examples_per_s": BATCH * WINDOW / wall,
        "device_busy_share": busy_s / wall,
        "device_idle_share": 1.0 - busy_s / wall,
        "busy_ms_per_step": busy_s / WINDOW * 1e3,
        "conv_taps_share_of_busy": k3_s / busy_s if busy_s else 0,
        "kernels_per_step": n_kernels / WINDOW,
        "conv_taps_launches": conv_taps.launches - launches0,
        "top_kernels_ms": [(k[:80], v * 1e-3) for k, v in top],
    }
    print(f"[{card}] {WINDOW} LeNet steps at B={BATCH} in {wall:.3f} s: "
          f"{summary['ms_per_step']:.3f} ms per step, device busy "
          f"{summary['device_busy_share']:.1%} (idle "
          f"{summary['device_idle_share']:.1%}, "
          f"{summary['busy_ms_per_step']:.3f} ms busy per step), conv_taps "
          f"{summary['conv_taps_share_of_busy']:.1%} of busy, "
          f"{summary['kernels_per_step']:.0f} kernels per step")
    for name, ms in summary["top_kernels_ms"]:
        print(f"  {ms:9.3f} ms  {name}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
