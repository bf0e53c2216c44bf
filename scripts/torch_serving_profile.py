"""Where a decode round's time goes in the PyTorch port's serving path.

    python3 scripts/torch_serving_profile.py

Needs a CUDA card. Builds the serving configuration ``chip_smoke.py``
drives (the width-1024, 8-block transformer flagship at bf16 compute
with a 2048-token window; random weights from seed 11), fills the
paged-KV engine's 8 slots with 128-token prompts, and profiles the
decode of their last 32 new tokens with ``torch.profiler``. Prints the
wall time per decode step (and, from one unprofiled round before the
profiled one, the wall per step and the slots' tokens/s without the
profiler), the device's busy and idle shares of that wall
(the sum of kernel times over it: the engine runs on one stream), the
paged-attention kernels' share (K2's two passes, both named
``paged_attention_*``), kernel launches per step and the kernels that
take the most device time, then one JSON line of the same. Before that
window, one more round runs under ``torch.cuda.set_sync_debug_mode
("warn")`` to count the host synchronisations per decode step (each sync
PyTorch sees warns once). ``paged_attention_calls`` counts calls of the
``paged_attention`` wrapper (one per layer per step); each call launches
the two CUDA kernels that ``paged_attention_kernels`` counts. Imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from deeplearning4j_tpu_torch.models.zoo import (  # noqa: E402
    transformer_lm_flagship,
)
from deeplearning4j_tpu_torch.nn.layers.attention import (  # noqa: E402
    paged_attention,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    DecodeEngine,
    Request,
)

VOCAB, WIDTH, N_LAYERS, N_HEADS, WINDOW = 64, 1024, 8, 8, 2048
N_SLOTS, DECODE_CHUNK, PROMPT_LEN, N_GEN = 8, 32, 128, 129


def syncs_per_step(eng) -> float:
    """Host synchronisations per decode step over one scheduling round,
    as ``set_sync_debug_mode("warn")`` counts them."""
    steps0 = eng.stats["decode_steps"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n = sum("synchronizing CUDA operation" in str(w.message)
            for w in caught)
    return n / max(1, eng.stats["decode_steps"] - steps0)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    conf = transformer_lm_flagship(vocab=VOCAB, width=WIDTH,
                                   n_layers=N_LAYERS, n_heads=N_HEADS,
                                   seed=11)
    for c in conf.confs:
        c.compute_dtype = "bfloat16"
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    net = MultiLayerNetwork(conf, device="cuda").init()
    eng = DecodeEngine(net, paged_kv=True, block_tokens=16,
                       n_slots=N_SLOTS, decode_chunk=DECODE_CHUNK)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, PROMPT_LEN).tolist()
               for _ in range(N_SLOTS)]
    eng.submit(Request(prompts[0][:16], DECODE_CHUNK + 1))   # warm-up
    eng.run()
    for p in prompts:
        eng.submit(Request(list(p), N_GEN))
    eng.step()          # admissions + the first round, unprofiled
    syncs = syncs_per_step(eng)
    torch.cuda.synchronize()
    steps0 = eng.stats["decode_steps"]
    t0 = time.perf_counter()
    eng.step()          # one unprofiled round
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    plain_steps = eng.stats["decode_steps"] - steps0
    steps0 = eng.stats["decode_steps"]
    launches0 = paged_attention.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while eng.has_work():
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = eng.stats["decode_steps"] - steps0
    kernels = {}
    n_kernels = n_paged = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.device_time_total)
            n_kernels += 1
            n_paged += "paged_attention" in ev.name
    busy_s = sum(kernels.values()) * 1e-6
    paged_s = sum(v for k, v in kernels.items()
                  if "paged_attention" in k) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    summary = {
        "card": card, "decode_steps": steps,
        "ms_per_step": wall / steps * 1e3,
        "unprofiled_ms_per_step": plain_wall / plain_steps * 1e3,
        "unprofiled_tokens_per_s": N_SLOTS * plain_steps / plain_wall,
        "device_busy_share": busy_s / wall,
        "device_idle_share": 1.0 - busy_s / wall,
        "paged_attention_share_of_busy": paged_s / busy_s if busy_s else 0,
        "kernels_per_step": n_kernels / steps,
        "paged_attention_calls": paged_attention.launches - launches0,
        "paged_attention_kernels": n_paged,
        "host_syncs_per_step": syncs,
        "top_kernels_ms": [(k[:80], v * 1e-3) for k, v in top],
    }
    print(f"[{card}] {steps} decode steps of {N_SLOTS} slots in "
          f"{wall:.3f} s: {summary['ms_per_step']:.2f} ms per step "
          f"({summary['unprofiled_ms_per_step']:.2f} ms, "
          f"{summary['unprofiled_tokens_per_s']:.1f} tokens/s unprofiled), "
          f"device "
          f"busy {summary['device_busy_share']:.1%} (idle "
          f"{summary['device_idle_share']:.1%}), paged attention "
          f"{summary['paged_attention_share_of_busy']:.1%} of busy, "
          f"{summary['kernels_per_step']:.0f} kernels per step, "
          f"{syncs:.3f} host syncs per step; paged_attention wrapper calls "
          f"{summary['paged_attention_calls']} (each launches 2 CUDA "
          f"kernels: {n_paged} paged_attention kernels profiled)")
    for name, ms in summary["top_kernels_ms"]:
        print(f"  {ms:9.3f} ms  {name}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
