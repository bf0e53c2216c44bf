"""Serving readings of the PyTorch port beyond ``chip_smoke.py``'s gate.

    python3 scripts/torch_serving_agreement.py [--repeats N]

Needs a CUDA card. Serves ``chip_smoke.py``'s serving workload (the
width-1024, 8-block transformer flagship at bf16 compute with a
2048-token window, random weights from seed 11; 12 greedy requests of
128-token prompts and 128 new tokens over 8 paged-KV slots) and prints:

- the aggregate tokens/s of ``chip_smoke.py``'s main serving run (a
  warm-up request, then the 12 requests of prompt seed 0 on the kernel
  engine), ``N`` times on fresh engines;
- the free-running greedy-id agreement at bf16 against the plain engine
  (the gather program, ``use_flash_paged=False``) over prompt seeds
  0-7, per seed and per request, for the kernel engine and for a right
  program: the plain one with its score sums reordered
  (``chip_smoke.reordered_sums``). ``chip_smoke.py`` reads the second at
  seed 0 only.

Then one JSON line of the same. Uses ``chip_smoke.py``'s helpers, so it
runs from a tree that holds both files; the package it imports is that
tree's. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    DecodeEngine,
    Request,
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serving_agreement: no CUDA card", file=sys.stderr)
        return 1
    card = cs.gpu_name_and_power()
    net = cs._serving_net("bfloat16")
    geometry = dict(paged_kv=True, block_tokens=cs.BLOCK_TOKENS,
                    n_slots=cs.N_SLOTS, decode_chunk=cs.DECODE_CHUNK)
    prompts = cs.serving_prompts(0)

    rates = []
    for _ in range(args.repeats):
        eng = DecodeEngine(net, use_flash_paged=True, **geometry)
        eng.submit(Request(prompts[0][:16], cs.DECODE_CHUNK + 1))  # warm-up
        eng.run()
        torch.cuda.synchronize()
        _, wall = cs.serve_ids(eng, prompts)
        rates.append(cs.N_REQUESTS * cs.N_GEN / wall)
        print(f"main serving run: {rates[-1]:.1f} tokens/s [{card}]",
              flush=True)

    def ids(use_flash_paged, seed, wrap=None):
        with cs.paged_reference_wrapped(wrap):
            res, _ = cs.serve_ids(DecodeEngine(
                net, use_flash_paged=use_flash_paged, **geometry),
                cs.serving_prompts(seed))
        return [r.tokens for r in res]

    readings = {"kernel": {}, "reordered": {}}
    for s in cs.SERVING_SEEDS:
        plain = ids(False, s)
        for name, run in (("kernel", ids(True, s)),
                          ("reordered", ids(False, s, cs.reordered_sums))):
            per = cs.agreement(run, plain)
            readings[name][s] = float(np.mean(per))
            print(f"bf16 prompt seed {s}, {name} against plain: free-running "
                  f"agreement {readings[name][s]:.4f} (per request "
                  f"{[round(x, 4) for x in per]})", flush=True)
    means = {k: float(np.mean(list(v.values()))) for k, v in readings.items()}
    print(f"bf16 free-running agreement over prompt seeds "
          f"{list(cs.SERVING_SEEDS)}: kernel mean {means['kernel']:.4f}, "
          f"reordered plain mean {means['reordered']:.4f} [{card}]")
    print(json.dumps({"card": card, "tokens_per_s": rates,
                      "agreement": readings, "agreement_mean": means}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
