"""K3's tensor-core kernel without its ordered fix-up, beside the product.

    python3 scripts/torch_conv_taps_variants.py

Needs a CUDA card and ``nvcc``. Builds ``csrc/conv_taps.cu`` with the
flags of ``cuda_build``, once as the product is built and once with
``-DDL4J_CONV_TAPS_FIX_REL=0`` (no ordered fix-up: neither its second
mma nor its list), one ``nvcc`` a variant, both started together. At
``chip_smoke.py``'s main K3 case (B=2048, 28x28 -> 24x24, 20 channels,
5x5, bf16 x and W, the same seed) it prints, for each variant, the
output's largest distance from the plain version in bf16 ulps, the
outputs over 1 ulp, the largest |out| / s among them (s = sum |w x|),
and its device time from a CUDA graph of back-to-back launches, the
variants taken in turn over several rounds; also the share of outputs
the fix-up recomputes. Ends with one JSON line of the same. Imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from deeplearning4j_tpu_torch import cuda_build  # noqa: E402
from deeplearning4j_tpu_torch.nn.layers import convolution as tconv  # noqa: E402

VARIANTS = {"product": (), "no fix-up": ("-DDL4J_CONV_TAPS_FIX_REL=0",)}
B, O, K, HW, SEED = 2048, 20, 5, 28, 23
FIX_REL, ROUNDS = 2.0 ** -10, 5


def build(variants: dict) -> dict:
    """{variant: loaded library}, one nvcc each, all started together."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.CSRC / "conv_taps.cu"
    jobs = {}
    for i, (name, defines) in enumerate(variants.items()):
        out = cuda_build.BUILD_DIR / f"variant{i}-conv_taps-{os.getpid()}.so"
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, *defines,
               "-o", str(out), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      out)
    libs = {}
    for name, (proc, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = tconv.bind_conv_taps(ctypes.CDLL(str(out)))
        out.unlink()
    return libs


def launcher(lib):
    def run(x, w):
        real = tconv._conv_taps_lib
        tconv._conv_taps_lib = lambda: lib
        try:
            return tconv._conv_taps_mma_launch(x, w, (0, 0))
        finally:
            tconv._conv_taps_lib = real
    return run


def graph_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one ``fn()`` from a CUDA graph of ``reps`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def ulp_map(got, want):
    """|got - want| in bf16 ulps of the larger magnitude, elementwise."""
    g, r = got.float(), want.float()
    mag = torch.maximum(g.abs(), r.abs()).clamp_min(2.0 ** -126)
    return (g - r).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = build(VARIANTS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    x = torch.rand(B, 1, HW, HW, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(O, K, K, generator=gen, device="cuda") * 0.1).bfloat16()
    want = tconv.conv_taps_reference(x, w)
    xf, wf = x.float(), w.float()[:, None]
    ratio = F.conv2d(xf, wf).abs() / F.conv2d(xf.abs(), wf.abs())
    print(f"the fix-up at 2^-10 recomputes "
          f"{float((ratio < FIX_REL).float().mean()):.6%} of outputs",
          flush=True)
    runs = {name: launcher(lib) for name, lib in libs.items()}
    res = {}
    for name, run in runs.items():
        got = run(x, w)
        torch.cuda.synchronize()
        ulps = ulp_map(got, want)
        over = ulps > 1.0
        res[name] = dict(
            ulps=float(ulps.max()), over_1_ulp=int(over.sum()),
            worst_out_over_s=(float(ratio[over].max())
                              if bool(over.any()) else 0.0),
            ms=[])
    for _ in range(ROUNDS):
        for name, run in runs.items():
            res[name]["ms"].append(graph_ms(lambda: run(x, w)))
    for name, r in res.items():
        r["ms_median"] = statistics.median(r["ms"])
        print(f"{name}: {r['ulps']:.2f} bf16 ulps, {r['over_1_ulp']} outputs "
              f"over 1 ulp (largest |out| / s {r['worst_out_over_s']:.3e}); "
              f"device ms median {r['ms_median']:.5f} of "
              f"{[round(t, 5) for t in r['ms']]}", flush=True)
    print(json.dumps({"card": card, "variants": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
