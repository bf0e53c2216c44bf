"""Where a decode round's time goes in the PyTorch port's serving path.

    python3 scripts/torch_serving_profile.py [--layout paged|dense] [--eager]
        [--fused-rounds K] [--spec-draft-len K]

Needs a CUDA card. Builds the serving configuration ``chip_smoke.py``
drives (the width-1024, 8-block transformer flagship at bf16 compute
with a 2048-token window; random weights from seed 11), fills the
engine's 8 slots with 128-token prompts (the paged-KV layout by
default, ``--layout dense`` for the dense slot pool), and profiles the
decode of their last 32 new tokens, one round, with ``torch.profiler``:
one replay of the round's captured CUDA graph, or with ``--eager`` the
round body run eagerly (the engine's private switch). With
``--fused-rounds K`` every round is a fused window of K rounds (the
requests ask for 4 windows' tokens), and the profiled round is one
replay of the K-round graph. With ``--spec-draft-len K`` the engine
drafts up to K tokens a slot, the prompts are ``chip_smoke.py`` phase
14's (``spec_workload``: the model's own continuations, the 8 most
predictable), and the profiled round is a verify pass and a decode
round: the verify pass's device time (CUDA events around its dispatch)
and the rest of the round are printed apart, with the tokens the round
committed. Prints the
wall time per decode step (and, from one unprofiled round before the
profiled one, the wall per step and the slots' tokens/s without the
profiler), the device's busy and idle shares of that wall
(the sum of kernel times over it: the engine runs on one stream), the
paged-attention kernels' share (K2's two passes, both named
``paged_attention_*``), kernel launches per step and the kernels that
take the most device time, then one JSON line of the same. Before that
window, one more round runs under ``torch.cuda.set_sync_debug_mode
("warn")`` to count the host synchronisations per decode step (each sync
PyTorch sees warns once). ``paged_attention_calls`` counts the
``paged_attention`` wrapper's launches (one per layer per step; a graph
replay adds the ones its capture holds); each launches the two CUDA
kernels that ``paged_attention_kernels`` counts. Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
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
N_SLOTS, DECODE_CHUNK, PROMPT_LEN = 8, 32, 128


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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layout", choices=("paged", "dense"), default="paged")
    ap.add_argument("--eager", action="store_true",
                    help="run the decode round eagerly, not as its graph")
    ap.add_argument("--fused-rounds", type=int, default=0,
                    help="fuse K rounds into each dispatch")
    ap.add_argument("--spec-draft-len", type=int, default=0,
                    help="speculative decoding: draft up to K tokens")
    args = ap.parse_args()
    # the admission's token, then 4 dispatches: one with the
    # admissions, one counting syncs, one unprofiled, one profiled (a
    # speculative round may commit K + 1 more tokens a slot)
    n_gen = 1 + (DECODE_CHUNK * max(args.fused_rounds, 1)
                 + args.spec_draft_len + bool(args.spec_draft_len)) * 4
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
    eng = DecodeEngine(net, paged_kv=args.layout == "paged",
                       block_tokens=16, n_slots=N_SLOTS,
                       decode_chunk=DECODE_CHUNK,
                       fused_rounds=args.fused_rounds,
                       spec_draft_len=args.spec_draft_len)
    if args.eager:
        eng._graphs = None
    if args.spec_draft_len:
        import chip_smoke

        prompts = chip_smoke.spec_workload(net)[0][:N_SLOTS]
    else:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, VOCAB, PROMPT_LEN).tolist()
                   for _ in range(N_SLOTS)]
    # device time of each verify dispatch: CUDA events around it
    marks = []
    dispatch_verify = eng._dispatch_verify

    def timed_verify(drafts, ops):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = dispatch_verify(drafts, ops)
        end.record()
        marks.append((start, end))
        return out

    if args.spec_draft_len:
        eng._dispatch_verify = timed_verify
    eng.submit(Request(prompts[0][:16], DECODE_CHUNK + 1))   # warm-up
    eng.run()
    for p in prompts:
        eng.submit(Request(list(p), n_gen))
    eng.step()          # admissions + the first round, unprofiled
    syncs = syncs_per_step(eng)
    torch.cuda.synchronize()
    steps0 = eng.stats["decode_steps"]
    tokens0 = eng.stats["tokens_generated"]
    t0 = time.perf_counter()
    eng.step()          # one unprofiled round
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    plain_steps = eng.stats["decode_steps"] - steps0
    plain_tokens = eng.stats["tokens_generated"] - tokens0
    steps0 = eng.stats["decode_steps"]
    tokens0 = eng.stats["tokens_generated"]
    spec0 = eng.stats["spec_rounds"]
    launches0 = paged_attention.launches
    marks.clear()
    round_start = torch.cuda.Event(enable_timing=True)
    round_end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        round_start.record()
        eng.step()      # one round: one replay of the captured graph
        round_end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = eng.stats["decode_steps"] - steps0
    tokens = eng.stats["tokens_generated"] - tokens0
    verify_ms = sum(a.elapsed_time(b) for a, b in marks)
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
        "card": card, "layout": args.layout,
        "fused_rounds": args.fused_rounds,
        "round": "eager" if args.eager else "graph",
        "compile_counts": eng.compile_counts(), "decode_steps": steps,
        "ms_per_step": wall / steps * 1e3,
        "unprofiled_ms_per_step": plain_wall / plain_steps * 1e3,
        "unprofiled_tokens_per_s": plain_tokens / plain_wall,
        "spec_draft_len": args.spec_draft_len,
        "round_tokens": tokens,
        "verify_passes": eng.stats["spec_rounds"] - spec0,
        "verify_ms": verify_ms,
        "round_event_ms": round_start.elapsed_time(round_end),
        "device_busy_share": busy_s / wall,
        "device_idle_share": 1.0 - busy_s / wall,
        "paged_attention_share_of_busy": paged_s / busy_s if busy_s else 0,
        "kernels_per_step": n_kernels / steps,
        "paged_attention_calls": paged_attention.launches - launches0,
        "paged_attention_kernels": n_paged,
        "host_syncs_per_step": syncs,
        "top_kernels_ms": [(k[:80], v * 1e-3) for k, v in top],
    }
    print(f"[{card}] {args.layout}, {summary['round']} round "
          f"(fused_rounds={args.fused_rounds}): "
          f"{steps} decode steps of {N_SLOTS} slots in "
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
    if args.spec_draft_len:
        print(f"[{card}] the profiled round committed {tokens} tokens "
              f"with {summary['verify_passes']} verify pass(es): verify "
              f"{verify_ms:.3f} ms of the round's "
              f"{summary['round_event_ms']:.3f} ms between CUDA events "
              f"(acceptance so far {eng.stats['spec_accepted']} / "
              f"{eng.stats['spec_drafted']})")
    for name, ms in summary["top_kernels_ms"]:
        print(f"  {ms:9.3f} ms  {name}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
