"""The ComputationGraph against the MultiLayerNetwork on the card: the
same layers served and trained, in one call.

    python3 scripts/torch_graph_compare.py [--runs 5] [--steps 4]

Three nets of ``chip_smoke.py``'s width-1024 shapes: the flagship MLN
(phase 6's serving net), its chain twin (a ComputationGraph of the same
vertices, no add vertex, from the MLN's params) and phase 20's DAG LM
(block 4's and block 8's outputs added before the LayerNorm).

- Serving: each net at bf16 on the paged engine with K2 at phase 6's
  knobs (8 slots, ``decode_chunk=32``, window 2048, 12 x 128-token
  prompts x 128 new tokens), its decode round one captured graph, after
  a warm run; ``--runs`` runs with the nets in turn within each run.
  Tokens/s from the first submit, the median host wall of ``step()``
  and the decode rounds; the MLN's and the twin's ids must be identical.
- Training: eager ``fit`` steps at B=2, T=2048 on the Markov task, f32
  and bf16, MLN and DAG in turn, ``--steps`` steps each after one
  warm-up step; the median s/step.

The card's name and power limit head the output. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def _twin(cs, mln, compute_dtype):
    """The chain twin of ``mln`` (its params, vertex ``block<i>`` for
    layer i), on the card."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.streaming import tree_map

    net = ComputationGraph(cs._dag_conf(compute_dtype, None, chain=True,
                                        window=cs.WINDOW),
                           device=cs.DEVICE).init()
    names = [f"block{i}" for i in range(cs.N_LAYERS)] + ["ln", "out"]
    net.params = {name: tree_map(torch.clone, mln.params[str(i)])
                  for i, name in enumerate(names)}
    net.params_version += 1
    return net


def _timed_steps(eng) -> list:
    walls = []
    step = eng.step

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return step(*a, **kw)
        finally:
            walls.append(time.perf_counter() - t0)

    eng.step = timed
    return walls


def serving(cs, runs: int) -> dict:
    from deeplearning4j_tpu_torch.serving import DecodeEngine, Request

    mln = cs._serving_net("bfloat16")
    nets = {"mln": mln, "chain twin": _twin(cs, mln, "bfloat16"),
            "dag": cs._dag_net("bfloat16", None, window=cs.WINDOW)}
    geometry = dict(paged_kv=True, block_tokens=cs.BLOCK_TOKENS,
                    n_slots=cs.N_SLOTS, decode_chunk=cs.DECODE_CHUNK)
    engines = {k: DecodeEngine(n, use_flash_paged=True, **geometry)
               for k, n in nets.items()}
    walls = {k: _timed_steps(e) for k, e in engines.items()}
    prompts = cs.serving_prompts(0)

    def serve(eng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [eng.submit(Request(list(p), cs.N_GEN)) for p in prompts]
        rounds0 = eng._round
        res = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        toks = [res[r].tokens for r in rids]
        return sum(map(len, toks)) / dt, eng._round - rounds0, toks

    ids = {}
    for k, e in engines.items():                      # warm: captures
        ids[k] = serve(e)[2]
    for w in walls.values():
        w.clear()
    rates = {k: [] for k in engines}
    rounds = {k: set() for k in engines}
    for _ in range(runs):
        for k, e in engines.items():
            rate, n, _ = serve(e)
            rates[k].append(rate)
            rounds[k].add(n)
    out = {k: {"tokens_per_s": rates[k],
               "median": float(np.median(rates[k])),
               "step_p50_ms": float(np.median(walls[k])) * 1e3,
               "rounds": sorted(rounds[k]),
               "graphs": engines[k].compile_counts()["decode"]}
           for k in engines}
    out["mln_twin_ids_identical"] = ids["mln"] == ids["chain twin"]
    del engines, nets
    torch.cuda.empty_cache()
    return out


def training(cs, steps: int) -> dict:
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    batches, _ = cs._markov_batches(steps + 1, cs.PARITY_T, sample_seed=1)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=100)
    out = {}
    for cd in ("float32", "bfloat16"):
        nets = {"mln": MultiLayerNetwork(cs._flagship(cd, True, **kw),
                                         device=cs.DEVICE).init(),
                "dag": cs._dag_net(cd, True, **kw)}
        walls = {k: [] for k in nets}
        for f, y in batches:
            for k, net in nets.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                net.fit(f, y)
                float(net.score_value)
                walls[k].append(time.perf_counter() - t0)
        out[cd] = {k: {"s_per_step": w[1:],
                       "median": float(np.median(w[1:]))}
                   for k, w in walls.items()}
        del nets
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    import chip_smoke as cs

    card = cs.device_phase()
    cs.build_phase()
    serve = serving(cs, args.runs)
    train = training(cs, args.steps)
    print(f"serving (paged, bf16, {cs.N_REQUESTS} x {cs.N_GEN} tokens, "
          f"{cs.N_SLOTS} slots, chunk {cs.DECODE_CHUNK}; {args.runs} runs, "
          f"nets in turn) [{card}]")
    for k in ("mln", "chain twin", "dag"):
        r = serve[k]
        print(f"  {k:<10} {r['median']:>9.1f} tokens/s "
              f"({min(r['tokens_per_s']):.1f}-{max(r['tokens_per_s']):.1f})"
              f", step p50 {r['step_p50_ms']:.3f} ms, rounds {r['rounds']}")
    print(f"  MLN and chain twin ids identical: "
          f"{serve['mln_twin_ids_identical']}")
    print(f"eager fit, B={cs.TRAIN_B}, T={cs.PARITY_T}, K1 ({args.steps} "
          f"steps after a warm-up, nets in turn) [{card}]")
    for cd, r in train.items():
        print(f"  {cd}: MLN {r['mln']['median']:.4f} s/step, DAG "
              f"{r['dag']['median']:.4f} s/step")
    print(json.dumps({"card": card, "serving": serve, "training": train}))
    return 0 if serve["mln_twin_ids_identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
