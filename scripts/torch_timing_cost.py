"""What the serving engine's phase clock (``record_timing``) costs on the
card.

    python3 scripts/torch_timing_cost.py [--runs 15]
        [--modes on,off,bare,tracer] [--root DIR]

Phase 6's serving run of ``chip_smoke.py`` (the serving net at bf16, the
paged engine with K2, 8 slots, ``decode_chunk=32``, 12 requests of
128-token prompts and 128 new tokens, prompt seed 0), served by one
engine per mode, after a warm run of each, ``--runs`` times, the modes
in turn within each run (so a drift of the card or the host falls on
every mode alike):

- ``on``: the default engine (``record_timing`` on, a flight recorder of
  256 requests);
- ``off``: ``record_timing=False`` (the flight recorder kept);
- ``bare``: ``record_timing=False, flight_recorder=0``;
- ``tracer``: the default engine with a ``Tracer`` attached (spans,
  counters and the histograms registered: what a gateway attaches).

For each mode: tokens/s from the first submit to the last token (median
and spread), the median of each run's ratio to ``on``'s rate in the same
run, the median host time of ``step()`` (the wall of each call less the
device time it waits for is not separable here, so the whole call), and
the decode rounds a run. Ids must be identical across the modes.

``--root DIR`` measures the package and the ``chip_smoke.py`` of another
tree (an unpacked parent commit) with its default engine alone (pass
``--modes on``). To compare the default engine across two commits, run
this script on both trees in one call: parent, change, change, parent.
The card's name and power limit head the output. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

MODES = ("on", "off", "bare", "tracer")


def _knobs(mode) -> dict:
    if mode == "tracer":
        from deeplearning4j_tpu_torch.profiler.tracer import Tracer

        return {"tracer": Tracer()}
    return {"on": {}, "off": {"record_timing": False},
            "bare": {"record_timing": False, "flight_recorder": 0}}[mode]


def _timed_steps(eng) -> list:
    """Wrap ``eng.step`` to keep each call's wall (s)."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=15)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--root", default=os.path.dirname(HERE),
                    help="the tree whose package and chip_smoke.py run")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from deeplearning4j_tpu_torch.serving import DecodeEngine, Request

    modes = args.modes.split(",")
    card = cs.device_phase()
    cs.build_phase()
    net = cs._serving_net("bfloat16")
    prompts = cs.serving_prompts(0)
    geometry = dict(paged_kv=True, block_tokens=cs.BLOCK_TOKENS,
                    n_slots=cs.N_SLOTS, decode_chunk=cs.DECODE_CHUNK)
    engines = {m: DecodeEngine(net, **geometry, **_knobs(m)) for m in modes}
    walls = {m: _timed_steps(e) for m, e in engines.items()}

    def serve(eng) -> tuple:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [eng.submit(Request(list(p), cs.N_GEN)) for p in prompts]
        rounds0 = eng._round
        res = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        toks = [res[r].tokens for r in rids]
        return sum(map(len, toks)) / dt, eng._round - rounds0, toks

    for m in modes:                                  # warm
        serve(engines[m])
    for w in walls.values():
        w.clear()
    rates = {m: [] for m in modes}
    rounds = {m: set() for m in modes}
    same = True
    for _ in range(args.runs):
        ids = None
        for m in modes:
            rate, n, toks = serve(engines[m])
            rates[m].append(rate)
            rounds[m].add(n)
            same = same and (ids is None or toks == ids)
            ids = toks
    print(f"record_timing cost [paged, bf16, {len(prompts)} x {cs.N_GEN} "
          f"tokens, {cs.N_SLOTS} slots, chunk {cs.DECODE_CHUNK}; tree "
          f"{root}; {args.runs} runs, modes interleaved] [{card}]")
    print(f"{'mode':<7} {'tokens/s':>9} {'spread':>15} {'x on':>7} "
          f"{'step p50 ms':>12} {'rounds':>7}")
    report = {}
    for m in modes:
        ratio = (float(np.median(np.asarray(rates[m])
                                 / np.asarray(rates["on"])))
                 if "on" in rates else None)
        report[m] = {"rates": rates[m], "ratio_to_on": ratio,
                     "step_p50_ms": float(np.median(walls[m])) * 1e3,
                     "rounds": sorted(rounds[m])}
        spread = f"{min(rates[m]):.1f}-{max(rates[m]):.1f}"
        shown = "-" if ratio is None else f"{ratio:.4f}"
        print(f"{m:<7} {float(np.median(rates[m])):>9.1f} {spread:>15} "
              f"{shown:>7} {report[m]['step_p50_ms']:>12.3f} "
              f"{str(report[m]['rounds']):>7}")
    print(f"ids identical across modes: {same}")
    print(json.dumps({"card": card, "root": root, "ids_identical": same,
                      "modes": report}))
    del engines
    torch.cuda.empty_cache()
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
