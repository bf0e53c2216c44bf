"""Where the serving gateway's host time goes on the card.

    python3 scripts/torch_gateway_profile.py [--layout paged|dense]
        [--trials 5]

The configuration of ``chip_smoke.py``'s gateway phase (the serving net
at bf16, 8 slots, ``decode_chunk=32``, 8 requests of 128-token prompts
and 128 new tokens, keep-alive 1 s, admission grace 0.25 s), served in
four ways:

- ``inproc``: ``DecodeEngine.run()`` in process, no gateway, timed from
  the first submit;
- ``sse-threads``: 8 SSE clients as threads of this process (they share
  this process's interpreter lock with the gateway's stepping and
  handler threads);
- ``sse-process``: the same 8 SSE clients in a child process (the
  gateway phase's clients, ``chip_smoke._Clients``);
- ``blocking-process``: 8 blocking ``/v1/generate`` clients in a child
  process (no delta fan-out, no SSE framing: one terminal a request).

After a warm round of each, ``--trials`` trials each run the four modes
in turn (so a drift of the card or the host falls on every mode alike).
For each mode: tokens/s (median over the trials and their spread), and
the median of the values the engine observes into
``serving_host_step_s`` (its host time between a round's token sync and
the next dispatch; the gap between two rounds of requests falls in it
once a round, so its tail is not read), ``serving_round_s`` (a round's
wall) and ``serving_ttft_s``, recorded exactly per mode (the
histograms' own quantiles are good to a bucket, a factor of 1.78), and
the decode rounds a trial. The gap between ``inproc`` and the gateway
modes is the gateway's cost to the stepping thread; between
``sse-threads`` and ``sse-process``, what in-process clients cost;
between ``sse-process`` and ``blocking-process``, the delta fan-out and
SSE framing. The card's name and power limit head the output. Needs
one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

#: the engine observations the report reads
OBSERVED = ("serving_host_step_s", "serving_round_s", "serving_ttft_s")
MODES = ("inproc", "sse-threads", "sse-process", "blocking-process")


def _record(eng) -> dict:
    """Wrap ``eng._observe`` to keep every value of ``OBSERVED``; the
    lists it returns fill as the engine runs (``_take`` empties them)."""
    raw = {name: [] for name in OBSERVED}
    observe = eng._observe

    def recording(name, value, n=1):
        if name in raw and value is not None:
            raw[name].append(value)
        observe(name, value, n)

    eng._observe = recording
    return raw


def _take(raw) -> dict:
    out = {name: list(values) for name, values in raw.items()}
    for values in raw.values():
        values.clear()
    return out


def main(argv=None) -> int:
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layout", choices=tuple(cs.GATEWAY_LAYOUTS),
                    default="paged")
    ap.add_argument("--trials", type=int, default=5)
    args = ap.parse_args(argv)
    card = cs.device_phase()
    cs.build_phase()
    net = cs._serving_net("bfloat16")
    prompts = cs.serving_prompts(0, n=cs.N_SLOTS)
    geometry = dict(n_slots=cs.N_SLOTS, decode_chunk=cs.DECODE_CHUNK,
                    **cs.GATEWAY_LAYOUTS[args.layout])
    inproc = DecodeEngine(net, **geometry)
    gw_eng = DecodeEngine(net, **geometry)
    raws = {"inproc": _record(inproc), "gateway": _record(gw_eng)}
    gw = cs._gateway(gw_eng)
    job = {"address": gw.address, "prompts": prompts, "n_gen": cs.N_GEN}

    def run(mode, clients) -> tuple:
        """One round in ``mode``: (tokens/s, decode rounds, the
        engine's observations)."""
        eng = inproc if mode == "inproc" else gw_eng
        rounds0 = eng._round
        if mode == "inproc":
            rate = cs._inproc_round(inproc, prompts, cs.N_GEN)[0]
        elif mode == "sse-threads":
            h = cs._client_round(dict(job, mode="sse"))
            if h["errors"]:
                raise SystemExit(f"torch_gateway_profile: {h['errors']}")
            rate = sum(len(o) for o in h["outs"]) / h["wall"]
        else:
            kind = "sse" if mode == "sse-process" else "blocking"
            rate = clients.round(gw.address, prompts, cs.N_GEN,
                                 mode=kind)["rate"]
        raw = raws["inproc" if mode == "inproc" else "gateway"]
        return rate, eng._round - rounds0, _take(raw)

    rows = {m: {"rates": [], "rounds": [], **{k: [] for k in OBSERVED}}
            for m in MODES}
    try:
        with cs._Clients() as clients:
            for mode in MODES:              # warm
                run(mode, clients)
            for _ in range(args.trials):
                for mode in MODES:
                    rate, rounds, obs = run(mode, clients)
                    rows[mode]["rates"].append(rate)
                    rows[mode]["rounds"].append(rounds)
                    for k in OBSERVED:
                        rows[mode][k] += obs[k]
    finally:
        gw.close()
    print(f"gateway host cost [{args.layout}, bf16, {cs.N_SLOTS} x "
          f"{cs.N_GEN} tokens, chunk {cs.DECODE_CHUNK}; {args.trials} "
          f"trials, modes interleaved] [{card}]")
    print(f"{'mode':<18} {'tokens/s':>9} {'spread':>15} {'x inproc':>9} "
          f"{'host p50 ms':>12} {'round p50 ms':>13} {'ttft p50 ms':>12} "
          f"{'rounds':>7}")
    report = {}
    base = float(np.median(rows["inproc"]["rates"]))
    for mode, r in rows.items():
        med = float(np.median(r["rates"]))
        report[mode] = {
            "rates": r["rates"], "rounds": r["rounds"],
            **{f"{k}_p50_ms": float(np.median(r[k])) * 1e3
               for k in OBSERVED}}
        spread = f"{min(r['rates']):.1f}-{max(r['rates']):.1f}"
        print(f"{mode:<18} {med:>9.1f} {spread:>15} {med / base:>9.3f} "
              f"{report[mode]['serving_host_step_s_p50_ms']:>12.3f} "
              f"{report[mode]['serving_round_s_p50_ms']:>13.3f} "
              f"{report[mode]['serving_ttft_s_p50_ms']:>12.3f} "
              f"{sorted(set(r['rounds']))!s:>7}")
    print(json.dumps({"card": card, "layout": args.layout, "rows": report}))
    del inproc, gw_eng
    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
