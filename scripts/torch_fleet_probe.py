"""Phase 18 of ``chip_smoke.py`` (the serving fleet) alone, with
timestamps around the rolling upgrade's steps.

Prints, beside phase 18's own lines, one ``[probe <s>]`` line at the
start and end of ``rolling_upgrade``, of each step's warm
(``FleetController._warm`` and ``ServingRouter.warm_transfer``), join,
drain and reap, with the open streams per replica address and every
stream's token count at that moment, and one line for each KV fetch
from a donor and push into a receiver with its seconds and size. It
answers where an upgrade step's time goes, against how long the streams
it should find in flight still run. Needs the card; run from the root
of the repo:

    python3 scripts/torch_fleet_probe.py
"""
import collections
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from deeplearning4j_tpu_torch.serving import controller as C  # noqa: E402
from deeplearning4j_tpu_torch.serving import router as R  # noqa: E402

T0 = [time.perf_counter()]
ROUTERS = []


def stamp(msg: str) -> None:
    print(f"[probe {time.perf_counter() - T0[0]:8.3f}] {msg}", flush=True)


def streams(router) -> tuple:
    """(open streams per replica address, sorted token counts)."""
    with router._lock:
        entries = list(router._journal.values())
        owners = collections.Counter(e.replica_address for e in entries
                                     if not e.done.is_set())
        return dict(owners), sorted(len(e.tokens) for e in entries)


def around(cls, name: str) -> None:
    f = getattr(cls, name)

    def g(self, *a, **k):
        r = ROUTERS[-1] if ROUTERS else None
        stamp(f"{name} start, open {streams(r) if r else None}")
        try:
            return f(self, *a, **k)
        finally:
            stamp(f"{name} end, open {streams(r) if r else None}")
    setattr(cls, name, g)


def timed(cls, name: str) -> None:
    f = getattr(cls, name)

    def g(self, *a, **k):
        t = time.perf_counter()
        out = f(self, *a, **k)
        size = len(out) if isinstance(out, (bytes, bytearray)) else out
        stamp(f"{name} {time.perf_counter() - t:.3f} s -> {size}")
        return out
    setattr(cls, name, g)


def main() -> int:
    init = R.ServingRouter.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        ROUTERS.append(self)
    R.ServingRouter.__init__ = keep
    for name in ("rolling_upgrade", "_warm", "_join"):
        around(C.FleetController, name)
    for name in ("warm_transfer", "drain_replica"):
        around(R.ServingRouter, name)
    around(cs._FleetChild, "shutdown")
    timed(R.ServingRouter, "_fetch_kv_payload")
    timed(R.ServingRouter, "_push_kv_payload")
    card = cs.device_phase()
    cs.build_phase()
    T0[0] = time.perf_counter()
    cs.fleet_phase(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
