"""Deterministic fault injection for the serving runtime (port of
``deeplearning4j_tpu/serving/faults.py``).

Production serving treats failure as an input, not an exception path
(Clockwork, Gujarati et al. OSDI'20): a NaN'd sampler, a failed
allocation, a stalled dispatch, or a corrupted cache row must cost ONE
request (bounded by its retry cap), never the batch. The only way to
keep that property true over time is to rehearse it — so faults here
are *data*: a seeded :class:`FaultPlan` names exactly which round gets
which fault, the engine injects it on schedule, and tests assert the
blast radius (victims reach a terminal state, healthy slots are
bit-unaffected, graph counts stay bounded).

Fault kinds (each exercises a different subsystem):

- ``"nan"`` — poison a live slot's KV rows with NaN (a sampler/matmul
  NaN in the wild). Detected by the engine's ``paranoid`` per-round
  finiteness sweep; the slot is quarantined (rows zeroed) and the
  victim re-queued.
- ``"admit_fail"`` — the next admission this round fails before any
  device work (an allocation failure). The victim re-queues with
  backoff; no slot is touched.
- ``"stall"`` — the round stalls ``seconds`` (a slow dispatch /
  preempted host). Surfaces as a ``slow_steps`` event when the round
  exceeds ``stall_threshold_s``; deadlines keep firing through it.
- ``"cache_corrupt"`` — poison a stored prefix-cache row with NaN (bit
  rot / a buggy writer). The corruption rides a later prefix hit into
  a slot, the paranoid sweep catches it, and the engine invalidates
  the poisoned entries before retrying the victim cold.

Injection happens outside the engine's captured graphs: ``poison_rows``
writes NaN into the pool tensors IN PLACE. Those tensors are the
graphs' static inputs, so a poison that built new tensors would leave
every replay reading the old, clean ones and the fault would never
happen on the card. A plan never changes the graph counts; the one new
graph of a fault-tolerant engine is the ``paranoid`` health check
itself (see ``DecodeEngine``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.streaming import tree_leaves

#: every fault kind a plan may schedule
FAULT_KINDS = ("nan", "admit_fail", "stall", "cache_corrupt")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: at engine round ``round``, inject ``kind``.

    ``slot`` targets a specific slot ("nan"; None = first active),
    ``row`` a specific prefix-cache row ("cache_corrupt"; None = the
    lowest stored row), ``seconds`` the stall length ("stall")."""

    round: int
    kind: str
    slot: Optional[int] = None
    row: Optional[int] = None
    seconds: float = 0.05

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind {self.kind!r}: expected one of "
                f"{FAULT_KINDS}")
        if self.round < 0:
            raise ValueError(f"fault round {self.round} < 0")
        if self.seconds < 0:
            raise ValueError(f"stall seconds {self.seconds} < 0")


class FaultPlan:
    """A deterministic schedule of :class:`FaultEvent`s.

    Build explicitly (``FaultPlan([FaultEvent(3, "nan"), ...])``) or
    seeded (:meth:`random`) — either way the plan is pure data, so the
    same plan replays the same failure sequence on every run (the
    chaos-parity gate depends on this). ``injected`` records what the
    engine actually applied, for assertions and soak reports."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        self.events: List[FaultEvent] = sorted(
            events, key=lambda e: (e.round, e.kind))
        self.injected: List[FaultEvent] = []

    @classmethod
    def random(cls, seed: int, rounds: int,
               kinds: Sequence[str] = FAULT_KINDS,
               rate: float = 0.1) -> "FaultPlan":
        """Seeded plan: each round draws each kind independently with
        probability ``rate`` (aggressive soaks use ``rate >= 0.1``)."""
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"fault kind {k!r}")
        rng = np.random.default_rng(seed)
        events = [FaultEvent(r, k)
                  for r in range(rounds) for k in kinds
                  if rng.random() < rate]
        return cls(events)

    def events_at(self, round_: int) -> List[FaultEvent]:
        return [e for e in self.events if e.round == round_]

    def record(self, event: FaultEvent) -> None:
        self.injected.append(event)

    def __len__(self) -> int:
        return len(self.events)


class ManualClock:
    """Injectable deterministic clock for deadline/stall tests: the
    engine's ``clock=`` knob accepts any zero-arg float callable; this
    one only moves when told to (``advance``), so deadline expiry and
    stall detection become exact assertions instead of sleeps. A
    ``"stall"`` fault advances it instead of sleeping."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def __call__(self) -> float:
        return self._t

    def advance(self, seconds: float) -> float:
        self._t += float(seconds)
        return self._t


def poison_rows(tree, rows: Sequence[int]):
    """Overwrite the given rows (axis 0) of every floating tensor leaf
    of ``tree`` with NaN, IN PLACE, and return ``tree``. Integer leaves
    (the attention ``filled`` counters) and non-tensor leaves (the paged
    pool's ``scratch`` index) are left intact, so the corruption models
    bad *values*, not bad bookkeeping. No tensor is rebound: the pools
    are captured graphs' static inputs."""
    idx = sorted({int(r) for r in rows})
    if not idx:
        return tree
    for leaf in tree_leaves(tree):
        if leaf.is_floating_point():
            leaf.index_fill_(0, torch.as_tensor(idx, device=leaf.device),
                             float("nan"))
    return tree
