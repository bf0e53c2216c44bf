"""Paged KV memory: one device-resident block pool shared by the decode
slots (port of ``deeplearning4j_tpu/serving/block_pool.py``).

- **Blocks** — the pool is ``kv_blocks`` fixed-size token blocks per
  attention layer (``[n_blocks, block_tokens, H, dh]``); a block holds
  ``block_tokens`` consecutive tokens of exactly one logical sequence.
- **Block tables** — each slot owns a host-side :class:`BlockTable`:
  logical block index ``g`` (absolute positions ``[g*bt, (g+1)*bt)``)
  -> pool block id. The device sees a fixed-width ring projection of it
  (``g`` at ring slot ``g % S``), so the decode step's shapes never
  depend on sequence length.
- **Refcounts** — a block is shared by reference; ``copy_block`` is the
  copy-on-write for an append into a block another holder still
  references.
- **Allocation on demand** — the engine reserves blocks only as
  ``filled`` crosses a block boundary.

The pool object holds host bookkeeping only; the device tensors live in
the engine's per-layer ``{"pk", "pv"}`` dict. ``copy_block`` and
``zero_block`` write those tensors IN PLACE (the JAX package returns a
new pool).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class BlockTable:
    """Host-side view of one logical KV sequence: which pool block
    holds each logical block of the sequence, how many absolute tokens
    exist (``length``), and the earliest valid position (``floor`` —
    nonzero when the sequence's head slid out of the window, or when it
    was spliced from a trie entry that stored a slid window).

    Used for decode slots (mutated as the slot streams), for in-flight
    paged admissions, and as the payload of paged prefix-trie entries
    (frozen after insert)."""

    block_tokens: int
    blocks: Dict[int, int] = dataclasses.field(default_factory=dict)
    length: int = 0
    floor: int = 0

    def block_ids(self) -> List[int]:
        return list(self.blocks.values())

    def tail_block(self) -> Optional[Tuple[int, int]]:
        """(logical g, block id) of the partial tail block the next
        append writes into, or None when length is block-aligned (the
        next append starts a fresh block)."""
        if self.length % self.block_tokens == 0:
            return None
        g = self.length // self.block_tokens
        bid = self.blocks.get(g)
        return None if bid is None else (g, bid)

    def new_logical_blocks(self, n_tokens: int) -> List[int]:
        """Logical block indices an append of ``n_tokens`` tokens
        requires beyond what the table already maps."""
        if n_tokens <= 0:
            return []
        bt = self.block_tokens
        first = (self.length + bt - 1) // bt   # == length//bt aligned
        last = (self.length + n_tokens - 1) // bt
        return [g for g in range(first, last + 1)
                if g not in self.blocks]

    def arrays(self, ring_slots: int) -> Tuple[np.ndarray, np.ndarray]:
        """Device projection: ``(table[S], base[S])`` int32 with block
        ``g`` at ring slot ``g % S`` (-1 = unmapped). Two live logical
        blocks may never collide on a ring slot — the engine sizes S
        past the window plus one round's worst-case writes and frees
        slid-out blocks each round, so a collision is a bookkeeping
        bug, not load."""
        table = np.full(ring_slots, -1, np.int32)
        base = np.full(ring_slots, -1, np.int32)
        for g, bid in self.blocks.items():
            s = g % ring_slots
            if table[s] != -1:
                raise AssertionError(
                    f"ring collision at slot {s}: logical blocks "
                    f"{base[s] // self.block_tokens} and {g} both "
                    "live — expired blocks were not freed")
            table[s] = bid
            base[s] = g * self.block_tokens
        return table, base

    def coverage(self, g: int) -> int:
        """Valid tokens this sequence keeps in logical block ``g``
        (fragmentation accounting: ``block_tokens - coverage`` of a
        tail block is allocated-but-masked pad)."""
        bt = self.block_tokens
        lo = max(self.floor, g * bt)
        hi = min(self.length, (g + 1) * bt)
        return max(0, hi - lo)


class BlockPool:
    """Host-side allocator + refcounts for the shared KV block pool,
    plus the two in-place device movers (``copy_block_device`` for
    copy-on-write, ``scrub_block_device`` for zeroing a block) and the
    ``poisoned`` set of blocks waiting to be scrubbed."""

    def __init__(self, n_blocks: int, block_tokens: int):
        if n_blocks < 1:
            raise ValueError(f"kv_blocks {n_blocks} < 1")
        if block_tokens < 1 or (block_tokens & (block_tokens - 1)):
            raise ValueError(
                f"block_tokens {block_tokens} must be a power of two")
        self.n_blocks = int(n_blocks)
        self.block_tokens = int(block_tokens)
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self._ref = np.zeros(self.n_blocks, np.int64)
        #: blocks the paranoid health check found non-finite; each is
        #: scrubbed when its last reference drops, never while a sharer
        #: still reads it
        self.poisoned: set = set()
        self.stats: Dict[str, int] = {
            "allocs": 0, "frees": 0, "cow_copies": 0,
            "spliced": 0, "scrubbed": 0,
        }

    # -- allocation / sharing ------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    def alloc(self) -> Optional[int]:
        """One fresh block at refcount 1, or None when the pool is
        exhausted (the engine then preempts the youngest slot —
        allocation never blocks)."""
        if not self._free:
            return None
        bid = self._free.pop()
        self._ref[bid] = 1
        self.stats["allocs"] += 1
        return bid

    def ref(self, bid: int) -> None:
        if self._ref[bid] < 1:
            raise AssertionError(f"ref of free block {bid}")
        self._ref[bid] += 1

    def refcount(self, bid: int) -> int:
        return int(self._ref[bid])

    def deref(self, bid: int) -> bool:
        """Drop one reference; returns True when the block just became
        free (the caller scrubs it first if it was poisoned)."""
        if self._ref[bid] < 1:
            raise AssertionError(f"deref of free block {bid}")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)
            self.stats["frees"] += 1
            return True
        return False

    # -- device helpers (pool = {layer: {"pk", "pv"}}), in place --------
    def copy_block_device(self, pool, src: int, dst: int):
        """Copy-on-write of one block, in place; returns ``pool``."""
        self.stats["cow_copies"] += 1
        for st in pool.values():
            for name in ("pk", "pv"):
                st[name][dst].copy_(st[name][src])
        return pool

    def scrub_block_device(self, pool, bid: int):
        """Zero one (freed, poisoned) block in place, so the paranoid
        health check goes green again without touching live blocks;
        returns ``pool``."""
        self.stats["scrubbed"] += 1
        self.poisoned.discard(bid)
        for st in pool.values():
            for name in ("pk", "pv"):
                st[name][bid].zero_()
        return pool

    # -- accounting -----------------------------------------------------
    def fragmentation_tokens(self, tables) -> int:
        """Allocated-but-masked tokens across the pool: for every used
        block, ``block_tokens`` minus the widest valid coverage any
        referent keeps in it. Shared blocks count once."""
        best: Dict[int, int] = {}
        for tab in tables:
            if tab is None:
                continue
            for g, bid in tab.blocks.items():
                cov = tab.coverage(g)
                if cov > best.get(bid, -1):
                    best[bid] = cov
        frag = 0
        for bid in range(self.n_blocks):
            if self._ref[bid] > 0:
                frag += self.block_tokens - best.get(bid, 0)
        return frag
