"""Radix prefix cache: host-side trie over prompt token ids mapping
matched prefixes to KV state on the card (a port of
``deeplearning4j_tpu/serving/prefix_cache.py``).

Real traffic shares long prompt prefixes (system prompts, few-shot
templates; RadixAttention, SGLang, Zheng et al. 2023), so the KV state
of a prefix computed for one request can seed the next request's
admission, leaving only the divergent *suffix* to prefill:

- **Host side** — a radix trie (path-compressed: edges carry token
  runs, split on divergence) keyed by prompt token ids. Stored nodes
  map a prefix to one row of the device pool, with LRU eviction over
  unleased rows and ref-count leases that pin a row while an in-flight
  admission still reads it.
- **Device side** (:class:`RadixPrefixCache`, the dense layout) — a
  second fixed pool beside the engine's slot pool: one row per cached
  prefix, the network's streaming-state tree (per attention layer
  ``k``/``v``/``filled``) with a leading ``[rows]`` axis, made lazily
  from the first stored state. Two plain torch movers: ``store``
  copies a B=1 post-prefill state into a row IN PLACE; ``fetch``
  returns a NEW B=1 state (an indexed copy, never a view of the pool)
  rewound by ``drop`` trailing tokens (``nn.streaming.
  drop_newest_tokens``). The JAX movers are two jitted executables over
  an immutable pool; here the pool is written in place, so a fetched
  state must own its memory: a later ``store`` into the same row (after
  the row was released and recycled) must not change it. Both run
  eagerly: ``compile_counts()`` reads 0 for each.
- :class:`PagedPrefixCache` (the paged layout) — the same trie over the
  engine's shared block pool: an entry holds references to blocks, a
  hit is spliced into the new slot's block table, and no row moves.

Why ``drop``: K/V at a position are projections of that token alone,
so a stored state rewinds EXACTLY to any shorter prefix of itself.
That serves two purposes. (1) A prompt that diverges ``m`` tokens into
a cached entry still reuses those ``m`` tokens — the entry's divergent
tail is rewound away — so the hit criterion is any-shared-prefix, not
whole-stored-prompt. (2) Sampling a request's first token needs the
logits at its LAST prompt position, which a cached state does not
carry — so a lookup never consumes the whole prompt: an exact match
rewinds one token and the engine re-streams the final prompt token as
a one-token suffix, producing those logits on the regular suffix path.

Leases: an admission that matched a prefix holds its row until the
admission completes, so LRU eviction never recycles a row the engine
still considers live.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.nn.streaming import (
    drop_newest_tokens,
    tree_map,
)
from deeplearning4j_tpu_torch.serving.block_pool import BlockTable


@dataclasses.dataclass
class PrefixHit:
    """One successful lookup: ``matched`` prompt tokens are served from
    cache row ``row`` (after rewinding ``drop`` trailing tokens); the
    row stays leased until ``release``."""

    row: int
    matched: int
    drop: int


class _Node:
    """Radix-trie node: ``edge`` is the token run from the parent,
    ``depth`` the total prefix length here, ``row`` the device pool row
    when this exact prefix is cached (structural nodes carry None)."""

    __slots__ = ("edge", "children", "parent", "depth", "row",
                 "last_use")

    def __init__(self, edge: Tuple[int, ...], parent: "_Node | None",
                 depth: int):
        self.edge = edge
        self.children: Dict[int, _Node] = {}
        self.parent = parent
        self.depth = depth
        self.row: Optional[int] = None
        self.last_use = 0


class RadixPrefixCache:
    """Fixed-capacity prefix cache: ``rows`` device-resident KV rows
    behind a radix trie over prompt token ids.

    ``lookup`` returns the longest cached prefix of a prompt (capped at
    ``len(prompt) - 1`` — see module docstring) and leases its row;
    ``fetch`` copies the row to a B=1 streaming state; ``insert``
    stores a post-prefill state under its full prompt, evicting the
    least-recently-used unleased row when full (declining, not
    evicting, when every row is leased). The device pool is written in
    place by ``insert``; ``fetch`` copies out of it."""

    def __init__(self, rows: int):
        if rows < 1:
            raise ValueError(f"prefix cache rows {rows} < 1")
        self.rows = int(rows)
        self.pool = None                      # [rows, ...] pytree
        self._root = _Node((), None, 0)
        self._free: List[int] = list(range(self.rows))
        self._by_row: Dict[int, _Node] = {}
        self._ref: Dict[int, int] = {}
        self._clock = 0
        #: pressure-eviction hook: called as
        #: ``on_evict(prefix_tokens, payload)`` just before an LRU
        #: victim's payload is dropped, so the engine can spill it to
        #: a host/disk KV tier (a paged engine with a tier sets it to
        #: ``DecodeEngine._stage_spill``). Fires ONLY for ``_evict_lru``
        #: pressure evictions — quarantine invalidations bypass it by
        #: design (poisoned state must never be spilled and reloaded).
        self.on_evict = None
        self.stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "inserts": 0, "evictions": 0,
            "declined": 0, "tokens_matched": 0, "invalidations": 0,
        }

    # -- row movement (eager torch, in place on the pool) --------------
    def compile_counts(self) -> Dict[str, int]:
        """The JAX cache's keys; both movers run eagerly (no graph)."""
        return {"prefix_fetch": 0, "prefix_store": 0}

    def _store(self, rnn1: Any, row: int) -> None:
        """Copy a B=1 streaming state into pool row ``row`` in place
        (cast to the pool's dtype), making the pool from the first
        stored state."""
        if self.pool is None:
            self.pool = tree_map(
                lambda a: torch.zeros((self.rows,) + tuple(a.shape[1:]),
                                      dtype=a.dtype, device=a.device),
                rnn1)
        tree_map(lambda p, o: p[row].copy_(o[0].to(p.dtype)), self.pool,
                 rnn1)
    # -- trie ----------------------------------------------------------
    def _walk(self, tokens: Tuple[int, ...]):
        """Descend as far as whole edges match ``tokens``; returns the
        final fully-matched (node, depth)."""
        node, depth = self._root, 0
        while depth < len(tokens):
            child = node.children.get(tokens[depth])
            if child is None:
                break
            n = len(child.edge)
            if (len(tokens) - depth < n
                    or tokens[depth:depth + n] != child.edge):
                break  # tokens end or diverge inside the edge
            node, depth = child, depth + n
        return node, depth

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_use = self._clock

    def _shallowest_stored(self, node: _Node) -> Optional[_Node]:
        """Closest stored node at or below ``node`` (the one needing
        the smallest rewind when its subtree shares a prefix with a
        query that diverged above it)."""
        frontier = [node]
        best: Optional[_Node] = None
        while frontier:
            nd = frontier.pop()
            if nd.row is not None:
                if best is None or nd.depth < best.depth:
                    best = nd
                continue  # anything below is deeper still
            frontier.extend(nd.children.values())
        return best

    def lookup(self, prompt: Sequence[int]) -> Optional[PrefixHit]:
        """Longest reusable cached prefix of ``prompt``; leases the row
        (pair every hit with ``release``).

        A stored state need not BE a prefix of the prompt to serve it:
        when the prompt diverges ``m`` tokens into a cached entry (or
        ends inside it), ``fetch`` rewinds the entry's trailing
        ``depth - m`` tokens (``drop_newest_tokens`` — K/V are
        per-token, so the rewound state is exactly the state after
        ``prompt[:m]``). That makes the hit criterion RadixAttention's:
        any shared prefix with anything cached, not just whole stored
        prompts. Returns None on miss, or when the reusable part is
        empty (a 1-token prompt can never hit: its first token's
        logits must come from a real prefill)."""
        tokens = tuple(int(t) for t in prompt)
        node, depth = self._root, 0
        best: Optional[_Node] = None      # stored node to fetch from
        best_m = 0                        # prompt tokens it covers
        while depth < len(tokens):
            child = node.children.get(tokens[depth])
            if child is None:
                break
            limit = min(len(child.edge), len(tokens) - depth)
            common = 0
            while (common < limit
                   and child.edge[common] == tokens[depth + common]):
                common += 1
            if common == len(child.edge):
                node, depth = child, depth + common
                if node.row is not None:
                    best, best_m = node, node.depth
                continue
            # query diverged (or ended) inside the edge: every stored
            # node under `child` shares exactly depth+common tokens
            if common and depth + common > best_m:
                cand = self._shallowest_stored(child)
                if cand is not None:
                    best, best_m = cand, depth + common
            break
        else:
            child = None
        if child is None and depth > best_m:
            # the walk ended at a node boundary (no continuing edge, or
            # the query ran out): every stored node under `node` —
            # siblings diverging here, or longer prompts extending the
            # query — shares exactly `depth` tokens with the query
            cand = self._shallowest_stored(node)
            if cand is not None:
                best, best_m = cand, depth
        if best is not None:
            matched = min(best_m, len(tokens) - 1)
            if matched >= 1:
                self._touch(best)
                self._ref[best.row] = self._ref.get(best.row, 0) + 1
                self.stats["hits"] += 1
                self.stats["tokens_matched"] += matched
                return PrefixHit(row=best.row, matched=matched,
                                 drop=best.depth - matched)
        self.stats["misses"] += 1
        return None

    def fetch(self, hit: PrefixHit):
        """Cache row -> a NEW B=1 streaming state (an indexed copy that
        owns its memory: later writes into the pool never reach it),
        rewound by ``hit.drop`` tokens."""
        def one(a):
            return a.index_select(
                0, torch.tensor([hit.row], device=a.device))

        return drop_newest_tokens(tree_map(one, self.pool), hit.drop)

    def release(self, hit: PrefixHit) -> None:
        """Drop the lease taken by ``lookup`` (the row becomes
        evictable again once unreferenced). A row invalidated WHILE
        leased (fault quarantine) was only unmapped at that point; the
        last release returns it to the free list."""
        left = self._ref.get(hit.row, 0) - 1
        if left > 0:
            self._ref[hit.row] = left
        else:
            self._ref.pop(hit.row, None)
            if (hit.row not in self._by_row
                    and hit.row not in self._free):
                self._free.append(hit.row)

    def _drop_node(self, node: _Node) -> int:
        """Unmap a stored node (an already-fetched state stays valid:
        ``fetch`` copies out of the pool) and prune now-empty leaf
        chains. The row returns to the free list immediately when
        unleased; a row another in-flight admission still leases is
        only UNMAPPED here (no new lookups can hit it) and ``release``
        frees it when the last lease drops — freeing it now would let
        an insert reuse a row whose lease bookkeeping still points at
        the old occupant. The quarantine path for corrupted entries."""
        row = node.row
        node.row = None
        del self._by_row[row]
        if self._ref.get(row, 0) == 0:
            self._ref.pop(row, None)
            self._free.append(row)
        while (node.parent is not None and node.row is None
               and not node.children):
            parent = node.parent
            del parent.children[node.edge[0]]
            node = parent
        return row

    def invalidate_row(self, row: int) -> bool:
        """Drop the entry stored in ``row`` (fault quarantine: the
        engine detected NaN state traced back to this row). Returns
        False when the row holds nothing."""
        node = self._by_row.get(row)
        if node is None:
            return False
        self._drop_node(node)
        self.stats["invalidations"] += 1
        return True

    def invalidate(self, prompt: Sequence[int]) -> bool:
        """Drop the entry stored under exactly ``prompt`` (fault
        quarantine: an admission built on a corrupt fetch re-inserted
        its poisoned state under its full prompt — both ends must be
        scrubbed before the retry, or the retry re-fetches the
        poison)."""
        tokens = tuple(int(t) for t in prompt)
        node, depth = self._walk(tokens)
        if depth != len(tokens) or node.row is None:
            return False
        self._drop_node(node)
        self.stats["invalidations"] += 1
        return True

    def stored_rows(self) -> List[int]:
        """Rows currently holding entries (fault injection picks its
        corruption target from these)."""
        return sorted(self._by_row)

    def row_prefix(self, row: int) -> Optional[Tuple[int, ...]]:
        """The token prefix currently stored in ``row`` (None when the
        row holds nothing). Quarantine uses this to confirm a
        suspect row still holds an ancestor of the poisoned prompt
        before invalidating — the row may have been LRU-recycled for
        an unrelated healthy entry since the admission fetched it."""
        node = self._by_row.get(row)
        if node is None:
            return None
        parts = []
        while node is not None:
            parts.append(node.edge)
            node = node.parent
        return tuple(t for edge in reversed(parts) for t in edge)

    def _spill_victim(self, node: _Node) -> None:
        """Give ``on_evict`` the victim's prefix + payload BEFORE the
        drop (pressure evictions only — the spill seam the KV tier
        rides; a no-op here because the dense cache's row payloads are
        cheap to recompute and the tier speaks block tables)."""

    def _evict_lru(self) -> Optional[int]:
        victims = [nd for row, nd in self._by_row.items()
                   if self._ref.get(row, 0) == 0]
        if not victims:
            return None
        node = min(victims, key=lambda nd: nd.last_use)
        if self.on_evict is not None:
            self._spill_victim(node)
        # one prune implementation: _drop_node unmaps + prunes, and —
        # the victim being unleased — puts the row on the free list;
        # take it straight back for the caller's immediate reuse
        row = self._drop_node(node)
        self._free.remove(row)
        self.stats["evictions"] += 1
        return row

    def _alloc_row(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        return self._evict_lru()

    def insert(self, prompt: Sequence[int], rnn1: Any) -> bool:
        """Store a B=1 post-prefill state under its full prompt.
        Duplicate prompts refresh LRU only; a full cache with every row
        leased declines (never blocks, never evicts a leased row)."""
        tokens = tuple(int(t) for t in prompt)
        if not tokens:
            return False
        node, depth = self._walk(tokens)
        if depth == len(tokens) and node.row is not None:
            self._touch(node)  # already cached: refresh recency
            return False
        row = self._alloc_row()
        if row is None:
            self.stats["declined"] += 1
            return False
        # re-walk AFTER allocation: evicting the LRU row may have
        # pruned nodes on the first walk's path — grafting from the
        # stale node would extend a detached subtree (unreachable
        # entry now, corrupted prune bookkeeping later)
        node, depth = self._walk(tokens)
        self._store(rnn1, row)
        node = self._graft(node, depth, tokens)
        node.row = row
        self._by_row[row] = node
        self._touch(node)
        self.stats["inserts"] += 1
        return True

    def _graft(self, node: _Node, depth: int,
               tokens: Tuple[int, ...]) -> _Node:
        """Extend the trie from ``node`` (which matched ``tokens`` up
        to ``depth``) until a node for the full prompt exists, splitting
        a partially-shared edge at the divergence point."""
        while depth < len(tokens):
            child = node.children.get(tokens[depth])
            if child is None:
                leaf = _Node(tokens[depth:], node, len(tokens))
                node.children[tokens[depth]] = leaf
                return leaf
            common = 0
            limit = min(len(child.edge), len(tokens) - depth)
            while (common < limit
                   and child.edge[common] == tokens[depth + common]):
                common += 1
            if common == len(child.edge):
                node, depth = child, depth + common
                continue
            # split child's edge at the divergence (or at prompt end)
            mid = _Node(child.edge[:common], node, node.depth + common)
            child.edge = child.edge[common:]
            child.parent = mid
            mid.children[child.edge[0]] = child
            node.children[tokens[depth]] = mid
            node, depth = mid, depth + common
        return node

    def clear(self) -> int:
        """Drop every stored entry (rows still leased by an in-flight
        admission are unmapped now and freed at the last release).
        Returns the number of entries dropped — the soak's
        pool-fully-free gate empties the trie through this."""
        dropped = 0
        for row in list(self._by_row):
            node = self._by_row.get(row)
            if node is not None:
                self._drop_node(node)
                dropped += 1
        return dropped

    # -- introspection -------------------------------------------------
    @property
    def hit_rate(self) -> float:
        seen = self.stats["hits"] + self.stats["misses"]
        return self.stats["hits"] / seen if seen else 0.0

    def cached_prefixes(self) -> List[Tuple[int, ...]]:
        """Every stored prefix (tests/debugging)."""
        out: List[Tuple[int, ...]] = []

        def rec(node, prefix):
            prefix = prefix + node.edge
            if node.row is not None:
                out.append(prefix)
            for child in node.children.values():
                rec(child, prefix)

        rec(self._root, ())
        return sorted(out)

    def leased_rows(self) -> Dict[int, int]:
        return dict(self._ref)


class PagedPrefixCache(RadixPrefixCache):
    """Radix prefix trie over the SHARED paged KV block pool: the same path-compressed trie, leases, LRU and invalidation
    machinery as the dense cache, but an entry's payload is a list of
    block ids leased from the engine's :class:`~.block_pool.BlockPool`
    instead of a private device row.

    Consequences of the paged payload:

    - **insert is zero-copy** — the entry references the admitted
      slot's own blocks (refcount bumps via ``ref_block``); no row is
      stored, and every later write into a shared block (the slot's
      decode appends, a warm admission's suffix chunk) copies the block
      first (``BlockPool.copy_block_device``), since the pool is one
      tensor that the trie, the slots and the decode graph all read.
    - **a hit is zero-copy** — the engine splices the payload's block
      ids into the new slot's table (no ``fetch`` copy); the
      dense cache's exact one-token rewind survives as "reference one
      block fewer / CoW the boundary block" (drop_newest_tokens
      semantics moved to the host).
    - **eviction frees references, not bytes** — dropping an entry
      derefs its blocks via ``release_block``; a block shared with a
      live slot stays resident until the slot finishes, so evicting an
      entry mid-use can never corrupt a reader.

    ``rows`` caps the number of ENTRIES (ids recycle through the base
    machinery); device capacity is governed by the block pool itself.
    The base class's row movers are never invoked — ``compile_counts``
    is empty, which the paged rows of ``bench.py`` assert."""

    def __init__(self, rows: int, block_tokens: int, ref_block,
                 release_block):
        super().__init__(rows)
        self.block_tokens = int(block_tokens)
        self._ref_block = ref_block
        self._release_block = release_block
        self._payloads: Dict[int, Any] = {}

    def compile_counts(self) -> Dict[str, int]:
        return {}

    def fetch(self, hit: PrefixHit):
        raise NotImplementedError(
            "paged prefix hits are spliced (zero-copy block-table "
            "reference), not fetched — see DecodeEngine paged "
            "admission")

    def insert(self, prompt: Sequence[int], rnn1: Any) -> bool:
        raise NotImplementedError(
            "paged prefix entries reference pool blocks — use "
            "insert_blocks")

    def payload(self, row: int):
        """The :class:`~.block_pool.BlockTable` payload stored under
        an entry id returned by ``lookup``."""
        return self._payloads[row]

    def insert_blocks(self, prompt: Sequence[int], tab) -> bool:
        """Store a prompt's KV footprint as references to ``tab``'s
        blocks (a frozen snapshot of the admitted slot's table —
        refcount +1 per block, zero device work). Duplicate prompts
        refresh recency only; an exhausted entry table evicts LRU
        unleased entries exactly like the dense cache."""
        tokens = tuple(int(t) for t in prompt)
        if not tokens:
            return False
        node, depth = self._walk(tokens)
        if depth == len(tokens) and node.row is not None:
            self._touch(node)
            return False
        row = self._alloc_row()
        if row is None:
            self.stats["declined"] += 1
            return False
        # re-walk after allocation (LRU eviction may have pruned the
        # first walk's path — same hazard as the dense insert)
        node, depth = self._walk(tokens)
        frozen = BlockTable(self.block_tokens, dict(tab.blocks),
                            tab.length, tab.floor)
        for bid in frozen.blocks.values():
            self._ref_block(bid)
        self._payloads[row] = frozen
        node = self._graft(node, depth, tokens)
        node.row = row
        self._by_row[row] = node
        self._touch(node)
        self.stats["inserts"] += 1
        return True

    def _spill_victim(self, node: _Node) -> None:
        """Paged spill seam: hand the pressure victim's prefix tokens
        + frozen block table to ``on_evict`` while its blocks are still
        referenced (a hook must copy what it keeps before returning:
        the blocks are recycled in place once released). A hook fault
        must never turn an eviction into an
        engine fault: the tier is an optimization, the drop proceeds
        regardless."""
        prefix = self.row_prefix(node.row)
        payload = self._payloads.get(node.row)
        if prefix is None or payload is None:
            return
        try:
            self.on_evict(prefix, payload)
        except Exception:
            pass

    def _drop_node(self, node: _Node) -> int:
        payload = self._payloads.pop(node.row, None)
        if payload is not None:
            for bid in payload.blocks.values():
                self._release_block(bid)
        return super()._drop_node(node)

    def evict_one(self) -> bool:
        """Evict the LRU unleased entry to relieve BLOCK-pool pressure
        (the engine calls this when allocation fails). Returns False
        when nothing is evictable. Unlike the dense path the freed
        resource is the blocks' references — the entry id goes back to
        the free list."""
        row = self._evict_lru()
        if row is None:
            return False
        # _evict_lru pulls the row off the free list for immediate
        # dense-pool reuse; here the id itself is the only resource
        self._free.append(row)
        return True

    def tables(self) -> List[Any]:
        """Every stored entry's frozen :class:`~.block_pool.BlockTable`
        (the engine's fragmentation accounting)."""
        return list(self._payloads.values())

    def block_ids(self) -> List[int]:
        """Every block id currently referenced by a stored entry
        (soak accounting + fault-injection targeting)."""
        out: List[int] = []
        for payload in self.tables():
            out.extend(payload.blocks.values())
        return out
