"""Tiered KV cache: host-DRAM (and disk) spill store for evicted
prefix-trie entries (a copy of ``deeplearning4j_tpu/serving/kv_tier.py``:
pure Python, nothing in it touches a device).

Without this module, a :class:`~.prefix_cache.PagedPrefixCache` victim
under device-memory pressure is simply dropped and a later hit on that
prefix pays a full prefill recompute — yet the machinery that makes
spilling nearly free already exists: ``kv_transfer.pack_prefix``
serializes any cached prefix as a width-invariant framed payload, and
``import_prefix`` re-imports it through one scatter into the pool. The
tier ladder this module completes (vLLM swap-out / DistServe spirit):

    device block pool (trie hit: zero-copy splice)
      └─ evict → host DRAM LRU (reload: one kv_import scatter)
           └─ overflow → disk ring (reload: file read + same scatter)
                └─ overflow → dropped (recompute — the seed behavior)

**What a tier entry is**: the *exact* ``DKV1`` wire payload the KV
transfer plane ships between replicas. That buys three properties for
free: (1) reload is literally ``import_prefix`` — same validation,
same fallback ladder, same scatter; (2) a host-tier-warm replica
can serve ``GET /v1/kv/export`` straight from the tier without any
device work (the router's donor pick exploits this); (3) the disk
form needs no second format — a payload file IS the payload.

**Budgets and accounting**: the host tier is a bounded-byte LRU
(``OrderedDict``); inserting past ``host_budget_bytes`` demotes the
oldest payloads to the disk ring (per-payload files under
``disk_path``, the ``util/disk_based_queue.py`` idiom), and past
``disk_budget_bytes`` the oldest files are unlinked (dropped). The
standing reconciliation invariant — asserted by the tier tests — is::

    spills == reloads + drops + resident entries

``put`` counts a spill even when the payload is immediately dropped
(over every budget), so the invariant holds at every instant.

Thread-safety: all mutators take one internal lock; :meth:`health`
deliberately reads WITHOUT it (GIL-atomic ints only) so the
gateway's lock-free ``/v1/healthz`` stays lock-free through the tier
block.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

Key = Tuple[int, ...]


class KVTierStore:
    """Bounded-budget LRU store of packed prefix payloads keyed by
    token prefix, with host-DRAM primary and optional disk overflow.

    - ``host_budget_bytes`` — payload bytes resident in host memory
      (0 = no host tier: everything spills straight to disk).
    - ``disk_path`` — directory for the disk ring (None = no disk
      tier: host overflow is dropped). Created on first use; files
      this store wrote are unlinked on :meth:`close`.
    - ``disk_budget_bytes`` — byte cap for the ring (None =
      unbounded — the operator pointed it at scratch space on
      purpose).
    """

    def __init__(self, host_budget_bytes: int = 0,
                 disk_path: Optional[str] = None,
                 disk_budget_bytes: Optional[int] = None):
        if host_budget_bytes < 0:
            raise ValueError(
                f"host_budget_bytes {host_budget_bytes} < 0")
        if host_budget_bytes == 0 and disk_path is None:
            raise ValueError(
                "a KVTierStore needs a host budget or a disk path "
                "(both absent = the no-tier engine; leave the tier "
                "off instead)")
        self.host_budget_bytes = int(host_budget_bytes)
        self.disk_path = disk_path
        self.disk_budget_bytes = (None if disk_budget_bytes is None
                                  else int(disk_budget_bytes))
        self._lock = threading.Lock()
        #: host tier: key -> payload bytes (insertion order = LRU)
        self._host: "OrderedDict[Key, bytes]" = OrderedDict()
        #: disk tier: key -> (file path, size) in ring order
        self._disk: "OrderedDict[Key, Tuple[str, int]]" = OrderedDict()
        self.host_bytes = 0
        self.disk_bytes = 0
        self._seq = 0          # monotone disk-ring file namer
        self._made_dir = False
        self.stats: Dict[str, int] = {
            "spills": 0,       # payloads handed to put()
            "reloads": 0,      # payloads taken back via take()
            "drops": 0,        # payloads lost (budget, fault, clear)
            "demotions": 0,    # host -> disk movements
            "hits_host": 0,    # match() answered from host DRAM
            "hits_disk": 0,    # match() answered from the disk ring
            "misses": 0,       # match() found nothing usable
        }

    # -- spill (eviction path) -----------------------------------------
    def put(self, tokens: Sequence[int], payload: bytes) -> str:
        """Admit one packed prefix payload; returns the tier it landed
        in (``"host"`` / ``"disk"`` / ``"dropped"``). A key already
        stored just refreshes recency (the trie re-evicting a prefix
        it reloaded earlier). Oversized-for-every-budget payloads are
        counted and dropped — spilling must never fail the caller."""
        key = tuple(int(t) for t in tokens)
        size = len(payload)
        with self._lock:
            self.stats["spills"] += 1
            if key in self._host:
                self._host.move_to_end(key)
                self.stats["spills"] -= 1  # refresh, not a new spill
                return "host"
            if key in self._disk:
                self._disk.move_to_end(key)
                self.stats["spills"] -= 1
                return "disk"
            if size <= self.host_budget_bytes:
                self._host[key] = payload
                self.host_bytes += size
                self._shed_host_locked()
                return "host"
            if self._disk_put_locked(key, payload):
                return "disk"
            self.stats["drops"] += 1
            return "dropped"

    def _shed_host_locked(self) -> None:
        while self.host_bytes > self.host_budget_bytes and self._host:
            key, payload = self._host.popitem(last=False)
            self.host_bytes -= len(payload)
            if self._disk_put_locked(key, payload):
                self.stats["demotions"] += 1
            else:
                self.stats["drops"] += 1

    def _disk_put_locked(self, key: Key, payload: bytes) -> bool:
        if self.disk_path is None:
            return False
        if (self.disk_budget_bytes is not None
                and len(payload) > self.disk_budget_bytes):
            return False
        if not self._made_dir:
            os.makedirs(self.disk_path, exist_ok=True)
            self._made_dir = True
        path = os.path.join(self.disk_path,
                            f"kvtier_{self._seq:08d}.dkv")
        self._seq += 1
        try:
            with open(path, "wb") as f:
                f.write(payload)
        except OSError:
            return False  # disk full/gone: same outcome as no disk
        self._disk[key] = (path, len(payload))
        self.disk_bytes += len(payload)
        if self.disk_budget_bytes is not None:
            while self.disk_bytes > self.disk_budget_bytes and self._disk:
                old_key, (old_path, old_size) = self._disk.popitem(
                    last=False)
                self.disk_bytes -= old_size
                self._unlink(old_path)
                if old_key != key:
                    self.stats["drops"] += 1
                # (evicting the just-written key counts at the caller)
        return key in self._disk

    @staticmethod
    def _unlink(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    # -- reload (admission path) ---------------------------------------
    def match(self, prompt: Sequence[int]
              ) -> Optional[Tuple[Key, bytes, str]]:
        """The stored payload sharing the LONGEST usable prefix with
        ``prompt`` (host tier preferred at a tie), WITHOUT removing it
        — pair a successful import with :meth:`take`, a structural
        fault with :meth:`drop`, and a soft decline with nothing (the
        payload stays resident for a later retry). "Usable" follows
        the trie's rule: ``min(lcp, len(prompt) - 1) >= 1`` — a
        stored key need not be an exact prefix of the prompt, because
        ``import_prefix`` seeds the trie under the STORED key and the
        next lookup's any-shared-prefix rewind covers divergence.
        Returns ``(key, payload bytes, tier name)`` or None."""
        tokens = tuple(int(t) for t in prompt)
        if len(tokens) < 2:
            with self._lock:
                self.stats["misses"] += 1
            return None
        best: Optional[Tuple[int, int, Key, str]] = None
        with self._lock:
            for tier_rank, (name, store) in enumerate(
                    (("host", self._host), ("disk", self._disk))):
                for key in store:
                    usable = min(_lcp(key, tokens), len(tokens) - 1)
                    if usable < 1:
                        continue
                    cand = (usable, -tier_rank, key, name)
                    if best is None or cand[:2] > best[:2]:
                        best = cand
            if best is None:
                self.stats["misses"] += 1
                return None
            _, _, key, name = best
            if name == "host":
                payload = self._host[key]
                self._host.move_to_end(key)
                self.stats["hits_host"] += 1
                return (key, payload, "host")
            path, size = self._disk[key]
            self.stats["hits_disk"] += 1
        # file read OUTSIDE the lock (disk latency must not block a
        # concurrent healthz/spill); a racing drop just re-misses
        try:
            with open(path, "rb") as f:
                payload = f.read()
        except OSError:
            with self._lock:
                if self._disk.get(key, (None, 0))[0] == path:
                    del self._disk[key]
                    self.disk_bytes -= size
                    self.stats["drops"] += 1
                self.stats["hits_disk"] -= 1
                self.stats["misses"] += 1
            return None
        return (key, payload, "disk")

    def take(self, key: Sequence[int]) -> bool:
        """Remove ``key`` after a successful reload (counts as a
        reload — the payload now lives in the trie again)."""
        return self._remove(key, "reloads")

    def drop(self, key: Sequence[int]) -> bool:
        """Remove ``key`` after a reload FAULT (malformed payload /
        geometry mismatch — counts as a drop; recompute covers it)."""
        return self._remove(key, "drops")

    def _remove(self, key: Sequence[int], stat: str) -> bool:
        key = tuple(int(t) for t in key)
        with self._lock:
            payload = self._host.pop(key, None)
            if payload is not None:
                self.host_bytes -= len(payload)
                self.stats[stat] += 1
                return True
            entry = self._disk.pop(key, None)
            if entry is not None:
                path, size = entry
                self.disk_bytes -= size
                self._unlink(path)
                self.stats[stat] += 1
                return True
        return False

    # -- introspection / lifecycle -------------------------------------
    def __len__(self) -> int:
        return len(self._host) + len(self._disk)

    def keys(self) -> List[Key]:
        with self._lock:
            return list(self._host) + list(self._disk)

    def health(self) -> Dict[str, Any]:
        """Lock-free tier block for ``/v1/healthz`` (GIL-atomic int
        reads only — the gateway's probe must answer instantly even
        mid-spill)."""
        return {
            "entries": len(self._host) + len(self._disk),
            "host_entries": len(self._host),
            "disk_entries": len(self._disk),
            "host_bytes": self.host_bytes,
            "disk_bytes": self.disk_bytes,
            "host_budget_bytes": self.host_budget_bytes,
            "disk_budget_bytes": self.disk_budget_bytes,
            "spills": self.stats["spills"],
            "reloads": self.stats["reloads"],
            "drops": self.stats["drops"],
        }

    def clear(self) -> int:
        """Drop every resident payload (counted as drops — the
        reconciliation invariant survives a clear)."""
        with self._lock:
            n = len(self._host) + len(self._disk)
            self.stats["drops"] += n
            self._host.clear()
            self.host_bytes = 0
            for path, _ in self._disk.values():
                self._unlink(path)
            self._disk.clear()
            self.disk_bytes = 0
            return n

    def close(self) -> None:
        """Unlink every ring file this store wrote (the payloads are
        droppable cache — nothing to persist)."""
        with self._lock:
            for path, _ in self._disk.values():
                self._unlink(path)
            self._disk.clear()
            self.disk_bytes = 0
            self._host.clear()
            self.host_bytes = 0


def _lcp(a: Key, b: Key) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i
