"""KV transfer plane: shipping warmed KV blocks between engines (port of
``deeplearning4j_tpu/serving/kv_transfer.py``; the wire format is the
JAX package's, byte for byte).

A prefix warmed on one replica is cold everywhere else, so affinity
misses, failover replay and rolling-upgrade warmup all recompute the
full prompt on the receiver. The paged engine gives KV a serializable
block-granular identity (:class:`~deeplearning4j_tpu_torch.serving.
block_pool.BlockTable` + pool block slices), so a warmed prefix can be
a fleet-level resource:

- **Export** (:func:`export_prefix`): the donor looks the prompt up in
  its radix trie, gathers the entry's referenced pool blocks into a
  fresh device tensor (``index_select``: a copy, so later in-place
  writes to the pool cannot reach it), brings them to the host and
  frames them as one binary payload (:func:`pack_prefix`).
- **Import** (:func:`import_prefix`): the receiver validates the frame
  against its own geometry (block size, layer set, head/dh shape,
  dtype, window), allocates fresh pool blocks (evicting LRU trie
  entries if needed — never preempting a live slot for a cache
  import), writes the shipped blocks into the pool IN PLACE
  (``index_copy_``: the pool is a static input of the engine's
  captured graphs) and seeds its radix trie through the zero-copy
  ``insert_blocks`` path. From then on the imported prefix is a
  locally computed one: the next admission splices it with the same
  copy-on-write machinery, and greedy ids are identical to a local
  prefill.

The gather and the scatter run over JAX's ids: the block ids padded to
the pow2 bucket of their count, each pad lane naming the pool's
scratch block (``kv_blocks``, JAX's out-of-range lane). A padded
gather reads the scratch block only into lanes that are sliced off
before packing; a padded scatter writes only into it (no table maps
it, and nothing reads it). The scratch block is never on the wire, so
a payload's block count is JAX's for the same prefix.

Correctness never depends on a transfer succeeding: every decline
surfaces as ``imported: False`` and every malformed frame as a
:class:`KVTransferError` (the HTTP layer maps it to 400), and the
caller falls back to recompute.

Wire format (version 1)::

    b"DKV1" | u32 version | u32 header_len | header JSON | buffers

The header carries the covered prefix's token ids (the radix-trie
key), the block geometry, and per-layer dtype/shape; the buffers are
each layer's selected ``pk`` then ``pv`` blocks, C-contiguous, in
ascending logical-block order. The header's dtype is numpy's spelling
(``"float32"``, ``"bfloat16"``, as the JAX package writes it); a bf16
buffer is its raw 16-bit words, written and read through a uint8 view
of the tensor (numpy has no bf16, and the port needs no ``ml_dtypes``).
Every size is validated against the header before any buffer is
touched, so a truncated payload fails loudly instead of importing
garbage.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.serving.block_pool import BlockTable
from deeplearning4j_tpu_torch.serving.prefix_cache import PagedPrefixCache

MAGIC = b"DKV1"
WIRE_VERSION = 1

#: default HTTP-facing payload cap (bytes): large enough for a long
#: prompt's blocks on a real model slice, small enough that a hostile
#: Content-Length cannot balloon the handler (the gateway's
#: ``kv_transfer_cap_bytes`` knob overrides per deployment)
DEFAULT_CAP_BYTES = 64 << 20

#: the header's dtype spelling (numpy's ``str(dtype)``) of each pool
#: dtype the wire carries
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.float64: "float64"}
_DTYPES = {name: dtype for dtype, name in _DTYPE_NAMES.items()}


class KVTransferError(ValueError):
    """A payload failed structural validation (bad magic, truncated
    buffers, geometry mismatch): the HTTP layer answers 400 and the
    caller falls back to recompute."""


class KVTransferTooLarge(KVTransferError):
    """An export would exceed the transfer cap — detected from the
    block count and leaf shapes BEFORE any device gather runs, so an
    over-cap prompt costs arithmetic, not a wasted device-to-host
    copy under the engine lock. The HTTP layer answers 413."""


def _raw_bytes(t: torch.Tensor) -> bytes:
    """A host tensor's buffer, C order (any dtype, bf16 included)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def pack_prefix(tokens: Sequence[int], blocks: Sequence[int],
                floor: int, block_tokens: int,
                layers: List[Tuple[str, torch.Tensor, torch.Tensor]]
                ) -> bytes:
    """Frame one warmed prefix: ``tokens`` is the covered prefix (the
    radix-trie key the receiver re-inserts under), ``blocks`` the
    ascending logical block indices covering ``[floor, len(tokens))``,
    ``layers`` a list of ``(name, pk [n, bt, H, dh], pv [n, bt, H,
    dh])`` host tensors in a stable order."""
    header: Dict[str, Any] = {
        "block_tokens": int(block_tokens),
        "floor": int(floor),
        "length": len(tokens),
        "tokens": [int(t) for t in tokens],
        "blocks": [int(g) for g in blocks],
        "layers": [],
    }
    buffers: List[bytes] = []
    for name, pk, pv in layers:
        if pk.shape != pv.shape or pk.dim() != 4:
            raise KVTransferError(
                f"layer {name}: pk/pv shapes {tuple(pk.shape)}/"
                f"{tuple(pv.shape)} are not matching [n, bt, H, dh] "
                "block stacks")
        if pk.dtype not in _DTYPE_NAMES:
            raise KVTransferError(
                f"layer {name}: dtype {pk.dtype} has no wire spelling")
        header["layers"].append({
            "name": str(name),
            "dtype": _DTYPE_NAMES[pk.dtype],
            "heads": int(pk.shape[2]),
            "dh": int(pk.shape[3]),
            "nbytes": int(pk.numel() * pk.element_size()),
        })
        buffers.append(_raw_bytes(pk))
        buffers.append(_raw_bytes(pv))
    head = json.dumps(header).encode()
    return b"".join([MAGIC, struct.pack("<II", WIRE_VERSION,
                                        len(head)), head] + buffers)


def unpack_prefix(payload: bytes) -> Dict[str, Any]:
    """Parse + validate one framed payload back to ``{"header": {...},
    "layers": {name: (pk, pv)}}`` host tensors (copies of the frame's
    buffers). Raises :class:`KVTransferError` on ANY structural problem
    — magic, version, header JSON, an unknown dtype, or buffer sizes
    that disagree with the header (a truncated payload)."""
    if len(payload) < len(MAGIC) + 8:
        raise KVTransferError(
            f"payload too short ({len(payload)} bytes)")
    if payload[:len(MAGIC)] != MAGIC:
        raise KVTransferError("bad magic (not a KV transfer frame)")
    version, head_len = struct.unpack_from("<II", payload, len(MAGIC))
    if version != WIRE_VERSION:
        raise KVTransferError(f"unsupported wire version {version}")
    off = len(MAGIC) + 8
    if off + head_len > len(payload):
        raise KVTransferError("truncated header")
    try:
        header = json.loads(payload[off:off + head_len])
    except ValueError as e:
        raise KVTransferError(f"bad header JSON: {e}") from None
    off += head_len
    for key in ("block_tokens", "floor", "length", "tokens",
                "blocks", "layers"):
        if key not in header:
            raise KVTransferError(f"header missing {key!r}")
    bt = int(header["block_tokens"])
    length = int(header["length"])
    floor = int(header["floor"])
    tokens = [int(t) for t in header["tokens"]]
    blocks = [int(g) for g in header["blocks"]]
    if bt < 1 or length < 1 or not tokens or len(tokens) != length:
        raise KVTransferError(
            f"inconsistent prefix: length {length}, "
            f"{len(tokens)} tokens")
    if not 0 <= floor < length:
        raise KVTransferError(f"floor {floor} outside [0, {length})")
    want = list(range(floor // bt, (length - 1) // bt + 1))
    if blocks != want:
        raise KVTransferError(
            f"blocks {blocks} do not contiguously cover "
            f"[{floor}, {length}) at block_tokens={bt}")
    layers: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    n = len(blocks)
    view = memoryview(payload)
    for spec in header["layers"]:
        name = str(spec["name"])
        dtype = _DTYPES.get(str(spec["dtype"]))
        if dtype is None:
            raise KVTransferError(
                f"layer {name}: unknown dtype {spec.get('dtype')!r}")
        heads, dh = int(spec["heads"]), int(spec["dh"])
        if heads < 1 or dh < 1:
            # validated BEFORE the nbytes arithmetic: a negative pair
            # multiplies back to a "consistent" byte count
            raise KVTransferError(
                f"layer {name}: non-positive heads/dh "
                f"({heads}, {dh})")
        nbytes = int(spec["nbytes"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        if nbytes != n * bt * heads * dh * itemsize:
            raise KVTransferError(
                f"layer {name}: declared {nbytes} bytes != "
                f"{n}x{bt}x{heads}x{dh} {spec['dtype']} blocks")
        if off + 2 * nbytes > len(payload):
            raise KVTransferError(
                f"truncated payload at layer {name}: need "
                f"{2 * nbytes} more bytes, "
                f"{len(payload) - off} remain")
        shape = (n, bt, heads, dh)
        pair = []
        for _ in range(2):
            buf = bytearray(view[off:off + nbytes])
            pair.append(torch.frombuffer(buf, dtype=dtype).reshape(shape))
            off += nbytes
        layers[name] = (pair[0], pair[1])
    if off != len(payload):
        raise KVTransferError(
            f"{len(payload) - off} trailing bytes after the declared "
            "buffers")
    header["tokens"] = tokens
    header["blocks"] = blocks
    return {"header": header, "layers": layers}


# -- engine-side export / import --------------------------------------

def _pow2_bucket(n: int, lo: int = 1) -> int:
    b = max(lo, 1)
    while b < n:
        b <<= 1
    return b


def padded_ids(engine, bids: Sequence[int]) -> torch.Tensor:
    """``bids`` padded to their pow2 bucket with the pool's scratch
    block (JAX's out-of-range pad lane), on the engine's device."""
    ids = np.full(_pow2_bucket(len(bids)), engine.kv_blocks, np.int64)
    ids[:len(bids)] = bids
    return torch.as_tensor(ids).to(engine.device)


def gather_blocks(engine, bids: Sequence[int]
                  ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Each layer's blocks ``bids`` as fresh device tensors ``[n, bt, H,
    dh]`` (JAX's ``kv_gather``: one ``index_select`` per leaf over the
    padded ids, the pad lanes sliced off), queued on the current
    stream: a copy, so a later in-place write to those blocks cannot
    reach it. No host sync."""
    ids = padded_ids(engine, bids)
    n = len(bids)
    return {name: (st["pk"].index_select(0, ids)[:n],
                   st["pv"].index_select(0, ids)[:n])
            for name, st in engine._pool.items()}


def export_prefix(engine, prompt: Sequence[int],
                  cap_bytes: Optional[int] = None) -> Optional[bytes]:
    """Serialize the longest cached prefix of ``prompt`` from
    ``engine``'s paged radix trie (None when nothing reusable is
    cached, or the engine is not paged / has no pool yet). The lease
    taken by the lookup pins the entry while its blocks are gathered
    to host. ``cap_bytes`` raises :class:`KVTransferTooLarge` from the
    block arithmetic alone — before any device work runs."""
    if (not engine.paged_kv or engine._pool is None
            or not isinstance(engine.prefix_cache, PagedPrefixCache)):
        return None
    hit = engine.prefix_cache.lookup(prompt)
    if hit is None:
        return None
    try:
        tab = engine.prefix_cache.payload(hit.row)
        matched = hit.matched
        if matched <= tab.floor:
            return None
        bt = engine.block_tokens
        want = list(range(tab.floor // bt, (matched - 1) // bt + 1))
        if any(g not in tab.blocks for g in want):
            return None  # entry no longer contiguous: nothing to ship
        bids = [tab.blocks[g] for g in want]
        if cap_bytes is not None:
            buffer_bytes = sum(
                2 * len(bids) * int(np.prod(st["pk"].shape[1:]))
                * st["pk"].element_size()
                for st in engine._pool.values())
            if buffer_bytes > cap_bytes:
                raise KVTransferTooLarge(
                    f"export of {len(bids)} blocks x "
                    f"{len(engine._pool)} layers needs "
                    f"{buffer_bytes} buffer bytes, over the "
                    f"{cap_bytes}-byte cap")
        with engine._span("serving.kv_export", matched=matched,
                          blocks=len(bids)):
            gathered = gather_blocks(engine, bids)
            layers = [(name, gathered[name][0].cpu(),
                       gathered[name][1].cpu())
                      for name in sorted(gathered)]
            payload = pack_prefix([int(t) for t in prompt[:matched]],
                                  want, tab.floor, bt, layers)
        engine.stats["kv_exports"] += 1
        engine.stats["kv_exported_tokens"] += matched - tab.floor
        if engine.tracer is not None:
            engine.tracer.incr("serving_kv_exports")
            engine.tracer.incr("serving_kv_exported_tokens",
                               matched - tab.floor)
        return payload
    finally:
        engine.prefix_cache.release(hit)


def import_prefix(engine, payload: bytes) -> Dict[str, Any]:
    """Splice a shipped prefix into ``engine``'s pool + radix trie.
    Returns a summary dict; ``imported`` is False on any DECLINE
    (already warm, pool pressure, trie full) — soft outcomes the caller
    treats as "stay cold". Structural problems (bad frame, geometry
    mismatch with this engine) raise :class:`KVTransferError` instead:
    those are deployment bugs the HTTP layer maps to 400, and
    recompute still covers correctness."""
    if not engine.paged_kv or not isinstance(engine.prefix_cache,
                                             PagedPrefixCache):
        raise KVTransferError(
            "receiver is not a paged engine with a prefix trie "
            "(paged_kv=True + prefix_cache_rows required)")
    parsed = unpack_prefix(payload)
    header, shipped = parsed["header"], parsed["layers"]
    bt = int(header["block_tokens"])
    if bt != engine.block_tokens:
        raise KVTransferError(
            f"block_tokens mismatch: payload {bt} vs engine "
            f"{engine.block_tokens}")
    tokens = header["tokens"]
    bad = [t for t in tokens if not 0 <= t < engine.vocab]
    if bad:
        raise KVTransferError(
            f"prefix ids {bad[:4]} outside vocab [0, {engine.vocab})")
    length, floor = int(header["length"]), int(header["floor"])
    if length - floor > engine._wmax:
        raise KVTransferError(
            f"prefix spans {length - floor} tokens, wider than the "
            f"receiver's cache window ({engine._wmax})")
    if engine._pool is None:
        # a freshly booted receiver has no device pool yet (it
        # allocates lazily at first admission): establish it through
        # the regular prefill path, one tiny prefill
        rnn, _ = engine._prefill_sequence([0])
        engine._ensure_pool(rnn)
    if set(shipped) != set(engine._pool):
        raise KVTransferError(
            f"layer set mismatch: payload {sorted(shipped)} vs "
            f"engine {sorted(engine._pool)}")
    for name, (pk, _pv) in shipped.items():
        leaf = engine._pool[name]["pk"]
        if tuple(pk.shape[1:]) != tuple(leaf.shape[1:]):
            raise KVTransferError(
                f"layer {name}: shipped block shape "
                f"{tuple(pk.shape[1:])} != receiver "
                f"{tuple(leaf.shape[1:])}")
        if pk.dtype != leaf.dtype:
            raise KVTransferError(
                f"layer {name}: shipped dtype {_DTYPE_NAMES[pk.dtype]} "
                f"!= receiver {_DTYPE_NAMES.get(leaf.dtype, leaf.dtype)}")
    n = len(header["blocks"])

    def result(imported: bool, reason: str) -> Dict[str, Any]:
        return {"imported": imported, "reason": reason,
                "prefix_len": length, "tokens": length - floor,
                "blocks": n}

    # already at least as warm: the trie holds this exact prefix (or
    # a longer one through it) — re-importing would duplicate blocks
    node, depth = engine.prefix_cache._walk(tuple(tokens))
    if depth == len(tokens) and (
            node.row is not None
            or engine.prefix_cache._shallowest_stored(node)
            is not None):
        engine.stats["kv_import_declined"] += 1
        return result(False, "already_warm")
    # allocation may evict LRU trie entries but must NEVER preempt a
    # live slot: an import is a cache fill, not admitted work
    if not engine._paged_reserve(n, protect=set(range(engine.n_slots))):
        engine.stats["kv_import_declined"] += 1
        return result(False, "no_blocks")
    tab = BlockTable(bt, length=length, floor=floor)
    for g in header["blocks"]:
        bid = engine.block_pool.alloc()
        if bid is None:  # _paged_reserve just guaranteed n frees
            raise AssertionError("reserved kv-import alloc failed")
        tab.blocks[g] = bid
    ids = padded_ids(engine, [tab.blocks[g] for g in header["blocks"]])
    t0 = engine._clock()
    with engine._span("serving.kv_import", prefix_len=length,
                      blocks=n, bytes=len(payload)):
        for name, st in engine._pool.items():
            for leaf, new in zip((st["pk"], st["pv"]), shipped[name]):
                new = new.to(leaf.device)
                if len(ids) != n:
                    new = torch.cat([new, new.new_zeros(
                        (len(ids) - n,) + tuple(new.shape[1:]))])
                leaf.index_copy_(0, ids, new)
    ok = engine.prefix_cache.insert_blocks(tokens, tab)
    engine._free_table(tab)
    if not ok:
        engine.stats["kv_import_declined"] += 1
        return result(False, "trie_full")
    dt = engine._clock() - t0
    engine.stats["kv_imports"] += 1
    engine.stats["kv_imported_tokens"] += length - floor
    engine.stats["kv_imported_blocks"] += n
    engine._observe("serving_kv_import_s", dt)
    if engine.tracer is not None:
        engine.tracer.incr("serving_kv_imports")
        engine.tracer.incr("serving_kv_imported_tokens", length - floor)
    return result(True, "imported")
