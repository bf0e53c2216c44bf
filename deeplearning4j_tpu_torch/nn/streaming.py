"""Slot-aware streaming-state utilities and the bucketed generate scan.

Port of ``deeplearning4j_tpu/nn/streaming.py``. Shared by the
network-level rnn-state APIs (``MultiLayerNetwork.rnn_time_step``,
``rnn_clear_previous_state``, ``generate``) and the serving decode
engine (``serving/engine.py``).

CONTRACT: streaming state is batch-major. Every tensor leaf of an
rnn-state tree (attention ``k``/``v``/``filled``, a recurrent layer's
carried ``(h, c)`` or ``h``) has the batch dimension on axis 0, one row
per batch element. The serving engine
treats those rows as KV-cache *slots*; :func:`clear_state_rows` relies
on the contract to reset single slots without touching their
neighbours. A zeroed attention row is exactly the empty-cache state
(``filled == 0`` masks every cached position in
``AttentionImpl._stream_attend``) and a zeroed recurrent row is the
layer's initial carry, so a cleared slot streams as if freshly
created.

Unlike the JAX package, :func:`clear_state_rows` zeroes the rows IN
PLACE (the serving engine's slot pool is the static input of its
captured decode graph, so it must keep its storage);
:func:`drop_newest_tokens` returns new tensors, as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.layers.attention import AttentionImpl


def scan_length_bucket(n: int, minimum: int = 8) -> int:
    """Next power of two >= max(n, minimum): the key of length-dependent
    decode graphs and prefill widths, which bounds their number at
    O(log max_len) under varied request lengths while wasting at most 2x
    steps for ``n >= minimum`` (below it, up to ``minimum`` steps run);
    the true length rides alongside as a device tensor, so masking stays
    exact."""
    n = max(int(n), int(minimum))
    return 1 << (n - 1).bit_length()


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensor leaves of nested dicts and tuples (with the
    matching leaves of ``rest``); anything else passes through
    unchanged."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return tree


def tree_leaves(tree: Any) -> list:
    """The tensor leaves of nested dicts and tuples, in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def make_bucketed_generate(step: Callable, vocab: int, dtype,
                           bucket: int) -> Callable:
    """The freeze-carry greedy decode body shared by
    ``MultiLayerNetwork.generate``'s captured graphs and its eager run.

    ``step(x, rnn) -> (out [B, V, T], new_rnn)`` is the network's
    streaming forward for one one-hot token. The returned
    ``body({"rnn": rnn_state, "tok": tok0 [B] int32, "n_rem": [] int32})
    -> {"toks": [B, bucket] int32, "rnn": rnn_state}`` runs ``bucket``
    steps with the true remaining length a device tensor: steps at
    ``i >= n_rem`` freeze the carry, so one graph serves every
    ``n_tokens`` of the bucket and the rnn state still lands exactly at
    the post-generation position. No step reads a value back to the
    host, so the body captures into one CUDA graph."""
    def body(ops):
        rnn, tok, n_rem = ops["rnn"], ops["tok"], ops["n_rem"]
        toks = []
        for i in range(bucket):
            x = F.one_hot(tok.long(), vocab).to(dtype)[:, :, None]
            out, new_rnn = step(x, rnn)
            nxt = torch.argmax(out[:, :, -1], dim=1).to(torch.int32)
            live = n_rem > i          # bucket-pad steps freeze the carry
            rnn = tree_map(lambda a, b: torch.where(live, a, b), new_rnn,
                           rnn)
            tok = torch.where(live, nxt, tok)
            toks.append(nxt)
        return {"toks": torch.stack(toks, dim=1), "rnn": rnn}

    return body


def reset_streaming_state(rnn_state: Any, slots) -> Any:
    """Shared body of ``rnn_clear_previous_state``: ``slots=None`` wipes
    everything (a fresh empty container), ``slots=[...]`` zeroes only
    those batch rows through :func:`clear_state_rows`. Returns the new
    state container."""
    if slots is None:
        return {}
    if not rnn_state:
        raise ValueError(
            "no streaming state to clear slots from — run "
            "rnn_time_step first (or call without slots)")
    return clear_state_rows(rnn_state, slots)


def drop_newest_tokens(rnn_state: Any, drop) -> Any:
    """Rewind every attention KV-cache in a streaming-state tree by
    ``drop`` tokens (0 or more), returning the state as it was before the
    newest ``drop`` tokens streamed in. ``drop`` is a scalar (every row
    rewinds equally) or a per-row ``[N]`` vector (each row its own
    count).

    Valid because K/V at a position are per-token projections of that
    token alone: the dense cache rolls right by ``drop``, which wraps the
    dropped K/V into the left region that the decremented ``filled``
    already invalidates. A paged cache (``pk`` in the layer's state)
    only moves ``filled`` back: its stale tail is masked by the causal
    position check and overwritten by the next append (block
    bookkeeping is the engine's). The caller guarantees ``drop <=
    filled`` per row and that none of the dropped tokens pushed an older
    token out of the window. Raises on a state with no ``filled``
    vector."""
    out = {}
    for name, st in (rnn_state or {}).items():
        if not (isinstance(st, dict) and "filled" in st):
            raise ValueError(
                f"streaming state for layer {name!r} carries no "
                "KV-cache 'filled' vector — only attention caches can "
                "be rewound by token")
        filled = st["filled"]
        d = torch.as_tensor(drop, device=filled.device)
        if d.ndim > 1:
            raise ValueError(
                f"drop must be a scalar or per-row vector; got shape "
                f"{tuple(d.shape)}")
        new_filled = (filled - d).to(filled.dtype)
        if "pk" in st:
            out[name] = dict(st, filled=new_filled)
            continue
        k, v = AttentionImpl._right_align(d.expand(filled.shape[0]),
                                          st["k"], st["v"])
        out[name] = {"k": k, "v": v, "filled": new_filled}
    return out


def clear_state_rows(rnn_state: Any, slots: Iterable[int]) -> Any:
    """Zero the given batch rows of every tensor leaf of a
    streaming-state tree IN PLACE, leaving all other rows untouched, and
    return the tree.

    The per-slot counterpart of the whole-batch wipe: the serving engine
    evicts a finished request by clearing its slot while the other slots
    keep decoding. Slot indices are checked against the state's batch
    size; a scalar leaf violates the batch-major contract and raises."""
    idx = sorted({int(s) for s in slots})
    leaves = tree_leaves(rnn_state)
    if not idx or not leaves:
        return rnn_state
    for leaf in leaves:
        if leaf.ndim < 1:
            raise ValueError(
                "streaming-state leaf is scalar — per-slot clearing "
                "requires batch-major state (axis 0 = slot); re-run "
                "the prefill with this version's per-row cache")
    n = min(leaf.shape[0] for leaf in leaves)
    bad = [s for s in idx if s < 0 or s >= n]
    if bad:
        raise ValueError(
            f"slots {bad} out of range for streaming batch size {n}")
    for leaf in leaves:
        rows = torch.as_tensor(idx, device=leaf.device)
        leaf.index_fill_(0, rows, 0)
    return rnn_state
