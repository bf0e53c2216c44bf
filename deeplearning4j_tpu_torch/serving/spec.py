"""Self-speculative decoding: host-side n-gram draft tables.

Port of ``deeplearning4j_tpu/serving/spec.py`` (pure Python, copied
whole). Decode is memory-bandwidth-bound: every autoregressive step
re-reads the full model weights to emit ONE token. Speculative decoding
(Leviathan et al. 2023, "Fast Inference from Transformers via
Speculative Decoding") amortizes that wall: draft K candidate tokens
cheaply, then VERIFY all K in ONE forward pass — the masked chunk
continuation the engine already uses for chunked prefill
(``AttentionImpl._stream_attend``, or ``_paged_attend`` over the block
pool) scores K right-padded positions per slot in a single dispatch, so
checking K drafts costs one weight read instead of K.

The draft here is free (prompt-lookup / n-gram drafting, Saxena 2023):
no second model, no extra device state. Each slot keeps its OWN context
(prompt + generated ids) and a suffix index over it; real text is
self-similar (templated output, quoted input spans, repetition loops),
so the historical continuation of the context's trailing n-gram is a
cheap, often-correct guess at what the model emits next. A wrong guess
costs nothing but the wasted verify lane: the verify pass emits the
model's OWN token at the first divergence, so every round still
advances at least one token and greedy output is exactly the plain
greedy decode (the engine's testable invariant).

:class:`NgramDraftTable` is pure host state:

- ``seed(slot, ids)`` — (re)build a slot's context + suffix index
  (admission, snapshot-restore rebuild). O(len(ids)).
- ``extend(slot, tokens)`` — append committed tokens; O(1) amortized
  per token (registers at most ``max_ngram`` suffix n-grams each).
- ``draft(slot, k)`` — up to ``k`` proposed next tokens,
  longest-match-wins: the longest trailing n-gram (``max_ngram`` down
  to ``min_ngram``) seen earlier in the context gets its historical
  continuation proposed (most recent occurrence wins a tie). Empty
  when nothing matches — the engine then falls back to the plain
  decode graph, so drafting is an accelerator, never a
  requirement.
- ``drop(slot)`` — forget a slot (eviction, cancellation, quarantine:
  a quarantined slot's draft state must die with its KV rows).

Index trick: an n-gram ending at position ``p`` is registered only
once position ``p + 1`` exists — i.e. when its continuation is known —
so a lookup always lands on an occurrence with at least one
continuation token, and the context's trailing n-gram can never match
itself.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


class NgramDraftTable:
    """Per-slot prompt-lookup draft tables over committed token ids.

    ``max_ngram``/``min_ngram`` bound the suffix lengths tried at draft
    time (longest first). Larger n-grams are more specific (higher
    acceptance when they hit, fewer hits); the 3..1 default is the
    standard prompt-lookup range."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1:
            raise ValueError(f"min_ngram {min_ngram} < 1")
        if max_ngram < min_ngram:
            raise ValueError(
                f"max_ngram {max_ngram} < min_ngram {min_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self._ctx: Dict[int, List[int]] = {}
        #: per slot: trailing n-gram -> continuation START position of
        #: its most recent registered occurrence (see module docstring)
        self._index: Dict[int, Dict[Tuple[int, ...], int]] = {}

    def seed(self, slot: int, ids: Sequence[int]) -> None:
        """(Re)build ``slot``'s context from scratch — admission seeds
        with prompt + first token; snapshot restore rebuilds
        deterministically from the recorded prompt + generated ids
        (the table is derived state, so a rebuild is exact)."""
        self._ctx[slot] = []
        self._index[slot] = {}
        self.extend(slot, ids)

    def extend(self, slot: int, tokens: Sequence[int]) -> None:
        """Append committed tokens to ``slot``'s context. O(1) per
        token: each append registers only the n-grams ending at the
        PREVIOUS position (they just gained a continuation)."""
        ctx = self._ctx[slot]
        index = self._index[slot]
        for tok in tokens:
            ctx.append(int(tok))
            end = len(ctx) - 2  # n-grams ending here now continue
            if end < 0:
                continue
            for n in range(self.min_ngram, self.max_ngram + 1):
                if n > end + 1:
                    break
                index[tuple(ctx[end - n + 1:end + 1])] = end + 1

    def draft(self, slot: int, k: int) -> List[int]:
        """Up to ``k`` proposed next tokens for ``slot``:
        longest-match-wins over the trailing n-grams, proposing the
        tokens that followed the match's most recent occurrence. When
        the continuation runs into the context end before ``k`` tokens,
        the lookup re-matches against the VIRTUAL context
        ``ctx + draft-so-far`` — a context stuck in a period-p cycle
        then drafts the full ``k`` tokens instead of at most ``p``
        (a period-1 tail would otherwise cap every draft at ONE token,
        forfeiting most of the verify pass). Empty list = no match —
        the caller falls back to plain decode."""
        if k < 1:
            return []
        ctx = self._ctx.get(slot)
        if not ctx:
            return []
        index = self._index[slot]
        out: List[int] = []
        while len(out) < k:
            # only the trailing max_ngram tokens of the virtual
            # context (ctx + out) are ever consulted — build just that
            # tail instead of concatenating the whole context (draft()
            # runs per slot per round; ctx grows with the stream)
            n_total = len(ctx) + len(out)
            if len(out) >= self.max_ngram:
                tail = out[-self.max_ngram:]
            else:
                need = self.max_ngram - len(out)
                tail = ctx[max(0, len(ctx) - need):] + out
            pos = None
            for n in range(self.max_ngram, self.min_ngram - 1, -1):
                if n > n_total:
                    continue
                pos = index.get(tuple(tail[len(tail) - n:]))
                if pos is not None:
                    break
            if pos is None:
                break
            take = ctx[pos:pos + k - len(out)]
            if not take:
                break
            out.extend(take)
        return out

    def drop(self, slot: int) -> None:
        """Forget a slot (eviction/quarantine/cancel)."""
        self._ctx.pop(slot, None)
        self._index.pop(slot, None)

    def context(self, slot: int) -> List[int]:
        """The slot's committed ids (tests/introspection)."""
        return list(self._ctx.get(slot, []))

    def slots(self) -> List[int]:
        """Slots currently holding draft state (tests/introspection)."""
        return sorted(self._ctx)
