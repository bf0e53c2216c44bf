"""Continuous-batching decode engine over the paged KV block pool.

Port of the ``paged_kv=True`` core of ``deeplearning4j_tpu/serving/
engine.py:DecodeEngine``. A fixed set of ``n_slots`` decode slots is
multiplexed across many requests; their KV lives in one block pool per
attention layer (``[kv_blocks + 1, block_tokens, H, dh]``, the master
dtype; the last block, named ``scratch`` in each layer's pool dict, is
the scratch block of the fixed-shape K/V scatter, which no table maps),
addressed through per-slot host block tables (serving/block_pool.py).

One scheduling round (``step()``):

1. **Admit** — while a slot is free and requests are queued, prefill
   the next prompt at batch 1, right-padded to its pow2 length bucket
   and masked (``AttentionImpl._prefill_cache``: a padded prefill
   streams exactly like an unpadded one), then scatter the resulting
   window of K/V into freshly allocated blocks at their absolute
   positions (``_scatter_row``) and take the first token.
2. **Reserve** — make every running slot's table writable for the
   round's ``decode_chunk`` appends, allocating blocks as ``filled``
   crosses block boundaries; under pool pressure the youngest slot is
   preempted and its request requeued (greedy ids regenerate
   identically).
3. **Decode** — ``decode_chunk`` batched forward steps over all slots:
   each layer's ``_paged_attend`` scatters the step's K/V into the pool
   and attends through the block tables (the CUDA paged-attention
   kernel on the card). Where the JAX engine runs one ``lax.scan``, this
   is a Python loop with one host sync per round, when the round's
   tokens are fetched.
4. **Land** — advance the host tables, free blocks that slid out of
   every window, append tokens, and finish requests that reached
   ``max_new_tokens`` or their ``eos_id`` (the slot's blocks return to
   the free list).

The pool tensors are updated in place (the JAX engine threads a new
pool through each executable). Knobs of the JAX engine that this port
does not carry yet (the dense-slot layout, the prefix caches, chunked
prefill, speculative decoding, fault handling, tenancy, async and fused
rounds, KV tiers, tensor parallelism, incremental delivery, tracing)
raise ``NotImplementedError`` when set to anything but their default.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.layers import BaseRecurrentLayer
from deeplearning4j_tpu_torch.nn.layers.attention import ATTENTION_BEANS
from deeplearning4j_tpu_torch.serving.block_pool import BlockPool, BlockTable
from deeplearning4j_tpu_torch.serving.sampler import sample_tokens
from deeplearning4j_tpu_torch.serving.scheduler import (
    GenerationResult,
    Request,
    Scheduler,
)

#: knobs of the JAX engine this port does not carry yet, with the only
#: value it accepts for each (the JAX engine's default)
_UNPORTED = {
    "prefix_cache_rows": 0, "prefill_chunk": 0, "prefill_budget": None,
    "admission_policy": "ttft", "max_queue": None,
    "shed_policy": "reject-new", "adaptive_prefill": False,
    "pressure_high": None, "pressure_low": None, "paranoid": False,
    "fault_plan": None, "max_retries": 2, "retry_backoff_rounds": 1,
    "stall_threshold_s": None, "clock": None, "spec_draft_len": 0,
    "draft_source": "ngram", "on_delta": None, "emit_deltas": False,
    "record_timing": True, "flight_recorder": 256, "tp": 1,
    "tenants": None, "async_rounds": False, "fused_rounds": 0,
    "kv_host_tier_bytes": 0, "kv_disk_tier_path": None,
    "kv_disk_tier_bytes": None, "tracer": None,
}


@dataclasses.dataclass
class _Slot:
    request: Request
    tokens: List[int]
    ttft_s: Optional[float] = None


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class DecodeEngine:
    """Slot-multiplexed batched decoding for one LM-shaped
    ``MultiLayerNetwork`` (first layer ``n_in`` == output ``n_out`` ==
    vocab, one-hot io), on the net's device.

    ``submit`` requests, then ``run()`` drains queue and slots and
    returns ``{request_id: GenerationResult}``, or drive one round at a
    time with ``step()``. ``decode_chunk`` tokens are decoded per round.
    ``use_flash_paged`` selects the paged attention path (see
    ``nn.layers.attention._should_use_flash_paged``); like the JAX
    engine, a non-None value is stamped onto the net's attention beans.
    ``seed`` seeds the ``torch.Generator`` sampled requests draw from.
    Only ``paged_kv=True`` is ported."""

    def __init__(self, net, n_slots: int = 8, decode_chunk: int = 8,
                 min_prompt_bucket: int = 8, seed: int = 0,
                 paged_kv: bool = True, block_tokens: int = 16,
                 kv_blocks: Optional[int] = None, use_flash_paged=None,
                 **unported):
        for name, value in unported.items():
            if name not in _UNPORTED:
                raise TypeError(
                    f"DecodeEngine got an unexpected keyword {name!r}")
            if value != _UNPORTED[name]:
                raise NotImplementedError(
                    f"DecodeEngine({name}={value!r}) is not ported to the "
                    f"torch package yet (only {_UNPORTED[name]!r})")
        if not paged_kv:
            raise NotImplementedError(
                "the dense-slot engine (paged_kv=False) is not ported to "
                "the torch package yet; use paged_kv=True")
        if n_slots < 1:
            raise ValueError(f"n_slots {n_slots} < 1")
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk {decode_chunk} < 1")
        self.device = resolve_device(net.device)
        net.init()
        self.net = net
        self.n_slots = int(n_slots)
        self.decode_chunk = int(decode_chunk)
        confs = net.conf.confs
        self.vocab = confs[0].layer.n_in
        out_n = getattr(confs[-1].layer, "n_out", None)
        if self.vocab != out_n:
            raise ValueError(
                "DecodeEngine requires an LM-shaped net (first-layer n_in "
                f"== output n_out; got {self.vocab} vs {out_n})")
        windows = []
        attn = []
        for i, c in enumerate(confs):
            bean = c.layer
            if getattr(bean, "ring_axis", None):
                raise ValueError(
                    f"layer {i} is configured with ring_axis="
                    f"{bean.ring_axis!r} and cannot stream; rebuild the "
                    "conf with ring_axis=None for serving")
            if not isinstance(bean, BaseRecurrentLayer):
                continue
            if not isinstance(bean, ATTENTION_BEANS):
                raise ValueError(
                    f"DecodeEngine streams through the attention KV cache; "
                    f"layer {i} ({type(bean).__name__}) carries a recurrent "
                    "state this engine does not support")
            windows.append(bean.stream_max_t)
            attn.append(bean)
        if not windows:
            raise ValueError(
                "DecodeEngine requires at least one attention layer")
        self.window = min(windows)
        self._wmax = max(windows)
        self.use_flash_paged = use_flash_paged
        if use_flash_paged is not None:
            for bean in attn:
                bean.use_flash_paged = use_flash_paged
        self.scheduler = Scheduler(self.window, min_bucket=min_prompt_bucket)
        # -- block pool sizing (the JAX engine's, with no spec/fused
        # writes and no prefix pool) -------------------------------------
        bt = self.block_tokens = int(block_tokens)
        if bt < 1 or (bt & (bt - 1)):
            raise ValueError(f"block_tokens {bt} must be a power of two")
        if bt > self.window:
            raise ValueError(
                f"block_tokens {bt} exceeds the cache window "
                f"({self.window}) — a block must fit inside it")
        round_write = self.decode_chunk + 1
        # ring width: the window, plus the widest single write (a whole
        # window at admission) plus one round's decode writes — a
        # logical block is never recycled while a query can reach it
        self._ring_slots = (_ceil_div(self._wmax, bt)
                            + _ceil_div(self.window, bt)
                            + _ceil_div(round_write, bt) + 3)
        slot_worst = (_ceil_div(self._wmax, bt)
                      + _ceil_div(round_write, bt) + 3)
        if kv_blocks is None:
            kv_blocks = max(
                _ceil_div(self._wmax, bt) * self.n_slots
                + self.n_slots * (_ceil_div(round_write, bt) + 2),
                slot_worst)
        self.kv_blocks = int(kv_blocks)
        if self.kv_blocks < slot_worst:
            raise ValueError(
                f"kv_blocks {self.kv_blocks} cannot hold one slot's window "
                f"+ one round of writes ({slot_worst} blocks of {bt} "
                "tokens)")
        self.block_pool = BlockPool(self.kv_blocks, bt)
        self._kv_tabs: List[Optional[BlockTable]] = [None] * self.n_slots
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._slots: List[Optional[_Slot]] = [None] * self.n_slots
        self._submit_t: Dict[int, float] = {}
        self._pool: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._toks: Optional[torch.Tensor] = None   # [B] current tokens
        self._temps = np.zeros(self.n_slots, np.float32)
        self._top_ks = np.full(self.n_slots, self.vocab, np.int64)
        self._round = 0
        self._terminal: Dict[int, GenerationResult] = {}
        self._requeue: List[Tuple[int, Request]] = []
        self.stats: Dict[str, Any] = {
            "tokens_generated": 0, "requests_finished": 0,
            "decode_time_s": 0.0, "chunks": 0, "decode_steps": 0,
            "occupancy_sum": 0.0, "admitted": 0, "evicted": 0,
            "prefill_tokens": 0, "blocks_free": self.kv_blocks,
            "blocks_used": 0, "frag_tokens": 0, "preempted": 0,
            "paged_admit_deferred": 0,
        }

    # -- forward -------------------------------------------------------
    def _forward(self, x, mask, rnn):
        """(out [B, V, T], new_rnn) of the net's streaming forward."""
        out, _, new_rnn = self.net._forward_fn(
            self.net.params, self.net.state, x, None, False,
            feature_mask=mask, rnn_state=rnn)
        return out, new_rnn

    # -- request lifecycle ---------------------------------------------
    def submit(self, request: Request) -> int:
        """Queue a request; returns its id (``run()`` drains)."""
        bad = [t for t in request.prompt if not 0 <= int(t) < self.vocab]
        if bad:
            raise ValueError(
                f"prompt ids {bad[:4]} outside vocab [0, {self.vocab})")
        if (request.deadline_s is not None
                or request.queue_timeout_s is not None):
            raise NotImplementedError(
                "request deadlines and queue timeouts are not ported to "
                "the torch package yet")
        rid = self.scheduler.submit(request)
        self._submit_t[rid] = time.perf_counter()
        return rid

    def has_work(self) -> bool:
        """True while anything is queued, requeued or decoding."""
        return bool(self.scheduler.pending or self._requeue
                    or any(s is not None for s in self._slots))

    def run(self) -> Dict[int, GenerationResult]:
        """Drain the queue: admit, decode in chunks, evict finished
        requests, until no work remains."""
        results: Dict[int, GenerationResult] = {}
        self._drain_terminal(results)
        while self.has_work():
            self.step(results)
        return results

    def _drain_terminal(self, results):
        if self._terminal:
            results.update(self._terminal)
            self._terminal.clear()

    def _record_terminal(self, state: _Slot, reason: str) -> None:
        req = state.request
        self._terminal[req.id] = GenerationResult(
            id=req.id, tokens=list(state.tokens), finish_reason=reason,
            prompt_len=len(req.prompt), ttft_s=state.ttft_s)
        self.stats["requests_finished"] += 1
        self._submit_t.pop(req.id, None)
        self.scheduler.release(req.id)

    @staticmethod
    def _hit_eos(state: _Slot) -> bool:
        req = state.request
        return bool(req.eos_id is not None and state.tokens
                    and state.tokens[-1] == req.eos_id)

    def _finished(self, state: _Slot) -> bool:
        return (len(state.tokens) >= state.request.max_new_tokens
                or self._hit_eos(state))

    def _finish(self, state: _Slot, slot: int) -> None:
        # eos wins even on the max_new_tokens-th token
        self._record_terminal(state, "eos" if self._hit_eos(state)
                              else "length")
        self._evict_slot(slot)

    def _evict_slot(self, slot: int) -> None:
        """Release the slot's block references (its blocks return to the
        free list) and free the slot."""
        tab = self._kv_tabs[slot]
        self._kv_tabs[slot] = None
        self._free_table(tab)
        self._slots[slot] = None
        self._temps[slot] = 0.0
        self._top_ks[slot] = self.vocab
        self.stats["evicted"] += 1

    # -- paged block-pool plumbing -------------------------------------
    def _free_table(self, tab: Optional[BlockTable]) -> None:
        if tab is None:
            return
        for bid in list(tab.blocks.values()):
            self.block_pool.deref(bid)
        tab.blocks.clear()

    def _paged_reserve(self, n: int, protect=()) -> bool:
        """Make ``n`` blocks allocatable by preempting the youngest
        unprotected slot(s)."""
        pool = self.block_pool
        while pool.free_blocks < n:
            victim = next((s for s in range(self.n_slots - 1, -1, -1)
                           if self._slots[s] is not None
                           and s not in protect), None)
            if victim is None:
                return False
            self._preempt_slot(victim)
        return True

    def _preempt_slot(self, slot: int) -> None:
        """Release a running slot's blocks under pool pressure and
        requeue its request for the next round (it prefills again from
        scratch; a greedy request regenerates identical ids)."""
        state = self._slots[slot]
        self.stats["preempted"] += 1
        tab = self._kv_tabs[slot]
        self._kv_tabs[slot] = None
        self._free_table(tab)
        self._slots[slot] = None
        self._temps[slot] = 0.0
        self._top_ks[slot] = self.vocab
        self._requeue.append((self._round + 1, state.request))

    def _drain_requeue(self) -> None:
        ready = [q for r, q in self._requeue if r <= self._round]
        if not ready:
            return
        self._requeue = [(r, q) for r, q in self._requeue
                         if r > self._round]
        for req in ready:
            self.scheduler.requeue(req)

    def _ensure_tab(self, tab: BlockTable, n_tokens: int,
                    protect=()) -> bool:
        """Allocate the fresh blocks the next ``n_tokens`` appends cross
        into. False = the pool could not be relieved. (No block is ever
        shared without a prefix cache, so no copy-on-write arises.)"""
        need = len(tab.new_logical_blocks(n_tokens))
        if need and not self._paged_reserve(need, protect):
            return False
        for g in tab.new_logical_blocks(n_tokens):
            old = g - self._ring_slots
            if old in tab.blocks:   # safety: expired ring predecessor
                self.block_pool.deref(tab.blocks.pop(old))
            bid = self.block_pool.alloc()
            if bid is None:
                raise AssertionError("reserved allocation failed")
            tab.blocks[g] = bid
        return True

    def _free_expired_blocks(self, tab: BlockTable) -> None:
        """Release blocks that slid entirely out of every layer's
        window."""
        for g in sorted(tab.blocks):
            if (g + 1) * self.block_tokens <= tab.length - self._wmax:
                self.block_pool.deref(tab.blocks.pop(g))
            else:
                break

    def _alloc_window_tab(self, length: int) -> Optional[BlockTable]:
        """A fresh BlockTable covering the last ``min(length, wmax)``
        absolute positions (what a B=1 prefill row holds); None when the
        pool cannot be relieved."""
        bt = self.block_tokens
        floor = max(0, length - self._wmax)
        gs = list(range(floor // bt, (length - 1) // bt + 1))
        if not self._paged_reserve(len(gs)):
            return None
        tab = BlockTable(bt, length=length, floor=floor)
        for g in gs:
            tab.blocks[g] = self.block_pool.alloc()
        return tab

    def _paged_rnn_rows(self, tabs):
        """The paged rnn-state operand for a dispatch: each layer's pool
        tensors plus every row's ring-projected block table (None rows —
        idle slots — map nothing; their writes drop and their keys all
        mask). The table operands are shared by every layer."""
        b, s_ring = len(tabs), self._ring_slots
        table = np.full((b, s_ring), -1, np.int32)
        base = np.full((b, s_ring), -1, np.int32)
        floor = np.zeros(b, np.int32)
        filled = np.zeros(b, np.int32)
        for i, tab in enumerate(tabs):
            if tab is None:
                continue
            table[i], base[i] = tab.arrays(s_ring)
            floor[i] = tab.floor
            filled[i] = tab.length
        dev = self.device
        ops = {"table": torch.as_tensor(table).to(dev),
               "base": torch.as_tensor(base).to(dev),
               "floor": torch.as_tensor(floor).to(dev),
               "filled": torch.as_tensor(filled).to(dev)}
        return {name: dict(st, **ops) for name, st in self._pool.items()}

    def _ensure_paged_pool(self, rnn1) -> None:
        """Create the device block pool lazily from the first B=1
        prefill state (per layer ``[kv_blocks + 1, block_tokens, H, dh]``
        in the state's dtype, the net's master dtype). The last block is
        the scratch block that fixed-shape scatters send dropped rows to
        (``AttentionImpl._paged_attend``), named by the layer's
        ``scratch`` entry: ``block_pool`` never hands it out, so no table
        maps it."""
        if self._pool is not None:
            return
        bt = self.block_tokens

        def make(st):
            k = st["k"]                          # [1, H, W, dh]
            shape = (self.kv_blocks + 1, bt, k.shape[1], k.shape[3])
            return {"pk": torch.zeros(shape, dtype=k.dtype, device=k.device),
                    "pv": torch.zeros(shape, dtype=st["v"].dtype,
                                      device=k.device),
                    "scratch": int(self.kv_blocks)}

        self._pool = {name: make(st) for name, st in rnn1.items()}
        self._toks = torch.zeros(self.n_slots, dtype=torch.int32,
                                 device=self.device)

    def _scatter_row(self, rnn1, table_row: np.ndarray, length: int):
        """Cold admission: write a B=1 prefill row's valid window tokens
        to their absolute positions in the slot's freshly allocated
        blocks, IN PLACE. A fixed-shape scatter, as in
        ``AttentionImpl._paged_attend``: every window position is
        written, those outside the row's ``filled`` span or in an
        unmapped block to the pool's scratch block (``scratch``), so no
        boolean selection syncs the host (JAX's ``mode="drop"`` scatter
        has no torch counterpart)."""
        bt, s_ring = self.block_tokens, self._ring_slots
        tr = torch.as_tensor(table_row).to(self.device)
        for name, st in self._pool.items():
            k1, v1 = rnn1[name]["k"], rnn1[name]["v"]
            fd = rnn1[name]["filled"][0]
            w = k1.shape[2]
            nbk, _, h, dh = st["pk"].shape
            absp = length - w + torch.arange(w, device=self.device)
            safe = torch.clamp(absp, min=0)
            blk = tr[((safe // bt) % s_ring).long()]
            sel = (absp >= length - fd) & (blk >= 0)
            idx = torch.where(sel, blk * bt + safe % bt,
                              st["scratch"] * bt + safe % bt).long()
            kt = k1[0].permute(1, 0, 2)          # [W, H, dh]
            vt = v1[0].permute(1, 0, 2)
            st["pk"].view(nbk * bt, h, dh).index_put_(
                (idx,), kt.to(st["pk"].dtype))
            st["pv"].view(nbk * bt, h, dh).index_put_(
                (idx,), vt.to(st["pv"].dtype))

    # -- admission -----------------------------------------------------
    def _one_hot_prompt(self, prompt, bucket):
        x = torch.zeros((1, self.vocab, bucket), dtype=torch.float32)
        x[0, torch.as_tensor(list(prompt)), torch.arange(len(prompt))] = 1.0
        mask = torch.zeros((1, bucket), dtype=torch.float32)
        mask[0, :len(prompt)] = 1.0
        return x.to(self.device), mask.to(self.device)

    def _admit(self, request: Request, slot: int) -> None:
        """Cold admission into ``slot``: bucketed masked prefill at B=1,
        the scatter into fresh blocks, and the first token. Deferred to
        the next round when the pool cannot hold it."""
        prompt = [int(t) for t in request.prompt]
        width = self.scheduler.bucket_of(len(prompt))
        x, mask = self._one_hot_prompt(prompt, width)
        out, rnn1 = self._forward(x, mask, None)
        probs = out[:, :, len(prompt) - 1]
        tok = sample_tokens(
            probs, np.asarray([request.temperature], np.float32),
            np.asarray([request.top_k or self.vocab]), self._gen)
        self.stats["prefill_tokens"] += len(prompt)
        self._ensure_paged_pool(rnn1)
        tab = self._alloc_window_tab(len(prompt))
        if tab is None:
            self.stats["paged_admit_deferred"] += 1
            self._requeue.append((self._round + 1, request))
            return
        table_row, _ = tab.arrays(self._ring_slots)
        self._scatter_row(rnn1, table_row, tab.length)
        self._toks[slot] = tok[0]
        self._kv_tabs[slot] = tab
        # the value fetch is the sync point that makes TTFT honest
        first = int(tok[0])
        submit_t = self._submit_t.get(request.id)
        ttft = (time.perf_counter() - submit_t
                if submit_t is not None else None)
        state = _Slot(request, [first], ttft_s=ttft)
        self._slots[slot] = state
        self._temps[slot] = request.temperature
        self._top_ks[slot] = request.top_k or self.vocab
        self.stats["tokens_generated"] += 1
        self.stats["admitted"] += 1
        if self._finished(state):
            self._finish(state, slot)

    # -- the scheduling round ------------------------------------------
    def _decode_round(self, active: List[int]) -> None:
        chunk = self.decode_chunk
        ensured: set = set()
        for slot in list(active):
            if self._slots[slot] is None:
                continue   # preempted by an earlier reservation
            if self._ensure_tab(self._kv_tabs[slot], chunk,
                                protect=ensured | {slot}):
                ensured.add(slot)
            else:
                self._preempt_slot(slot)
        active = [s for s in active if self._slots[s] is not None]
        if not active:
            return
        t0 = time.perf_counter()
        rnn = self._paged_rnn_rows(self._kv_tabs)
        tok = self._toks
        steps = []
        for _ in range(chunk):
            x = F.one_hot(tok.long(), self.vocab).to(
                self.net._dtype)[:, :, None]
            out, rnn = self._forward(x, None, rnn)
            tok = sample_tokens(out[:, :, -1], self._temps, self._top_ks,
                                self._gen)
            steps.append(tok)
        self._toks = tok
        seq = torch.stack(steps, dim=1).cpu().numpy()   # the round's sync
        dt = time.perf_counter() - t0
        emitted = 0
        for slot in active:
            tab = self._kv_tabs[slot]
            tab.length += chunk
            self._free_expired_blocks(tab)
            state = self._slots[slot]
            for t in seq[slot]:
                state.tokens.append(int(t))
                emitted += 1
                if self._finished(state):
                    break
            if self._finished(state):
                self._finish(state, slot)
        self.stats["tokens_generated"] += emitted
        self.stats["decode_time_s"] += dt
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += chunk
        self.stats["occupancy_sum"] += len(active) / self.n_slots

    def step(self, results: Optional[Dict[int, GenerationResult]] = None
             ) -> Dict[int, GenerationResult]:
        """One scheduling round: requeue, admit into free slots, one
        decode chunk, evictions. Terminal results accumulate into (and
        are returned via) ``results``."""
        if results is None:
            results = {}
        with torch.no_grad():
            self._drain_requeue()
            for slot in range(self.n_slots):
                if self._slots[slot] is None and self.scheduler.pending:
                    self._admit(self.scheduler.pop_admissible(), slot)
            active = [i for i, s in enumerate(self._slots)
                      if s is not None]
            if active:
                self._decode_round(active)
        pool = self.block_pool
        self.stats["blocks_free"] = pool.free_blocks
        self.stats["blocks_used"] = pool.used_blocks
        self.stats["frag_tokens"] = pool.fragmentation_tokens(self._kv_tabs)
        self._round += 1
        self._drain_terminal(results)
        return results
