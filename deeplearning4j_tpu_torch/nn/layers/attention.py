"""Multi-head self-attention, the pre-LN transformer block, and the
wrappers of the two attention kernels.

Port of ``deeplearning4j_tpu/nn/layers/attention.py``: ``AttentionImpl``
(``apply``, ``_attend_core``, the masked dense attention, the flash
attention of training and long prefill, the prefill KV cache, the
dense-slot streaming attend of ``rnn_time_step``/``generate`` and the
dense engine, and the paged block-pool attend), ``guard_streamable`` and
``TransformerBlockImpl``, over the same ``[N, C, T]`` activations and
``[B, H, T, dh]`` heads, with the mesh routes of a ``ParallelTrainer``
step (``parallel/collectives.py:ParallelScope``): under tensor
parallelism each rank holds ``n_heads/T`` whole heads (the Wq/Wk/Wv
columns and the Wo rows of ``tp_param_specs``), so the core, and K1,
runs on [B, H/T, T, dh]; Megatron's *f* goes before the q/k/v (and
W1) projections and *g* after Wo (and W2). A layer with ``ring_axis``
runs ring or Ulysses attention over that axis
(``parallel/sequence_parallel.py``).

Two hand-written CUDA kernels, each with its plain PyTorch version:

- K1, ``csrc/flash_attention.cu`` through :func:`flash_attention` (a
  ``torch.autograd.Function``: forward and dQ/dK/dV backward); plain
  version :func:`flash_attention_reference`. Dispatch:
  :func:`_should_use_flash`. At float32 its kernels read operands that
  its split pass prepares (:func:`f32_operands`, plain version
  :func:`f32_operands_reference`).
- K2, ``csrc/paged_attention.cu`` through :func:`paged_attention`; plain
  version :func:`paged_attention_reference`, the JAX package's
  gather-by-block-table program.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from deeplearning4j_tpu_torch import cuda_build
from deeplearning4j_tpu_torch.nn.conf.layers import BaseRecurrentLayer
from deeplearning4j_tpu_torch.nn.conf.serde import register_bean
from deeplearning4j_tpu_torch.nn.layers.base import LayerImplBase
from deeplearning4j_tpu_torch.nn.layers.normalization import layer_norm
from deeplearning4j_tpu_torch.nn.weights import init_weights
from deeplearning4j_tpu_torch.ops.activations import activation
from deeplearning4j_tpu_torch.parallel.collectives import (
    copy_to_group,
    current_scope,
    reduce_from_group,
    ring_axis_group,
    tp_local,
)


@register_bean("MultiHeadSelfAttention")
@dataclasses.dataclass
class MultiHeadSelfAttention(BaseRecurrentLayer):
    """Conf bean: n_in = model width C, n_out = model width out; heads
    must divide n_out. Same fields and defaults as the JAX bean, so the
    conf JSON round-trips; ``use_flash_paged`` selects the paged decode
    path (see :func:`_should_use_flash_paged`)."""

    n_heads: int = 4
    causal: bool = True
    ring_axis: Optional[str] = None
    ring_block_size: Optional[int] = None
    sp_mode: str = "ring"
    use_flash: Optional[bool] = None
    use_flash_paged: Optional[object] = None
    stream_max_t: int = 512


@register_bean("TransformerBlock")
@dataclasses.dataclass
class TransformerBlock(BaseRecurrentLayer):
    """Conf bean: a pre-LN transformer block — LayerNorm → multi-head
    self-attention → residual, then LayerNorm → FFN (``ffn_mult``× inner
    width) → residual. ``n_in != n_out`` adds a learned input projection
    ``Wi`` with no residual across it."""

    n_heads: int = 4
    causal: bool = True
    ffn_mult: int = 4
    ffn_activation: str = "gelu"
    ring_axis: Optional[str] = None
    ring_block_size: Optional[int] = None
    sp_mode: str = "ring"
    use_flash: Optional[bool] = None
    use_flash_paged: Optional[object] = None
    stream_max_t: int = 512


ATTENTION_BEANS = (MultiHeadSelfAttention, TransformerBlock)


def _mm(a, b):
    """``a @ b`` under JAX's type promotion: operands of two float
    dtypes meet at the wider one (torch refuses mixed-dtype matmuls).
    It matters under bf16 compute, where a float32 mask promotes a
    masked block's output, and so the following layers, to float32, as
    in the JAX package."""
    ct = torch.promote_types(a.dtype, b.dtype)
    return a.to(ct) @ b.to(ct)


def _split_heads(y, h, dh):
    """[N, T, D] -> [N, H, T, dh]."""
    return y.reshape(y.shape[0], y.shape[1], h, dh).permute(0, 2, 1, 3)


def _merge_heads(o):
    """[N, H, T, dh] -> [N, T, H * dh]."""
    n, h, t, dh = o.shape
    return o.permute(0, 2, 1, 3).reshape(n, t, h * dh)


def _tp_axis():
    """The live tensor-parallel axis of this step, or None."""
    scope = current_scope()
    return None if scope is None else scope.tp_axis


def _tp_in(x, tp):
    """Megatron's *f* before a column-parallel projection."""
    return x if tp is None else copy_to_group(x, tp.group)


def _tp_out(y, tp):
    """Megatron's *g* after a row-parallel projection: the partial sums
    add up in float32 and round to the compute dtype once."""
    if tp is None:
        return y
    return reduce_from_group(y.float(), tp.group).to(y.dtype)


def _check_streamable(lc):
    if not lc.causal:
        raise ValueError(
            "non-causal (bidirectional) attention cannot stream: "
            "continuation would need future tokens; use causal=True or "
            "run output() on full sequences")


class AttentionImpl(LayerImplBase):
    @classmethod
    def init(cls, gen, conf, dtype=torch.float32, device="cpu") -> dict:
        lc = conf.layer
        scheme, dist = conf.resolved("weight_init"), conf.resolved("dist")
        d_in, d = lc.n_in, lc.n_out
        p = {name: init_weights(gen, shape, scheme, dist, dtype, device)
             for name, shape in (("Wq", (d_in, d)), ("Wk", (d_in, d)),
                                 ("Wv", (d_in, d)), ("Wo", (d, d)))}
        p["b"] = torch.zeros(d, dtype=dtype, device=device)
        return p

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        lc = conf.layer
        h, d = lc.n_heads, lc.n_out
        if d % h:
            raise ValueError(f"n_out {d} not divisible by n_heads {h}")
        dh = d // h
        tp = _tp_axis()
        h = tp_local(h, tp)
        x = cls.maybe_dropout(conf, x, train, rng)
        xt = _tp_in(x.transpose(1, 2), tp)  # [N, T, C]
        q = _split_heads(_mm(xt, params["Wq"]), h, dh)
        k = _split_heads(_mm(xt, params["Wk"]), h, dh)
        v = _split_heads(_mm(xt, params["Wv"]), h, dh)
        o, state = cls._attend_core(lc, q, k, v, state, train, mask)
        out = _tp_out(_mm(_merge_heads(o), params["Wo"]), tp) + params["b"]
        out = cls.activation_of(conf)(out).transpose(1, 2)  # [N, D, T]
        if mask is not None:
            out = out * mask[:, None, :]
        return out, state

    @classmethod
    def _attend_core(cls, lc, q, k, v, state, train, mask):
        """Attention core on [N, H, T, dh] q/k/v, shared with
        TransformerBlockImpl: paged continuation over the serving block
        pool, or full-sequence attention (K1 or masked dense, by
        :func:`_should_use_flash`) plus, outside training, the prefill
        KV cache."""
        if state is not None:
            if isinstance(state, dict) and "pk" in state:
                return cls._paged_attend(lc, q, k, v, state, mask)
            return cls._stream_attend(lc, q, k, v, state, mask)
        if lc.ring_axis:
            from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
                ring_attention,
                ulysses_attention,
            )

            axis = ring_axis_group(lc.ring_axis)
            if lc.sp_mode == "ulysses":
                if lc.ring_block_size:
                    raise ValueError(
                        "ring_block_size bounds the RING schedule's score "
                        "memory; ulysses materializes the full [T, T] "
                        "scores of its local heads — unset ring_block_size "
                        "or use sp_mode='ring'")
                o = ulysses_attention(q, k, v, axis, causal=lc.causal,
                                      key_mask=mask, use_flash=lc.use_flash)
            elif lc.sp_mode == "ring":
                o = ring_attention(q, k, v, axis, causal=lc.causal,
                                   key_mask=mask,
                                   block_size=lc.ring_block_size,
                                   use_flash=lc.use_flash)
            else:
                raise ValueError(
                    f"sp_mode {lc.sp_mode!r}: expected 'ring' or 'ulysses'")
            return o, None
        if _should_use_flash(lc.use_flash, q, mask):
            o = flash_attention(q, k, v, lc.causal)
        else:
            o = _dense_attention(q, k, v, lc.causal, mask)
        # training never builds the prefill cache (tBPTT windows stay
        # independent, as in the JAX package)
        new_state = None if train else cls._prefill_cache(lc, k, v, mask)
        return o, new_state

    @staticmethod
    def _right_align(shift, *arrays):
        """Right-rotate each batch row of ``[N, H, T, dh]`` arrays by its
        per-row ``shift`` along the time axis, so that after rotation a
        ``[:, :, -tm:, :]`` window keeps real tokens contiguous at the
        right edge and the wrapped pad lands in the masked left
        region."""
        out = []
        for a in arrays:
            n, h, t, dh = a.shape
            src = (torch.arange(t, device=a.device)[None, :]
                   - shift.to(a.device)[:, None]) % t       # [N, T]
            idx = src[:, None, :, None].expand(n, h, t, dh)
            out.append(torch.gather(a, 2, idx))
        return tuple(out)

    @classmethod
    def _prefill_cache(cls, lc, k, v, mask=None):
        """Right-align the last ``stream_max_t`` K/V positions into the
        fixed-size cache (zeros pad the left when underfilled); ``filled``
        is a per-row int32 vector counting only real tokens. A
        right-padded prompt (``mask``) streams exactly like its unpadded
        prefill: its pad wraps into the masked left region."""
        tm = lc.stream_max_t
        n, h, t, dh = k.shape
        if mask is None:
            filled = torch.full((n,), min(t, tm), dtype=torch.int32,
                                device=k.device)
        else:
            lengths = (mask > 0).sum(dim=1).to(torch.int32)
            k, v = cls._right_align(t - lengths, k, v)
            filled = torch.clamp(lengths, max=tm)
        zk = torch.zeros((n, h, tm, dh), dtype=k.dtype, device=k.device)
        ck = torch.cat([zk, k], dim=2)[:, :, -tm:, :]
        cv = torch.cat([zk, v], dim=2)[:, :, -tm:, :]
        return {"k": ck, "v": cv, "filled": filled}

    @classmethod
    def _stream_attend(cls, lc, q, k, v, cache, mask=None):
        """Dense attention of the current chunk's queries over cache +
        chunk (``rnn_time_step``, ``generate`` and the dense-slot
        engine). The cache ``{k, v: [N, H, tm, dh], filled: [N] int32}``
        stays ``stream_max_t`` long (static shapes: one captured decode
        step whatever has streamed); the oldest tokens slide out when
        the window is exceeded.

        The JAX program, kept as it is: attend over the FULL ``[cache |
        chunk]`` extension (length ``tm + t``) and slice only the
        returned cache (slicing before attending would drop cached keys
        still inside the window of the chunk's early queries). Each row's
        ``filled`` masks its cache positions, so slots at different fill
        levels share one batched step. ``mask`` ([N, t] 1/0, right
        padded) marks each row's valid chunk prefix: pad keys get no
        weight, ``filled`` advances by each row's true chunk length, and
        the pad is rotated out of view (:meth:`_right_align`) before the
        cache is sliced.

        Plain torch with no kernel behind it, so its numerics are the
        JAX package's: scores divided by ``sqrt(dh)`` rounded to q's
        dtype, masked to ``-1e30`` in q's dtype, softmax over the last
        axis, in the promoted dtype of q and the cache (float32 for a
        bf16 net: the carried cache is at the master dtype)."""
        _check_streamable(lc)
        tm = lc.stream_max_t
        t = q.shape[2]
        if t > tm:
            raise ValueError(
                f"rnn_time_step continuation chunk of {t} steps exceeds "
                f"stream_max_t={tm}: raise stream_max_t or stream "
                "smaller chunks")
        ek = torch.cat([cache["k"], k], dim=2)            # [N,H,tm+t,dh]
        ev = torch.cat([cache["v"], v], dim=2)
        prev = cache["filled"]                            # [N]
        if mask is None:
            lengths = torch.full((q.shape[0],), t, dtype=torch.int32,
                                 device=q.device)
        else:
            lengths = (mask > 0).sum(dim=1).to(torch.int32)
        filled = torch.clamp(prev + lengths, max=tm).to(torch.int32)
        ct = torch.promote_types(q.dtype, ek.dtype)
        # scalars made on the device (fill kernels), never copied from
        # the host: the body is captured into a CUDA graph
        div = torch.full((), float(q.shape[-1]), dtype=q.dtype,
                         device=q.device).sqrt()
        scores = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), ek.to(ct)) / div
        j = torch.arange(tm + t, device=q.device)         # extension pos
        i = torch.arange(t, device=q.device)              # query i at tm+i
        ok = ((j[None, :] <= tm + i[:, None])             # causal
              & (j[None, :] >= i[:, None] + 1))           # last-tm window
        # per-row validity: cache zeros (an idle or evicted slot's rows:
        # filled == 0 masks the whole cache) never receive weight
        ok = ok[None] & (j[None, None, :] >= tm - prev[:, None, None])
        if mask is not None:
            ok = ok & ((j[None, None, :] < tm)
                       | (j[None, None, :] - tm < lengths[:, None, None]))
        neg = torch.full((), -1e30, dtype=q.dtype, device=q.device)
        scores = torch.where(ok[:, None], scores, neg)
        w = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", w, ev.to(ct))
        if mask is not None:
            ek, ev = cls._right_align(t - lengths, ek, ev)
        return o, {"k": ek[:, :, -tm:, :], "v": ev[:, :, -tm:, :],
                   "filled": filled}

    @classmethod
    def _paged_attend(cls, lc, q, k, v, cache, mask=None):
        """Attention of a chunk's queries over the shared KV block pool
        (the serving engine's ``paged_kv=True`` layout).

        ``cache`` holds ``pk``/``pv`` [n_blocks, block_tokens, H, dh]
        (the pool), ``table``/``base`` [B, S] int32 (each row's
        ring-addressed block table: logical block ``g`` at ring slot
        ``g % S``, -1 = unmapped; ``base`` = ``g * bt`` of the block the
        slot holds, so a stale slot is masked), and ``floor``/``filled``
        [B] int32 (minimum valid and next write position).

        The chunk's K/V are scattered into the pool at their absolute
        positions through the table, then every query attends over the
        blocks its window can reach, under the validity rule of
        :func:`paged_attention_reference`.

        Unlike the JAX package, which returns a new pool, this updates
        ``pk``/``pv`` IN PLACE: the returned cache holds the same pool
        tensors. JAX's ``mode="drop"`` scatter has no torch counterpart,
        so the scatter has a fixed shape instead: every row of the chunk
        is written, and a row that must be dropped (past its row's chunk
        length, or in an unmapped block, as for an idle slot) goes to the
        **scratch block**, whose index the cache names under
        ``scratch`` (a Python int). Its owner guarantees that no table
        maps it (``DecodeEngine`` allocates ``kv_blocks + 1`` blocks,
        names the last, and its ``BlockPool`` hands out only the first
        ``kv_blocks``). Nothing reads the scratch block, so what the
        dropped rows leave there does not matter, and no boolean
        selection syncs the host. A cache that names no scratch block
        inside the pool is refused (a host check). The returned
        ``filled`` advances by each row's chunk length."""
        _check_streamable(lc)
        tm = lc.stream_max_t
        b, h, t, dh = q.shape
        dev = q.device
        pk, pv = cache["pk"], cache["pv"]
        table, base = cache["table"], cache["base"]
        floor, filled = cache["floor"], cache["filled"]
        nb, bt = pk.shape[0], pk.shape[1]
        scratch = cache.get("scratch")
        if (not isinstance(scratch, int) or isinstance(scratch, bool)
                or not 0 <= scratch < nb):
            raise ValueError(
                f"paged cache names scratch block {scratch!r}, not a block "
                f"of its {nb}-block pool: the fixed-shape K/V scatter "
                "needs a block that no table maps (DecodeEngine names "
                "its pool's last)")
        s_ring = table.shape[1]
        pkf = pk.view(nb * bt, h, dh)
        pvf = pv.view(nb * bt, h, dh)
        if mask is None:
            lengths = torch.full((b,), t, dtype=torch.int32, device=dev)
        else:
            lengths = (mask > 0).sum(dim=1).to(torch.int32)
        ar_t = torch.arange(t, device=dev, dtype=torch.int32)
        # -- scatter the chunk's K/V to their absolute positions ------
        pos = filled[:, None] + ar_t[None, :]                 # [B, t]
        blk = torch.gather(table, 1, ((pos // bt) % s_ring).long())
        writable = (ar_t[None, :] < lengths[:, None]) & (blk >= 0)
        widx = torch.where(writable, blk * bt + pos % bt,
                           scratch * bt + pos % bt).reshape(-1).long()
        kt = k.transpose(1, 2).reshape(b * t, h, dh)
        vt = v.transpose(1, 2).reshape(b * t, h, dh)
        pkf.index_put_((widx,), kt.to(pkf.dtype))
        pvf.index_put_((widx,), vt.to(pvf.dtype))
        # -- the blocks each row's window can reach -------------------
        ntab = min(s_ring, (tm + t - 2) // bt + 2)
        lo = torch.maximum(floor, torch.clamp(filled - tm + 1, min=0))
        lo_blk = (lo // bt).to(torch.int32)
        g = lo_blk[:, None] + torch.arange(ntab, device=dev,
                                           dtype=torch.int32)[None, :]
        ring = (g % s_ring).long()
        tb = torch.gather(table, 1, ring)
        bb = torch.gather(base, 1, ring)
        bval = (tb >= 0) & (bb == g * bt)
        bid = torch.where(bval, tb, torch.zeros_like(tb)).to(torch.int32)
        # the heads split of a t > 1 chunk leaves q strided; the kernel
        # takes contiguous operands (a no-op at t = 1)
        args = (q.contiguous(), pk, pv, bid, bval.to(torch.int32), lo_blk,
                floor.to(torch.int32), filled.to(torch.int32), lengths)
        toggle = getattr(lc, "use_flash_paged", None)
        if _should_use_flash_paged(toggle, q):
            o = paged_attention(*args, tm=tm)
        else:
            o = paged_attention_reference(*args, tm=tm)
        return o, {"pk": pk, "pv": pv, "scratch": scratch, "table": table,
                   "base": base, "floor": floor, "filled": filled + lengths}


class TransformerBlockImpl(LayerImplBase):
    @classmethod
    def init(cls, gen, conf, dtype=torch.float32, device="cpu") -> dict:
        lc = conf.layer
        d_in, d = lc.n_in, lc.n_out
        dff = lc.ffn_mult * d
        scheme, dist = conf.resolved("weight_init"), conf.resolved("dist")

        def w(shape):
            return init_weights(gen, shape, scheme, dist, dtype, device)

        def ones(n):
            return torch.ones(n, dtype=dtype, device=device)

        def zeros(n):
            return torch.zeros(n, dtype=dtype, device=device)

        p = {"ln1_g": ones(d), "ln1_b": zeros(d),
             "Wq": w((d, d)), "Wk": w((d, d)), "Wv": w((d, d)),
             "Wo": w((d, d)), "bo": zeros(d),
             "ln2_g": ones(d), "ln2_b": zeros(d),
             "W1": w((d, dff)), "b1": zeros(dff),
             "W2": w((dff, d)), "b2": zeros(d)}
        if d_in != d:
            p["Wi"] = w((d_in, d))
        return p

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        lc = conf.layer
        h, d = lc.n_heads, lc.n_out
        if d % h:
            raise ValueError(f"n_out {d} not divisible by n_heads {h}")
        dh = d // h
        tp = _tp_axis()
        h = tp_local(h, tp)
        x = cls.maybe_dropout(conf, x, train, rng)
        xt = x.transpose(1, 2)  # [N, T, C]
        if "Wi" in params:
            xt = _mm(xt, params["Wi"])
        hn = _tp_in(layer_norm(xt, params["ln1_g"], params["ln1_b"]), tp)
        q = _split_heads(_mm(hn, params["Wq"]), h, dh)
        k = _split_heads(_mm(hn, params["Wk"]), h, dh)
        v = _split_heads(_mm(hn, params["Wv"]), h, dh)
        o, state = AttentionImpl._attend_core(lc, q, k, v, state, train,
                                              mask)
        attn = _tp_out(_mm(_merge_heads(o), params["Wo"]), tp)
        xt = xt + (attn + params["bo"])
        h2 = _tp_in(layer_norm(xt, params["ln2_g"], params["ln2_b"]), tp)
        ffn = activation(lc.ffn_activation)(_mm(h2, params["W1"])
                                            + params["b1"])
        xt = xt + (_tp_out(_mm(ffn, params["W2"]), tp) + params["b2"])
        out = xt.transpose(1, 2)  # [N, D, T]
        if mask is not None:
            out = out * mask[:, None, :]
        return out, state


def guard_streamable(named_layer_beans) -> None:
    """Raise if any layer bean carries ``ring_axis``: ``rnn_time_step``
    streams on a single device, and sequence-parallel attention cannot."""
    for name, lc in named_layer_beans:
        if getattr(lc, "ring_axis", None):
            raise ValueError(
                f"rnn_time_step streams on a single device; layer "
                f"{name} is configured with ring_axis="
                f"{lc.ring_axis!r} (sequence parallelism) and cannot "
                "stream — rebuild the conf with ring_axis=None for "
                "serving")


def _dense_attention(q, k, v, causal, mask):
    """softmax(QKᵀ/√dh)·V with an optional causal mask and [N, T] key
    mask; masked scores are -1e30 in q's dtype."""
    t = q.shape[2]
    # scalars made on the device (fill kernels), never copied from the
    # host: a train step is captured into a CUDA graph
    div = torch.full((), float(q.shape[-1]), dtype=q.dtype,
                     device=q.device).sqrt()
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / div
    neg = torch.full((), -1e30, dtype=scores.dtype, device=q.device)
    if causal:
        cm = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                   device=q.device))
        scores = torch.where(cm, scores, neg)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :] > 0, scores, neg)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


#: Auto mode (``use_flash=None``) takes K1 on the card from this length
#: on, for bfloat16 and float32 alike: the smallest T of
#: ``chip_smoke.py``'s sweep (kernel fwd+bwd against dense fwd+bwd at
#: B=2, H=8, dh=128, causal; PERF.md). In bf16 K1 was the faster at
#: every T (512..4096) in every run. In f32, on the split-TF32 kernels,
#: K1 was the faster at every T of the sweep's f32 half (512 up to where
#: dense no longer fits the card) in every run, by about 2x at 512 and
#: 1024 and 2.5-3.3x from 2048, and from 16384 dense does not fit. In
#: both dtypes the crossover lies below 512 and is not measured. Shorter
#: sequences, such as the serving engine's prompt prefills, stay on the
#: dense path.
FLASH_MIN_T = 512
#: head widths K1 takes
FLASH_HEAD_DIMS = (64, 128)


def _should_use_flash(use_flash, q, mask) -> bool:
    """Full-sequence attention dispatch: K1 (:func:`flash_attention`) or
    the masked dense path (:func:`_dense_attention`). ``use_flash``
    keeps its conf JSON values; the TPU tile rules (``T % 128``,
    ``T % 512`` block health) do not carry over:

    - ``False``: dense always.
    - ``True``: K1; raises for a tensor that is not on a CUDA device, for
      a key mask, or for a head width or dtype the kernel does not take,
      as the JAX package raises off the TPU.
    - ``None`` (auto): K1 for CUDA tensors with no mask, a head width and
      dtype it takes and T >= :data:`FLASH_MIN_T`; dense otherwise."""
    if use_flash is False:
        return False
    kernel_ok = (q.device.type == "cuda" and mask is None
                 and q.shape[-1] in FLASH_HEAD_DIMS
                 and q.dtype in _DTYPE_CODES)
    if use_flash is True:
        if not kernel_ok:
            raise ValueError(
                "use_flash=True launches the CUDA flash-attention kernel "
                "and needs CUDA tensors, no mask, head dim in "
                f"{FLASH_HEAD_DIMS} and float32/bfloat16 (got "
                f"{q.device}, mask {'set' if mask is not None else 'None'},"
                f" dh {q.shape[-1]}, {q.dtype}); use None for auto or "
                "False for dense")
        return True
    if use_flash is None:
        return kernel_ok and q.shape[2] >= FLASH_MIN_T
    raise ValueError(f"use_flash={use_flash!r}: expected None, True or "
                     "False")


def flash_attention_reference(q, k, v, causal: bool):
    """Plain PyTorch version of K1: dense softmax(QKᵀ·dh^-½)·V over
    [B, H, T, dh], computed in float32 and returned in q's dtype, with
    the kernel's exact ``dh ** -0.5`` multiplier. (The JAX package's
    ``_dense_attention``, mirrored by :func:`_dense_attention`, divides
    by ``sqrt(dh)`` rounded to q's dtype — under bf16 a 1e-4 relative
    shift of every score; at float32 the two agree to rounding.)"""
    t = q.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          k.float()) * q.shape[-1] ** -0.5
    if causal:
        cm = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                   device=q.device))
        scores = torch.where(cm, scores,
                             torch.full((), -1e30, device=q.device))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


@functools.cache
def _flash_lib():
    """The flash-attention library, built at first use, with its
    functions' ctypes signatures set."""
    lib = cuda_build.load("flash_attention")
    lib.dl4j_flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.dl4j_flash_attention_fwd.restype = ctypes.c_int
    lib.dl4j_flash_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.dl4j_flash_attention_bwd.restype = ctypes.c_int
    lib.dl4j_flash_attention_split.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.dl4j_flash_attention_split.restype = ctypes.c_int
    lib.dl4j_flash_error_string.argtypes = [ctypes.c_int]
    lib.dl4j_flash_error_string.restype = ctypes.c_char_p
    return lib


#: The order in which the float32 kernels' transposed operands hold each
#: 8 rows (keys or queries): position p holds row F32_ROW_ORDER[p]. The
#: kernels read a k8 tf32 fragment out of an f32 accumulator that holds
#: columns 2t and 2t + 1 where the fragment wants k = t and t + 4.
F32_ROW_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Finite float32 ``x`` rounded to TF32 (10 mantissa bits), to
    nearest with ties away from zero: the kernels' ``cvt.rna.tf32.f32``."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def f32_padded_t(t: int) -> int:
    """The row length of the transposed planes: T rounded up to 8."""
    return -(-t // 8) * 8


def f32_operand_floats(shape, rows: bool, cols: bool) -> int:
    """Floats of :func:`f32_operands`' result for x of ``shape``
    [B, H, T, dh]: two planes of B*H*T*dh for ``rows``, two of
    B*H*dh*Tp for ``cols``."""
    b, h, t, dh = shape
    return 2 * b * h * dh * (t * rows + f32_padded_t(t) * cols)


def f32_operands_reference(x: torch.Tensor, rows: bool,
                           cols: bool) -> torch.Tensor:
    """Plain version of K1's float32 split pass on x [B, H, T, dh]:
    one flat float32 tensor holding, for ``rows``, big = tf32(x) and
    small = tf32(x - big) as planes [2][B*H][T][dh], then, for ``cols``,
    the same of x's transpose as planes [2][B*H][dh][Tp] (Tp =
    :func:`f32_padded_t`), each 8 rows of x in :data:`F32_ROW_ORDER`,
    zeros past T."""
    b, h, t, dh = x.shape
    parts = []
    if rows:
        parts.append(x.float())
    if cols:
        tp = f32_padded_t(t)
        xp = torch.zeros((b, h, tp, dh), dtype=torch.float32,
                         device=x.device)
        xp[:, :, :t] = x
        order = torch.tensor(F32_ROW_ORDER, device=x.device)
        perm = (torch.arange(0, tp, 8, device=x.device)[:, None]
                + order).reshape(-1)
        parts.append(xp[:, :, perm].transpose(2, 3))
    out = []
    for a in parts:
        big = tf32_round(a)
        out += [big.reshape(-1), tf32_round(a - big).reshape(-1)]
    return torch.cat(out)


def f32_operands(ops) -> list:
    """K1's float32 split pass (``flash_split_kernel``), one launch on
    the current stream for all of ``ops``: 1 to 4 ``(x, rows, cols)``,
    each x a contiguous CUDA tensor of one shape. Returns, for each,
    what :func:`f32_operands_reference` computes, as views into one
    buffer."""
    b, h, t, dh = ops[0][0].shape
    lib = _flash_lib()
    sizes = [f32_operand_floats(x.shape, r, c) for x, r, c in ops]
    buf = torch.empty(sum(sizes), dtype=torch.float32,
                      device=ops[0][0].device)
    outs, ptrs = [], []
    at = 0
    for (x, rows, cols), n in zip(ops, sizes):
        out = buf[at:at + n]
        at += n
        skip = 4 * f32_operand_floats(x.shape, rows, False)
        ptrs.append((x.data_ptr(), out.data_ptr() if rows else None,
                     out.data_ptr() + skip if cols else None))
        outs.append(out)
    arrays = [(ctypes.c_void_p * len(ops))(*col) for col in zip(*ptrs)]
    err = lib.dl4j_flash_attention_split(
        *arrays, len(ops), b, h, t, dh,
        torch.cuda.current_stream(buf.device).cuda_stream)
    if err != 0:
        _raise_launch(lib, "flash_attention split", err)
    return outs


def _kernel_ready(a: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernel's vector loads)."""
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


def _check_flash_args(q, k, v):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention: q/k/v {tuple(q.shape)}/{tuple(k.shape)}/"
            f"{tuple(v.shape)} must share one [B, H, T, dh] shape")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype} "
            "differ")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention: dtype {q.dtype}; the kernel "
                         "takes float32 or bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q/k/v on different devices")
    b, h, t, dh = q.shape
    if dh not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in "
                         f"{FLASH_HEAD_DIMS}")
    if min(b, h, t) < 1 or b * h > 65535:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} "
                         "outside 1 <= B*H <= 65535, T >= 1")


def _raise_launch(lib, what, err):
    raise RuntimeError(
        f"{what} kernel launch failed: CUDA error {err} "
        f"({lib.dl4j_flash_error_string(err).decode()})")


def flash_attention_fwd(q, k, v, causal: bool):
    """K1's forward kernel on contiguous CUDA q/k/v: returns (O in q's
    dtype, row log-sum-exp LSE f32 [B, H, T]). At float32 the split pass
    first prepares the kernel's operands (q and k split, v split and
    transposed). Counted in ``flash_attention.launches``."""
    b, h, t, dh = q.shape
    lib = _flash_lib()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if q.dtype == torch.float32:
        q, k, v = f32_operands([(q, True, False), (k, True, False),
                                (v, False, True)])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.dl4j_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, t, dh, int(causal), dh ** -0.5,
        _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        _raise_launch(lib, "flash_attention forward", err)
    flash_attention.launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool):
    """K1's backward on contiguous CUDA tensors: ``di = rowsum(dO ∘ O)``
    as one torch op (the stock Pallas backward also computes it outside
    its kernels), then the dK/dV and dQ kernels in one launch call.
    Returns (dQ, dK, dV) in q's dtype. At float32 the split pass first
    prepares the kernels' operands (q, k and dO split, and split and
    transposed; v split). Counted once per call in
    ``flash_attention.bwd_launches``."""
    b, h, t, dh = q.shape
    lib = _flash_lib()
    di = (do.float() * o.float()).sum(dim=-1).contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if q.dtype == torch.float32:
        q, k, v, do = f32_operands([(q, True, True), (k, True, True),
                                    (v, True, False), (do, True, True)])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.dl4j_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, h, t, dh, int(causal), dh ** -0.5,
        _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        _raise_launch(lib, "flash_attention backward", err)
    flash_attention.bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 under autograd: saves q, k, v, O and LSE; the backward
    recomputes P from them in the kernels. Deterministic (no atomics),
    so a rerun under ``torch.utils.checkpoint`` gives the same O.

    The backward is the raw kernels, whose own derivative is not
    written, so a double backward through K1 (a Hessian-vector product,
    any gradient taken with ``create_graph=True``) raises at its first,
    graph-building backward instead of treating attention's gradient as
    a constant. ``torch.autograd.function.once_differentiable`` would
    not do: it detaches the backward's outputs behind an error node that
    a second backward toward the parameters never visits, so the
    second-order term would drop silently. The plain version,
    :func:`flash_attention_reference`, is torch ops and stays twice
    differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "flash_attention: a double backward through K1 (a "
                "Hessian-vector product, or a gradient taken with "
                "create_graph=True) is not supported: its backward is the "
                "CUDA kernels, whose own derivative is not written (the JAX "
                "package's Pallas kernel refuses it too). Set "
                "use_flash=False to take second derivatives through dense "
                "attention")
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse,
                                         _kernel_ready(do), ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool):
    """Flash attention (K1): the CUDA kernels of
    ``csrc/flash_attention.cu`` for CUDA tensors, differentiable through
    their backward; :func:`flash_attention_reference` for CPU tensors.

    q/k/v: one [B, H, T, dh] shape, one dtype (float32 or bfloat16), dh
    in {64, 128}, any T >= 1; anything else raises (no quiet drop to the
    plain version). Output in q's dtype. Forward launches count in
    ``flash_attention.launches``, backward calls in
    ``flash_attention.bwd_launches``."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    cuda_build.refuse_tracing("K1 flash_attention (csrc/flash_attention.cu)",
                              q)
    _check_flash_args(q, k, v)
    return _FlashAttention.apply(q, k, v, bool(causal))


flash_attention.launches = 0
flash_attention.bwd_launches = 0


def _should_use_flash_paged(toggle, q) -> bool:
    """Dispatch rule for the paged decode attention: the CUDA kernel
    (through :func:`paged_attention`) or the plain gather program
    (:func:`paged_attention_reference`). The four values the conf JSON
    carries keep their names; the TPU tile rule (``bt % 8``,
    ``dh % 128``) does not carry over:

    - ``None`` (auto): :func:`paged_attention`, which launches the
      kernel for a CUDA tensor and takes the plain version for a CPU
      tensor. A shape the kernel does not take raises; it never drops
      quietly to the gather.
    - ``True``: the kernel; raises for a tensor that is not on a CUDA
      device, and for a shape the kernel does not take.
    - ``False``: the plain gather program always.
    - ``"interpret"``: there is no kernel interpreter on the card; this
      means the plain gather program too.

    Both paths zero V lanes outside ``[floor, filled + written)`` at the
    value level (a recycled block's NaN survives a zero softmax
    weight)."""
    if toggle is False or toggle == "interpret":
        return False
    if toggle is None:
        return True
    if toggle is True:
        if q.device.type != "cuda":
            raise ValueError(
                "use_flash_paged=True launches the CUDA paged-attention "
                f"kernel and needs CUDA tensors (got {q.device}); use "
                "None for auto or False for the plain gather program")
        return True
    raise ValueError(
        f"use_flash_paged={toggle!r}: expected None, True, False or "
        "'interpret'")


def paged_attention_reference(q, pk, pv, bid, bval, lo_blk, floor,
                              filled, lengths, *, tm: int):
    """Plain PyTorch version of the paged-attention kernel: the JAX
    package's gather-by-block-table program (``_paged_attend``'s XLA
    path) on the kernel's operands.

    Shapes: q [B, H, t, dh]; pk/pv [nb, bt, H, dh]; bid/bval [B, ntab]
    int32 (pool block per logical block ``lo_blk + j``, 0 where
    unmapped; validity); lo_blk/floor/filled/lengths [B] int32. Keys
    count if mapped, causal, inside the last-``tm`` window and at or
    above ``floor``; V lanes outside ``[floor, filled + lengths)`` are
    zeroed before the weighted sum. Computes in the promoted dtype of q
    and the pool and returns q's dtype, with the kernel's scale (a
    ``dh ** -0.5`` multiplier), so that the two differ only in summation
    order. (The JAX gather program divides by ``sqrt(dh)`` rounded to
    q's dtype — under bf16 a 1e-4 shift of every score — and returns
    the promoted dtype; at float32 the two agree to rounding.)"""
    b, h, t, dh = q.shape
    nb, bt = pk.shape[0], pk.shape[1]
    ntab = bid.shape[1]
    dev = q.device
    ct = torch.promote_types(q.dtype, pk.dtype)
    pkf = pk.reshape(nb * bt, h, dh)
    pvf = pv.reshape(nb * bt, h, dh)
    off = torch.arange(bt, device=dev)
    live = bval > 0
    gidx = (bid.long()[:, :, None] * bt + off).reshape(b, ntab * bt)
    g = lo_blk.long()[:, None] + torch.arange(ntab, device=dev)[None, :]
    kpos = (g[:, :, None] * bt + off).reshape(b, ntab * bt)
    kval = live.repeat_interleave(bt, dim=1)                # [B, K]
    ek = pkf[gidx].transpose(1, 2).to(ct)                    # [B, H, K, dh]
    ev = pvf[gidx].transpose(1, 2).to(ct)
    filled, floor = filled.long(), floor.long()
    vlive = (kval & (kpos < (filled + lengths.long())[:, None])
             & (kpos >= floor[:, None]))
    ev = torch.where(vlive[:, None, :, None], ev, torch.zeros_like(ev))
    qpos = filled[:, None] + torch.arange(t, device=dev)[None, :]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), ek) * dh ** -0.5
    ok = (kval[:, None, :]
          & (kpos[:, None, :] <= qpos[:, :, None])
          & (kpos[:, None, :] > qpos[:, :, None] - tm)
          & (kpos[:, None, :] >= floor[:, None, None]))
    # made on the device (a fill kernel): the paged decode round that
    # calls this is captured into a CUDA graph
    neg = torch.full((), -1e30, dtype=q.dtype, device=dev).to(ct)
    scores = torch.where(ok[:, None], scores, neg)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, ev).to(q.dtype)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _paged_lib():
    """The paged-attention library, built at first use, with its
    functions' ctypes signatures set."""
    lib = cuda_build.load("paged_attention")
    fn = lib.dl4j_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.dl4j_paged_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.dl4j_paged_attention_smem_bytes.restype = ctypes.c_size_t
    lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
    return lib


#: first-pass thread blocks K2 aims for on each of the card's SMs
#: (``chip_smoke.py`` times 1, 2 and 4 at B=8 and B=1 on every run; 2
#: read fastest at both on an H100: PERF.md, K2)
PAGED_BLOCKS_PER_SM = 2
#: queries one first-pass block takes when t > 1 (``kQueryTile`` in
#: ``csrc/paged_attention.cu``)
PAGED_QUERY_TILE = 4


@functools.cache
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, read once per device."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def paged_splits(b: int, h: int, t: int, ntab: int, sms: int,
                 per_sm: int = PAGED_BLOCKS_PER_SM) -> int:
    """K2's split count S: each (row, head, query tile) walks its live
    table entries in S equal shares, one thread block each. The fewest
    splits that give ``per_sm`` blocks for each of the card's ``sms``
    SMs, never more than table entries. A function of the shapes and the
    card alone, so the same inputs on the same card always take the same
    plan (and give the same bits)."""
    tiles = b * h * (1 if t == 1 else -(-t // PAGED_QUERY_TILE))
    return max(1, min(ntab, -(-(per_sm * sms) // tiles)))


def _check_kernel_args(q, pk, pv, bid, bval, lo_blk, floor, filled,
                       lengths):
    named = dict(q=q, pk=pk, pv=pv, bid=bid, bval=bval, lo_blk=lo_blk,
                 floor=floor, filled=filled, lengths=lengths)
    for name, a in named.items():
        if a.device != q.device:
            raise ValueError(
                f"paged_attention: {name} is on {a.device}, q on {q.device}")
        if not a.is_contiguous():
            raise ValueError(f"paged_attention: {name} is not contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"paged_attention: q dtype {q.dtype}; the kernel takes "
            "float32 or bfloat16")
    if pk.dtype not in _DTYPE_CODES or pv.dtype != pk.dtype:
        raise ValueError(
            f"paged_attention: pool dtypes {pk.dtype}/{pv.dtype}; the "
            "kernel takes float32 or bfloat16, the same for pk and pv")
    if q.ndim != 4 or pk.ndim != 4 or pv.shape != pk.shape:
        raise ValueError(
            f"paged_attention: q {tuple(q.shape)} must be [B, H, t, dh], "
            f"pk/pv {tuple(pk.shape)}/{tuple(pv.shape)} [nb, bt, H, dh]")
    b, h, t, dh = q.shape
    nb, bt = pk.shape[0], pk.shape[1]
    if pk.shape[2:] != (h, dh):
        raise ValueError(
            f"paged_attention: pool heads/width {tuple(pk.shape[2:])} "
            f"differ from q's {(h, dh)}")
    if dh not in (64, 128):
        raise ValueError(f"paged_attention: head dim {dh} not in (64, 128)")
    if bt < 1 or bt > 64 or bt & (bt - 1):
        raise ValueError(
            f"paged_attention: block_tokens {bt} must be a power of two "
            "<= 64")
    if t < 1 or b < 1 or nb < 1:
        raise ValueError(f"paged_attention: empty operand q {tuple(q.shape)}")
    for name in ("bid", "bval", "lo_blk", "floor", "filled", "lengths"):
        if named[name].dtype != torch.int32:
            raise ValueError(f"paged_attention: {name} must be int32")
    if bid.ndim != 2 or bid.shape[0] != b or bval.shape != bid.shape:
        raise ValueError(
            f"paged_attention: bid/bval {tuple(bid.shape)}/"
            f"{tuple(bval.shape)} must be [B={b}, ntab]")
    for name in ("lo_blk", "floor", "filled", "lengths"):
        if tuple(named[name].shape) != (b,):
            raise ValueError(f"paged_attention: {name} must be [B={b}]")
    for name in ("q", "pk", "pv"):
        if named[name].data_ptr() % 16:
            raise ValueError(
                f"paged_attention: {name} is not 16-byte aligned (the "
                "kernel's vector and cp.async loads)")


def _paged_attention_launch(q, pk, pv, bid, bval, lo_blk, floor, filled,
                            lengths, *, tm: int, splits: int):
    """Both passes of K2 on checked CUDA operands with ``splits``
    splits. Returns the output and the first pass's partials (m, l
    [B, H, S, t] and the unnormalised acc [B, H, S, t, dh], views of the
    f32 workspace). Counts nothing."""
    b, h, t, dh = q.shape
    bt = pk.shape[1]
    ntab = bid.shape[1]
    kv = _DTYPE_CODES[pk.dtype]
    lib = _paged_lib()
    smem = lib.dl4j_paged_attention_smem_bytes(t, dh, bt, kv)
    if smem > cuda_build.SMEM_PER_BLOCK:
        raise ValueError(
            f"paged_attention: dh={dh}, block_tokens={bt}, {pk.dtype} pool "
            f"needs {smem} bytes of shared memory (limit "
            f"{cuda_build.SMEM_PER_BLOCK})")
    # the f32 workspace: acc [B, H, S, t, dh], then m and l [B, H, S, t]
    rows = b * h * splits * t
    ws = torch.empty(rows * (dh + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.dl4j_paged_attention(
        q.data_ptr(), pk.data_ptr(), pv.data_ptr(), bid.data_ptr(),
        bval.data_ptr(), lo_blk.data_ptr(), floor.data_ptr(),
        filled.data_ptr(), lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
        b, h, t, dh, bt, ntab, int(tm), splits, dh ** -0.5,
        _DTYPE_CODES[q.dtype], kv, stream)
    if err != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: CUDA error {err} "
            f"({lib.dl4j_cuda_error_string(err).decode()})")
    acc = ws[:rows * dh].view(b, h, splits, t, dh)
    m = ws[rows * dh:rows * (dh + 1)].view(b, h, splits, t)
    l_ = ws[rows * (dh + 1):].view(b, h, splits, t)
    return out, (m, l_, acc)


def paged_attention(q, pk, pv, bid, bval, lo_blk, floor, filled, lengths,
                    *, tm: int):
    """Paged attention: the CUDA kernels ``csrc/paged_attention.cu`` for
    CUDA tensors, :func:`paged_attention_reference` for CPU tensors.

    Operands as :func:`paged_attention_reference`. The kernel takes q in
    float32 or bfloat16, pk/pv in float32 or bfloat16, dh in {64, 128},
    block_tokens a power of two <= 64 and any t >= 1; q, pk and pv
    16-byte aligned; anything else raises. Mapped entries of ``bid``
    must index the pool (the caller's tables guarantee it; the kernel
    does not check). Output: [B, H, t, dh] in q's dtype, allocated here
    with the split-K workspace (:func:`paged_splits` splits); the two
    launches go on the current stream, and the call counts once in
    ``paged_attention.launches`` and, where t > 1 (a chunk or a verify
    pass), once in ``paged_attention.chunk_launches``."""
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, pk, pv, bid, bval, lo_blk, floor, filled, lengths, tm=tm)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    _check_kernel_args(q, pk, pv, bid, bval, lo_blk, floor, filled,
                       lengths)
    b, h, t, _ = q.shape
    out, _ = _paged_attention_launch(
        q, pk, pv, bid, bval, lo_blk, floor, filled, lengths, tm=tm,
        splits=paged_splits(b, h, t, bid.shape[1], sm_count(q.device.index)))
    paged_attention.launches += 1
    if t > 1:
        paged_attention.chunk_launches += 1
    return out


paged_attention.launches = 0
paged_attention.chunk_launches = 0
