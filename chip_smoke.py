"""On-card smoke run of the PyTorch/CUDA port (``deeplearning4j_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of
JAX or of the JAX package. Phases, each fatal on failure:

1. device  — CUDA present; the card's name and power limit; TF32 off.
2. build   — every kernel of the serving path built from ``csrc/``.
3. kernels — each kernel held against its plain PyTorch version on the
   card at the serving path's shapes, with its time, the plain
   version's, a library call's and the least time the card could take.
4. serving — the width-1024 transformer flagship served by the paged-KV
   ``DecodeEngine`` (random weights from a seed): every request
   finishes, the kernels' launch counters moved on this run, and the
   greedy ids agree with an engine on the plain gather program.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when any phase fails or no card is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores (the kernel's arithmetic).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# the serving path's shapes: bench.py's serving configuration
VOCAB, WIDTH, N_LAYERS, N_HEADS, WINDOW = 64, 1024, 8, 8, 2048
BLOCK_TOKENS, N_SLOTS, DECODE_CHUNK = 16, 8, 32
DEVICE = "cuda"
N_REQUESTS, PROMPT_LEN, N_GEN = 12, 128, 128

# max |kernel - plain| allowed: f32 queries differ only by summation
# order over <= 2048 keys; bf16 queries are rounded to bf16 on output
# and compared with the plain version run on the f32 upcast
TOL_F32 = 1e-5
TOL_BF16 = 2e-2
# greedy-id agreement between the kernel and the plain engine at bf16
# (argmax-level: bf16 near-ties may flip, as in the JAX serving suite)
ID_AGREEMENT = 0.9


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    card = gpu_name_and_power()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; TF32 off for matmul and cuDNN")
    return card


def build_phase() -> None:
    from deeplearning4j_tpu_torch import cuda_build

    t0 = time.perf_counter()
    secs = cuda_build.build_all(["paged_attention"])
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.2f} s "
        "wall, nvcc sm_90a)")


def cuda_time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _paged_case(rng, t, fill, q_dtype, dev):
    """Kernel operands at the serving path's shapes: B = N_SLOTS rows,
    each with its own block table into one f32 pool. ``fill`` is
    "half" (1024 tokens written) or "full" (past the 2048 window, so
    the head slid out). Row 0 is idle (nothing mapped: no valid key),
    row 1 has a raised floor, row 2's tail block holds NaN past the
    written span, and a free pool block is NaN-poisoned."""
    b, h, dh, bt, tm = N_SLOTS, N_HEADS, WIDTH // N_HEADS, BLOCK_TOKENS, \
        WINDOW
    ntab = (tm + t - 2) // bt + 2
    per_row = ntab + 2
    nb = b * per_row + 8
    pk = torch.randn(nb, bt, h, dh, generator=rng, device=dev)
    pv = torch.randn(nb, bt, h, dh, generator=rng, device=dev)
    perm = torch.randperm(nb, generator=rng, device=dev).tolist()
    free = perm[-1]
    pk[free] = float("nan")
    pv[free] = float("nan")
    bid = np.zeros((b, ntab), np.int32)
    bval = np.zeros((b, ntab), np.int32)
    lo_blk = np.zeros(b, np.int32)
    floor = np.zeros(b, np.int32)
    filled = np.zeros(b, np.int32)
    lengths = np.full(b, t, np.int32)
    nan_blocks = []
    for r in range(b):
        length = (tm // 2 if fill == "half" else tm + 2 * bt + 5) + 3 * r
        fl = max(0, length - tm)
        if r == 1:
            fl = length - 300
        filled[r] = length
        floor[r] = fl
        if r == 0:
            filled[r] = 0
            continue
        lo = max(fl, max(length - tm + 1, 0))
        lo_blk[r] = lo // bt
        for j in range(ntab):
            g = lo_blk[r] + j
            if g * bt > length + t - 1:
                break
            bid[r, j] = perm[r * per_row + j]
            bval[r, j] = 1
            if r == 2 and g == (length + t - 1) // bt:
                nan_blocks.append((bid[r, j], (length + t) % bt))
    for blk, first in nan_blocks:
        if first:
            pk[blk, first:] = float("nan")
            pv[blk, first:] = float("nan")
    q = torch.randn(b, h, t, dh, generator=rng, device=dev).to(q_dtype)

    def i32(a):
        return torch.as_tensor(a, device=dev)

    ops = (q, pk, pv, i32(bid), i32(bval), i32(lo_blk), i32(floor),
           i32(filled), i32(lengths))
    return ops, tm


def _paged_bound(ops, tm):
    """Least time for these inputs: every operand byte the function
    needs read once (the K/V of the blocks some query may attend), the
    output written once; f32 flops of QKᵀ and P·V over those keys."""
    q, pk, pv, bid, bval, lo_blk, floor, filled, lengths = ops
    b, h, t, dh = q.shape
    bt = pk.shape[1]
    g = lo_blk.long()[:, None] + torch.arange(bid.shape[1],
                                              device=q.device)[None, :]
    reach = ((bval > 0) & ((g + 1) * bt > floor.long()[:, None])
             & (g * bt <= (filled.long() + t - 1)[:, None]))
    n_blocks = int(reach.sum())
    kv_bytes = n_blocks * bt * h * dh * 2 * pk.element_size()
    io_bytes = 2 * q.numel() * q.element_size() + sum(
        a.numel() * a.element_size() for a in ops[3:])
    flops = 4.0 * n_blocks * bt * h * t * dh
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sdpa_yardstick(ops, tm):
    """``F.scaled_dot_product_attention`` over the gathered window with
    a boolean mask: the same function for rows with a valid key, timed
    as a yardstick only (the port never calls it)."""
    q, pk, pv, bid, bval, lo_blk, floor, filled, lengths = ops
    b, h, t, dh = q.shape
    nb, bt = pk.shape[0], pk.shape[1]
    ntab = bid.shape[1]
    off = torch.arange(bt, device=q.device)
    gidx = (bid.long()[:, :, None] * bt + off).reshape(b, ntab * bt)
    g = lo_blk.long()[:, None] + torch.arange(ntab, device=q.device)
    kpos = (g[:, :, None] * bt + off).reshape(b, ntab * bt)
    kval = (bval > 0).repeat_interleave(bt, dim=1)
    vlive = (kval & (kpos < (filled + lengths).long()[:, None])
             & (kpos >= floor.long()[:, None]))

    def gather(pool):
        # lanes outside the written span may hold NaN: zero them (every
        # key a query may attend is inside it, so the function is kept)
        x = pool.reshape(nb * bt, h, dh)[gidx].transpose(1, 2)
        return torch.where(vlive[:, None, :, None], x, 0.0).contiguous()

    ek, ev = gather(pk), gather(pv)
    qpos = filled.long()[:, None] + torch.arange(t, device=q.device)
    ok = (kval[:, None, :] & (kpos[:, None, :] <= qpos[:, :, None])
          & (kpos[:, None, :] > qpos[:, :, None] - tm)
          & (kpos[:, None, :] >= floor.long()[:, None, None]))
    qf = q.float()
    mask = ok[:, None]
    fn = torch.nn.functional.scaled_dot_product_attention
    return lambda: fn(qf, ek, ev, attn_mask=mask)


def kernel_phase() -> list:
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        paged_attention,
        paged_attention_reference,
    )

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev)
    rng.manual_seed(7)
    before = paged_attention.launches
    main = None
    for fill in ("half", "full"):
        for t in (1, 4):
            for q_dtype in (torch.bfloat16, torch.float32):
                ops, tm = _paged_case(rng, t, fill, q_dtype, dev)
                got = paged_attention(*ops, tm=tm)
                torch.cuda.synchronize()
                ref_ops = (ops[0].float(),) + ops[1:]
                want = paged_attention_reference(*ref_ops, tm=tm)
                err = float((got.float() - want).abs().max())
                tol = TOL_F32 if q_dtype == torch.float32 else TOL_BF16
                finite = bool(torch.isfinite(got).all())
                zero_row = float(got[0].float().abs().max())
                name = (f"paged_attention {fill} window, t={t}, "
                        f"q={str(q_dtype).split('.')[-1]}, pool=float32")
                if not finite or err > tol or zero_row != 0.0:
                    raise SystemExit(
                        f"chip_smoke: {name}: max_abs_err {err} (tol "
                        f"{tol}), finite {finite}, idle-row max "
                        f"{zero_row} (must be 0)")
                ms = cuda_time_ms(lambda: paged_attention(*ops, tm=tm))
                plain_ms = cuda_time_ms(
                    lambda: paged_attention_reference(*ops, tm=tm))
                lib_ms = cuda_time_ms(_sdpa_yardstick(ops, tm))
                bound_ms, bound_by = _paged_bound(ops, tm)
                log(f"{name}: max_abs_err {err:.3e} (tol {tol}); kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                    f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
                    f"({bound_by}, {bound_ms / ms:.1%} of it)")
                if fill == "full" and t == 1 and q_dtype == torch.bfloat16:
                    main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                library_ms=lib_ms)
    # comparison launches do not count toward the main path's run
    paged_attention.launches = before
    return [dict(
        name="paged_attention", route="cuda",
        source="deeplearning4j_tpu_torch/csrc/paged_attention.cu",
        replaces="deeplearning4j_tpu/nn/layers/attention.py:807",
        **main)]


def serving_phase(card: str) -> int:
    """The flagship served by the paged-KV engine on the card; returns
    the paged-attention kernel's launches on the main run."""
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm_flagship
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import DecodeEngine, Request

    conf = transformer_lm_flagship(vocab=VOCAB, width=WIDTH,
                                   n_layers=N_LAYERS, n_heads=N_HEADS,
                                   seed=11)
    for c in conf.confs:
        c.compute_dtype = "bfloat16"
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    # the forward is right on a small input: finite softmax rows
    x = torch.zeros(2, VOCAB, 16, device=DEVICE)
    x[:, 3, :] = 1.0
    probs = net.output(x)
    sums = probs.sum(dim=1)
    if (probs.shape != (2, VOCAB, 16) or not torch.isfinite(probs).all()
            or float((sums - 1).abs().max()) > 1e-4):
        raise SystemExit(f"chip_smoke: flagship output() is wrong: shape "
                         f"{tuple(probs.shape)}, row sums {sums}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, PROMPT_LEN).tolist()
               for _ in range(N_REQUESTS)]
    geometry = dict(paged_kv=True, block_tokens=BLOCK_TOKENS,
                    n_slots=N_SLOTS, decode_chunk=DECODE_CHUNK)

    def serve(engine):
        ids = [engine.submit(Request(list(p), N_GEN)) for p in prompts]
        t0 = time.perf_counter()
        res = engine.run()
        torch.cuda.synchronize()
        return [res[i] for i in ids], time.perf_counter() - t0

    eng = DecodeEngine(net, **geometry)
    eng.submit(Request(prompts[0][:16], DECODE_CHUNK + 1))   # warm-up
    eng.run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps0 = eng.stats["decode_steps"]
    paged_attention.launches = 0
    results, wall = serve(eng)
    launches = paged_attention.launches
    steps = eng.stats["decode_steps"] - steps0
    peak = torch.cuda.max_memory_allocated()
    bad = [(r.id, r.finish_reason, len(r.tokens)) for r in results
           if r.finish_reason != "length" or len(r.tokens) != N_GEN]
    if bad:
        raise SystemExit(f"chip_smoke: requests did not finish: {bad}")
    if launches != N_LAYERS * steps or launches == 0:
        raise SystemExit(
            f"chip_smoke: paged_attention launched {launches} times for "
            f"{steps} decode steps x {N_LAYERS} layers")
    ttft = float(np.median([r.ttft_s for r in results]))
    log(f"serving (kernel): {N_REQUESTS} requests x {N_GEN} tokens, "
        f"{N_REQUESTS * N_GEN / wall:.1f} tokens/s aggregate, median TTFT "
        f"{ttft * 1e3:.1f} ms, peak memory {peak / 2**30:.3f} GiB, "
        f"{steps} decode steps, {launches} kernel launches [{card}]")

    plain = DecodeEngine(net, use_flash_paged=False, **geometry)
    plain_results, plain_wall = serve(plain)
    same = [np.mean(np.asarray(a.tokens) == np.asarray(b.tokens))
            for a, b in zip(results, plain_results)]
    agreement = float(np.mean(same))
    log(f"serving (plain gather): {N_REQUESTS * N_GEN / plain_wall:.1f} "
        f"tokens/s aggregate [{card}]; greedy id agreement with the "
        f"kernel engine {agreement:.4f} (min per request "
        f"{min(same):.4f}, bar {ID_AGREEMENT}; per request "
        f"{[round(float(a), 4) for a in same]})")
    if agreement < ID_AGREEMENT:
        raise SystemExit(
            f"chip_smoke: kernel vs plain id agreement {agreement} < "
            f"{ID_AGREEMENT}")
    return launches


def main() -> int:
    card = device_phase()
    build_phase()
    kernels = kernel_phase()
    launches = serving_phase(card)
    for k in kernels:
        k["launches"] = launches
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
