"""On-card smoke run of the PyTorch/CUDA port (``deeplearning4j_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of
JAX or of the JAX package. Phases, each fatal on failure:

1. device  — CUDA present; the card's name and power limit; TF32 off.
2. build   — every kernel built from ``csrc/`` (one nvcc per source,
   started together).
3. kernels — each kernel held against its plain PyTorch version on the
   card at its path's shapes, with its time, the plain version's, a
   library call's and the least time the card could take: K2 (paged
   attention: the serving shape at half and full window, t = 1 and 4,
   q bf16 and f32; dh=64, 1- to 64-token blocks, a bf16 pool, t=33,
   B=1, rows that leave splits empty; a rerun must give the same bits;
   the first pass's partials folded in torch must agree and a fold
   that drops a split must fail its limits; its device time from a
   CUDA graph of back-to-back calls, also at 1, 2 and 4 first-pass
   blocks per SM), K1 (flash
   attention, forward and dQ/dK/dV, at training
   A's T=2048, at training B's T=32768 against a plain version chunked
   over query rows, and at edge cases down to T=1; planted faults must
   fail its limits; a rerun must give the same bits), plus the bf16 and
   f32 sweeps behind K1's auto-dispatch threshold ``FLASH_MIN_T`` (one
   for both), and K3
   (``conv_taps``, LeNet's conv1: its tensor-core kernel for bf16 x with
   bf16 W and the CUDA-core kernel for the rest, each case on the
   route it must take; at B=2048 in bf16 and f32, ragged and padded
   batches, 1x1, 3x3 and 7x7 kernels, 529 output pixels, an inf and a
   NaN whose non-finite outputs must sit where the plain version's do;
   the main case rerun bit for bit; a zeroed tap must fail its limits).
4. training A — the width-1024 flagship (random weights from a seed) on
   K1 and on dense attention from the same params, 4 ``fit`` steps each
   at B=2, T=2048 on the Markov task, f32 and bf16: loss trajectories
   agree (and at f32 the params), K1 launched 8 times per step forward
   and backward.
5. training B — bench.py's 32k long-context row (bf16, B=2, T=32768):
   1 warm-up and 2 timed ``fit`` steps through K1 in auto mode; tokens/s,
   s/step, peak memory, finite losses, K1's launches and its share of
   the step.
6. serving — the flagship served by the paged-KV ``DecodeEngine``: every
   request finishes, K2 launched once per layer per decode step, and one
   decode step's forward runs with no host sync. Then the serving gate
   against an engine on the plain gather program: at f32 the greedy ids
   are identical on every request, a right program (the plain one with
   reordered score sums) passes that check and planted faults in the
   plain engine's attention fail it. At bf16 the free-running id
   agreement at prompt seed 0 is printed as a report, with each
   divergence's f32 log-probability gap; it has no bar.
7. LeNet — bench.py's ``mnist_lenet5_train_throughput`` row:
   ``lenet5(lr=0.002)``, bf16 compute, B=2048 synthetic MNIST, 7
   ``fit_scan`` windows of 64 steps, then 2 timed windows (examples/s,
   s/step, peak memory, K3's launches == steps, every one of them and
   of ``evaluate``'s on the tensor-core kernel, and its share of the
   step), falling losses, and ``evaluate`` on 4096 test images at
   bench.py's 0.97 accuracy gate.
8. LeNet card vs CPU — one set of port params, 4 f32 ``fit`` steps at
   B=256 on the card (K3 on the CUDA-core kernel, the f32 route, and
   cuDNN's conv2) and on the CPU (the plain versions): loss trajectories
   and params agree.

Each path's kernel launch counts are set to 0 just before it runs and
read just after (comparison launches do not count).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when any phase fails or no card is present.
"""

from __future__ import annotations

import contextlib
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

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s,
# float32 FLOP/s outside the tensor cores, bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

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
    secs = cuda_build.build_all(["paged_attention", "flash_attention",
                                 "conv_taps"])
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


def graph_time_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in one CUDA
    graph, replayed ``iters`` times between CUDA events, so no host
    launch gap sits between the kernels (and the capture itself shows
    that ``fn`` neither syncs nor allocates outside the graph's pool)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def _paged_case(rng, t, fill, q_dtype, dev, *, b=N_SLOTS,
                dh=WIDTH // N_HEADS, bt=BLOCK_TOKENS,
                kv_dtype=torch.float32, idle=True):
    """Kernel operands at the serving path's shapes: ``b`` rows (B =
    N_SLOTS by default), each with its own block table into one pool of
    ``kv_dtype`` (f32, the master dtype, by default). ``fill`` is "half"
    (1024 tokens written), "full" (past the 2048 window, so the head
    slid out) or "short" (20 + 37 r tokens in row r: live ranges shorter
    than the split count, so some splits are empty). With ``idle`` row 0
    is idle (nothing mapped: no valid key); row 1 has a raised floor
    inside a block, row 2's tail block holds NaN past the written span,
    and a free pool block is NaN-poisoned."""
    h, tm = N_HEADS, WINDOW
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
        length = dict(half=tm // 2 + 3 * r, full=tm + 2 * bt + 5 + 3 * r,
                      short=20 + 37 * r)[fill]
        fl = max(0, length - tm)
        if r == 1:
            fl = length - (50 if fill == "short" else 300)
        filled[r] = length
        floor[r] = fl
        if r == 0 and idle:
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

    ops = (q, pk.to(kv_dtype), pv.to(kv_dtype), i32(bid), i32(bval),
           i32(lo_blk), i32(floor), i32(filled), i32(lengths))
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


def _paged_name(ops, fill, t):
    q, pk = ops[0], ops[1]
    return (f"paged_attention {fill} window, B={q.shape[0]}, t={t}, "
            f"dh={q.shape[3]}, bt={pk.shape[1]}, "
            f"q={str(q.dtype).split('.')[-1]}, "
            f"pool={str(pk.dtype).split('.')[-1]}")


def _paged_hold(ops, tm, fill, t, idle=True):
    """K2 against its plain version on the f32 upcast of q: max |err|
    within TOL_F32 (f32 q) or TOL_BF16 (bf16 q), finite, and the idle
    row (row 0, where ``idle``) exactly 0. Fatal otherwise. Returns the
    kernel's output, the plain version's and the error."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        paged_attention,
        paged_attention_reference,
    )

    got = paged_attention(*ops, tm=tm)
    torch.cuda.synchronize()
    want = paged_attention_reference(ops[0].float(), *ops[1:], tm=tm)
    err = float((got.float() - want).abs().max())
    tol = TOL_F32 if ops[0].dtype == torch.float32 else TOL_BF16
    finite = bool(torch.isfinite(got).all())
    zero_row = float(got[0].float().abs().max()) if idle else 0.0
    name = _paged_name(ops, fill, t)
    if not finite or err > tol or zero_row != 0.0:
        raise SystemExit(
            f"chip_smoke: {name}: max_abs_err {err} (tol {tol}), finite "
            f"{finite}, idle-row max {zero_row} (must be 0)")
    log(f"{name}: max_abs_err {err:.3e} (tol {tol})")
    return got, want, err


def _paged_times(ops, tm) -> dict:
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        paged_attention,
        paged_attention_reference,
    )

    ms = cuda_time_ms(lambda: paged_attention(*ops, tm=tm))
    plain_ms = cuda_time_ms(lambda: paged_attention_reference(*ops, tm=tm))
    lib_ms = cuda_time_ms(_sdpa_yardstick(ops, tm))
    bound_ms, bound_by = _paged_bound(ops, tm)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def _paged_log_times(name, times) -> None:
    log(f"{name} times: kernel {times['ms']:.4f} ms, plain "
        f"{times['plain_ms']:.4f} ms, sdpa {times['library_ms']:.4f} ms, "
        f"bound {times['bound_ms']:.4f} ms ({times['bound_by']}, "
        f"{times['bound_ms'] / times['ms']:.1%} of it)")


def paged_device_times(ops, tm, name, times) -> None:
    """K2's and SDPA's device times (CUDA-graph replays: no host gaps
    between launches) beside the bound."""
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention

    dev_ms = graph_time_ms(lambda: paged_attention(*ops, tm=tm))
    lib_dev_ms = graph_time_ms(_sdpa_yardstick(ops, tm))
    log(f"{name} device times (CUDA graph of 20 calls): kernel "
        f"{dev_ms:.4f} ms ({times['bound_ms'] / dev_ms:.1%} of the "
        f"{times['bound_ms']:.4f} ms bound), sdpa {lib_dev_ms:.4f} ms")
    paged_split_sweep(ops, tm, name, times["bound_ms"])


def paged_split_sweep(ops, tm, name, bound_ms) -> None:
    """K2's device time with the split counts that 1, 2 and 4 first-pass
    blocks per SM give (``PAGED_BLOCKS_PER_SM`` picks one). A reading,
    not a gate."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        PAGED_BLOCKS_PER_SM,
        _paged_attention_launch,
        paged_splits,
        sm_count,
    )

    b, h, t, _ = ops[0].shape
    sms = sm_count(ops[0].device.index)
    readings = []
    for per_sm in (1, 2, 4):
        splits = paged_splits(b, h, t, ops[3].shape[1], sms, per_sm)
        ms = graph_time_ms(lambda: _paged_attention_launch(
            *ops, tm=tm, splits=splits))
        readings.append(f"{per_sm} per SM ({splits} splits) {ms:.4f} ms "
                        f"({bound_ms / ms:.1%} of bound)")
    log(f"{name} split sweep on {sms} SMs (device times; "
        f"PAGED_BLOCKS_PER_SM = {PAGED_BLOCKS_PER_SM}): "
        + ", ".join(readings))


def paged_rerun_check(ops, tm, name) -> None:
    """K2 twice on the same inputs: the same bits (a split plan that is
    arithmetic on the inputs, fixed merge and combine orders, no
    atomics). Fatal on any difference."""
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention

    a = paged_attention(*ops, tm=tm)
    b = paged_attention(*ops, tm=tm)
    torch.cuda.synchronize()
    same = torch.equal(a, b)
    log(f"{name}: rerun bit for bit {same}")
    if not same:
        raise SystemExit(f"chip_smoke: {name}: a rerun of K2 differs")


def _combine(m, l_, acc):
    """The second pass's fold of split partials, in torch (f32)."""
    top = m.max(dim=2, keepdim=True).values
    f = torch.exp(m - top)
    den = (f * l_).sum(dim=2)
    return (f[..., None] * acc).sum(dim=2) / torch.where(
        den == 0, 1.0, den)[..., None]


def paged_fault_check(ops, tm, want, name) -> None:
    """The first pass's partials, folded in torch over every split,
    agree with the plain version within TOL_F32 (they are f32); folded
    without the last split (a planted fault: a combine that drops a
    split) they must fail the bf16 limit. Fatal otherwise."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        _paged_attention_launch,
        paged_splits,
        sm_count,
    )

    b, h, t, _ = ops[0].shape
    splits = paged_splits(b, h, t, ops[3].shape[1],
                          sm_count(ops[0].device.index))
    _, (m, l_, acc) = _paged_attention_launch(*ops, tm=tm, splits=splits)
    torch.cuda.synchronize()
    whole = float((_combine(m, l_, acc) - want).abs().max())
    fault = float((_combine(m[:, :, :-1], l_[:, :, :-1], acc[:, :, :-1])
                   - want).abs().max())
    log(f"{name}: {splits} splits; partials folded in torch "
        f"max_abs_err {whole:.3e} (tol {TOL_F32}); planted fault (last "
        f"split dropped from the combine) {fault:.3e}: caught "
        f"{fault > TOL_BF16} (tol {TOL_BF16})")
    if not whole <= TOL_F32 or not fault > TOL_BF16:
        raise SystemExit(f"chip_smoke: {name}: partials {whole} (tol "
                         f"{TOL_F32}), dropped split {fault} must exceed "
                         f"{TOL_BF16}")


def kernel_phase() -> list:
    """K2 held against its plain version: the serving shape (B=8, H=8,
    dh=128, bt=16, f32 pool) at half and full window, t = 1 and 4, q
    bf16 and f32, all timed; at the half window dh=64, bt = 1, 4, 8, 32
    and 64 (below 16 a warp's 4-key groups are partly empty), a bf16
    pool, t=33 (ragged against the 4-query tile) and B=1; short
    rows that leave splits empty; a rerun bit for bit; the planted
    fault; B=1 at the full window timed beside the main case, and both
    timed at 1, 2 and 4 first-pass blocks per SM. Returns
    the kernels-line entry (the full window, t=1, q bf16)."""
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev)
    rng.manual_seed(7)
    before = paged_attention.launches
    bf16, f32 = torch.bfloat16, torch.float32
    main = None
    for fill in ("half", "full"):
        for t in (1, 4):
            for q_dtype in (bf16, f32):
                ops, tm = _paged_case(rng, t, fill, q_dtype, dev)
                got, want, err = _paged_hold(ops, tm, fill, t)
                times = _paged_times(ops, tm)
                name = _paged_name(ops, fill, t)
                _paged_log_times(name, times)
                if fill == "full" and q_dtype == bf16:
                    paged_rerun_check(ops, tm, name)
                    if t == 1:
                        paged_fault_check(ops, tm, want, name)
                        main = dict(max_abs_err=err, **times)
                        paged_device_times(ops, tm, name, times)
    half = [dict(dh=64), dict(dh=64, q_dtype=f32), dict(bt=32),
            dict(bt=64), dict(bt=64, dh=64, q_dtype=f32),
            dict(bt=1, q_dtype=f32), dict(bt=4),
            dict(bt=8, t=4, q_dtype=f32, kv_dtype=bf16),
            dict(kv_dtype=bf16), dict(kv_dtype=bf16, q_dtype=f32),
            dict(kv_dtype=bf16, dh=64, t=4), dict(t=33),
            dict(t=33, q_dtype=f32, kv_dtype=bf16),
            dict(b=1, idle=False), dict(b=1, idle=False, t=4, q_dtype=f32)]
    for kw in half:
        kw = dict(dict(t=1, q_dtype=bf16), **kw)
        t, q_dtype = kw.pop("t"), kw.pop("q_dtype")
        ops, tm = _paged_case(rng, t, "half", q_dtype, dev, **kw)
        _paged_hold(ops, tm, "half", t, kw.get("idle", True))
    for t in (1, 4):
        for q_dtype in (bf16, f32):
            ops, tm = _paged_case(rng, t, "short", q_dtype, dev)
            _paged_hold(ops, tm, "short", t)
    ops, tm = _paged_case(rng, 1, "full", bf16, dev, b=1, idle=False)
    _paged_hold(ops, tm, "full", 1, idle=False)
    name = _paged_name(ops, "full", 1)
    times = _paged_times(ops, tm)
    _paged_log_times(name, times)
    paged_device_times(ops, tm, name, times)
    # comparison launches do not count toward the main path's run
    paged_attention.launches = before
    return [dict(
        name="paged_attention", route="cuda",
        source="deeplearning4j_tpu_torch/csrc/paged_attention.cu",
        replaces="deeplearning4j_tpu/nn/layers/attention.py:807",
        **main)]


# K1 (flash attention): the training path's shapes are B=2, H=8, dh=128
# at phase A's T=2048 and at phase B's T=LONG_T; the kernels line
# reports the LONG_T shape, the one its launches are counted at. Each
# case is held against the plain version on the f32 upcast by three
# measures, each with its limit: max |out - ref| ("out"); each grad's
# max |g - r| / max |r| ("grad"); and the scale-free ||x - r|| / ||r||
# of the output and of each grad ("norm"), which a fault confined to
# late rows moves where the max measures may not. PERF.md gives the
# sound readings and the planted-fault readings each limit sits between.
FLASH_B, FLASH_H = 2, 8
FLASH_TOL = {torch.float32: dict(out=1e-4, grad=1e-3, norm=1e-5),
             torch.bfloat16: dict(out=2e-2, grad=1e-2, norm=6e-3)}
FLASH_SWEEP_T = (512, 1024, 2048, 4096)
# f32 up to the first T where dense no longer fits the card
FLASH_SWEEP_T_F32 = (512, 1024, 2048, 4096, 8192, 16384, 32768)
# query rows per chunk of the chunked plain version: a [B, H, 512, T]
# f32 score block at a time (1 GiB at T=32768)
FLASH_REF_ROWS = 512
# planted faults, each a drop(qpos, kpos) of keys a faulty kernel would
# leave out, confined to the late half of the rows: the check must fail
# each of them (the bf16 kernels step over keys in tiles of 128 in the
# forward and 64 in dQ, over queries in tiles of 64 in dK/dV; the f32
# kernels in tiles of 64 and 32)
FLASH_FAULTS = {
    "diagonal key dropped in rows >= T/2":
        lambda t: lambda qp, kp: (qp >= t // 2) & (kp == qp),
    "first 64-key tile dropped in rows >= T/2":
        lambda t: lambda qp, kp: (qp >= t // 2) & (kp < 64),
}


def _flash_case(gen, t, dh, dtype, dev):
    """q/k/v/dO from a seeded generator; q's row 3 (where T > 3) is zero
    in every head."""
    shape = (FLASH_B, FLASH_H, t, dh)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                   for _ in range(4))
    if t > 3:
        q[:, :, 3, :] = 0.0
    return [a.to(dtype) for a in (q, k, v, do)]


def _flash_flops(t, dh, causal):
    """Executed forward flops (QKᵀ and P·V); causal counts half the
    square. The backward does 2.5x the forward."""
    f = 4.0 * FLASH_B * FLASH_H * t * t * dh
    return f / 2 if causal else f


def _flash_bound(t, dh, dtype, causal, backward):
    """Least time: each operand read once and each output written once
    (fwd: q, k, v -> o, lse; bwd: q, k, v, o, dO, lse -> dq, dk, dv)
    over HBM bytes/s, or the flops over the dtype's peak."""
    el = FLASH_B * FLASH_H * t * dh * (2 if dtype == torch.bfloat16 else 4)
    rows = FLASH_B * FLASH_H * t * 4
    nbytes = (8 * el + 2 * rows) if backward else (4 * el + rows)
    flops = _flash_flops(t, dh, causal) * (2.5 if backward else 1.0)
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _grad_fn(fn, q, k, v, do, causal):
    """fwd+bwd of ``fn`` as one timed call, and the backward alone on a
    graph kept alive (``retain_graph``)."""
    qr, kr, vr = (a.detach().requires_grad_(True) for a in (q, k, v))

    def both():
        out = fn(qr, kr, vr, causal)
        return torch.autograd.grad(out, (qr, kr, vr), do)

    out = fn(qr, kr, vr, causal)

    def back():
        return torch.autograd.grad(out, (qr, kr, vr), do,
                                   retain_graph=True)

    return both, back


def _sdpa(q, k, v, causal):
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal)


def _flash_reference_chunked(q, k, v, do, causal, drop=None,
                             rows=FLASH_REF_ROWS):
    """The function of ``flash_attention_reference`` (f32, the exact
    ``dh ** -0.5``, causal by select) over query-row chunks, with dQ,
    dK and dV by autograd chunk by chunk, so a long T never holds its
    [T, T] scores at once. ``do=None`` gives the output alone;
    ``drop(qpos, kpos)`` marks keys to leave out (a planted fault).
    Returns f32 (out,) or (out, dq, dk, dv)."""
    t, dh = q.shape[2], q.shape[3]
    qf, kf, vf = (a.detach().float() for a in (q, k, v))
    grads = do is not None
    out = torch.empty_like(qf)
    if grads:
        dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    neg = torch.tensor(-1e30, device=q.device)
    for s in range(0, t, rows):
        e = min(s + rows, t)
        n = e if causal else t
        qpos = torch.arange(s, e, device=q.device)[:, None]
        kpos = torch.arange(n, device=q.device)[None, :]
        keep = torch.ones(e - s, n, dtype=torch.bool, device=q.device)
        if causal:
            keep &= kpos <= qpos
        if drop is not None:
            keep &= ~drop(qpos, kpos)
        qc, kc, vc = (a[:, :, lo:hi].detach().requires_grad_(grads)
                      for a, lo, hi in ((qf, s, e), (kf, 0, n), (vf, 0, n)))
        with torch.set_grad_enabled(grads):
            sc = torch.einsum("bhqd,bhkd->bhqk", qc, kc) * dh ** -0.5
            w = torch.softmax(torch.where(keep, sc, neg), dim=-1)
            oc = torch.einsum("bhqk,bhkd->bhqd", w, vc)
            if grads:
                gq, gk, gv = torch.autograd.grad(oc, (qc, kc, vc),
                                                 do[:, :, s:e].float())
        out[:, :, s:e] = oc.detach()
        if grads:
            dq[:, :, s:e] = gq
            dk[:, :, :n] += gk
            dv[:, :, :n] += gv
    return (out, dq, dk, dv) if grads else (out,)


def _flash_errors(out, grads, ref, ref_grads) -> dict:
    """The three measures of FLASH_TOL: ``out`` a number, ``grad`` one
    per dq/dk/dv, ``norm`` one per out/dq/dk/dv. A reference grad that
    is zero everywhere (dQ and dK at T=1, where each row's softmax has
    one key and so no gradient) has no scale of its own: its ``grad``
    and ``norm`` are taken against the largest reference grad's."""
    maxes = [float(r.abs().max()) for r in ref_grads]
    norms = [float(r.norm()) for r in ref_grads]

    def scaled(x, own, top):
        return x / (own if own > 0 else top)

    pairs = list(zip(grads, ref_grads))
    return dict(
        out=float((out.float() - ref).abs().max()),
        grad=[scaled(float((g.float() - r).abs().max()), m, max(maxes))
              for (g, r), m in zip(pairs, maxes)],
        norm=[float((out.float() - ref).norm() / ref.norm())]
        + [scaled(float((g.float() - r).norm()), n, max(norms))
           for (g, r), n in zip(pairs, norms)])


def _flash_failed(errs, dtype) -> list:
    """The measures over their limits at ``dtype``."""
    tol = FLASH_TOL[dtype]
    worst = dict(out=errs["out"], grad=max(errs["grad"]),
                 norm=max(errs["norm"]))
    return [m for m in tol if not worst[m] <= tol[m]]


def _flash_log(name, errs, dtype) -> None:
    tol = FLASH_TOL[dtype]
    log(f"{name}: out max_abs_err {errs['out']:.3e} (tol {tol['out']}); "
        f"dq/dk/dv max err / max|ref| {[f'{e:.3e}' for e in errs['grad']]}"
        f" (tol {tol['grad']}); ||err|| / ||ref|| of out/dq/dk/dv "
        f"{[f'{e:.3e}' for e in errs['norm']]} (tol {tol['norm']})")


def _flash_hold(name, dtype, out, grads, ref, ref_grads) -> dict:
    """Hold K1's output and grads against the plain version's; fatal on
    a NaN or a measure over its limit. Returns the measures."""
    errs = _flash_errors(out, grads, ref, ref_grads)
    _flash_log(name, errs, dtype)
    finite = all(bool(torch.isfinite(a).all()) for a in (out, *grads))
    failed = _flash_failed(errs, dtype)
    if not finite or failed:
        raise SystemExit(f"chip_smoke: {name}: over the limit on "
                         f"{failed}, finite {finite}: {errs}")
    return errs


def _k1_grads(q, k, v, do, causal):
    """K1's output and dQ/dK/dV through autograd."""
    from deeplearning4j_tpu_torch.nn.layers.attention import flash_attention

    qr, kr, vr = (a.detach().requires_grad_(True) for a in (q, k, v))
    out = flash_attention(qr, kr, vr, causal)
    grads = torch.autograd.grad(out, (qr, kr, vr), do)
    torch.cuda.synchronize()
    return out.detach(), grads


def flash_rerun_check(name, q, k, v, do, causal) -> None:
    """K1's forward and backward twice on the same inputs: O, LSE, dQ,
    dK and dV must match bit for bit (no atomics, a fixed summation
    order). Fatal on any difference."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )

    runs = []
    for _ in range(2):
        o, lse = flash_attention_fwd(q, k, v, causal)
        runs.append((o, lse) + flash_attention_bwd(q, k, v, o, lse, do,
                                                   causal))
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    log(f"{name}: rerun bit for bit (O, LSE, dQ, dK, dV) {same}")
    if not all(same):
        raise SystemExit(f"chip_smoke: {name}: a rerun of K1 differs: "
                         f"O, LSE, dQ, dK, dV equal {same}")


def flash_long_case(gen, dev) -> tuple:
    """K1 at phase B's shape (B=2, H=8, T=LONG_T, dh=128, bf16, causal)
    held against the chunked plain version (the whole [T, T] scores do
    not fit the card), with its times, the plain version's (its
    backward timed as chunked fwd+bwd less chunked fwd), SDPA's and the
    bounds. Returns the kernels-line entries."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )

    t, dh, bf16 = LONG_T, WIDTH // N_HEADS, torch.bfloat16
    name = f"flash_attention T={t}, dh={dh}, causal, bfloat16"
    q, k, v, do = _flash_case(gen, t, dh, bf16, dev)
    out, grads = _k1_grads(q, k, v, do, True)
    ref, *ref_grads = _flash_reference_chunked(q, k, v, do, True)
    errs = _flash_hold(name + " (chunked plain)", bf16, out, grads, ref,
                       ref_grads)
    del out, grads, ref, ref_grads
    flash_rerun_check(name, q, k, v, do, True)
    o, lse = flash_attention_fwd(q, k, v, True)
    ms = cuda_time_ms(lambda: flash_attention_fwd(q, k, v, True), iters=5,
                      warmup=1)
    bwd_ms = cuda_time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                      True),
                          iters=5, warmup=1)
    plain_ms = cuda_time_ms(
        lambda: _flash_reference_chunked(q, k, v, None, True), iters=2,
        warmup=1)
    plain_both_ms = cuda_time_ms(
        lambda: _flash_reference_chunked(q, k, v, do, True), iters=2,
        warmup=1)
    lib_ms = cuda_time_ms(lambda: _sdpa(q, k, v, True), iters=5, warmup=1)
    _, l_back = _grad_fn(_sdpa, q, k, v, do, True)
    lib_bwd_ms = cuda_time_ms(l_back, iters=5, warmup=1)
    bound, by = _flash_bound(t, dh, bf16, True, False)
    bbound, bby = _flash_bound(t, dh, bf16, True, True)
    plain_bwd_ms = plain_both_ms - plain_ms
    log(f"{name} times: kernel fwd {ms:.4f} ms, bwd {bwd_ms:.4f} ms; "
        f"chunked plain fwd {plain_ms:.4f}, fwd+bwd {plain_both_ms:.4f}, "
        f"bwd (the difference) {plain_bwd_ms:.4f} ms; sdpa fwd "
        f"{lib_ms:.4f}, bwd {lib_bwd_ms:.4f} ms; bound fwd {bound:.4f} ms "
        f"({by}, {bound / ms:.2%} of it), bwd {bbound:.4f} ms ({bby}, "
        f"{bbound / bwd_ms:.2%} of it)")
    return {
        "flash_attention": dict(
            max_abs_err=errs["out"], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=lib_ms),
        "flash_attention_bwd": dict(
            max_abs_err=max(errs["grad"]), ms=bwd_ms,
            plain_ms=plain_bwd_ms, bound_ms=bbound, bound_by=bby,
            library_ms=lib_bwd_ms)}


def flash_fault_readings(q, k, v, do, ref, ref_grads) -> None:
    """The chunked plain version held against the whole one (f32, so
    at the f32 limits), then each planted fault's readings against the
    bf16 limits: the check must fail every fault."""
    t = q.shape[2]
    chunked, *c_grads = _flash_reference_chunked(q, k, v, do, True)
    _flash_hold(f"chunked plain vs plain T={t}, float32", torch.float32,
                chunked, c_grads, ref, ref_grads)
    for fault, drop in FLASH_FAULTS.items():
        f_out, *f_grads = _flash_reference_chunked(q, k, v, do, True,
                                                   drop=drop(t))
        errs = _flash_errors(f_out, f_grads, ref, ref_grads)
        _flash_log(f"planted fault T={t}: {fault}", errs, torch.bfloat16)
        failed = _flash_failed(errs, torch.bfloat16)
        log(f"planted fault T={t}: {fault}: caught by {failed}")
        if not failed:
            raise SystemExit(f"chip_smoke: the bf16 limits pass a planted "
                             f"fault ({fault}): {errs}")


def _dense_grad_fn(q, k, v, do):
    from deeplearning4j_tpu_torch.nn.layers.attention import _dense_attention

    both, _ = _grad_fn(
        lambda a, b, c, causal: _dense_attention(a, b, c, causal, None),
        q, k, v, do, True)
    return both


def flash_sweep(gen, dev) -> None:
    """The threshold behind K1's auto dispatch (``FLASH_MIN_T``, one
    for bf16 and f32): K1 fwd+bwd against dense fwd+bwd at B=2, H=8,
    dh=128, causal, with dense's peak memory above its inputs; bf16 over
    FLASH_SWEEP_T, f32 over FLASH_SWEEP_T_F32 up to the first T where
    dense does not fit the card. Logs whether each T's faster path is
    the one the rule picks."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        FLASH_MIN_T,
        flash_attention,
    )

    for dtype, ts in ((torch.bfloat16, FLASH_SWEEP_T),
                      (torch.float32, FLASH_SWEEP_T_F32)):
        sweep = []
        for t in ts:
            iters = 10 if t <= 4096 else 2
            q, k, v, do = _flash_case(gen, t, 128, dtype, dev)
            k_both, _ = _grad_fn(flash_attention, q, k, v, do, True)
            k_ms = cuda_time_ms(k_both, iters=iters, warmup=1)
            del k_both
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            try:
                d_both = _dense_grad_fn(q, k, v, do)
                d_ms = cuda_time_ms(d_both, iters=iters, warmup=1)
                d_mem = torch.cuda.max_memory_allocated() - base
                del d_both
            except torch.cuda.OutOfMemoryError:
                d_ms = d_mem = None
            torch.cuda.empty_cache()
            rule = t >= FLASH_MIN_T
            faster = d_ms is None or k_ms < d_ms
            sweep.append((t, k_ms, d_ms, d_mem, rule == faster))
            if d_ms is None:
                break
        log(f"FLASH_MIN_T sweep ({str(dtype).split('.')[-1]}, B=2, H=8, "
            f"dh=128, causal, fwd+bwd ms; dense peak memory above its "
            f"inputs; threshold {FLASH_MIN_T}): " + "; ".join(
                f"T={t}: kernel {a:.4f}, dense "
                + (f"{b:.4f}, dense memory {m / 2**30:.3f} GiB"
                   if b is not None else "does not fit the card")
                + f", rule {'agrees' if ok else 'DISAGREES'}"
                for t, a, b, m, ok in sweep))


def flash_kernel_phase() -> tuple:
    """K1 forward and backward held against the plain version on the
    f32 upcast at phase A's and phase B's shapes and at edge cases;
    planted-fault readings; times; the FLASH_MIN_T sweep. Returns the
    kernels-line entries (at LONG_T) and K1's fwd + bwd ms there."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_fwd,
        flash_attention_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    before = (flash_attention.launches, flash_attention.bwd_launches)
    cases = [(2048, 128, True), (1000, 128, True), (2049, 128, True),
             (1024, 64, True), (1024, 128, False),
             # shorter than one tile, or ragged against 128
             (1, 128, True), (77, 128, True), (129, 128, True),
             (77, 64, True)]
    for t, dh, causal in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = _flash_case(gen, t, dh, dtype, dev)
            out, grads = _k1_grads(q, k, v, do, causal)
            qf, kf, vf = (a.float().requires_grad_(True) for a in (q, k, v))
            ref = flash_attention_reference(qf, kf, vf, causal)
            ref_grads = torch.autograd.grad(ref, (qf, kf, vf), do.float())
            ref = ref.detach()
            name = (f"flash_attention T={t}, dh={dh}, "
                    f"{'causal' if causal else 'full'}, "
                    f"{str(dtype).split('.')[-1]}")
            _flash_hold(name, dtype, out, grads, ref, ref_grads)
            if t != 2048:
                continue
            if dtype == torch.float32:
                flash_fault_readings(q, k, v, do, ref, ref_grads)
            flash_rerun_check(name, q, k, v, do, causal)
            qc, kc, vc, oc = (a.contiguous() for a in (q, k, v, out))
            _, lse = flash_attention_fwd(qc, kc, vc, causal)
            ms = cuda_time_ms(lambda: flash_attention_fwd(qc, kc, vc, causal))
            bwd_ms = cuda_time_ms(lambda: flash_attention_bwd(
                qc, kc, vc, oc, lse, do, causal))
            both, _ = _grad_fn(flash_attention, q, k, v, do, causal)
            both_ms = cuda_time_ms(both)
            plain_ms = cuda_time_ms(
                lambda: flash_attention_reference(q, k, v, causal))
            p_both, p_back = _grad_fn(flash_attention_reference, q, k, v, do,
                                      causal)
            plain_bwd_ms = cuda_time_ms(p_back)
            plain_both_ms = cuda_time_ms(p_both)
            lib_ms = cuda_time_ms(lambda: _sdpa(q, k, v, causal))
            l_both, l_back = _grad_fn(_sdpa, q, k, v, do, causal)
            lib_bwd_ms = cuda_time_ms(l_back)
            lib_both_ms = cuda_time_ms(l_both)
            bound, by = _flash_bound(t, dh, dtype, causal, False)
            bbound, bby = _flash_bound(t, dh, dtype, causal, True)
            log(f"{name} times: kernel fwd {ms:.4f} ms, bwd {bwd_ms:.4f} ms,"
                f" fwd+bwd {both_ms:.4f} ms; plain fwd {plain_ms:.4f}, bwd "
                f"{plain_bwd_ms:.4f}, fwd+bwd {plain_both_ms:.4f} ms; sdpa "
                f"fwd {lib_ms:.4f}, bwd {lib_bwd_ms:.4f}, fwd+bwd "
                f"{lib_both_ms:.4f} ms; bound fwd {bound:.4f} ms ({by}, "
                f"{bound / ms:.1%} of it), bwd {bbound:.4f} ms ({bby}, "
                f"{bbound / bwd_ms:.1%} of it)")
    entries = flash_long_case(gen, dev)
    flash_sweep(gen, dev)
    flash_attention.launches, flash_attention.bwd_launches = before
    src = "deeplearning4j_tpu_torch/csrc/flash_attention.cu"
    rep = "deeplearning4j_tpu/nn/layers/attention.py:729"
    k1_long_ms = (entries["flash_attention"]["ms"]
                  + entries["flash_attention_bwd"]["ms"])
    return [dict(name=name, route="cuda", source=src, replaces=rep, **e)
            for name, e in entries.items()], k1_long_ms


# K3 (conv_taps): LeNet conv1's shape on the training path is B=2048,
# 1 -> 20 channels, 5x5, 28x28 -> 24x24, bf16 x and bf16 W (the net's
# compute dtype), which conv_taps routes to the tensor-core kernel; f32
# operands, and bf16 x with an f32 W, go to the CUDA-core kernel.
# Each case is held against the plain version (the tap loop) on the
# same inputs. f32 differs only in summation order (fused multiply-
# adds): max |err| <= CONV_TOL_F32 * max |ref|. bf16: at most
# CONV_TOL_ULPS bf16 ulp from the plain version run in bf16 (the f32
# sums differ by a rounding or so, then round once; the tensor-core
# kernel recomputes in order each output whose sum cancels).
CONV_B, CONV_O, CONV_K, CONV_HW = 2048, 20, 5, 28
CONV_TOL_F32 = 1e-5
CONV_TOL_ULPS = 1.0
# the planted fault: the centre tap of every channel zeroed
CONV_FAULT_TAP = (2, 2)
_BF16, _F32 = torch.bfloat16, torch.float32
# (batch, kernel size, image size, padding, x dtype, W dtype); the
# first is the main case (the LeNet path's), the second the CUDA-core
# kernel at that shape with f32 W, as the LeNet path ran it before the
# tensor-core kernel
CONV_CASES = (
    (CONV_B, CONV_K, CONV_HW, 0, _BF16, _BF16),
    (CONV_B, CONV_K, CONV_HW, 0, _BF16, _F32),
    (CONV_B, CONV_K, CONV_HW, 0, _F32, _F32),
    (1, CONV_K, CONV_HW, 0, _BF16, _BF16),
    (1, CONV_K, CONV_HW, 0, _F32, _F32),
    (CONV_B + 1, CONV_K, CONV_HW, 0, _BF16, _BF16),
    (CONV_B + 1, CONV_K, CONV_HW, 0, _F32, _F32),
    (64, CONV_K, CONV_HW, 2, _BF16, _BF16),
    (64, CONV_K, CONV_HW, 2, _F32, _F32),
    (64, 3, CONV_HW, 0, _BF16, _BF16), (64, 3, CONV_HW, 0, _F32, _F32),
    (64, 1, CONV_HW, 0, _BF16, _BF16),
    (64, 7, CONV_HW, 3, _BF16, _BF16),
    # 23x23 = 529 output pixels (not a multiple of 16 or 8), H*W odd
    (64, CONV_K, 27, 0, _BF16, _BF16))


def _conv_case(gen, b, k, hw, dtype, w_dtype, dev):
    """x [b, 1, hw, hw] in ``dtype`` and bf16-representable w [O, k, k]
    in ``w_dtype`` (the bf16 training weights, or their f32 upcast)."""
    x = torch.rand(b, 1, hw, hw, generator=gen, device=dev).to(dtype)
    w = (torch.randn(CONV_O, k, k, generator=gen, device=dev)
         * 0.1).bfloat16().to(w_dtype)
    return x, w


def _bf16_ulp_map(got, want):
    """|got - want| in bf16 ulps of the larger magnitude, elementwise."""
    g, r = got.float(), want.float()
    mag = torch.maximum(g.abs(), r.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (g - r).abs() / ulp


def _bf16_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of the larger magnitude."""
    return float(_bf16_ulp_map(got, want).max())


def _conv_errors(got, want) -> dict:
    err = float((got.float() - want.float()).abs().max())
    return dict(max_abs_err=err,
                rel=err / max(float(want.float().abs().max()), 1e-30),
                ulps=_bf16_ulps(got, want))


def _conv_failed(errs, dtype) -> bool:
    if dtype == torch.float32:
        return not errs["rel"] <= CONV_TOL_F32
    return not errs["ulps"] <= CONV_TOL_ULPS


def _conv_bound(b, o, k, hw, pad, dtype):
    """Least time: x read once, out written once (and w), over HBM
    bytes/s, or the multiply-adds (2 flops each) over the card's peak
    for the operands' type: bf16 x with bf16-valued w (``_conv_case``,
    as on the LeNet path) at the bf16 tensor-core rate, f32 at the f32
    rate."""
    ho = hw + 2 * pad - k + 1
    el = 2 if dtype == torch.bfloat16 else 4
    nbytes = (b * hw * hw + b * o * ho * ho) * el + o * k * k * 4
    flops = 2.0 * b * o * k * k * ho * ho
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound, t_bytes, t_ops


def _conv_name(b, k, hw, pad, dtype, w_dtype):
    return (f"conv_taps B={b}, {hw}x{hw}, {k}x{k}, pad {pad}, x "
            f"{str(dtype).split('.')[-1]}, W {str(w_dtype).split('.')[-1]}")


def conv_nonfinite_check(gen, dev) -> None:
    """One inf and one NaN in a bf16 batch (the tensor-core kernel): the
    non-finite outputs sit exactly where the plain version's do, and the
    finite ones hold the bf16 limit."""
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        conv_taps,
        conv_taps_reference,
    )

    x, w = _conv_case(gen, 64, CONV_K, CONV_HW, _BF16, _BF16, dev)
    x[3, 0, 10, 10] = float("inf")
    x[7, 0, 0, CONV_HW - 1] = float("nan")
    got = conv_taps(x, w)
    torch.cuda.synchronize()
    want = conv_taps_reference(x, w)
    same = {what: bool(torch.equal(fn(got), fn(want))) for what, fn in (
        ("nan", torch.isnan), ("+inf", torch.isposinf),
        ("-inf", torch.isneginf))}
    fin = torch.isfinite(want) & torch.isfinite(got)
    errs = _conv_errors(got[fin], want[fin])
    log(f"conv_taps B=64 with an inf and a NaN: non-finite outputs "
        f"{int((~torch.isfinite(want)).sum())}, positions as the plain "
        f"version's {same}; finite outputs {errs['ulps']:.2f} bf16 ulps")
    if not all(same.values()) or _conv_failed(errs, _BF16):
        raise SystemExit(f"chip_smoke: conv_taps non-finite case: {same}, "
                         f"{errs}")


def conv_kernel_phase() -> list:
    """K3 held against its plain version in every CONV_CASES case, each
    on the route conv_taps must take (bf16 x with bf16 W: the tensor-
    core kernel; the rest: the CUDA-core kernel), plus an inf and a
    NaN; the main case rerun bit for bit; the planted fault must fail
    the bf16 limit; the CUDA-core kernel's guarded any-size path held to
    the same limit. Times at B=2048: the tensor-core kernel, the
    CUDA-core kernel with f32 W (bf16 x, as the LeNet path ran it before
    the tensor-core kernel) and with f32 x and W, cuDNN's ``F.conv2d``,
    the plain version and the bound. Returns the kernels-line entries of
    the two routes (without launches): ``conv_taps``, the tensor-core
    kernel the LeNet path runs, and ``conv_taps_f32``, the CUDA-core
    kernel at f32."""
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        _conv_taps_launch,
        conv_taps,
        conv_taps_reference,
    )

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    before = (conv_taps.launches, conv_taps.mma_launches)
    entries, main_x = {}, None
    for b, k, hw, pad, dtype, w_dtype in CONV_CASES:
        x, w = _conv_case(gen, b, k, hw, dtype, w_dtype, dev)
        mma0 = conv_taps.mma_launches
        got = conv_taps(x, w, (pad, pad))
        torch.cuda.synchronize()
        mma = conv_taps.mma_launches - mma0 == 1
        want = conv_taps_reference(x, w, (pad, pad))
        errs = _conv_errors(got, want)
        name = _conv_name(b, k, hw, pad, dtype, w_dtype)
        log(f"{name} ({'tensor cores' if mma else 'CUDA cores'}): "
            f"max_abs_err {errs['max_abs_err']:.3e}, / max|ref| "
            f"{errs['rel']:.3e} (f32 tol {CONV_TOL_F32}), bf16 ulps "
            f"{errs['ulps']:.2f} (bf16 tol {CONV_TOL_ULPS})")
        if mma != (dtype == w_dtype == _BF16):
            raise SystemExit(f"chip_smoke: {name} took the wrong route")
        if (_conv_failed(errs, dtype) or got.shape != want.shape
                or not bool(torch.isfinite(got).all())):
            raise SystemExit(f"chip_smoke: {name}: over the limit: {errs}")
        if (b, k, hw, pad) != (CONV_B, CONV_K, CONV_HW, 0):
            continue
        (bound, by), t_bytes, t_ops = _conv_bound(b, CONV_O, k, hw, pad,
                                                  dtype)
        plain_ms = cuda_time_ms(lambda: conv_taps_reference(x, w), iters=20)
        lib_ms = cuda_time_ms(
            lambda: torch.nn.functional.conv2d(x, w.to(dtype)[:, None]),
            iters=100)
        ms = cuda_time_ms(lambda: conv_taps(x, w), iters=100)
        dev_ms = graph_time_ms(lambda: conv_taps(x, w))
        log(f"{name} times: kernel {ms:.4f} ms (device {dev_ms:.4f} ms, "
            f"a CUDA graph of 20 calls), plain {plain_ms:.4f} ms, cudnn "
            f"conv2d {lib_ms:.4f} ms; bound {bound:.4f} ms ({by}; bytes "
            f"{t_bytes:.4f} ms, operations {t_ops:.4f} ms), {bound / ms:.1%} "
            f"of it ({bound / dev_ms:.1%} of the device time)")
        entry = dict(max_abs_err=errs["max_abs_err"], ms=ms,
                     plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                     library_ms=lib_ms)
        if mma:
            entries["conv_taps"] = entry
            main_x, main_w, main_got, main_want = x, w, got, want
        elif dtype == _F32:
            entries["conv_taps_f32"] = entry
        else:
            guarded = _conv_taps_launch(x, w, (0, 0), guarded=True)
            g_errs = _conv_errors(guarded, want)
            guarded_ms = cuda_time_ms(
                lambda: _conv_taps_launch(x, w, (0, 0), guarded=True),
                iters=100)
            log(f"{name}: the CUDA-core kernel's guarded any-size path "
                f"{guarded_ms:.4f} ms "
                f"({guarded_ms / ms:.2f}x its 5x5 path), bf16 ulps "
                f"{g_errs['ulps']:.2f}")
            if _conv_failed(g_errs, dtype):
                raise SystemExit(f"chip_smoke: {name}, guarded path: over "
                                 f"the limit: {g_errs}")

    name = _conv_name(CONV_B, CONV_K, CONV_HW, 0, _BF16, _BF16)
    again = conv_taps(main_x, main_w)
    rerun = bool(torch.equal(again, main_got))
    bad_w = main_w.clone()
    bad_w[:, CONV_FAULT_TAP[0], CONV_FAULT_TAP[1]] = 0.0
    f_errs = _conv_errors(conv_taps(main_x, bad_w), main_want)
    torch.cuda.synchronize()
    log(f"{name}: rerun bit-identical {rerun}; planted fault (tap "
        f"{CONV_FAULT_TAP} zeroed): {f_errs['ulps']:.1f} bf16 ulps, "
        f"max_abs_err {f_errs['max_abs_err']:.3e}: caught "
        f"{_conv_failed(f_errs, _BF16)}")
    if not rerun or not _conv_failed(f_errs, _BF16):
        raise SystemExit(f"chip_smoke: K3 main case: rerun identical "
                         f"{rerun}, planted fault {f_errs}")
    conv_nonfinite_check(gen, dev)
    conv_taps.launches, conv_taps.mma_launches = before
    src = "deeplearning4j_tpu_torch/csrc/conv_taps.cu"
    rep = "scripts/lenet_breakdown.py:148"
    return [dict(name=n, route="cuda", source=src, replaces=rep, **e)
            for n, e in entries.items()]


# training: the flagship at full width on the Markov task
TRAIN_VOCAB, TRAIN_B = 64, 2
PARITY_T, PARITY_STEPS = 2048, 4
# loss-trajectory agreement, K1 net vs dense net (ROADMAP's 5e-3 at f32
# with TF32 off; bf16 rounds at other places in the two attentions)
PARITY_RTOL = {"float32": 5e-3, "bfloat16": 2e-2}
# at f32 the params after the 4 steps agree too (max |diff|; 1.2e-6
# measured). At bf16 they are not held: Adam's normalized step turns
# rounding-level gradient differences into lr-sized param differences.
PARITY_PARAM_ATOL = {"float32": 1e-5}
# bench.py's 32k long-context row: 1 warm-up and 2 timed steps
LONG_T, LONG_STEPS = 32768, 3


def _flagship(compute_dtype, use_flash, **kw):
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm_flagship

    conf = transformer_lm_flagship(vocab=TRAIN_VOCAB, width=WIDTH,
                                   n_layers=N_LAYERS, n_heads=N_HEADS,
                                   seed=11, **kw)
    for c in conf.confs:
        if compute_dtype != "float32":
            c.compute_dtype = compute_dtype
        if hasattr(c.layer, "use_flash"):
            c.layer.use_flash = use_flash
    return conf


def _markov_batches(n_batches, t, sample_seed):
    from deeplearning4j_tpu_torch.datasets.markov import markov_lm_batches

    f, y, floor = markov_lm_batches(TRAIN_VOCAB, TRAIN_B * n_batches, t,
                                    seed=0, sample_seed=sample_seed)
    return [(f[i:i + TRAIN_B], y[i:i + TRAIN_B])
            for i in range(0, len(f), TRAIN_B)], floor


def _train(net, batches):
    """fit each batch; returns the losses and the wall of each step."""
    losses, walls = [], []
    for f, y in batches:
        t0 = time.perf_counter()
        net.fit(f, y)
        losses.append(float(net.score_value))   # syncs the step
        walls.append(time.perf_counter() - t0)
    return losses, walls


def training_parity_phase(card: str) -> None:
    """Phase A: two flagship nets from the same params, one on K1 and
    one on dense attention, 4 fit steps each at B=2, T=2048; the loss
    trajectories agree and K1 launched 8 times per step each way."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention,
        paged_attention,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    batches, _ = _markov_batches(PARITY_STEPS, PARITY_T, sample_seed=1)
    for cd in ("float32", "bfloat16"):
        kw = dict(lr=1e-3, warmup_steps=2, total_steps=100)
        k1 = MultiLayerNetwork(_flagship(cd, True, **kw),
                               device=DEVICE).init()
        dense = MultiLayerNetwork(_flagship(cd, False, **kw),
                                  device=DEVICE).init()
        for key, p in k1.param_table().items():
            dense.set_param(key, p)
        flash_attention.launches = flash_attention.bwd_launches = 0
        paged_attention.launches = 0
        k_loss, k_wall = _train(k1, batches)
        fwd, bwd = flash_attention.launches, flash_attention.bwd_launches
        d_loss, d_wall = _train(dense, batches)
        dense_launches = flash_attention.launches - fwd
        rel = max(abs(a - b) / abs(b) for a, b in zip(k_loss, d_loss))
        pdiff = max(float((k1.param_table()[k] - p).abs().max())
                    for k, p in dense.param_table().items())
        p_tol = PARITY_PARAM_ATOL.get(cd, float("inf"))
        log(f"training A [{cd}]: K1 losses {[f'{x:.6f}' for x in k_loss]}, "
            f"dense {[f'{x:.6f}' for x in d_loss]}; max rel diff {rel:.3e} "
            f"(tol {PARITY_RTOL[cd]}); max |param diff| {pdiff:.3e} (tol "
            f"{p_tol}); K1 launches fwd {fwd}, bwd {bwd} over "
            f"{PARITY_STEPS} steps; s/step K1 {[round(w, 4) for w in k_wall]}"
            f", dense {[round(w, 4) for w in d_wall]} [{card}]")
        want = N_LAYERS * PARITY_STEPS
        if (not rel <= PARITY_RTOL[cd] or not pdiff <= p_tol
                or fwd != want or bwd != want
                or dense_launches != 0 or paged_attention.launches != 0
                or not all(np.isfinite(k_loss + d_loss))):
            raise SystemExit(
                f"chip_smoke: training phase A [{cd}] failed: rel {rel}, "
                f"param diff {pdiff}, K1 launches {fwd}/{bwd} (want "
                f"{want}), dense net's {dense_launches}, paged "
                f"{paged_attention.launches}")
        del k1, dense
        torch.cuda.empty_cache()


def training_long_phase(card: str, k1_ms: float) -> dict:
    """Phase B: bench.py's long-context row (width 1024, 8 blocks, 8
    heads, bf16, lr 3e-4, warmup 10, total 1000) at B=2, T=32768 on
    Markov tokens: 1 warm-up and 2 timed fit steps, K1 in auto mode.
    ``k1_ms`` is K1's fwd + bwd ms at this shape (kernels phase).
    Returns K1's launches on this run."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention,
        paged_attention,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    t = LONG_T
    batches, floor = _markov_batches(LONG_STEPS, t, sample_seed=2)
    net = MultiLayerNetwork(_flagship("bfloat16", None, lr=3e-4,
                                      warmup_steps=10, total_steps=1000),
                            device=DEVICE).init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention.bwd_launches = 0
    paged_attention.launches = 0
    losses, walls = _train(net, batches)
    fwd, bwd = flash_attention.launches, flash_attention.bwd_launches
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.mean(walls[1:]))
    dense_gb = TRAIN_B * N_HEADS * t * t * 2 / 1e9
    log(f"training B: T={t}, B={TRAIN_B}, bf16; losses "
        f"{[f'{x:.6f}' for x in losses]} (entropy floor {floor:.4f}); "
        f"s/step {[round(w, 3) for w in walls]} (first is warm-up); "
        f"{TRAIN_B * t / step_s:.1f} tokens/s over the timed steps; peak "
        f"memory {peak / 2**30:.3f} GiB; K1 launches fwd {fwd}, bwd {bwd} "
        f"[{card}]. Dense path not attempted: its scores alone are "
        f"[{TRAIN_B}, {N_HEADS}, {t}, {t}] bf16 = {dense_gb:.1f} GB per "
        "layer")
    want = N_LAYERS * LONG_STEPS
    if (not all(np.isfinite(losses)) or fwd != want or bwd != want
            or paged_attention.launches != 0):
        raise SystemExit(f"chip_smoke: training phase B failed: losses "
                         f"{losses}, K1 launches {fwd}/{bwd} (want {want})")
    del net
    torch.cuda.empty_cache()
    log(f"training B: K1 {N_LAYERS} layers x (fwd + bwd) = "
        f"{N_LAYERS * k1_ms / 1e3 / step_s:.1%} of the step (K1 timed "
        "alone at this shape in the kernels phase)")
    return {"flash_attention": fwd, "flash_attention_bwd": bwd}


# the serving gate, the kernel engine against the plain engine (the
# gather program, use_flash_paged=False), at prompt seed 0. It decides
# at f32: the greedy ids identical on every request (ROADMAP: "greedy
# ids identical at f32"), for the kernel engine and for a right program
# (the plain one with its score sums reordered), while each planted
# fault in the plain engine's attention must differ. At bf16 it prints
# the kernel engine's free-running id agreement with the plain engine,
# per request, with the f32 log-probability gap at each first
# divergence: a report, with no bar. On these random weights no bf16
# reading separates right programs from the "newest key dropped" fault
# (PERF.md §6; ROADMAP Queue 3, item 5, closed with that ruling).
# The prompt sets default_rng(s), s in SERVING_SEEDS, are those of
# scripts/torch_serving_agreement.py's readings over seeds.
SERVING_SEEDS = tuple(range(8))


def _paged_fault_newest_key_dropped(ref):
    """Each query placed one position early: its newest key (its own)
    is no longer causal and its V lane is zeroed; past the window one
    key older than the window is admitted."""
    def fn(q, pk, pv, bid, bval, lo_blk, floor, filled, lengths, *, tm):
        return ref(q, pk, pv, bid, bval, lo_blk, floor, filled - 1,
                   lengths, tm=tm)
    return fn


def _paged_fault_scale_squared(ref):
    """Scores scaled by dh^-1 in place of dh^-1/2."""
    def fn(q, pk, pv, *rest, tm):
        return ref(q * q.shape[-1] ** -0.5, pk, pv, *rest, tm=tm)
    return fn


def reordered_sums(ref):
    """A right program: the plain version with its score sums over dh
    taken in reverse order (the same function, other roundings)."""
    def fn(q, pk, pv, *rest, tm):
        return ref(q.flip(-1), pk.flip(-1), pv.flip(-1), *rest,
                   tm=tm).flip(-1)
    return fn


#: planted faults of the plain engine's attention the f32 gate must
#: reject (each wraps ``paged_attention_reference``)
PLANTED_FAULTS = {"newest key dropped": _paged_fault_newest_key_dropped,
                  "scale squared": _paged_fault_scale_squared}


@contextlib.contextmanager
def paged_reference_wrapped(wrap):
    """Within the block, the plain paged attention (the gather program
    ``_paged_attend`` calls for ``use_flash_paged=False``) is
    ``wrap(paged_attention_reference)``; ``wrap=None`` leaves it. The
    CUDA kernel is untouched."""
    from deeplearning4j_tpu_torch.nn.layers import attention

    ref = attention.paged_attention_reference
    if wrap is not None:
        attention.paged_attention_reference = wrap(ref)
    try:
        yield
    finally:
        attention.paged_attention_reference = ref


def serving_prompts(seed: int, n=None, length=None, vocab=None) -> list:
    """The serving workload's prompts from ``default_rng(seed)``: ``n``
    (N_REQUESTS) prompts of ``length`` (PROMPT_LEN) ids below ``vocab``
    (VOCAB)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab or VOCAB, length or PROMPT_LEN).tolist()
            for _ in range(n or N_REQUESTS)]


def serve_ids(engine, prompts, n_gen=None) -> tuple:
    """Greedy-serve ``prompts`` on ``engine``, ``n_gen`` (N_GEN) new
    tokens each; returns the results in submission order and the wall
    seconds of the run."""
    from deeplearning4j_tpu_torch.serving import Request

    ids = [engine.submit(Request(list(p), n_gen or N_GEN)) for p in prompts]
    t0 = time.perf_counter()
    res = engine.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return [res[i] for i in ids], time.perf_counter() - t0


def request_agreement(a, b) -> float:
    """The share of positions where two id sequences of one request
    agree; a position only one of them reached counts as a
    disagreement."""
    n = max(len(a), len(b))
    if n == 0:
        return 1.0
    m = min(len(a), len(b))
    return float((np.asarray(a[:m]) == np.asarray(b[:m])).sum()) / n


def agreement(runs_a, runs_b) -> list:
    """:func:`request_agreement` of each request of two runs, in order."""
    if len(runs_a) != len(runs_b):
        raise ValueError(
            f"runs of {len(runs_a)} and {len(runs_b)} requests")
    return [request_agreement(a, b) for a, b in zip(runs_a, runs_b)]


def first_divergence(a, b):
    """The first position where two id sequences differ (the shorter
    one's length if one is a prefix of the other), or None when they
    are identical."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def logprob_gap(net, prompt, shared, tok_a: int, tok_b: int) -> float:
    """log p(tok_a) - log p(tok_b) for the token after ``prompt`` +
    ``shared``, from ``net.output`` (a full forward, no cache) of an
    LM-shaped net with one-hot input. Near 0 means a near-tie."""
    ids = torch.as_tensor(list(prompt) + list(shared), dtype=torch.long)
    vocab = net.conf.confs[0].layer.n_in
    x = torch.nn.functional.one_hot(ids, vocab).T[None].float()
    probs = net.output(x)[0, :, -1].double()
    return float(torch.log(probs[tok_a]) - torch.log(probs[tok_b]))


def _serving_net(compute_dtype: str, device=None):
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm_flagship
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = transformer_lm_flagship(vocab=VOCAB, width=WIDTH,
                                   n_layers=N_LAYERS, n_heads=N_HEADS,
                                   seed=11)
    for c in conf.confs:
        if compute_dtype != "float32":
            c.compute_dtype = compute_dtype
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    return MultiLayerNetwork(conf, device=device or DEVICE).init()


def decode_forward_sync_check(eng, prompts) -> None:
    """One decode step's network forward (``DecodeEngine._forward``, the
    paged attend with its K/V scatter and K2 in every layer) over full
    slots, run under ``torch.cuda.set_sync_debug_mode("error")``: any
    host synchronisation in it raises. Fatal if one does."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.serving import Request

    for p in prompts[:N_SLOTS]:
        eng.submit(Request(list(p), N_GEN))
    eng.step()                   # admissions and one round
    active = sum(s is not None for s in eng._slots)
    with torch.no_grad():
        rnn = eng._paged_rnn_rows(eng._kv_tabs)
        x = F.one_hot(eng._toks.long(), eng.vocab).to(
            eng.net._dtype)[:, :, None]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, _ = eng._forward(x, None, rnn)
        except RuntimeError as e:
            raise SystemExit(f"chip_smoke: a decode step's forward syncs "
                             f"the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()) or active != N_SLOTS:
        raise SystemExit(f"chip_smoke: sync check: {active} active slots, "
                         "non-finite output")
    log(f"serving: one decode step's forward over {active} slots ran under "
        "set_sync_debug_mode('error') without a host sync")
    eng.run()


def near_tie_report(net32, prompts, ids_a, ids_b, label) -> None:
    """For each request whose two id runs diverge: the first divergent
    position, the two tokens, and log p(a) - log p(b) there from the
    f32 ``net.output`` forward on the shared prefix. Evidence only."""
    for r, (p, a, b) in enumerate(zip(prompts, ids_a, ids_b)):
        at = first_divergence(a, b)
        if at is None or at >= min(len(a), len(b)):
            continue
        gap = logprob_gap(net32, p, a[:at], a[at], b[at])
        log(f"  {label} request {r}: first divergence at token {at}: "
            f"{a[at]} vs {b[at]}, f32 log-prob gap {gap:+.4e}")


def serving_phase(card: str) -> int:
    """The flagship served by the paged-KV engine on the card (the main
    run: bf16, prompt seed 0, timed), one decode step's forward checked
    for host syncs, then the serving gate: f32 ids identical between the
    kernel engine and the plain engine, and between the plain engine and
    a right program (the plain one with reordered sums); each planted
    fault rejected by that check. Beside it, as a report, the main run's
    bf16 free-running id agreement with the plain engine at prompt seed
    0, with a near-tie report for each request that diverges. Returns
    the paged-attention kernel's launches on the main run."""
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention
    from deeplearning4j_tpu_torch.serving import DecodeEngine, Request

    net = _serving_net("bfloat16")
    # the forward is right on a small input: finite softmax rows
    x = torch.zeros(2, VOCAB, 16, device=DEVICE)
    x[:, 3, :] = 1.0
    probs = net.output(x)
    sums = probs.sum(dim=1)
    if (probs.shape != (2, VOCAB, 16) or not torch.isfinite(probs).all()
            or float((sums - 1).abs().max()) > 1e-4):
        raise SystemExit(f"chip_smoke: flagship output() is wrong: shape "
                         f"{tuple(probs.shape)}, row sums {sums}")
    geometry = dict(paged_kv=True, block_tokens=BLOCK_TOKENS,
                    n_slots=N_SLOTS, decode_chunk=DECODE_CHUNK)
    prompts = serving_prompts(0)

    eng = DecodeEngine(net, **geometry)
    eng.submit(Request(prompts[0][:16], DECODE_CHUNK + 1))   # warm-up
    eng.run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps0 = eng.stats["decode_steps"]
    paged_attention.launches = 0
    results, wall = serve_ids(eng, prompts)
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
    decode_forward_sync_check(eng, prompts)
    del eng

    net32 = _serving_net("float32")
    for key, p in net.param_table().items():
        net32.set_param(key, p)

    def free_ids(model, use_flash_paged, seed, wrap=None):
        with paged_reference_wrapped(wrap):
            res, secs = serve_ids(DecodeEngine(
                model, use_flash_paged=use_flash_paged, **geometry),
                serving_prompts(seed))
        return [r.tokens for r in res], secs

    def rounded(xs):
        return [round(x, 4) for x in xs]

    def mean(xs):
        return float(np.mean(xs))

    # f32, the gate: identical ids, the kernel engine and a right program
    # against the plain engine; each planted fault must differ
    kernel32, _ = free_ids(net32, True, 0)
    plain32, _ = free_ids(net32, False, 0)
    reord32, _ = free_ids(net32, False, 0, reordered_sums)
    identical = kernel32 == plain32
    right32 = reord32 == plain32
    log(f"serving gate f32, prompt seed 0: kernel ids identical to plain "
        f"{identical} (per request {rounded(agreement(kernel32, plain32))})"
        f"; plain with reordered sums identical {right32}")
    near_tie_report(net32, prompts, kernel32, plain32, "f32 seed 0")

    # bf16, a report: the main run's free-running agreement with the
    # plain engine at prompt seed 0
    kernel16 = [r.tokens for r in results]
    plain16, plain_wall = free_ids(net, False, 0)
    per = agreement(kernel16, plain16)
    log(f"serving bf16 report, prompt seed 0: free-running id agreement of "
        f"the kernel engine with the plain engine {mean(per):.4f} (per "
        f"request {rounded(per)}; no bar: on these random weights no bf16 "
        f"reading separates right programs from a planted fault); plain "
        f"engine {N_REQUESTS * N_GEN / plain_wall:.1f} tokens/s [{card}]")
    near_tie_report(net32, prompts, kernel16, plain16,
                    "bf16 seed 0, kernel vs plain")

    caught = {}
    for name, wrap in PLANTED_FAULTS.items():
        fault32, _ = free_ids(net32, False, 0, wrap)
        caught[name] = fault32 != kernel32
        log(f"serving gate, planted fault ({name}) in the plain engine: f32 "
            f"ids identical {not caught[name]} (per request "
            f"{rounded(agreement(kernel32, fault32))})")
    log(f"serving gate: f32 ids identical {identical} (right program "
        f"{right32}); planted faults rejected {caught} [{card}]")
    if not identical or not right32 or not all(caught.values()):
        raise SystemExit(
            f"chip_smoke: serving gate failed: f32 ids identical "
            f"{identical}, right program identical {right32}, planted "
            f"faults rejected {caught}")
    return launches


# LeNet: bench.py's mnist_lenet5_train_throughput row (lenet5(lr=0.002),
# bf16 compute, B=2048, 8 synthetic batches stacked into fit_scan
# windows of 64 steps, 1 + 6 set-up windows, the 0.97 gate on 4096
# synthetic test images); then 2 timed windows
LENET_B, LENET_WINDOW, LENET_SETUP, LENET_TIMED = 2048, 64, 7, 2
LENET_N_TRAIN, LENET_N_TEST, LENET_EVAL_BATCH = 8 * 2048, 4096, 1024
ACCURACY_GATE = 0.97
# card vs CPU: one set of params, 4 f32 fit steps at B=256, TF32 off;
# losses within ROADMAP's 5e-3 relative, params within max |diff|
# 1e-6 (2.98e-8 measured on an H100: summation order only)
LENET_PARITY_B, LENET_PARITY_STEPS = 256, 4
LENET_PARITY_RTOL = 5e-3
LENET_PARITY_PARAM_ATOL = 1e-6


def _lenet(lr, compute_dtype=None, device=None):
    from deeplearning4j_tpu_torch.models.zoo import lenet5
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = lenet5(lr=lr)
    if compute_dtype is not None:
        for c in conf.confs:
            c.compute_dtype = compute_dtype
    return MultiLayerNetwork(conf, device=device or DEVICE).init()


def lenet_phase(card: str, k3_ms: float) -> int:
    """Phase 7: train LeNet as bench.py does, time 2 windows, gate the
    accuracy; every K3 launch of the bf16 training and evaluate path
    must go to the tensor-core kernel. ``k3_ms`` is that kernel's time
    at this shape (kernels phase). Returns its launches over the
    training steps."""
    from deeplearning4j_tpu_torch.datasets.mnist import mnist_dataset
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention,
        paged_attention,
    )
    from deeplearning4j_tpu_torch.nn.layers.convolution import conv_taps

    net = _lenet(0.002, "bfloat16")
    ds = mnist_dataset(train=True, num_examples=LENET_N_TRAIN)
    batches = ds.batch_by(LENET_B)
    reps = -(-LENET_WINDOW // len(batches))
    feats = np.stack([b.features for b in batches] * reps)[:LENET_WINDOW]
    labels = np.stack([b.labels for b in batches] * reps)[:LENET_WINDOW]
    feats = torch.as_tensor(feats.reshape(LENET_WINDOW, LENET_B, 1, 28, 28),
                            device=DEVICE)
    labels = torch.as_tensor(labels, device=DEVICE)
    torch.cuda.synchronize()
    conv_taps.launches = conv_taps.mma_launches = 0
    flash_attention.launches = flash_attention.bwd_launches = 0
    paged_attention.launches = 0
    t0 = time.perf_counter()
    scores = [net.fit_scan(feats, labels) for _ in range(LENET_SETUP)]
    first = [float(s) for s in scores[0]]
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(LENET_TIMED):
        t0 = time.perf_counter()
        last = net.fit_scan(feats, labels)
        last_loss = [float(x) for x in last]      # syncs the window
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches, mma_launches = conv_taps.launches, conv_taps.mma_launches
    steps = (LENET_SETUP + LENET_TIMED) * LENET_WINDOW
    others = (flash_attention.launches, flash_attention.bwd_launches,
              paged_attention.launches)
    step_s = float(np.mean(walls)) / LENET_WINDOW
    test = mnist_dataset(train=False, num_examples=LENET_N_TEST,
                         as_image=True)
    conv_taps.launches = conv_taps.mma_launches = 0
    accuracy = net.evaluate(test.batch_by(LENET_EVAL_BATCH)).accuracy()
    eval_launches, eval_mma = conv_taps.launches, conv_taps.mma_launches
    falling = np.mean(last_loss) < np.mean(first)
    log(f"LeNet: lenet5(lr=0.002), bf16, B={LENET_B}; set-up "
        f"{LENET_SETUP} x {LENET_WINDOW} steps in {setup_s:.3f} s, first "
        f"window losses {first[0]:.6f} -> {first[-1]:.6f}, last timed "
        f"window {last_loss[0]:.6f} -> {last_loss[-1]:.6f}; timed windows "
        f"{[round(w, 4) for w in walls]} s: "
        f"{LENET_B / step_s:.1f} examples/s, {step_s * 1e3:.4f} ms/step; "
        f"peak memory {peak / 2**30:.3f} GiB; K3 launches {launches} over "
        f"{steps} steps ({mma_launches} on the tensor cores), "
        f"{eval_launches} over {LENET_N_TEST // LENET_EVAL_BATCH} evaluate "
        f"batches ({eval_mma} on the tensor cores); K3 "
        f"{k3_ms:.4f} ms x 1 launch a step = {k3_ms / (step_s * 1e3):.1%} "
        f"of the step; synthetic test accuracy {accuracy:.4f} (gate "
        f"{ACCURACY_GATE}) [{card}]")
    if (launches != steps or mma_launches != launches
            or others != (0, 0, 0) or eval_mma != eval_launches
            or eval_launches != LENET_N_TEST // LENET_EVAL_BATCH
            or not np.all(np.isfinite(first + last_loss)) or not falling
            or accuracy < ACCURACY_GATE):
        raise SystemExit(
            f"chip_smoke: LeNet phase failed: K3 launches {launches} (want "
            f"{steps}, tensor cores {mma_launches}), evaluate "
            f"{eval_launches} (tensor cores {eval_mma}), other kernels "
            f"{others}, "
            f"losses {first} ... {last_loss}, accuracy {accuracy}")
    del net, feats, labels
    torch.cuda.empty_cache()
    return mma_launches


def lenet_parity_phase(card: str) -> int:
    """Phase 8: one set of port params on the card and on the CPU, 4
    f32 fit steps each at B=256: the card runs K3 (the CUDA-core kernel, the
    f32 route) and cuDNN's conv2, the CPU the plain tap loop and its
    conv2. Returns K3's launches on the card."""
    from deeplearning4j_tpu_torch.datasets.mnist import mnist_dataset
    from deeplearning4j_tpu_torch.nn.layers.convolution import conv_taps

    card_net = _lenet(0.01)
    cpu_net = _lenet(0.01, device="cpu")
    for key, p in card_net.param_table().items():
        cpu_net.set_param(key, p.cpu())
    ds = mnist_dataset(train=True,
                       num_examples=LENET_PARITY_B * LENET_PARITY_STEPS,
                       as_image=True)
    batches = [(b.features, b.labels) for b in ds.batch_by(LENET_PARITY_B)]
    conv_taps.launches = conv_taps.mma_launches = 0
    card_loss, card_wall = _train(card_net, batches)
    launches, mma_launches = conv_taps.launches, conv_taps.mma_launches
    cpu_loss, _ = _train(cpu_net, batches)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_loss, cpu_loss))
    pdiff = max(float((p.cpu() - cpu_net.param_table()[k]).abs().max())
                for k, p in card_net.param_table().items())
    log(f"LeNet card vs CPU (f32, B={LENET_PARITY_B}): card losses "
        f"{[f'{x:.6f}' for x in card_loss]}, CPU "
        f"{[f'{x:.6f}' for x in cpu_loss]}; max rel diff {rel:.3e} (tol "
        f"{LENET_PARITY_RTOL}); max |param diff| {pdiff:.3e} (tol "
        f"{LENET_PARITY_PARAM_ATOL}); K3 launches {launches}; card s/step "
        f"{[round(w, 4) for w in card_wall]} [{card}]")
    if (not rel <= LENET_PARITY_RTOL or not pdiff <= LENET_PARITY_PARAM_ATOL
            or launches != LENET_PARITY_STEPS or mma_launches != 0
            or not np.all(np.isfinite(card_loss))):
        raise SystemExit(f"chip_smoke: LeNet card vs CPU failed: rel {rel},"
                         f" param diff {pdiff}, K3 launches {launches} "
                         f"({mma_launches} on the tensor cores)")
    return launches


def main() -> int:
    card = device_phase()
    build_phase()
    kernels = kernel_phase()
    flash, k1_long_ms = flash_kernel_phase()
    kernels += flash
    conv = conv_kernel_phase()
    kernels += conv
    training_parity_phase(card)
    launches = training_long_phase(card, k1_long_ms)
    launches["paged_attention"] = serving_phase(card)
    k3_ms = {k["name"]: k["ms"] for k in conv}["conv_taps"]
    launches["conv_taps"] = lenet_phase(card, k3_ms)
    launches["conv_taps_f32"] = lenet_parity_phase(card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
