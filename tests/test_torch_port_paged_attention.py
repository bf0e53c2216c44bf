"""The paged decode attention of the PyTorch port against the JAX
package.

The port's plain version (``paged_attention_reference``, which CPU
tensors take through the ``paged_attention`` wrapper) is held against
both JAX paths of ``AttentionImpl._paged_attend``: the XLA gather
program (``use_flash_paged=False``) and the Pallas kernel in interpret
mode, as ``tests/test_serving_tp.py`` runs it. Tolerance 2e-5, the bar
of JAX's own interpret-mode test. The pool the port scatters into in
place must equal the pool JAX returns, exactly.

The port's pool carries one block more than the tables address: the
scratch block (its last, named by the cache's ``scratch``) that the
fixed-shape scatter sends dropped rows to. The test pool's scratch block
starts as NaN, so a read of it would show; the live blocks must equal
JAX's pool.

The CUDA kernel itself cannot run here (this suite imports JAX, which
the card's machine lacks): ``chip_smoke.py`` holds it against the plain
version on the card at the serving path's shapes. Here run the wrapper's
argument checks, its ctypes binding against the C prototypes, its split
count, and an emulation of the kernel's split plan and combine held
against the plain version."""

import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers.attention import (
    AttentionImpl as JAttn,
    MultiHeadSelfAttention as JBean,
)
from deeplearning4j_tpu_torch.nn.layers import attention as tatt
from deeplearning4j_tpu_torch.nn.layers.attention import (
    AttentionImpl as TAttn,
    MultiHeadSelfAttention as TBean,
    paged_attention,
    paged_attention_reference,
)

TOL = dict(atol=2e-5, rtol=2e-5)
#: the H100's SMs, on which K2's split plan was timed
H100_SMS = 132
B, H, DH, BT, TM, S_RING, NB = 4, 2, 8, 4, 16, 8, 24


def _case(t, masked, seed=0):
    """Four rows over one pool: row 0 ordinary; row 1 with a raised
    floor past a slid window; row 2 idle (nothing mapped: no valid
    key); row 3 with an unmapped and a stale ring slot. Pool block 0
    (the placeholder invalid entries read) and a free block hold NaN,
    and row 0's partly written tail block holds NaN past the span."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, t, DH)).astype(np.float32)
    k = rng.normal(size=(B, H, t, DH)).astype(np.float32)
    v = rng.normal(size=(B, H, t, DH)).astype(np.float32)
    pk = rng.normal(size=(NB, BT, H, DH)).astype(np.float32)
    pv = rng.normal(size=(NB, BT, H, DH)).astype(np.float32)
    table = np.full((B, S_RING), -1, np.int32)
    base = np.full((B, S_RING), -1, np.int32)
    floor = np.zeros(B, np.int32)
    filled = np.zeros(B, np.int32)
    free = 1 + np.random.default_rng(seed + 1).permutation(NB - 1)
    nxt = iter(free.tolist())

    def map_blocks(row, gs):
        for g in gs:
            table[row, g % S_RING] = next(nxt)
            base[row, g % S_RING] = g * BT

    filled[0] = 9
    map_blocks(0, range(0, 4))           # tail block g=2 partly written
    filled[1], floor[1] = 22, 13
    map_blocks(1, range(3, 7))
    filled[3] = 14
    map_blocks(3, range(0, 5))
    table[3, 1 % S_RING] = -1            # unmapped ring slot
    base[3, 2 % S_RING] = (2 + S_RING) * BT   # stale ring slot
    used = set(table[table >= 0].tolist())
    poisoned = [0, next(b for b in free.tolist() if b not in used)]
    for blk in poisoned:
        pk[blk] = np.nan
        pv[blk] = np.nan
    tail = table[0, 2]
    pk[tail, 1 + t:] = np.nan            # positions >= 9 + t: unwritten
    pv[tail, 1 + t:] = np.nan
    mask = None
    if masked:
        mask = np.zeros((B, t), np.float32)
        for row, n in enumerate((t, t - 1, 0, 2)):
            mask[row, :n] = 1.0
    return dict(q=q, k=k, v=v, pk=pk, pv=pv, table=table, base=base,
                floor=floor, filled=filled, mask=mask)


def _jax_attend(c, toggle):
    lc = JBean(n_in=H * DH, n_out=H * DH, n_heads=H, stream_max_t=TM,
               use_flash_paged=toggle)
    cache = {key: jnp.asarray(c[key]) for key in
             ("pk", "pv", "table", "base", "floor", "filled")}
    mask = None if c["mask"] is None else jnp.asarray(c["mask"])
    o, st = JAttn._paged_attend(lc, jnp.asarray(c["q"]),
                                jnp.asarray(c["k"]), jnp.asarray(c["v"]),
                                cache, mask)
    return np.asarray(o), {k: np.asarray(a) for k, a in st.items()}


def _with_scratch(pool):
    """The pool plus the port's scratch block (its last), NaN-filled."""
    scratch = np.full((1,) + pool.shape[1:], np.nan, pool.dtype)
    return np.concatenate([pool, scratch])


def _port_attend(c, toggle=None, with_scratch=False):
    """The port's ``_paged_attend`` on the case; the returned pool is
    cut to the live blocks (the scratch block dropped) unless
    ``with_scratch``."""
    lc = TBean(n_in=H * DH, n_out=H * DH, n_heads=H, stream_max_t=TM,
               use_flash_paged=toggle)
    cache = {key: torch.as_tensor(c[key].copy()) for key in
             ("table", "base", "floor", "filled")}
    cache["pk"] = torch.as_tensor(_with_scratch(c["pk"]))
    cache["pv"] = torch.as_tensor(_with_scratch(c["pv"]))
    cache["scratch"] = NB
    mask = None if c["mask"] is None else torch.as_tensor(c["mask"])
    o, st = TAttn._paged_attend(lc, torch.as_tensor(c["q"]),
                                torch.as_tensor(c["k"]),
                                torch.as_tensor(c["v"]), cache, mask)
    assert st["pk"] is cache["pk"] and st["pv"] is cache["pv"], (
        "the port scatters into the pool in place")
    out = {k: a.numpy() if isinstance(a, torch.Tensor) else a
           for k, a in st.items()}
    if not with_scratch:
        out["pk"], out["pv"] = out["pk"][:NB], out["pv"][:NB]
    return o.numpy(), out


CASES = [(1, False), (4, False), (4, True)]


@pytest.mark.parametrize("t,masked", CASES)
def test_plain_version_matches_the_gather_program(t, masked):
    c = _case(t, masked)
    want, jst = _jax_attend(c, False)
    got, tst = _port_attend(c)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(tst["filled"], jst["filled"])
    # the in-place scatter leaves the pool JAX returns (NaN where poisoned)
    np.testing.assert_array_equal(tst["pk"], jst["pk"])
    np.testing.assert_array_equal(tst["pv"], jst["pv"])


@pytest.mark.parametrize("t,masked", CASES)
def test_plain_version_matches_the_interpreted_pallas_kernel(t, masked):
    c = _case(t, masked)
    want, _ = _jax_attend(c, "interpret")
    got, _ = _port_attend(c)
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("t", [1, 4])
def test_row_with_no_valid_key_is_exactly_zero(t):
    got, _ = _port_attend(_case(t, False))
    assert np.all(got[2] == 0.0)


@pytest.mark.parametrize("toggle", [False, "interpret", None])
def test_every_cpu_toggle_takes_the_plain_version(toggle):
    c = _case(4, True)
    before = paged_attention.launches
    got, _ = _port_attend(c, toggle)
    ref, _ = _port_attend(c, False)
    np.testing.assert_array_equal(got, ref)
    assert paged_attention.launches == before


def test_dispatch_rule():
    cpu = torch.zeros(1)
    assert tatt._should_use_flash_paged(None, cpu)
    assert not tatt._should_use_flash_paged(False, cpu)
    assert not tatt._should_use_flash_paged("interpret", cpu)
    with pytest.raises(ValueError, match="CUDA"):
        tatt._should_use_flash_paged(True, cpu)
    with pytest.raises(ValueError, match="expected"):
        tatt._should_use_flash_paged("auto", cpu)


def _kernel_ops(t=1, dh=128, bt=16, q_dtype=torch.float32,
                kv_dtype=torch.float32, device="cpu"):
    b, h, nb, ntab = 2, 2, 8, 4
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.zeros(b, h, t, dh, dtype=q_dtype, device=device),
            torch.zeros(nb, bt, h, dh, dtype=kv_dtype, device=device),
            torch.zeros(nb, bt, h, dh, dtype=kv_dtype, device=device),
            torch.zeros(b, ntab, **i32), torch.zeros(b, ntab, **i32),
            torch.zeros(b, **i32), torch.zeros(b, **i32),
            torch.zeros(b, **i32), torch.ones(b, **i32))


@pytest.mark.parametrize("kw,match", [
    (dict(dh=32), "head dim"),
    (dict(bt=12), "power of two"),
    (dict(bt=128), "power of two"),
    (dict(q_dtype=torch.float16), "q dtype"),
    (dict(kv_dtype=torch.float64), "pool dtypes"),
])
def test_kernel_argument_checks_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        tatt._check_kernel_args(*_kernel_ops(**kw))


def test_kernel_argument_checks_accept_the_serving_shapes():
    for q_dtype in (torch.float32, torch.bfloat16):
        for dh in (64, 128):
            tatt._check_kernel_args(*_kernel_ops(t=4, dh=dh,
                                                 q_dtype=q_dtype))
    ops = list(_kernel_ops())
    ops[3] = ops[3].long()
    with pytest.raises(ValueError, match="int32"):
        tatt._check_kernel_args(*ops)
    ops = list(_kernel_ops())
    ops[1] = ops[1].transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tatt._check_kernel_args(*ops)


def _dropped_rows(c, t):
    """Chunk rows the scatter must drop: past the row's chunk length or
    in an unmapped block."""
    lengths = (np.full(B, t) if c["mask"] is None
               else (c["mask"] > 0).sum(axis=1))
    n = 0
    for r in range(B):
        for i in range(t):
            pos = c["filled"][r] + i
            n += i >= lengths[r] or c["table"][r, (pos // BT) % S_RING] < 0
    return n


def _masked_scatter(c, t):
    """The pool after the scatter the port made before its scatter had a
    fixed shape: the writable rows selected with a boolean mask, then
    ``index_put_``."""
    pk = torch.as_tensor(c["pk"].copy())
    pv = torch.as_tensor(c["pv"].copy())
    table, filled = torch.as_tensor(c["table"]), torch.as_tensor(c["filled"])
    lengths = (torch.full((B,), t) if c["mask"] is None
               else (torch.as_tensor(c["mask"]) > 0).sum(dim=1))
    pos = filled[:, None] + torch.arange(t)[None, :]
    blk = torch.gather(table, 1, ((pos // BT) % S_RING).long())
    writable = ((torch.arange(t)[None, :] < lengths[:, None])
                & (blk >= 0)).reshape(-1)
    widx = (blk * BT + pos % BT).reshape(-1)[writable].long()
    for pool, x in ((pk, c["k"]), (pv, c["v"])):
        rows = torch.as_tensor(x).transpose(1, 2).reshape(B * t, H, DH)
        pool.view(NB * BT, H, DH).index_put_((widx,), rows[writable])
    return pk.numpy(), pv.numpy()


@pytest.mark.parametrize("t,masked", [(1, False), (1, True), (4, True),
                                      (6, True)])
def test_fixed_shape_scatter_leaves_jaxs_pool_and_drops_to_scratch(t, masked):
    """Every chunk row is written: the live blocks equal the pool JAX's
    ``mode="drop"`` scatter returns and the pool the masked scatter
    leaves, bit for bit, and the dropped rows (the idle row, masked
    chunk positions) land in the scratch block alone, which no table
    maps and the attention never reads."""
    c = _case(t, masked)
    assert _dropped_rows(c, t) > 0
    want, jst = _jax_attend(c, False)
    got, tst = _port_attend(c, with_scratch=True)
    mk, mv = _masked_scatter(c, t)
    np.testing.assert_array_equal(tst["pk"][:NB], jst["pk"])
    np.testing.assert_array_equal(tst["pv"][:NB], jst["pv"])
    np.testing.assert_array_equal(tst["pk"][:NB], mk)
    np.testing.assert_array_equal(tst["pv"][:NB], mv)
    assert np.isfinite(tst["pk"][NB]).any(), "no row went to scratch"
    assert NB not in c["table"] and tst["scratch"] == NB
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("scratch", ["missing", None, -1, NB + 1, True,
                                     torch.tensor(NB)])
def test_a_paged_cache_without_a_scratch_block_is_refused(scratch):
    """A pool laid out as JAX lays it out (every block mappable, no
    scratch block named) or a cache naming a block outside the pool is
    refused before anything is written: the layer never picks a block
    of its own to drop rows into."""
    c = _case(4, True)
    lc = TBean(n_in=H * DH, n_out=H * DH, n_heads=H, stream_max_t=TM)
    cache = {key: torch.as_tensor(c[key].copy()) for key in
             ("pk", "pv", "table", "base", "floor", "filled")}
    if not isinstance(scratch, str):
        cache["scratch"] = scratch
    before = cache["pk"].clone()
    with pytest.raises(ValueError, match="scratch block"):
        TAttn._paged_attend(lc, torch.as_tensor(c["q"]),
                            torch.as_tensor(c["k"]),
                            torch.as_tensor(c["v"]), cache,
                            torch.as_tensor(c["mask"]))
    assert torch.equal(cache["pk"].view(torch.int32),
                       before.view(torch.int32))


def _kernel_operands(c):
    """The kernel's operands as ``_paged_attend`` builds them for the
    case (captured at the dispatch to ``paged_attention``)."""
    seen = {}

    def capture(*ops, tm):
        seen["ops"], seen["tm"] = ops, tm
        return paged_attention_reference(*ops, tm=tm)

    orig = tatt.paged_attention
    tatt.paged_attention = capture
    try:
        _port_attend(c)
    finally:
        tatt.paged_attention = orig
    return seen["ops"], seen["tm"]


def _splitk_emulation(ops, tm, splits):
    """K2's algorithm in torch: the split plan over each row's live
    entry range, the skip rule, per-(split, query tile) partials m, l
    and unnormalised acc (an empty one holds -1e30, 0, 0), then the
    combine over the splits in order. Returns the output in q's dtype
    and the number of empty (row, split, query tile) partials."""
    q, pk, pv, bid, bval, lo_blk, floor, filled, lengths = ops
    b, h, t, dh = q.shape
    bt, ntab = pk.shape[1], bid.shape[1]
    tq = 1 if t == 1 else tatt.PAGED_QUERY_TILE
    m = torch.full((b, h, splits, t), -1e30)
    l_ = torch.zeros(b, h, splits, t)
    acc = torch.zeros(b, h, splits, t, dh)
    pkf, pvf = pk.reshape(-1, h, dh).float(), pv.reshape(-1, h, dh).float()
    empty = 0
    for r in range(b):
        lo, fl, fi = int(lo_blk[r]), int(floor[r]), int(filled[r])
        vhi = fi + int(lengths[r])
        jlo = max(0, fl // bt - lo)
        n = max(0, min(ntab, (fi + t - 1) // bt - lo + 1) - jlo)
        for s in range(splits):
            j0, j1 = jlo + s * n // splits, jlo + (s + 1) * n // splits
            for q0 in range(0, t, tq):
                qi = list(range(q0, min(t, q0 + tq)))
                qlast = fi + qi[-1]
                live = [j for j in range(j0, j1)
                        if bval[r, j] > 0 and (lo + j + 1) * bt > fl
                        and (lo + j) * bt <= qlast]
                if not live:
                    empty += 1
                    continue
                kpos = torch.tensor([(lo + j) * bt + o for j in live
                                     for o in range(bt)])
                rows = torch.tensor([int(bid[r, j]) * bt + o for j in live
                                     for o in range(bt)])
                ek, ev = pkf[rows], pvf[rows]            # [K, H, dh]
                vlive = (kpos < vhi) & (kpos >= fl)
                ev = torch.where(vlive[:, None, None], ev, 0.0)
                qpos = fi + torch.tensor(qi)
                ok = ((kpos[None] <= qpos[:, None])
                      & (kpos[None] > qpos[:, None] - tm)
                      & (kpos[None] >= fl))              # [nq, K]
                sc = torch.einsum("hqd,khd->hqk", q[r][:, qi].float(),
                                  ek) * dh ** -0.5
                sc = torch.where(ok[None], sc, -1e30)
                mx = sc.max(dim=-1).values
                p = torch.where(ok[None], torch.exp(sc - mx[..., None]), 0.0)
                m[r, :, s, qi] = mx
                l_[r, :, s, qi] = p.sum(dim=-1)
                acc[r, :, s, qi] = torch.einsum("hqk,khd->hqd", p, ev)
    top = m.max(dim=2, keepdim=True).values
    f = torch.exp(m - top)
    den = (f * l_).sum(dim=2)
    out = (f[..., None] * acc).sum(dim=2) / torch.where(
        den == 0, 1.0, den)[..., None]
    return out.to(q.dtype), empty


@pytest.mark.parametrize("t,masked", CASES)
@pytest.mark.parametrize("splits", ["one", "wrapper", "two", "ntab"])
def test_split_plan_and_combine_match_the_plain_version(t, masked, splits):
    """The kernel's split-K algebra, emulated, gives the plain version's
    output at the plain version's tolerance for any split count; with
    as many splits as table entries some splits are empty (m = -1e30,
    l = 0, acc = 0) and add nothing; the idle row comes out exactly 0."""
    ops, tm = _kernel_operands(_case(t, masked))
    b, h, t_, _ = ops[0].shape
    ntab = ops[3].shape[1]
    n = dict(one=1, two=2, ntab=ntab,
             wrapper=tatt.paged_splits(b, h, t_, ntab, H100_SMS))[splits]
    got, empty = _splitk_emulation(ops, tm, n)
    want = paged_attention_reference(*ops, tm=tm)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert torch.all(got[2] == 0.0)
    if splits == "ntab":
        assert empty > b, "the row ranges leave splits empty"


@pytest.mark.parametrize("shape", [(8, 8, 1, 129, 132), (1, 8, 1, 129, 132),
                                   (8, 8, 4, 130, 132), (2, 2, 33, 10, 132),
                                   (1, 1, 1, 3, 132), (1, 1, 1, 1, 132),
                                   (64, 16, 1, 129, 132),
                                   (8, 8, 1, 129, 114), (1, 8, 1, 129, 78)])
def test_split_count(shape):
    """Deterministic, at least 1, never more splits than table entries,
    and enough first-pass blocks to fill the card's SMs where the table
    has the entries (and no more splits than that takes)."""
    b, h, t, ntab, sms = shape
    s = tatt.paged_splits(b, h, t, ntab, sms)
    assert s == tatt.paged_splits(b, h, t, ntab, sms)
    assert 1 <= s <= ntab
    tiles = b * h * (1 if t == 1 else -(-t // tatt.PAGED_QUERY_TILE))
    target = tatt.PAGED_BLOCKS_PER_SM * sms
    if s < ntab:
        assert tiles * s >= target
    if s > 1:
        assert tiles * (s - 1) < target


def test_split_count_at_the_serving_shapes():
    """The decode step's shapes on the H100's 132 SMs: B=8 or 1, H=8,
    t=1, window 2048 at 16 tokens a block (129 entries): 5 splits and
    320 blocks at B=8; 33 splits and 264 blocks at B=1; one split once
    B * H alone fills the card."""
    assert tatt.paged_splits(8, 8, 1, 129, H100_SMS) == 5
    assert tatt.paged_splits(1, 8, 1, 129, H100_SMS) == 33
    assert tatt.paged_splits(64, 8, 1, 129, H100_SMS) == 1


def test_the_wrapper_plans_for_the_cards_sms(monkeypatch):
    """The wrapper takes its split count from the SMs of the card its
    operands lie on, not from a constant: a card with fewer SMs gets
    fewer splits. (The launch is stubbed; nothing runs on a card.)"""
    ops, tm = _kernel_operands(_case(1, False))
    seen = []

    def launch(*a, tm, splits):
        seen.append(splits)
        return None, None

    cuda_ops = [types.SimpleNamespace(device=torch.device("cuda", 0),
                                      shape=o.shape) for o in ops]
    monkeypatch.setattr(paged_attention, "launches", 0)
    monkeypatch.setattr(tatt, "_check_kernel_args", lambda *a: None)
    monkeypatch.setattr(tatt, "_paged_attention_launch", launch)
    for sms in (132, 8):
        monkeypatch.setattr(tatt, "sm_count", lambda index, n=sms: n)
        tatt.paged_attention(*cuda_ops, tm=tm)
    b, h, t, _ = ops[0].shape
    ntab = ops[3].shape[1]
    assert seen == [tatt.paged_splits(b, h, t, ntab, 132),
                    tatt.paged_splits(b, h, t, ntab, 8)]
    assert seen[0] > seen[1] and paged_attention.launches == 2


def test_query_tile_matches_the_kernel_source():
    from deeplearning4j_tpu_torch import cuda_build

    src = (cuda_build.CSRC / "paged_attention.cu").read_text()
    assert (f"constexpr int kQueryTile = {tatt.PAGED_QUERY_TILE};"
            in src)


def _c_prototypes():
    """{name: (return kind, [parameter kind, ...])} of the ``extern
    "C"`` functions of ``csrc/paged_attention.cu``; a kind is "pointer",
    "int", "float", "size_t", "cudaError_t" or "string"."""
    import re

    from deeplearning4j_tpu_torch import cuda_build

    src = (cuda_build.CSRC / "paged_attention.cu").read_text()
    block = src[src.index('extern "C" {'):]
    protos = {}
    for ret, name, params in re.findall(
            r"^([\w *]+?)\s*\b(dl4j_\w+)\(([^)]*)\)\s*\{", block, re.M):
        ret = " ".join(ret.split())
        kinds = []
        for p in params.split(","):
            p = " ".join(p.split())
            kinds.append("pointer" if "*" in p else p.split()[0])
        protos[name] = ("string" if ret == "const char*" else ret, kinds)
    return protos


_CTYPE_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
                ctypes.c_float: "float", ctypes.c_size_t: "size_t",
                ctypes.c_char_p: "string"}


def test_c_prototypes_are_the_three_bound():
    assert sorted(_c_prototypes()) == [
        "dl4j_cuda_error_string", "dl4j_paged_attention",
        "dl4j_paged_attention_smem_bytes"]


@pytest.mark.parametrize("name", ["dl4j_paged_attention",
                                  "dl4j_paged_attention_smem_bytes",
                                  "dl4j_cuda_error_string"])
def test_ctypes_binding_matches_the_c_prototypes(monkeypatch, name):
    """``_paged_lib`` declares each C function's parameters and result
    in the count and kinds the source gives them (a pointer passed as a
    ctypes int would be cut to 32 bits; cudaError_t comes back as an
    int)."""
    from deeplearning4j_tpu_torch import cuda_build

    fake = types.SimpleNamespace(**{n: types.SimpleNamespace()
                                    for n in _c_prototypes()})
    tatt._paged_lib.cache_clear()
    monkeypatch.setattr(cuda_build, "load", lambda lib: fake)
    try:
        lib = tatt._paged_lib()
    finally:
        tatt._paged_lib.cache_clear()
    fn = getattr(lib, name)
    ret, params = _c_prototypes()[name]
    assert [_CTYPE_KINDS[t] for t in fn.argtypes] == params
    assert _CTYPE_KINDS[fn.restype] == {"cudaError_t": "int"}.get(ret, ret)


def test_kernel_argument_checks_refuse_a_misaligned_pool():
    ops = list(_kernel_ops())
    flat = torch.zeros(ops[1].numel() + 4)
    ops[1] = flat[1:1 + ops[1].numel()].view(ops[1].shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tatt._check_kernel_args(*ops)
