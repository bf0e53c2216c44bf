"""K1 (flash attention) of the PyTorch port on the CPU.

The kernel itself (``csrc/flash_attention.cu``) runs only on the card,
where ``chip_smoke.py`` holds it against :func:`flash_attention_reference`.
Here the plain version and its autograd gradients are held against the
JAX package's real Pallas kernel run in interpret mode
(``force_tpu_interpret_mode``), and, at ragged T the Pallas kernel does
not take, against the JAX ``_dense_attention``; the dispatch rule is
checked against the JAX package's for the values they share.

Tolerances (float32): 2e-5 on outputs and 1e-4 on gradients against the
interpreted kernel (blocked online softmax vs one dense softmax); 1e-5
against ``_dense_attention`` (the same dense program).

The float32 kernels compute in split TF32; a CPU model of their products
(below) is scored with ``chip_smoke``'s own measures against its f32
limits, and their split pass's plain version (``f32_operands_reference``)
is checked for the layout the kernels read."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deeplearning4j_tpu.nn.layers.attention import (
    _dense_attention as j_dense,
    _flash_attention as j_flash,
    _should_use_flash as j_should,
)

from deeplearning4j_tpu_torch.nn.layers import attention as tattn
from deeplearning4j_tpu_torch.nn.layers.attention import (
    _dense_attention as t_dense,
    _should_use_flash,
    flash_attention,
    flash_attention_reference,
)
from torch_port_threads import one_torch_thread  # noqa: F401


def _inputs(t, dh, seed=0, b=1, h=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, dh)).astype(np.float32)
            for _ in range(4)]          # q, k, v, dO


def _jax_vjp(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _torch_vjp(fn, q, k, v, do):
    ts = [torch.as_tensor(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.as_tensor(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("t", [256, 512])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_reference_matches_interpreted_pallas_kernel(t, dh, causal):
    q, k, v, do = _inputs(t, dh, seed=t + dh)
    with pltpu.force_tpu_interpret_mode():
        want, want_g = _jax_vjp(lambda a, b, c: j_flash(a, b, c, causal),
                                q, k, v, do)
    got, got_g = _torch_vjp(
        lambda a, b, c: flash_attention_reference(a, b, c, causal),
        q, k, v, do)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    for name, g, w in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("t", [200, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_reference_matches_dense_at_ragged_t(t, causal):
    q, k, v, do = _inputs(t, 64, seed=t, b=2)
    want, want_g = _jax_vjp(lambda a, b, c: j_dense(a, b, c, causal, None),
                            q, k, v, do)
    got, got_g = _torch_vjp(
        lambda a, b, c: flash_attention(a, b, c, causal), q, k, v, do)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_wrapper_takes_the_plain_version_on_cpu_without_launching():
    q, k, v, _ = (torch.as_tensor(a) for a in _inputs(64, 64))
    before = (flash_attention.launches, flash_attention.bwd_launches)
    np.testing.assert_array_equal(
        flash_attention(q, k, v, True).numpy(),
        flash_attention_reference(q, k, v, True).numpy())
    assert (flash_attention.launches,
            flash_attention.bwd_launches) == before


def test_reference_computes_in_f32_and_returns_q_dtype():
    q, k, v, _ = (torch.as_tensor(a) for a in _inputs(96, 64))
    out = flash_attention_reference(q.bfloat16(), k.bfloat16(),
                                    v.bfloat16(), True)
    assert out.dtype == torch.bfloat16
    want = flash_attention_reference(q.bfloat16().float(),
                                     k.bfloat16().float(),
                                     v.bfloat16().float(), True)
    np.testing.assert_array_equal(out.float().numpy(),
                                  want.bfloat16().float().numpy())


def test_reference_uses_the_exact_scale():
    """The kernel's multiplier is dh**-0.5 exactly; the dense path
    divides by sqrt(dh) in q's dtype (the same at f32)."""
    q, k, v, _ = (torch.as_tensor(a) for a in _inputs(48, 128))
    np.testing.assert_allclose(
        flash_attention_reference(q, k, v, True).numpy(),
        t_dense(q, k, v, True, None).numpy(), atol=1e-6)


def test_use_flash_true_raises_off_the_card_like_jax():
    q = torch.zeros(1, 2, 256, 64)
    with pytest.raises(ValueError, match="CUDA"):
        _should_use_flash(True, q, None)
    with pytest.raises(ValueError):
        j_should(True, jnp.zeros((1, 2, 256, 64)), None)


@pytest.mark.parametrize("toggle", [False, None])
def test_dispatch_on_cpu_takes_dense(toggle):
    q = torch.zeros(1, 2, 4096, 64)
    assert _should_use_flash(toggle, q, None) is False
    assert bool(j_should(toggle, jnp.zeros((1, 2, 4096, 64)), None)) is False


def test_dispatch_rejects_unknown_values():
    with pytest.raises(ValueError, match="expected None, True or False"):
        _should_use_flash("interpret", torch.zeros(1, 1, 8, 64), None)


def test_auto_threshold_and_kernel_shapes():
    assert tattn.FLASH_HEAD_DIMS == (64, 128)
    assert 512 <= tattn.FLASH_MIN_T <= 16384


def _on_card(t, dtype, dh=128):
    """A stand-in for a CUDA q of shape [1, 2, t, dh]: what the
    dispatch reads (device, shape, dtype) without a card."""
    import types

    return types.SimpleNamespace(device=torch.device("cuda"),
                                 shape=(1, 2, t, dh), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_auto_dispatch_takes_the_one_threshold_for_each_dtype(dtype):
    """Auto mode takes K1 on the card from :data:`FLASH_MIN_T` on, for
    bf16 and f32 alike (one threshold: the f32 sweep supports the bf16
    value), dense below it; an explicit True takes K1 at any length."""
    at = tattn.FLASH_MIN_T
    assert _should_use_flash(None, _on_card(at, dtype), None) is True
    assert _should_use_flash(None, _on_card(at - 1, dtype), None) is False
    assert _should_use_flash(None, _on_card(4 * at, dtype), None) is True
    assert _should_use_flash(True, _on_card(1, dtype), None) is True
    assert _should_use_flash(False, _on_card(4 * at, dtype), None) is False


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_auto_dispatch_refuses_what_the_kernel_does_not_take(dtype):
    t = tattn.FLASH_MIN_T
    mask = torch.ones(1, t)
    assert _should_use_flash(None, _on_card(t, dtype), mask) is False
    assert _should_use_flash(None, _on_card(t, dtype, 32), None) is False
    assert _should_use_flash(None, _on_card(t, torch.float16), None) is False
    with pytest.raises(ValueError, match="float32/bfloat16"):
        _should_use_flash(True, _on_card(t, dtype, 32), None)


def test_attend_core_routes_through_dispatch(monkeypatch):
    """With the dispatch patched to K1, the layer's training forward
    goes through :func:`flash_attention` (its plain version on CPU),
    and builds no prefill cache."""
    seen = []
    monkeypatch.setattr(tattn, "_should_use_flash",
                        lambda use_flash, q, mask: True)
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a: seen.append(a[0].shape) or real(*a))
    lc = tattn.MultiHeadSelfAttention(n_in=8, n_out=8, n_heads=2)
    q, k, v, _ = (torch.as_tensor(a) for a in _inputs(16, 4))
    o, state = tattn.AttentionImpl._attend_core(lc, q, k, v, None, True,
                                                None)
    assert seen == [q.shape] and state is None
    np.testing.assert_allclose(
        o.numpy(), t_dense(q, k, v, True, None).numpy(), atol=1e-6)


def _c_prototypes():
    """{name: [kind, ...]} of the ``extern "C"`` functions of
    ``csrc/flash_attention.cu``: each parameter's kind is "pointer",
    "int" or "float"."""
    import re

    from deeplearning4j_tpu_torch import cuda_build

    src = (cuda_build.CSRC / "flash_attention.cu").read_text()
    block = src[src.index('extern "C" {'):]
    protos = {}
    for name, params in re.findall(r"\b(dl4j_\w+)\(([^)]*)\)\s*\{", block):
        kinds = []
        for p in params.split(","):
            p = " ".join(p.split())
            kinds.append("pointer" if "*" in p else p.split()[0])
        protos[name] = kinds
    return protos


_CTYPE_KINDS = {"c_void_p": "pointer", "c_int": "int", "c_float": "float"}


@pytest.mark.parametrize("name", ["dl4j_flash_attention_fwd",
                                  "dl4j_flash_attention_bwd",
                                  "dl4j_flash_attention_split",
                                  "dl4j_flash_error_string"])
def test_ctypes_binding_matches_the_c_prototypes(monkeypatch, name):
    """``_flash_lib`` declares each C function's parameters in the
    count and kinds the source gives them (a pointer passed as a ctypes
    int would be cut to 32 bits)."""
    import types

    from deeplearning4j_tpu_torch import cuda_build

    fake = types.SimpleNamespace(**{n: types.SimpleNamespace()
                                    for n in _c_prototypes()})
    tattn._flash_lib.cache_clear()
    monkeypatch.setattr(cuda_build, "load", lambda lib: fake)
    try:
        lib = tattn._flash_lib()
    finally:
        tattn._flash_lib.cache_clear()
    declared = [_CTYPE_KINDS[t.__name__] for t in getattr(lib, name).argtypes]
    assert declared == _c_prototypes()[name]


def _misaligned(shape, dtype):
    """A contiguous view whose data starts 2 bytes past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    flat = torch.arange(n + 8, dtype=torch.float32).to(dtype)
    view = flat[1:n + 1].view(shape)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    return view


@pytest.mark.parametrize("layout", ["aligned", "misaligned", "transposed"])
def test_kernel_ready_gives_what_tma_reads(layout):
    """The kernels read q/k/v/dO through TMA tensor maps over a
    contiguous [B*H, T, dh] tensor: its base 16-byte aligned and its
    row stride dh * itemsize (a multiple of 16 for dh in 64, 128)."""
    shape = (1, 2, 8, 64)
    if layout == "aligned":
        a = torch.randn(shape).bfloat16()
    elif layout == "misaligned":
        a = _misaligned(shape, torch.bfloat16)
    else:
        a = torch.randn(1, 2, 64, 8).bfloat16().transpose(2, 3)
    r = tattn._kernel_ready(a)
    assert r.is_contiguous() and r.data_ptr() % 16 == 0
    assert r.stride(2) * r.element_size() % 16 == 0
    assert torch.equal(r, a)
    if layout == "aligned":
        assert r.data_ptr() == a.data_ptr()     # no copy when none is due


def test_autograd_wrapper_hands_the_kernels_ready_tensors(monkeypatch):
    """``_FlashAttention`` passes contiguous, 16-byte aligned q, k, v
    to the forward launch and the same, with dO, to the backward,
    whatever layout it was given."""
    seen = {}

    def fake_fwd(q, k, v, causal):
        seen["fwd"] = (q, k, v)
        o = flash_attention_reference(q, k, v, causal)
        return o, torch.zeros(q.shape[:3])

    def fake_bwd(q, k, v, o, lse, do, causal):
        seen["bwd"] = (q, k, v, do)
        return q * 0, k * 0, v * 0

    monkeypatch.setattr(tattn, "flash_attention_fwd", fake_fwd)
    monkeypatch.setattr(tattn, "flash_attention_bwd", fake_bwd)
    shape = (1, 2, 8, 64)
    q = _misaligned(shape, torch.bfloat16).requires_grad_(True)
    k = torch.randn(1, 2, 64, 8).bfloat16().transpose(2, 3)
    k.requires_grad_(True)
    v = torch.randn(shape).bfloat16().requires_grad_(True)
    out = tattn._FlashAttention.apply(q, k, v, True)
    out.backward(torch.randn(1, 2, 64, 8).bfloat16().transpose(2, 3))
    for tensors in seen.values():
        for t in tensors:
            assert t.is_contiguous() and t.data_ptr() % 16 == 0
    assert len(seen) == 2


# ---- K1's float32 route: split TF32, and the operands its split pass
# prepares

def _tf32_truncate(x):
    """x cut to TF32 toward zero (its low 13 bits cleared)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_mm(a, b, mode):
    """a @ b as K1's f32 kernels compute it, emulated in float32 on the
    CPU: "split" is big = tf32(x), small = tf32(x - big) per operand and
    As Bb + Ab Bs + Ab Bb (the kernels' three products); "split_trunc"
    the same with big cut toward zero; "single" is one product of the
    operands rounded to tf32 (plain TF32)."""
    big = _tf32_truncate if mode == "split_trunc" else tattn.tf32_round
    ab, bb = big(a), big(b)
    if mode == "single":
        return ab @ bb
    as_, bs = tattn.tf32_round(a - ab), tattn.tf32_round(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def _k1_f32_model(q, k, v, do, causal, mode):
    """K1's forward and backward with every product through
    :func:`_split_mm`: S = Q Kᵀ, O = P V / l, then from the LSE
    P, dP = dO Vᵀ, dS = P (dP - Di), dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS K.
    Returns (O, (dQ, dK, dV))."""
    t, dh = q.shape[-2:]
    scale = dh ** -0.5
    s = _split_mm(q, k.transpose(-1, -2), mode) * scale
    if causal:
        keep = torch.tril(torch.ones(t, t, dtype=torch.bool))
        s = torch.where(keep, s, torch.tensor(-1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_ = p.sum(-1, keepdim=True)
    o = _split_mm(p, v, mode) / l_
    p = torch.exp(s - (m + torch.log(l_)))
    ds = p * (_split_mm(do, v.transpose(-1, -2), mode)
              - (do * o).sum(-1, keepdim=True))
    return o, (_split_mm(ds, k, mode) * scale,
               _split_mm(ds.transpose(-1, -2), q, mode) * scale,
               _split_mm(p.transpose(-1, -2), do, mode))


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_split_tf32_meets_the_f32_limits_and_single_tf32_does_not(dh,
                                                                  causal):
    """The CPU model that chose the f32 kernels' split: three products
    (no small x small term) pass every measure of
    ``chip_smoke.FLASH_TOL[float32]`` against a float64 reference, with
    the norm under a fifth of its limit, whether big is rounded to
    nearest (what the kernels do: it needs no assumption about what the
    tensor cores make of an operand's low 13 bits) or cut toward zero; a
    single TF32 product misses the norm limit, so the limits still tell
    the two apart."""
    import chip_smoke

    q, k, v, do = (torch.as_tensor(a) for a in _inputs(256, dh, seed=dh))
    q64, k64, v64 = (a.double().requires_grad_(True) for a in (q, k, v))
    ref = flash_attention_reference(q64, k64, v64, causal)
    ref_grads = torch.autograd.grad(ref, (q64, k64, v64), do.double())
    readings = {}
    for mode in ("split", "split_trunc", "single"):
        out, grads = _k1_f32_model(q, k, v, do, causal, mode)
        errs = chip_smoke._flash_errors(out, grads, ref.detach(), ref_grads)
        readings[mode] = (errs, chip_smoke._flash_failed(errs,
                                                         torch.float32))
    for mode in ("split", "split_trunc"):
        errs, failed = readings[mode]
        assert failed == [], (mode, errs)
        limit = chip_smoke.FLASH_TOL[torch.float32]["norm"]
        assert max(errs["norm"]) < limit / 5, (mode, errs)
    assert "norm" in readings["single"][1], readings["single"][0]


def test_tf32_round_is_round_to_nearest_ties_away():
    """:func:`tf32_round` keeps 10 mantissa bits, rounding to nearest
    with ties away from zero (``cvt.rna.tf32.f32``)."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2 ** -20, 1 + 1.5 * ulp,
                      -(1 + ulp / 2), 3.0, 0.0, -0.0, 2 ** -100],
                     dtype=torch.float32)
    want = [1 + ulp, 1.0, 1 + 2 * ulp, -(1 + ulp), 3.0, 0.0, -0.0,
            2 ** -100]
    got = tattn.tf32_round(x)
    assert got.tolist() == want
    assert not bool((got.view(torch.int32) & 0x1FFF).any())


def test_split_planes_hold_big_and_small_tf32_parts():
    """The rows planes: big = tf32(x), small = tf32(x - big), each with
    its low 13 bits clear, their sum within 2^-21 of x."""
    x = torch.as_tensor(_inputs(21, 64, seed=3, b=2)[0])
    flat = tattn.f32_operands_reference(x, True, False)
    n = x.numel()
    assert flat.numel() == tattn.f32_operand_floats(x.shape, True, False)
    big, small = flat[:n].view(x.shape), flat[n:].view(x.shape)
    torch.testing.assert_close(big, tattn.tf32_round(x), rtol=0, atol=0)
    assert not bool((flat.view(torch.int32) & 0x1FFF).any())
    assert float(((big + small - x).abs() / x.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("t", [1, 8, 13, 77])
def test_transposed_planes_hold_each_8_rows_in_the_kernels_order(t):
    """The transposed planes [2][B*H][dh][Tp]: Tp = T rounded up to 8,
    position p of each 8 holds row F32_ROW_ORDER[p] of those 8 (the
    kernels read an accumulator's columns 2j and 2j + 1 as k = j and
    j + 4), zeros past T."""
    b, h, dh = 1, 2, 64
    x = torch.as_tensor(_inputs(t, dh, seed=t, b=b, h=h)[0])
    tp = tattn.f32_padded_t(t)
    assert tp % 8 == 0 and t <= tp < t + 8
    flat = tattn.f32_operands_reference(x, False, True)
    assert flat.numel() == tattn.f32_operand_floats(x.shape, False, True)
    big = flat[:b * h * dh * tp].view(b * h, dh, tp)
    rows = tattn.tf32_round(x).view(b * h, t, dh)
    assert tattn.F32_ROW_ORDER == (0, 2, 4, 6, 1, 3, 5, 7)
    for pos in range(tp):
        src = pos - pos % 8 + tattn.F32_ROW_ORDER[pos % 8]
        want = rows[:, src] if src < t else torch.zeros(b * h, dh)
        assert torch.equal(big[:, :, pos], want), pos


@pytest.mark.parametrize("t", [1, 77, 2048, 2049])
def test_split_planes_meet_the_tma_alignment_rules(t):
    """What the kernels' tensor maps need of the prepared operands:
    every plane starts 16-byte aligned past the buffer's start, and each
    plane's row stride (dh or Tp floats) is a multiple of 16 bytes."""
    b, h = 2, 8
    for dh in (64, 128):
        rows_bytes = 4 * tattn.f32_operand_floats((b, h, t, dh), True,
                                                   False)
        plane = b * h * t * dh * 4
        cols_plane = b * h * dh * tattn.f32_padded_t(t) * 4
        assert rows_bytes == 2 * plane
        assert plane % 16 == 0 and cols_plane % 16 == 0
        assert (dh * 4) % 16 == 0
        assert (tattn.f32_padded_t(t) * 4) % 16 == 0


def test_split_wrapper_passes_the_planes_where_the_kernels_read_them(
        monkeypatch):
    """``f32_operands`` makes one launch for all its operands: one buffer
    of their ``f32_operand_floats``, each operand's rows planes at its
    start and its transposed planes right after them (null where not
    asked for), every pointer 16-byte aligned, with x's B, H, T, dh."""
    import types

    calls = []

    def split(xs, rows, cols, n, *shape):
        calls.append(([xs[i] for i in range(n)], [rows[i] for i in range(n)],
                      [cols[i] for i in range(n)], n, shape))
        return 0

    monkeypatch.setattr(tattn, "_flash_lib", lambda: types.SimpleNamespace(
        dl4j_flash_attention_split=split))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    modes = [(True, True), (True, False), (False, True), (True, True)]
    xs = [torch.zeros(2, 3, 13, 64) for _ in modes]
    outs = tattn.f32_operands([(x, r, c) for x, (r, c) in zip(xs, modes)])
    (xp, rows_p, cols_p, n, shape), = calls
    assert n == 4 and shape[:4] == (2, 3, 13, 64)
    assert xp == [x.data_ptr() for x in xs]
    base = outs[0].data_ptr()
    for i, (out, (r, c)) in enumerate(zip(outs, modes)):
        assert out.dtype == torch.float32
        assert out.numel() == tattn.f32_operand_floats(xs[i].shape, r, c)
        assert out.data_ptr() == base + 4 * sum(o.numel() for o in outs[:i])
        skip = 4 * tattn.f32_operand_floats(xs[i].shape, True, False)
        assert rows_p[i] == (out.data_ptr() if r else None)
        assert cols_p[i] == (out.data_ptr() + (skip if r else 0)
                             if c else None)
        for p in (rows_p[i], cols_p[i]):
            assert p is None or p % 16 == 0
