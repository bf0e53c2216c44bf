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
against ``_dense_attention`` (the same dense program)."""

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
