"""K3 (``conv_taps``, LeNet's conv1 as tap accumulation) in the PyTorch
port, on the CPU.

The plain version ``conv_taps_reference`` is held against the TPU kernel
itself: ``pal_kernel``/``pallas_fwd`` of ``scripts/lenet_breakdown.py``
(a closure inside ``kernel_compare``, so this file holds its lines
verbatim and a guard test fails if they change), run under
``force_tpu_interpret_mode()`` at B = 256 on bf16 x. Both sum the 25
taps in the same order in float32 and round once to bf16, so the
outputs must be bit-identical. Then the plain version against
``F.conv2d`` at float32 (1e-5: only the summation order differs), the
autograd gradients against ``F.conv2d``'s (1e-5), the wrapper's refusals,
the shared-memory size it launches with, and ``ConvolutionImpl``'s
dispatch. The CUDA kernel itself runs only on
the card (``chip_smoke.py``)."""

import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from deeplearning4j_tpu_torch import cuda_build
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.nn.layers import convolution as tconv
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    ConvolutionImpl,
    conv_taps,
    conv_taps_reference,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "lenet_breakdown.py")
# scripts/lenet_breakdown.py:148-169, verbatim (pal_kernel, pallas_fwd)
PAL_LINES = (148, 169)
PAL_SRC = '''\
    def pal_kernel(w_ref, x_ref, o_ref):
        xb = x_ref[...].astype(jnp.float32)
        for o in range(20):
            acc = jnp.zeros((24, 24, TILE), jnp.float32)
            for dy in range(5):
                for dx in range(5):
                    acc += w_ref[o, dy, dx] * xb[dy:dy + 24,
                                                 dx:dx + 24, :]
            o_ref[o] = acc.astype(o_ref.dtype)

    def pallas_fwd(w):
        return pl.pallas_call(
            pal_kernel,
            grid=(B // TILE,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                      pl.BlockSpec((28, 28, TILE),
                                   lambda i: (0, 0, i))],
            out_specs=pl.BlockSpec((20, 24, 24, TILE),
                                   lambda i: (0, 0, 0, i)),
            out_shape=jax.ShapeDtypeStruct((20, 24, 24, B),
                                           jnp.bfloat16),
        )(w.astype(jnp.float32), x_hwb)
'''
F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _pallas_fwd(x_hwb, batch):
    """``pallas_fwd`` from the verbatim lines, with the closure's names
    (TILE = 256 as in ``kernel_compare``)."""
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, TILE=256, B=batch,
              x_hwb=x_hwb)
    exec(textwrap.dedent(PAL_SRC), ns)
    return ns["pallas_fwd"]


def test_pal_kernel_copy_is_verbatim():
    lines = open(SCRIPT).read().splitlines(keepends=True)
    lo, hi = PAL_LINES
    assert "".join(lines[lo - 1:hi]) == PAL_SRC


def _operands(rng, b, o=20, k=(5, 5), h=28, w=28):
    x = rng.normal(size=(b, 1, h, w)).astype(np.float32)
    wt = (rng.normal(size=(o,) + k) * 0.05).astype(np.float32)
    return x, wt


def test_plain_version_is_bit_identical_to_the_tpu_kernel():
    b = 256
    x, w = _operands(np.random.default_rng(0), b)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = _pallas_fwd(jnp.transpose(xj[:, 0], (1, 2, 0)), b)(wj)
    want = np.asarray(want.astype(jnp.float32)).transpose(3, 0, 1, 2)
    xt = torch.as_tensor(np.array(xj.astype(jnp.float32))).bfloat16()
    wt = torch.as_tensor(np.array(wj.astype(jnp.float32))).bfloat16()
    got = conv_taps_reference(xt, wt)
    assert got.dtype == torch.bfloat16 and got.shape == (b, 20, 24, 24)
    np.testing.assert_array_equal(got.float().numpy(), want)


CASES = {"lenet conv1": dict(k=(5, 5), padding=(0, 0)),
         "padded": dict(k=(5, 5), padding=(2, 2)),
         "3x3": dict(k=(3, 3), padding=(0, 0)),
         "7x4 uneven pad": dict(k=(7, 4), padding=(3, 1))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_conv2d(case):
    k, padding = CASES[case]["k"], CASES[case]["padding"]
    x, w = _operands(np.random.default_rng(1), 3, o=6, k=k, h=13, w=11)
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    want = F.conv2d(xt, wt[:, None], padding=padding)
    got = conv_taps_reference(xt, wt, padding)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    np.testing.assert_array_equal(conv_taps(xt, wt, padding).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_autograd_matches_conv2d_grads(case):
    k, padding = CASES[case]["k"], CASES[case]["padding"]
    rng = np.random.default_rng(2)
    x, w = _operands(rng, 3, o=6, k=k, h=13, w=11)
    want_out = F.conv2d(torch.as_tensor(x), torch.as_tensor(w)[:, None],
                        padding=padding)
    g = torch.as_tensor(rng.normal(size=want_out.shape).astype(np.float32))
    grads = {}
    for name, fn in (("conv2d", lambda a, b: F.conv2d(a, b[:, None],
                                                      padding=padding)),
                     ("taps", lambda a, b: conv_taps(a, b, padding))):
        xt = torch.as_tensor(x).requires_grad_(True)
        wt = torch.as_tensor(w).requires_grad_(True)
        grads[name] = torch.autograd.grad(fn(xt, wt), (xt, wt), g)
    for got, want in zip(grads["taps"], grads["conv2d"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


def test_weight_grad_alone_when_x_needs_none():
    """LeNet's conv1: x needs no gradient, so the backward computes dW
    only, and a bf16 W gets a bf16 dW (the wrapper's upcast is
    autograd's to undo)."""
    x, w = _operands(np.random.default_rng(3), 2, o=4, h=9, w=9)
    xt = torch.as_tensor(x).bfloat16()
    wt = torch.as_tensor(w).bfloat16().requires_grad_(True)
    out = conv_taps(xt, wt)
    assert out.dtype == torch.bfloat16
    (dw,) = torch.autograd.grad(out.float().sum(), (wt,))
    assert dw.dtype == torch.bfloat16 and dw.shape == wt.shape
    want = torch.nn.grad.conv2d_weight(xt, (4, 1, 5, 5),
                                       torch.ones_like(out))[:, 0]
    np.testing.assert_allclose(dw.float().numpy(), want.float().numpy(),
                               rtol=1e-2, atol=1e-2)


REFUSED = {
    "two input channels": ((2, 2, 9, 9), (4, 5, 5), (0, 0)),
    "kernel 8x8": ((2, 1, 9, 9), (4, 8, 8), (0, 0)),
    "w not [O, kh, kw]": ((2, 1, 9, 9), (4, 25), (0, 0)),
    "negative padding": ((2, 1, 9, 9), (4, 5, 5), (-1, 0)),
    "empty output": ((2, 1, 3, 9), (4, 5, 5), (0, 0)),
    "image past shared memory": ((1, 1, 300, 300), (4, 5, 5), (0, 0)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    xs, ws, padding = REFUSED[case]
    x, w = torch.zeros(xs), torch.zeros(ws)
    assert not tconv.takes_conv_taps(x, w, padding)
    with pytest.raises(ValueError, match="conv_taps"):
        conv_taps(x, w, padding)


def test_wrapper_refuses_other_dtypes_and_devices():
    w = torch.zeros(4, 5, 5)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conv_taps(torch.zeros(2, 1, 9, 9, dtype=torch.float16), w)
    with pytest.raises(ValueError, match="unsupported device"):
        conv_taps(torch.zeros(2, 1, 9, 9, device="meta"), w)
    assert conv_taps.launches == 0     # the CPU path counts no launch


def test_kernel_loader_builds_only_on_first_launch(monkeypatch):
    """Importing the module builds nothing; the loader asks
    ``cuda_build`` for ``csrc/conv_taps.cu`` at first launch and, with
    no ``nvcc``, raises instead of falling back."""
    assert (cuda_build.CSRC / "conv_taps.cu").exists()
    assert "conv_taps" not in cuda_build._LIBS
    asked = []

    def fake_load(name):
        asked.append(name)
        raise RuntimeError("nvcc not found")

    tconv._conv_taps_lib.cache_clear()
    monkeypatch.setattr(cuda_build, "load", fake_load)
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            tconv._conv_taps_lib()
    finally:
        tconv._conv_taps_lib.cache_clear()
    assert asked == ["conv_taps"]


@pytest.mark.parametrize("xs,ws,padding", [
    ((3, 1, 28, 28), (20, 5, 5), (0, 0)),
    ((2, 1, 28, 28), (20, 5, 5), (2, 2)),
    ((1, 1, 9, 13), (4, 3, 7), (1, 3))])
def test_launch_passes_the_wrappers_shared_memory_size(monkeypatch, xs, ws,
                                                        padding):
    """The kernel takes its dynamic shared memory from the wrapper, so the
    size checked against the card's limit is the size launched with:
    the padded image and the weights in f32."""
    seen = []

    class FakeLib:
        def dl4j_conv_taps(self, *args):
            seen.append(args)
            return 0

    class FakeStream:
        cuda_stream = 0

    monkeypatch.setattr(tconv, "_conv_taps_lib", lambda: FakeLib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: FakeStream())
    monkeypatch.setattr(conv_taps, "launches", 0)
    x, w = torch.zeros(xs), torch.zeros(ws)
    out = tconv._conv_taps_launch(x, w, padding)
    (b, _, h, wd), (o, kh, kw), (ph, pw) = xs, ws, padding
    assert out.shape == (b, o, h + 2 * ph - kh + 1, wd + 2 * pw - kw + 1)
    (args,) = seen
    assert args[3:12] == (b, o, h, wd, kh, kw, ph, pw, 0)
    assert args[12] == 4 * ((h + 2 * ph) * (wd + 2 * pw) + o * kh * kw)
    assert args[12] == tconv.conv_taps_smem_bytes(o, h, wd, kh, kw, ph, pw)
    assert args[13] == 0        # the fixed-size path where the source has one
    assert conv_taps.launches == 1


def _conv_conf(n_in, stride=(1, 1), padding=(0, 0)):
    conf = NeuralNetConfiguration.Builder().build()
    conf.layer = L.ConvolutionLayer(n_in=n_in, n_out=3, kernel_size=(3, 3),
                                    stride=stride, padding=padding,
                                    activation="identity")
    return conf


@pytest.mark.parametrize("n_in,stride,padding,taps", [
    (1, (1, 1), (0, 0), True), (1, (1, 1), (1, 1), True),
    (1, (2, 2), (0, 0), False), (2, (1, 1), (0, 0), False)])
def test_convolution_dispatch(monkeypatch, n_in, stride, padding, taps):
    """Single-input-channel stride-1 convs go to K3's wrapper, the rest
    to ``F.conv2d``; either way the output is the conv."""
    calls = []
    real = tconv.conv_taps

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tconv, "conv_taps", spy)
    conf = _conv_conf(n_in, stride, padding)
    params = ConvolutionImpl.init(torch.Generator().manual_seed(0), conf)
    x = torch.randn(2, n_in, 8, 8, generator=torch.Generator().manual_seed(1))
    out, _ = ConvolutionImpl.apply(conf, params, x)
    want = F.conv2d(x, params["W"], params["b"], stride=stride,
                    padding=padding)
    assert len(calls) == int(taps)
    np.testing.assert_allclose(out.numpy(), want.numpy(), **F32_TOL)
