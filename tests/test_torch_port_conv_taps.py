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
dispatch. For the two CUDA kernels (the tensor-core one for bf16 x with
bf16 W, the CUDA-core one for the rest): which one the card-side
dispatch launches, with fake libraries; the tensor-core kernel's
shared-memory formula against the source's layout and the card's
limits; each ctypes binding against its C prototype; and, in a model of
the tensor cores' summation order, the ordered fix-up that holds the
kernel to the plain version's bf16 rounding. The CUDA kernels themselves
run only on the card (``chip_smoke.py``)."""

import ctypes
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
    only, and a bf16 W gets a bf16 dW (the backward casts dW to W's own
    dtype)."""
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


# -- the two CUDA kernels: dispatch, layout, bindings, rounding ---------

def _fake_kernels(monkeypatch):
    """Fake conv-taps library recording which entry each launch calls
    and with what; the launchers run on CPU tensors through it."""
    calls = []

    class FakeLib:
        def dl4j_conv_taps(self, *args):
            calls.append(("ffma", args))
            return 0

        def dl4j_conv_taps_mma(self, *args):
            calls.append(("mma", args))
            return 0

    class FakeStream:
        cuda_stream = 0

    monkeypatch.setattr(tconv, "_conv_taps_lib", lambda: FakeLib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: FakeStream())
    monkeypatch.setattr(conv_taps, "launches", 0)
    monkeypatch.setattr(conv_taps, "mma_launches", 0)
    return calls


ROUTES = {
    "bf16 x, bf16 W": ((3, 1, 28, 28), (20, 5, 5), torch.bfloat16,
                       torch.bfloat16, (0, 0), "mma"),
    "bf16 x, bf16 W, 7x7 pad 3": ((2, 1, 13, 11), (6, 7, 7),
                                  torch.bfloat16, torch.bfloat16, (3, 3),
                                  "mma"),
    "f32 x, f32 W": ((3, 1, 28, 28), (20, 5, 5), torch.float32,
                     torch.float32, (0, 0), "ffma"),
    "bf16 x, f32 W": ((3, 1, 28, 28), (20, 5, 5), torch.bfloat16,
                      torch.float32, (0, 0), "ffma"),
    "f32 x, bf16 W": ((3, 1, 28, 28), (20, 5, 5), torch.float32,
                      torch.bfloat16, (0, 0), "ffma"),
    # two output buffers of 128 x 576 bf16: past one block
    "bf16, staging past shared memory": ((2, 1, 28, 28), (128, 5, 5),
                                         torch.bfloat16, torch.bfloat16,
                                         (0, 0), "ffma"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_card_dispatch_picks_the_kernel_by_dtype_and_shape(monkeypatch,
                                                           case):
    """bf16 x with bf16 W at a shape whose staging fits goes to the
    tensor-core entry with W as it is; anything else to the CUDA-core entry
    with W upcast to float32. Decided before any launch, counted per
    route."""
    xs, ws, xd, wd, padding, route = ROUTES[case]
    calls = _fake_kernels(monkeypatch)
    x, w = torch.zeros(xs, dtype=xd), torch.zeros(ws, dtype=wd)
    assert tconv.takes_conv_taps(x, w, padding)
    assert tconv.conv_taps_route(x, w, padding) == route
    out = tconv._conv_taps_kernel(x, w, padding)
    (b, _, h, wd_), (o, kh, kw), (ph, pw) = xs, ws, padding
    assert out.shape == (b, o, h + 2 * ph - kh + 1, wd_ + 2 * pw - kw + 1)
    assert out.dtype == xd
    ((entry, args),) = calls
    assert entry == route
    assert conv_taps.launches == 1
    assert conv_taps.mma_launches == int(route == "mma")
    if route == "ffma":
        assert args[11] == tconv._DTYPE_CODES[xd]
        assert args[12] == tconv.conv_taps_smem_bytes(o, h, wd_, kh, kw, ph,
                                                      pw)
        return
    assert args[3:11] == (b, o, h, wd_, kh, kw, ph, pw)
    stride = -(-h * wd_ // 8) * 8       # images 16-byte aligned
    assert args[11] == stride
    assert args[12] == tconv.conv_taps_mma_smem_bytes(o, h, wd_, kh, kw, ph,
                                                      pw)
    assert len(args) == 14


def _mma_layout_bytes(src, o, h, w, kh, kw, ph, pw):
    """``MmaLayout::bytes`` of ``csrc/conv_taps.cu``, recomputed from
    the constants the source declares."""
    import re

    const = {n: int(v) for n, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}

    def r8(n):
        return (n + 7) // 8 * 8

    hp, wp = h + 2 * ph, w + 2 * pw
    npix = (hp - kh + 1) * (wp - kw + 1)
    zeros = r8(hp * wp)
    land = r8(h * w) + (0 if (ph or pw) else zeros)
    pimg = 2 * zeros if (ph or pw) else 0
    land_off = 32 + 4 * const["kFixCap"] + 2 * r8(o * kh * kw)
    pimg_off = land_off + 2 * const["kStages"] * land
    return pimg_off + 2 * pimg + 2 * const["kOutBuffers"] * r8(o * npix)


@pytest.mark.parametrize("o,h,w,kh,kw,ph,pw", [
    (20, 28, 28, 5, 5, 0, 0), (20, 28, 28, 5, 5, 2, 2),
    (6, 13, 11, 7, 4, 3, 1), (64, 27, 27, 1, 1, 0, 0),
    (40, 10, 9, 3, 3, 1, 1)])
def test_mma_shared_memory_formula_matches_the_kernels_layout(o, h, w, kh,
                                                              kw, ph, pw):
    """The wrapper's one formula is the kernel's layout, built from the
    source's own constants; at LeNet's shape it fits four blocks on an
    SM (228 KB, 1 KB reserved a block), the occupancy the kernel is
    tuned for, and a block's limit always."""
    src = (cuda_build.CSRC / "conv_taps.cu").read_text()
    want = _mma_layout_bytes(src, o, h, w, kh, kw, ph, pw)
    assert tconv.conv_taps_mma_smem_bytes(o, h, w, kh, kw, ph, pw) == want
    assert want % 16 == 0 and want <= cuda_build.SMEM_PER_BLOCK
    if (o, h, w, kh, kw, ph, pw) == (20, 28, 28, 5, 5, 0, 0):
        assert 4 * (want + 1024) <= 228 * 1024


def _c_prototypes():
    """{name: [kind, ...]} of the ``extern "C"`` functions of
    ``csrc/conv_taps.cu``: each parameter's kind is "pointer", "int",
    "float" or "size_t"."""
    import re

    src = (cuda_build.CSRC / "conv_taps.cu").read_text()
    block = src[src.index('extern "C" {'):]
    protos = {}
    for name, params in re.findall(r"\b(dl4j_\w+)\(([^)]*)\)\s*\{", block):
        protos[name] = ["pointer" if "*" in p else p.split()[0]
                        for p in params.split(",")]
    return protos


_CTYPE_KINDS = {"c_void_p": "pointer", "c_int": "int", "c_float": "float",
                ctypes.c_size_t.__name__: "size_t"}


@pytest.mark.parametrize("name", ["dl4j_conv_taps", "dl4j_conv_taps_mma",
                                  "dl4j_conv_taps_error_string"])
def test_ctypes_binding_matches_the_c_prototypes(monkeypatch, name):
    """``_conv_taps_lib`` declares each C function's parameters in the
    count and kinds the source gives them (a pointer or a size passed
    as a ctypes int would be cut to 32 bits, a float passed as an int
    would be read as garbage)."""
    import types

    protos = _c_prototypes()
    assert set(protos) == {"dl4j_conv_taps", "dl4j_conv_taps_mma",
                           "dl4j_conv_taps_error_string"}
    fake = types.SimpleNamespace(**{n: types.SimpleNamespace()
                                    for n in protos})
    tconv._conv_taps_lib.cache_clear()
    monkeypatch.setattr(cuda_build, "load", lambda lib: fake)
    try:
        lib = tconv._conv_taps_lib()
    finally:
        tconv._conv_taps_lib.cache_clear()
    declared = [_CTYPE_KINDS[t.__name__] for t in getattr(lib, name).argtypes]
    assert declared == protos[name]


def test_bf16_weight_forward_and_grads_equal_the_f32_upcast():
    """``conv_taps`` keeps a bf16 W (so the card can route it to the
    tensor cores) and, on the CPU, computes what a call with the f32
    upcast computes: the same output, and the same dx and dW, each
    in its own tensor's dtype."""
    rng = np.random.default_rng(4)
    x, w = _operands(rng, 3, o=6, h=12, w=10)
    g = torch.as_tensor(rng.normal(size=(3, 6, 10, 8)).astype(np.float32))
    res = {}
    for name, wdt in (("bf16", torch.bfloat16), ("upcast", torch.float32)):
        xt = torch.as_tensor(x).bfloat16().requires_grad_(True)
        wb = torch.as_tensor(w).bfloat16().requires_grad_(True)
        wt = wb if wdt == torch.bfloat16 else wb.float()
        out = conv_taps(xt, wt, (1, 1))
        dx, dw = torch.autograd.grad(out, (xt, wb), g.bfloat16())
        res[name] = (out, dx, dw)
    for got, want in zip(res["bf16"], res["upcast"]):
        assert got.dtype == want.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.detach().float().numpy(),
                                      want.detach().float().numpy())


def test_convolution_impl_hands_the_kernel_a_bf16_weight(monkeypatch):
    """Under ``compute_dtype="bfloat16"`` the net casts W (an f32
    master) to bf16 and ``ConvolutionImpl`` passes it on as it is, in
    training and in inference, so the card's LeNet path reaches the
    tensor-core kernel; the gradient still reaches the f32 master."""
    from deeplearning4j_tpu_torch.models.zoo import lenet5
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    seen = []
    real = tconv.conv_taps

    def spy(x, w, padding=(0, 0)):
        seen.append((x.dtype, w.dtype))
        return real(x, w, padding)

    monkeypatch.setattr(tconv, "conv_taps", spy)
    conf = lenet5(lr=0.002)
    for c in conf.confs:
        c.compute_dtype = "bfloat16"
    net = MultiLayerNetwork(conf, device="cpu").init()
    w0 = net.param_table()["0_W"].clone()
    assert w0.dtype == torch.float32
    rng = np.random.default_rng(5)
    feats = rng.random((8, 1, 28, 28)).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    net.fit(feats, labels)
    net.output(feats)
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 2
    assert not torch.equal(net.param_table()["0_W"], w0)


def _ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of the larger magnitude (as
    ``chip_smoke.py`` reads K3's bf16 limit)."""
    g, r = got.float(), want.float()
    mag = torch.maximum(g.abs(), r.abs()).clamp_min(2.0 ** -126)
    return float(((g - r).abs()
                  / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def _fix_rel() -> float:
    """The tensor-core kernel's fix-up threshold, ``kFixRel``, as
    ``csrc/conv_taps.cu`` defines it by default."""
    import re

    src = (cuda_build.CSRC / "conv_taps.cu").read_text()
    (lit,) = re.findall(r"#define DL4J_CONV_TAPS_FIX_REL (\S+)f\n", src)
    return float.fromhex(lit)


def test_reordered_sums_miss_the_ulp_limit_and_the_fix_up_restores_it():
    """Why the tensor-core kernel recomputes some outputs in order. A
    model of its sums (each k-step of 16 taps summed exactly, then added
    in f32, as an mma may) moves a few near-cancelling outputs of
    ``chip_smoke.py``'s data (rand x, 0.1 randn W, bf16) by more than
    the 1 bf16 ulp ``chip_smoke.py`` allows from the plain version.
    Recomputing, in the plain version's order, each output with |out| <
    kFixRel * sum |w x| brings every output within one ulp, at well
    under 1% of the outputs recomputed."""
    fix_rel = _fix_rel()
    assert fix_rel == 2.0 ** -10
    worst, fixed_worst, shares = 0.0, 0.0, []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        x = torch.as_tensor(rng.random((256, 1, 28, 28),
                                       dtype=np.float32)).bfloat16()
        w = torch.as_tensor(rng.normal(size=(20, 5, 5)).astype(np.float32)
                            * 0.1).bfloat16()
        ref = conv_taps_reference(x, w)
        xd, wd = x[:, 0].double(), w.double()
        terms = torch.stack([wd[None, :, dy, dx, None, None]
                             * xd[:, None, dy:dy + 24, dx:dx + 24]
                             for dy in range(5) for dx in range(5)])
        mma = terms[:16].sum(0).float() + terms[16:].sum(0).float()
        flag = mma.abs() < fix_rel * terms.abs().sum(0)
        fixed = torch.where(flag, ref.float(), mma)
        worst = max(worst, _ulps(mma.bfloat16(), ref))
        fixed_worst = max(fixed_worst, _ulps(fixed.bfloat16(), ref))
        shares.append(float(flag.double().mean()))
    assert worst > 1.0
    assert fixed_worst <= 1.0
    assert max(shares) < 0.01
