"""Convolution + subsampling (pooling) layers.

Port of ``deeplearning4j_tpu/nn/layers/convolution.py``. Layouts as in
the JAX package: activations [N, C, H, W], kernels [O, I, kH, kW]
(OIHW).

``ConvolutionImpl`` dispatches by shape before any launch: a
single-input-channel, stride-1 conv whose taps and padded image K3
takes goes to :func:`conv_taps` (a CUDA kernel of ``csrc/conv_taps.cu``
on the card, chosen by dtype and shape: the tensor-core kernel for bf16
x with bf16 W, the CUDA-core kernel for the rest;
:func:`conv_taps_reference` on the CPU); every other conv
(LeNet's conv2, 20 -> 50) goes to ``torch.nn.functional.conv2d``, as the
JAX package leaves every conv to XLA. ``SubsamplingImpl`` keeps
``lax.reduce_window``'s padding semantics: MAX pads with -inf, SUM and
AVG with zeros, and AVG divides by kh*kw, padding included.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import cuda_build
from deeplearning4j_tpu_torch.nn.conf.layers import PoolingType
from deeplearning4j_tpu_torch.nn.layers.base import LayerImplBase
from deeplearning4j_tpu_torch.nn.weights import init_weights

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest kh and kw K3 takes
CONV_TAPS_MAX_K = 7


def conv_taps_reference(x, w, padding=(0, 0)):
    """Plain PyTorch version of K3: ``out[b, o, i, j] = Σ w[o, dy, dx] ·
    xp[b, 0, i + dy, j + dx]`` over the zero-padded x, one tap at a time
    in dy-major, dx-minor order with a float32 accumulator (as
    ``scripts/lenet_breakdown.py:pal_kernel`` sums), returned in x's
    dtype. x [B, 1, H, W], w [O, kh, kw]."""
    ph, pw = padding
    o, kh, kw = w.shape
    xf = x[:, 0].float()
    if ph or pw:
        xf = F.pad(xf, (pw, pw, ph, ph))
    b, hp, wp = xf.shape
    ho, wo = hp - kh + 1, wp - kw + 1
    wf = w.float()
    acc = torch.zeros((b, o, ho, wo), dtype=torch.float32, device=x.device)
    for dy in range(kh):
        for dx in range(kw):
            acc = acc + (wf[None, :, dy, dx, None, None]
                         * xf[:, None, dy:dy + ho, dx:dx + wo])
    return acc.to(x.dtype)


def conv_taps_image_stride(hw: int, x_bytes: int) -> int:
    """Elements from one of x's images to the next as K3's kernels land
    them: H*W rounded up to a whole number of 16 bytes (one bulk copy an
    image, which needs 16-byte sizes and addresses)."""
    per = 16 // x_bytes
    return -(-hw // per) * per


def _landed_images(x):
    """Contiguous x [B, 1, H, W] as [B, stride] rows at
    :func:`conv_taps_image_stride`, 16-byte aligned, and the stride: x
    itself where H*W is a whole number of 16 bytes and x is aligned,
    else a zero-padded or aligned copy."""
    b, _, h, wd = x.shape
    hw = h * wd
    stride = conv_taps_image_stride(hw, x.element_size())
    xs = x.reshape(b, hw)
    if stride != hw:
        xs = F.pad(xs, (0, stride - hw))
    elif xs.data_ptr() % 16:
        xs = xs.clone()
    return xs, stride


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


#: the CUDA-core kernel's plan: at most this many images in its ring
#: (``kFfmaStages`` in ``csrc/conv_taps.cu``), and at most this many
#: bytes in its two output buffers together
CONV_TAPS_STAGES = 4
CONV_TAPS_OUT_BUDGET = 98304


def conv_taps_smem_bytes(o, h, w, kh, kw, ph, pw, x_bytes, stages,
                         piece_rows) -> int:
    """Shared memory one launch of K3's CUDA-core kernel needs, in the
    kernel's layout (``FfmaLayout`` in ``csrc/conv_taps.cu``) for x of
    ``x_bytes`` an element, a ring of ``stages`` images and output
    buffers of ``piece_rows`` channel-rows [c, i, :]: an mbarrier a
    stage (to 16 bytes); W in f32, each channel's taps zero-padded to
    whole float4s; the ring's landed images at
    :func:`conv_taps_image_stride`, each followed by 16 zero floats when
    the strips read it where it lands (f32 x, no padding), else the
    zero-padded f32 image and 16 zero floats; and 2 output buffers in
    x's dtype. With ``stages`` 0 (no ring, no staging) the zero-padded
    f32 image and W alone. The one formula for it: :func:`conv_taps_plan`
    fits it to a block, and the launch, passed this size, refuses less
    than the layout takes."""
    hp, wp = h + 2 * ph, w + 2 * pw
    wo = wp - kw + 1
    if stages == 0:
        return 4 * (hp * wp + o * kh * kw)
    direct = x_bytes == 4 and not (ph or pw)
    land = (x_bytes * conv_taps_image_stride(h * w, x_bytes)
            + (4 * 16 if direct else 0))
    pimg = 0 if direct else 4 * (_round4(hp * wp) + 16)
    return (_round16(8 * stages) + 4 * o * _round4(kh * kw) + stages * land
            + pimg + 2 * _round16(piece_rows * wo * x_bytes))


def conv_taps_plan(o, h, w, kh, kw, ph, pw, x_bytes):
    """(stages, piece_rows) of K3's CUDA-core kernel for this image: the
    deepest ring up to :data:`CONV_TAPS_STAGES` images, then the most
    channel-rows an output buffer holds, up to the whole image and
    :data:`CONV_TAPS_OUT_BUDGET` over both buffers, at which one block's
    shared memory (``cuda_build.SMEM_PER_BLOCK``) still holds at least
    one row. Where no ring does, ``(0, O * Ho)``: no ring and no staging,
    in the bytes of the zero-padded f32 image and W alone."""
    ho, wo = h + 2 * ph - kh + 1, w + 2 * pw - kw + 1
    row = wo * x_bytes
    cap = min(o * ho, max(1, CONV_TAPS_OUT_BUDGET // (2 * row)))
    for stages in range(CONV_TAPS_STAGES, 0, -1):
        free = cuda_build.SMEM_PER_BLOCK - conv_taps_smem_bytes(
            o, h, w, kh, kw, ph, pw, x_bytes, stages, 0)
        rows = min(cap, max(free, 0) // 2 // 16 * 16 // row)
        if rows >= 1:
            return stages, rows
    return 0, o * ho


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def conv_taps_mma_smem_bytes(o, h, w, kh, kw, ph, pw) -> int:
    """Shared memory one launch of K3's tensor-core kernel needs, in the
    kernel's layout (``MmaLayout`` in ``csrc/conv_taps.cu``): two
    mbarriers and two counters (32 bytes), the fix-up list (512 entries
    of 4 bytes), W's bf16 bits, a ring of 2 landed images (each at x's
    padded image stride), the zero-padded image when padding > 0, a zero
    region as large as the padded image after each image buffer that is
    read, and 2 bf16 output buffers [O, Ho*Wo]. The one formula for it:
    the wrapper routes a shape that needs more than a block has to the
    CUDA-core kernel, and passes this size to the launch, which refuses
    less than the layout takes."""
    hp, wp = h + 2 * ph, w + 2 * pw
    npix = (hp - kh + 1) * (wp - kw + 1)
    zeros = _round8(hp * wp)
    padded = bool(ph or pw)
    land = _round8(h * w) + (0 if padded else zeros)
    pimg = 2 * zeros if padded else 0
    return 32 + 4 * 512 + 2 * (_round8(o * kh * kw) + 2 * land + pimg
                               + 2 * _round8(o * npix))


def conv_taps_route(x, w, padding) -> str:
    """Which kernel :func:`conv_taps` launches for CUDA operands it
    takes: ``"mma"`` (the tensor-core kernel) for bf16 x with bf16 w at
    a shape whose staging fits one block's shared memory, else
    ``"ffma"`` (the CUDA-core kernel, w upcast to float32)."""
    if x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        o, kh, kw = w.shape
        smem = conv_taps_mma_smem_bytes(o, x.shape[2], x.shape[3], kh, kw,
                                        *padding)
        if smem <= cuda_build.SMEM_PER_BLOCK:
            return "mma"
    return "ffma"


def _conv_taps_problem(x, w, padding):
    """Why K3 does not take these operands, or None when it does."""
    if x.ndim != 4 or x.shape[1] != 1:
        return f"x {tuple(x.shape)} must be [B, 1, H, W]"
    if w.ndim != 3:
        return f"w {tuple(w.shape)} must be [O, kh, kw]"
    if x.dtype not in _DTYPE_CODES:
        return f"x dtype {x.dtype}; the kernel takes float32 or bfloat16"
    if not w.is_floating_point():
        return f"w dtype {w.dtype} is not floating"
    if w.device != x.device:
        return f"w is on {w.device}, x on {x.device}"
    b, _, h, wd = x.shape
    o, kh, kw = w.shape
    ph, pw = padding
    if not 1 <= kh <= CONV_TAPS_MAX_K or not 1 <= kw <= CONV_TAPS_MAX_K:
        return f"kernel {kh}x{kw} outside 1..{CONV_TAPS_MAX_K}"
    if ph < 0 or pw < 0:
        return f"padding {padding} is negative"
    if min(b, o, h, wd) < 1 or h + 2 * ph < kh or wd + 2 * pw < kw:
        return (f"x {tuple(x.shape)}, w {tuple(w.shape)}, padding "
                f"{padding} give an empty output")
    if conv_taps_route(x, w, padding) == "ffma":
        el = x.element_size()
        smem = conv_taps_smem_bytes(o, h, wd, kh, kw, ph, pw, el,
                                    *conv_taps_plan(o, h, wd, kh, kw, ph,
                                                    pw, el))
        if smem > cuda_build.SMEM_PER_BLOCK:
            return (f"the CUDA-core kernel's padded image and weights "
                    f"need {smem} bytes of shared memory (limit "
                    f"{cuda_build.SMEM_PER_BLOCK})")
    return None


def takes_conv_taps(x, w, padding) -> bool:
    """Whether :func:`conv_taps` takes x [B, 1, H, W] and w [O, kh, kw]
    at this padding."""
    return _conv_taps_problem(x, w, padding) is None


@functools.cache
def _conv_taps_lib():
    """The conv-taps library, built at first use, with its functions'
    ctypes signatures set."""
    return bind_conv_taps(cuda_build.load("conv_taps"))


def bind_conv_taps(lib):
    """Set the ctypes signatures of a loaded conv-taps library's
    functions; returns the library."""
    lib.dl4j_conv_taps.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12
        + [ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p])
    lib.dl4j_conv_taps.restype = ctypes.c_int
    lib.dl4j_conv_taps_mma.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
        + [ctypes.c_size_t, ctypes.c_void_p])
    lib.dl4j_conv_taps_mma.restype = ctypes.c_int
    lib.dl4j_conv_taps_error_string.argtypes = [ctypes.c_int]
    lib.dl4j_conv_taps_error_string.restype = ctypes.c_char_p
    return lib


def _conv_taps_launch(x, w, padding, guarded=False):
    """K3's CUDA-core kernel on contiguous CUDA x and f32 w; counted in
    ``conv_taps.launches``. The kernel lands each image with one bulk
    copy (:func:`_landed_images`). ``guarded`` runs the any-size path
    even where the source has a fixed-size one (5x5), so the two can be
    timed against each other."""
    b, _, h, wd = x.shape
    o, kh, kw = w.shape
    ph, pw = padding
    xs, stride = _landed_images(x)
    lib = _conv_taps_lib()
    out = torch.empty((b, o, h + 2 * ph - kh + 1, wd + 2 * pw - kw + 1),
                      dtype=x.dtype, device=x.device)
    el = x.element_size()
    plan = conv_taps_plan(o, h, wd, kh, kw, ph, pw, el)
    smem = conv_taps_smem_bytes(o, h, wd, kh, kw, ph, pw, el, *plan)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.dl4j_conv_taps(xs.data_ptr(), w.data_ptr(), out.data_ptr(), b,
                             o, h, wd, kh, kw, ph, pw, _DTYPE_CODES[x.dtype],
                             stride, *plan, smem, int(guarded), stream)
    _raise_on(lib, err, "conv_taps")
    conv_taps.launches += 1
    return out


def _raise_on(lib, err, name):
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({lib.dl4j_conv_taps_error_string(err).decode()})")


def _conv_taps_mma_launch(x, w, padding):
    """K3's tensor-core kernel on contiguous CUDA bf16 x and bf16 w;
    counted in ``conv_taps.launches`` and ``conv_taps.mma_launches``.
    The kernel lands each image with one bulk copy
    (:func:`_landed_images`)."""
    b, _, h, wd = x.shape
    o, kh, kw = w.shape
    ph, pw = padding
    xs, stride = _landed_images(x)
    lib = _conv_taps_lib()
    out = torch.empty((b, o, h + 2 * ph - kh + 1, wd + 2 * pw - kw + 1),
                      dtype=x.dtype, device=x.device)
    smem = conv_taps_mma_smem_bytes(o, h, wd, kh, kw, ph, pw)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.dl4j_conv_taps_mma(xs.data_ptr(), w.data_ptr(),
                                 out.data_ptr(), b, o, h, wd, kh, kw, ph, pw,
                                 stride, smem, stream)
    _raise_on(lib, err, "conv_taps (tensor cores)")
    conv_taps.launches += 1
    conv_taps.mma_launches += 1
    return out


def _conv_taps_kernel(x, w, padding):
    """K3 on the card: the kernel :func:`conv_taps_route` names, with w
    in its own dtype for the tensor-core kernel and upcast to float32
    for the CUDA-core one."""
    if conv_taps_route(x, w, padding) == "mma":
        return _conv_taps_mma_launch(x.contiguous(), w.contiguous(), padding)
    return _conv_taps_launch(x.contiguous(), w.float().contiguous(), padding)


class _ConvTaps(torch.autograd.Function):
    """K3 under autograd. The forward is a kernel on the card (by
    :func:`conv_taps_route`) and the plain version on the CPU; the
    backward is torch ops on both, as the JAX package leaves conv1's
    gradient to XLA: dW by ``torch.nn.grad.conv2d_weight``, in w's own
    dtype, dX by ``conv2d_input`` only when x needs it (LeNet's conv1
    input does not). Being torch ops over the saved x and w, the
    backward is itself differentiable, so a double backward (a
    Hessian-vector product) through K3 is exact; unlike K1's it is not
    marked once differentiable."""

    @staticmethod
    def forward(ctx, x, w, ph, pw):
        if x.device.type == "cpu":
            out = conv_taps_reference(x, w, (ph, pw))
        else:
            out = _conv_taps_kernel(x, w, (ph, pw))
        ctx.save_for_backward(x, w)
        ctx.padding = (ph, pw)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        w4 = w[:, None]
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(
                x, w4.shape, g, padding=ctx.padding)[:, 0].to(w.dtype)
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(
                x.shape, w4.to(g.dtype), g, padding=ctx.padding).to(x.dtype)
        return dx, dw, None, None


def conv_taps(x, w, padding=(0, 0)):
    """K3: single-input-channel convolution as tap accumulation, stride
    1, zero padding ``(ph, pw)`` on each side. The CUDA kernel of
    ``csrc/conv_taps.cu`` for CUDA tensors, :func:`conv_taps_reference`
    for CPU tensors; differentiable in x and w on both.

    x [B, 1, H, W] in float32 or bfloat16; w [O, kh, kw] in a floating
    dtype, kept (so a bf16 w reaches the tensor-core kernel and gets a
    bf16 gradient), kh and kw <= 7, within one block's shared memory in
    the layout of the kernel :func:`conv_taps_route` names; anything
    else raises. Output [B, O, Ho, Wo] in x's dtype, allocated per call;
    kernel launches go on the current stream and count in
    ``conv_taps.launches``, those of the tensor-core kernel also in
    ``conv_taps.mma_launches``. No fallback: a kernel that fails to
    build or launch raises."""
    padding = tuple(int(p) for p in padding)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_taps: unsupported device {x.device}")
    if x.device.type == "cuda":
        cuda_build.refuse_tracing("K3 conv_taps (csrc/conv_taps.cu)", x)
    problem = _conv_taps_problem(x, w, padding)
    if problem is not None:
        raise ValueError(f"conv_taps: {problem}")
    return _ConvTaps.apply(x, w, *padding)


conv_taps.launches = 0
conv_taps.mma_launches = 0


class ConvolutionImpl(LayerImplBase):
    @classmethod
    def init(cls, gen, conf, dtype=torch.float32, device="cpu") -> dict:
        lc = conf.layer
        kh, kw = lc.kernel_size
        w = init_weights(gen, (lc.n_out, lc.n_in, kh, kw),
                         conf.resolved("weight_init"),
                         conf.resolved("dist"), dtype, device)
        b = torch.full((lc.n_out,), float(conf.resolved("bias_init")),
                       dtype=dtype, device=device)
        return {"W": w, "b": b}

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        lc = conf.layer
        x = cls.maybe_dropout(conf, x, train, rng)
        w = params["W"]
        padding = tuple(int(p) for p in lc.padding)
        if (w.shape[1] == 1 and tuple(lc.stride) == (1, 1)
                and takes_conv_taps(x, w[:, 0], padding)):
            z = conv_taps(x, w[:, 0], padding)
        else:
            z = F.conv2d(x, w, stride=tuple(lc.stride), padding=padding)
        z = z + params["b"][None, :, None, None]
        return cls.activation_of(conf)(z), state


class SubsamplingImpl(LayerImplBase):
    """Parameter-free spatial pooling with ``lax.reduce_window``'s
    padding: the pad is explicit, so any padding works (the torch
    pools' own padding stops at half the kernel)."""

    @classmethod
    def apply(cls, conf, params, x, state=None, train=False, rng=None,
              mask=None):
        lc = conf.layer
        kh, kw = lc.kernel_size
        ph, pw = lc.padding
        window, stride = (kh, kw), tuple(lc.stride)
        if lc.pooling_type == PoolingType.MAX:
            if ph or pw:
                x = F.pad(x, (pw, pw, ph, ph), value=float("-inf"))
            return F.max_pool2d(x, window, stride), state
        if lc.pooling_type in (PoolingType.SUM, PoolingType.AVG):
            if ph or pw:
                x = F.pad(x, (pw, pw, ph, ph))
            div = 1 if lc.pooling_type == PoolingType.SUM else kh * kw
            return F.avg_pool2d(x, window, stride,
                                divisor_override=div), state
        raise ValueError(f"Unknown pooling type {lc.pooling_type}")
