"""The CNN slice of the PyTorch port (LeNet-5 on MNIST) against the JAX
package, on the CPU.

Shape inference and the conf JSON; every preprocessor's forward; the
dense, convolution and pooling impls; the data path (IDX decoding, the
synthetic MNIST stand-in, iterators); and LeNet itself from ONE
JAX-built net carried into the port through a model zip: ``output``,
``feed_forward``, ``predict``, ``evaluate``, 4-step NESTEROVS ``fit``
and ``fit_scan`` trajectories, resuming a JAX checkpoint, and zips both
ways. conv1 runs through ``conv_taps``, which on the CPU is its plain
version (the tap loop); conv2 through ``F.conv2d``.

Tolerances: 1e-4 for float32 forwards and params (the two frameworks
sum in different orders), 5e-3 relative on loss trajectories (ROADMAP's
training bar), bit-equal for data and the conf JSON; at bf16 compute
the argmax classes agree on at least 90% of images (bf16 rounds at
other places in the two frameworks)."""

import gzip
import struct
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import iterator as jiter
from deeplearning4j_tpu.datasets import mnist as jmnist
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.native_rt import lib as jnative
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf import preprocessors as jpp
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.layers import convolution as jconv
from deeplearning4j_tpu.nn.layers import dense as jdense
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.util import model_serializer as jser

from deeplearning4j_tpu_torch.datasets import iterator as titer
from deeplearning4j_tpu_torch.datasets import mnist as tmnist
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.native_rt import lib as tnative
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration as TNNC
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpp
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TInputType
from deeplearning4j_tpu_torch.nn.layers import convolution as tconv
from deeplearning4j_tpu_torch.nn.layers import dense as tdense
from deeplearning4j_tpu_torch.nn.layers.base import apply_dropconnect
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.util import model_serializer as tser

TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 5e-3
PARAM_ATOL = 1e-4
ARGMAX_BF16 = 0.9


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


# ------------------------------------------------------ shape inference
JAX_PKG = types.SimpleNamespace(L=JL, NNC=JNNC, InputType=JInputType,
                                zoo=jzoo)
PORT_PKG = types.SimpleNamespace(L=TL, NNC=TNNC, InputType=TInputType,
                                 zoo=tzoo)


def _small_cnn(pkg):
    """conv (padded) - avg pool (padded) - dense - output, shapes from
    ``cnn_input_size`` (the other set_input_type spelling)."""
    return (pkg.NNC.Builder().seed(3).list()
            .layer(0, pkg.L.ConvolutionLayer(
                n_out=4, kernel_size=(3, 3), padding=(1, 1)))
            .layer(1, pkg.L.SubsamplingLayer(
                pooling_type=pkg.L.PoolingType.AVG,
                kernel_size=(3, 3), stride=(2, 2), padding=(1, 1)))
            .layer(2, pkg.L.DenseLayer(n_out=7, activation="relu"))
            .layer(3, pkg.L.OutputLayer(n_out=3, activation="softmax"))
            .cnn_input_size(9, 9, 2).build())


def _ff(pkg):
    return (pkg.NNC.Builder().list()
            .layer(0, pkg.L.DenseLayer(n_out=5))
            .layer(1, pkg.L.OutputLayer(n_out=2))
            .set_input_type(pkg.InputType.feed_forward(11)).build())


CONFS = {
    "lenet5": lambda pkg: pkg.zoo.lenet5(),
    "lenet5 32x32x3": lambda pkg: pkg.zoo.lenet5(32, 32, 3, n_classes=4),
    "mlp": lambda pkg: pkg.zoo.mlp(),
    "padded cnn": _small_cnn,
    "feed-forward": _ff,
}


@pytest.mark.parametrize("name", sorted(CONFS))
def test_shape_inference_gives_the_jax_conf_json(name):
    build = CONFS[name]
    assert build(PORT_PKG).to_json() == build(JAX_PKG).to_json()


def test_lenet5_gets_its_flatten_at_layer_4():
    conf = tzoo.lenet5()
    pps = {k: type(v).__name__ for k, v in conf.input_preprocessors.items()}
    assert pps == {"4": "CnnToFeedForwardPreProcessor"}
    assert [getattr(c.layer, "n_in", None) for c in conf.confs] == [
        1, None, 20, None, 800, 500]


# --------------------------------------------------------- preprocessors
def _pp_cases():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(4, 3, 5, 2)).astype(np.float32)
    seq = rng.normal(size=(2, 6, 3)).astype(np.float32)
    flat = rng.normal(size=(6, 30)).astype(np.float32)
    return {
        "CnnToFeedForwardPreProcessor": ((5, 2, 3), {}, img),
        "FeedForwardToCnnPreProcessor": ((5, 2, 3), {}, flat),
        "FeedForwardToCnnPreProcessor 4-d": ((5, 2, 3), {}, img),
        "RnnToFeedForwardPreProcessor": ((), {}, seq),
        "FeedForwardToRnnPreProcessor": ((2,), {}, flat),
        "CnnToRnnPreProcessor": ((5, 2, 3, 2), {}, img),
        "RnnToCnnPreProcessor": ((1, 3, 2), {}, seq),
        "ReshapePreProcessor": ((), {"shape": (6, 5, 6)}, flat),
        "ZeroMeanPrePreProcessor": ((), {}, flat),
        "ZeroMeanAndUnitVariancePreProcessor": ((), {}, flat),
        "UnitVarianceProcessor": ((), {}, flat),
        "BinomialSamplingPreProcessor": ((), {}, flat),
        "ComposableInputPreProcessor": ((), {}, img),
    }


@pytest.mark.parametrize("name", sorted(_pp_cases()))
def test_preprocessor_forward_matches(name):
    args, kw, x = _pp_cases()[name]
    cls = name.split()[0]
    if cls == "ComposableInputPreProcessor":
        jp = jpp.ComposableInputPreProcessor(components=(
            jpp.CnnToFeedForwardPreProcessor(), jpp.ZeroMeanPrePreProcessor()))
        tp = tpp.ComposableInputPreProcessor(components=(
            tpp.CnnToFeedForwardPreProcessor(), tpp.ZeroMeanPrePreProcessor()))
    else:
        jp = getattr(jpp, cls)(*args, **kw)
        tp = getattr(tpp, cls)(*args, **kw)
    want = np.asarray(jp.pre_process(jnp.asarray(x)))
    got = tp.pre_process(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_binomial_sampling_in_distribution():
    """Bernoulli draws from the generator given: the mean of many draws
    tracks the probabilities; no generator is the identity."""
    p = torch.linspace(0.0, 1.0, 11).repeat(4000, 1)
    pp = tpp.BinomialSamplingPreProcessor()
    assert pp.pre_process(p) is p
    s = pp.pre_process(p, torch.Generator().manual_seed(0))
    assert set(s.unique().tolist()) <= {0.0, 1.0}
    np.testing.assert_allclose(s.mean(0).numpy(), p[0].numpy(), atol=0.03)
    again = pp.pre_process(p, torch.Generator().manual_seed(0))
    assert torch.equal(s, again)
    assert s[:, 0].sum() == 0 and s[:, -1].sum() == 4000


# ---------------------------------------------------------- layer impls
def _confs(layer_kw, kind, **conf_kw):
    out = []
    for nnc, layers in ((JNNC, JL), (TNNC, TL)):
        c = nnc.Builder().build()
        for k, v in conf_kw.items():
            setattr(c, k, v)
        kw = dict(layer_kw)
        if "pooling_type" in kw:
            kw["pooling_type"] = layers.PoolingType(kw["pooling_type"])
        c.layer = getattr(layers, kind)(**kw)
        out.append(c)
    return out


def _params(rng, **shapes):
    return {k: rng.normal(size=s).astype(np.float32) * 0.3
            for k, s in shapes.items()}


def _apply_both(jimpl, timpl, confs, params, x):
    jc, tc = confs
    jo, _ = jimpl.apply(jc, {k: jnp.asarray(v) for k, v in params.items()},
                        jnp.asarray(x))
    to, _ = timpl.apply(tc, {k: torch.as_tensor(v)
                             for k, v in params.items()}, torch.as_tensor(x))
    return np.asarray(jo), to.numpy()


@pytest.mark.parametrize("impl", ["DenseImpl", "OutputImpl"])
def test_dense_apply_matches(impl):
    rng = np.random.default_rng(1)
    confs = _confs(dict(n_in=6, n_out=4, activation="tanh"),
                   "DenseLayer" if impl == "DenseImpl" else "OutputLayer")
    p = _params(rng, W=(6, 4), b=(4,))
    x = rng.normal(size=(5, 6)).astype(np.float32)
    want, got = _apply_both(getattr(jdense, impl), getattr(tdense, impl),
                            confs, p, x)
    np.testing.assert_allclose(got, want, **TOL)


def test_output_loss_matches():
    rng = np.random.default_rng(2)
    confs = _confs(dict(n_in=6, n_out=4, activation="softmax"),
                   "OutputLayer")
    a = rng.dirichlet(np.ones(4), size=5).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 5)]
    want = jdense.OutputImpl.loss(confs[0], jnp.asarray(a), jnp.asarray(y))
    got = tdense.OutputImpl.loss(confs[1], torch.as_tensor(a),
                                 torch.as_tensor(y))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_dropconnect_masks_weights_in_distribution():
    w = torch.ones(200, 200)
    out = apply_dropconnect(w, 0.25, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.75))
    assert apply_dropconnect(w, 0.25, None) is w


CONV = {"conv1 (K3)": dict(n_in=1, n_out=5, kernel_size=(5, 5)),
        "conv1 padded (K3)": dict(n_in=1, n_out=5, kernel_size=(3, 3),
                                  padding=(2, 1)),
        "conv2 (conv2d)": dict(n_in=3, n_out=4, kernel_size=(5, 5)),
        "strided padded (conv2d)": dict(n_in=2, n_out=4, kernel_size=(3, 3),
                                        stride=(2, 2), padding=(1, 1))}


@pytest.mark.parametrize("name", sorted(CONV))
def test_convolution_apply_matches(name):
    kw = dict(CONV[name], activation="relu")
    rng = np.random.default_rng(3)
    kh, kw_ = kw["kernel_size"]
    p = _params(rng, W=(kw["n_out"], kw["n_in"], kh, kw_), b=(kw["n_out"],))
    x = rng.normal(size=(3, kw["n_in"], 12, 11)).astype(np.float32)
    want, got = _apply_both(jconv.ConvolutionImpl, tconv.ConvolutionImpl,
                            _confs(kw, "ConvolutionLayer"), p, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("padding", [(0, 0), (1, 2)])
@pytest.mark.parametrize("pooling", ["max", "avg", "sum"])
def test_subsampling_apply_matches(pooling, padding):
    """``lax.reduce_window``'s padding: -inf for MAX, zeros counted in
    AVG's kh*kw divisor; (1, 2) pads past half of a 2-wide window, which
    the torch pools' own padding refuses."""
    kw = dict(pooling_type=pooling, kernel_size=(3, 2), stride=(2, 1),
              padding=padding)
    x = np.random.default_rng(4).normal(size=(2, 3, 7, 6)).astype(
        np.float32)
    want, got = _apply_both(jconv.SubsamplingImpl, tconv.SubsamplingImpl,
                            _confs(kw, "SubsamplingLayer"), {}, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


# -------------------------------------------------------------- the data
@pytest.mark.parametrize("train", [True, False])
def test_synthetic_mnist_is_array_equal(train):
    ji, jl = jmnist._synthetic_mnist(300, train)
    ti, tl = tmnist._synthetic_mnist(300, train)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)
    assert ti.dtype == ji.dtype == np.uint8


def _write_idx(path, arr, code):
    head = struct.pack(">HBB", 0, code, arr.ndim)
    body = struct.pack(">" + "I" * arr.ndim, *arr.shape)
    data = head + body + arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(data)


def test_mnist_from_idx_files_matches(tmp_path, monkeypatch):
    """Real IDX files under ``$DL4J_TPU_DATA_DIR/mnist`` (one gzipped)
    are what both packages load, the same arrays."""
    rng = np.random.default_rng(5)
    root = tmp_path / "mnist"
    root.mkdir()
    imgs = rng.integers(0, 256, (20, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, 20).astype(np.uint8)
    _write_idx(str(root / "t10k-images-idx3-ubyte.gz"), imgs, 0x08)
    _write_idx(str(root / "t10k-labels-idx1-ubyte"), labels, 0x08)
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    jd = jmnist.mnist_dataset(train=False, num_examples=12, as_image=True)
    td = tmnist.mnist_dataset(train=False, num_examples=12, as_image=True)
    np.testing.assert_array_equal(td.features, jd.features)
    np.testing.assert_array_equal(td.labels, jd.labels)
    np.testing.assert_array_equal(np.rint(td.features[:, 0] * 255),
                                  imgs[:12])


@pytest.mark.parametrize("dtype,code", [(np.int16, 0x0B), (np.float32, 0x0D),
                                        (np.float64, 0x0E)])
def test_read_idx_element_types_match(tmp_path, dtype, code):
    a = np.arange(24, dtype=dtype).reshape(2, 3, 4) - 5
    path = str(tmp_path / "a.idx")
    _write_idx(path, a, code)
    np.testing.assert_array_equal(tnative.read_idx(path),
                                  jnative.read_idx(path))
    np.testing.assert_array_equal(tnative.read_idx(path), a)


def test_ingest_transforms_match():
    u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(tnative.u8_to_f32(u8),
                                  jnative.u8_to_f32(u8))
    ids = np.array([[3, 0], [9, 2]])
    np.testing.assert_array_equal(tnative.one_hot(ids, 10),
                                  jnative.one_hot(ids, 10))
    with pytest.raises(ValueError, match="outside"):
        tnative.one_hot(np.array([10]), 10)


def _batches(it):
    return [(d.features.copy(), d.labels.copy()) for d in it]


def test_iterators_match():
    ds = tmnist.mnist_dataset(train=True, num_examples=50)
    jds = jmnist.mnist_dataset(train=True, num_examples=50)
    pairs = [(titer.BaseDataSetIterator(16, ds),
              jiter.BaseDataSetIterator(16, jds)),
             (titer.ListDataSetIterator([ds], batch_size=20),
              jiter.ListDataSetIterator([jds], batch_size=20)),
             (titer.AsyncDataSetIterator(titer.BaseDataSetIterator(16, ds)),
              jiter.AsyncDataSetIterator(
                  jiter.BaseDataSetIterator(16, jds)))]
    for t, j in pairs:
        got, want = _batches(t), _batches(j)
        assert len(got) == len(want) > 1
        for (gf, gl), (wf, wl) in zip(got, want):
            np.testing.assert_array_equal(gf, wf)
            np.testing.assert_array_equal(gl, wl)
        assert len(_batches(t)) == len(got)        # reset() rewinds


# --------------------------------------------------------------- LeNet-5
def _lenet_pair(tmp_path, lr=0.01, seed=12345):
    jnet = JNet(jzoo.lenet5(lr=lr, seed=seed)).init()
    path = str(tmp_path / "lenet.zip")
    jser.write_model(jnet, path)
    return jnet, tser.restore_model(path, device="cpu")


def _mnist(n, train=True, start=0):
    ds = jmnist.mnist_dataset(train=train, num_examples=start + n,
                              as_image=True)
    return ds.features[start:], ds.labels[start:]


def _assert_params_close(tnet, jnet, atol=PARAM_ATOL):
    for key, p in jnet.param_table().items():
        np.testing.assert_allclose(_np(tnet.param_table()[key]),
                                   np.asarray(p), atol=atol, rtol=0,
                                   err_msg=key)


def test_jax_lenet_output_matches_at_f32(tmp_path):
    jnet, tnet = _lenet_pair(tmp_path)
    x, _ = _mnist(16, train=False)
    want = np.asarray(jnet.output(x))
    got = tnet.output(x).numpy()
    assert got.shape == want.shape == (16, 10)
    np.testing.assert_allclose(got, want, **TOL)
    for a, b in zip(tnet.feed_forward(x), jnet.feed_forward(x)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)
    np.testing.assert_array_equal(tnet.predict(x), np.asarray(
        jnet.predict(x)))


def test_jax_lenet_argmax_agrees_at_bf16(tmp_path):
    jnet, tnet = _lenet_pair(tmp_path)
    x, _ = _mnist(256, train=False)
    jc = jzoo.lenet5(lr=0.01)
    for c in jc.confs:
        c.compute_dtype = "bfloat16"
    jb = JNet(jc).init()
    jb.params = jnet.params
    for c in tnet.conf.confs:
        c.compute_dtype = "bfloat16"
    tb = TNet(tnet.conf, device="cpu").init()
    tser.load_numpy_params(tb, {si: {k: _np(v) for k, v in sub.items()}
                                for si, sub in tnet.params.items()})
    out = tb.output(x)
    assert out.dtype == torch.float32          # the f32 head
    agree = np.mean(out.argmax(1).numpy() == np.asarray(
        jb.output(x)).argmax(1))
    assert agree >= ARGMAX_BF16


def test_lenet_fit_trajectory_matches_jax(tmp_path):
    jnet, tnet = _lenet_pair(tmp_path)
    x, y = _mnist(64)
    jl, tl = [], []
    for s in range(4):
        f, l_ = x[16 * s:16 * s + 16], y[16 * s:16 * s + 16]
        jnet.fit(f, l_)
        tnet.fit(f, l_)
        jl.append(float(jnet.score_value))
        tl.append(float(tnet.score_value))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_params_close(tnet, jnet)
    assert tnet.iteration == jnet.iteration == 4
    for si in jnet.updater_state:
        for k, v in jnet.updater_state[si]["v"].items():
            np.testing.assert_allclose(_np(tnet.updater_state[si]["v"][k]),
                                       np.asarray(v), atol=PARAM_ATOL)


def test_lenet_fit_scan_takes_stacked_images(tmp_path):
    """``fit_scan`` over [K, B, 1, 28, 28] features unchanged, as
    bench.py feeds it; the telemetry counts images as examples (and as
    tokens, never B*H)."""
    jnet, tnet = _lenet_pair(tmp_path)
    x, y = _mnist(48)
    feats, labels = x.reshape(3, 16, 1, 28, 28), y.reshape(3, 16, 10)
    js = np.asarray(jnet.fit_scan(feats, labels))
    ts = _np(tnet.fit_scan(feats, labels))
    np.testing.assert_allclose(ts, js, rtol=LOSS_RTOL)
    _assert_params_close(tnet, jnet)
    assert tnet.train_telemetry.examples == 48
    assert tnet.train_telemetry.tokens == 48


def test_evaluate_accuracy_equals_jax(tmp_path):
    jnet, tnet = _lenet_pair(tmp_path)
    x, y = _mnist(64)
    for s in range(2):
        jnet.fit(x[32 * s:32 * s + 32], y[32 * s:32 * s + 32])
        tnet.fit(x[32 * s:32 * s + 32], y[32 * s:32 * s + 32])
    tx, ty = _mnist(96, train=False)
    jev = jnet.evaluate([JDataSet(tx[:48], ty[:48]),
                         JDataSet(tx[48:], ty[48:])])
    tev = tnet.evaluate(titer.ListDataSetIterator(
        [DataSet(tx[:48], ty[:48]), DataSet(tx[48:], ty[48:])]))
    assert tev.accuracy() == jev.accuracy()
    np.testing.assert_array_equal(tev.confusion.matrix, jev.confusion.matrix)
    assert tev.confusion.total() == 96


def test_resume_lenet_from_jax_checkpoint(tmp_path):
    """NESTEROVS' velocity and the iteration carry over: a JAX zip
    written mid-training resumes in the port on the JAX trajectory."""
    jnet = JNet(jzoo.lenet5(lr=0.01)).init()
    x, y = _mnist(64)
    for s in range(2):
        jnet.fit(x[16 * s:16 * s + 16], y[16 * s:16 * s + 16])
    path = str(tmp_path / "mid.zip")
    jser.write_model(jnet, path)
    tnet = tser.restore_model(path, device="cpu")
    assert tnet.iteration == 2
    for si in jnet.updater_state:
        for k, v in jnet.updater_state[si]["v"].items():
            np.testing.assert_array_equal(
                _np(tnet.updater_state[si]["v"][k]), np.asarray(v))
    jl, tl = [], []
    for s in range(2, 4):
        f, l_ = x[16 * s:16 * s + 16], y[16 * s:16 * s + 16]
        jnet.fit(f, l_)
        tnet.fit(f, l_)
        jl.append(float(jnet.score_value))
        tl.append(float(tnet.score_value))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_params_close(tnet, jnet)


def test_port_lenet_zip_loads_in_jax(tmp_path):
    tnet = TNet(tzoo.lenet5(lr=0.01), device="cpu").init()
    x, y = _mnist(16)
    tnet.fit(x, y)
    path = str(tmp_path / "port.zip")
    tnet.save(path)
    jnet = jser.restore_model(path)
    assert jnet.conf.to_json() == tnet.conf.to_json()
    assert jnet.iteration == 1
    tt, jt = tnet.param_table(), jnet.param_table()
    assert sorted(jt) == sorted(tt)
    for k in tt:
        np.testing.assert_array_equal(_np(tt[k]), np.asarray(jt[k]))
    np.testing.assert_allclose(np.asarray(jnet.output(x)),
                               tnet.output(x).numpy(), **TOL)


def test_mlp_fit_matches_jax(tmp_path):
    jnet = JNet(jzoo.mlp(sizes=(784, 32, 10))).init()
    path = str(tmp_path / "mlp.zip")
    jser.write_model(jnet, path)
    tnet = tser.restore_model(path, device="cpu")
    ds = jmnist.mnist_dataset(train=True, num_examples=48)
    for b in ds.batch_by(16):
        jnet.fit(b.features, b.labels)
        tnet.fit(b.features, b.labels)
        assert float(tnet.score_value) == pytest.approx(
            float(jnet.score_value), rel=LOSS_RTOL)
    _assert_params_close(tnet, jnet)
