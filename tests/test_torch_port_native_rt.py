"""The port's native data runtime against the JAX package's.

``deeplearning4j_tpu_torch/native_rt`` binds the same C++ source
(``native/dl4j_native.cpp``) through ctypes, but builds it with ``g++``
into ``deeplearning4j_tpu_torch/_build/`` at first use; the JAX package
runs ``make`` in ``native/``. Every entry point is held against JAX's on
the same files and arguments, with the native library and with
``DL4J_TPU_DISABLE_NATIVE`` set (both packages then run their numpy
fallbacks): ``read_csv``, ``read_idx``, ``read_cifar_bin`` on the
``real_patches_batch.bin`` fixture, ``read_image_dir`` on the ``lfw``
fixture (JPEG: no netpbm, None on both) and on a netpbm tree,
``u8_to_f32``, ``one_hot``, ``mine_pairs``, ``NativeVocab.tokenize``,
``shuffle_indices`` and the ``RingBuffer``'s semantics; the build's
place and its failure; ``NativeAsyncDataSetIterator``'s order, reset,
error and ``state_dict`` against JAX's. Arrays must be equal."""

import os
import threading

import numpy as np
import pytest

import deeplearning4j_tpu.native_rt as jrt
import deeplearning4j_tpu.native_rt.lib as jlib
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterator import (
    ListDataSetIterator as JListIterator,
)

import deeplearning4j_tpu_torch.native_rt as trt
import deeplearning4j_tpu_torch.native_rt.lib as tlib
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "deeplearning4j_tpu", "datasets", "fixtures")


@pytest.fixture(params=["native", "numpy"])
def mode(request, monkeypatch):
    """Each case with the native library and with it switched off."""
    if request.param == "numpy":
        monkeypatch.setenv("DL4J_TPU_DISABLE_NATIVE", "1")
    else:
        monkeypatch.delenv("DL4J_TPU_DISABLE_NATIVE", raising=False)
        assert trt.native_available()
    return request.param


def _both(name, *args):
    return getattr(trt, name)(*args), getattr(jrt, name)(*args)


def _write_idx(path, arr):
    import struct

    with open(path, "wb") as f:
        f.write(bytes([0, 0, 0x08, arr.ndim]))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.astype(np.uint8).tobytes())


def _write_pnm(path, img):
    """P5 (1 channel) or P6 (3 channels) from u8 [C, H, W]."""
    c, h, w = img.shape
    head = f"{'P5' if c == 1 else 'P6'}\n{w} {h}\n255\n".encode()
    with open(path, "wb") as f:
        f.write(head + np.ascontiguousarray(img.transpose(1, 2, 0)).tobytes())


class TestReaders:
    def test_read_csv(self, tmp_path, mode):
        rng = np.random.default_rng(1)
        p = str(tmp_path / "d.csv")
        np.savetxt(p, rng.normal(size=(20, 6)), delimiter=",", fmt="%.10f")
        a, b = _both("read_csv", p)
        np.testing.assert_array_equal(a, b)
        q = tmp_path / "c.csv"
        q.write_text("# header\n-1.5,\t2e3,0\n4.25,-6e-2,7\n")
        a, b = _both("read_csv", str(q))
        np.testing.assert_array_equal(a, b)
        bad = tmp_path / "ragged.csv"
        bad.write_text("1,2,3\n4,5\n")
        for mod in (trt, jrt):
            with pytest.raises(ValueError):
                mod.read_csv(str(bad))

    def test_read_idx(self, tmp_path, mode):
        arr = np.random.default_rng(0).integers(0, 256, (7, 5, 4),
                                                dtype=np.uint8)
        p = str(tmp_path / "x.idx")
        _write_idx(p, arr)
        a, b = _both("read_idx", p)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, arr)

    def test_read_cifar_bin_fixture(self, mode):
        path = os.path.join(FIXTURES, "real_patches_batch.bin")
        (ti, tl), (ji, jl) = _both("read_cifar_bin", path)
        assert ti.shape == (200, 3, 32, 32) and ti.dtype == np.uint8
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)

    def test_read_image_dir(self, tmp_path, mode):
        a, b = _both("read_image_dir", os.path.join(FIXTURES, "lfw"))
        assert a is None and b is None    # JPEG tree: not netpbm
        rng = np.random.default_rng(5)
        for cls, n in (("alpha", 2), ("beta", 3)):
            os.makedirs(tmp_path / cls)
            for i in range(n):
                _write_pnm(str(tmp_path / cls / f"{i}.ppm"),
                           rng.integers(0, 256, (3, 6, 5), np.uint8))
        a, b = _both("read_image_dir", str(tmp_path))
        if mode == "numpy":
            assert a is None and b is None
            return
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[0].shape == (5, 3, 6, 5)
        assert a[1].tolist() == [0, 0, 1, 1, 1]

    def test_ingest_transforms(self, mode):
        rng = np.random.default_rng(2)
        u8 = rng.integers(0, 256, (4, 3, 8, 8), np.uint8)
        a, b = _both("u8_to_f32", u8)
        np.testing.assert_array_equal(a, b)
        labels = rng.integers(0, 10, 33)
        a, b = _both("one_hot", labels, 10)
        np.testing.assert_array_equal(a, b)
        for mod in (trt, jrt):
            with pytest.raises(ValueError, match="outside"):
                mod.one_hot(np.array([0, 300]), 10)

    def test_shuffle_indices(self, mode):
        for n, seed in ((1, 0), (257, 7), (1000, 2 ** 40 + 3)):
            a, b = _both("shuffle_indices", n, seed)
            np.testing.assert_array_equal(a, b)
            assert sorted(a.tolist()) == list(range(n))


class TestNlpHelpers:
    def test_mine_pairs(self, mode):
        rng = np.random.default_rng(3)
        flat = rng.integers(0, 50, 400).astype(np.int32)
        seq = np.repeat(np.arange(8), 50).astype(np.int32)
        keep = rng.uniform(0.3, 1.0, 50).astype(np.float32)
        for kp in (None, keep):
            kp_tok = None if kp is None else kp[flat]
            a = tlib.mine_pairs(flat, seq, 3, kp_tok, seed=11)
            b = jlib.mine_pairs(flat, seq, 3, kp_tok, seed=11)
            if mode == "numpy":
                assert a is None and b is None
                continue
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert len(a[0]) > 0
            again = tlib.mine_pairs(flat, seq, 3, kp_tok, seed=11)
            np.testing.assert_array_equal(a[0], again[0])

    def test_vocab_tokenize(self, mode):
        words = ["the", "cat", "sat", "on", "mat", "é"]
        idx = np.arange(len(words)) * 3
        text = "the cat sat\non the  mat\nzebra é cat\n\n".encode()
        tv = tlib.NativeVocab.create(words, idx)
        jv = jlib.NativeVocab.create(words, idx)
        if mode == "numpy":
            assert tv is None and jv is None
            return
        a, b = tv.tokenize(text), jv.tokenize(text)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[0].tolist() == [0, 3, 6, 9, 0, 12, 15, 3]
        empty = tv.tokenize(b"")
        assert len(empty[0]) == 0


class TestRingBuffer:
    @pytest.mark.parametrize("pkg", ["port", "jax"])
    def test_semantics(self, mode, pkg):
        Ring = tlib.RingBuffer if pkg == "port" else jlib.RingBuffer
        ring = Ring(8)
        assert (ring._ring is not None) == (mode == "native")
        for i in range(5):
            assert ring.push(i)
        assert ring.size() == 5
        assert [ring.pop() for _ in range(5)] == list(range(5))
        ring.close()
        assert ring.pop() is None
        assert not ring.push(9)
        ring = Ring(2)
        seen = []

        def consumer():
            while (v := ring.pop()) is not None:
                seen.append(v)

        t = threading.Thread(target=consumer)
        t.start()
        for i in range(50):   # beyond capacity: push blocks, never drops
            assert ring.push(i)
        ring.close()
        t.join(timeout=10.0)
        assert seen == list(range(50))


class TestBuild:
    def test_builds_into_build_dir_not_native(self):
        assert not os.environ.get("DL4J_TPU_DISABLE_NATIVE")
        assert trt.native_available()
        path = tlib.library_path()
        assert path.exists()
        assert path.parent == tlib.BUILD_DIR
        assert tlib.BUILD_DIR.name == "_build"
        assert tlib.BUILD_DIR.parent.name == "deeplearning4j_tpu_torch"
        assert tlib.SOURCE == tlib.BUILD_DIR.parent.parent / "native" / (
            "dl4j_native.cpp")
        assert tlib.NativeLib.load().lib._name == str(path)

    def test_fresh_build_writes_nothing_to_native(self, tmp_path,
                                                  monkeypatch):
        native = tlib.SOURCE.parent
        before = {f: os.stat(native / f).st_mtime_ns
                  for f in os.listdir(native)}
        monkeypatch.setattr(tlib, "BUILD_DIR", tmp_path / "_build")
        monkeypatch.delenv("DL4J_TPU_DISABLE_NATIVE", raising=False)
        tlib.NativeLib.reset()
        try:
            assert tlib.native_available()
            built = list((tmp_path / "_build").glob("libdl4j_native-*.so"))
            assert len(built) == 1
            assert tlib.NativeLib.load().lib.dl4j_native_abi_version() == 4
        finally:
            tlib.NativeLib.reset()
        after = {f: os.stat(native / f).st_mtime_ns
                 for f in os.listdir(native)}
        assert after == before

    def test_failed_build_reports_once_and_falls_back(self, tmp_path,
                                                      monkeypatch, capsys):
        bad = tmp_path / "bad.cpp"
        bad.write_text("this is not C++;\n")
        monkeypatch.setattr(tlib, "SOURCE", bad)
        monkeypatch.setattr(tlib, "BUILD_DIR", tmp_path / "_build")
        monkeypatch.delenv("DL4J_TPU_DISABLE_NATIVE", raising=False)
        tlib.NativeLib.reset()
        try:
            assert not tlib.native_available()
            err = capsys.readouterr().err
            assert "bad.cpp" in err and "error" in err
            assert not tlib.native_available()
            assert capsys.readouterr().err == ""
            # the fallbacks still answer
            np.testing.assert_array_equal(tlib.shuffle_indices(5, 1),
                                          jlib.shuffle_indices(5, 1))
        finally:
            tlib.NativeLib.reset()


def _sets(n=6, batch=4):
    rng = np.random.default_rng(2)
    return [(rng.normal(size=(batch, 3)).astype(np.float32),
             np.eye(2, dtype=np.float32)[rng.integers(0, 2, batch)])
            for _ in range(n)]


def _drain(it):
    out = []
    while (ds := it.next()) is not None:
        out.append(np.asarray(ds.features))
    return out


class TestNativeAsyncIterator:
    def _pair(self, queue_size=2, n=6):
        raw = _sets(n)
        port = trt.NativeAsyncDataSetIterator(
            ListDataSetIterator([DataSet(x, y) for x, y in raw]),
            queue_size=queue_size)
        jax_ = jrt.NativeAsyncDataSetIterator(
            JListIterator([JDataSet(x, y) for x, y in raw]),
            queue_size=queue_size)
        return raw, port, jax_

    def test_order_and_reset(self, mode):
        raw, port, jax_ = self._pair()
        a, b = _drain(port), _drain(jax_)
        assert len(a) == len(b) == 6
        for x, y, (want, _) in zip(a, b, raw):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, want)
        port.reset()
        jax_.reset()
        assert len(_drain(port)) == len(_drain(jax_)) == 6

    def test_state_dict_is_exactly_once(self, mode):
        raw, port, jax_ = self._pair(queue_size=3)
        for it in (port, jax_):
            it.next()
            it.next()
        state, jstate = port.state_dict(), jax_.state_dict()
        assert state["consumed"] == jstate["consumed"] == 2
        rest = _drain(port)
        _, port2, jax2 = self._pair(queue_size=3)
        port2.load_state_dict(state)
        jax2.load_state_dict(jstate)
        a, b = _drain(port2), _drain(jax2)
        assert len(a) == len(b) == len(rest) == 4
        for x, y, z in zip(a, b, rest):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)

    def test_producer_error_surfaces(self, mode):
        class Exploding(ListDataSetIterator):
            def next(self, num=None):
                raise RuntimeError("boom")

        it = trt.NativeAsyncDataSetIterator(
            Exploding([DataSet(x, y) for x, y in _sets(2)]), queue_size=2)
        with pytest.raises(RuntimeError, match="boom"):
            _drain(it)

    def test_trains_through_prefetch(self, mode):
        from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
        from deeplearning4j_tpu_torch.nn.conf import layers as L
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.ops.losses import LossFunction

        conf = (NeuralNetConfiguration.Builder().seed(5).learning_rate(0.1)
                .list()
                .layer(0, L.DenseLayer(n_in=3, n_out=8, activation="tanh"))
                .layer(1, L.OutputLayer(n_in=8, n_out=2,
                                        activation="softmax",
                                        loss_function=LossFunction.MCXENT))
                .build())
        net = MultiLayerNetwork(conf, device="cpu").init()
        raw = _sets(6)
        net.fit(trt.NativeAsyncDataSetIterator(
            ListDataSetIterator([DataSet(x, y) for x, y in raw]),
            queue_size=3))
        assert net.iteration == 6 and np.isfinite(float(net.score_value))
