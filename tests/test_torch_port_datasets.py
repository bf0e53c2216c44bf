"""The port's ``datasets/``, ``storage/`` and ``util/moving_window.py``
against the JAX package's: the same inputs (files written here from a
seed, the bundled fixtures read by path, seeded synthetic stand-ins)
must give equal arrays.

- ``records.py``: CSV, sequence-CSV and image record readers, the
  classification / regression / feature-only, sequence (padded, masked)
  and multi-reader iterators.
- ``fetchers.py``: CIFAR (synthetic), LFW (synthetic and the ``lfw``
  fixture through PIL), curves, the moving-window fetcher.
- ``iris.py`` down its whole fallback chain: sklearn, a CSV under
  ``$DL4J_TPU_DATA_DIR``, the synthetic clusters.
- ``fixtures``: mnist200, real patches, raw sentences, digits, the LFW
  directory.
- ``rearrange.py``, ``vectorizer.py``, the five iterators
  (``MultipleEpochsIterator``, ``SamplingDataSetIterator``,
  ``TestDataSetIterator``, ``ReconstructionDataSetIterator``,
  ``MovingWindowDataSetIterator``) with their ``state_dict``, and
  ``StorageDataSetIterator`` over the local backend (npz, token and
  CIFAR shards; resume, also through the async wrapper) with
  ``StorageModelSaver``."""

import os
import sys

import numpy as np
import pytest

import deeplearning4j_tpu.datasets.fetchers as jfetch
import deeplearning4j_tpu.datasets.fixtures as jfix
import deeplearning4j_tpu.datasets.iris as jiris
import deeplearning4j_tpu.datasets.iterator as jit_mod
import deeplearning4j_tpu.datasets.rearrange as jrearr
import deeplearning4j_tpu.datasets.records as jrec
import deeplearning4j_tpu.datasets.streaming as jstream
import deeplearning4j_tpu.datasets.vectorizer as jvec
import deeplearning4j_tpu.storage.backends as jstore
import deeplearning4j_tpu.util.moving_window as jmw
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet

import deeplearning4j_tpu_torch.datasets.fetchers as tfetch
import deeplearning4j_tpu_torch.datasets.fixtures as tfix
import deeplearning4j_tpu_torch.datasets.iris as tiris
import deeplearning4j_tpu_torch.datasets.iterator as tit_mod
import deeplearning4j_tpu_torch.datasets.rearrange as trearr
import deeplearning4j_tpu_torch.datasets.records as trec
import deeplearning4j_tpu_torch.datasets.streaming as tstream
import deeplearning4j_tpu_torch.datasets.vectorizer as tvec
import deeplearning4j_tpu_torch.native_rt as trt
import deeplearning4j_tpu_torch.storage as tstore_pkg
import deeplearning4j_tpu_torch.storage.backends as tstore
import deeplearning4j_tpu_torch.util.moving_window as tmw
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from torch_port_threads import one_torch_thread  # noqa: F401


def _arrays(ds):
    """Every array of a DataSet / MultiDataSet, None kept."""
    if hasattr(ds, "features_masks"):
        return (list(ds.features) + list(ds.labels)
                + list(ds.features_masks or []) + list(ds.labels_masks or []))
    return [ds.features, ds.labels, ds.features_mask, ds.labels_mask]


def _assert_same(a, b):
    xa, xb = _arrays(a), _arrays(b)
    assert len(xa) == len(xb)
    for x, y in zip(xa, xb):
        if x is None or y is None:
            assert x is None and y is None
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _drain_both(port_it, jax_it, limit=1000):
    n = 0
    while True:
        a, b = port_it.next(), jax_it.next()
        if a is None or b is None:
            assert a is None and b is None
            return n
        _assert_same(a, b)
        n += 1
        assert n < limit


@pytest.fixture
def csv_path(tmp_path):
    rng = np.random.default_rng(0)
    rows = [",".join(f"{v:.4f}" for v in rng.normal(size=3)) + f",{i % 3}"
            for i in range(30)]
    p = tmp_path / "data.csv"
    p.write_text("# header comment\n" + "\n".join(rows) + "\n")
    return str(p)


class TestRecords:
    def test_csv_reader_and_iterators(self, csv_path):
        assert list(trec.CSVRecordReader(csv_path)) == list(
            jrec.CSVRecordReader(csv_path))
        for kw in ({}, {"label_index": 0, "regression": True},
                   {"label_index": None}, {"num_classes": 5}):
            n = _drain_both(
                trec.RecordReaderDataSetIterator(
                    trec.CSVRecordReader(csv_path), batch_size=8, **kw),
                jrec.RecordReaderDataSetIterator(
                    jrec.CSVRecordReader(csv_path), batch_size=8, **kw))
            assert n == 4
        it = trec.RecordReaderDataSetIterator(trec.CSVRecordReader(csv_path),
                                              batch_size=8)
        it.next()
        state = it.state_dict()
        want = it.next()
        it2 = trec.RecordReaderDataSetIterator(
            trec.CSVRecordReader(csv_path), batch_size=8)
        it2.load_state_dict(state)
        _assert_same(it2.next(), want)
        with pytest.raises(ValueError, match="out of range"):
            trec.RecordReaderDataSetIterator(trec.CSVRecordReader(csv_path),
                                             batch_size=8, label_index=9)

    def test_sequence_iterator_pads_and_masks(self, tmp_path):
        rng = np.random.default_rng(1)
        fpaths, lpaths = [], []
        for i, t_len in enumerate([4, 6, 3]):
            fp, lp = tmp_path / f"f{i}.csv", tmp_path / f"l{i}.csv"
            fp.write_text("\n".join(",".join(
                f"{v:.3f}" for v in rng.normal(size=2))
                for _ in range(t_len)))
            lp.write_text("\n".join(str(rng.integers(0, 3))
                                    for _ in range(t_len)))
            fpaths.append(str(fp))
            lpaths.append(str(lp))
        a = trec.SequenceRecordReaderDataSetIterator(
            trec.CSVSequenceRecordReader(fpaths),
            trec.CSVSequenceRecordReader(lpaths), batch_size=2,
            num_classes=3)
        b = jrec.SequenceRecordReaderDataSetIterator(
            jrec.CSVSequenceRecordReader(fpaths),
            jrec.CSVSequenceRecordReader(lpaths), batch_size=2,
            num_classes=3)
        assert _drain_both(a, b) == 2

    def test_multi_reader_iterator(self, csv_path):
        def build(mod):
            return (mod.RecordReaderMultiDataSetIterator.Builder(7)
                    .add_reader("csv", mod.CSVRecordReader(csv_path))
                    .add_input("csv", 0, 1).add_input("csv", 2, 2)
                    .add_output_one_hot("csv", 3, num_classes=3)
                    .build())

        a, b = build(trec), build(jrec)
        assert a.total_outcomes() == b.total_outcomes() == 3
        assert _drain_both(a, b) == 5

    def test_image_reader(self, tmp_path):
        from PIL import Image

        rng = np.random.default_rng(2)
        for cls in ("cat", "dog"):
            (tmp_path / cls).mkdir()
            for i in range(3):
                Image.fromarray(rng.integers(0, 256, (10, 8), np.uint8),
                                "L").save(tmp_path / cls / f"{i}.png")
        a = trec.ImageRecordReader(str(tmp_path), height=5, width=4)
        b = jrec.ImageRecordReader(str(tmp_path), height=5, width=4)
        assert list(a) == list(b) and a.labels == b.labels == ["cat", "dog"]


class TestFetchers:
    def test_cifar(self):
        for train in (True, False):
            a, b = (tfetch.load_cifar(train=train, num_examples=64),
                    jfetch.load_cifar(train=train, num_examples=64))
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
        assert _drain_both(tfetch.CifarDataSetIterator(16, num_examples=48),
                           jfetch.CifarDataSetIterator(16, num_examples=48)
                           ) == 3

    def test_lfw_synthetic_and_fixture(self):
        assert _drain_both(
            tfetch.LFWDataSetIterator(10, num_examples=40, num_people=4),
            jfetch.LFWDataSetIterator(10, num_examples=40, num_people=4)
        ) == 4
        root = tfix.lfw_fixture_dir()
        assert root == jfix.lfw_fixture_dir() and os.path.isdir(root)
        a, b = tfetch.load_lfw(root=root), jfetch.load_lfw(root=root)
        assert a[0].shape[0] == 4 and a[2] == b[2]
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])

    def test_curves_and_moving_window_fetcher(self):
        assert _drain_both(tfetch.CurvesDataSetIterator(20, num_examples=40),
                           jfetch.CurvesDataSetIterator(20, num_examples=40)
                           ) == 2
        rng = np.random.default_rng(3)
        x = rng.normal(size=(3, 36)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[[0, 1, 1]]
        a = tfetch.MovingWindowDataSetFetcher(DataSet(x, y), 3, 3, rotate=1)
        b = jfetch.MovingWindowDataSetFetcher(JDataSet(x, y), 3, 3, rotate=1)
        _assert_same(a.fetch(), b.fetch())
        assert _drain_both(a.iterator(16), b.iterator(16)) > 1


class TestIris:
    def test_sklearn(self):
        _assert_same(tiris.iris_dataset(), jiris.iris_dataset())
        assert _drain_both(tiris.IrisDataSetIterator(50),
                           jiris.IrisDataSetIterator(50)) == 3

    def test_csv_and_synthetic_fallbacks(self, tmp_path, monkeypatch):
        # the card's machine has no sklearn: the rest of the chain
        monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
        monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
        synth = tiris.iris_dataset()
        _assert_same(synth, jiris.iris_dataset())
        assert synth.features.shape == (150, 4)
        rng = np.random.default_rng(4)
        rows = [",".join(f"{v:.2f}" for v in rng.normal(size=4))
                + f",{i % 3}" for i in range(30)]
        (tmp_path / "iris.csv").write_text("\n".join(rows) + "\n")
        from_csv = tiris.iris_dataset()
        _assert_same(from_csv, jiris.iris_dataset())
        assert from_csv.features.shape == (30, 4)


class TestFixtures:
    def test_loaders_read_the_same_files(self):
        for name, kw in (("mnist200_datasets", {}),
                         ("real_patches_cifar", {}),
                         ("digits_dataset", {"n_test": 100})):
            a = getattr(tfix, name)(**kw)
            b = getattr(jfix, name)(**kw)
            for x, y in zip(a, b):
                _assert_same(x, y)
        assert tfix.raw_sentences(50) == jfix.raw_sentences(50)
        assert tfix._HERE == os.path.dirname(os.path.abspath(jfix.__file__))


class TestRearrangeAndVectorizer:
    def test_rearrange_split(self, tmp_path):
        src = tmp_path / "raw"
        for cls in ("a", "b"):
            (src / cls).mkdir(parents=True)
            for i in range(7):
                (src / cls / f"{i}.txt").write_text(f"{cls}{i}")
        out = {}
        for name, mod in (("port", trearr), ("jax", jrearr)):
            f = mod.LocalUnstructuredDataFormatter(
                str(tmp_path / name), str(src), percent_train=0.7, seed=5)
            f.rearrange()
            out[name] = sorted(
                os.path.relpath(os.path.join(d, x), tmp_path / name)
                for d, _, fs in os.walk(tmp_path / name) for x in fs)
            assert f.num_examples_total() == 14
        assert out["port"] == out["jax"]

    def test_vectorizer(self, tmp_path):
        from PIL import Image

        arr = np.random.default_rng(4).integers(0, 256, (6, 6), np.uint8)
        p = str(tmp_path / "img.png")
        Image.fromarray(arr, "L").save(p)
        _assert_same(tvec.ImageVectorizer(p, label=2, num_labels=4)
                     .vectorize(),
                     jvec.ImageVectorizer(p, label=2, num_labels=4)
                     .vectorize())
        m = np.arange(25, dtype=np.float32).reshape(5, 5)
        for rot in (0, 1):
            np.testing.assert_array_equal(
                tvec.moving_window_matrix(m, 2, 2, rotate=rot),
                jvec.moving_window_matrix(m, 2, 2, rotate=rot))
        for a, b in zip(tmw.moving_window_matrices(m, 3, 2),
                        jmw.moving_window_matrices(m, 3, 2)):
            np.testing.assert_array_equal(a, b)
        with pytest.raises(ValueError, match="square"):
            tvec.moving_window_matrix(m, 2, 3, rotate=1)


def _data(n=20, seed=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 16)).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


class TestIterators:
    @pytest.mark.parametrize("kind", ["epochs", "sampling", "test",
                                      "reconstruction", "moving_window"])
    def test_matches_jax_and_resumes(self, kind):
        x, y = _data()

        def make(mod, D):
            base = mod.BaseDataSetIterator(6, D(x, y))
            if kind == "epochs":
                return mod.MultipleEpochsIterator(3, base)
            if kind == "sampling":
                return mod.SamplingDataSetIterator(D(x, y), 4, 22, seed=9)
            if kind == "test":
                return mod.TestDataSetIterator(base)
            if kind == "reconstruction":
                return mod.ReconstructionDataSetIterator(base)
            return mod.MovingWindowDataSetIterator(D(x, y), 2, 3,
                                                   batch_size=16)

        a, b = make(tit_mod, DataSet), make(jit_mod, JDataSet)
        n = _drain_both(a, b)
        assert n == {"epochs": 12, "sampling": 6, "test": 4,
                     "reconstruction": 4, "moving_window": 3}[kind]
        if kind == "test":
            assert a.next_calls == b.next_calls == n + 1
        a.reset()
        b.reset()
        if kind == "test":
            assert a.reset_calls == b.reset_calls == 1
        a.next()
        b.next()
        if kind != "moving_window":
            state = a.state_dict()
            assert state.keys() == b.state_dict().keys()
            want = a.next()
            c = make(tit_mod, DataSet)
            c.load_state_dict(state)
            _assert_same(c.next(), want)
        assert a.total_examples() == b.total_examples()
        assert a.total_outcomes() == b.total_outcomes()


def _put_npz(backend, tmp_path, key, n, seed):
    x, y = _data(n, seed)
    p = tmp_path / f"{key.replace('/', '_')}.npz"
    np.savez(p, features=x, labels=y)
    backend.put(str(p), key)


class TestStorage:
    @pytest.fixture
    def bucket(self, tmp_path):
        """One local bucket of npz, token and CIFAR shards, read through
        each package's LocalStorage."""
        root = str(tmp_path / "bucket")
        port = tstore.LocalStorage(root)
        _put_npz(port, tmp_path, "train/shard-2.npz", 10, 2)
        _put_npz(port, tmp_path, "train/shard-1.npz", 12, 1)
        _put_npz(port, tmp_path, "other/x.npz", 4, 9)
        toks = np.random.default_rng(5).integers(0, 32, (6, 9))
        tstream.write_token_file(str(tmp_path / "t.bin"), toks, vocab=32)
        port.put(str(tmp_path / "t.bin"), "lm/part-0.bin")
        rng = np.random.default_rng(7)
        rows = np.concatenate([rng.integers(0, 10, (12, 1)),
                               rng.integers(0, 256, (12, 3072))], axis=1)
        rows.astype(np.uint8).tofile(tmp_path / "c.bin")
        port.put(str(tmp_path / "c.bin"), "img/part-0.bin")
        return port, jstore.LocalStorage(root)

    @pytest.mark.parametrize("prefix,fmt,n", [("train/", "npz", 4),
                                              ("lm/", "tokens", 2),
                                              ("img/", "cifar", 3)])
    def test_shards_match_jax(self, bucket, prefix, fmt, n):
        port, jax_ = bucket
        assert port.list(prefix) == jax_.list(prefix)
        a = tstream.StorageDataSetIterator(port, prefix, batch_size=5 if (
            fmt != "npz") else 8, fmt=fmt)
        b = jstream.StorageDataSetIterator(jax_, prefix, batch_size=5 if (
            fmt != "npz") else 8, fmt=fmt)
        assert _drain_both(a, b) == n
        assert a.input_columns() == b.input_columns()
        assert a.total_outcomes() == b.total_outcomes()
        a.close()
        b.close()

    @pytest.mark.parametrize("wrapped", [False, True])
    def test_resume_mid_shard(self, bucket, wrapped):
        port, _ = bucket

        def make():
            it = tstream.StorageDataSetIterator(port, "train/", batch_size=4)
            return trt.NativeAsyncDataSetIterator(it, queue_size=2) if (
                wrapped) else it

        it = make()
        for _ in range(3):
            it.next()
        state = it.state_dict()
        want = it.next()
        it2 = make()
        it2.load_state_dict(state)
        _assert_same(it2.next(), want)

    def test_errors_and_exports(self, bucket):
        port, _ = bucket
        with pytest.raises(ValueError, match="no shards"):
            tstream.StorageDataSetIterator(port, "nothing/", batch_size=4)
        with pytest.raises(ValueError, match="unknown shard format"):
            tstream.StorageDataSetIterator(port, "train/", batch_size=4,
                                           fmt="parquet")
        assert set(tstore_pkg.__all__) == set(
            __import__("deeplearning4j_tpu.storage",
                       fromlist=["x"]).__all__)

    def test_model_saver_round_trip(self, bucket):
        from deeplearning4j_tpu_torch.models.zoo import mlp
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        port, _ = bucket
        net = MultiLayerNetwork(mlp(sizes=(16, 8, 3)), device="cpu").init()
        saver = tstore.StorageModelSaver(port, "models/m.zip")
        saver.save(net)
        assert port.exists("models/m.zip")
        back = saver.load(device="cpu")
        x, _ = _data(5)
        np.testing.assert_array_equal(back.output(x).numpy(),
                                      net.output(x).numpy())
