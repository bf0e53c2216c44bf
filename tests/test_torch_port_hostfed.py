"""Host-fed training in the PyTorch port against the JAX package:
``fit_stream`` on both nets, the disk-streaming iterators and
``wide_cnn``.

Every net is JAX-initialised and loaded into the port through a model
zip (never two independent inits); inputs are numpy, made from a seed.

- ``fit_stream`` on the MLN and on a graph (a small transformer LM:
  width 32, 2 attention layers, V=16, T=16, B=4) over 10 batches of
  Markov token ids read from a DL4JTOK1 file through the C++ prefetch
  ring, ``scan_steps=4``: two fused windows and a ragged tail of 2,
  one-hot on the device. Scores and params against JAX's
  ``fit_stream`` from the same zip within 5e-3 relative (the k-step
  rule; params also 1e-4 absolute); against the port's own sequential
  ``fit`` on the same batches exactly.
- Masked batches through both routes, and the mixed-mask error; a
  multi-input graph with a ragged final batch; a ragged tail's ingest.
- DL4JTOK1 files byte-identical between the packages (u8 and u16
  vocabularies), each package's reader on the other's file, and the
  out-of-range rejection; ``CifarBinStreamIterator`` rows across files
  and its resume from ``state_dict``, alone and through the async
  wrapper.
- ``wide_cnn`` from a JAX zip (16x16 images): f32 forward within 1e-4,
  one ``fit`` step's params within 5e-3 relative."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import streaming as jstream
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMulti
from deeplearning4j_tpu.datasets.iterator import (
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.native_rt import (
    NativeAsyncDataSetIterator as JAsync,
)
from deeplearning4j_tpu.nn import conf as jconf_pkg
from deeplearning4j_tpu.nn.conf import graph_conf as jgc
from deeplearning4j_tpu.nn.conf import layers as jL
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss
from deeplearning4j_tpu.util.model_serializer import write_model as jwrite

from deeplearning4j_tpu_torch.datasets import markov
from deeplearning4j_tpu_torch.datasets import streaming as tstream
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.native_rt import NativeAsyncDataSetIterator
from deeplearning4j_tpu_torch.nn import conf as tconf_pkg
from deeplearning4j_tpu_torch.nn.conf import graph_conf as tgc
from deeplearning4j_tpu_torch.nn.conf import layers as tL
from deeplearning4j_tpu_torch.ops.losses import LossFunction as TLoss
from deeplearning4j_tpu_torch.util.model_serializer import restore_model
from torch_port_threads import one_torch_thread  # noqa: F401

V, W, T, B = 16, 32, 16, 4
N_BATCHES, K = 10, 4
SCORE_RTOL = 5e-3
PARAM_TOL = dict(rtol=5e-3, atol=1e-4)
FWD_TOL = dict(rtol=1e-4, atol=1e-4)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def _leaves(params):
    """Params in a fixed order (sorted keys at every level) as numpy."""
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in _leaves(params[k])]
    return [_np(params)]


def _assert_params(port, jax_params, **tol):
    a, b = _leaves(port.params), _leaves(jax_params)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, **tol)


def _assert_same_params(a, b):
    for x, y in zip(_leaves(a.params), _leaves(b.params)):
        np.testing.assert_array_equal(x, y)


def _t_one_hot(ids):
    return torch.nn.functional.one_hot(ids.long(), V).permute(
        0, 1, 3, 2).float()


_j_one_hot = jax.jit(lambda ids: jax.nn.one_hot(
    ids, V, dtype=jnp.float32).transpose(0, 1, 3, 2))


def _lm_graph_conf(G, NNC, Lm, Loss, MHSA):
    """The same graph in either package: in -> att0 -> att1 -> out."""
    b = (NNC.Builder().seed(5).learning_rate(1e-2).updater("ADAM")
         .activation("identity").weight_init("XAVIER").graph_builder()
         .add_inputs("in"))
    b.add_layer("att0", MHSA(n_in=V, n_out=W, n_heads=2, causal=True),
                "in")
    b.add_layer("att1", MHSA(n_in=W, n_out=W, n_heads=2, causal=True),
                "att0")
    b.add_layer("out", Lm.RnnOutputLayer(
        n_in=W, n_out=V, activation="softmax",
        loss_function=Loss.MCXENT), "att1")
    return b.set_outputs("out").build()


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The token file, its batches, and JAX-written zips of the LM (MLN
    and graph), shared by the module."""
    d = tmp_path_factory.mktemp("hostfed")
    chain, _, _ = markov.make_chain(V, seed=0)
    toks = markov.sample_tokens(chain, N_BATCHES * B, T, seed=1)
    path = str(d / "lm.bin")
    tstream.write_token_file(path, toks, vocab=V)
    mln = str(d / "mln.zip")
    jwrite(JNet(jzoo.transformer_lm(n_in=V, width=W, n_layers=2,
                                    n_heads=2, n_classes=V, lr=1e-2,
                                    seed=3)).init(), mln)
    from deeplearning4j_tpu.nn.layers.attention import (
        MultiHeadSelfAttention as JMHSA,
    )
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        MultiHeadSelfAttention as TMHSA,
    )

    jconf = _lm_graph_conf(jgc, jconf_pkg.NeuralNetConfiguration, jL,
                           JLoss, JMHSA)
    tconf = _lm_graph_conf(tgc, tconf_pkg.NeuralNetConfiguration, tL,
                           TLoss, TMHSA)
    assert jconf.to_json() == tconf.to_json()
    graph = str(d / "graph.zip")
    jwrite(JGraph(jconf).init(), graph)
    return {"dir": d, "tokens": path, "toks": toks, "mln": mln,
            "graph": graph}


def _jax_net(path):
    from deeplearning4j_tpu.util.model_serializer import restore_model as jr

    return jr(path)


def _port_stream(path):
    return NativeAsyncDataSetIterator(
        tstream.TokenSequenceFileIterator(path, batch_size=B), queue_size=4)


def _jax_stream(path):
    return JAsync(jstream.TokenSequenceFileIterator(path, batch_size=B),
                  queue_size=4)


class TestFitStreamAgainstJax:
    def test_mln_windows_and_ragged_tail(self, work):
        net = restore_model(work["mln"], device="cpu")
        scores = net.fit_stream(_port_stream(work["tokens"]), scan_steps=K,
                                ingest=_t_one_hot, ingest_labels=_t_one_hot)
        jnet = _jax_net(work["mln"])
        jscores = jnet.fit_stream(_jax_stream(work["tokens"]),
                                  scan_steps=K, ingest=_j_one_hot,
                                  ingest_labels=_j_one_hot)
        assert net.iteration == jnet.iteration == N_BATCHES
        assert tuple(scores.shape) == (1,)       # the ragged tail's
        np.testing.assert_allclose(_np(scores), np.asarray(jscores),
                                   rtol=SCORE_RTOL)
        _assert_params(net, jnet.params, **PARAM_TOL)

    def test_mln_fused_window_scores(self, work):
        """Two full windows: the returned [K] scores of the second."""
        rows = work["toks"][:2 * K * B]
        batches = [(rows[i:i + B, :-1], rows[i:i + B, 1:])
                   for i in range(0, len(rows), B)]
        net = restore_model(work["mln"], device="cpu")
        scores = net.fit_stream(
            ListDataSetIterator([DataSet(f, y) for f, y in batches]),
            scan_steps=K, ingest=_t_one_hot, ingest_labels=_t_one_hot)
        jnet = _jax_net(work["mln"])
        jscores = jnet.fit_stream(
            JListIterator([JDataSet(f, y) for f, y in batches]),
            scan_steps=K, ingest=_j_one_hot, ingest_labels=_j_one_hot)
        assert tuple(scores.shape) == (K,)
        np.testing.assert_allclose(_np(scores), np.asarray(jscores),
                                   rtol=SCORE_RTOL)
        _assert_params(net, jnet.params, **PARAM_TOL)

    def test_graph_windows_and_ragged_tail(self, work):
        ingest = lambda d: {k: _t_one_hot(v) for k, v in d.items()}  # noqa
        jingest = lambda d: {k: _j_one_hot(v) for k, v in d.items()}  # noqa
        net = restore_model(work["graph"], device="cpu")
        scores = net.fit_stream(
            _port_stream(work["tokens"]), scan_steps=K, ingest=ingest,
            ingest_labels=lambda ys: [_t_one_hot(y) for y in ys])
        jnet = _jax_net(work["graph"])
        jscores = jnet.fit_stream(
            _jax_stream(work["tokens"]), scan_steps=K, ingest=jingest,
            ingest_labels=lambda ys: [_j_one_hot(y) for y in ys])
        assert net.iteration == jnet.iteration == N_BATCHES
        np.testing.assert_allclose(_np(scores), np.asarray(jscores),
                                   rtol=SCORE_RTOL)
        _assert_params(net, jnet.params, **PARAM_TOL)


def _one_hot_batches(toks):
    eye = np.eye(V, dtype=np.float32)
    out = []
    for i in range(0, len(toks), B):
        rows = toks[i:i + B]
        out.append(DataSet(eye[rows[:, :-1]].transpose(0, 2, 1),
                           eye[rows[:, 1:]].transpose(0, 2, 1)))
    return out


class TestFitStreamEqualsSequentialFit:
    @pytest.mark.parametrize("kind", ["mln", "graph"])
    def test_token_stream(self, work, kind):
        stream = restore_model(work[kind], device="cpu")
        if kind == "mln":
            ingest, ingest_labels = _t_one_hot, _t_one_hot
        else:
            ingest = lambda d: {k: _t_one_hot(v) for k, v in d.items()}  # noqa
            ingest_labels = lambda ys: [_t_one_hot(y) for y in ys]  # noqa
        stream.fit_stream(_port_stream(work["tokens"]), scan_steps=K,
                          ingest=ingest, ingest_labels=ingest_labels)
        seq = restore_model(work[kind], device="cpu")
        for ds in _one_hot_batches(work["toks"]):
            seq.fit(ds)
        assert stream.iteration == seq.iteration == N_BATCHES
        _assert_same_params(stream, seq)

    def test_multi_input_graph_with_ragged_batch(self):
        def conf(G, NNC, Lm, Loss):
            return (NNC.Builder().seed(9).learning_rate(0.05)
                    .graph_builder().add_inputs("a", "b")
                    .add_layer("da", Lm.DenseLayer(n_in=4, n_out=5,
                                                   activation="relu"), "a")
                    .add_layer("db", Lm.DenseLayer(n_in=3, n_out=5,
                                                   activation="tanh"), "b")
                    .add_vertex("m", G.MergeVertex(), "da", "db")
                    .add_layer("out", Lm.OutputLayer(
                        n_in=10, n_out=2, activation="softmax",
                        loss_function=Loss.MCXENT), "m")
                    .set_outputs("out").build())

        from deeplearning4j_tpu.util.model_serializer import (
            restore_model as jrestore,
        )

        rng = np.random.default_rng(8)
        raw = []
        for n in [6, 6, 6, 6, 6, 4]:   # ragged final batch
            raw.append((rng.normal(size=(n, 4)).astype(np.float32),
                        rng.normal(size=(n, 3)).astype(np.float32),
                        np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]))
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "g.zip")
            jwrite(JGraph(conf(jgc, jconf_pkg.NeuralNetConfiguration, jL,
                               JLoss)).init(), path)
            stream = restore_model(path, device="cpu")
            seq = restore_model(path, device="cpu")
            jnet = jrestore(path)
        scores = stream.fit_stream(ListDataSetIterator(
            [MultiDataSet([a, b], [y]) for a, b, y in raw]), scan_steps=2)
        jnet.fit_stream(JListIterator(
            [JMulti([a, b], [y]) for a, b, y in raw]), scan_steps=2)
        for a, b, y in raw:
            seq.fit(MultiDataSet([a, b], [y]))
        assert np.isfinite(_np(scores)).all()
        assert stream.iteration == seq.iteration == jnet.iteration == 6
        _assert_same_params(stream, seq)
        _assert_params(stream, jnet.params, **PARAM_TOL)

    def test_graph_ragged_tail_applies_ingest(self):
        """The ragged tail goes through the same ingest as the fused
        window: u8 features scaled on the device."""
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        def net():
            c = (tconf_pkg.NeuralNetConfiguration.Builder().seed(4)
                 .learning_rate(0.05).graph_builder().add_inputs("x")
                 .add_layer("d", tL.DenseLayer(n_in=6, n_out=8,
                                               activation="relu"), "x")
                 .add_layer("out", tL.OutputLayer(
                     n_in=8, n_out=2, activation="softmax",
                     loss_function=TLoss.MCXENT), "d")
                 .set_outputs("out").build())
            return ComputationGraph(c, device="cpu").init()

        rng = np.random.default_rng(1)
        u8, f32 = [], []
        for n in [8, 8, 8, 4]:     # one fused window of 2, then (8, 4)
            x = rng.integers(0, 255, (n, 6), np.uint8)
            y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
            u8.append(DataSet(x, y))
            f32.append(DataSet(x.astype(np.float32) / 255.0, y))
        stream = net()
        stream.fit_stream(ListDataSetIterator(u8), scan_steps=2,
                          ingest=lambda d: {k: v.float() / 255.0
                                            for k, v in d.items()})
        seq = net()
        for ds in f32:
            seq.fit(ds)
        assert stream.iteration == seq.iteration == 4
        for a, b in zip(_leaves(stream.params), _leaves(seq.params)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def _lstm_conf(NNC, Lm, Loss):
    return (NNC.Builder().seed(11).learning_rate(0.05).list()
            .layer(0, Lm.GravesLSTM(n_in=3, n_out=4))
            .layer(1, Lm.RnnOutputLayer(n_in=4, n_out=2,
                                        activation="softmax",
                                        loss_function=Loss.MCXENT))
            .build())


def _masked_batches(n, seed=4, b=4, t=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(b, 3, t)).astype(np.float32)
        idx = rng.integers(0, 2, (b, t))
        y = np.zeros((b, 2, t), np.float32)
        for i in range(b):
            y[i, idx[i], np.arange(t)] = 1.0
        lens = rng.integers(3, t + 1, b)
        fm = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
        out.append((x, y, fm))
    return out


class TestMasks:
    def test_masked_batches_fused_and_ragged(self, tmp_path):
        from deeplearning4j_tpu.util.model_serializer import (
            restore_model as jrestore,
        )

        path = str(tmp_path / "lstm.zip")
        jwrite(JNet(_lstm_conf(jconf_pkg.NeuralNetConfiguration, jL,
                               JLoss)).init(), path)
        raw = _masked_batches(5)   # windows of 2: two fused, one ragged
        stream = restore_model(path, device="cpu")
        stream.fit_stream(ListDataSetIterator(
            [DataSet(x, y, m, m.copy()) for x, y, m in raw]), scan_steps=2)
        seq = restore_model(path, device="cpu")
        for x, y, m in raw:
            seq.fit(DataSet(x, y, m, m.copy()))
        jnet = jrestore(path)
        jnet.fit_stream(JListIterator(
            [JDataSet(x, y, m, m.copy()) for x, y, m in raw]), scan_steps=2)
        assert stream.iteration == seq.iteration == jnet.iteration == 5
        _assert_same_params(stream, seq)
        _assert_params(stream, jnet.params, **PARAM_TOL)

    @pytest.mark.parametrize("kind", ["mln", "graph"])
    def test_window_mixing_masked_and_unmasked_raises(self, kind):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        conf = _lstm_conf(tconf_pkg.NeuralNetConfiguration, tL, TLoss)
        if kind == "mln":
            net = MultiLayerNetwork(conf, device="cpu").init()
        else:
            g = (tconf_pkg.NeuralNetConfiguration.Builder().seed(11)
                 .learning_rate(0.05).graph_builder().add_inputs("in")
                 .add_layer("lstm", tL.GravesLSTM(n_in=3, n_out=4), "in")
                 .add_layer("out", tL.RnnOutputLayer(
                     n_in=4, n_out=2, activation="softmax",
                     loss_function=TLoss.MCXENT), "lstm")
                 .set_outputs("out").build())
            net = ComputationGraph(g, device="cpu").init()
        (x0, y0, m0), (x1, y1, _) = _masked_batches(2)
        it = ListDataSetIterator([DataSet(x0, y0, m0, m0.copy()),
                                  DataSet(x1, y1)])
        with pytest.raises(ValueError, match="mixes"):
            net.fit_stream(it, scan_steps=2)
        assert net.iteration == 0


class TestTokenFiles:
    @pytest.mark.parametrize("vocab,shift", [(64, 0), (1000, 300)])
    def test_byte_identical_and_cross_read(self, tmp_path, vocab, shift):
        rng = np.random.default_rng(2)
        toks = rng.integers(0, min(vocab, 64), (10, 17)) + shift
        pt, pj = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
        tstream.write_token_file(pt, toks, vocab=vocab)
        jstream.write_token_file(pj, toks, vocab=vocab)
        assert open(pt, "rb").read() == open(pj, "rb").read()
        itemsize = 1 if vocab <= 256 else 2
        assert tstream.read_token_file_header(pj) == (10, 17, vocab,
                                                      itemsize)
        assert jstream.read_token_file_header(pt) == (10, 17, vocab,
                                                      itemsize)
        for port_reads, path in ((True, pj), (False, pt)):
            mod = tstream if port_reads else jstream
            it = mod.TokenSequenceFileIterator(path, batch_size=4)
            assert it.total_examples() == 10 and it.input_columns() == 16
            feats, labels = [], []
            while (ds := it.next()) is not None:
                feats.append(np.asarray(ds.features))
                labels.append(np.asarray(ds.labels))
            np.testing.assert_array_equal(np.concatenate(feats),
                                          toks[:, :-1])
            np.testing.assert_array_equal(np.concatenate(labels),
                                          toks[:, 1:])

    @pytest.mark.parametrize("bad", [[[0, 99]], [[-1, 3]]])
    def test_rejects_out_of_range(self, tmp_path, bad):
        for mod in (tstream, jstream):
            with pytest.raises(ValueError, match="outside"):
                mod.write_token_file(str(tmp_path / "x.bin"),
                                     np.array(bad), vocab=64)

    def test_rejects_other_files(self, tmp_path):
        p = tmp_path / "not.bin"
        p.write_bytes(b"NOTATOKENFILE" + bytes(20))
        with pytest.raises(ValueError, match="DL4JTOK1"):
            tstream.read_token_file_header(str(p))

    def test_skip_and_resume(self, work):
        it = tstream.TokenSequenceFileIterator(work["tokens"], batch_size=B)
        assert it.skip_batches(3) == 3
        want = np.asarray(it.next().features)
        it2 = tstream.TokenSequenceFileIterator(work["tokens"], batch_size=B)
        it2.load_state_dict({"cursor": 3 * B})
        np.testing.assert_array_equal(np.asarray(it2.next().features), want)
        np.testing.assert_array_equal(want,
                                      work["toks"][3 * B:4 * B, :-1])


def _write_cifar(path, imgs, labels):
    rows = np.concatenate([labels.astype(np.uint8)[:, None],
                           imgs.reshape(len(imgs), -1)], axis=1)
    rows.astype(np.uint8).tofile(path)


class TestCifarBinStream:
    def test_rows_across_files_match_jax(self, tmp_path):
        rng = np.random.default_rng(0)
        imgs = rng.integers(0, 255, (50, 3, 32, 32), np.uint8)
        labels = rng.integers(0, 10, 50).astype(np.uint8)
        p1, p2 = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
        _write_cifar(p1, imgs[:30], labels[:30])
        _write_cifar(p2, imgs[30:], labels[30:])
        it = tstream.CifarBinStreamIterator([p1, p2], batch_size=16)
        jit_ = jstream.CifarBinStreamIterator([p1, p2], batch_size=16)
        assert it.total_examples() == jit_.total_examples() == 50
        sizes, feats = [], []
        while (ds := it.next()) is not None:
            jds = jit_.next()
            np.testing.assert_array_equal(ds.features, jds.features)
            np.testing.assert_array_equal(ds.labels, jds.labels)
            sizes.append(len(ds.features))
            feats.append(ds.features)
        assert jit_.next() is None
        assert sizes == [16, 14, 16, 4]    # batches never span files
        np.testing.assert_array_equal(np.concatenate(feats), imgs)

    @pytest.mark.parametrize("wrapped", [False, True])
    def test_resume_from_state_dict(self, tmp_path, wrapped):
        rng = np.random.default_rng(1)
        imgs = rng.integers(0, 255, (40, 3, 32, 32), np.uint8)
        labels = rng.integers(0, 10, 40).astype(np.uint8)
        p = str(tmp_path / "a.bin")
        _write_cifar(p, imgs, labels)

        def make():
            it = tstream.CifarBinStreamIterator([p], batch_size=8)
            return NativeAsyncDataSetIterator(it, queue_size=2) if (
                wrapped) else it

        it = make()
        it.next()
        it.next()
        state = it.state_dict()
        want = np.asarray(it.next().features)
        it2 = make()
        it2.load_state_dict(state)
        np.testing.assert_array_equal(np.asarray(it2.next().features), want)
        np.testing.assert_array_equal(want, imgs[16:24])

    def test_rejects_bad_file(self, tmp_path):
        p = tmp_path / "bad.bin"
        p.write_bytes(b"\x01" * 100)
        with pytest.raises(ValueError, match="not a CIFAR-10"):
            tstream.CifarBinStreamIterator([str(p)], batch_size=4)


class TestWideCnn:
    def test_conf_json_matches_jax(self):
        assert tzoo.wide_cnn().to_json() == jzoo.wide_cnn().to_json()

    def test_forward_and_one_fit_step_from_a_jax_zip(self, tmp_path):
        path = str(tmp_path / "wide.zip")
        # 16x16 images: the layers of the 32x32 default, a quarter of
        # the CPU time
        jnet = JNet(jzoo.wide_cnn(height=16, width=16, lr=0.01)).init()
        jwrite(jnet, path)
        net = restore_model(path, device="cpu")
        rng = np.random.default_rng(3)
        x = rng.normal(size=(2, 3, 16, 16)).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 2)]
        np.testing.assert_allclose(_np(net.output(x)),
                                   np.asarray(jnet.output(x)), **FWD_TOL)
        net.fit(DataSet(x, y))
        jnet.fit(JDataSet(x, y))
        np.testing.assert_allclose(float(net.score_value),
                                   float(jnet.score_value),
                                   rtol=SCORE_RTOL)
        _assert_params(net, jnet.params, rtol=5e-3, atol=1e-6)
