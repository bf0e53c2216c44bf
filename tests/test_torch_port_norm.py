"""BatchNormalization, LocalResponseNormalization and EmbeddingLayer of
the PyTorch port against the JAX package: forward, gradients, the
running statistics through ``fit`` and through ``fit_scan``'s captured
step (a stand-in replay on the CPU), inference against training mode,
and model zips in both directions.

Every port net is loaded from a zip the JAX package wrote. Tolerances:
forward outputs and gradients 1e-4 (float32), one loss evaluation 1e-6,
trajectories 5e-3 relative on losses and 1e-4 on params and running
statistics."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.enums import Updater as JUpdater
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss
from deeplearning4j_tpu.util.model_serializer import (
    restore_model as jrestore,
    write_model as jwrite,
)

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.layers import normalization as tnorm
from deeplearning4j_tpu_torch.nn import cuda_graphs
from deeplearning4j_tpu_torch.nn.streaming import tree_leaves, tree_map
from deeplearning4j_tpu_torch.util.model_serializer import (
    restore_model,
    write_model,
)
from torch_port_threads import one_torch_thread  # noqa: F401

FWD_ATOL = 1e-4
GRAD_ATOL = 1e-4
LOSS_RTOL = 5e-3
PARAM_ATOL = 1e-4
N = 6


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def _cnn_conf(lock=False, lrn_n=5.0):
    """conv -> BatchNorm -> LRN -> dense -> BatchNorm -> softmax over
    [N, 2, 8, 8] images: BatchNorm on images and on [N, C]."""
    return (JNNC.Builder().seed(1).learning_rate(0.05)
            .updater(JUpdater.NESTEROVS).momentum(0.9).list()
            .layer(0, JL.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                          activation="relu"))
            .layer(1, JL.BatchNormalization(decay=0.8,
                                            lock_gamma_beta=lock))
            .layer(2, JL.LocalResponseNormalization(n=lrn_n, k=1.5,
                                                    alpha=0.3, beta=0.6))
            .layer(3, JL.DenseLayer(n_out=6, activation="tanh"))
            .layer(4, JL.BatchNormalization(gamma=1.5, beta=0.2))
            .layer(5, JL.OutputLayer(n_out=3, activation="softmax",
                                     loss_function=JLoss.MCXENT))
            .set_input_type(JInputType.convolutional(8, 8, 2)).build())


def _embedding_conf():
    return (JNNC.Builder().seed(2).learning_rate(0.1)
            .updater(JUpdater.ADAM).list()
            .layer(0, JL.EmbeddingLayer(n_in=10, n_out=4,
                                        activation="tanh"))
            .layer(1, JL.DenseLayer(n_in=4, n_out=5, activation="relu"))
            .layer(2, JL.OutputLayer(n_in=5, n_out=3, activation="softmax",
                                     loss_function=JLoss.MCXENT))
            .build())


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    d = tmp_path_factory.mktemp("norm_zips")
    confs = {"cnn": _cnn_conf(), "locked": _cnn_conf(lock=True),
             "lrn3": _cnn_conf(lrn_n=3.0), "embedding": _embedding_conf()}
    out = {}
    for name, conf in confs.items():
        out[name] = str(d / f"{name}.zip")
        jwrite(JNet(conf).init(), out[name])
    return out


def _pair(zips, name):
    return jrestore(zips[name]), restore_model(zips[name], device="cpu")


def _data(name, seed):
    rng = np.random.default_rng(seed)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, N)]
    if name == "embedding":
        return rng.integers(0, 10, (N, 1)).astype(np.float32), y
    return rng.normal(size=(N, 2, 8, 8)).astype(np.float32), y


def _close(tree_t, tree_j, atol, what):
    for k, v in tree_j.items():
        if isinstance(v, dict):
            _close(tree_t[k], v, atol, f"{what}/{k}")
        else:
            np.testing.assert_allclose(_np(tree_t[k]), np.asarray(v),
                                       atol=atol, rtol=0,
                                       err_msg=f"{what}/{k}")


@pytest.mark.parametrize("name", ["cnn", "locked", "lrn3", "embedding"])
def test_forward_and_gradients_match_jax(zips, name):
    """Inference (running statistics) and the training forward's
    gradients (batch statistics) against JAX's."""
    jnet, tnet = _pair(zips, name)
    x, y = _data(name, 0)
    np.testing.assert_allclose(_np(tnet.output(x)),
                               np.asarray(jnet.output(x)), atol=FWD_ATOL)
    js, jg = jnet.compute_gradient_and_score(JDataSet(x, y))
    ts, tg = tnet.compute_gradient_and_score(DataSet(x, y))
    assert abs(ts - js) <= 1e-6 * max(1.0, abs(js))
    jm, tm = jg.gradient_map(), tg.gradient_map()
    assert sorted(jm) == sorted(tm)
    for k in jm:
        np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]),
                                   atol=GRAD_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["cnn", "locked", "embedding"])
def test_fit_trajectory_and_running_stats_match_jax(zips, name):
    """4 ``fit`` steps: losses within 5e-3, params within 1e-4, and the
    BatchNorm running mean and var in ``state`` within 1e-4; after
    training, inference reads the running statistics, not the batch's."""
    jnet, tnet = _pair(zips, name)
    jl, tl = [], []
    for s in range(4):
        x, y = _data(name, 10 + s)
        jnet.fit(x, y)
        tnet.fit(x, y)
        jl.append(float(jnet.score_value))
        tl.append(float(tnet.score_value))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _close(tnet.params, jnet.params, PARAM_ATOL, "params")
    _close(tnet.state, jnet.state, PARAM_ATOL, "state")
    x, _ = _data(name, 20)
    np.testing.assert_allclose(_np(tnet.output(x)),
                               np.asarray(jnet.output(x)), atol=FWD_ATOL)


def test_batch_norm_is_the_population_variance():
    """Training mode normalizes by the biased variance (``jnp.var``), and
    the running stats move by ``decay``; inference reads them."""
    class Bean:
        decay, eps, lock_gamma_beta = 0.9, 1e-5, False

    class Conf:
        layer = Bean()

    x = torch.as_tensor(np.random.default_rng(1).normal(
        size=(4, 3)).astype(np.float32))
    params = {"gamma": torch.ones(3), "beta": torch.zeros(3)}
    state = {"mean": torch.zeros(3), "var": torch.ones(3)}
    out, new = tnorm.BatchNormImpl.apply(Conf, params, x, state, train=True)
    xn = x.numpy()
    want = (xn - xn.mean(0)) / np.sqrt(xn.var(0) + 1e-5)
    np.testing.assert_allclose(_np(out), want, atol=1e-5)
    np.testing.assert_allclose(_np(new["var"]), 0.9 + 0.1 * xn.var(0),
                               atol=1e-6)
    out_inf, same = tnorm.BatchNormImpl.apply(Conf, params, x, new)
    assert same is new
    np.testing.assert_allclose(
        _np(out_inf),
        (xn - _np(new["mean"])) / np.sqrt(_np(new["var"]) + 1e-5),
        atol=1e-5)


@pytest.fixture
def replaying_runner(monkeypatch):
    """CPU tensors treated as card tensors by ``GraphRunner``, with a
    stand-in capture whose replay reruns the body on the static inputs
    and writes the results into the captured outputs, as a graph
    replay overwrites them."""
    def capture(self, body, inputs, key):
        states = [gen.get_state() for gen in self.generators]
        outputs = body(tree_map(torch.clone, inputs))
        for gen, st in zip(self.generators, states):
            gen.set_state(st)

        class Graph:
            def replay(self):
                tree_map(lambda dst, src: dst.copy_(src), outputs,
                         body(inputs))

        self.captures += 1
        return cuda_graphs._Graph(Graph(), inputs, outputs, ())

    monkeypatch.setattr(cuda_graphs, "_on_card", lambda leaves: True)
    monkeypatch.setattr(cuda_graphs.GraphRunner, "_capture", capture)


def test_fit_scan_running_stats_come_out_of_the_replay(zips,
                                                       replaying_runner):
    """Two 3-step windows through one captured step: the running
    statistics the replays write are the net's state after each window,
    bit for bit those of the eager loop (not the capture's static
    inputs), and JAX's ``fit_scan`` within 1e-4."""
    jnet, graph = _pair(zips, "cnn")
    eager = restore_model(zips["cnn"], device="cpu")
    eager.train_graphs = None
    xs, ys = zip(*[_data("cnn", 30 + s) for s in range(3)])
    xs, ys = np.stack(xs), np.stack(ys)
    start = _np(graph.state["1"]["mean"]).copy()
    for _ in range(2):
        want = eager.fit_scan(xs, ys)
        got = graph.fit_scan(xs, ys)
        jnet.fit_scan(xs, ys)
        assert torch.equal(got, want)
        for a, b in zip(tree_leaves(graph.state), tree_leaves(eager.state)):
            assert torch.equal(a, b)
    assert np.abs(_np(graph.state["1"]["mean"]) - start).max() > 1e-3
    _close(graph.state, jnet.state, PARAM_ATOL, "state")
    _close(graph.params, jnet.params, PARAM_ATOL, "params")
    assert graph.train_graphs.captures == 1


@pytest.mark.parametrize("name", ["cnn", "embedding"])
def test_zip_round_trips_both_ways(zips, name, tmp_path):
    """JAX -> port -> 2 steps -> a port zip that JAX loads (params,
    updater state, the running statistics, the iteration) and trains on
    from there, matching the port's next step."""
    _, tnet = _pair(zips, name)
    for s in range(2):
        tnet.fit(*_data(name, 40 + s))
    path = str(tmp_path / "port.zip")
    write_model(tnet, path)
    back = jrestore(path)
    assert back.iteration == 2
    _close(tnet.params, back.params, 0.0, "params")
    _close(tnet.state, back.state, 0.0, "state")
    x, y = _data(name, 50)
    back.fit(x, y)
    tnet.fit(x, y)
    assert abs(float(back.score_value) - float(tnet.score_value)) <= (
        1e-5 * abs(float(back.score_value)))
    _close(tnet.state, back.state, 1e-6, "state")
