"""ComputationGraph in the PyTorch port against the JAX package.

Every graph is built by the same builder code in both packages (the
conf JSON must be byte-identical) and every net is JAX-initialised and
loaded into the port through a model zip, never two independent inits.
Inputs are numpy, made from a seed.

- The conf: JSON both ways, ``topological_order`` on random DAGs with
  ties (Kahn over a sorted ready queue), validation errors.
- The forward of every vertex kind (Layer with a preprocessor, Merge,
  ElementWise with each op, Subset, Preprocessor, LastTimeStep under a
  mask, DuplicateToTimeSeries) on a two-input, two-output graph with a
  masked GravesLSTM: every vertex's activation within 1e-4.
- Training: 4-step ``fit`` and ``fit_scan`` trajectories of a small
  transformer DAG (two blocks meeting in an ``ElementWiseVertex(add)``)
  with dense attention, and with K1 on both sides (JAX's Pallas kernel
  in interpret mode, the port's plain ``flash_attention_reference``);
  ``MultiDataSet`` training of the two-output graph; truncated BPTT and
  ``rnn_time_step`` on an LSTM graph; ``pretrain_graph`` on an RBM graph
  fed JAX's draws; ``generate`` ids.
- Zips both ways; the flat-parameter surface (``params_flat`` equal to
  JAX's ``ravel_pytree`` on a 12-layer MLN and on a graph,
  ``set_params_flat`` of a JAX vector, ``clone`` independence).

Tolerances: forwards 1e-4 (float32 in both, summed in other orders);
trajectories 5e-3 relative on losses (``__graft_entry__.py``'s) and
1e-4 on params; greedy ids identical at float32."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.flatten_util import ravel_pytree

import deeplearning4j_tpu.nn.graph as jgraph_mod
import deeplearning4j_tpu.nn.layers.attention as jattn_mod
from deeplearning4j_tpu.datasets import markov as jmarkov
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMulti
from deeplearning4j_tpu.datasets.iterator import (
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import conf as jconf_pkg
from deeplearning4j_tpu.nn.conf import graph_conf as jgc
from deeplearning4j_tpu.nn.conf import layers as jL
from deeplearning4j_tpu.nn.conf import enums as jenums
from deeplearning4j_tpu.nn.conf import preprocessors as jpp
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss
from deeplearning4j_tpu.util.model_serializer import restore_model as jrestore
from deeplearning4j_tpu.util.model_serializer import write_model as jwrite

import deeplearning4j_tpu_torch.nn.graph as tgraph_mod
import deeplearning4j_tpu_torch.nn.layers.attention as tattn_mod
import deeplearning4j_tpu_torch.nn.layers.pretrain as tpre
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.nn import conf as tconf_pkg
from deeplearning4j_tpu_torch.nn.conf import enums as tenums
from deeplearning4j_tpu_torch.nn.conf import graph_conf as tgc
from deeplearning4j_tpu_torch.nn.conf import layers as tL
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpp
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.ops.losses import LossFunction as TLoss
from deeplearning4j_tpu_torch.util.model_serializer import (
    restore_model,
    write_model,
)
from torch_port_threads import one_torch_thread  # noqa: F401

FWD_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 5e-3
PARAM_ATOL = 1e-4

JAX = types.SimpleNamespace(NNC=jconf_pkg.NeuralNetConfiguration, L=jL,
                            G=jgc, PP=jpp, E=jenums, Loss=JLoss,
                            TB=jattn_mod.TransformerBlock)
PORT = types.SimpleNamespace(NNC=tconf_pkg.NeuralNetConfiguration, L=tL,
                             G=tgc, PP=tpp, E=tenums, Loss=TLoss,
                             TB=tattn_mod.TransformerBlock)

V, W, T = 16, 32, 16
SEQ_C, STATIC_C = 5, 3


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------- builders
def dag_conf(p, width=W, n_heads=4, skip=("block0", "block1")):
    """A small transformer DAG: two blocks (``skip`` names the pair that
    meets in an add vertex; "block1" is also the second block's own
    input chain), LayerNorm, softmax output; Adam with warmup_cosine."""
    b = (p.NNC.Builder().seed(3).learning_rate(1e-2)
         .lr_policy("warmup_cosine").lr_warmup_steps(2).lr_total_steps(100)
         .updater(p.E.Updater.ADAM).activation("identity")
         .weight_init(p.E.WeightInit.XAVIER).graph_builder()
         .add_inputs("in"))
    b.add_layer("block0", p.TB(n_in=V, n_out=width, n_heads=n_heads,
                               causal=True), "in")
    b.add_layer("block1", p.TB(n_in=width, n_out=width, n_heads=n_heads,
                               causal=True), "block0")
    b.add_vertex("skip", p.G.ElementWiseVertex(op=p.G.ElementWiseOp.ADD),
                 *skip)
    b.add_layer("ln", p.L.LayerNormalization(n_in=width, n_out=width),
                "skip")
    b.add_layer("out", p.L.RnnOutputLayer(
        n_in=width, n_out=V, activation="softmax",
        loss_function=p.Loss.MCXENT), "ln")
    return b.set_outputs("out").build()


def vertices_conf(p, op="add"):
    """Two inputs ("seq" [N, 5, T] masked, "static" [N, 3]) and two
    outputs, through every vertex kind."""
    G = p.G
    b = (p.NNC.Builder().seed(5).learning_rate(0.05).activation("tanh")
         .graph_builder().add_inputs("seq", "static"))
    b.add_layer("lstm", p.L.GravesLSTM(n_in=SEQ_C, n_out=6), "seq")
    b.add_vertex("last", G.LastTimeStepVertex(mask_input="seq"), "lstm")
    b.add_vertex("norm", G.PreprocessorVertex(
        preprocessor=p.PP.ZeroMeanAndUnitVariancePreProcessor()), "static")
    b.add_layer("dense", p.L.DenseLayer(n_in=STATIC_C, n_out=6), "norm",
                preprocessor=p.PP.ZeroMeanPrePreProcessor())
    b.add_vertex("ew", G.ElementWiseVertex(op=G.ElementWiseOp(op)),
                 "last", "dense")
    b.add_vertex("merge", G.MergeVertex(), "ew", "dense")
    b.add_vertex("subset", G.SubsetVertex(from_index=2, to_index=9),
                 "merge")
    b.add_vertex("dup", G.DuplicateToTimeSeriesVertex(
        reference_input="seq"), "subset")
    b.add_layer("seq_out", p.L.RnnOutputLayer(
        n_in=8, n_out=3, activation="softmax",
        loss_function=p.Loss.MCXENT), "dup")
    b.add_layer("cls_out", p.L.OutputLayer(
        n_in=8, n_out=2, activation="softmax",
        loss_function=p.Loss.MCXENT), "subset")
    return b.set_outputs("seq_out", "cls_out").build()


def lstm_conf(p, tbptt=True):
    b = (p.NNC.Builder().seed(42).learning_rate(0.05).activation("tanh")
         .graph_builder().add_inputs("in")
         .add_layer("lstm", p.L.GravesLSTM(n_in=3, n_out=4), "in")
         .add_layer("lstm2", p.L.GravesLSTM(n_in=4, n_out=4), "lstm")
         .add_layer("out", p.L.RnnOutputLayer(
             n_in=4, n_out=2, activation="softmax",
             loss_function=p.Loss.MCXENT), "lstm2")
         .set_outputs("out"))
    if tbptt:
        b = (b.backprop_type(p.E.BackpropType.TRUNCATED_BPTT)
             .t_bptt_forward_length(5).t_bptt_backward_length(5))
    return b.build()


def rbm_conf(p):
    return (p.NNC.Builder().seed(4).learning_rate(0.1)
            .updater(p.E.Updater.SGD).activation("sigmoid")
            .graph_builder().add_inputs("in")
            .add_layer("rbm0", p.L.RBM(n_in=12, n_out=8), "in")
            .add_layer("rbm1", p.L.RBM(n_in=8, n_out=6), "rbm0")
            .add_layer("out", p.L.OutputLayer(
                n_in=6, n_out=3, activation="softmax",
                loss_function=p.Loss.MCXENT), "rbm1")
            .set_outputs("out").pretrain(True).build())


BUILDERS = {"dag": dag_conf, "vertices": vertices_conf,
            "lstm": lstm_conf, "rbm": rbm_conf}


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    d = tmp_path_factory.mktemp("graph_zips")
    out = {}
    for name, make in BUILDERS.items():
        out[name] = str(d / f"{name}.zip")
        jwrite(JGraph(make(JAX)).init(), out[name])
    for op in ("subtract", "product", "average", "max"):
        out[f"vertices_{op}"] = str(d / f"vertices_{op}.zip")
        jwrite(JGraph(vertices_conf(JAX, op)).init(), out[f"vertices_{op}"])
    flash = dag_conf(JAX, width=128, n_heads=2)
    out["flash"] = str(d / "flash.zip")
    jwrite(JGraph(flash).init(), out["flash"])
    return out


def _pair(zips, name):
    return jrestore(zips[name]), restore_model(zips[name], device="cpu")


def _assert_params_close(tnet, jnet, atol=PARAM_ATOL):
    for v, sub in jnet.params.items():
        for k, p in sub.items():
            np.testing.assert_allclose(_np(tnet.params[v][k]), np.asarray(p),
                                       atol=atol, rtol=0, err_msg=f"{v}_{k}")


def _markov(n, t=T, sample_seed=1):
    f, y, _ = jmarkov.markov_lm_batches(V, n, t, seed=0,
                                        sample_seed=sample_seed)
    return f, y


def _vertex_data(seed=0, n=4):
    rng = np.random.default_rng(seed)
    seq = rng.normal(size=(n, SEQ_C, T)).astype(np.float32)
    static = rng.normal(size=(n, STATIC_C)).astype(np.float32)
    mask = np.ones((n, T), np.float32)
    mask[1, 9:] = 0.0
    mask[2, 3:] = 0.0
    mask[3, :] = 0.0                         # no real step at all
    ys = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (n, T))]
    ys = ys.transpose(0, 2, 1).copy()
    yc = np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]
    return seq, static, mask, ys, yc


# ------------------------------------------------------------------ conf
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_conf_json_is_identical_both_ways(name):
    """The port's builder writes JAX's JSON byte for byte; each parses
    the other's and re-serializes it unchanged."""
    jc, tc = BUILDERS[name](JAX), BUILDERS[name](PORT)
    assert tc.to_json() == jc.to_json()
    assert (tgc.ComputationGraphConfiguration.from_json(jc.to_json())
            .to_json() == jc.to_json())
    assert (jgc.ComputationGraphConfiguration.from_json(tc.to_json())
            .to_json() == jc.to_json())
    assert tc.clone().to_json() == jc.to_json()


def _random_dag(pkg, seed):
    """A random DAG over shuffled names, many vertices ready at once."""
    rng = np.random.default_rng(seed)
    names = [f"{c}{i}" for i, c in enumerate("zqamkbxeoc")]
    rng.shuffle(names)
    conf = pkg.G.ComputationGraphConfiguration(network_inputs=["in"])
    for i, name in enumerate(names):
        k = int(rng.integers(0, min(i, 3) + 1))
        ins = ["in"] if k == 0 else list(rng.choice(names[:i], k,
                                                    replace=False))
        conf.vertices[name] = pkg.G.MergeVertex()
        conf.vertex_inputs[name] = [str(x) for x in ins]
    conf.network_outputs = [names[-1]]
    return conf


@pytest.mark.parametrize("seed", range(6))
def test_topological_order_matches_jax_on_ties(seed):
    jc, tc = _random_dag(JAX, seed), _random_dag(PORT, seed)
    assert tc.topological_order() == jc.topological_order()
    assert tc.to_json() == jc.to_json()


def test_validation_errors_match_jax():
    for pkg in (JAX, PORT):
        conf = BUILDERS["lstm"](pkg)
        conf.vertex_inputs["lstm"] = ["out"]
        with pytest.raises(ValueError, match="cycle"):
            conf.topological_order()
        b = (pkg.NNC.Builder().graph_builder().add_inputs("in")
             .add_layer("out", pkg.L.OutputLayer(n_in=4, n_out=2), "nope")
             .set_outputs("out"))
        with pytest.raises(ValueError, match="unknown input"):
            b.build()
    bad = (PORT.NNC.Builder().graph_builder().add_inputs("in")
           .add_layer("d", tL.DenseLayer(n_in=4, n_out=2), "in")
           .set_outputs("d").build())
    with pytest.raises(ValueError, match="output layer vertex"):
        ComputationGraph(bad, device="cpu")


# --------------------------------------------------------------- forward
@pytest.mark.parametrize("op", ["add", "subtract", "product", "average",
                                "max"])
def test_every_vertex_kind_matches_jax(zips, op):
    """``feed_forward`` of the two-input graph with the time mask riding
    the "seq" edge (a row with no real step at all included): every
    vertex within 1e-4; ``output`` gives both outputs; ``score`` of a
    ``MultiDataSet`` with both masks."""
    name = "vertices" if op == "add" else f"vertices_{op}"
    jnet, tnet = _pair(zips, name)
    seq, static, mask, ys, yc = _vertex_data(1)
    ja = jnet._forward_fn(jnet.params, jnet.state,
                          {"seq": jnp.asarray(seq),
                           "static": jnp.asarray(static)},
                          None, False, {"seq": jnp.asarray(mask)})[0]
    with torch.no_grad():
        ta = tnet._forward_fn(tnet.params, tnet.state,
                              {"seq": torch.as_tensor(seq),
                               "static": torch.as_tensor(static)},
                              None, False, {"seq": torch.as_tensor(mask)})[0]
    assert set(ta) == set(ja)
    for k in ja:
        np.testing.assert_allclose(_np(ta[k]), np.asarray(ja[k]),
                                   err_msg=k, **FWD_TOL)
    for a, b in zip(tnet.output(seq, static), jnet.output(seq, static)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **FWD_TOL)
    lmask = mask.copy()
    lmask[3, 0] = 1.0
    jm = JMulti([seq, static], [ys, yc], [mask, None], [lmask, None])
    tm = MultiDataSet([seq, static], [ys, yc], [mask, None], [lmask, None])
    np.testing.assert_allclose(tnet.score(tm), jnet.score(jm), rtol=1e-5)


def test_last_time_step_is_a_gather_as_jax_indexes():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 3, 7)).astype(np.float32)
    mask = (rng.uniform(size=(5, 7)) < 0.6).astype(np.float32)
    mask[0] = 0.0
    mask[1] = 1.0
    mask[2, :] = [1, 0, 1, 0, 0, 0, 0]
    want = np.asarray(jgraph_mod._last_time_step(jnp.asarray(x),
                                                 jnp.asarray(mask)))
    got = tgraph_mod._last_time_step(torch.as_tensor(x),
                                     torch.as_tensor(mask))
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        _np(tgraph_mod._last_time_step(torch.as_tensor(x), None)),
        x[:, :, -1])


def test_dag_forward_matches_jax(zips):
    jnet, tnet = _pair(zips, "dag")
    f, _ = _markov(3)
    np.testing.assert_allclose(_np(tnet.output(f)[0]),
                               np.asarray(jnet.output(f)[0]), **FWD_TOL)
    assert tnet.order == jnet.order


# -------------------------------------------------------------- training
def _fit_both(jnet, tnet, batches):
    jl, tl = [], []
    for f, y in batches:
        jnet.fit(JDataSet(f, y))
        tnet.fit(DataSet(f, y))
        jl.append(float(jnet.score_value))
        tl.append(float(tnet.score_value))
    return np.asarray(jl), np.asarray(tl)


def test_dag_fit_trajectory_matches_jax(zips):
    jnet, tnet = _pair(zips, "dag")
    f, y = _markov(8)
    batches = [(f[i:i + 2], y[i:i + 2]) for i in range(0, 8, 2)]
    jl, tl = _fit_both(jnet, tnet, batches)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_params_close(tnet, jnet)
    assert tnet.iteration == jnet.iteration == 4


def test_dag_fit_trajectory_with_flash_matches_jax(zips, monkeypatch):
    """Both sides on K1: JAX's Pallas kernel in interpret mode, the
    port's plain version (its dispatch patched to take K1)."""
    calls = {"jax": 0, "port": 0}

    def jax_flash(use_flash, q, mask):
        calls["jax"] += 1
        return True

    def port_flash(use_flash, q, mask):
        calls["port"] += 1
        return True

    monkeypatch.setattr(jattn_mod, "_should_use_flash", jax_flash)
    monkeypatch.setattr(tattn_mod, "_should_use_flash", port_flash)
    jnet, tnet = _pair(zips, "flash")
    f, y = _markov(8, t=256)
    batches = [(f[i:i + 2], y[i:i + 2]) for i in range(0, 8, 2)]
    with pltpu.force_tpu_interpret_mode():
        jl, tl = _fit_both(jnet, tnet, batches)
    assert calls["jax"] >= 2 and calls["port"] == 2 * 4
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_params_close(tnet, jnet)


def test_dag_fit_scan_matches_jax_and_the_fit_loop(zips):
    jnet, tnet = _pair(zips, "dag")
    loop = restore_model(zips["dag"], device="cpu")
    f, y = _markov(8, sample_seed=2)
    fs = np.stack([f[i:i + 2] for i in range(0, 8, 2)])
    ys = np.stack([y[i:i + 2] for i in range(0, 8, 2)])
    jl = np.asarray(jnet.fit_scan(fs, ys))
    tl = _np(tnet.fit_scan({"in": fs}, [ys]))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_params_close(tnet, jnet)
    for fb, yb in zip(fs, ys):
        loop.fit(DataSet(fb, yb))
    for v, sub in loop.params.items():
        for k, p in sub.items():
            torch.testing.assert_close(tnet.params[v][k], p, rtol=0,
                                       atol=1e-6)
    assert tnet.iteration == 4
    health = tnet.train_telemetry.consume()["health"]
    assert health["grad_norm"].shape == (4,)


@pytest.fixture
def replaying_runner(monkeypatch):
    """CPU tensors treated as card tensors by ``GraphRunner``, with a
    stand-in capture whose replay reruns the body on the static inputs
    and writes the results into the captured outputs, as a graph replay
    overwrites them (``tests/test_torch_port_fit_scan.py``'s)."""
    from deeplearning4j_tpu_torch.nn import cuda_graphs
    from deeplearning4j_tpu_torch.nn.streaming import tree_map

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


def test_fit_scan_through_one_captured_step_equals_the_eager_loop(
        zips, replaying_runner):
    """The two-input, two-output graph with masks on both sides: two
    windows through one captured step (its static inputs refilled every
    step: inputs by name, labels as a tuple, masks) equal the eager
    loop's params and updater state bit for bit."""
    graph = restore_model(zips["vertices"], device="cpu")
    eager = restore_model(zips["vertices"], device="cpu")
    eager.train_graphs = None
    data = [_vertex_data(20 + s) for s in range(3)]
    xs = {"seq": np.stack([d[0] for d in data]),
          "static": np.stack([d[1] for d in data])}
    ys = [np.stack([d[3] for d in data]), np.stack([d[4] for d in data])]
    ms = {"seq": np.stack([d[2] for d in data])}
    lms = {"seq_out": np.stack([d[2] for d in data])}
    for _ in range(2):
        a = graph.fit_scan(xs, ys, ms, lms)
        b = eager.fit_scan(xs, ys, ms, lms)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(graph.train_graphs) == 1 and graph.train_graphs.captures == 1
    torch.testing.assert_close(graph.params_flat(), eager.params_flat(),
                               rtol=0, atol=0)
    assert all(torch.equal(x, y) for x, y in zip(
        _leaves_sorted(graph.updater_state),
        _leaves_sorted(eager.updater_state)))


def test_fit_scan_refusals_match_jax(zips):
    _, tnet = _pair(zips, "dag")
    f, y = _markov(2)
    with pytest.raises(ValueError, match="inputs"):
        tnet.fit_scan({"nope": f[None]}, y[None])
    with pytest.raises(ValueError, match="not network inputs"):
        tnet.fit_scan(f[None], y[None], masks_stacked={"x": f[None, :, 0]})
    tnet.conf.vertices["ln"].conf.optimization_algo = (
        tenums.OptimizationAlgorithm.LBFGS)
    with pytest.raises(ValueError, match="only supports SGD"):
        tnet.fit_scan(f[None], y[None])
    with pytest.raises(NotImplementedError, match="item 10"):
        tnet.fit_stream(iter(()))


def test_multi_dataset_training_matches_jax(zips):
    """Two inputs, two outputs, masks on both sides: 3 ``fit`` steps of
    a ``MultiDataSet`` (Adam-free SGD at lr 0.05)."""
    jnet, tnet = _pair(zips, "vertices")
    jl, tl = [], []
    for s in range(3):
        seq, static, mask, ys, yc = _vertex_data(10 + s)
        jnet.fit(JMulti([seq, static], [ys, yc], [mask, None], [mask, None]))
        tnet.fit(MultiDataSet([seq, static], [ys, yc], [mask, None],
                              [mask, None]))
        jl.append(float(jnet.score_value))
        tl.append(float(tnet.score_value))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_params_close(tnet, jnet)


def _seq_data(seed, n=4, t=20):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3, t)).astype(np.float32)
    y = np.zeros((n, 2, t), np.float32)
    y[np.arange(n)[:, None], rng.integers(0, 2, (n, t)),
      np.arange(t)[None, :]] = 1.0
    return x, y


def test_tbptt_on_an_lstm_graph_matches_jax(zips):
    """T=20 in windows of 5: 4 steps a fit, the state carried."""
    jnet, tnet = _pair(zips, "lstm")
    jl, tl = [], []

    class Scores:
        invoked_every = 1

        def __init__(self, out):
            self.out = out

        def iteration_done(self, model, iteration):
            self.out.append(float(model.score_value))

    jnet.set_listeners(Scores(jl))
    tnet.set_listeners(Scores(tl))
    for s in range(2):
        x, y = _seq_data(s)
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
    assert len(tl) == len(jl) == 8
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_params_close(tnet, jnet)


def test_rnn_time_step_matches_jax(zips):
    """Step by step (2-D inputs) then a 3-D chunk, on carried state; then
    a cleared row restarts from the initial carry."""
    jnet, tnet = _pair(zips, "lstm")
    x, _ = _seq_data(7, t=6)
    for t in range(3):
        a = tnet.rnn_time_step(x[:, :, t])[0]
        b = jnet.rnn_time_step(x[:, :, t])[0]
        assert a.shape == (4, 2)
        np.testing.assert_allclose(_np(a), np.asarray(b), **FWD_TOL)
    a = tnet.rnn_time_step(x[:, :, 3:])[0]
    b = jnet.rnn_time_step(x[:, :, 3:])[0]
    np.testing.assert_allclose(_np(a), np.asarray(b), **FWD_TOL)
    tnet.rnn_clear_previous_state(slots=[1])
    jnet.rnn_clear_previous_state(slots=[1])
    np.testing.assert_allclose(_np(tnet.rnn_time_step(x[:, :, 0])[0]),
                               np.asarray(jnet.rnn_time_step(x[:, :, 0])[0]),
                               **FWD_TOL)


def test_pretrain_graph_matches_jax_with_fed_draws(zips, monkeypatch):
    """``fit`` on an iterator of a ``pretrain(True)`` RBM graph: each RBM
    vertex pretrained in topological order, fed the draws JAX's key
    chain makes (``graph._key`` split once an update), then one
    backprop epoch; every score within 5e-3 relative, params 1e-4."""
    from test_torch_port_pretrain import _jax_rbm_noise

    jnet, tnet = _pair(zips, "rbm")
    rng = np.random.default_rng(4)
    batches = [((rng.uniform(size=(8, 12)) < 0.5).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
               for _ in range(3)]
    key, queue = jnet._key, []
    for name in tnet.order:
        lc = tnet.conf.vertices[name].conf.layer
        if not isinstance(lc, tL.RBM):
            continue
        for _ in batches:
            key, sub = jax.random.split(key)
            queue.append(_jax_rbm_noise(lc, sub, 8))
    monkeypatch.setattr(tpre.RBMImpl, "draw_noise",
                        classmethod(lambda cls, conf, gen, x: queue.pop(0)))
    js, ts = [], []

    class Scores:
        invoked_every = 1

        def __init__(self, out):
            self.out = out

        def iteration_done(self, model, iteration):
            self.out.append(float(model.score_value))

    jnet.set_listeners(Scores(js))
    tnet.set_listeners(Scores(ts))
    jnet.fit(JListIterator([JDataSet(x, y) for x, y in batches]))
    tnet.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
    assert not queue and len(ts) == len(js) == 9
    np.testing.assert_allclose(ts, js, rtol=LOSS_RTOL)
    _assert_params_close(tnet, jnet)


def test_generate_ids_match_jax(zips):
    jnet, tnet = _pair(zips, "dag")
    f, _ = _markov(2, t=5, sample_seed=3)
    for n in (1, 12):
        tnet.rnn_clear_previous_state()
        jnet.rnn_clear_previous_state()
        got = tnet.generate(f, n)
        want = np.asarray(jnet.generate(f, n))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got).astype(np.int64), want)


# ------------------------------------------------------------------ zips
def test_graph_zips_round_trip_both_ways(zips, tmp_path):
    """A trained port graph's zip restores in JAX (params, updater state,
    iteration; the same forward) and back in the port."""
    jnet, tnet = _pair(zips, "dag")
    f, y = _markov(2)
    tnet.fit(DataSet(f, y))
    path = str(tmp_path / "port.zip")
    tnet.save(path)
    back = jrestore(path)
    assert isinstance(back, JGraph) and back.iteration == 1
    np.testing.assert_allclose(np.asarray(back.output(f)[0]),
                               _np(tnet.output(f)[0]), **FWD_TOL)
    want = ravel_pytree(back.updater_state)[0]
    got = torch.cat([t.reshape(-1) for t in _leaves_sorted(
        tnet.updater_state)])
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    again = ComputationGraph.load(path, device="cpu")
    torch.testing.assert_close(again.params_flat(), tnet.params_flat(),
                               rtol=0, atol=0)
    mln = _mln_zip(tmp_path)
    with pytest.raises(TypeError, match="holds a MultiLayerNetwork"):
        ComputationGraph.load(mln, device="cpu")


def _leaves_sorted(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_sorted(tree[k])]
    return [tree]


def _mln_zip(tmp_path):
    path = str(tmp_path / "mlp.zip")
    jwrite(JNet(jzoo.mlp(sizes=(6, 5, 3))).init(), path)
    return path


# ---------------------------------------------------- the flat surface
def _deep_mlp(p):
    b = (p.NNC.Builder().seed(9).learning_rate(0.1).activation("tanh")
         .list())
    for i in range(11):
        b.layer(i, p.L.DenseLayer(n_in=4 if i == 0 else 5, n_out=5))
    b.layer(11, p.L.OutputLayer(n_in=5, n_out=3, activation="softmax",
                                loss_function=p.Loss.MCXENT))
    return b.build()


def test_params_flat_is_ravel_pytree_on_a_12_layer_mlp(tmp_path):
    """Layers "0", "1", "10", "11", "2", ...: the port's flat vector is
    JAX's element for element, a JAX vector set into the port lands on
    the same params, and ``num_params`` agrees."""
    path = str(tmp_path / "deep.zip")
    jnet = JNet(_deep_mlp(JAX)).init()
    jwrite(jnet, path)
    tnet = restore_model(path, device="cpu")
    want, _ = ravel_pytree(jnet.params)
    np.testing.assert_array_equal(_np(tnet.params_flat()), np.asarray(want))
    assert tnet.num_params() == jnet.num_params()
    v = np.random.default_rng(0).normal(size=want.shape).astype(np.float32)
    jnet.set_params_flat(v)
    tnet.set_params_flat(v)
    for k, p in jnet.param_table().items():
        np.testing.assert_array_equal(_np(tnet.param_table()[k]),
                                      np.asarray(p), err_msg=k)
    np.testing.assert_array_equal(_np(tnet.params_flat()), v)


def test_params_flat_is_ravel_pytree_on_a_graph(zips):
    jnet, tnet = _pair(zips, "vertices")
    want, _ = ravel_pytree(jnet.params)
    np.testing.assert_array_equal(_np(tnet.params_flat()), np.asarray(want))
    assert tnet.num_params() == jnet.num_params()
    v = np.arange(want.shape[0], dtype=np.float32) / want.shape[0]
    tnet.set_params_flat(v)
    np.testing.assert_array_equal(_np(tnet.params_flat()), v)
    seq, static, _, _, _ = _vertex_data(3)
    jnet.params = jax.tree.map(jnp.asarray, ravel_pytree(jnet.params)[1](
        jnp.asarray(v)))
    np.testing.assert_allclose(_np(tnet.output(seq, static)[1]),
                               np.asarray(jnet.output(seq, static)[1]),
                               **FWD_TOL)


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_clone_is_independent(zips, tmp_path, kind):
    if kind == "graph":
        net = restore_model(zips["dag"], device="cpu")
        f, y = _markov(2)
        ds = DataSet(f, y)
    else:
        net = restore_model(_mln_zip(tmp_path), device="cpu")
        rng = np.random.default_rng(0)
        ds = DataSet(rng.normal(size=(4, 6)).astype(np.float32),
                     np.eye(3, dtype=np.float32)[[0, 1, 2, 0]])
    twin = net.clone()
    assert twin.conf is not net.conf
    assert twin.conf.to_json() == net.conf.to_json()
    before = net.params_flat().clone()
    torch.testing.assert_close(twin.params_flat(), before, rtol=0, atol=0)
    twin.fit(ds)
    torch.testing.assert_close(net.params_flat(), before, rtol=0, atol=0)
    assert twin.iteration == net.iteration + 1
    net.fit(ds)
    torch.testing.assert_close(net.params_flat(), twin.params_flat(),
                               rtol=0, atol=0)
    if kind == "mln":
        flat = net.unsharded_clone()
        assert flat.conf.to_json() == net.conf.to_json()
