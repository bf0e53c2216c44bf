"""``fit_scan`` as the port captures it: ``grad_scale``, the gradient-
health scalars, the window's per-step updater scalars, the per-layer
dropout generators, and the captured bodies' freedom from host reads.

Scores, params and health are held against the JAX package from one
JAX-written zip (the small flagship of ``test_torch_port_training.py``:
width 32, 2 blocks, Adam with ``warmup_cosine``), K=3 steps at
``grad_scale`` 0.5 and 1.0: scores within 5e-3 relative, params within
1e-4 (the training tolerances), and the four health scalars within 1e-4
relative (f32). On the CPU ``fit_scan`` runs the captured graph's body
eagerly, so it must equal K ``fit`` calls bit for bit: the per-step
scalars ride as float32 tensors where ``fit`` passes host floats.

No host read inside a captured body: one ``fit_scan`` step and one
fused decode window (both layouts) run under a ``TorchDispatchMode``
that records ``aten._local_scalar_dense`` (``item``, ``tolist``,
``bool`` of a tensor), a tensor built from host data (``lift_fresh``,
the host-to-device copy of ``torch.tensor(..., device=...)``) and any
copy between devices; it must record none."""

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deeplearning4j_tpu.datasets import markov as jmarkov
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.util.model_serializer import write_model as jwrite

from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn import cuda_graphs
from deeplearning4j_tpu_torch.nn.conf.enums import Updater as TUpdater
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater.updaters import resolve_lr
from deeplearning4j_tpu_torch.optimize.telemetry import HEALTH_KEYS
from deeplearning4j_tpu_torch.nn.streaming import tree_map
from deeplearning4j_tpu_torch.serving import DecodeEngine, Request
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

SMALL = dict(vocab=16, width=32, n_layers=2, n_heads=4, lr=1e-2,
             warmup_steps=2, total_steps=100, seed=3)
LOSS_RTOL, PARAM_ATOL, HEALTH_RTOL = 5e-3, 1e-4, 1e-4
K = 3


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fit_scan") / "net.zip")
    jwrite(JNet(jzoo.transformer_lm_flagship(**SMALL)).init(), path)
    return path


@pytest.fixture(scope="module")
def window():
    batches = [jmarkov.markov_lm_batches(16, 2, 16, seed=0,
                                         sample_seed=s)[:2]
               for s in range(K)]
    return (np.stack([f for f, _ in batches]),
            np.stack([y for _, y in batches]))


def _np(t):
    return t.detach().cpu().double().numpy()


@pytest.mark.parametrize("grad_scale", [0.5, 1.0])
def test_fit_scan_scores_params_and_health_match_jax(zip_path, window,
                                                     grad_scale):
    jnet = JNet.load(zip_path)
    tnet = restore_model(zip_path, device="cpu")
    feats, labels = window
    js = np.asarray(jnet.fit_scan(feats, labels, grad_scale=grad_scale))
    ts = _np(tnet.fit_scan(feats, labels, grad_scale=grad_scale))
    np.testing.assert_allclose(ts, js, rtol=LOSS_RTOL)
    for key, p in jnet.param_table().items():
        np.testing.assert_allclose(_np(tnet.param_table()[key]),
                                   np.asarray(p), atol=PARAM_ATOL, rtol=0,
                                   err_msg=key)
    jh, th = jnet.train_telemetry.health, tnet.train_telemetry.health
    assert set(th) == set(jh) == set(HEALTH_KEYS)
    for key in HEALTH_KEYS:
        assert th[key].shape == (K,)
        np.testing.assert_allclose(_np(th[key]), np.asarray(jh[key]),
                                   rtol=HEALTH_RTOL, atol=0, err_msg=key)
    assert float(th["nonfinite_grads"].sum()) == 0.0
    assert tnet.iteration == jnet.iteration == K


def _nesterovs(conf):
    for c in conf.confs:
        c.updater = TUpdater.NESTEROVS
        c.lr_policy = None
        c.learning_rate_schedule = {0: 0.05, 2: 0.02}
        c.momentum_schedule = {1: 0.5, 2: 0.99}
    return conf


CONFS = {"adam_warmup_cosine": lambda: tzoo.transformer_lm_flagship(
             **SMALL),
         "nesterovs_momentum_schedule": lambda: _nesterovs(
             tzoo.transformer_lm_flagship(**SMALL))}


@pytest.mark.parametrize("name", list(CONFS))
def test_window_scalars_equal_the_host_values(name):
    net = MultiLayerNetwork(CONFS[name](), device="cpu").init()
    layout, table = net._window_scalars(1, 3)
    assert table.dtype == torch.float32 and table.shape[0] == 3
    for j, it in enumerate(range(1, 4)):
        col = 0
        for c, names in zip(net.conf.confs, layout):
            lr = resolve_lr(c, it)
            want = {"lr": lr}
            if name == "nesterovs_momentum_schedule":
                mu = {1: 0.5, 2: 0.99, 3: 0.99}[it]
                want.update(mu=mu, mu1=1.0 + mu)
            else:
                t = it + 1
                want["lr_bias"] = lr * (math.sqrt(1.0 - 0.999 ** t)
                                        / (1.0 - 0.9 ** t))
            assert names == list(want)
            for n, key in enumerate(names):
                assert table[j, col + n].item() == np.float32(want[key])
            col += len(names)
        assert col == table.shape[1]


@pytest.mark.parametrize("name", list(CONFS))
def test_cpu_fit_scan_equals_k_fit_calls_bit_for_bit(name, window):
    a = MultiLayerNetwork(CONFS[name](), device="cpu").init()
    b = MultiLayerNetwork(CONFS[name](), device="cpu").init()
    feats, labels = window
    for f, y in zip(feats, labels):
        a.fit(f, y)
    scores = b.fit_scan(feats, labels)
    assert float(scores[-1]) == float(a.score_value)
    for key, p in a.param_table().items():
        assert torch.equal(b.param_table()[key], p), key
    for si, st in a.updater_state.items():
        for k, leaf in st.items():
            for name_, t in leaf.items():
                assert torch.equal(b.updater_state[si][k][name_], t)


def _dropout_net(remat):
    conf = tzoo.transformer_lm_flagship(**SMALL)
    for c in conf.confs[:-1]:
        c.dropout = 0.25
    conf.remat = remat
    return MultiLayerNetwork(conf, device="cpu").init()


def test_fit_scan_dropout_draws_from_per_layer_generators(window):
    """Two nets from one seed draw the same masks; under remat each
    layer's generator is rewound for the recompute, so the params equal
    those without remat; and the masks move from step to step."""
    feats, labels = window
    nets = [_dropout_net(False), _dropout_net(False), _dropout_net(True)]
    scores = [n.fit_scan(feats, labels) for n in nets]
    assert torch.equal(scores[0], scores[1])
    torch.testing.assert_close(scores[2], scores[0], rtol=1e-6, atol=0)
    for key, p in nets[0].param_table().items():
        assert torch.equal(nets[1].param_table()[key], p)
        torch.testing.assert_close(nets[2].param_table()[key], p,
                                   rtol=1e-5, atol=1e-6)
    again = _dropout_net(False)
    same = again.fit_scan(feats[:1].repeat(2, 0), labels[:1].repeat(2, 0))
    assert float(same[0]) != float(same[1])


class _HostReads(TorchDispatchMode):
    """Records every op that reads a tensor back to the host or builds
    one from host data."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.__name__
        if "_local_scalar_dense" in name or "lift_fresh" in name:
            self.seen.append(name)
        elif "copy" in name:
            devs = {a.device for a in list(args) + list(kwargs.values())
                    if isinstance(a, torch.Tensor)}
            if len(devs) > 1 or kwargs.get("device") not in (None,
                                                              *devs):
                self.seen.append(name)
        return func(*args, **kwargs)


def test_the_host_read_recorder_sees_host_reads():
    x = torch.ones(3)
    with _HostReads() as mode:
        float(x.sum())
        torch.tensor(2.0) * x
    assert any("_local_scalar_dense" in n for n in mode.seen)
    assert any("lift_fresh" in n for n in mode.seen)


def test_a_fit_scan_step_reads_nothing_from_the_host(zip_path, window):
    net = restore_model(zip_path, device="cpu")
    feats, labels = window
    net.fit_scan(feats[:1], labels[:1])          # makes the generators
    layout, table = net._window_scalars(net.iteration, 1)
    ops = {"params": net.params, "state": net.state,
           "upd": net.updater_state, "x": net._tensor(feats[1]),
           "y": net._tensor(labels[1]), "fm": None, "lm": None,
           "scalars": table[0],
           "grad_scale": torch.full((), 0.5, dtype=torch.float32)}
    with torch.no_grad(), _HostReads() as mode:
        out = net._scan_step(ops, layout, net._scan_gens)
    assert mode.seen == []
    assert out["health"].shape == (len(HEALTH_KEYS),)


@pytest.mark.parametrize("paged", [False, True])
def test_a_fused_window_reads_nothing_from_the_host(zip_path, paged):
    net = restore_model(zip_path, device="cpu")
    kw = dict(paged_kv=True, block_tokens=8) if paged else {}
    eng = DecodeEngine(net, n_slots=2, decode_chunk=2, fused_rounds=2,
                       **kw)
    eng.submit(Request([1, 2, 3], 20, temperature=0.9, top_k=4))
    eng.submit(Request([4, 5], 20))
    eng.step()
    active = [0, 1]
    if paged:
        for s in active:
            eng._ensure_tab(eng._kv_tabs[s], 2 * eng.decode_chunk)
    ops = {"rnn": (eng._paged_rnn_rows(eng._kv_tabs) if paged
                   else eng._pool),
           "toks": eng._toks,
           "temps": eng._round_buffer("temps", eng._temps),
           "top_ks": eng._round_buffer("top_ks", eng._top_ks),
           "eos_ids": torch.full((2,), -1, dtype=torch.int64),
           "remaining": torch.full((2,), 17, dtype=torch.int64)}
    with torch.no_grad(), _HostReads() as mode:
        out = eng._fused_body(ops, 2)
    assert mode.seen == []
    assert out["seq"].shape == (2, 4) and out["n_valid"].tolist() == [4, 4]


@pytest.fixture
def replaying_runner(monkeypatch):
    """CPU tensors treated as card tensors by ``GraphRunner``, with a
    stand-in capture whose replay reruns the body on the static inputs
    and writes the results into the captured outputs, as a graph
    replay overwrites them."""
    def capture(self, body, inputs, key):
        # a capture runs nothing: the outputs' buffers come from a run
        # on copies, with the generators put back after it
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


def test_fit_scan_through_one_graph_per_key_equals_the_eager_loop(
        zip_path, window, replaying_runner):
    """Static inputs, outputs fed back as the next step's inputs, and
    the net's params never aliased to the graph's buffers: two windows
    through one captured step equal the eager loop bit for bit."""
    feats, labels = window
    eager = restore_model(zip_path, device="cpu")
    eager.train_graphs = None
    graph = restore_model(zip_path, device="cpu")
    before = {k: (p, p.clone()) for k, p in graph.param_table().items()}
    for _ in range(2):
        want = eager.fit_scan(feats, labels, grad_scale=0.5)
        got = graph.fit_scan(feats, labels, grad_scale=0.5)
        assert torch.equal(got, want)
    for key, p in eager.param_table().items():
        assert torch.equal(graph.param_table()[key], p), key
    for p, p0 in before.values():
        assert torch.equal(p, p0)          # the first window's inputs
    runner = graph.train_graphs
    assert len(runner) == 1 and runner.captures == 1
    graph.fit_scan(feats[:, :1], labels[:, :1])
    assert len(runner) == 2
