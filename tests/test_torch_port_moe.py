"""The mixture-of-experts slice of the PyTorch port against the JAX
package: capacity routing (``route_top_k``), ``moe_apply`` and its dense
reference, the ``MoeDense`` layer, the aux-loss channel of the training
score, ``moe_transformer_lm`` training (``fit``, and ``fit_scan`` through
a stand-in for the captured graph), ``DecodeEngine`` serving on both
layouts, and model zips in both directions.

Routing is first-come in token order over the whole batch of a call, so
every port-against-JAX comparison uses the same batch, layout, knobs
and chunking, and asserts the expert assignment (``dispatch``) equal
before it compares outputs. Tolerances: dispatch identical; combine and
aux 1e-6; layer outputs and gradients 1e-4 (float32); trajectories 5e-3
relative on losses and 1e-4 on params; greedy ids identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.enums import Updater as JUpdater
from deeplearning4j_tpu.nn.layers.moe import MoeDense as JMoeDense
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss
from deeplearning4j_tpu.parallel import expert_parallel as jep
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.util.model_serializer import (
    restore_model as jrestore,
    write_model as jwrite,
)

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.layers.moe import MoeDense, MoeDenseImpl
from deeplearning4j_tpu_torch.nn import cuda_graphs
from deeplearning4j_tpu_torch.nn.streaming import tree_leaves, tree_map
from deeplearning4j_tpu_torch.parallel import expert_parallel as tep
from deeplearning4j_tpu_torch.serving import DecodeEngine as TEngine
from deeplearning4j_tpu_torch.serving import Request as TRequest
from deeplearning4j_tpu_torch.util.model_serializer import (
    restore_model,
    write_model,
)
from torch_port_threads import one_torch_thread  # noqa: F401

EXACT = 1e-6
FWD_ATOL = 1e-4
LOSS_RTOL = 5e-3
PARAM_ATOL = 1e-4
V, WIDTH, WINDOW = 16, 32, 64


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def _logits(b, e, seed, ties=True):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(b, e)).astype(np.float32)
    if ties:
        z[3] = 0.25                 # an exact tie across every expert
        z[5, :2] = z[5, :2].max()   # a tie between two experts
    return z


# --------------------------------------------------------------- routing
@pytest.mark.parametrize("top_k,capacity", [(1, 3), (1, 24), (2, 5),
                                            (2, 12), (3, 4)])
def test_route_top_k_matches_jax(top_k, capacity):
    """Dispatch identical and combine / aux within 1e-6, for k = 1, 2, 3
    and capacities that drop tokens (3, 5, 4 seats for 24 tokens over 4
    experts) and that drop none."""
    z = _logits(24, 4, seed=top_k * 10 + capacity)
    jd, jc, ja = jep.route_top_k(jnp.asarray(z), capacity, top_k)
    td, tc, ta = tep.route_top_k(torch.as_tensor(z), capacity, top_k)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_allclose(_np(tc), np.asarray(jc), atol=EXACT, rtol=0)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), atol=EXACT, rtol=0)
    seated = _np(td).sum(axis=(1, 2))
    if capacity < 24 * top_k / 4:
        assert (seated < top_k).any()          # some seats were refused
    assert (_np(td).sum(axis=(0, 2)) <= capacity).all()


def test_route_top_k_builds_no_library_one_hot(monkeypatch):
    """The slots are comparisons against an arange: ``F.one_hot`` raises
    on the -1 positions and reads its range back to the host, which a
    captured graph cannot hold."""
    def refuse(*a, **k):
        raise AssertionError("one_hot called")

    monkeypatch.setattr(torch.nn.functional, "one_hot", refuse)
    tep.route_top_k(torch.as_tensor(_logits(24, 4, 0)), 3, 2)


@pytest.mark.parametrize("n,e,cf,k", [(1, 8, 1.25, 1), (4096, 8, 1.25, 1),
                                      (33, 8, 1.25, 1), (64, 4, 2.0, 2),
                                      (7, 16, 1.0, 1), (100, 3, 0.5, 2)])
def test_expert_capacity_matches_jax(n, e, cf, k):
    assert tep.expert_capacity(n, e, cf, k) == jep.expert_capacity(n, e,
                                                                   cf, k)


@pytest.fixture(scope="module")
def moe_params():
    rng = np.random.default_rng(3)
    d, e, h = 8, 4, 16
    return {"router": rng.normal(size=(d, e)).astype(np.float32),
            "W_up": (rng.normal(size=(e, d, h)) / 3).astype(np.float32),
            "W_down": (rng.normal(size=(e, h, d)) / 4).astype(np.float32)}


@pytest.mark.parametrize("cf,k", [(1.25, 1), (0.5, 1), (1.0, 2)])
def test_moe_apply_matches_jax(moe_params, cf, k):
    x = np.random.default_rng(4).normal(size=(20, 8)).astype(np.float32)
    jp = {n: jnp.asarray(a) for n, a in moe_params.items()}
    tp = {n: torch.as_tensor(a) for n, a in moe_params.items()}
    cap = tep.expert_capacity(20, 4, cf, k)
    jd, _, _ = jep.route_top_k(jnp.asarray(x) @ jp["router"], cap, k)
    td, _, _ = tep.route_top_k(torch.as_tensor(x) @ tp["router"], cap, k)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    jy, ja = jep.moe_apply(jp, jnp.asarray(x), cf, k)
    ty, ta = tep.moe_apply(tp, torch.as_tensor(x), cf, k)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), atol=FWD_ATOL)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), atol=EXACT)


def test_moe_apply_equals_the_dense_reference_when_nothing_drops(
        moe_params):
    """At capacity factor E every token keeps its seat, and the capacity
    dispatch gives the dense one-hot dispatch's output and aux."""
    tp = {n: torch.as_tensor(a) for n, a in moe_params.items()}
    x = torch.as_tensor(
        np.random.default_rng(5).normal(size=(20, 8)).astype(np.float32))
    y, aux = tep.moe_apply(tp, x, capacity_factor=4.0, top_k=1)
    yd, auxd = tep.moe_apply_dense(tp, x)
    np.testing.assert_allclose(_np(y), _np(yd), atol=1e-5)
    np.testing.assert_allclose(_np(aux), _np(auxd), atol=EXACT)
    jy, ja = jep.moe_apply_dense({n: jnp.asarray(a)
                                  for n, a in moe_params.items()},
                                 jnp.asarray(_np(x)))
    np.testing.assert_allclose(_np(yd), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(_np(auxd), np.asarray(ja), atol=EXACT)


def test_ep_axis_raises_naming_the_mesh_item(moe_params):
    """``ep_axis`` names a live mesh axis: outside a step (no
    ``make_ep_moe``, no ``ParallelTrainer``) it raises; over an axis of
    one rank the all-to-all schedule is ``moe_apply`` itself. Two ranks
    are held against JAX's ``make_ep_moe`` in
    ``test_torch_port_parallel_sp.py``."""
    from deeplearning4j_tpu_torch.parallel.collectives import AxisGroup

    tp = {n: torch.as_tensor(a) for n, a in moe_params.items()}
    x = torch.as_tensor(
        np.random.default_rng(6).normal(size=(12, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="live mesh axis"):
        tep.moe_apply(tp, x, ep_axis="ep")
    one = AxisGroup("ep", None, 1, 0)
    y, aux = tep.moe_apply(tp, x, ep_axis=one)
    yp, auxp = tep.moe_apply(tp, x)
    torch.testing.assert_close(y, yp, rtol=0, atol=0)
    torch.testing.assert_close(aux, auxp, rtol=0, atol=0)


def test_init_moe_params_shapes_and_scales():
    gen = torch.Generator().manual_seed(0)
    p = tep.init_moe_params(gen, 4, 64, 256)
    assert tuple(p["router"].shape) == (64, 4)
    assert tuple(p["W_up"].shape) == (4, 64, 256)
    assert tuple(p["W_down"].shape) == (4, 256, 64)
    assert abs(float(p["W_up"].std()) - 64 ** -0.5) < 0.01
    assert abs(float(p["W_down"].std()) - 256 ** -0.5) < 0.01


# ------------------------------------------------------------- the layer
def _layer_conf(top_k=1, cf=1.25, residual=True):
    return (JNNC.Builder().seed(9).learning_rate(0.01)
            .updater(JUpdater.ADAM).activation("identity").list()
            .layer(0, JMoeDense(n_in=8, n_out=8, n_experts=4, n_hidden=12,
                                capacity_factor=cf, top_k=top_k,
                                aux_weight=0.1, residual=residual))
            .layer(1, JL.RnnOutputLayer(n_in=8, n_out=5,
                                        activation="softmax",
                                        loss_function=JLoss.MCXENT))
            .build())


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_zips")
    confs = {"k1": _layer_conf(), "k2": _layer_conf(top_k=2, cf=0.75),
             "plain": _layer_conf(residual=False)}
    lm = jzoo.moe_transformer_lm(n_in=V, width=WIDTH, n_blocks=2,
                                 n_heads=4, n_classes=V, n_experts=4,
                                 capacity_factor=1.0, seed=5)
    for c in lm.confs:
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    confs["lm"] = lm
    out = {}
    for name, conf in confs.items():
        out[name] = str(d / f"{name}.zip")
        jwrite(JNet(conf).init(), out[name])
    return out


def _pair(zips, name):
    return jrestore(zips[name]), restore_model(zips[name], device="cpu")


def _seq_data(seed, n=2, c=8, t=6, o=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c, t)).astype(np.float32)
    y = np.eye(o, dtype=np.float32)[rng.integers(0, o, (n, t))]
    return x, y.transpose(0, 2, 1)


def test_moe_dense_bean_loads_from_jax_conf_json(zips):
    _, tnet = _pair(zips, "k2")
    bean = tnet.conf.confs[0].layer
    assert isinstance(bean, MoeDense)
    assert (bean.n_experts, bean.n_hidden, bean.top_k, bean.aux_weight,
            bean.capacity_factor) == (4, 12, 2, 0.1, 0.75)
    assert tnet._impls[0] is MoeDenseImpl
    assert set(tnet.state["0"]) == {"aux_loss"}
    assert tuple(tnet.params["0"]["W_up"].shape) == (4, 8, 12)


@pytest.mark.parametrize("name", ["k1", "k2", "plain"])
def test_layer_forward_and_gradients_match_jax(zips, name):
    """Output within 1e-4 and, with the aux loss in the score, every
    gradient (router, W_up, W_down) within 1e-4 of ``jax.grad``'s."""
    jnet, tnet = _pair(zips, name)
    x, y = _seq_data(1)
    np.testing.assert_allclose(_np(tnet.output(x)),
                               np.asarray(jnet.output(x)), atol=FWD_ATOL)
    from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
    js, jg = jnet.compute_gradient_and_score(JDataSet(x, y))
    ts, tg = tnet.compute_gradient_and_score(DataSet(x, y))
    assert abs(ts - js) <= EXACT * max(1.0, abs(js))
    jm, tm = jg.gradient_map(), tg.gradient_map()
    assert sorted(jm) == sorted(tm)
    for k in jm:
        np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]),
                                   atol=FWD_ATOL, rtol=0, err_msg=k)


def test_aux_loss_is_in_the_training_score(zips):
    """The score adds aux_weight x aux; the state channel carries the
    batch's aux out of the forward."""
    _, tnet = _pair(zips, "k1")
    x, y = _seq_data(2)
    s_with, _ = tnet.compute_gradient_and_score(DataSet(x, y))
    tnet.conf.confs[0].layer.aux_weight = 0.0
    s_without, _ = tnet.compute_gradient_and_score(DataSet(x, y))
    tokens = torch.as_tensor(x).permute(0, 2, 1).reshape(-1, 8)
    _, aux = tep.moe_apply(tnet.params["0"], tokens, 1.25, 1)
    assert abs((s_with - s_without) - 0.1 * float(aux)) < 1e-6
    tnet.fit(x, y)
    assert float(tnet.state["0"]["aux_loss"]) == pytest.approx(float(aux),
                                                               abs=1e-6)


# ----------------------------------------------------------- the LM
def _lm_batch(seed, b=2, t=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (b, t + 1))
    eye = np.eye(V, dtype=np.float32)
    return (eye[ids[:, :-1]].transpose(0, 2, 1),
            eye[ids[:, 1:]].transpose(0, 2, 1))


def _moe_inputs_dispatch(net, x, jax_side):
    """The first MoE layer's dispatch on ``x``, from its input
    activations."""
    acts = net.feed_forward(x)
    a = acts[1]
    lc = net.conf.confs[1].layer
    router = net.params["1"]["router"]
    if jax_side:
        tok = jnp.transpose(a, (0, 2, 1)).reshape(-1, a.shape[1])
        cap = jep.expert_capacity(tok.shape[0], lc.n_experts,
                                  lc.capacity_factor, lc.top_k)
        return np.asarray(jep.route_top_k(tok @ router, cap, lc.top_k)[0])
    tok = a.permute(0, 2, 1).reshape(-1, a.shape[1])
    cap = tep.expert_capacity(tok.shape[0], lc.n_experts,
                              lc.capacity_factor, lc.top_k)
    return _np(tep.route_top_k(tok @ router, cap, lc.top_k)[0])


def test_moe_lm_fit_trajectory_matches_jax(zips):
    """4 ``fit`` steps of the zoo's ``moe_transformer_lm`` from one
    JAX-written zip: the first MoE layer's dispatch identical before
    each step, losses within 5e-3 relative, params within 1e-4 after."""
    jnet, tnet = _pair(zips, "lm")
    jl, tl = [], []
    for s in range(4):
        x, y = _lm_batch(s)
        np.testing.assert_array_equal(_moe_inputs_dispatch(tnet, x, False),
                                      _moe_inputs_dispatch(jnet, x, True))
        jnet.fit(x, y)
        tnet.fit(x, y)
        jl.append(float(jnet.score_value))
        tl.append(float(tnet.score_value))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    for k, p in jnet.param_table().items():
        np.testing.assert_allclose(_np(tnet.param_table()[k]),
                                   np.asarray(p), atol=PARAM_ATOL, err_msg=k)
    assert np.isfinite(float(tnet.state["1"]["aux_loss"]))


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


def test_moe_lm_fit_scan_replay_equals_eager_and_jax(zips,
                                                     replaying_runner):
    """Two 3-step ``fit_scan`` windows replayed from one captured step
    equal the eager loop bit for bit (params, updater state and the aux
    state out of the replay), and JAX's ``fit_scan`` within 5e-3."""
    jnet, graph = _pair(zips, "lm")
    eager = restore_model(zips["lm"], device="cpu")
    eager.train_graphs = None
    xs, ys = zip(*[_lm_batch(10 + s) for s in range(3)])
    xs, ys = np.stack(xs), np.stack(ys)
    for _ in range(2):
        want = eager.fit_scan(xs, ys)
        got = graph.fit_scan(xs, ys)
        jscores = np.asarray(jnet.fit_scan(xs, ys))
        assert torch.equal(got, want)
        np.testing.assert_allclose(_np(got), jscores, rtol=LOSS_RTOL)
    for a, b in zip(tree_leaves(graph.params) + tree_leaves(
            graph.updater_state) + tree_leaves(graph.state),
            tree_leaves(eager.params) + tree_leaves(eager.updater_state)
            + tree_leaves(eager.state)):
        assert torch.equal(a, b)
    assert graph.train_graphs.captures == 1


# ------------------------------------------------------------- serving
GEOMETRY = dict(n_slots=2, decode_chunk=4)
LAYOUTS = {
    "dense": GEOMETRY,
    "paged": dict(GEOMETRY, paged_kv=True, block_tokens=8),
    "dense_chunked": dict(GEOMETRY, prefill_chunk=8),
    "paged_chunked": dict(GEOMETRY, paged_kv=True, block_tokens=8,
                          prefill_chunk=8),
    "paged_spec": dict(GEOMETRY, paged_kv=True, block_tokens=8,
                       spec_draft_len=4),
    "dense_fused": dict(GEOMETRY, fused_rounds=2),
}
# (prompt length, max_new_tokens): more requests than slots, two past
# the window
WORKLOAD = [(5, 30), (30, 20), (3, 9), (60, 20), (10, 1)]


def _serve(engine, request_cls, prompts):
    ids = [engine.submit(request_cls(list(p), g)) for p, g in prompts]
    res = engine.run()
    return [res[i] for i in ids]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_moe_engine_greedy_ids_identical_to_jax(zips, layout):
    """The same layout, knobs, slots and chunking in both packages: the
    routing sees the same batches (idle slots' rows included), so the
    greedy ids are identical at float32."""
    rng = np.random.default_rng(0)
    prompts = [(rng.integers(0, V, n).tolist(), g) for n, g in WORKLOAD]
    kw = LAYOUTS[layout]
    jres = _serve(JEngine(JNet.load(zips["lm"]), seed=0, **kw), JRequest,
                  prompts)
    tres = _serve(TEngine(restore_model(zips["lm"], device="cpu"), seed=0,
                          **kw), TRequest, prompts)
    for (p, g), j, t in zip(prompts, jres, tres):
        assert t.finish_reason == j.finish_reason
        assert t.tokens == j.tokens, f"prompt len {len(p)}"


# ---------------------------------------------------------------- zips
def test_zip_round_trips_both_ways(zips, tmp_path):
    """JAX -> port (router, W_up, W_down, Adam state, the aux state) ->
    2 port steps -> a port zip JAX resumes from, its next step matching
    the port's."""
    _, tnet = _pair(zips, "lm")
    for s in range(2):
        tnet.fit(*_lm_batch(20 + s))
    path = str(tmp_path / "port.zip")
    write_model(tnet, path)
    back = jrestore(path)
    assert back.iteration == 2
    for k, p in tnet.param_table().items():
        np.testing.assert_array_equal(np.asarray(back.param_table()[k]),
                                      _np(p))
    np.testing.assert_array_equal(
        np.asarray(back.updater_state["1"]["m"]["W_up"]),
        _np(tnet.updater_state["1"]["m"]["W_up"]))
    x, y = _lm_batch(30)
    back.fit(x, y)
    tnet.fit(x, y)
    assert abs(float(back.score_value) - float(tnet.score_value)) <= (
        1e-5 * abs(float(back.score_value)))
