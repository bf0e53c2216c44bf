"""The second-order solvers, step functions, terminations, gradient
checks and training listeners of the PyTorch port against the JAX
package.

- ``backtrack_line_search`` on the JAX suite's cases
  (``tests/test_optimizers_convergence.py``): the same (step, value).
- Trajectories from one JAX-written zip of the suite's problem (a
  6-12-3 tanh/softmax MLP on 96 three-class points): the score after
  every iteration and the final params of LineGradientDescent,
  ConjugateGradient and LBFGS (20 iterations each) and
  StochasticHessianFree (4 iterations) within 1e-4 relative (scores)
  and 2e-4 (params): float32 sums in another order move LBFGS's scores
  by up to 1.2e-5. HF is held for 4 iterations only: from its fifth,
  the inner 50-step CG at lambda 4.4e-3 amplifies float32 rounding
  (its Hessian-vector products agree to 2e-7 here) and the two packages'
  scores part (0.325736 against 0.325806 at iteration 5); that is
  reported, not absorbed into a tolerance.
- The Hessian-vector product against JAX's (forward-over-reverse);
  ``flash_attention_reference`` (K1's plain version) stays twice
  differentiable: its HVP equals a central difference of gradients;
  a double backward through K1's autograd function, and HF over it,
  raise (its backward refuses ``create_graph``).
- Solver dispatch from ``fit`` for a non-SGD conf, on an MLN and a
  graph, against JAX's; ``fit_scan`` refuses it as JAX's does.
- Step functions and terminations against JAX's; ``check_gradients``
  on the JAX suite's nets (``tests/test_gradientcheck.py``) and a
  planted wrong gradient; the tracing listener and ``MetricsLog``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.gradientcheck import check_gradients as j_check
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers as jL
from deeplearning4j_tpu.nn.conf.enums import (
    OptimizationAlgorithm as JAlgo,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss
from deeplearning4j_tpu.optimize import solver as jsolver
from deeplearning4j_tpu.optimize import stepfunctions as jsf
from deeplearning4j_tpu.optimize import terminations as jterm
from deeplearning4j_tpu.optimize.listeners import (
    CollectScoresIterationListener as JCollect,
)
from deeplearning4j_tpu.util.model_serializer import restore_model as jrestore
from deeplearning4j_tpu.util.model_serializer import write_model as jwrite

import deeplearning4j_tpu_torch.gradientcheck.gradient_check_util as tgc
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.gradientcheck import check_gradients
from deeplearning4j_tpu_torch.nn.conf.enums import OptimizationAlgorithm
from deeplearning4j_tpu_torch.nn.layers import attention as tattn
from deeplearning4j_tpu_torch.optimize import solver as tsolver
from deeplearning4j_tpu_torch.optimize import stepfunctions as tsf
from deeplearning4j_tpu_torch.optimize import terminations as tterm
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener,
    TracingIterationListener,
)
from deeplearning4j_tpu_torch.optimize.telemetry import MetricsLog
from deeplearning4j_tpu_torch.profiler.tracer import Tracer
from deeplearning4j_tpu_torch.util.model_serializer import restore_model
from torch_port_threads import one_torch_thread  # noqa: F401

SCORE_RTOL = 1e-4
PARAM_ATOL = 2e-4


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().cpu().numpy()
    return np.asarray(a)


def _data(seed=0, n=96):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 3, n)
    x = rng.normal(loc=cls[:, None] * 0.8, size=(n, 6)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[cls]


def _mlp_conf():
    return (JNNC.Builder().seed(7).learning_rate(0.1).list()
            .layer(0, jL.DenseLayer(n_in=6, n_out=12, activation="tanh"))
            .layer(1, jL.OutputLayer(n_in=12, n_out=3, activation="softmax",
                                     loss_function=JLoss.MCXENT))
            .build())


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("solvers") / "mlp.zip")
    jwrite(JNet(_mlp_conf()).init(), path)
    return path


def _pair(zip_path):
    return jrestore(zip_path), restore_model(zip_path, device="cpu")


# -------------------------------------------------------- line search
def _quadratic(pkg_vec):
    rng = np.random.default_rng(0)
    m = rng.normal(size=(5, 5))
    a = m @ m.T + 5 * np.eye(5)
    x0 = rng.normal(size=5)
    return (lambda x: 0.5 * float(np.asarray(x) @ a @ np.asarray(x)),
            x0, a @ x0)


LS_CASES = {
    "quadratic": lambda: dict(f=_quadratic(None)[0],
                              x=_quadratic(None)[1],
                              g=_quadratic(None)[2], d="neg", kw={},
                              max_iterations=8),
    "overshoot": lambda: dict(f=lambda x: float(1000.0 * x[0] ** 2),
                              x=np.array([1.0]), g=np.array([2000.0]),
                              d="neg", kw={}, max_iterations=20),
    "ascent": lambda: dict(f=lambda x: float(-(x - 3.0) ** 2),
                           x=np.float64(0.0), g=np.float64(6.0), d="pos",
                           kw=dict(minimize=False, initial_step=0.5),
                           max_iterations=5),
    "nonfinite": lambda: dict(
        f=lambda x: float("inf") if abs(float(x)) > 2 else float(x) ** 2,
        x=np.float64(1.0), g=np.float64(2.0), d="neg",
        kw=dict(initial_step=8.0), max_iterations=8),
    "exhaustion": lambda: dict(f=lambda x: float(x) ** 2, x=np.float64(1.0),
                               g=np.float64(2.0), d="neg",
                               kw=dict(c1=1.0), max_iterations=4),
}


@pytest.mark.parametrize("case", sorted(LS_CASES))
def test_line_search_matches_jax(case):
    c = LS_CASES[case]()
    for key in ("x", "g"):
        c[key] = np.asarray(c[key], np.float32)
    d = -c["g"] if c["d"] == "neg" else c["g"]
    want = jsolver.backtrack_line_search(
        c["f"], jnp.asarray(c["x"]), c["f"](c["x"]), jnp.asarray(c["g"]),
        jnp.asarray(d), c["max_iterations"], **c["kw"])
    got = tsolver.backtrack_line_search(
        c["f"], torch.as_tensor(c["x"]), c["f"](c["x"]),
        torch.as_tensor(c["g"]), torch.as_tensor(d), c["max_iterations"],
        **c["kw"])
    # float32 vectors on both sides; the probes' values agree to rounding
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert got[0] > 0


# ------------------------------------------------------- trajectories
SOLVERS = [("LineGradientDescent", 20), ("ConjugateGradient", 20),
           ("LBFGS", 20), ("StochasticHessianFree", 4)]


@pytest.mark.parametrize("name,iters", SOLVERS)
def test_solver_trajectory_matches_jax(zip_path, name, iters):
    jnet, tnet = _pair(zip_path)
    jc, tc = JCollect(), CollectScoresIterationListener()
    jnet.set_listeners(jc)
    tnet.set_listeners(tc)
    x, y = _data()
    before = tnet.score(DataSet(x, y))
    jout = getattr(jsolver, name)(jnet, max_iterations=iters).optimize(
        JDataSet(x, y))
    tout = getattr(tsolver, name)(tnet, max_iterations=iters).optimize(
        DataSet(x, y))
    js = [s for _, s in jc.scores]
    ts = [s for _, s in tc.scores]
    assert len(ts) == len(js) > 0
    np.testing.assert_allclose(ts, js, rtol=SCORE_RTOL)
    np.testing.assert_allclose(tout, jout, rtol=SCORE_RTOL)
    np.testing.assert_allclose(_np(tnet.params_flat()),
                               np.asarray(jnet.params_flat()),
                               atol=PARAM_ATOL)
    assert tout < before and tnet.iteration == jnet.iteration
    # the params were written back: the score of the final params
    np.testing.assert_allclose(tnet.score(DataSet(x, y)), tout, rtol=1e-5)


@pytest.mark.parametrize("name,iters", [("LineGradientDescent", 20),
                                        ("ConjugateGradient", 20),
                                        ("LBFGS", 20),
                                        ("StochasticHessianFree", 10)])
def test_solvers_converge_as_the_jax_suite_requires(zip_path, name, iters):
    _, net = _pair(zip_path)
    x, y = _data()
    before = net.score(DataSet(x, y))
    after = getattr(tsolver, name)(net, max_iterations=iters).optimize(
        DataSet(x, y))
    assert after < before * 0.6, (name, before, after)
    assert (net.predict(x) == y.argmax(1)).mean() > 0.7


def test_hessian_vector_product_matches_jax(zip_path):
    jnet, tnet = _pair(zip_path)
    x, y = _data()
    jp = jsolver.FlatProblem(jnet, JDataSet(x, y))
    tp = tsolver.FlatProblem(tnet, DataSet(x, y))
    v = np.random.default_rng(1).normal(size=jp.x0.shape).astype(np.float32)
    want = np.asarray(jp.hessian_vector_product(jp.x0, jnp.asarray(v)))
    got = _np(tp.hessian_vector_product(tp.x0, torch.as_tensor(v)))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("algo", ["LBFGS", "CONJUGATE_GRADIENT",
                                  "LINE_GRADIENT_DESCENT", "HESSIAN_FREE"])
def test_fit_dispatches_to_the_solver_as_jax(zip_path, algo):
    """``fit`` with a non-SGD ``optimization_algo`` (2 iterations): the
    same scores as JAX's ``fit``; ``fit_scan`` refuses it."""
    jnet, tnet = _pair(zip_path)
    for net, enum in ((jnet, JAlgo), (tnet, OptimizationAlgorithm)):
        net.conf.confs[0].optimization_algo = getattr(enum, algo)
        net.conf.confs[0].num_iterations = 2
    x, y = _data(1)
    jnet.fit(JDataSet(x, y))
    tnet.fit(DataSet(x, y))
    assert tnet.iteration == jnet.iteration == 2
    np.testing.assert_allclose(float(tnet.score_value),
                               float(jnet.score_value), rtol=SCORE_RTOL)
    with pytest.raises(ValueError, match="only supports SGD"):
        tnet.fit_scan(x[None], y[None])


def _graph_conf():
    return (JNNC.Builder().seed(7).learning_rate(0.1)
            .optimization_algo(JAlgo.LBFGS).iterations(3)
            .graph_builder().add_inputs("a", "b")
            .add_layer("da", jL.DenseLayer(n_in=3, n_out=6,
                                           activation="tanh"), "a")
            .add_layer("db", jL.DenseLayer(n_in=3, n_out=6,
                                           activation="tanh"), "b")
            .add_vertex("sum", __import__(
                "deeplearning4j_tpu.nn.conf.graph_conf",
                fromlist=["ElementWiseVertex"]).ElementWiseVertex(), "da",
                "db")
            .add_layer("out", jL.OutputLayer(
                n_in=6, n_out=3, activation="softmax",
                loss_function=JLoss.MCXENT), "sum")
            .set_outputs("out").build())


def test_graph_fit_runs_lbfgs_as_jax(tmp_path):
    from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMulti

    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet

    path = str(tmp_path / "g.zip")
    jwrite(JGraph(_graph_conf()).init(), path)
    jnet, tnet = jrestore(path), restore_model(path, device="cpu")
    x, y = _data(2)
    jc, tc = JCollect(), CollectScoresIterationListener()
    jnet.set_listeners(jc)
    tnet.set_listeners(tc)
    jnet.fit(JMulti([x[:, :3], x[:, 3:]], [y]))
    tnet.fit(MultiDataSet([x[:, :3], x[:, 3:]], [y]))
    ts, js = [s for _, s in tc.scores], [s for _, s in jc.scores]
    assert len(ts) == len(js) == 3 and ts[-1] < ts[0]
    np.testing.assert_allclose(ts, js, rtol=SCORE_RTOL)
    np.testing.assert_allclose(_np(tnet.params_flat()),
                               np.asarray(jnet.params_flat()),
                               atol=PARAM_ATOL)


# ---------------------------------------------- second order over K1
def test_flash_reference_is_twice_differentiable():
    """K1's plain version: the Hessian-vector product of a scalar of its
    output (double backward) equals the central difference of its
    gradients, in float64 inputs (computed in float32 inside, so the
    difference step is 1e-2 and the limit 2e-3 of the product's max)."""
    g = torch.Generator().manual_seed(0)
    q, k, v, w = (torch.randn((1, 2, 9, 64), generator=g,
                              dtype=torch.float64) for _ in range(4))
    dq = torch.randn(q.shape, generator=g, dtype=torch.float64)

    def grad_q(qq):
        qq = qq.detach().requires_grad_(True)
        out = tattn.flash_attention_reference(qq, k, v, True)
        return torch.autograd.grad((out * w).sum(), qq)[0]

    qq = q.clone().requires_grad_(True)
    out = tattn.flash_attention_reference(qq, k, v, True)
    (gq,) = torch.autograd.grad((out * w).sum(), qq, create_graph=True)
    (hvp,) = torch.autograd.grad(gq, qq, grad_outputs=dq)
    eps = 1e-2
    fd = (grad_q(q + eps * dq) - grad_q(q - eps * dq)) / (2 * eps)
    scale = float(hvp.abs().max())
    assert scale > 1e-3
    assert float((hvp - fd).abs().max()) <= 2e-3 * scale


def _k1_stand_in(monkeypatch):
    """K1's autograd function on CPU tensors, its kernels replaced by the
    plain version (forward) and autograd of it (backward)."""
    def fwd(q, k, v, causal):
        o = tattn.flash_attention_reference(q, k, v, causal)
        return o, torch.zeros(q.shape[:3])

    def bwd(q, k, v, o, lse, do, causal):
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
            out = tattn.flash_attention_reference(*leaves, causal)
            return torch.autograd.grad(out, leaves, do)

    monkeypatch.setattr(tattn, "flash_attention_fwd", fwd)
    monkeypatch.setattr(tattn, "flash_attention_bwd", bwd)


def test_a_double_backward_through_k1_raises(monkeypatch):
    _k1_stand_in(monkeypatch)
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((1, 2, 8, 64), generator=g).requires_grad_(True)
               for _ in range(3))
    out = tattn._FlashAttention.apply(q, k, v, True)
    with pytest.raises(RuntimeError, match="double backward through K1"):
        torch.autograd.grad(out.square().sum(), q, create_graph=True)
    # a plain backward still runs the kernels' gradient
    (gq,) = torch.autograd.grad(out.square().sum(), q)
    ref = q.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(tattn.flash_attention_reference(
        ref, k, v, True).square().sum(), ref)
    torch.testing.assert_close(gq, want)


def test_hessian_free_over_k1_raises_naming_the_cause(monkeypatch):
    """HF's product through K1's autograd function raises, as JAX's
    raises for HF through its Pallas kernel; the same net on dense
    attention runs HF."""
    from deeplearning4j_tpu_torch.datasets import markov
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm_flagship
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    _k1_stand_in(monkeypatch)
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda q, k, v, causal:
                        tattn._FlashAttention.apply(q, k, v, causal))
    monkeypatch.setattr(tattn, "_should_use_flash",
                        lambda use_flash, q, mask: bool(use_flash))
    conf = transformer_lm_flagship(vocab=8, width=64, n_layers=1, n_heads=1,
                                   seed=2)
    for c in conf.confs:
        c.optimization_algo = OptimizationAlgorithm.HESSIAN_FREE
        c.num_iterations = 1
        if hasattr(c.layer, "use_flash"):
            c.layer.use_flash = True
    net = MultiLayerNetwork(conf, device="cpu").init()
    f, y, _ = markov.markov_lm_batches(8, 2, 8, seed=0, sample_seed=1)
    with pytest.raises(RuntimeError, match="double backward through K1"):
        net.fit(f, y)
    for c in net.conf.confs:
        if hasattr(c.layer, "use_flash"):
            c.layer.use_flash = False
    before = net.score(DataSet(f, y))
    net.fit(f, y)
    assert float(net.score_value) < before


# ----------------------------------------- step functions, terminations
@pytest.mark.parametrize("name", ["default", "gradient", "negative_default",
                                  "negative_gradient", "NegativeDefault"
                                  "StepFunction"])
def test_step_functions_match_jax(name):
    x = np.array([1.0, -2.0, 0.5], np.float32)
    d = np.array([0.25, 1.0, -3.0], np.float32)
    want = jsf.from_name(name).step(jnp.asarray(x), jnp.asarray(d), 0.3)
    got = tsf.from_name(name).step(torch.as_tensor(x), torch.as_tensor(d),
                                   0.3)
    np.testing.assert_array_equal(_np(got).astype(np.float32),
                                  np.asarray(want))
    assert type(tsf.from_name(name)).__name__ == type(
        jsf.from_name(name)).__name__


def test_unknown_step_function_raises_in_both():
    for mod in (jsf, tsf):
        with pytest.raises(ValueError, match="unknown step function"):
            mod.from_name("sideways")


TERMINATION_CASES = [(1.0, 1.00001, [0.1, 0.0]), (1.0, 2.0, [0.0, 0.0]),
                     (0.0, 0.0, [1e-7, 0.0]), (5.0, 0.0, [0.0, 1e-9])]


@pytest.mark.parametrize("cost,old,direction", TERMINATION_CASES)
def test_terminations_match_jax(cost, old, direction):
    for jc, tc in ((jterm.EpsTermination(), tterm.EpsTermination()),
                   (jterm.Norm2Termination(), tterm.Norm2Termination()),
                   (jterm.ZeroDirection(), tterm.ZeroDirection())):
        want = jc.terminate(cost, old, np.asarray(direction))
        assert tc.terminate(cost, old, torch.as_tensor(direction)) == want
        assert tc.terminate(cost, old, np.asarray(direction)) == want


# ------------------------------------------------------ gradient checks
def _gc_net(pkg_builder, layers):
    b = (pkg_builder.Builder().seed(42).regularization(True).l1(1e-2)
         .l2(2e-2).list())
    for i, layer in enumerate(layers):
        b.layer(i, layer)
    return b.build()


def _gc_cases():
    def out(loss, act):
        return jL.OutputLayer(n_in=5, n_out=3, activation=act,
                              loss_function=loss)

    cases = {}
    for act in ("sigmoid", "tanh", "relu", "elu"):
        cases[f"mlp_{act}"] = [jL.DenseLayer(n_in=4, n_out=5,
                                             activation=act),
                               out(JLoss.MCXENT, "softmax")]
    for loss, act in ((JLoss.MSE, "identity"), (JLoss.XENT, "sigmoid")):
        cases[f"loss_{loss.value}"] = [
            jL.DenseLayer(n_in=4, n_out=5, activation="tanh"),
            out(loss, act)]
    cases["embedding"] = [jL.EmbeddingLayer(n_in=10, n_out=5,
                                            activation="tanh"),
                          out(JLoss.MCXENT, "softmax")]
    return cases


GC_CASES = _gc_cases()


@pytest.mark.parametrize("name", sorted(GC_CASES))
def test_check_gradients_passes_as_in_jax(name, tmp_path):
    """The JAX suite's nets (l1 and l2 on, so the penalty's gradient is
    checked too), 60 sampled parameters from seed 0: both packages pass,
    on the same zip and data."""
    rng = np.random.default_rng(12345)
    conf = _gc_net(JNNC, GC_CASES[name])
    if name == "embedding":
        x = rng.integers(0, 10, size=(6, 1)).astype(np.float32)
    else:
        x = rng.normal(size=(6, 4)).astype(np.float32)
    y = np.zeros((6, 3), np.float32)
    y[np.arange(6), rng.integers(0, 3, 6)] = 1.0
    if name == "loss_xent":
        y = rng.uniform(size=(6, 3)).astype(np.float32)
    path = str(tmp_path / "gc.zip")
    jwrite(JNet(conf).init(), path)
    assert j_check(jrestore(path), JDataSet(x, y), max_params_to_check=60)
    net = restore_model(path, device="cpu")
    assert check_gradients(net, DataSet(x, y), max_params_to_check=60)


def test_check_gradients_fails_on_a_planted_wrong_gradient(monkeypatch,
                                                           tmp_path):
    """A loss whose autograd gradient is wrong (the output's gradient
    halved by a custom function) fails the check; the sampled indices
    come from ``default_rng(seed)`` over the flat vector."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    path = str(tmp_path / "gc.zip")
    jwrite(JNet(_gc_net(JNNC, GC_CASES["mlp_tanh"])).init(), path)
    net = restore_model(path, device="cpu")
    assert check_gradients(net, DataSet(x, y))

    class HalfGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a):
            return a.clone()

        @staticmethod
        def backward(ctx, g):
            return 0.5 * g

    loss_fn = net._loss_fn

    def planted(params, *args, **kw):
        score, st, rnn = loss_fn(params, *args, **kw)
        return HalfGrad.apply(score), st, rnn

    monkeypatch.setattr(net, "_loss_fn", planted)
    assert not check_gradients(net, DataSet(x, y), max_params_to_check=20,
                               seed=4)
    assert tgc.ravel_params(net.params).numel() == net.num_params()


# ------------------------------------------------------------ listeners
def test_tracing_listener_and_metrics_log(zip_path, tmp_path):
    """Over an SGD ``fit`` and an LBFGS solve: one JSONL record and one
    ``train.step`` span a fire, the health fetched (device tensors from
    the train step, the solver's host callable)."""
    _, net = _pair(zip_path)
    x, y = _data()
    tracer = Tracer()
    path = str(tmp_path / "m.jsonl")
    with MetricsLog(path) as log:
        listener = TracingIterationListener(tracer=tracer, metrics_log=log)
        net.set_listeners(listener)
        net.fit(DataSet(x, y))
        tsolver.LBFGS(net, max_iterations=2).optimize(DataSet(x, y))
    records = MetricsLog.read(path)
    assert [r["iteration"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r["grad_norm"]) and r["steps"] == 1
               for r in records)
    assert listener.quantile("train_step_s", 0.5) > 0
    spans = [e for e in tracer.events() if e.get("name") == "train.step"]
    assert len(spans) == 3
