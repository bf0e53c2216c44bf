"""The training slice of the PyTorch port against the JAX package.

Losses, updaters, lr schedules and gradient normalization on the same
numpy inputs; k-step ``fit`` trajectories of the transformer flagship
from ONE JAX-built net loaded into the port through a model zip (never
two independent inits), with dense attention and with K1 on both sides
(the JAX Pallas kernel in interpret mode, the port's plain version);
``fit_scan``, ``remat``, resume from a JAX checkpoint, and the bf16
cast cache after ``fit``.

Tolerances, per case: 1e-6 for losses, updaters and schedules (float32
arithmetic in both); trajectories 5e-3 relative on losses and 1e-4 on
params (the two frameworks sum in different orders over 4 steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import deeplearning4j_tpu.nn.layers.attention as jattn_mod
from deeplearning4j_tpu.datasets import markov as jmarkov
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf.enums import (
    GradientNormalization as JGN,
    Updater as JUpdater,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn.updater import updaters as jupd
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu.optimize import listeners as jlisteners
from deeplearning4j_tpu.optimize import telemetry as jtelemetry
from deeplearning4j_tpu.util.model_serializer import write_model as jwrite

import deeplearning4j_tpu_torch.nn.layers.attention as tattn_mod
from deeplearning4j_tpu_torch.datasets import markov as tmarkov
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn.conf.enums import (
    BackpropType,
    GradientNormalization as TGN,
    OptimizationAlgorithm,
    Updater as TUpdater,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updater import updaters as tupd
from deeplearning4j_tpu_torch.ops import losses as tlosses
from deeplearning4j_tpu_torch.optimize import listeners as tlisteners
from deeplearning4j_tpu_torch.optimize import telemetry as ttelemetry
from deeplearning4j_tpu_torch.util.model_serializer import restore_model
from torch_port_threads import one_torch_thread  # noqa: F401

EXACT = dict(atol=1e-6, rtol=1e-6)
LOSS_RTOL = 5e-3
PARAM_ATOL = 1e-4


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------- losses
def _loss_inputs(name, masked):
    rng = np.random.default_rng(5)
    z = rng.normal(size=(3, 5, 4)).astype(np.float32)
    a = 1.0 / (1.0 + np.exp(-z))            # in (0, 1) for the xents
    if name in ("mcxent", "negativeloglikelihood"):
        a = np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)
    if name in ("mse", "squared_loss", "l1", "cosine_proximity",
                "hinge", "rmse_xent"):
        a = z
    ids = rng.integers(0, 5, (3, 4))
    y = np.zeros_like(a)
    for n in range(3):
        y[n, ids[n], np.arange(4)] = 1.0
    if name in ("xent", "reconstruction_crossentropy", "expll"):
        y = rng.uniform(0, 1, a.shape).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((3, 4), np.float32)
        mask[1, 2:] = 0.0
        mask[2, 1:] = 0.0
    return a, y, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", [f.value for f in tlosses.LossFunction])
def test_losses_match(name, masked):
    a, y, mask = _loss_inputs(name, masked)
    want = jlosses.loss_fn(name)(jnp.asarray(a), jnp.asarray(y),
                                 None if mask is None else jnp.asarray(mask))
    got = tlosses.loss_fn(name)(torch.as_tensor(a), torch.as_tensor(y),
                                None if mask is None
                                else torch.as_tensor(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), **EXACT)


def test_loss_enum_wire_values_match():
    assert ([f.value for f in tlosses.LossFunction]
            == [f.value for f in jlosses.LossFunction])


# -------------------------------------------------------------- updaters
_HP = {"momentum": 0.9, "momentum_schedule": {2: 0.5}, "rho": 0.95,
       "rms_decay": 0.9, "adam_mean_decay": 0.9, "adam_var_decay": 0.999,
       "epsilon": 1e-6}


def _grad_trees(rng, steps):
    shapes = {"W": (4, 3), "b": (3,)}
    return [{k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(steps)]


@pytest.mark.parametrize("rule", ["sgd", "none", "nesterovs", "adagrad",
                                  "rmsprop", "adadelta", "adam"])
def test_updater_rules_match(rule):
    rng = np.random.default_rng(1)
    params = {"W": rng.normal(size=(4, 3)).astype(np.float32),
              "b": np.zeros(3, np.float32)}
    ju = jupd.LayerUpdater(JUpdater(rule), dict(_HP))
    tu = tupd.LayerUpdater(TUpdater(rule), dict(_HP))
    js = ju.init({k: jnp.asarray(v) for k, v in params.items()})
    ts = tu.init({k: torch.as_tensor(v) for k, v in params.items()})
    for it, g in enumerate(_grad_trees(rng, 4)):
        jupd_, js = ju.update({k: jnp.asarray(v) for k, v in g.items()},
                              js, 0.01, it)
        tupd_, ts = tu.update({k: torch.as_tensor(v) for k, v in g.items()},
                              ts, 0.01, it)
        for k in g:
            np.testing.assert_allclose(_np(tupd_[k]), np.asarray(jupd_[k]),
                                       **EXACT)
    jflat = jax.tree_util.tree_leaves(js)
    tflat = [ts[slot][k] for slot in sorted(ts) for k in sorted(ts[slot])]
    assert len(jflat) == len(tflat)
    for a, b in zip(jflat, tflat):
        np.testing.assert_allclose(_np(b), np.asarray(a), **EXACT)


def _flagship_confs(warm=3, total=10):
    jc = jzoo.transformer_lm_flagship(vocab=8, width=16, n_layers=1,
                                      n_heads=2, lr=0.01,
                                      warmup_steps=warm, total_steps=total)
    tc = tzoo.transformer_lm_flagship(vocab=8, width=16, n_layers=1,
                                      n_heads=2, lr=0.01,
                                      warmup_steps=warm, total_steps=total)
    return jc.confs[0], tc.confs[0]


@pytest.mark.parametrize("policy", ["warmup_cosine", "schedule"])
def test_learning_rate_schedules_match(policy):
    jc, tc = _flagship_confs()
    if policy == "schedule":
        for c in (jc, tc):
            c.lr_policy = None
            c.learning_rate_schedule = {2: 0.5, 5: 0.125}
    lrs = [tupd.resolve_lr(tc, it) for it in range(14)]
    want = [float(jupd.resolve_lr(jc, it)) for it in range(14)]
    np.testing.assert_allclose(lrs, want, **EXACT)
    if policy == "warmup_cosine":
        assert lrs[0] == 0.0      # the no-op first step
        assert lrs[3] == pytest.approx(0.01)


def test_warmup_cosine_rejects_unset_horizon():
    _, tc = _flagship_confs(warm=5, total=5)
    with pytest.raises(ValueError, match="lr_total_steps"):
        tupd.resolve_lr(tc, 0)


@pytest.mark.parametrize("mode", [m.value for m in TGN])
def test_gradient_normalization_matches(mode):
    rng = np.random.default_rng(2)
    g = {"W": rng.normal(size=(5, 4)).astype(np.float32) * 3,
         "b": rng.normal(size=4).astype(np.float32)}
    want = jupd.normalize_gradients(
        JGN(mode), {k: jnp.asarray(v) for k, v in g.items()}, 1.5)
    got = tupd.normalize_gradients(
        TGN(mode), {k: torch.as_tensor(v) for k, v in g.items()}, 1.5)
    for k in g:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   **EXACT)


def test_aggregate_updater_states_matches():
    rng = np.random.default_rng(3)
    states = [{"m": {"W": rng.normal(size=(2, 2)).astype(np.float32)}}
              for _ in range(3)]
    want = jupd.aggregate_updater_states(
        [jax.tree.map(jnp.asarray, s) for s in states])
    got = tupd.aggregate_updater_states(
        [{"m": {"W": torch.as_tensor(s["m"]["W"])}} for s in states])
    np.testing.assert_allclose(_np(got["m"]["W"]),
                               np.asarray(want["m"]["W"]), **EXACT)


# ------------------------------------------------------ data and support
def test_markov_copy_matches():
    jf, jl, jfloor = jmarkov.markov_lm_batches(16, 3, 20, seed=4)
    tf, tl, tfloor = tmarkov.markov_lm_batches(16, 3, 20, seed=4)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tl, jl)
    assert tfloor == jfloor


def test_dataset_copy_matches():
    rng = np.random.default_rng(0)
    f = rng.normal(size=(6, 3, 4)).astype(np.float32)
    y = rng.normal(size=(6, 2, 4)).astype(np.float32)
    m = np.ones((6, 4), np.float32)
    jd, td = JDataSet(f, y, m, m), DataSet(f, y, m, m)
    for a, b in ((jd.batch_by(4), td.batch_by(4)),
                 ([JDataSet.merge([jd, jd])], [DataSet.merge([td, td])])):
        for x, z in zip(a, b):
            np.testing.assert_array_equal(z.features, x.features)
            np.testing.assert_array_equal(z.labels_mask, x.labels_mask)
    assert isinstance(td.features, np.ndarray)


def test_train_telemetry_windows_match():
    """The same stamps give the same drained windows (wall aside): an
    empty drain is None and keeps the accrued data wait."""
    def drive(tel):
        out = [tel.consume()]
        tel.add_data_wait(0.25)
        out.append(tel.consume())
        tel.record_step(dispatch_s=0.5, examples=2, tokens=32)
        tel.record_step(dispatch_s=0.125, steps=3, examples=6, tokens=96)
        out.append(tel.consume())
        out.append(tel.consume())
        return [None if w is None else
                {k: w[k] for k in ("data_wait_s", "dispatch_s", "steps",
                                   "examples", "tokens")} for w in out]

    want = drive(jtelemetry.TrainTelemetry())
    assert drive(ttelemetry.TrainTelemetry()) == want
    assert want[2] == dict(data_wait_s=0.25, dispatch_s=0.625, steps=4,
                           examples=8, tokens=128)


@pytest.mark.parametrize("every,start,end",
                         [(1, 0, 1), (3, 0, 2), (3, 2, 3), (3, 1, 7),
                          (0, 4, 4), (-1, 4, 5)])
def test_fire_crossed_matches(every, start, end):
    class Rec:
        def __init__(self, mod):
            self.invoked_every, self.fired = every, []
            self.iteration_done = lambda m, it: self.fired.append(it)

    j, t = Rec(jlisteners), Rec(tlisteners)
    jlisteners.fire_crossed([j], None, start, end)
    tlisteners.fire_crossed([t], None, start, end)
    assert t.fired == j.fired


def test_batch_and_window_counts_match():
    for shape in ((4, 3, 7), (4, 3), (4, 1, 5, 5)):
        assert (ttelemetry.batch_counts(np.zeros(shape))
                == jtelemetry.batch_counts(np.zeros(shape)))
    for shape in ((2, 4, 3, 7), (2, 4, 3)):
        assert (ttelemetry.window_counts(shape)
                == jtelemetry.window_counts(shape))


# ---------------------------------------------------------- trajectories
def _markov(vocab, n, t, sample_seed=1):
    f, y, _ = jmarkov.markov_lm_batches(vocab, n, t, seed=0,
                                        sample_seed=sample_seed)
    return f, y


def _pair(tmp_path, **kw):
    conf = jzoo.transformer_lm_flagship(**kw)
    jnet = JNet(conf).init()
    path = str(tmp_path / "net.zip")
    jwrite(jnet, path)
    return jnet, restore_model(path, device="cpu")


def _assert_params_close(tnet, jnet, atol=PARAM_ATOL):
    for key, p in jnet.param_table().items():
        np.testing.assert_allclose(_np(tnet.param_table()[key]),
                                   np.asarray(p), atol=atol, rtol=0,
                                   err_msg=key)


def _fit_both(jnet, tnet, batches):
    jl, tl = [], []
    for f, y in batches:
        jnet.fit(f, y)
        tnet.fit(f, y)
        jl.append(float(jnet.score_value))
        tl.append(float(tnet.score_value))
    return np.asarray(jl), np.asarray(tl)


SMALL = dict(vocab=16, width=32, n_layers=2, n_heads=4, lr=1e-2,
             warmup_steps=2, total_steps=100, seed=3)


def test_fit_trajectory_matches_jax(tmp_path):
    jnet, tnet = _pair(tmp_path, **SMALL)
    batches = [_markov(16, 2, 16, sample_seed=s) for s in range(4)]
    before = {k: _np(v).copy() for k, v in tnet.param_table().items()}
    jl, tl = _fit_both(jnet, tnet, batches)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_params_close(tnet, jnet)
    assert tnet.iteration == jnet.iteration == 4
    moved = max(np.abs(_np(v) - before[k]).max()
                for k, v in tnet.param_table().items())
    assert moved > 1e-3          # lr is 0 only at iteration 0


def test_fit_trajectory_with_flash_matches_jax(tmp_path, monkeypatch):
    """Both sides on K1: the JAX package's stock Pallas kernel run in
    interpret mode (its dispatch patched to take it off the TPU), the
    port's plain version (its dispatch patched to take K1, which on CPU
    tensors is :func:`flash_attention_reference`)."""
    calls = {"jax": 0, "port": 0}

    def jax_flash(use_flash, q, mask):
        calls["jax"] += 1
        return True

    def port_flash(use_flash, q, mask):
        calls["port"] += 1
        return True

    monkeypatch.setattr(jattn_mod, "_should_use_flash", jax_flash)
    monkeypatch.setattr(tattn_mod, "_should_use_flash", port_flash)
    jnet, tnet = _pair(tmp_path, vocab=16, width=128, n_layers=2,
                       n_heads=2, lr=1e-3, warmup_steps=1,
                       total_steps=100, seed=5)
    batches = [_markov(16, 2, 256, sample_seed=s) for s in range(4)]
    with pltpu.force_tpu_interpret_mode():
        jl, tl = _fit_both(jnet, tnet, batches)
    assert calls["jax"] >= 2 and calls["port"] == 2 * 4
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_params_close(tnet, jnet)
    assert jl[1] < jl[0] or jl[2] < jl[1]


def test_fit_scan_equals_k_fit_calls(tmp_path):
    _, a = _pair(tmp_path, **SMALL)
    b = restore_model(str(tmp_path / "net.zip"), device="cpu")
    batches = [_markov(16, 2, 16, sample_seed=s) for s in range(3)]
    for f, y in batches:
        a.fit(f, y)
    v0 = b.params_version
    scores = b.fit_scan(np.stack([f for f, _ in batches]),
                        np.stack([y for _, y in batches]))
    assert b.params_version == v0 + 3 and b.iteration == 3
    assert scores.shape == (3,)
    np.testing.assert_allclose(float(scores[-1]), float(a.score_value),
                               rtol=1e-6)
    _assert_params_close(b, a, atol=1e-6)


def test_fit_scan_matches_jax(tmp_path):
    jnet, tnet = _pair(tmp_path, **SMALL)
    batches = [_markov(16, 2, 16, sample_seed=s) for s in range(3)]
    feats = np.stack([f for f, _ in batches])
    labels = np.stack([y for _, y in batches])
    js = np.asarray(jnet.fit_scan(feats, labels))
    ts = _np(tnet.fit_scan(feats, labels))
    np.testing.assert_allclose(ts, js, rtol=LOSS_RTOL)
    _assert_params_close(tnet, jnet)


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_remat_gives_the_same_grads(tmp_path, dropout):
    _, a = _pair(tmp_path, **SMALL)
    b = restore_model(str(tmp_path / "net.zip"), device="cpu")
    b.conf.remat = True
    f, y = _markov(16, 2, 16)
    for net in (a, b):
        for c in net.conf.confs[:-1]:
            c.dropout = dropout
        net._gen.manual_seed(9)
    sa, ga, _ = a._value_and_grad(a.params, a.state, a._gen,
                                  a._tensor(f), a._tensor(y), None, None)
    sb, gb, _ = b._value_and_grad(b.params, b.state, b._gen,
                                  b._tensor(f), b._tensor(y), None, None)
    assert float(sa) == pytest.approx(float(sb), rel=1e-6)
    for si in ga:
        for k in ga[si]:
            np.testing.assert_allclose(_np(gb[si][k]), _np(ga[si][k]),
                                       atol=1e-6, rtol=1e-5)


def test_compute_gradient_and_score_matches_jax(tmp_path):
    jnet, tnet = _pair(tmp_path, **SMALL)
    f, y = _markov(16, 2, 16)
    js, jg = jnet.compute_gradient_and_score(JDataSet(f, y))
    ts, tg = tnet.compute_gradient_and_score(DataSet(f, y))
    assert ts == pytest.approx(js, rel=1e-5)
    assert sorted(tg.keys()) == sorted(jg.keys())
    for key in jg.keys():
        np.testing.assert_allclose(_np(tg.gradient_for_variable(key)),
                                   np.asarray(jg.gradient_for_variable(key)),
                                   atol=1e-5, rtol=1e-4, err_msg=key)


def test_score_matches_jax(tmp_path):
    jnet, tnet = _pair(tmp_path, **SMALL)
    f, y = _markov(16, 3, 16)
    m = np.ones((3, 16), np.float32)
    m[1, 9:] = 0.0
    assert tnet.score(DataSet(f, y, m, m)) == pytest.approx(
        jnet.score(JDataSet(f, y, m, m)), rel=1e-5)


def test_regularized_fit_matches_jax(tmp_path):
    """l1/l2 on every conf: the penalty lands in the score and the
    grads the same way on both sides (tolerances as the trajectories)."""
    jnet, tnet = _pair(tmp_path, **SMALL)
    f, y = _markov(16, 2, 16)
    bare = tnet.score(DataSet(f, y))
    for net in (jnet, tnet):
        for c in net.conf.confs:
            c.use_regularization, c.l1, c.l2 = True, 1e-3, 1e-2
    assert tnet.score(DataSet(f, y)) == pytest.approx(
        jnet.score(JDataSet(f, y)), rel=1e-5)
    assert tnet.score(DataSet(f, y)) > bare + 1e-3
    batches = [_markov(16, 2, 16, sample_seed=s) for s in range(3)]
    jl, tl = _fit_both(jnet, tnet, batches)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_params_close(tnet, jnet)


def test_masked_fit_matches_jax(tmp_path):
    jnet, tnet = _pair(tmp_path, **SMALL)
    m = np.ones((2, 16), np.float32)
    m[0, 11:] = 0.0
    jl, tl = [], []
    for s in range(3):
        f, y = _markov(16, 2, 16, sample_seed=s)
        jnet.fit(JDataSet(f, y, m, m))
        tnet.fit(DataSet(f, y, m, m))
        jl.append(float(jnet.score_value))
        tl.append(float(tnet.score_value))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_params_close(tnet, jnet)


def test_fit_from_iterator_fires_listeners(tmp_path):
    _, tnet = _pair(tmp_path, **SMALL)
    rec = tlisteners.CollectScoresIterationListener()
    tnet.set_listeners(rec, tlisteners.ScoreIterationListener(2))
    tnet.fit([DataSet(*_markov(16, 2, 16, sample_seed=s))
              for s in range(3)])
    assert [it for it, _ in rec.scores] == [1, 2, 3]
    assert all(np.isfinite(s) for _, s in rec.scores)
    assert tnet.train_telemetry.steps == 3
    assert tnet.train_telemetry.tokens == 3 * 2 * 16


# --------------------------------------------------------------- repairs
def test_init_builds_updater_state():
    net = MultiLayerNetwork(tzoo.transformer_lm_flagship(
        vocab=8, width=16, n_layers=1, n_heads=2), device="cpu").init()
    assert sorted(net.updater_state) == sorted(net.params)
    for si, sub in net.params.items():
        st = net.updater_state[si]
        assert sorted(st) == ["m", "v"]
        for k, p in sub.items():
            assert st["m"][k].shape == p.shape
            assert st["m"][k].device == p.device
            assert float(st["v"][k].abs().max()) == 0.0


def test_resume_from_jax_checkpoint(tmp_path):
    conf = jzoo.transformer_lm_flagship(**SMALL)
    jnet = JNet(conf).init()
    batches = [_markov(16, 2, 16, sample_seed=s) for s in range(4)]
    for f, y in batches[:2]:
        jnet.fit(f, y)
    path = str(tmp_path / "mid.zip")
    jwrite(jnet, path)
    tnet = restore_model(path, device="cpu")
    assert tnet.iteration == 2
    for si in jnet.updater_state:
        for slot in ("m", "v"):
            for k, a in jnet.updater_state[si][slot].items():
                got = tnet.updater_state[si][slot][k]
                assert isinstance(got, torch.Tensor)
                np.testing.assert_array_equal(_np(got), np.asarray(a))
    jl, tl = _fit_both(jnet, tnet, batches[2:])
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_params_close(tnet, jnet)


def test_port_checkpoint_round_trips_training_state(tmp_path):
    _, a = _pair(tmp_path, **SMALL)
    for s in range(2):
        a.fit(*_markov(16, 2, 16, sample_seed=s))
    path = str(tmp_path / "port.zip")
    a.save(path)
    b = MultiLayerNetwork.load(path, device="cpu")
    assert b.iteration == 2
    f, y = _markov(16, 2, 16, sample_seed=7)
    a.fit(f, y)
    b.fit(f, y)
    _assert_params_close(b, a, atol=1e-6)


def test_output_after_fit_uses_updated_bf16_weights(tmp_path):
    _, net = _pair(tmp_path, **SMALL)
    for c in net.conf.confs:
        c.compute_dtype = "bfloat16"
    net = MultiLayerNetwork(net.conf, device="cpu")
    src = restore_model(str(tmp_path / "net.zip"), device="cpu")
    net.init()
    for key, p in src.param_table().items():
        net.set_param(key, p)
    x, y = _markov(16, 2, 16)
    before = _np(net.output(x))
    cached = net._cast_cache[1]
    v0 = net.params_version
    for s in range(3):
        net.fit(*_markov(16, 2, 16, sample_seed=s))
    assert net.params_version == v0 + 3
    after = _np(net.output(x))
    assert net._cast_cache[1] is not cached
    net._cast_cache = (None, None)           # a fresh cast of the params
    np.testing.assert_array_equal(_np(net.output(x)), after)
    assert np.abs(after - before).max() > 1e-4
    # the master params stay f32 and the grads reached them
    assert all(p.dtype == torch.float32 for p in net.params["0"].values())


def test_unported_training_paths_raise(tmp_path):
    """Truncated BPTT trains through ``fit`` (its windows are
    ``tests/test_torch_port_recurrent.py``'s) and ``fit_scan`` refuses
    it, as JAX's does; the second-order solvers still raise, naming
    their ROADMAP item."""
    _, net = _pair(tmp_path, **SMALL)
    f, y = _markov(16, 2, 16)
    net.conf.backprop_type = BackpropType.TRUNCATED_BPTT
    with pytest.raises(ValueError, match="truncated-BPTT"):
        net.fit_scan(f[None], y[None])
    net.conf.backprop_type = BackpropType.STANDARD
    net.conf.confs[0].optimization_algo = OptimizationAlgorithm.LBFGS
    with pytest.raises(NotImplementedError, match="Solver"):
        net.fit_scan(f[None], y[None])
    with pytest.raises(NotImplementedError, match="item 9b"):
        net.fit(f, y)
