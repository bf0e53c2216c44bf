"""The recurrent layers of the PyTorch port against the JAX package:
GravesLSTM, GravesBidirectionalLSTM, GRU and ImageLSTM, truncated BPTT,
streaming (``rnn_time_step``, ``rnn_clear_previous_state(slots=)``),
the ``lstm_classifier`` and ``image_captioner`` zoo builders, and model
zips in both directions.

Every port net is loaded from a zip the JAX package wrote (never two
independent inits), and both packages see the same numpy inputs.
Tolerances: forward outputs and gradients 1e-4 (float32; the two
frameworks sum in different orders), losses 1e-6 for one evaluation;
training trajectories 5e-3 relative on losses over k steps or windows
and 1e-4 on params."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.enums import (
    BackpropType as JBackprop,
    Updater as JUpdater,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss
from deeplearning4j_tpu.util.model_serializer import (
    restore_model as jrestore,
    write_model as jwrite,
)

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.conf.enums import (
    BackpropType,
    OptimizationAlgorithm,
)
from deeplearning4j_tpu_torch.nn.layers import get_impl
from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTMImpl
from deeplearning4j_tpu_torch.nn.streaming import tree_leaves
from deeplearning4j_tpu_torch.util.model_serializer import (
    restore_model,
    write_model,
)
from torch_port_threads import one_torch_thread  # noqa: F401

FWD_ATOL = 1e-4
GRAD_ATOL = 1e-4
LOSS_RTOL = 5e-3
PARAM_ATOL = 1e-4
N, C, H, O, T = 3, 5, 6, 4, 9

KINDS = ("GravesLSTM", "GravesBidirectionalLSTM", "GRU", "ImageLSTM")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def _layer(kind, **kw):
    if kind == "ImageLSTM":
        return JL.ImageLSTM(n_in=C, n_out=H, n_hidden=7, **kw)
    return getattr(JL, kind)(n_in=C, n_out=H, **kw)


def _conf(kind, tbptt=None, updater=JUpdater.ADAM, l2=0.0):
    b = (JNNC.Builder().seed(7).learning_rate(0.05).updater(updater)
         .activation("tanh"))
    if l2:
        b = b.regularization(True).l2(l2)
    lb = (b.list().layer(0, _layer(kind))
          .layer(1, JL.RnnOutputLayer(n_in=H, n_out=O, activation="softmax",
                                      loss_function=JLoss.MCXENT)))
    if tbptt:
        lb = (lb.backprop_type(JBackprop.TRUNCATED_BPTT)
              .t_bptt_forward_length(tbptt))
    return lb.build()


def _deep_conf(tbptt):
    """Two stacked GravesLSTMs with tanh and a softmax/MCXENT output:
    the shape of DL4J's GravesLSTMCharModellingExample, narrowed."""
    return (JNNC.Builder().seed(3).learning_rate(0.1)
            .updater(JUpdater.RMSPROP).activation("tanh").list()
            .layer(0, JL.GravesLSTM(n_in=C, n_out=H))
            .layer(1, JL.GravesLSTM(n_in=H, n_out=H))
            .layer(2, JL.RnnOutputLayer(n_in=H, n_out=C,
                                        activation="softmax",
                                        loss_function=JLoss.MCXENT))
            .backprop_type(JBackprop.TRUNCATED_BPTT)
            .t_bptt_forward_length(tbptt).build())


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    d = tmp_path_factory.mktemp("recurrent_zips")
    out = {}
    confs = {k: _conf(k) for k in KINDS}
    confs["GravesLSTM_l2"] = _conf("GravesLSTM", l2=0.01)
    confs["GravesBidirectionalLSTM_l2"] = _conf("GravesBidirectionalLSTM",
                                                l2=0.01)
    confs["tbptt"] = _conf("GravesLSTM", tbptt=4)
    confs["tbptt_gru"] = _conf("GRU", tbptt=4)
    confs["deep"] = _deep_conf(5)
    confs["lstm_classifier"] = jzoo.lstm_classifier(n_in=C, n_hidden=H,
                                                    n_classes=O)
    confs["image_captioner"] = jzoo.image_captioner(embed_dim=C,
                                                    n_hidden=7, vocab=O)
    for name, conf in confs.items():
        out[name] = str(d / f"{name}.zip")
        jwrite(JNet(conf).init(), out[name])
    return out


def _pair(zips, name):
    return jrestore(zips[name]), restore_model(zips[name], device="cpu")


def _data(kind, seed=0, t=T, masked=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, C, t)).astype(np.float32)
    t_out = t - 1 if kind == "ImageLSTM" else t
    ids = rng.integers(0, O, (N, t_out))
    y = np.eye(O, dtype=np.float32)[ids].transpose(0, 2, 1)
    fm = lm = None
    if masked:
        fm = np.ones((N, t), np.float32)
        fm[1, t - 3:] = 0.0
        fm[2, 2:] = 0.0
        lm = fm.copy()
    return x, y, fm, lm


def _grads_close(jg, tg):
    jm = {k: np.asarray(v) for k, v in jg.gradient_map().items()}
    tm = {k: _np(v) for k, v in tg.gradient_map().items()}
    assert sorted(jm) == sorted(tm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=GRAD_ATOL, rtol=0,
                                   err_msg=k)


def _params_close(jnet, tnet, atol=PARAM_ATOL):
    jt, tt = jnet.param_table(), tnet.param_table()
    assert sorted(jt) == sorted(tt)
    for k in jt:
        np.testing.assert_allclose(_np(tt[k]), np.asarray(jt[k]), atol=atol,
                                   rtol=0, err_msg=k)


# ------------------------------------------------------------ per layer
# ImageLSTM refuses feature masks in both packages
@pytest.mark.parametrize("kind,masked", [(k, m) for k in KINDS
                                         for m in (False, True)
                                         if not (k == "ImageLSTM" and m)])
def test_layer_forward_and_gradients_match_jax(zips, kind, masked):
    jnet, tnet = _pair(zips, kind)
    x, y, fm, lm = _data(kind, masked=masked)
    jout = np.asarray(jnet.output(x))
    tout = _np(tnet.output(x))
    np.testing.assert_allclose(tout, jout, atol=FWD_ATOL, rtol=0)
    js, jg = jnet.compute_gradient_and_score(JDataSet(x, y, fm, lm))
    ts, tg = tnet.compute_gradient_and_score(DataSet(x, y, fm, lm))
    assert abs(ts - js) <= 1e-6 * max(1.0, abs(js))
    _grads_close(jg, tg)


@pytest.mark.parametrize("kind", ["GravesLSTM", "GravesBidirectionalLSTM"])
def test_recurrent_weights_carry_the_l2_penalty(zips, kind):
    """RW (and the backward pass's W_bwd, RW_bwd) join W in l1/l2, as in
    JAX's ``_REGULARIZED_KEYS``: scores and gradients agree with the
    penalty on."""
    jnet, tnet = _pair(zips, f"{kind}_l2")
    x, y, _, _ = _data(kind, seed=4)
    js, jg = jnet.compute_gradient_and_score(JDataSet(x, y))
    ts, tg = tnet.compute_gradient_and_score(DataSet(x, y))
    assert abs(ts - js) <= 1e-6 * max(1.0, abs(js))
    _grads_close(jg, tg)


def test_lstm_layout_and_peepholes(zips):
    """The packing pinned by the JAX package: W [C, 4H] in gate order
    i|f|o|g, RW [H, 4H + 3] whose last 3 columns are the i/f/o
    peepholes, the forget block of b at 1.0; i and f read c_prev, o
    reads the new c. One step by hand in numpy against the layer."""
    _, tnet = _pair(zips, "GravesLSTM")
    p = {k: _np(v) for k, v in tnet.params["0"].items()}
    assert p["W"].shape == (C, 4 * H) and p["RW"].shape == (H, 4 * H + 3)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(N, C)).astype(np.float32)
    h0 = rng.normal(size=(N, H)).astype(np.float32)
    c0 = rng.normal(size=(N, H)).astype(np.float32)

    def sig(a):
        return 1.0 / (1.0 + np.exp(-a))

    z = x @ p["W"] + h0 @ p["RW"][:, :4 * H] + p["b"]
    pi, pf, po = (p["RW"][:, 4 * H + j] for j in range(3))
    i = sig(z[:, :H] + c0 * pi)
    f = sig(z[:, H:2 * H] + c0 * pf)
    c = f * c0 + i * np.tanh(z[:, 3 * H:])
    o = sig(z[:, 2 * H:3 * H] + c * po)
    h = o * np.tanh(c)
    conf = tnet.conf.confs[0]
    params = tnet.params["0"]
    (th, tc), _ = LSTMImpl._step(conf, params, (torch.as_tensor(h0),
                                                torch.as_tensor(c0)),
                                 torch.as_tensor(x) @ params["W"], None)
    np.testing.assert_allclose(_np(th), h, atol=1e-5)
    np.testing.assert_allclose(_np(tc), c, atol=1e-5)
    # a masked step keeps (h, c)
    (mh, mc), _ = LSTMImpl._step(conf, params, (torch.as_tensor(h0),
                                                torch.as_tensor(c0)),
                                 torch.as_tensor(x) @ params["W"],
                                 torch.tensor([1.0, 0.0, 1.0]))
    np.testing.assert_array_equal(_np(mh)[1], h0[1])
    np.testing.assert_array_equal(_np(mc)[1], c0[1])


def test_image_lstm_drops_the_image_step_and_has_no_first_forget(zips):
    jnet, tnet = _pair(zips, "ImageLSTM")
    x, _, _, _ = _data("ImageLSTM", seed=3)
    out = _np(tnet.output(x))
    assert out.shape == (N, O, T - 1)
    # the first step's cell is i * g alone: a carried state of zeros
    # with every step decoded differs from the fresh pass only at t = 0
    zeros = tuple(torch.zeros(N, 7) for _ in range(2))
    conf, params = tnet.conf.confs[0], tnet.params["0"]
    impl = get_impl(conf.layer)
    fresh, _ = impl.apply(conf, params, torch.as_tensor(x))
    carried, _ = impl.apply(conf, params, torch.as_tensor(x), state=zeros)
    assert carried.shape[2] == T
    np.testing.assert_allclose(_np(carried)[:, :, 1:], _np(fresh),
                               atol=1e-6)


def test_ring_axis_raises_naming_the_mesh_item(zips):
    _, tnet = _pair(zips, "GRU")
    tnet.conf.confs[0].layer.ring_axis = "sp"
    x, _, _, _ = _data("GRU")
    with pytest.raises(NotImplementedError, match="item 11"):
        tnet.output(x)


# -------------------------------------------------------------- training
class _Scores:
    invoked_every = 1

    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration):
        self.scores.append(float(model.score_value))


def _trajectories(jnet, tnet, batches):
    js, ts = _Scores(), _Scores()
    jnet.set_listeners(js)
    tnet.set_listeners(ts)
    for x, y, fm, lm in batches:
        jnet.fit(JDataSet(x, y, fm, lm))
        tnet.fit(DataSet(x, y, fm, lm))
    return js.scores, ts.scores


@pytest.mark.parametrize("name,masked", [("tbptt", False),
                                         ("tbptt", True),
                                         ("tbptt_gru", False),
                                         ("deep", False)])
def test_tbptt_trajectory_matches_jax(zips, name, masked):
    """Windows of tbptt_fwd_length over T=11 (the last one ragged), the
    carry detached across windows: per-window losses within 5e-3 and the
    params after them within 1e-4; the losses fall."""
    jnet, tnet = _pair(zips, name)
    kind = "GravesLSTM"
    batches = []
    for s in range(3):
        x, y, fm, lm = _data(kind, seed=10 + s, t=11, masked=masked)
        if name == "deep":
            ids = np.random.default_rng(s).integers(0, C, (N, 11))
            x = np.eye(C, dtype=np.float32)[ids].transpose(0, 2, 1)
            y = np.eye(C, dtype=np.float32)[np.roll(ids, -1, 1)].transpose(
                0, 2, 1)
        batches.append((x, y, fm, lm))
    jsc, tsc = _trajectories(jnet, tnet, batches)
    window = tnet.conf.tbptt_fwd_length
    assert len(tsc) == len(jsc) == 3 * -(-11 // window)
    np.testing.assert_allclose(tsc, jsc, rtol=LOSS_RTOL)
    _params_close(jnet, tnet)
    assert tnet.iteration == jnet.iteration


def test_tbptt_detaches_the_carry_between_windows(zips, monkeypatch):
    """The state a window hands on carries no autograd history, and a
    window's gradient equals a fresh step started from that state."""
    _, tnet = _pair(zips, "tbptt")
    seen = []
    step = tnet._tbptt_step

    def spy(*args):
        out = step(*args)
        seen.append((args[-1], out[3]))
        return out

    monkeypatch.setattr(tnet, "_tbptt_step", spy)
    x, y, _, _ = _data("GravesLSTM", seed=5, t=11)
    tnet.fit(x, y)
    assert len(seen) == 3 and seen[0][0] is None
    for _, carried in seen:
        for leaf in tree_leaves(carried):
            assert leaf.grad_fn is None and not leaf.requires_grad
    assert seen[1][0] is seen[0][1]


def test_non_sgd_still_raises_naming_the_solver_item(zips):
    """A truncated-BPTT conf trains its windows by SGD whatever its
    ``optimization_algo``, as JAX's ``_fit_batch`` takes the TBPTT
    branch first (the second-order solvers run only on a full-BPTT
    conf); ``fit_scan`` refuses both, the TBPTT check first, then the
    solver with JAX's message."""
    from deeplearning4j_tpu.nn.conf.enums import OptimizationAlgorithm as JA

    jnet, tnet = _pair(zips, "tbptt")
    jnet.conf.confs[0].optimization_algo = JA.LBFGS
    tnet.conf.confs[0].optimization_algo = OptimizationAlgorithm.LBFGS
    x, y, _, _ = _data("GravesLSTM", t=11)
    jnet.fit(x, y)
    tnet.fit(x, y)
    assert tnet.iteration == jnet.iteration == 3
    np.testing.assert_allclose(float(tnet.score_value),
                               float(jnet.score_value), rtol=LOSS_RTOL)
    with pytest.raises(ValueError, match="truncated-BPTT"):
        tnet.fit_scan(x[None], y[None])
    tnet.conf.backprop_type = BackpropType.STANDARD
    with pytest.raises(ValueError, match="only supports SGD"):
        tnet.fit_scan(x[None], y[None])


@pytest.mark.parametrize("name", ["lstm_classifier", "image_captioner"])
def test_zoo_builder_trains_like_jax(zips, name):
    jnet, tnet = _pair(zips, name)
    kind = "ImageLSTM" if name == "image_captioner" else "GravesLSTM"
    jl, tl = [], []
    for s in range(4):
        x, y, _, _ = _data(kind, seed=20 + s)
        jnet.fit(x, y)
        tnet.fit(x, y)
        jl.append(float(jnet.score_value))
        tl.append(float(tnet.score_value))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _params_close(jnet, tnet)


def test_fit_scan_of_a_recurrent_net_matches_jax(zips):
    jnet, tnet = _pair(zips, "GravesLSTM")
    xs, ys = zip(*[_data("GravesLSTM", seed=30 + s)[:2] for s in range(3)])
    xs, ys = np.stack(xs), np.stack(ys)
    want = np.asarray(jnet.fit_scan(xs, ys))
    got = _np(tnet.fit_scan(xs, ys))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    _params_close(jnet, tnet)


# ------------------------------------------------------------- streaming
@pytest.mark.parametrize("kind", ["GravesLSTM", "GRU", "ImageLSTM"])
def test_rnn_time_step_equals_the_full_forward(zips, kind):
    """Step by step and in chunks, the carried state gives the full
    forward's outputs (ImageLSTM: the first call holds the image step,
    whose output it drops, as the full pass does), and JAX's."""
    jnet, tnet = _pair(zips, kind)
    x, _, _, _ = _data(kind, seed=6)
    full = _np(tnet.output(x))
    first = 2 if kind == "ImageLSTM" else 1
    outs = [_np(tnet.rnn_time_step(x[:, :, :first]))]
    outs += [_np(tnet.rnn_time_step(x[:, :, t])) for t in range(first, 5)]
    outs.append(_np(tnet.rnn_time_step(x[:, :, 5:])))
    np.testing.assert_allclose(np.concatenate(outs, axis=2), full,
                               atol=FWD_ATOL)
    jouts = [np.asarray(jnet.rnn_time_step(x[:, :, :first]))]
    jouts += [np.asarray(jnet.rnn_time_step(x[:, :, t]))
              for t in range(first, 5)]
    jouts.append(np.asarray(jnet.rnn_time_step(x[:, :, 5:])))
    np.testing.assert_allclose(np.concatenate(outs, axis=2),
                               np.concatenate(jouts, axis=2), atol=FWD_ATOL)


def test_cleared_rows_are_the_initial_carry(zips):
    """``rnn_clear_previous_state(slots=[1])`` zeroes row 1 of (h, c) in
    place, which is ``initial_carry``: that row then streams as a fresh
    sequence while the other rows keep their state."""
    _, tnet = _pair(zips, "GravesLSTM")
    x, _, _, _ = _data("GravesLSTM", seed=8)
    tnet.rnn_time_step(x[:, :, :4])
    (h, c), = [st for st in tnet._rnn_state.values()]
    ptrs = (h.data_ptr(), c.data_ptr())
    kept = _np(h)[[0, 2]].copy()
    tnet.rnn_clear_previous_state(slots=[1])
    h2, c2 = tnet._rnn_state["0"]
    assert (h2.data_ptr(), c2.data_ptr()) == ptrs
    init_h, init_c = LSTMImpl.initial_carry(tnet.conf.confs[0], 1)
    np.testing.assert_array_equal(_np(h2)[1:2], _np(init_h))
    np.testing.assert_array_equal(_np(c2)[1:2], _np(init_c))
    np.testing.assert_array_equal(_np(h2)[[0, 2]], kept)
    out = _np(tnet.rnn_time_step(x[:, :, 4:]))
    fresh = _np(tnet.output(x[:, :, 4:]))
    np.testing.assert_allclose(out[1], fresh[1], atol=1e-6)
    assert np.abs(out[0] - fresh[0]).max() > 1e-4


# ------------------------------------------------------------------ zips
@pytest.mark.parametrize("kind", KINDS)
def test_zip_round_trips_both_ways(zips, kind, tmp_path):
    """JAX -> port -> JAX: after 2 port steps the port writes a zip that
    JAX loads and trains on from where the port stopped (params,
    updater state and iteration), matching the port's own next step."""
    jnet, tnet = _pair(zips, kind)
    for s in range(2):
        x, y, _, _ = _data(kind, seed=40 + s)
        tnet.fit(x, y)
    path = str(tmp_path / "port.zip")
    write_model(tnet, path)
    back = jrestore(path)
    assert back.iteration == tnet.iteration == 2
    _params_close(back, tnet, atol=0.0)
    x, y, _, _ = _data(kind, seed=50)
    back.fit(x, y)
    tnet.fit(x, y)
    assert abs(float(back.score_value) - float(tnet.score_value)) <= (
        1e-5 * abs(float(back.score_value)))
    _params_close(back, tnet)
