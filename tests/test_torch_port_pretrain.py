"""The pretrainable layers (RBM, AutoEncoder, RecursiveAutoEncoder), the
greedy layer-wise ``pretrain`` and the ``dbn`` zoo builder of the
PyTorch port against the JAX package.

The port's updates take their random draws as tensors
(``draw_noise``); here they are fed the draws JAX's key chain makes
(``jax.random.bernoulli(key, p)`` is ``uniform(key) < p``), so the CD-k
gradient and the corrupted autoencoder loss can be held to JAX's to
1e-6 (absolute, and relative to the larger gradients: float32 sums
of a few rounding steps), and a DBN's pretrain + finetune trajectory to
5e-3 relative with its params to 1e-4. Every port net is loaded from a
zip the JAX package wrote."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterator import (
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.enums import Updater as JUpdater
from deeplearning4j_tpu.nn.layers import pretrain as jpre
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss
from deeplearning4j_tpu.util.model_serializer import (
    restore_model as jrestore,
    write_model as jwrite,
)

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import pretrain as tpre
from deeplearning4j_tpu_torch.util.model_serializer import (
    restore_model,
    write_model,
)
from torch_port_threads import one_torch_thread  # noqa: F401

EXACT = 1e-6
FWD_ATOL = 1e-4
LOSS_RTOL = 5e-3
PARAM_ATOL = 1e-4
N_IN, N_OUT, N = 7, 5, 6
HU, VU = JL.HiddenUnit, JL.VisibleUnit


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a)


def _one_layer(bean, out=True):
    b = (JNNC.Builder().seed(4).learning_rate(0.1).updater(JUpdater.SGD)
         .activation("sigmoid").list().layer(0, bean))
    if out:
        b = b.layer(1, JL.OutputLayer(n_in=N_OUT, n_out=3,
                                      activation="softmax",
                                      loss_function=JLoss.MCXENT))
    return b.build()


def _confs(jconf):
    """(JAX layer conf, port layer conf) of layer 0."""
    tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    return jconf.confs[0], tconf.confs[0]


def _params(seed, keys=("W", "b", "vb")):
    rng = np.random.default_rng(seed)
    shapes = {"W": (N_IN, N_OUT), "b": (N_OUT,), "vb": (N_IN,),
              "U": (N_OUT, N_IN)}
    return {k: (rng.normal(size=shapes[k]) * 0.5).astype(np.float32)
            for k in keys}


def _visible(seed, kind=VU.BINARY):
    rng = np.random.default_rng(seed)
    if kind == VU.BINARY:
        return (rng.uniform(size=(N, N_IN)) < 0.4).astype(np.float32)
    return rng.normal(size=(N, N_IN)).astype(np.float32)


def _jax_rbm_noise(lc, key, n):
    """The draws JAX's ``RBMImpl.pretrain_value_and_grad`` makes from
    ``key``, in the port's ``draw_noise`` layout."""
    def hidden(k):
        if lc.hidden_unit == HU.BINARY:
            return jax.random.uniform(k, (n, lc.n_out), jnp.float32)
        if lc.hidden_unit in (HU.GAUSSIAN, HU.RECTIFIED):
            return jax.random.normal(k, (n, lc.n_out), jnp.float32)
        return None

    def visible(k):
        if lc.visible_unit == VU.BINARY:
            return jax.random.uniform(k, (n, lc.n_in), jnp.float32)
        if lc.visible_unit == VU.GAUSSIAN:
            return jax.random.normal(k, (n, lc.n_in), jnp.float32)
        return None

    def t(a):
        return None if a is None else torch.as_tensor(np.array(a))

    key0, chain = jax.random.split(key)
    noise = {"h0": t(hidden(key0)), "v": [], "h": []}
    for k in jax.random.split(chain, max(1, lc.k)):
        kv, kh = jax.random.split(k)
        noise["v"].append(t(visible(kv)))
        noise["h"].append(t(hidden(kh)))
    return noise


def _jax_ae_noise(lc, key, shape):
    if lc.corruption_level > 0.0:
        return torch.as_tensor(np.array(
            jax.random.uniform(key, shape, jnp.float32)))
    return None


# ------------------------------------------------------------------ RBM
@pytest.mark.parametrize("hidden", list(HU))
@pytest.mark.parametrize("visible", list(VU))
def test_rbm_cd1_gradient_matches_jax_with_fed_draws(hidden, visible):
    """Every hidden x visible unit kind: CD-1 from the draws of JAX's key
    chain gives JAX's score and W / b / vb gradient within 1e-6."""
    jc, tc = _confs(_one_layer(JL.RBM(
        n_in=N_IN, n_out=N_OUT, hidden_unit=hidden, visible_unit=visible,
        loss_function=JLoss.MSE)))
    p = _params(1)
    x = _visible(2, visible)
    key = jax.random.key(3)
    js, jg = jpre.RBMImpl.pretrain_value_and_grad(
        jc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), key)
    noise = _jax_rbm_noise(tc.layer, key, N)
    ts, tg = tpre.RBMImpl.pretrain_value_and_grad(
        tc, {k: torch.as_tensor(v) for k, v in p.items()},
        torch.as_tensor(x), noise)
    assert abs(float(ts) - float(js)) <= EXACT * max(1.0, abs(float(js)))
    for k in ("W", "b", "vb"):
        np.testing.assert_allclose(_np(tg[k]), np.asarray(jg[k]),
                                   atol=EXACT, rtol=EXACT, err_msg=k)


def test_rbm_cd_k_and_draw_shapes():
    """CD-3 on binary units against JAX, and ``draw_noise``'s layout:
    uniform draws for binary units, one visible and one hidden draw per
    Gibbs step."""
    jc, tc = _confs(_one_layer(JL.RBM(n_in=N_IN, n_out=N_OUT, k=3)))
    p = _params(5)
    x = _visible(6)
    key = jax.random.key(7)
    js, jg = jpre.RBMImpl.pretrain_value_and_grad(
        jc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), key)
    ts, tg = tpre.RBMImpl.pretrain_value_and_grad(
        tc, {k: torch.as_tensor(v) for k, v in p.items()},
        torch.as_tensor(x), _jax_rbm_noise(tc.layer, key, N))
    for k in ("W", "b", "vb"):
        np.testing.assert_allclose(_np(tg[k]), np.asarray(jg[k]),
                                   atol=EXACT, rtol=EXACT, err_msg=k)
    gen = torch.Generator().manual_seed(0)
    noise = tpre.RBMImpl.draw_noise(tc, gen, torch.as_tensor(x))
    assert tuple(noise["h0"].shape) == (N, N_OUT)
    assert [tuple(v.shape) for v in noise["v"]] == [(N, N_IN)] * 3
    assert all(0.0 <= float(v.min()) and float(v.max()) < 1.0
               for v in noise["v"])


# ---------------------------------------------------------- autoencoders
@pytest.mark.parametrize("corruption,sparsity", [(0.0, 0.0), (0.3, 0.0),
                                                 (0.3, 0.05)])
def test_autoencoder_loss_and_grads_match_jax(corruption, sparsity):
    jc, tc = _confs(_one_layer(JL.AutoEncoder(
        n_in=N_IN, n_out=N_OUT, corruption_level=corruption,
        sparsity=sparsity)))
    p = _params(8)
    x = np.random.default_rng(9).uniform(size=(N, N_IN)).astype(np.float32)
    key = jax.random.key(10)
    js, jg = jpre.AutoEncoderImpl.pretrain_value_and_grad(
        jc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), key)
    ts, tg = tpre.AutoEncoderImpl.pretrain_value_and_grad(
        tc, {k: torch.as_tensor(v) for k, v in p.items()},
        torch.as_tensor(x), _jax_ae_noise(tc.layer, key, x.shape))
    assert abs(float(ts) - float(js)) <= EXACT * max(1.0, abs(float(js)))
    for k in ("W", "b", "vb"):
        np.testing.assert_allclose(_np(tg[k]), np.asarray(jg[k]),
                                   atol=EXACT, rtol=EXACT, err_msg=k)


@pytest.mark.parametrize("rows", [2, 3, 9])
def test_recursive_autoencoder_matches_jax(rows):
    jc, tc = _confs(_one_layer(JL.RecursiveAutoEncoder(n_in=N_IN,
                                                       n_out=N_OUT)))
    p = _params(11, keys=("W", "U", "b", "vb"))
    x = np.random.default_rng(rows).normal(size=(rows, N_IN)).astype(
        np.float32)
    js, jg = jpre.RecursiveAutoEncoderImpl.pretrain_value_and_grad(
        jc, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), None)
    ts, tg = tpre.RecursiveAutoEncoderImpl.pretrain_value_and_grad(
        tc, {k: torch.as_tensor(v) for k, v in p.items()},
        torch.as_tensor(x))
    assert abs(float(ts) - float(js)) <= EXACT * max(1.0, abs(float(js)))
    for k in p:
        np.testing.assert_allclose(_np(tg[k]), np.asarray(jg[k]),
                                   atol=EXACT, rtol=EXACT, err_msg=k)
    with pytest.raises(ValueError, match=">= 2 rows"):
        tpre.RecursiveAutoEncoderImpl.pretrain_loss(
            tc, {k: torch.as_tensor(v) for k, v in p.items()},
            torch.as_tensor(x[:1]))


# --------------------------------------------------------- the networks
NETS = {
    "dbn": lambda: jzoo.dbn(sizes=(N_IN, 6, N_OUT, 3), lr=0.1,
                            updater=JUpdater.NESTEROVS),
    "ae": lambda: (JNNC.Builder().seed(6).learning_rate(0.2)
                   .updater(JUpdater.SGD).activation("sigmoid").list()
                   .layer(0, JL.AutoEncoder(n_in=N_IN, n_out=N_OUT,
                                            corruption_level=0.25))
                   .layer(1, JL.RecursiveAutoEncoder(n_in=N_OUT, n_out=4))
                   .layer(2, JL.OutputLayer(n_in=4, n_out=3,
                                            activation="softmax",
                                            loss_function=JLoss.MCXENT))
                   .pretrain(True).backprop(True).build()),
}


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    d = tmp_path_factory.mktemp("pretrain_zips")
    out = {}
    for name, make in NETS.items():
        out[name] = str(d / f"{name}.zip")
        jwrite(JNet(make()).init(), out[name])
    return out


def _batches(seed, n_batches=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        x = (rng.uniform(size=(N, N_IN)) < 0.5).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, N)]
        out.append((x, y))
    return out


def _feed_jax_draws(monkeypatch, jnet, tnet, batches):
    """Queue, for the port, the draws JAX's pretrain will make: its key
    chain splits ``net._key`` once per update, layer by layer, batch by
    batch, and each update draws from its subkey."""
    key = jnet._key
    queue = []
    for conf in tnet.conf.confs:
        lc = conf.layer
        if not hasattr(lc, "visible_bias_init"):
            continue
        n_iter = max(1, conf.num_iterations)
        for _ in batches:
            for _ in range(n_iter):
                key, sub = jax.random.split(key)
                if hasattr(lc, "hidden_unit"):
                    queue.append(_jax_rbm_noise(lc, sub, N))
                elif hasattr(lc, "corruption_level"):
                    queue.append(_jax_ae_noise(lc, sub, (N, lc.n_in)))
                else:
                    queue.append(None)

    def fed(cls, conf, gen, x):
        return queue.pop(0)

    for impl in (tpre.RBMImpl, tpre.AutoEncoderImpl,
                 tpre.RecursiveAutoEncoderImpl):
        monkeypatch.setattr(impl, "draw_noise", classmethod(fed))
    return queue


class _Scores:
    invoked_every = 1

    def __init__(self):
        self.scores = []

    def iteration_done(self, model, iteration):
        self.scores.append(float(model.score_value))


@pytest.mark.parametrize("name", sorted(NETS))
def test_pretrain_and_finetune_match_jax_with_fed_draws(zips, name,
                                                        monkeypatch):
    """``fit`` on an iterator with ``pretrain(True)``: greedy pretraining
    of every RBM / autoencoder layer, then 2 finetune epochs; every
    update's score within 5e-3 relative and the params within 1e-4."""
    jnet, tnet = jrestore(zips[name]), restore_model(zips[name],
                                                     device="cpu")
    batches = _batches(1)
    queue = _feed_jax_draws(monkeypatch, jnet, tnet, batches)
    js, ts = _Scores(), _Scores()
    jnet.set_listeners(js)
    tnet.set_listeners(ts)
    jnet.fit(JListIterator([JDataSet(x, y) for x, y in batches]))
    tnet.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
    assert not queue
    for x, y in batches:
        jnet.fit(x, y)
        tnet.fit(x, y)
        js.scores.append(float(jnet.score_value))
        ts.scores.append(float(tnet.score_value))
    assert len(ts.scores) == len(js.scores) > len(batches)
    np.testing.assert_allclose(ts.scores, js.scores, rtol=LOSS_RTOL)
    for k, p in jnet.param_table().items():
        np.testing.assert_allclose(_np(tnet.param_table()[k]),
                                   np.asarray(p), atol=PARAM_ATOL, err_msg=k)
    assert tnet.iteration == jnet.iteration


def test_pretrain_draws_from_the_nets_generator(zips):
    """Unfed, the draws come from the net's pretrain generator (seeded
    from the conf's seed): two nets from one zip pretrain to the same
    params, and the RBM layers move."""
    a = restore_model(zips["dbn"], device="cpu")
    b = restore_model(zips["dbn"], device="cpu")
    w0 = a.params["0"]["W"].clone()
    data = [DataSet(x, y) for x, y in _batches(2)]
    a.pretrain(ListDataSetIterator(data))
    b.pretrain(ListDataSetIterator(data))
    for k, p in a.param_table().items():
        assert torch.equal(p, b.param_table()[k]), k
    assert (a.params["0"]["W"] - w0).abs().max() > 1e-4
    assert a.iteration == 2 * len(data)


@pytest.mark.parametrize("name", sorted(NETS))
def test_forward_matches_jax(zips, name):
    jnet, tnet = jrestore(zips[name]), restore_model(zips[name],
                                                     device="cpu")
    x, _ = _batches(3)[0]
    np.testing.assert_allclose(_np(tnet.output(x)),
                               np.asarray(jnet.output(x)), atol=FWD_ATOL)


@pytest.mark.parametrize("name", sorted(NETS))
def test_zip_round_trips_both_ways(zips, name, tmp_path):
    """JAX -> port (W, b, the RBM's vb, the recursive AE's U) -> 2
    finetune steps -> a port zip JAX resumes from, matching the port's
    next step."""
    _, tnet = jrestore(zips[name]), restore_model(zips[name], device="cpu")
    for x, y in _batches(4)[:2]:
        tnet.fit(x, y)
    path = str(tmp_path / "port.zip")
    write_model(tnet, path)
    back = jrestore(path)
    assert back.iteration == 2
    for k, p in tnet.param_table().items():
        np.testing.assert_array_equal(np.asarray(back.param_table()[k]),
                                      _np(p), err_msg=k)
    x, y = _batches(5)[0]
    back.fit(x, y)
    tnet.fit(x, y)
    assert abs(float(back.score_value) - float(tnet.score_value)) <= (
        1e-5 * abs(float(back.score_value)))
