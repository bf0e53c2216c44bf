"""Early stopping and the checkpoint manager in the PyTorch port against
the JAX package.

One JAX-written zip of a small classifier (4-8-3, relu/softmax, SGD) on
a seeded three-class problem (120 train points in batches of 40, 30
held out) is trained by each package's ``EarlyStoppingTrainer`` under
each termination condition: the reason, its details, the epochs run,
the best epoch and every epoch's score (within 5e-3 relative: float32
sums in another order) agree. ``LocalFileModelSaver`` and
``InMemoryModelSaver`` keep the best model (restored with its score,
its outputs equal to the saved net's; a port-saved zip restores in
JAX); a ComputationGraph early-stops too; ``ParallelEarlyStoppingTrainer``
raises naming its ROADMAP item.

``CheckpointManager``: atomic ``step_N`` commits (no ``.tmp`` left),
keep-last-n plus best retention, the iterator's position saved and
restored so a resumed run ends on the uninterrupted run's params
(1e-6), a background write's error surfacing once, and step
directories crossing the packages both ways. The new entry points
(ComputationGraph, a graph zip's restore, the savers' and the
manager's restores) default to the card and raise without it."""

import math
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.checkpoint import CheckpointManager as JManager
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.iterator import (
    BaseDataSetIterator as JBaseIterator,
    ListDataSetIterator as JListIterator,
)
from deeplearning4j_tpu import earlystopping as jes
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers as jL
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss
from deeplearning4j_tpu.util.model_serializer import restore_model as jrestore
from deeplearning4j_tpu.util.model_serializer import write_model as jwrite

from deeplearning4j_tpu_torch import earlystopping as tes
from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import (
    BaseDataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.profiler.tracer import Tracer
from deeplearning4j_tpu_torch.util.model_serializer import restore_model
from torch_port_threads import one_torch_thread  # noqa: F401

SCORE_RTOL = 5e-3


def _data(seed=0, n=150):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 3, n)
    x = rng.normal(loc=cls[:, None] * 1.2, size=(n, 4)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[cls]


def _mlp_conf(lr):
    return (JNNC.Builder().seed(42).learning_rate(lr).list()
            .layer(0, jL.DenseLayer(n_in=4, n_out=8, activation="relu"))
            .layer(1, jL.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                     loss_function=JLoss.MCXENT))
            .build())


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    d = tmp_path_factory.mktemp("es")
    out = {}
    for name, lr in (("mlp", 0.1), ("slow", 1e-4), ("wild", 1e4),
                     ("nan", 1e38)):
        out[name] = str(d / f"{name}.zip")
        jwrite(JNet(_mlp_conf(lr)).init(), out[name])
    return out


def _iters(pkg):
    x, y = _data()
    if pkg == "jax":
        train = [JDataSet(x[i:i + 40], y[i:i + 40]) for i in (0, 40, 80)]
        return JListIterator(train), JListIterator([JDataSet(x[120:],
                                                             y[120:])])
    train = [DataSet(x[i:i + 40], y[i:i + 40]) for i in (0, 40, 80)]
    return ListDataSetIterator(train), ListDataSetIterator(
        [DataSet(x[120:], y[120:])])


CONDITIONS = {
    "max_epochs": ("mlp", lambda m: dict(epoch=[
        m.MaxEpochsTerminationCondition(5)])),
    "score_improvement": ("slow", lambda m: dict(epoch=[
        m.ScoreImprovementEpochTerminationCondition(1, 0.01),
        m.MaxEpochsTerminationCondition(30)])),
    "best_score": ("mlp", lambda m: dict(epoch=[
        m.BestScoreEpochTerminationCondition(0.8),
        m.MaxEpochsTerminationCondition(40)])),
    "max_score": ("wild", lambda m: dict(
        epoch=[m.MaxEpochsTerminationCondition(10)],
        iteration=[m.MaxScoreIterationTerminationCondition(5.0)])),
    "invalid_score": ("nan", lambda m: dict(
        epoch=[m.MaxEpochsTerminationCondition(10)],
        iteration=[m.InvalidScoreIterationTerminationCondition(),
                   m.MaxScoreIterationTerminationCondition(1e30)])),
    "max_time": ("mlp", lambda m: dict(
        epoch=[m.MaxEpochsTerminationCondition(10)],
        iteration=[m.MaxTimeIterationTerminationCondition(0.0)])),
}


def _run(pkg, zips, name, save_last=False, tracer=None):
    m = jes if pkg == "jax" else tes
    zip_name, make = CONDITIONS[name]
    conds = make(m)
    train, test = _iters(pkg)
    cfg = (m.EarlyStoppingConfiguration.Builder()
           .score_calculator(m.DataSetLossCalculator(test))
           .epoch_termination_conditions(*conds["epoch"])
           .iteration_termination_conditions(*conds.get("iteration", []))
           .model_saver(m.InMemoryModelSaver())
           .save_last_model(save_last).build())
    net = (jrestore(zips[zip_name]) if pkg == "jax"
           else restore_model(zips[zip_name], device="cpu"))
    kw = {} if tracer is None else dict(tracer=tracer)
    return m.EarlyStoppingTrainer(cfg, net, train, **kw).fit(), net


@pytest.mark.parametrize("name", sorted(CONDITIONS))
def test_termination_matches_jax(zips, name):
    want, _ = _run("jax", zips, name)
    got, _ = _run("port", zips, name)
    assert got.termination_reason.value == want.termination_reason.value
    assert got.termination_details == want.termination_details
    assert got.total_epochs == want.total_epochs
    assert got.best_model_epoch == want.best_model_epoch
    assert sorted(got.score_vs_epoch) == sorted(want.score_vs_epoch)
    for epoch, score in want.score_vs_epoch.items():
        np.testing.assert_allclose(got.score_vs_epoch[epoch], score,
                                   rtol=SCORE_RTOL)
    if math.isfinite(want.best_model_score):
        np.testing.assert_allclose(got.best_model_score,
                                   want.best_model_score, rtol=SCORE_RTOL)


def test_in_memory_best_model_is_an_independent_clone(zips):
    result, net = _run("port", zips, "max_epochs", save_last=True)
    best = result.best_model
    assert best is not net and best.iteration <= net.iteration
    x, y = _data(5)
    _, test = _iters("port")
    np.testing.assert_allclose(
        tes.DataSetLossCalculator(test).calculate_score(best),
        result.best_model_score, rtol=1e-6)


def test_local_file_saver_round_trips_and_crosses_to_jax(zips, tmp_path):
    train, test = _iters("port")
    saver = tes.LocalFileModelSaver(str(tmp_path / "saved"), device="cpu")
    cfg = (tes.EarlyStoppingConfiguration.Builder()
           .score_calculator(tes.DataSetLossCalculator(test))
           .epoch_termination_conditions(
               tes.MaxEpochsTerminationCondition(4))
           .model_saver(saver).save_last_model(True).build())
    net = restore_model(zips["mlp"], device="cpu")
    listener = tes.LoggingEarlyStoppingListener()
    result = tes.EarlyStoppingTrainer(cfg, net, train, listener).fit()
    assert [e for e, _ in listener.epochs] == [0, 1, 2, 3]
    best = saver.get_best_model()
    latest = saver.get_latest_model()
    x, _ = _data(6)
    np.testing.assert_allclose(
        tes.DataSetLossCalculator(test).calculate_score(best),
        result.best_model_score, rtol=1e-6)
    torch.testing.assert_close(latest.output(x), net.output(x), rtol=0,
                               atol=0)
    jbest = jrestore(os.path.join(saver.directory, "bestModel"))
    np.testing.assert_allclose(np.asarray(jbest.output(x)),
                               best.output(x).numpy(), atol=1e-6)


def test_a_graph_early_stops(tmp_path):
    conf = (JNNC.Builder().seed(42).learning_rate(0.1).graph_builder()
            .add_inputs("in")
            .add_layer("h", jL.DenseLayer(n_in=4, n_out=8,
                                          activation="relu"), "in")
            .add_layer("out", jL.OutputLayer(
                n_in=8, n_out=3, activation="softmax",
                loss_function=JLoss.MCXENT), "h")
            .set_outputs("out").build())
    path = str(tmp_path / "g.zip")
    jwrite(JGraph(conf).init(), path)
    results = {}
    for pkg, m, net in (("jax", jes, jrestore(path)),
                        ("port", tes, restore_model(path, device="cpu"))):
        train, test = _iters(pkg)
        cfg = (m.EarlyStoppingConfiguration.Builder()
               .score_calculator(m.DataSetLossCalculator(test))
               .epoch_termination_conditions(
                   m.MaxEpochsTerminationCondition(3))
               .build())
        results[pkg] = m.EarlyStoppingGraphTrainer(cfg, net, train).fit()
    assert isinstance(results["port"].best_model, ComputationGraph)
    assert results["port"].total_epochs == results["jax"].total_epochs
    for e, s in results["jax"].score_vs_epoch.items():
        np.testing.assert_allclose(results["port"].score_vs_epoch[e], s,
                                   rtol=SCORE_RTOL)


def test_trace_and_parallel_trainer(zips):
    tracer = Tracer()
    result, _ = _run("port", zips, "max_score", tracer=tracer)
    assert result.termination_reason == (
        tes.config.TerminationReason.ITERATION_TERMINATION_CONDITION)
    assert tracer.counter_values("train_early_stop")
    with pytest.raises(NotImplementedError, match="item 11"):
        tes.ParallelEarlyStoppingTrainer(None, None, None)


# ---------------------------------------------------- checkpoint manager
def test_checkpoint_resume_matches_the_uninterrupted_run(zips, tmp_path):
    x, y = _data(1, n=48)
    net = restore_model(zips["mlp"], device="cpu")
    it = BaseDataSetIterator(6, DataSet(x, y))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep_last_n=2)
    for _ in range(3):
        net.fit(it.next())
    mgr.save(net.iteration, net, iterator=it, score=float(net.score()))
    mgr.wait_until_finished()
    saved = it.state_dict()
    ds = it.next()
    while ds is not None:
        net.fit(ds)
        ds = it.next()
    it2 = BaseDataSetIterator(6, DataSet(x, y))
    net2, meta = mgr.restore(iterator=it2, device="cpu")
    assert it2.state_dict() == saved and meta["iteration"] == 3
    assert meta["kind"] == "multilayer" and meta["step"] == 3
    ds = it2.next()
    while ds is not None:
        net2.fit(ds)
        ds = it2.next()
    torch.testing.assert_close(net2.params_flat(), net.params_flat(),
                               rtol=0, atol=1e-6)
    names = os.listdir(mgr.directory)
    assert names == ["step_3"]
    assert sorted(os.listdir(os.path.join(mgr.directory, "step_3"))) == [
        "iterator.pkl", "meta.json", "model.zip"]


def test_retention_keeps_the_last_two_and_the_best(zips, tmp_path):
    net = restore_model(zips["mlp"], device="cpu")
    x, y = _data(2, n=12)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep_last_n=2,
                            keep_best=True, async_save=False)
    for step, score in enumerate([5.0, 1.0, 3.0, 2.0, 4.0]):
        net.fit(DataSet(x, y))
        mgr.save(step, net, score=score)
    assert mgr.all_steps() == [1, 3, 4]
    assert mgr.best_step() == 1 and mgr.latest_step() == 4
    best, meta = mgr.restore(step=1, device="cpu")
    assert meta["score"] == 1.0 and best.iteration == 2
    assert not [n for n in os.listdir(mgr.directory) if n.endswith(".tmp")]


def test_a_background_write_error_surfaces_once(zips, tmp_path):
    net = restore_model(zips["mlp"], device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"))

    def boom(step, payload):
        raise OSError("disk full")

    mgr._write = boom
    mgr.save(1, net)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait_until_finished()
    del mgr._write
    mgr.save(2, net)
    mgr.wait_until_finished()
    assert mgr.all_steps() == [2]


def test_step_directories_cross_the_packages(zips, tmp_path):
    """A JAX-written step (with a JAX iterator's position) restores in
    the port, and a port-written one in JAX: the same outputs, score
    and iterator position."""
    x, y = _data(3, n=24)
    jnet = jrestore(zips["mlp"])
    jit = JBaseIterator(6, JDataSet(x, y))
    jnet.fit(jit.next())
    jm = JManager(str(tmp_path / "jax"), async_save=False)
    jm.save(7, jnet, iterator=jit, score=0.5)
    it = BaseDataSetIterator(6, DataSet(x, y))
    net, meta = CheckpointManager(str(tmp_path / "jax")).restore(
        iterator=it, device="cpu")
    assert meta["score"] == 0.5 and it.state_dict() == jit.state_dict()
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), atol=1e-6)
    tm = CheckpointManager(str(tmp_path / "port"), async_save=False)
    net.fit(DataSet(x, y))
    tm.save(8, net, iterator=it, score=0.25)
    jit2 = JBaseIterator(6, JDataSet(x, y))
    back, jmeta = JManager(str(tmp_path / "port")).restore(iterator=jit2)
    assert jmeta["score"] == 0.25 and jit2.state_dict() == it.state_dict()
    np.testing.assert_allclose(np.asarray(back.output(x)),
                               net.output(x).numpy(), atol=1e-6)
    assert back.iteration == net.iteration == 2


def test_new_entry_points_default_to_cuda_and_raise_without_it(zips,
                                                                tmp_path):
    """ComputationGraph, a graph zip's restore, the file saver's and the
    checkpoint manager's restores run on the card unless the caller
    asks for the CPU; without CUDA they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as tL

    conf = (NeuralNetConfiguration.Builder().graph_builder()
            .add_inputs("in")
            .add_layer("out", tL.OutputLayer(n_in=4, n_out=3), "in")
            .set_outputs("out").build())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ComputationGraph(conf)
    path = str(tmp_path / "g.zip")
    ComputationGraph(conf, device="cpu").init().save(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        restore_model(path)
    saver = tes.LocalFileModelSaver(str(tmp_path / "s"))
    saver.save_best_model(restore_model(zips["mlp"], device="cpu"), 1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        saver.get_best_model()
    mgr = CheckpointManager(str(tmp_path / "c"), async_save=False)
    mgr.save(0, restore_model(path, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mgr.restore()
    assert mgr.restore(device="cpu")[0].device.type == "cpu"
