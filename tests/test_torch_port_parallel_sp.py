"""The port's sequence and expert parallelism and its sharded checkpoints
against the JAX package.

gloo ranks on the CPU (``torch_port_ranks.py``, worlds of 2 and 4)
against JAX's ``ParallelTrainer`` on the conftest's 8 virtual CPU
devices, over the same JAX-written zips and seeded numpy batches: ring
and Ulysses attention, dp x sp, dp x sp x tp, a ComputationGraph, a
masked batch (key masks hopping with their K/V blocks, the global masked
mean), ``sp_scan`` in a GravesLSTM and a GRU, ``make_ep_moe``'s
all-to-all dispatch (capacity that drops nothing, and one that drops
per rank) and ``ParallelTrainer(ep_axis=)``: loss trajectories within
5e-3 relative. ``OrbaxCheckpointer``: a tp=2 checkpoint restores into a
single-device net (params equal to the gathered ones) and into a dp=2
trainer (DCP reshards).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.datasets.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import Updater as JUpdater
from deeplearning4j_tpu.nn.conf import layers as jL
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers.attention import (
    MultiHeadSelfAttention as JMHSA,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss
from deeplearning4j_tpu.parallel import expert_parallel as jep
from deeplearning4j_tpu.parallel.data_parallel import ParallelTrainer as JPT
from deeplearning4j_tpu.parallel.mesh import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh
from deeplearning4j_tpu.util.model_serializer import restore_model as jrestore
from deeplearning4j_tpu.util.model_serializer import write_model as jwrite
from deeplearning4j_tpu_torch.checkpoint.orbax_io import OrbaxCheckpointer
from deeplearning4j_tpu_torch.util.model_serializer import (
    restore_model,
    write_model,
)

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP

import torch_port_ranks as R
from torch_port_threads import one_torch_thread  # noqa: F401

RTOL = 5e-3


def _seq(rng, n, c, t, classes):
    x = rng.normal(size=(n, c, t)).astype(np.float32)
    y = np.zeros((n, classes, t), np.float32)
    ids = rng.integers(0, classes, (n, t))
    for i in range(n):
        y[i, ids[i], np.arange(t)] = 1.0
    return x, y


def _rnn_conf(kind):
    layer = (jL.GravesLSTM if kind == "lstm" else jL.GRU)(
        n_in=4, n_out=6, activation="tanh", ring_axis="sp")
    return (JNNC.Builder().seed(5).learning_rate(0.05)
            .updater(JUpdater.ADAM).list()
            .layer(0, layer)
            .layer(1, jL.RnnOutputLayer(n_in=6, n_out=3,
                                        activation="softmax",
                                        loss_function=JLoss.MCXENT))
            .build())


def _graph_conf():
    return (JNNC.Builder().seed(3).learning_rate(0.02).graph_builder()
            .add_inputs("in")
            .add_layer("attn", JMHSA(n_in=8, n_out=8, n_heads=2,
                                     causal=True, ring_axis="sp"), "in")
            .add_layer("out", jL.RnnOutputLayer(
                n_in=8, n_out=8, activation="softmax",
                loss_function=JLoss.MCXENT), "attn")
            .set_outputs("out").build())


def _tlm(mode="ring", block=None):
    conf = jzoo.transformer_lm(n_in=8, width=16, n_layers=2, n_heads=4,
                               n_classes=8, lr=1e-2, ring_axis="sp")
    for c in conf.confs:
        if hasattr(c.layer, "sp_mode"):
            c.layer.sp_mode = mode
            c.layer.ring_block_size = block
    return conf


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    d = tmp_path_factory.mktemp("sp")
    nets = {
        "ring": JNet(_tlm()), "ulysses": JNet(_tlm("ulysses")),
        "ring_block": JNet(_tlm(block=3)),
        "graph": JGraph(_graph_conf()),
        "lstm": JNet(_rnn_conf("lstm")), "gru": JNet(_rnn_conf("gru")),
        "moe": JNet(jzoo.moe_transformer_lm(
            n_in=8, width=8, n_blocks=1, n_heads=2, n_classes=4,
            n_experts=4, n_hidden=16, lr=1e-2)),
        "flag": JNet(jzoo.transformer_lm_flagship(
            vocab=8, width=16, n_layers=2, n_heads=4, lr=1e-2,
            warmup_steps=1, total_steps=50)),
    }
    out = {}
    for name, net in nets.items():
        out[name] = str(d / f"{name}.zip")
        jwrite(net.init(), out[name])
    return out


@pytest.fixture(scope="module")
def pool2():
    pool = R.RankPool(2)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def pool4():
    pool = R.RankPool(4)
    yield pool
    pool.close()


def _batch(kind):
    rng = np.random.default_rng(7)
    if kind in ("lstm", "gru"):
        return _seq(rng, 4, 4, 12, 3), None
    if kind == "moe":
        return _seq(rng, 2, 8, 4, 4), None
    x, y = _seq(rng, 4, 8, 12, 8)
    if kind != "masked":
        return (x, y), None
    fm = np.ones((4, 12), np.float32)
    fm[0, 9:] = 0.0
    fm[3, 5:] = 0.0
    return (x, y), (fm, fm.copy())


SP = {
    # name: (world, zip, mesh, axes, batch kind)
    "ring": (2, "ring", {"sp": 2}, {"sp_axis": "sp"}, "seq"),
    "ulysses": (2, "ulysses", {"sp": 2}, {"sp_axis": "sp"}, "seq"),
    "ring_block": (2, "ring_block", {"sp": 2}, {"sp_axis": "sp"}, "seq"),
    "dp_sp_conf": (4, "ring", {"dp": 2, "sp": 2}, {"sp_axis": "sp"},
                   "seq"),
    "dp_sp_masked": (4, "ring", {"dp": 2, "sp": 2}, {"sp_axis": "sp"},
                     "masked"),
    "dp_sp_tp": (4, "ring", {"dp": 1, "sp": 2, "tp": 2},
                 {"sp_axis": "sp", "tp_axis": "tp"}, "seq"),
    "graph_dp_sp": (4, "graph", {"dp": 2, "sp": 2}, {"sp_axis": "sp"},
                    "seq"),
    "lstm_sp_scan": (2, "lstm", {"sp": 2}, {"sp_axis": "sp"}, "lstm"),
    "gru_sp_scan": (2, "gru", {"sp": 2}, {"sp_axis": "sp"}, "gru"),
    "ep_conf": (2, "moe", {"dp": 1, "ep": 2}, {"ep_axis": "ep"}, "moe"),
}


@pytest.mark.parametrize("combo", sorted(SP))
def test_trajectories_match_jax(combo, zips, pool2, pool4):
    world, name, mesh, axes, kind = SP[combo]
    (x, y), masks = _batch(kind)
    graph = name == "graph"
    jnet = jrestore(zips[name])
    jtr = JPT(jnet, jmake_mesh(JMeshSpec(dict(mesh))), **axes)
    if graph:
        jds = JMultiDataSet([x], [y])
    else:
        jds = JDataSet(x, y, *(masks or (None, None)))
    want = [float(jtr.fit(jds)) for _ in range(3)]
    pool = pool2 if world == 2 else pool4
    res = pool.run(R.train_job, zip_path=zips[name], mesh=mesh, axes=axes,
                   batches=[(x, y)], steps=3, graph=graph, masks=masks)
    for r in res:
        np.testing.assert_allclose(r["scores"], want, rtol=RTOL)


# ------------------------------------------------------------------ ep
def _jax_ep(params, x, cf, aux_weight, steps, n):
    mesh = jmake_mesh(JMeshSpec({"ep": n}), devices=jax.devices()[:n])
    fn = jep.make_ep_moe(mesh, "ep", capacity_factor=cf)
    p = jax.device_put({k: jnp.asarray(v) for k, v in params.items()},
                       jep.ep_param_shardings(mesh, "ep"))
    xe = jax.device_put(jnp.asarray(x), NamedSharding(mesh, JP("ep", None)))

    def loss(p, x):
        y, aux = fn(p, x)
        return jnp.mean(y ** 2) + aux_weight * aux

    step = jax.jit(jax.value_and_grad(loss))
    out = []
    for _ in range(steps):
        lv, g = step(p, xe)
        p = jax.tree.map(lambda a, b: a - 0.01 * b, p, g)
        out.append(float(lv))
    return out


@pytest.mark.parametrize("cf,aux_weight", [(4.0, 0.0), (2.0, 0.01)],
                         ids=["ep", "ep_dropping"])
def test_ep_dispatch_matches_jax(cf, aux_weight, pool2):
    params = {k: np.asarray(v) for k, v in jep.init_moe_params(
        jax.random.key(0), 4, 8, 16).items()}
    x = np.random.default_rng(3).normal(size=(16, 8)).astype(np.float32)
    want = _jax_ep(params, x, cf, aux_weight, 2, 2)
    res = pool2.run(R.ep_job, params=params, x=x, capacity_factor=cf,
                    aux_weight=aux_weight, steps=2)
    for r in res:
        np.testing.assert_allclose(r["losses"], want, rtol=RTOL)


# ---------------------------------------------------------- checkpoint
def test_checkpoint_across_world_sizes(zips, pool2, tmp_path):
    (x, y), _ = _batch("seq")
    d = str(tmp_path / "ckpt")
    res = pool2.run(R.checkpoint_job, zip_path=zips["flag"],
                    mesh={"dp": 1, "tp": 2}, axes={"tp_axis": "tp"},
                    batch=(x, y), steps=2, directory=d,
                    restore_mesh={"dp": 2}, restore_axes={})
    whole = res[0]["params"]
    ck = OrbaxCheckpointer(d)
    assert ck.all_steps() == [2] and ck.latest_step() == 2
    net = ck.restore(device="cpu")
    assert net.iteration == 2
    for key, sub in whole.items():
        for n, p in sub.items():
            np.testing.assert_array_equal(net.params[key][n].numpy(), p)
            np.testing.assert_array_equal(res[1]["restored"][key][n], p)
    for key, moments in res[0]["upd"].items():
        for mk, sub in moments.items():
            for n, t in sub.items():
                np.testing.assert_array_equal(
                    net.updater_state[key][mk][n].numpy(), t)
    assert res[0]["iteration"] == 2
    # the restored single-device net trains on as the JAX net does
    path = str(tmp_path / "restored.zip")
    write_model(net, path)
    back = restore_model(path, device="cpu")
    torch.testing.assert_close(back.output(x), net.output(x), rtol=0,
                               atol=0)
