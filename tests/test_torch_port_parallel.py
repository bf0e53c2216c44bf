"""The port's data-parallel trainer against the JAX package: dp, tp,
fsdp and local-step averaging, the mesh, the collectives, the
refusals, the dry run and ``train --mesh``.

The port's ranks are gloo processes on the CPU, spawned once per module
(worlds of 2 and 4, one torch thread each; ``torch_port_ranks.py``); the
JAX package runs its ``ParallelTrainer`` on the conftest's 8 virtual CPU
devices. Both restore the same JAX-written zips and fit the same seeded
numpy global batches: loss trajectories agree within 5e-3 relative
(collectives reorder float sums), and the params after them within
1e-4. The dry run (``parallel/dryrun.py``) runs its 12 combos on
4 ranks; ``train --mesh dp=2`` runs under ``torch.distributed.run``.
"""

import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import Updater as JUpdater
from deeplearning4j_tpu.nn.conf import layers as jL
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss
from deeplearning4j_tpu.parallel import data_parallel as jdp
from deeplearning4j_tpu.parallel.mesh import MeshSpec as JMeshSpec
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh
from deeplearning4j_tpu.util.model_serializer import restore_model as jrestore
from deeplearning4j_tpu.util.model_serializer import write_model as jwrite
from deeplearning4j_tpu_torch.parallel import collectives as C
from deeplearning4j_tpu_torch.parallel import data_parallel as tdp
from deeplearning4j_tpu_torch.parallel.mesh import MeshSpec, P, make_mesh
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

import torch_port_ranks as R
from torch_port_threads import one_torch_thread  # noqa: F401

RTOL = 5e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mlp_conf():
    return (JNNC.Builder().seed(12345).learning_rate(0.1)
            .updater(JUpdater.NESTEROVS).momentum(0.9).list()
            .layer(0, jL.DenseLayer(n_in=12, n_out=8, activation="relu"))
            .layer(1, jL.DenseLayer(n_in=8, n_out=8, activation="relu"))
            .layer(2, jL.OutputLayer(n_in=8, n_out=4, activation="softmax",
                                     loss_function=JLoss.MCXENT))
            .build())


def _seq(rng, n, c, t, classes):
    x = rng.normal(size=(n, c, t)).astype(np.float32)
    y = np.zeros((n, classes, t), np.float32)
    ids = rng.integers(0, classes, (n, t))
    for i in range(n):
        y[i, ids[i], np.arange(t)] = 1.0
    return x, y


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    d = tmp_path_factory.mktemp("par")
    nets = {
        "mlp": JNet(_mlp_conf()),
        "tlm": JNet(jzoo.transformer_lm(n_in=8, width=16, n_layers=2,
                                        n_heads=4, n_classes=8, lr=1e-2)),
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
def batches():
    rng = np.random.default_rng(11)
    xm = rng.normal(size=(8, 12)).astype(np.float32)
    ym = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]
    return {"mlp": (xm, ym), "tlm": _seq(rng, 4, 8, 12, 8),
            "flag": _seq(rng, 4, 8, 12, 8)}


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


def _jax_traj(zip_path, mesh, axes, batch, steps, scan=False, **kw):
    net = jrestore(zip_path)
    tr = jdp.ParallelTrainer(net, jmake_mesh(JMeshSpec(dict(mesh))), **axes,
                             **kw)
    ds = JDataSet(*batch)
    out = [float(tr.fit(ds)) for _ in range(steps)]
    if scan:
        out += [float(s) for s in np.asarray(tr.fit_scan(
            np.stack([batch[0]] * 2), np.stack([batch[1]] * 2)))]
    return out, net


COMBOS = {
    # name: (world, zip, mesh, trainer axes, steps, with a fit_scan)
    "dp": (2, "tlm", {"dp": 2}, {}, 3, False),
    "dp_tp": (4, "mlp", {"dp": 2, "tp": 2}, {"tp_axis": "tp"}, 3, True),
    "tp_flagship": (2, "flag", {"dp": 1, "tp": 2}, {"tp_axis": "tp"}, 3,
                    False),
    "dp_fsdp": (4, "mlp", {"dp": 2, "fsdp": 2}, {"fsdp_axis": "fsdp"}, 3,
                False),
    "dp_tp_fsdp": (4, "tlm", {"dp": 1, "tp": 2, "fsdp": 2},
                   {"tp_axis": "tp", "fsdp_axis": "fsdp"}, 3, False),
}


@pytest.mark.parametrize("combo", sorted(COMBOS))
def test_trajectories_match_jax(combo, zips, batches, pool2, pool4):
    world, name, mesh, axes, steps, scan = COMBOS[combo]
    batch = batches[name]
    want, jnet = _jax_traj(zips[name], mesh, axes, batch, steps, scan)
    pool = pool2 if world == 2 else pool4
    stacked = ((np.stack([batch[0]] * 2), np.stack([batch[1]] * 2))
               if scan else None)
    res = pool.run(R.train_job, zip_path=zips[name], mesh=mesh, axes=axes,
                   batches=[batch], steps=steps, scan=stacked,
                   return_params=True)
    for r in res:
        got = r["scores"] + r.get("scan", [])
        np.testing.assert_allclose(got, want, rtol=RTOL)
        # the losses barely move under a dropped gradient reduction; the
        # params do not
        for key, sub in r["params"].items():
            for n, p in sub.items():
                np.testing.assert_allclose(
                    p, np.asarray(jnet.params[key][n]), atol=1e-4,
                    err_msg=f"{combo} {key}/{n}")


def test_step_spans_carry_the_mesh_as_jax(zips, batches, pool4):
    from deeplearning4j_tpu.profiler.tracer import Tracer as JTracer

    batch = batches["mlp"]
    mesh, axes = {"dp": 2, "tp": 2}, {"tp_axis": "tp"}
    jtracer = JTracer()
    jtr = jdp.ParallelTrainer(jrestore(zips["mlp"]),
                              jmake_mesh(JMeshSpec(dict(mesh))),
                              tracer=jtracer, **axes)
    for _ in range(2):
        jtr.fit(JDataSet(*batch))
    jtr.fit_scan(np.stack([batch[0]] * 2), np.stack([batch[1]] * 2))
    want = [e["args"] for e in jtracer.spans("train.parallel_step")]
    res = pool4.run(R.train_job, zip_path=zips["mlp"], mesh=mesh, axes=axes,
                    batches=[batch], steps=2, trace=True,
                    scan=(np.stack([batch[0]] * 2),
                          np.stack([batch[1]] * 2)))
    assert len(want) == 3
    for r in res:
        assert r["spans"] == want


def test_local_steps_then_average_params_match_jax(zips, batches, pool2):
    batch = batches["mlp"]
    kw = dict(average_each_iteration=False, local_steps=2)
    want, jnet = _jax_traj(zips["mlp"], {"dp": 2}, {}, batch, 2, **kw)
    res = pool2.run(R.train_job, zip_path=zips["mlp"], mesh={"dp": 2},
                    axes={}, batches=[batch], steps=2, trainer_kwargs=kw,
                    return_params=True)
    np.testing.assert_allclose(res[0]["scores"], want, rtol=RTOL)
    for key, sub in res[0]["params"].items():
        for n, p in sub.items():
            np.testing.assert_allclose(p, np.asarray(jnet.params[key][n]),
                                       atol=1e-4)
            np.testing.assert_array_equal(p, res[1]["params"][key][n])


def test_fsdp_shards_hold_half_of_params_and_adam_state(zips, pool2):
    rng = np.random.default_rng(5)
    batch = _seq(rng, 4, 8, 12, 8)
    dp = pool2.run(R.train_job, zip_path=zips["flag"], mesh={"dp": 2},
                   axes={}, batches=[batch], steps=2, return_shards=True)
    fs = pool2.run(R.train_job, zip_path=zips["flag"], mesh={"fsdp": 2},
                   axes={"fsdp_axis": "fsdp"}, batches=[batch], steps=2,
                   return_shards=True)
    np.testing.assert_allclose(fs[0]["scores"], dp[0]["scores"], rtol=RTOL)

    def size(tree):
        if isinstance(tree, dict):
            return sum(size(v) for v in tree.values())
        return np.asarray(tree).size

    for key in ("shards", "upd"):
        ratio = size(fs[0][key]) / size(dp[0][key])
        assert 0.45 < ratio < 0.55, (key, ratio)
    assert fs[0]["specs"]["0"]["W1"] in ((None, "fsdp"), ("fsdp", None))


def test_parallel_early_stopping_matches_jax(zips, pool2):
    from deeplearning4j_tpu import earlystopping as jes
    from deeplearning4j_tpu.datasets.iterator import ListDataSetIterator

    rng = np.random.default_rng(9)
    x = rng.normal(size=(24, 12)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 24)]
    train, test = [(x[:8], y[:8]), (x[8:16], y[8:16])], (x[16:], y[16:])
    cfg = (jes.EarlyStoppingConfiguration.Builder()
           .score_calculator(jes.DataSetLossCalculator(
               ListDataSetIterator([JDataSet(*test)])))
           .epoch_termination_conditions(
               jes.MaxEpochsTerminationCondition(3))
           .model_saver(jes.InMemoryModelSaver()).build())
    jtr = jdp.ParallelTrainer(jrestore(zips["mlp"]),
                              jmake_mesh(JMeshSpec({"dp": 2})))
    want = jes.ParallelEarlyStoppingTrainer(
        cfg, jtr, ListDataSetIterator([JDataSet(*b) for b in train])).fit()
    res = pool2.run(R.early_stopping_job, zip_path=zips["mlp"],
                    train=train, test=test, epochs=3, mesh={"dp": 2})
    for epochs, best, scores in res:
        assert (epochs, best) == (want.total_epochs, want.best_model_epoch)
        for e, s in want.score_vs_epoch.items():
            np.testing.assert_allclose(scores[e], s, rtol=RTOL)


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize("axes,n", [({"dp": -1, "tp": -1}, 8),
                                    ({"dp": -1, "tp": 3}, 8),
                                    ({"dp": -1, "tp": 2}, 8),
                                    ({"dp": 2, "tp": 2}, 8)])
def test_mesh_spec_resolve_matches_jax(axes, n):
    def outcome(spec):
        try:
            return spec.resolve(n)
        except ValueError as e:
            return str(e)

    assert outcome(MeshSpec(dict(axes))) == outcome(JMeshSpec(dict(axes)))


def _mesh_errors():
    from deeplearning4j_tpu_torch.parallel.mesh import mesh_coordinate

    out = {}
    for spec in ({"dp": 4}, {"dp": 1}, {"dp": -1, "tp": 3}):
        try:
            make_mesh(MeshSpec(spec))
            out[str(spec)] = "ok"
        except ValueError as e:
            out[str(spec)] = str(e)
    mesh = make_mesh({"dp": -1, "tp": 1})
    out["coord"] = mesh_coordinate(mesh)
    return out


def test_make_mesh_errors_match_jax(pool2):
    res = pool2.run(_mesh_errors)
    assert res[0]["{'dp': 4}"] == "Mesh needs 4 devices, have 2"
    jdevs = jax.devices()[:2]
    with pytest.raises(ValueError, match="Mesh needs 4 devices, have 2"):
        jmake_mesh(JMeshSpec({"dp": 4}), devices=jdevs)
    assert "every rank holds one device" in res[0]["{'dp': 1}"]
    assert res[0]["{'dp': -1, 'tp': 3}"] == (
        "2 devices not divisible by 3")
    assert [r["coord"] for r in res] == [{"dp": 0, "tp": 0},
                                         {"dp": 1, "tp": 0}]
    with pytest.raises(ValueError, match="initialised process group"):
        make_mesh({"dp": 1})


# ----------------------------------------------------------- collectives
def _single_rank_cases():
    x = torch.arange(12.0).reshape(3, 4)
    return {
        "copy_to_group": lambda t: C.copy_to_group(t, None),
        "reduce_from_group": lambda t: C.reduce_from_group(t, None),
        "all_reduce_sum": lambda t: C.all_reduce_sum(t, None),
        "gather_shards": lambda t: C.gather_shards(t, None, 1),
        "gather_replicas": lambda t: C.gather_replicas(t, None, 0),
        "all_to_all": lambda t: C.all_to_all(t, None, 0, 1),
    }, x


@pytest.mark.parametrize("name", sorted(_single_rank_cases()[0]))
def test_collectives_single_rank_meaning_is_identity(name):
    fns, x = _single_rank_cases()
    leaf = x.clone().requires_grad_(True)
    y = fns[name](leaf)
    torch.testing.assert_close(y, x, rtol=0, atol=0)
    g = torch.randn_like(x)
    y.backward(g)
    torch.testing.assert_close(leaf.grad, g, rtol=0, atol=0)


def _collectives_two_ranks():
    import torch.distributed as dist

    r = dist.get_rank()
    g = dist.new_group([0, 1])
    out = {}
    x = torch.full((2, 4), float(r + 1), requires_grad=True)
    y = C.copy_to_group(x, g)
    y.backward(torch.full((2, 4), float(r + 1)))
    out["f_grad"] = x.grad[0, 0].item()        # 1 + 2
    x = torch.full((2, 4), float(r + 1), requires_grad=True)
    y = C.reduce_from_group(x, g)
    out["g_fwd"] = y[0, 0].item()              # 3
    y.backward(torch.ones(2, 4))
    out["g_grad"] = x.grad[0, 0].item()        # 1
    x = torch.full((2, 2), float(r + 1), requires_grad=True)
    y = C.gather_shards(x, g, 1)
    out["gather_fwd"] = y[0].tolist()          # [1, 1, 2, 2]
    y.backward(torch.ones(2, 4) * (r + 1))
    out["gather_grad"] = x.grad[0, 0].item()   # 1 + 2 (reduce-scatter)
    x = torch.full((2, 2), float(r + 1), requires_grad=True)
    y = C.gather_replicas(x, g, 0)
    y.backward(torch.arange(8.0).reshape(4, 2))
    out["replica_grad"] = x.grad.tolist()      # own rows
    x = (torch.arange(8.0).reshape(4, 2) + 10 * r).requires_grad_(True)
    y = C.all_to_all(x, g, 0, 1)
    out["a2a_fwd"] = y.tolist()
    y.backward(torch.ones_like(y) * (r + 1))
    out["a2a_grad"] = x.grad.tolist()
    cnt = C.count_weighted_mean(torch.tensor(2.0), 3, 6)
    out["share"] = float(cnt)
    return out


def test_collectives_over_two_ranks(pool2):
    res = pool2.run(_collectives_two_ranks)
    for r, o in enumerate(res):
        assert o["f_grad"] == 3.0 and o["g_fwd"] == 3.0
        assert o["g_grad"] == 1.0
        assert o["gather_fwd"] == [1.0, 1.0, 2.0, 2.0]
        assert o["gather_grad"] == 3.0
        assert o["replica_grad"] == (
            np.arange(8.0).reshape(4, 2)[2 * r:2 * r + 2].tolist())
        assert o["share"] == 1.0
    # piece j of each rank's rows goes to rank j, received pieces laid
    # side by side (JAX's tiled all_to_all)
    a = [np.arange(8.0).reshape(4, 2) + 10 * r for r in range(2)]
    for r, o in enumerate(res):
        want = np.concatenate([a[s][2 * r:2 * r + 2] for s in range(2)], 1)
        assert o["a2a_fwd"] == want.tolist()
        # the backward is the reverse exchange of the senders' gradients
        assert o["a2a_grad"] == (
            np.concatenate([np.full((2, 2), 1.0), np.full((2, 2), 2.0)],
                           0).tolist())


# -------------------------------------------------------------- refusals
def _graph_conf():
    return (JNNC.Builder().seed(3).learning_rate(0.02).graph_builder()
            .add_inputs("in")
            .add_layer("d", jL.DenseLayer(n_in=4, n_out=4), "in")
            .add_layer("out", jL.OutputLayer(
                n_in=4, n_out=3, activation="softmax",
                loss_function=JLoss.MCXENT), "d")
            .set_outputs("out").build())


def test_tp_on_a_graph_refuses_as_jax(tmp_path):
    jnet = JGraph(_graph_conf()).init()
    path = str(tmp_path / "g.zip")
    jwrite(jnet, path)
    tnet = restore_model(path, device="cpu")
    with pytest.raises(ValueError, match="requires a MultiLayerNetwork") as t:
        tdp.tp_param_specs(tnet)
    with pytest.raises(ValueError) as j:
        jdp.tp_param_specs(jnet)
    assert str(t.value) == str(j.value)


def test_fsdp_that_shards_nothing_refuses_as_jax(zips):
    tnet = restore_model(zips["mlp"], device="cpu")
    stub = types.SimpleNamespace(mesh_dim_names=("fsdp",),
                                 mesh=torch.zeros(7))
    with pytest.raises(ValueError, match="shards NOTHING") as t:
        tdp.fsdp_param_specs(tnet, stub)
    jnet = jrestore(zips["mlp"])
    jmesh = types.SimpleNamespace(shape={"fsdp": 7})
    with pytest.raises(ValueError) as j:
        jdp.fsdp_param_specs(jnet, jmesh)
    assert str(t.value) == str(j.value)


def test_param_specs_match_jax(zips):
    for name in ("mlp", "flag"):
        jspecs = jdp.tp_param_specs(jrestore(zips[name]))
        tspecs = tdp.tp_param_specs(restore_model(zips[name], device="cpu"))
        assert {k: {n: tuple(s) for n, s in v.items()}
                for k, v in tspecs.items()} == {
            k: {n: tuple(s) for n, s in v.items()}
            for k, v in jspecs.items()}
    assert P(None, "tp") == (None, "tp")


# ------------------------------------------------- dry run and the CLI
def test_dryrun_on_four_ranks_passes_every_combo(capsys):
    from deeplearning4j_tpu_torch.parallel.dryrun import dryrun_multichip

    res = dryrun_multichip(4, device="cpu", timeout=240)
    out = capsys.readouterr().out
    assert len(res) == 12
    assert sum(1 for ln in out.splitlines()
               if ln.startswith("  ") and ln.endswith(" PASS")) == 12
    assert "FAIL" not in out
    assert out.count("not yet ported") == 6
    assert set(res) == {"dp_tp", "dp_tp_scan", "dp_local_avg", "dp_fsdp",
                        "sp", "dp_sp_conf", "graph_dp_sp", "dp_sp_tp",
                        "dp_tp_fsdp", "ep", "ep_dropping", "ep_conf"}


def test_train_mesh_dp2_under_torch_distributed_run(tmp_path):
    conf = _mlp_conf()
    conf_path = tmp_path / "conf.json"
    conf_path.write_text(conf.to_json())
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 12)).astype(np.float32)
    cls = rng.integers(0, 4, 40)
    np.savetxt(tmp_path / "d.csv", np.concatenate([x, cls[:, None]], 1),
               delimiter=",", fmt="%.6f")
    common = ["train", "--conf", str(conf_path), "--input",
              str(tmp_path / "d.csv"), "--device", "cpu", "--epochs", "2",
              "--batch-size", "20"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(R.free_port()), "-m",
         "deeplearning4j_tpu_torch.cli"] + common
        + ["--output", str(tmp_path / "mesh.zip"), "--mesh", "dp=2"],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "mesh {'dp': 2}" in run.stdout
    from deeplearning4j_tpu_torch.cli import driver

    driver.main(common + ["--output", str(tmp_path / "one.zip")])
    a = restore_model(str(tmp_path / "mesh.zip"), device="cpu")
    b = restore_model(str(tmp_path / "one.zip"), device="cpu")
    for key, sub in b.params.items():
        for n, p in sub.items():
            torch.testing.assert_close(a.params[key][n], p, atol=1e-5,
                                       rtol=1e-5)
