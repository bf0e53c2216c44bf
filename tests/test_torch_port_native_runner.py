"""The PyTorch port's native runner (``native_rt/aoti.py`` and
``csrc/aoti_runner.cpp``) against the JAX package, on the CPU.

Each exported program is held against the JAX function it replaces, on
nets loaded from JAX-written model zips: the decode step's
``ExportedProgram.module()`` against JAX's ``rnn_time_step`` (JAX's
native-decode test net, ``stream_max_t`` 32, past the window), the
6-16-3 MLP and a one-input graph against JAX's ``output``, at 1e-4
absolute and relative (float32, different summation orders). A forward
that would reach K1 or K3 on the card refuses to export, naming the
kernel, decided on meta tensors before tracing (no card needed); the
same forward exports on the CPU, where the plain versions run. The
veneer's ctypes declarations are held against the C signatures parsed
from ``aoti_runner.cpp``. The end-to-end build and run of the runner
on the CPU is marked slow: AOT-compiling even a small package takes the
host compiler about 45 s cold, and the runner's own build about 15 s
more."""

import ctypes
import os
import re
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss
from deeplearning4j_tpu.util.model_serializer import write_model

from deeplearning4j_tpu_torch.cuda_build import KernelNotExportable
from deeplearning4j_tpu_torch.models.zoo import lenet5, transformer_lm
from deeplearning4j_tpu_torch.native_rt import aoti
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import restore_model
from torch_port_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mlp_data():
    rng = np.random.default_rng(0)
    cls = rng.integers(0, 3, 96)
    x = rng.normal(loc=cls[:, None], size=(96, 6)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[cls]


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    """JAX's native-decode test net, its native-serving MLP (30 fits)
    and a one-input graph, written as model zips."""
    d = tmp_path_factory.mktemp("runner_zips")
    conf = jzoo.transformer_lm(n_in=16, width=32, n_layers=2, n_heads=4,
                               n_classes=16, seed=7)
    for c in conf.confs:
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = 32
    write_model(JNet(conf).init(), str(d / "lm.zip"))
    x, y = _mlp_data()
    mlp = JNet(JConf.Builder().seed(3).learning_rate(0.1).list()
               .layer(0, JL.DenseLayer(n_in=6, n_out=16, activation="tanh"))
               .layer(1, JL.OutputLayer(n_in=16, n_out=3,
                                        activation="softmax",
                                        loss_function=JLoss.MCXENT))
               .build()).init()
    for _ in range(30):
        mlp.fit(x, y)
    write_model(mlp, str(d / "mlp.zip"))
    graph = JGraph(
        JConf.Builder().seed(5).learning_rate(0.1).graph_builder()
        .add_inputs("in")
        .add_layer("d", JL.DenseLayer(n_in=4, n_out=8, activation="tanh"),
                   "in")
        .add_layer("out", JL.OutputLayer(n_in=8, n_out=3,
                                         activation="softmax",
                                         loss_function=JLoss.MCXENT), "d")
        .set_outputs("out").build()).init()
    write_model(graph, str(d / "graph.zip"))
    return {k: str(d / f"{k}.zip") for k in ("lm", "mlp", "graph")}


def test_decode_step_matches_jax_rnn_time_step(zips):
    jnet = JNet.load(zips["lm"])
    tnet = restore_model(zips["lm"], device="cpu")
    ep, template, tree = aoti.export_decode_step(tnet)
    assert len(template) == 6
    assert [p[-1] for p in tree.paths()] == ["filled", "k", "v"] * 2
    assert sorted({t.dtype.name for t in template}) == ["float32", "int32"]
    step = ep.module()
    xs = np.random.default_rng(0).normal(size=(40, 1, 16, 1)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        jnet.rnn_clear_previous_state()
        want = [np.asarray(jnet.rnn_time_step(x)) for x in xs]
    cache = [torch.as_tensor(t) for t in template]
    for i, x in enumerate(xs):
        out = step(torch.as_tensor(x), *cache)
        logits, cache = out[0], list(out[1:])
        assert logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), want[i], **TOL,
                                   err_msg=f"step {i}")
    filled = [c for c, p in zip(cache, tree.paths()) if p[-1] == "filled"]
    assert all(f.dtype == torch.int32 and int(f[0]) == 32 for f in filled)
    assert all(c.is_contiguous() for c in cache)


def test_mlp_export_matches_jax_output(zips):
    x, _ = _mlp_data()
    probe = x[:8]
    want = np.asarray(JNet.load(zips["mlp"]).output(probe))
    tnet = restore_model(zips["mlp"], device="cpu")
    got = aoti.export_network(tnet, probe).module()(torch.as_tensor(probe))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy().sum(axis=1), 1.0, atol=1e-5)


def test_graph_export_matches_jax_output(zips):
    x = np.random.default_rng(1).normal(size=(2, 4)).astype(np.float32)
    want = np.asarray(JGraph.load(zips["graph"]).output(x)[0])
    tgraph = restore_model(zips["graph"], device="cpu")
    got = aoti.export_network(tgraph, x).module()(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _attention_net(**kw):
    conf = transformer_lm(n_in=16, width=128, n_layers=1, n_heads=2,
                          n_classes=16, seed=7)
    for c in conf.confs:
        for k, v in kw.items():
            if hasattr(c.layer, k):
                setattr(c.layer, k, v)
    return MultiLayerNetwork(conf, device="cpu").init()


@pytest.mark.parametrize("case", ["k1_auto", "k1_forced", "k3"])
def test_export_refuses_a_forward_that_reaches_a_kernel(case):
    if case == "k3":
        net = MultiLayerNetwork(lenet5(), device="cpu").init()
        x, kernel = np.zeros((2, 1, 28, 28), np.float32), "K3"
    else:
        net = _attention_net(
            **({"use_flash": True} if case == "k1_forced" else {}))
        t = 512 if case == "k1_auto" else 64
        x, kernel = np.zeros((1, 16, t), np.float32), "K1"
    with pytest.raises(KernelNotExportable, match=kernel):
        aoti.export_network(net, x, device="cuda")
    if case == "k1_forced":
        # use_flash=True takes K1 or raises: never the plain version
        with pytest.raises(ValueError, match="use_flash=True"):
            aoti.export_network(net, x, device="cpu")
    else:
        # on the CPU the forward takes the plain versions, which trace
        assert aoti.export_network(net, x, device="cpu") is not None


def test_export_route_below_the_kernels():
    """Below FLASH_MIN_T, and for the decode step (t = 1) even with
    ``use_flash=True``, the forward on the card stays off K1: the route
    probe passes without a card."""
    net = _attention_net()
    mod = aoti.network_module(net)
    out = aoti.probe_route(mod, (torch.zeros((1, 16, 511)),), "cuda")
    assert out.is_meta and tuple(out.shape) == (1, 16, 511)
    forced = _attention_net(use_flash=True)
    step, x, template, _ = aoti.decode_step_module(forced)
    outs = aoti.probe_route(
        step, (x, *[torch.as_tensor(t) for t in template]), "cuda")
    assert len(outs) == 1 + len(template)


_CTYPES = {"void*": ctypes.c_void_p, "constvoid*": ctypes.c_void_p,
           "constchar*": ctypes.c_char_p, "char*": ctypes.c_char_p,
           "int": ctypes.c_int, "int64_t": ctypes.c_int64,
           "constint64_t*": ctypes.POINTER(ctypes.c_int64),
           "int64_t*": ctypes.POINTER(ctypes.c_int64),
           "int*": ctypes.POINTER(ctypes.c_int),
           "void**": ctypes.POINTER(ctypes.c_void_p), "void": None}


def _c_signatures():
    src = open(aoti.SOURCE).read()
    body = src[src.index('extern "C" {'):]
    sigs = {}
    for ret, name, args in re.findall(
            r"^(\w[\w\s\*]*?)\s*\b(dl4j_aoti_\w+)\(([^)]*)\)\s*\{", body,
            re.M):
        params = [re.sub(r"\s+", "", re.sub(r"\w+$", "", a.strip()))
                  for a in args.split(",") if a.strip()]
        sigs[name] = (re.sub(r"\s+", "", ret), params)
    return sigs


def test_veneer_declarations_match_the_c_symbols():
    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, type("F", (), {})())

    lib = Lib()
    aoti._declare(lib)
    sigs = _c_signatures()
    assert len(sigs) == 11 and set(sigs) == set(lib.fns)
    for name, (ret, params) in sigs.items():
        fn = lib.fns[name]
        assert fn.restype == _CTYPES[ret], name
        assert list(fn.argtypes) == [_CTYPES[p] for p in params], name


RUN_STAGE = textwrap.dedent("""
    import importlib.util, sys
    import numpy as np
    veneer, lib, d = sys.argv[1:4]
    spec = importlib.util.spec_from_file_location("veneer", veneer)
    aoti = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(aoti)
    with aoti.NativeClient("cpu", library=lib) as client:
        assert client.platform() == "cpu" and client.device_count() == 1
        np.save(d + "/mlp_out.npy",
                client.run(d + "/mlp.pt2", np.load(d + "/x.npy")))
        prog = aoti.CompiledProgram(client, d + "/step.pt2")
        z = np.load(d + "/cache0.npz")
        cache = [aoti.buffer_from_host(client, z["arr_%d" % i])
                 for i in range(len(z.files))]
        outs = []
        for x in np.load(d + "/xs.npy"):
            inp = aoti.buffer_from_host(client, x)
            res = prog.execute([inp] + cache)
            outs.append(res[0].to_host())
            for b in [inp, res[0]] + cache:
                b.destroy()
            cache = res[1:]
        prog.destroy()
    np.save(d + "/step_out.npy", np.stack(outs))
    assert "torch" not in sys.modules
    print("RUNNER_OK")
""")


@pytest.mark.slow
def test_runner_builds_and_runs_packages_without_torch(zips, tmp_path):
    lib = aoti.build_runner()
    x, _ = _mlp_data()
    mlp = restore_model(zips["mlp"], device="cpu")
    aoti.export_network_for_native(mlp, x[:8], str(tmp_path / "mlp.pt2"))
    lm = restore_model(zips["lm"], device="cpu")
    _, template, _ = aoti.export_decode_step_for_native(
        lm, str(tmp_path / "step.pt2"))
    xs = np.random.default_rng(0).normal(size=(40, 1, 16, 1)).astype(
        np.float32)
    np.save(tmp_path / "x.npy", x[:8])
    np.save(tmp_path / "xs.npy", xs)
    np.savez(tmp_path / "cache0.npz", *template)
    out = subprocess.run(
        [sys.executable, "-c", RUN_STAGE, aoti.__file__, str(lib),
         str(tmp_path)], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "RUNNER_OK" in out.stdout, out.stderr
    np.testing.assert_allclose(np.load(tmp_path / "mlp_out.npy"),
                               mlp.output(x[:8]).numpy(), atol=1e-5)
    lm.rnn_clear_previous_state()
    want = np.stack([lm.rnn_time_step(x).numpy() for x in xs])
    np.testing.assert_allclose(np.load(tmp_path / "step_out.npy"), want,
                               atol=1e-5, rtol=1e-5)
