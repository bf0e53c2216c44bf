"""The port CLI's ``train``, ``test``, ``predict`` and ``client``
against the JAX package's (``deeplearning4j_tpu/cli/driver.py``),
mirroring ``tests/test_cli.py``: ``main()`` in process on tiny CSV,
properties and built-in inputs, on the CPU (``--device cpu``).

- The helpers: ``load_csv``, ``resolve_input`` and ``resolve_conf``
  give JAX's arrays and conf JSON.
- The ``train`` -> ``test`` -> ``predict`` cycle on a CSV, on a
  properties conf and on ``iris``; the default device is the card (so
  without CUDA it raises).
- ``predict --raw`` on a JAX-written zip within 1e-4 of JAX's, and the
  argmax classes identical.
- ``--mesh dp=2`` without a launcher exits saying how to launch it; a
  pp axis and ``--pp-interleave`` exit naming ROADMAP item 11b.
- ``client`` against a port gateway on the CPU, blocking and
  ``--stream``: the same lines as JAX's ``client`` against it."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.cli import driver as jcli
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.util.model_serializer import write_model as jwrite

from deeplearning4j_tpu_torch.cli import driver as tcli
from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as L
from deeplearning4j_tpu_torch.ops.losses import LossFunction
from torch_port_threads import one_torch_thread  # noqa: F401

RAW_TOL = 1e-4


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _accuracy(text):
    return float([ln for ln in text.splitlines()
                  if "Accuracy" in ln][0].split()[-1])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(120, 4)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(int)
    csv = str(d / "train.csv")
    np.savetxt(csv, np.column_stack([x, y]), delimiter=",", fmt="%.6f")
    conf = (NeuralNetConfiguration.Builder().seed(9).learning_rate(0.2)
            .list()
            .layer(0, L.DenseLayer(n_in=4, n_out=16, activation="relu"))
            .layer(1, L.OutputLayer(n_in=16, n_out=2, activation="softmax",
                                    loss_function=LossFunction.MCXENT))
            .build())
    conf_json = str(d / "conf.json")
    with open(conf_json, "w") as f:
        f.write(conf.to_json())
    props = str(d / "net.properties")
    with open(props, "w") as f:
        f.write("# comment\nlayers=4,16,3\nactivation=tanh\n"
                "learning_rate=0.1\nupdater=nesterovs\nseed=0\n")
    npz = str(d / "x.npz")
    np.savez(npz, features=x, labels=np.eye(2, dtype=np.float32)[y])
    return {"dir": d, "csv": csv, "conf": conf_json, "props": props,
            "npz": npz}


class TestHelpers:
    def test_inputs_and_confs_match_jax(self, files):
        for kw in ({}, {"label_column": None}, {"num_classes": 4}):
            a, b = tcli.load_csv(files["csv"], **kw), jcli.load_csv(
                files["csv"], **kw)
            for x, y in zip(a, b):
                if x is None:
                    assert y is None
                else:
                    np.testing.assert_array_equal(x, y)
        for uri, kw in ((files["npz"], {}), (files["csv"], {}),
                        ("iris", {}), ("mnist", {"num_examples": 64}),
                        (files["csv"], {"with_labels": False})):
            a, b = (tcli.resolve_input(uri, **kw),
                    jcli.resolve_input(uri, **kw))
            for x, y in zip(a, b):
                if x is None:
                    assert y is None
                else:
                    np.testing.assert_array_equal(x, y)
        for path in (files["conf"], files["props"]):
            assert (tcli.resolve_conf(path).to_json()
                    == jcli.resolve_conf(path).to_json())
        with pytest.raises(FileNotFoundError):
            tcli.resolve_input(str(files["dir"] / "missing.csv"))


class TestEndToEnd:
    def test_train_test_predict_cycle_on_a_csv(self, files):
        model = str(files["dir"] / "csv.zip")
        rc, out = _run(tcli.main, [
            "train", "--conf", files["conf"], "--input", files["csv"],
            "--output", model, "--epochs", "30", "--batch-size", "40",
            "--device", "cpu"])
        assert rc == 0 and os.path.exists(model) and "saved model" in out
        rc, out = _run(tcli.main, ["test", "--model", model, "--input",
                                   files["csv"], "--device", "cpu"])
        assert rc == 0 and _accuracy(out) > 0.8
        preds = str(files["dir"] / "preds.csv")
        rc, _ = _run(tcli.main, [
            "predict", "--model", model, "--input", files["csv"],
            "--has-labels", "--output", preds, "--device", "cpu"])
        assert rc == 0
        p = np.loadtxt(preds, dtype=int, ndmin=1)
        assert p.shape == (120,) and set(np.unique(p)) <= {0, 1}
        rc, out = _run(tcli.main, [
            "predict", "--model", model, "--input", files["csv"],
            "--has-labels", "--raw", "--device", "cpu"])
        probs = np.array([[float(v) for v in ln.split(",")]
                          for ln in out.splitlines() if ln])
        assert probs.shape == (120, 2)
        np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-4)

    def test_properties_conf_on_iris(self, files):
        model = str(files["dir"] / "iris.zip")
        rc, _ = _run(tcli.main, [
            "train", "--conf", files["props"], "--input", "iris",
            "--output", model, "--epochs", "60", "--device", "cpu"])
        assert rc == 0
        rc, out = _run(tcli.main, ["test", "--model", model, "--input",
                                   "iris", "--device", "cpu"])
        assert rc == 0 and _accuracy(out) > 0.85

    def test_default_device_is_the_card(self, files):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["train", "--conf", files["conf"], "--input",
                       files["csv"], "--output",
                       str(files["dir"] / "x.zip")])

    def test_predict_raw_on_a_jax_zip(self, files):
        model = str(files["dir"] / "jax.zip")
        jwrite(JNet(jzoo.mlp(sizes=(4, 8, 2), lr=0.1)).init(), model)
        argv = ["predict", "--model", model, "--input", files["csv"],
                "--has-labels", "--raw"]
        rc, out = _run(tcli.main, argv + ["--device", "cpu"])
        jrc, jout = _run(jcli.main, argv)
        assert rc == jrc == 0

        def parse(text):
            return np.array([[float(v) for v in ln.split(",")]
                             for ln in text.splitlines() if ln])

        port, ref = parse(out), parse(jout)
        assert port.shape == ref.shape == (120, 2)
        np.testing.assert_allclose(port, ref, atol=RAW_TOL, rtol=0)
        np.testing.assert_array_equal(port.argmax(1), ref.argmax(1))

    @pytest.mark.parametrize("flag,value,says", [
        pytest.param("--mesh", "dp=2", "torchrun --nproc-per-node 2",
                     id="--mesh-dp=2"),
        pytest.param("--mesh", "pp=2", "ROADMAP item 11b", id="--mesh-pp=2"),
        pytest.param("--pp-interleave", "1", "ROADMAP item 11b",
                     id="--pp-interleave-1"),
        pytest.param("--pp-interleave", "2", "ROADMAP item 11b",
                     id="--pp-interleave-2")])
    def test_parallel_flags_exit_naming_item_11(self, files, flag, value,
                                                says):
        """Without a launcher's environment a dp=2 mesh exits saying how
        to launch it (``train --mesh`` under ``torch.distributed.run``:
        ``test_torch_port_parallel.py``); a pp axis and
        ``--pp-interleave`` exit naming pipeline parallelism's item."""
        with pytest.raises(SystemExit, match=says):
            tcli.main(["train", "--conf", files["conf"], "--input",
                       files["csv"], "--output",
                       str(files["dir"] / "m.zip"), "--device", "cpu",
                       flag, value])


@pytest.fixture(scope="module")
def gateway(tmp_path_factory):
    """A port gateway on the CPU over a JAX-written tiny LM zip."""
    from deeplearning4j_tpu_torch.serving import (
        DecodeEngine,
        ServingGateway,
    )
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model,
    )

    conf = jzoo.transformer_lm(n_in=12, width=32, n_layers=2, n_heads=4,
                               n_classes=12, seed=7)
    for c in conf.confs:
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = 64
    path = str(tmp_path_factory.mktemp("client") / "lm.zip")
    jwrite(JNet(conf).init(), path)
    eng = DecodeEngine(restore_model(path, device="cpu"), n_slots=2,
                       decode_chunk=2)
    gw = ServingGateway(eng, keepalive_s=0.1).start()
    yield gw
    gw.close()


class TestClient:
    @pytest.mark.parametrize("stream", [False, True])
    def test_client_lines_match_jax(self, gateway, stream):
        argv = ["client", "--address", gateway.address, "--prompt",
                "1,4,7,2", "--max-new-tokens", "6"]
        if stream:
            argv.append("--stream")
        rc, out = _run(tcli.main, argv)
        jrc, jout = _run(jcli.main, argv)
        assert rc == jrc == 0
        assert out == jout
        tokens = [ln for ln in out.splitlines() if ln.startswith("tokens:")]
        assert len(tokens) == 1 and len(eval(tokens[0][7:])) == 6
        assert "finish_reason: length" in out
        if stream:
            assert out.count("delta:") >= 1

    def test_bad_prompt_exits(self, gateway):
        with pytest.raises(SystemExit, match="comma-separated"):
            tcli.main(["client", "--address", gateway.address,
                       "--prompt", "1,x"])
