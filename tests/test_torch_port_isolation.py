"""The PyTorch port stands alone: importing ``deeplearning4j_tpu_torch``
and every module in it pulls in neither ``jax`` nor the JAX package,
``chip_smoke.py`` imports neither, and the entry points default to the
card and refuse to run elsewhere when CUDA is absent."""

import ast
import os
import pkgutil
import subprocess
import sys
import types

import pytest
import torch

import deeplearning4j_tpu_torch
from deeplearning4j_tpu_torch.models.zoo import transformer_lm_flagship
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import DecodeEngine
from deeplearning4j_tpu_torch.util.model_serializer import (
    restore_model,
    write_model,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def _port_modules():
    pkg = deeplearning4j_tpu_torch
    return sorted(
        m.name for m in pkgutil.walk_packages(pkg.__path__,
                                              pkg.__name__ + "."))


def test_port_modules_import_without_jax():
    mods = _port_modules()
    assert "deeplearning4j_tpu_torch.serving.engine" in mods
    assert "deeplearning4j_tpu_torch.nn.layers.attention" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(repr(bad))\n")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", ["chip_smoke.py", "port package"])
def test_sources_never_import_jax(path):
    if path == "port package":
        base = os.path.dirname(deeplearning4j_tpu_torch.__file__)
        files = [os.path.join(d, f) for d, _, fs in os.walk(base)
                 for f in fs if f.endswith(".py")]
    else:
        files = [os.path.join(ROOT, path)]
    for f in files:
        bad = [m for m in _imports(f) if _forbidden(m)]
        assert not bad, f"{f} imports {bad}"


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card (or run from a directory holding only the
    script), chip_smoke.py exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    for cwd, script in ((ROOT, "chip_smoke.py"), (tmp_path, str(lone))):
        out = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


def _cpu_net():
    conf = transformer_lm_flagship(vocab=8, width=16, n_layers=1,
                                   n_heads=2)
    return MultiLayerNetwork(conf, device="cpu").init()


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    conf = transformer_lm_flagship(vocab=8, width=16, n_layers=1,
                                   n_heads=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiLayerNetwork(conf)
    path = str(tmp_path / "m.zip")
    write_model(_cpu_net(), path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        restore_model(path)
    # the engine follows the net's device and checks it is usable
    stub = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeEngine(stub)
    assert restore_model(path, device="cpu").device.type == "cpu"
    assert DecodeEngine(_cpu_net(), n_slots=1).device.type == "cpu"


def test_training_modules_are_covered():
    mods = _port_modules()
    for m in ("deeplearning4j_tpu_torch.ops.losses",
              "deeplearning4j_tpu_torch.nn.updater.updaters",
              "deeplearning4j_tpu_torch.nn.gradient",
              "deeplearning4j_tpu_torch.datasets.dataset",
              "deeplearning4j_tpu_torch.datasets.markov",
              "deeplearning4j_tpu_torch.optimize.telemetry",
              "deeplearning4j_tpu_torch.optimize.listeners"):
        assert m in mods


def test_cnn_modules_are_covered_and_default_to_cuda():
    """The CNN slice's modules are among those imported without JAX,
    and LeNet, like every entry point, is built on the card unless the
    caller asks for the CPU."""
    mods = _port_modules()
    for m in ("deeplearning4j_tpu_torch.nn.conf.inputs",
              "deeplearning4j_tpu_torch.nn.layers.convolution",
              "deeplearning4j_tpu_torch.nn.layers.dense",
              "deeplearning4j_tpu_torch.native_rt.lib",
              "deeplearning4j_tpu_torch.datasets.iterator",
              "deeplearning4j_tpu_torch.datasets.mnist",
              "deeplearning4j_tpu_torch.eval.evaluation"):
        assert m in mods
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from deeplearning4j_tpu_torch.models.zoo import lenet5

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiLayerNetwork(lenet5())
    assert MultiLayerNetwork(lenet5(), device="cpu").init().device.type \
        == "cpu"


def test_training_entry_points_default_to_cuda(tmp_path):
    """``fit`` runs on a net that only exists on the card unless built
    with ``device="cpu"``; a ``DataSet`` stays numpy on the host until
    ``fit`` moves it to the net's device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    conf = transformer_lm_flagship(vocab=8, width=16, n_layers=1,
                                   n_heads=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiLayerNetwork(conf).fit(DataSet([[[0.0]]], [[[0.0]]]))
    import numpy as np

    x = np.zeros((2, 8, 4), np.float32)
    x[:, 1, :] = 1.0
    ds = DataSet(x, x)
    assert isinstance(ds.features, np.ndarray)
    net = _cpu_net()
    net.fit(ds)
    assert net.iteration == 1 and net.params["0"]["Wq"].device.type == "cpu"


def test_flash_kernel_loader_builds_only_on_first_launch(monkeypatch):
    """Importing the attention module builds nothing; the loader asks
    ``cuda_build`` for ``csrc/flash_attention.cu`` at first launch and,
    with no ``nvcc``, raises instead of falling back."""
    from deeplearning4j_tpu_torch import cuda_build
    from deeplearning4j_tpu_torch.nn.layers import attention

    assert (cuda_build.CSRC / "flash_attention.cu").exists()
    assert "flash_attention" not in cuda_build._LIBS
    asked = []

    def fake_load(name):
        asked.append(name)
        raise RuntimeError("nvcc not found")

    attention._flash_lib.cache_clear()
    monkeypatch.setattr(cuda_build, "load", fake_load)
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            attention._flash_lib()
    finally:
        attention._flash_lib.cache_clear()
    assert asked == ["flash_attention"]
