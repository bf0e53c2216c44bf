"""Conf JSON and model.zip compatibility between the JAX package and its
PyTorch port (``deeplearning4j_tpu_torch``).

Nets are built in JAX and carried into the port through a zip written by
``deeplearning4j_tpu.util.model_serializer.write_model``; the reverse
direction writes with the port and restores in JAX. Weights must arrive
bit-identical (both sides are float32 numpy in the zip)."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.conf.multi_layer import (
    MultiLayerConfiguration as JConf,
)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.util import model_serializer as jser

from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
    MultiLayerConfiguration as TConf,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import (
    InputPreProcessor,
    RnnToFeedForwardPreProcessor,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.util import model_serializer as tser

SMALL = dict(flagship=dict(vocab=16, width=32, n_layers=2, n_heads=4),
             transformer_lm=dict(n_in=16, width=32, n_layers=2, n_heads=4,
                                 n_classes=16))
BUILDERS = {"flagship": ("transformer_lm_flagship", SMALL["flagship"]),
            "transformer_lm": ("transformer_lm", SMALL["transformer_lm"])}


def _jconf(arch):
    fn, kw = BUILDERS[arch]
    return getattr(jzoo, fn)(**kw)


@pytest.mark.parametrize("arch", sorted(BUILDERS))
def test_conf_json_round_trip_is_string_identical(arch):
    js = _jconf(arch).to_json()
    assert TConf.from_json(js).to_json() == js


@pytest.mark.parametrize("arch", sorted(BUILDERS))
def test_port_builders_emit_the_jax_json(arch):
    fn, kw = BUILDERS[arch]
    assert getattr(tzoo, fn)(**kw).to_json() == _jconf(arch).to_json()


def test_conf_with_mixed_precision_and_window_round_trips():
    conf = _jconf("flagship")
    for c in conf.confs:
        c.compute_dtype = "bfloat16"
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = 2048
            c.layer.use_flash_paged = "interpret"
    js = conf.to_json()
    assert TConf.from_json(js).to_json() == js
    assert JConf.from_json(TConf.from_json(js).to_json()).to_json() == js


@pytest.mark.parametrize("arch", sorted(BUILDERS))
def test_jax_zip_loads_in_port(tmp_path, arch):
    jnet = JNet(_jconf(arch)).init()
    path = str(tmp_path / "model.zip")
    jser.write_model(jnet, path)
    tnet = tser.restore_model(path, device="cpu")
    assert tnet.conf.to_json() == jnet.conf.to_json()
    jt, tt = jnet.param_table(), tnet.param_table()
    assert sorted(jt) == sorted(tt)
    for k in jt:
        np.testing.assert_array_equal(np.asarray(jt[k]), tt[k].numpy())


def test_port_zip_loads_in_jax(tmp_path):
    tnet = TNet(tzoo.transformer_lm_flagship(**SMALL["flagship"]),
                device="cpu").init()
    path = str(tmp_path / "port.zip")
    tser.write_model(tnet, path)
    jnet = jser.restore_model(path)
    assert jnet.conf.to_json() == tnet.conf.to_json()
    tt, jt = tnet.param_table(), jnet.param_table()
    assert sorted(jt) == sorted(tt)
    for k in tt:
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]))


def test_zip_round_trip_through_both_packages(tmp_path):
    jnet = JNet(_jconf("flagship")).init()
    p1, p2 = str(tmp_path / "a.zip"), str(tmp_path / "b.zip")
    jser.write_model(jnet, p1)
    tser.write_model(tser.restore_model(p1, device="cpu"), p2)
    back = jser.restore_model(p2)
    for k, v in jnet.param_table().items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(back.param_table()[k]))
    assert back.iteration == jnet.iteration


def test_load_numpy_params_rejects_foreign_weights():
    tnet = TNet(tzoo.transformer_lm_flagship(**SMALL["flagship"]),
                device="cpu").init()
    with pytest.raises(ValueError, match="shape"):
        tser.load_numpy_params(tnet, {"0": {"Wq": np.zeros((3, 3))}})
    with pytest.raises(ValueError, match="not in layer"):
        tser.load_numpy_params(tnet, {"0": {"W_bogus": np.zeros(3)}})
    with pytest.raises(ValueError, match="not in the network"):
        tser.load_numpy_params(tnet, {"9": {"W": np.zeros(3)}})


def test_unported_preprocessor_raises_naming_the_bean():
    """Every registered preprocessor has its forward; the abstract base
    alone raises, naming itself."""
    with pytest.raises(NotImplementedError, match="InputPreProcessor"):
        InputPreProcessor().pre_process(None)
    x = torch.zeros(2, 3, 4)
    assert RnnToFeedForwardPreProcessor().pre_process(x).shape == (8, 3)
