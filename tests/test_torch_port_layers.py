"""Layer-level parity of the PyTorch port against the JAX package at
float32: LayerNorm, the GELU activation, the transformer block and the
full forward of both transformer LMs, with and without a right-padded
mask, and the prefill KV cache the serving engine scatters.

Inputs are made with numpy from a seed and fed to both packages; the
nets are built in JAX and loaded into the port through a model zip.
Tolerance: atol = rtol = 1e-4 (the two frameworks sum in different
orders; float32 forwards agree to ~1e-6 at these widths)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.layers.attention import (
    AttentionImpl as JAttn,
    TransformerBlockImpl as JBlock,
)
from deeplearning4j_tpu.nn.layers.normalization import layer_norm as j_ln
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.ops.activations import activation as j_act
from deeplearning4j_tpu.util.model_serializer import write_model

from deeplearning4j_tpu_torch.nn.layers.attention import (
    AttentionImpl as TAttn,
    TransformerBlockImpl as TBlock,
)
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    layer_norm as t_ln,
)
from deeplearning4j_tpu_torch.ops.activations import activation as t_act
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

TOL = dict(atol=1e-4, rtol=1e-4)
V = 16


def _nets(tmp_path, arch, stream_max_t=64):
    if arch == "flagship":
        conf = jzoo.transformer_lm_flagship(vocab=V, width=32, n_layers=2,
                                            n_heads=4, seed=3)
    else:
        conf = jzoo.transformer_lm(n_in=V, width=32, n_layers=2,
                                   n_heads=4, n_classes=V, seed=3)
    for c in conf.confs:
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = stream_max_t
    jnet = JNet(conf).init()
    path = str(tmp_path / f"{arch}.zip")
    write_model(jnet, path)
    return jnet, restore_model(path, device="cpu")


def _one_hot(rng, n, t):
    ids = rng.integers(0, V, (n, t))
    x = np.zeros((n, V, t), np.float32)
    for i in range(n):
        x[i, ids[i], np.arange(t)] = 1.0
    return x


def _mask(lengths, t):
    m = np.zeros((len(lengths), t), np.float32)
    for i, n in enumerate(lengths):
        m[i, :n] = 1.0
    return m


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm_matches(axis):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 8, 5)).astype(np.float32) * 3 + 1
    n = x.shape[axis]
    g = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    want = np.asarray(j_ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                           axis=axis))
    got = t_ln(torch.as_tensor(x), torch.as_tensor(g), torch.as_tensor(b),
               axis=axis).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_layer_norm_keeps_bf16_and_f32_moments():
    x = torch.full((2, 4), 1000.0, dtype=torch.bfloat16)
    x[:, 0] = 1001.0
    y = t_ln(x, torch.ones(4), torch.zeros(4))
    assert y.dtype == torch.bfloat16 and torch.isfinite(y).all()


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    want = np.asarray(j_act("gelu")(jnp.asarray(x)))
    got = t_act("gelu")(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_transformer_block_apply_matches(tmp_path, masked):
    jnet, tnet = _nets(tmp_path, "flagship")
    rng = np.random.default_rng(1)
    t = 7
    x = rng.normal(size=(3, 32, t)).astype(np.float32)
    m = _mask([7, 4, 1], t) if masked else None
    conf = jnet.conf.confs[1]
    jo, jst = JBlock.apply(conf, jnet.params["1"], jnp.asarray(x),
                           mask=None if m is None else jnp.asarray(m))
    to, tst = TBlock.apply(tnet.conf.confs[1], tnet.params["1"],
                           torch.as_tensor(x),
                           mask=None if m is None else torch.as_tensor(m))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    # the prefill KV cache (right-aligned window + per-row filled)
    np.testing.assert_array_equal(tst["filled"].numpy(),
                                  np.asarray(jst["filled"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   **TOL)


def test_attention_apply_matches(tmp_path):
    jnet, tnet = _nets(tmp_path, "transformer_lm")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 32, 6)).astype(np.float32)
    m = _mask([6, 3], 6)
    jo, _ = JAttn.apply(jnet.conf.confs[1], jnet.params["1"],
                        jnp.asarray(x), mask=jnp.asarray(m))
    to, _ = TAttn.apply(tnet.conf.confs[1], tnet.params["1"],
                        torch.as_tensor(x), mask=torch.as_tensor(m))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


@pytest.mark.parametrize("arch", ["flagship", "transformer_lm"])
def test_full_output_matches(tmp_path, arch):
    jnet, tnet = _nets(tmp_path, arch)
    x = _one_hot(np.random.default_rng(4), 3, 9)
    want = np.asarray(jnet.output(x))
    got = tnet.output(x).numpy()
    assert got.shape == want.shape == (3, V, 9)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("arch", ["flagship", "transformer_lm"])
def test_masked_forward_matches(tmp_path, arch):
    """The serving prefill's forward: right-padded prompts with a mask,
    the prefill cache longer than the window (T > stream_max_t)."""
    jnet, tnet = _nets(tmp_path, arch, stream_max_t=8)
    x = _one_hot(np.random.default_rng(5), 3, 12)
    m = _mask([12, 5, 9], 12)
    jo, _, jrnn = jnet._forward_fn(jnet.params, jnet.state,
                                   jnp.asarray(x), None, False,
                                   feature_mask=jnp.asarray(m))
    with torch.no_grad():
        to, _, trnn = tnet._forward_fn(tnet.params, tnet.state,
                                       torch.as_tensor(x), None, False,
                                       feature_mask=torch.as_tensor(m))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert sorted(trnn) == sorted(jrnn)
    for layer, st in trnn.items():
        np.testing.assert_array_equal(st["filled"].numpy(),
                                      np.asarray(jrnn[layer]["filled"]))
        np.testing.assert_allclose(st["k"].numpy(),
                                   np.asarray(jrnn[layer]["k"]), **TOL)


def test_mixed_precision_keeps_f32_head_and_state(tmp_path):
    """compute_dtype=bfloat16: bf16 blocks, an f32 output layer, and the
    carried KV state cast back to f32 (so the paged pool is f32 while
    queries are bf16), as in the JAX package."""
    jnet, tnet = _nets(tmp_path, "flagship")
    for c in tnet.conf.confs:
        c.compute_dtype = "bfloat16"
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(tnet.conf, device="cpu").init()
    net.params = tnet.params
    net.params_version += 1
    x = torch.as_tensor(_one_hot(np.random.default_rng(6), 2, 5))
    with torch.no_grad():
        out, _, rnn = net._forward_fn(net.params, net.state, x, None,
                                      False)
    assert out.dtype == torch.float32
    assert all(st["k"].dtype == torch.float32 for st in rnn.values())
    cast = net._compute_params(net.params)
    assert cast["0"]["Wq"].dtype == torch.bfloat16
    assert cast[str(net.n_layers - 1)]["W"].dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(
        x.numpy())), atol=5e-2)
