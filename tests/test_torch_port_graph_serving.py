"""Serving a ComputationGraph in the PyTorch port against the JAX package.

One JAX-written zip of an LM-shaped transformer DAG (vocab 16, width
32, three causal blocks with block 0's and block 2's outputs meeting in
an ``ElementWiseVertex(add)``, LayerNorm, softmax; a 64-token window)
is loaded into both packages and served by each ``DecodeEngine`` at
float32 greedy:

- the dense and the paged layouts: ids identical to JAX's graph engine,
  and to the port's own ``generate`` on one request;
- DKV1 across the packages: a JAX graph engine's export imports into
  the port's graph engine (vertex names as the layer keys, sorted as
  strings on both sides) and gives the JAX donor's ids, and the port's
  export imports into JAX;
- ``snapshot`` / ``restore`` mid-run, each package's snapshot restored
  in the port, finishing with the ids JAX's uninterrupted engine gives;
  the scratch block stays out of a port snapshot;
- ``serve --model`` on a graph zip through ``gateway_from_args``;
- refusals: a graph that is not LM-shaped, and a vertex with
  ``ring_axis``.
"""

import json

import numpy as np
import pytest

from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf import layers as jL
from deeplearning4j_tpu.nn.conf.graph_conf import (
    ElementWiseOp as JOp,
    ElementWiseVertex as JEW,
)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers.attention import TransformerBlock as JTB
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.util.model_serializer import restore_model as jrestore
from deeplearning4j_tpu.util.model_serializer import write_model as jwrite

import torch

from deeplearning4j_tpu_torch.cli.driver import (
    build_parser,
    gateway_from_args,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.serving import DecodeEngine as TEngine
from deeplearning4j_tpu_torch.serving import GatewayClient
from deeplearning4j_tpu_torch.serving import Request as TRequest
from deeplearning4j_tpu_torch.serving import unpack_prefix
from deeplearning4j_tpu_torch.util.model_serializer import restore_model
from torch_port_threads import one_torch_thread  # noqa: F401

V, W, WINDOW, BT = 16, 32, 64, 8
DENSE = dict(n_slots=2, decode_chunk=4, seed=0)
PAGED = dict(DENSE, paged_kv=True, block_tokens=BT)
KV = dict(n_slots=2, decode_chunk=2, seed=0, paged_kv=True, block_tokens=BT,
          prefix_cache_rows=4)
RNG = np.random.default_rng(11)
PROMPTS = [RNG.integers(0, V, int(n)).tolist() for n in (5, 19, 3, 30, 12)]
N_GEN = [9, 14, 20, 6, 11]
KV_PROMPT = [1, 4, 7, 2, 5, 9, 3, 3, 1, 6, 2, 0, 8, 8, 4, 11, 13, 2, 6, 9]

_CACHE = {}


def _conf(ring_axis=None):
    b = (JNNC.Builder().seed(8).activation("identity")
         .weight_init("xavier").graph_builder().add_inputs("in"))
    prev = "in"
    for i in range(3):
        b.add_layer(f"block{i}", JTB(n_in=V if i == 0 else W, n_out=W,
                                     n_heads=4, causal=True,
                                     stream_max_t=WINDOW,
                                     ring_axis=ring_axis), prev)
        prev = f"block{i}"
    b.add_vertex("skip", JEW(op=JOp.ADD), "block0", "block2")
    b.add_layer("ln", jL.LayerNormalization(n_in=W, n_out=W), "skip")
    b.add_layer("out", jL.RnnOutputLayer(
        n_in=W, n_out=V, activation="softmax",
        loss_function=JLoss.MCXENT), "ln")
    return b.set_outputs("out").build()


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("graph_serving") / "dag.zip")
    jwrite(JGraph(_conf()).init(), path)
    return path


def _jnet(zip_path):
    key = ("jnet", zip_path)
    if key not in _CACHE:
        _CACHE[key] = jrestore(zip_path)
    return _CACHE[key]


def _tnet(zip_path):
    return restore_model(zip_path, device="cpu")


def _serve(eng, req_cls, prompts=PROMPTS, n_gen=N_GEN):
    ids = [eng.submit(req_cls(list(p), n)) for p, n in zip(prompts, n_gen)]
    res = eng.run()
    return [res[i].tokens for i in ids]


def _jax_ids(zip_path, layout):
    key = ("ids", layout, zip_path)
    if key not in _CACHE:
        cfg = PAGED if layout == "paged" else DENSE
        _CACHE[key] = _serve(JEngine(_jnet(zip_path), **cfg), JRequest)
    return _CACHE[key]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_graph_engine_ids_match_jax(zip_path, layout):
    tnet = _tnet(zip_path)
    assert isinstance(tnet, ComputationGraph)
    eng = TEngine(tnet, **(PAGED if layout == "paged" else DENSE))
    assert eng.vocab == V and eng.window == WINDOW
    assert _serve(eng, TRequest) == _jax_ids(zip_path, layout)
    if layout == "paged":
        # the paged pool's layer keys are the attention vertices' names
        assert sorted(eng._pool) == ["block0", "block1", "block2"]


def test_graph_engine_matches_generate(zip_path):
    tnet = _tnet(zip_path)
    prompt, n = PROMPTS[1], 10
    x = torch.nn.functional.one_hot(torch.as_tensor(prompt), V).T[None]
    want = tnet.generate(x.float(), n)[0].tolist()
    tnet.rnn_clear_previous_state()
    eng = TEngine(tnet, **PAGED)
    assert _serve(eng, TRequest, [prompt], [n]) == [want]


def _jax_donor(zip_path):
    key = ("donor", zip_path)
    if key not in _CACHE:
        eng = JEngine(_jnet(zip_path), **KV)
        ids = _serve(eng, JRequest, [KV_PROMPT], [12])[0]
        payload = eng.export_kv(KV_PROMPT)
        assert payload is not None
        _CACHE[key] = (ids, payload)
    return _CACHE[key]


def test_dkv1_from_a_jax_graph_engine_imports_into_the_port(zip_path):
    want, payload = _jax_donor(zip_path)
    layers = sorted(unpack_prefix(payload)["layers"])
    assert layers == ["block0", "block1", "block2"]
    recv = TEngine(_tnet(zip_path), **KV)
    out = recv.import_kv(payload)
    assert out["imported"] and out["prefix_len"] == len(KV_PROMPT) - 1
    rid = recv.submit(TRequest(list(KV_PROMPT), 12))
    res = recv.run()[rid]
    assert res.tokens == want
    assert res.prefix_tokens_reused == len(KV_PROMPT) - 1


def test_dkv1_from_the_port_imports_into_a_jax_graph_engine(zip_path):
    want, j_payload = _jax_donor(zip_path)
    donor = TEngine(_tnet(zip_path), **KV)
    assert _serve(donor, TRequest, [KV_PROMPT], [12])[0] == want
    payload = donor.export_kv(KV_PROMPT)
    got, ref = unpack_prefix(payload), unpack_prefix(j_payload)
    assert got["header"] == ref["header"]
    for name in ref["layers"]:
        for a, b in zip(got["layers"][name], ref["layers"][name]):
            assert float((a - b).abs().max()) <= 1e-4
    recv = JEngine(_jnet(zip_path), **KV)
    assert recv.import_kv(payload)["imported"]
    rid = recv.submit(JRequest(list(KV_PROMPT), 12))
    assert recv.run()[rid].tokens == want


def _mid_run_snapshot(eng, req_cls, steps=3):
    for p, n in zip(PROMPTS, N_GEN):
        eng.submit(req_cls(list(p), n))
    for _ in range(steps):
        eng.step()
    return json.loads(json.dumps(eng.snapshot()))


@pytest.mark.parametrize("source", ["jax", "port"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_snapshot_restores_in_the_port(zip_path, source, layout):
    """A snapshot taken after 3 rounds (by JAX's graph engine or the
    port's), through JSON, restored in a fresh port graph engine: every
    request finishes with the ids JAX's uninterrupted engine gives."""
    cfg = PAGED if layout == "paged" else DENSE
    if source == "jax":
        snap = _mid_run_snapshot(JEngine(_jnet(zip_path), **cfg), JRequest)
    else:
        snap = _mid_run_snapshot(TEngine(_tnet(zip_path), **cfg), TRequest)
        if layout == "paged":
            paged = snap["paged"]
            used = {b for tab in paged["tables"].values()
                    for b in tab["blocks"].values()}
            assert used and max(used) < paged["kv_blocks"]
            assert max(int(b) for b in paged["refcounts"]) < paged[
                "kv_blocks"]
    eng = TEngine.restore(_tnet(zip_path), snap)
    res = eng.run()
    want = _jax_ids(zip_path, layout)
    got = {rid: r.tokens for rid, r in res.items()}
    for rid, ids in got.items():
        assert ids == want[rid], rid


def test_serve_cli_takes_a_graph_zip(zip_path, tmp_path):
    args = build_parser().parse_args(
        ["serve", "--model", zip_path, "--device", "cpu", "--port", "0",
         "--slots", "2", "--decode-chunk", "4", "--paged-kv",
         "--block-tokens", str(BT)])
    gw = gateway_from_args(args).start()
    try:
        assert isinstance(gw.engine.net, ComputationGraph)
        out = GatewayClient(gw.address).generate(PROMPTS[0], N_GEN[0])
        assert out["tokens"] == _jax_ids(zip_path, "paged")[0]
    finally:
        gw.close()


def test_refusals(zip_path, tmp_path):
    """Not LM-shaped (two outputs, or n_in != n_out) and ``ring_axis``
    on a vertex raise, as JAX's engine refuses them."""
    tnet = _tnet(zip_path)
    tnet.conf.vertices["out"].conf.layer.n_out = V + 1
    with pytest.raises(ValueError, match="LM-shaped"):
        TEngine(tnet, **DENSE)
    path = str(tmp_path / "ring.zip")
    jwrite(JGraph(_conf()).init(), path)
    ring = restore_model(path, device="cpu")
    ring.conf.vertices["block1"].conf.layer.ring_axis = "sp"
    with pytest.raises(ValueError, match="ring_axis"):
        TEngine(ring, **DENSE)
