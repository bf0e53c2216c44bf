"""Fused and async decode rounds in the PyTorch port's ``DecodeEngine``
against the JAX engine, and against the port's own stepped engine.

One JAX-written model zip (``transformer_lm(n_in=12, width=32,
n_layers=2, n_heads=4)``, a 64-token window) serves
``tests/test_serving_fused.py``'s CASES on both packages at
``n_slots=2``, ``decode_chunk=2``, on the dense and the paged layout
(``block_tokens=8``). Greedy ids must be identical at float32: the
port's fused engine (K = 1, 2, 4, 8) against the JAX package's stepped
engine and the port's stepped engine. Sampled ids (temperature 0.9,
top-k 4) must be identical between the port's fused or async engine and
its stepped engine from the same seed. Nets, zips and engines are made
once per module; the K sweep lowers ``fused_rounds`` on one engine, as
the JAX suite does (the ring was sized for the largest K). On the CPU
every window runs its body eagerly; on the card each pow2 K replays one
captured graph (``chip_smoke.py``)."""

import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.profiler.tracer import Histogram as JHistogram
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.util.model_serializer import write_model

from deeplearning4j_tpu_torch.nn import cuda_graphs
from deeplearning4j_tpu_torch.nn.streaming import tree_map
from deeplearning4j_tpu_torch.profiler.tracer import Histogram
from deeplearning4j_tpu_torch.serving import DecodeEngine as TEngine
from deeplearning4j_tpu_torch.serving import Request as TRequest
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

V, WINDOW = 12, 64
SHARED = [1, 4, 7, 2, 5, 9, 3, 3]
PROMPT = SHARED + [1, 6, 2, 0]
CASES = [(SHARED + [1, 6], 8), (SHARED + [2, 0], 5),
         ([9, 3, 3], 11), (SHARED + [4, 8], 7), ([2, 2], 9)]
GEOMETRY = dict(n_slots=2, decode_chunk=2, seed=0)
LAYOUTS = {"dense": dict(), "paged": dict(paged_kv=True, block_tokens=8)}
SAMPLED = dict(temperature=0.9, top_k=4)

_CACHE = {}


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    conf = jzoo.transformer_lm(n_in=V, width=32, n_layers=2, n_heads=4,
                               n_classes=V, seed=7)
    for c in conf.confs:
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    path = str(tmp_path_factory.mktemp("fused") / "lm.zip")
    write_model(JNet(conf).init(), path)
    return path


def _port(zip_path, **kw):
    return TEngine(restore_model(zip_path, device="cpu"),
                   **dict(GEOMETRY, **kw))


def _serve(eng, request_cls, cases, **req):
    ids = [eng.submit(request_cls(list(p), n, **req)) for p, n in cases]
    res = eng.run()
    return [(res[i].tokens, res[i].finish_reason) for i in ids]


def _cached(name, make):
    if name not in _CACHE:
        _CACHE[name] = make()
    return _CACHE[name]


def _jax_stepped(zip_path, layout):
    return _cached(("jax", layout), lambda: _serve(
        JEngine(JNet.load(zip_path), **GEOMETRY, **LAYOUTS[layout]),
        JRequest, CASES))


def _port_stepped(zip_path, layout, **req):
    key = ("port", layout, tuple(sorted(req.items())))
    return _cached(key, lambda: _serve(
        _port(zip_path, **LAYOUTS[layout]), TRequest, CASES, **req))


def _fused_engine(zip_path, layout):
    return _cached(("fused", layout), lambda: _port(
        zip_path, fused_rounds=8, **LAYOUTS[layout]))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("k", [8, 4, 2, 1])
def test_fused_greedy_ids_equal_the_stepped_engines(zip_path, layout, k):
    eng = _fused_engine(zip_path, layout)
    eng.fused_rounds = k
    before = eng.histograms["serving_fused_rounds"].count
    got = _serve(eng, TRequest, CASES)
    assert got == _port_stepped(zip_path, layout)
    assert got == _jax_stepped(zip_path, layout)
    assert eng.histograms["serving_fused_rounds"].count > before
    assert eng.compile_counts()["fused_decode"] == 0   # CPU: eager


@pytest.mark.parametrize("knobs", [dict(fused_rounds=4),
                                   dict(async_rounds=True),
                                   dict(fused_rounds=4, async_rounds=True)])
def test_sampled_ids_equal_the_stepped_engine_from_one_seed(zip_path,
                                                             knobs):
    got = _serve(_port(zip_path, seed=3, **knobs), TRequest,
                 [(PROMPT, 12)] + CASES[:2], **SAMPLED)
    want = _cached(("sampled", 3), lambda: _serve(
        _port(zip_path, seed=3), TRequest, [(PROMPT, 12)] + CASES[:2],
        **SAMPLED))
    assert got == want


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_async_greedy_ids_equal_the_synchronous_engine(zip_path, layout):
    eng = _port(zip_path, async_rounds=True, fused_rounds=4,
                **LAYOUTS[layout])
    assert _serve(eng, TRequest, CASES) == _port_stepped(zip_path, layout)


def test_eos_inside_a_window_truncates_as_stepped(zip_path):
    prompt = CASES[2][0]
    free = _serve(_port(zip_path), TRequest, [(prompt, 16)])[0][0]
    eos = free[5]                      # lands inside the first window
    stepped = _serve(_port(zip_path), TRequest, [(prompt, 16)],
                     eos_id=eos)
    fused = _fused_engine(zip_path, "dense")
    fused.fused_rounds = 8
    assert _serve(fused, TRequest, [(prompt, 16)], eos_id=eos) == stepped
    assert stepped[0][1] == "eos"
    assert len(stepped[0][0]) == free.index(eos) + 1


def test_fused_rounds_validation(zip_path):
    with pytest.raises(ValueError, match="fused_rounds"):
        _port(zip_path, fused_rounds=-1)


def test_a_queued_arrival_makes_the_next_round_stepped(zip_path):
    eng = _port(zip_path, fused_rounds=8)
    for p, n in ((CASES[0][0], 6), (CASES[1][0], 6), (CASES[2][0], 20)):
        eng.submit(TRequest(list(p), n))        # 3 requests, 2 slots
    res, stepped = {}, 0
    while True:
        eng.step(res)
        if not eng.scheduler.pending:
            break
        # this round ran while an arrival was queued
        assert eng.histograms["serving_fused_rounds"].count == 0
        stepped += 1
    assert stepped >= 2 and eng.stats["chunks"] == stepped + 1
    res.update(eng.run())
    assert len(res) == 3
    assert eng.histograms["serving_fused_rounds"].count > 0
    assert eng.histograms["serving_host_step_s"].count > 0
    assert eng.stats["decode_steps"] > 2 * eng.stats["chunks"]


def test_has_work_while_a_round_is_in_flight(zip_path):
    eng = _port(zip_path, async_rounds=True)
    rid = eng.submit(TRequest([9, 3, 3], 3))
    eng.step()             # admits (1 token) and dispatches a round
    assert eng._inflight is not None and eng.has_work()
    assert len(eng._slots[0].tokens) == 1
    res = eng.step()       # lands it: 1 + 2 tokens, finished
    assert eng._inflight is None and not eng.has_work()
    assert len(res[rid].tokens) == 3
    rid = eng.submit(TRequest([9, 3, 3], 5))
    assert len(eng.run()[rid].tokens) == 5    # run() lands the last


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_compile_count_keys_equal_the_jax_engine(zip_path, layout):
    kw = dict(GEOMETRY, fused_rounds=4, **LAYOUTS[layout])
    want = set(JEngine(JNet.load(zip_path), **kw).compile_counts())
    assert "fused_decode" in want
    assert set(_port(zip_path, **{k: v for k, v in kw.items()
                                  if k not in GEOMETRY}).compile_counts()
               ) == want
    assert "fused_decode" not in _port(zip_path).compile_counts()


def test_ring_and_default_kv_blocks_equal_the_jax_engine(zip_path):
    kw = dict(GEOMETRY, paged_kv=True, block_tokens=8, fused_rounds=8)
    j = JEngine(JNet.load(zip_path), **kw)
    t = TEngine(restore_model(zip_path, device="cpu"), **kw)
    assert (t._ring_slots, t.kv_blocks) == (j._ring_slots, j.kv_blocks)
    assert t._ring_slots > _port(zip_path, **LAYOUTS["paged"])._ring_slots


def test_histogram_copy_matches_jax():
    values = [0.0, 1e-5, 3e-4, 0.01, 0.5, 2.0, 7.0, 1e3]
    j, t = JHistogram(), Histogram()
    for i, v in enumerate(values):
        j.observe(v, n=i + 1)
        t.observe(v, n=i + 1)
    assert t.snapshot() == j.snapshot()
    assert [t.quantile(q) for q in (0.1, 0.5, 0.99)] == [
        j.quantile(q) for q in (0.1, 0.5, 0.99)]
    assert t.prometheus_lines("x", "h") == j.prometheus_lines("x", "h")


@pytest.fixture
def replaying_runner(monkeypatch):
    """CPU tensors treated as card tensors by ``GraphRunner``, with a
    stand-in capture whose replay reruns the body on the static inputs
    and writes the results into the captured outputs."""
    def capture(self, body, inputs, key):
        # a capture runs nothing: the outputs' buffers come from a run
        # on copies, with the generators put back after it
        states = [gen.get_state() for gen in self.generators]
        outputs = body(tree_map(torch.clone, inputs))
        for gen, st in zip(self.generators, states):
            gen.set_state(st)

        class Graph:
            def replay(self):
                tree_map(lambda dst, src: dst.copy_(src), outputs,
                         body(inputs))

        self.captures += 1
        return cuda_graphs._Graph(Graph(), inputs, outputs, ())

    monkeypatch.setattr(cuda_graphs, "_on_card", lambda leaves: True)
    monkeypatch.setattr(cuda_graphs.GraphRunner, "_capture", capture)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_one_graph_per_window_size_and_no_more_on_a_repeat(
        zip_path, layout, replaying_runner):
    eng = _port(zip_path, fused_rounds=8, async_rounds=True,
                **LAYOUTS[layout])
    assert _serve(eng, TRequest, CASES) == _port_stepped(zip_path, layout)
    counts = eng.compile_counts()
    assert counts["decode"] <= 1 and 1 <= counts["fused_decode"] <= 4
    assert _serve(eng, TRequest, CASES) == _port_stepped(zip_path, layout)
    assert eng.compile_counts() == counts
