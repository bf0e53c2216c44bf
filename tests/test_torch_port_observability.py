"""Incremental delivery and request-scoped observability in the PyTorch
port, against the JAX package: committed-token deltas, the phase clock
and the flight recorder, the tracer with its Prometheus exposition, and
the engine's tracer mirrors.

One JAX-written model zip (the JAX gateway tests' net,
``transformer_lm(n_in=12, width=32, n_layers=2, n_heads=4)``, a 64-token
window) is loaded into both packages; everything runs at float32 greedy
unless a case samples. Deltas are compared step by step: both engines
run with ``emit_deltas=True`` and ``drain_deltas()`` after every
``step()``, and the per-step delta lists must be identical, for plain,
fused (K=4), speculative, chunked-prefill (paged, with the prefix
cache), fault-retry and snapshot/restore runs (twins of
``tests/test_serving_gateway.py``'s ``TestDeltaEmission``). The phase
clock and flight-recorder cases twin ``tests/test_observability.py``'s
``TestEnginePhaseClock`` and compare what is deterministic across the
packages (histogram counts, span names and request ids, flight-record
shapes). The tracer cases feed the same calls into both packages'
tracers: ``prometheus_text`` is byte-identical and ``parse_exposition``
and ``merge_prometheus`` agree. No case asserts a wall time.

The port's engines run under a stand-in capture (a replay reruns the
body on the graph's static inputs), so ``compile_counts()`` counts the
graphs a card run would capture."""

import json
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.profiler import tracer as jtracer
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.serving import FaultEvent as JEvent
from deeplearning4j_tpu.serving import FaultPlan as JPlan
from deeplearning4j_tpu.serving import ManualClock as JClock
from deeplearning4j_tpu.serving import NgramDraftTable as JDrafts
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.util.model_serializer import (
    restore_model as j_restore_model,
)
from deeplearning4j_tpu.util.model_serializer import write_model

from deeplearning4j_tpu_torch.nn import cuda_graphs
from deeplearning4j_tpu_torch.nn.streaming import tree_map
from deeplearning4j_tpu_torch.profiler import tracer as ttracer
from deeplearning4j_tpu_torch.serving import DecodeEngine as TEngine
from deeplearning4j_tpu_torch.serving import FaultEvent, FaultPlan
from deeplearning4j_tpu_torch.serving import ManualClock, NgramDraftTable
from deeplearning4j_tpu_torch.serving import Request as TRequest
from deeplearning4j_tpu_torch.serving import engine as engine_module
from deeplearning4j_tpu_torch.util.model_serializer import restore_model
from torch_port_threads import one_torch_thread  # noqa: F401

V, WINDOW = 12, 64
PROMPTS = [[1, 4, 7, 2], [9, 3, 3], [5, 2, 8, 1, 6, 0, 4], [2, 2],
           [11, 0, 6]]
LENS = [6, 11, 4, 9, 13]
SHARED = [1, 2, 3, 4, 5, 6]
CHUNKED_PROMPTS = [SHARED + [i % V, (i * 3) % V] for i in range(6)]
SPEC_PROMPTS = [[1, 2, 3] * 5, [4, 5] * 6] + PROMPTS[:3]

JAX = types.SimpleNamespace(name="jax", Engine=JEngine, Request=JRequest,
                            Plan=JPlan, Event=JEvent, Clock=JClock,
                            Drafts=JDrafts, tracer=jtracer)
PORT = types.SimpleNamespace(name="port", Engine=TEngine, Request=TRequest,
                             Plan=FaultPlan, Event=FaultEvent,
                             Clock=ManualClock, Drafts=NgramDraftTable,
                             tracer=ttracer)
PKGS = {"jax": JAX, "port": PORT}

_NETS = {}


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    conf = jzoo.transformer_lm(n_in=V, width=32, n_layers=2, n_heads=4,
                               n_classes=V, seed=7)
    for c in conf.confs:
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    path = str(tmp_path_factory.mktemp("observability") / "lm.zip")
    write_model(JNet(conf).init(), path)
    return path


def _net(pkg, zip_path):
    """The zip in ``pkg`` (one JAX net a module: its engines share it;
    a fresh port net each time)."""
    if pkg is JAX:
        key = ("jax", zip_path)
        if key not in _NETS:
            _NETS[key] = j_restore_model(zip_path)
        return _NETS[key]
    return restore_model(zip_path, device="cpu")


def _capture(self, body, inputs, key):
    """``GraphRunner._capture``'s stand-in: the body runs once on copies
    of the inputs (the generators' states put back); a replay reruns it
    on the static inputs, writing into the captured outputs."""
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


@pytest.fixture(autouse=True)
def replaying_runner(monkeypatch):
    monkeypatch.setattr(cuda_graphs, "_on_card", lambda leaves: True)
    monkeypatch.setattr(cuda_graphs.GraphRunner, "_capture", _capture)


def _phase_sum(timing):
    return (timing["queue_wait_s"] + timing["admission_s"]
            + timing["decode_s"] + timing["verify_s"]
            + timing["stall_s"])


# -- deltas ----------------------------------------------------------------
def _stepwise(eng, pkg, prompts, lens, **req_kw):
    """Submit, then step with a drain after every step: (ids, [per-step
    {rid: delta}], results)."""
    ids = [eng.submit(pkg.Request(list(p), n, **req_kw))
           for p, n in zip(prompts, lens)]
    steps, res = [], {}
    while eng.has_work():
        eng.step(res)
        steps.append(eng.drain_deltas())
    return ids, steps, res


def _adversary(pkg, wrong):
    class Adversary(pkg.Drafts):
        def draft(self, slot, k):
            return [wrong] * k if k > 0 else []

    return Adversary()


def _delta_case(pkg, zip_path, case):
    """One configuration's stepwise run in ``pkg``: (ids, steps,
    {rid: tokens}, extra)."""
    net = _net(pkg, zip_path)
    extra = {}
    if case == "plain":
        eng = pkg.Engine(net, n_slots=2, decode_chunk=3, seed=0,
                         emit_deltas=True)
        ids, steps, res = _stepwise(eng, pkg, PROMPTS, LENS)
    elif case == "fused":
        eng = pkg.Engine(net, n_slots=2, decode_chunk=3, seed=0,
                         fused_rounds=4, emit_deltas=True)
        ids, steps, res = _stepwise(eng, pkg, PROMPTS[:2], [25, 31])
        extra["fused"] = eng.stats["chunks"]
    elif case == "spec":
        # a draft table that is always wrong (rejected tails), then the
        # engine's own n-gram table (accepted drafts) on one engine
        eng = pkg.Engine(net, n_slots=2, decode_chunk=2, seed=0,
                         spec_draft_len=4, emit_deltas=True)
        own = eng.spec
        eng.spec = _adversary(pkg, 5)
        ids, steps, res = _stepwise(eng, pkg, PROMPTS[:2], LENS[:2])
        rejected = (eng.stats["spec_drafted"], eng.stats["spec_accepted"])
        eng.spec = own
        ids2, steps2, res2 = _stepwise(eng, pkg, SPEC_PROMPTS, [14] * 5)
        ids, steps = ids + ids2, steps + steps2
        res.update(res2)
        extra["spec"] = (rejected, eng.stats["spec_accepted"])
    elif case == "chunked":
        eng = pkg.Engine(net, n_slots=2, decode_chunk=2, seed=0,
                         paged_kv=True, block_tokens=8,
                         prefix_cache_rows=4, prefill_chunk=4,
                         admission_policy="decode", emit_deltas=True)
        ids, steps, res = _stepwise(eng, pkg, CHUNKED_PROMPTS,
                                    [10 + i % 3 for i in range(6)])
        extra["skipped"] = eng.stats["prefill_tokens_skipped"]
    elif case == "fault_retry":
        eng = pkg.Engine(net, n_slots=1, decode_chunk=2, seed=0,
                         paranoid=True, max_retries=3, emit_deltas=True,
                         fault_plan=pkg.Plan([pkg.Event(2, "nan",
                                                        slot=0)]))
        ids, steps, res = _stepwise(eng, pkg, [[1, 4, 7, 2]], [10])
        extra["retries"] = res[ids[0]].retries
    elif case == "restore":
        eng = pkg.Engine(net, n_slots=2, decode_chunk=2, seed=0,
                         emit_deltas=True)
        ids = [eng.submit(pkg.Request(list(p), 12)) for p in PROMPTS[:3]]
        steps = []
        for _ in range(3):
            eng.step()
            steps.append(eng.drain_deltas())
        eng.step()   # undrained: its deltas are not delivered
        snap = json.loads(json.dumps(eng.snapshot()))
        extra["delta_sent"] = [s and s["delta_sent"] for s in snap["slots"]]
        eng2 = pkg.Engine.restore(_net(pkg, zip_path), snap)
        eng2.emit_deltas = True
        res = {}
        while eng2.has_work():
            eng2.step(res)
            steps.append(eng2.drain_deltas())
    return ids, steps, {rid: list(r.tokens) for rid, r in res.items()}, extra


DELTA_CASES = ("plain", "fused", "spec", "chunked", "fault_retry",
               "restore")


@pytest.mark.parametrize("case", DELTA_CASES)
def test_stepwise_deltas_match_jax(zip_path, case):
    """Per-step delta lists identical to the JAX engine's, and the deltas
    concatenate to each request's tokens (a rejected draft tail, a
    quarantined round and an already streamed prefix never reach a
    consumer)."""
    want = _delta_case(JAX, zip_path, case)
    got = _delta_case(PORT, zip_path, case)
    ids, steps, tokens, extra = got
    assert got[0] == want[0]
    assert steps == want[1]
    assert tokens == want[2]
    assert extra == want[3]
    for rid in ids:
        streamed = [t for step in steps for t in step.get(rid, [])]
        assert streamed == tokens[rid], rid
    if case == "fused":
        assert extra["fused"] < sum(-(-n // 3) for n in (25, 31))
    if case == "spec":
        (drafted, accepted), honest = extra["spec"]
        assert drafted > accepted and honest > accepted
    if case == "chunked":
        assert extra["skipped"] > 0
    if case == "fault_retry":
        assert extra["retries"] == 1
    if case == "plain":
        # incremental: at most one chunk (+ the admission's token) a step
        assert max(len(d) for s in steps for d in s.values()) <= 3 + 1


@pytest.mark.parametrize("pkg_name", ["jax", "port"])
def test_sampled_stream_victim_faults_instead_of_splicing(zip_path,
                                                         pkg_name):
    """A sampled request that already streamed tokens ends ``"fault"``
    when quarantine would retry it, its terminal holding exactly what
    was streamed; without a delta consumer it is retried as before.
    Sampled ids differ across the packages (their generators differ):
    the contract is compared, not the ids."""
    pkg = PKGS[pkg_name]

    def run(streaming):
        deltas = {}
        kw = {}
        if streaming:
            kw["on_delta"] = (
                lambda rid, t: deltas.setdefault(rid, []).extend(t))
        eng = pkg.Engine(_net(pkg, zip_path), n_slots=1, decode_chunk=2,
                         seed=0, paranoid=True, max_retries=3,
                         fault_plan=pkg.Plan([pkg.Event(2, "nan",
                                                        slot=0)]), **kw)
        rid = eng.submit(pkg.Request([1, 4, 7, 2], 12, temperature=1.0))
        return eng.run()[rid], deltas.get(rid, [])

    res, streamed = run(True)
    assert res.finish_reason == "fault"
    assert len(streamed) >= 1 and list(res.tokens) == streamed
    res2, _ = run(False)
    assert res2.finish_reason == "length" and res2.retries == 1


def test_sampled_preemption_victim_faults(zip_path):
    """Preemption's twin of the carve-out (paged, a pool too small for
    two sampled streams): a preempted sampled request that streamed ends
    ``"fault"``; greedy victims regenerate and stream no token twice."""
    net = _net(PORT, zip_path)
    deltas = {}
    eng = TEngine(net, n_slots=2, decode_chunk=8, seed=0, paged_kv=True,
                  block_tokens=8, kv_blocks=13,
                  on_delta=lambda rid, t: deltas.setdefault(
                      rid, []).extend(t))
    ids = [eng.submit(TRequest(list(p), 56, temperature=t))
           for p, t in ((PROMPTS[0], 0.0), (PROMPTS[1], 1.0))]
    res = eng.run()
    # the reservation for slot 0 preempts the youngest slot, the sampled
    # one, after it streamed
    assert eng.stats["preempted"] >= 1
    for rid in ids:
        assert deltas.get(rid, []) == list(res[rid].tokens)
    assert res[ids[1]].finish_reason == "fault"
    assert 0 < len(res[ids[1]].tokens) < 56
    assert res[ids[0]].finish_reason == "length"


# -- phase clock and flight recorder ----------------------------------------
#: the JAX engine's histogram of the feature the port refuses (tensor
#: parallelism: ROADMAP item 11)
JAX_ONLY = {"serving_tp_dispatch_s"}


def _hist_counts(eng):
    """Each histogram's count, those of ``JAX_ONLY`` left out."""
    return {k: h.count for k, h in sorted(eng.histograms.items())
            if k not in JAX_ONLY}


def _span_view(tracer):
    """(name, rid or sorted rids) of every span and request_done
    instant, sorted: what both packages' traces must agree on."""
    out = []
    for e in tracer.events():
        if e["ph"] not in ("X", "i"):
            continue
        args = e.get("args") or {}
        out.append((e["name"], args.get("rid"),
                    tuple(sorted(args.get("rids", ()))),
                    args.get("reason")))
    return sorted(out, key=repr)


def _traced_run(pkg, zip_path):
    tracer = pkg.tracer.Tracer()
    eng = pkg.Engine(_net(pkg, zip_path), n_slots=2, decode_chunk=3,
                     seed=0, prefix_cache_rows=4, prefill_chunk=4,
                     tracer=tracer)
    ids = [eng.submit(pkg.Request(list(p), n))
           for p, n in zip(PROMPTS[:4] + [[1, 4, 7, 2, 9]], LENS)]
    return eng, tracer, ids, eng.run()


def test_timing_breakdown_histograms_and_spans_match_jax(zip_path):
    """Every result's timing sums under its e2e and repeats its TTFT;
    the flight record holds it with a queue_wait first and a
    first_token and a terminal event; the engine's histograms are the
    tracer's, by reference, with JAX's names and counts; the spans and
    ``serving.request_done`` instants carry the same request ids as
    JAX's."""
    jeng, jtr, jids, jres = _traced_run(JAX, zip_path)
    eng, tracer, ids, res = _traced_run(PORT, zip_path)
    assert ids == jids
    for rid in ids:
        timing = res[rid].timing
        assert sorted(timing) == sorted(jres[rid].timing)
        assert _phase_sum(timing) <= timing["e2e_s"]
        assert timing["ttft_s"] == res[rid].ttft_s
        assert timing["tokens"] == len(res[rid].tokens)
        assert timing["attempts"] == 1
        trace = eng.request_trace(rid)
        assert trace["timing"] == timing
        phases = [e["phase"] for e in trace["attempts"][0]["events"]]
        jphases = [e["phase"] for e in
                   jeng.request_trace(rid)["attempts"][0]["events"]]
        assert phases == jphases
        assert phases[0] == "queue_wait"
        assert "first_token" in phases and "terminal" in phases
    assert set(eng.histograms) == set(jeng.histograms) - JAX_ONLY
    assert all(jeng.histograms[k].count == 0 for k in JAX_ONLY)
    for name, hist in eng.histograms.items():
        assert tracer.histogram(name) is hist
    assert _hist_counts(eng) == _hist_counts(jeng)
    itl = sum(len(res[r].tokens) - 1 for r in ids)
    assert eng.histograms["serving_itl_s"].count == itl
    assert _span_view(tracer) == _span_view(jtr)
    assert any(v[0] == "serving.prefix_fetch" for v in _span_view(tracer))
    counters = tracer.latest_counters()
    jcounters = jtr.latest_counters()
    assert set(counters) == set(jcounters)
    for key in ("serving_admitted", "serving_evicted",
                "serving_tokens_generated", "serving_prefill_tokens",
                "serving_prefill_tokens_skipped", "serving_prefix_hits",
                "serving_chunks_scheduled"):
        assert counters[key] == jcounters[key], key


def test_record_timing_off_is_invisible_and_bit_identical(zip_path):
    """Observability off against on (with a tracer): the same greedy
    and sampled ids (the generator draws the same), no clock, no record,
    no histogram, and the same graphs; a second workload on the
    observed engine captures nothing new."""
    net = _net(PORT, zip_path)
    on = TEngine(net, n_slots=2, decode_chunk=3, seed=0, fused_rounds=2,
                 tracer=ttracer.Tracer())
    off = TEngine(_net(PORT, zip_path), n_slots=2, decode_chunk=3,
                  seed=0, fused_rounds=2, record_timing=False,
                  flight_recorder=0)
    results = []
    for eng in (on, off):
        ids = [eng.submit(TRequest(list(p), n,
                                   temperature=0.8 if i % 2 else 0.0))
               for i, (p, n) in enumerate(zip(PROMPTS, LENS))]
        res = eng.run()
        results.append([list(res[i].tokens) for i in ids])
        assert (res[ids[0]].timing is None) == (eng is off)
    assert results[0] == results[1]
    assert off.request_trace(0) is None
    assert off._clocks == {} and off.histograms == {}
    assert on.compile_counts() == off.compile_counts()
    assert on.compile_counts()["decode"] == 1
    captures = on._graphs.captures
    on.submit(TRequest([2, 5, 8, 1], 5))
    on.run()
    assert on._graphs.captures == captures


@pytest.mark.parametrize("case", ["ring", "retry_attempts", "restored"])
def test_flight_recorder_matches_jax(zip_path, case):
    """The ring keeps the last N terminal traces; an admission failure's
    retry is a second attempt with a requeue event; a restored request's
    timeline starts ``restored``: the same in both packages."""
    out = {}
    for pkg in (JAX, PORT):
        net = _net(pkg, zip_path)
        if case == "ring":
            eng = pkg.Engine(net, n_slots=2, decode_chunk=3, seed=0,
                             flight_recorder=3)
            ids = [eng.submit(pkg.Request([1 + i % 4, 4, 7], 4))
                   for i in range(6)]
            eng.run()
            out[pkg.name] = [r for r in ids if eng.request_trace(r)]
            assert out[pkg.name] == ids[-3:]
        elif case == "retry_attempts":
            eng = pkg.Engine(net, n_slots=1, decode_chunk=3, seed=0,
                             paranoid=True, max_retries=2,
                             fault_plan=pkg.Plan([pkg.Event(
                                 0, "admit_fail")]))
            rid = eng.submit(pkg.Request([1, 4, 7, 2], 5))
            res = eng.run()
            trace = eng.request_trace(rid)
            assert res[rid].retries == 1
            assert trace["timing"]["attempts"] == 2
            assert _phase_sum(trace["timing"]) <= trace["timing"]["e2e_s"]
            out[pkg.name] = [[e["phase"] for e in a["events"]]
                             for a in trace["attempts"]]
            assert "requeue" in out[pkg.name][0]
        else:
            eng = pkg.Engine(net, n_slots=2, decode_chunk=2, seed=0)
            ids = [eng.submit(pkg.Request(list(p), 9))
                   for p in PROMPTS[:4]]
            eng.step()
            snap = json.loads(json.dumps(eng.snapshot()))
            eng2 = pkg.Engine.restore(_net(pkg, zip_path), snap)
            res = eng2.run()
            out[pkg.name] = []
            for rid in ids:
                timing = res[rid].timing
                assert _phase_sum(timing) <= timing["e2e_s"]
                events = eng2.request_trace(rid)["attempts"][0]["events"]
                assert events[0]["phase"] == "restored"
                out[pkg.name].append([e["phase"] for e in events])
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("kind", ["deadline", "shed"])
@pytest.mark.parametrize("pkg_name", ["jax", "port"])
def test_failure_events_mirror_to_tracer(zip_path, pkg_name, kind):
    """Twins of JAX's ``test_deadline_mirrors_to_tracer`` and
    ``test_shed_mirrors_to_tracer``: each failure event is a cumulative
    ``serving_<key>`` track."""
    pkg = PKGS[pkg_name]
    tracer = pkg.tracer.Tracer()
    if kind == "deadline":
        clock = pkg.Clock()
        eng = pkg.Engine(_net(pkg, zip_path), n_slots=1, decode_chunk=2,
                         tracer=tracer, clock=clock)
        eng.submit(pkg.Request([1, 2, 3], 6))
        eng.submit(pkg.Request([4, 5], 6, deadline_s=0.5))
        res = eng.step()
        clock.advance(1.0)
        while eng.has_work():
            eng.step(res)
        assert tracer.latest_counters()["serving_deadline_expired"] == 1.0
        assert eng.stats["deadline_expired"] == 1
    else:
        eng = pkg.Engine(_net(pkg, zip_path), n_slots=1, decode_chunk=2,
                         max_queue=1, tracer=tracer)
        eng.submit(pkg.Request([1, 2], 3))
        eng.submit(pkg.Request([3, 4], 3))
        assert tracer.latest_counters()["serving_shed"] == 1.0


@pytest.mark.parametrize("source", ["port", "jax"])
def test_snapshot_round_trips_observability_knobs(zip_path, source):
    """``record_timing`` and ``flight_recorder`` ride the snapshot both
    ways: a port snapshot restores in JAX with them, a JAX one in the
    port; ``restore(tracer=)`` attaches the tracer."""
    src, dst = (PORT, JAX) if source == "port" else (JAX, PORT)
    eng = src.Engine(_net(src, zip_path), n_slots=1, decode_chunk=2,
                     record_timing=False, flight_recorder=7)
    eng.submit(src.Request([1, 4, 7], 3))
    snap = json.loads(json.dumps(eng.snapshot()))
    assert snap["config"]["record_timing"] is False
    assert snap["config"]["flight_recorder"] == 7
    tracer = dst.tracer.Tracer()
    back = dst.Engine.restore(_net(dst, zip_path), snap, tracer=tracer)
    assert back.record_timing is False and back.flight_recorder == 7
    assert back.tracer is tracer
    res = back.run()
    assert [r.timing for r in res.values()] == [None]


def test_observability_refusals_and_validation(zip_path):
    """The refused knob is tensor parallelism only; a negative ring is
    refused as in JAX; the engine owns JAX's histograms less that of
    the refused feature."""
    assert set(engine_module._UNPORTED) == {"tp"}
    with pytest.raises(ValueError, match="flight_recorder"):
        TEngine(_net(PORT, zip_path), flight_recorder=-1)
    assert set(engine_module.ENGINE_HISTOGRAMS) == set(
        JEngine(_net(JAX, zip_path), n_slots=1).histograms) - JAX_ONLY


# -- the tracer ------------------------------------------------------------
def _feed(mod):
    """One sequence of tracer calls (JAX's TestTracerTracks and the
    engine's and gateway's uses): returns the tracer."""
    t = mod.Tracer(max_events=8)
    with t.span("real_work", rid=3):
        pass
    assert t.incr("serving_shed") == 1.0
    assert t.incr("serving_shed", 2.0) == 3.0
    for _ in range(100):
        t.gauge("scrape_gauge", 1.0)
    t.counter("serving_admitted", 3)
    t.describe("serving_admitted", "requests admitted\ninto slots")
    t.gauge('serving_blocks_free{shard="0"}', 12)
    t.gauge('serving_blocks_free{shard="1"}', 11)
    t.rate("serving_tokens_per_sec", 64, 0.5)
    t.counter("slot_occupancy", 0.75)
    for v in (0.25, 0.001, 3.0, 250.0):
        t.observe("serving_e2e_s", v)
    t.describe("serving_e2e_s", "end to end")
    h = mod.Histogram(bounds=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 20.0):
        h.observe(v)
    t.register_histogram('serving_ttft_s{tenant="a"}', h)
    t.register_histogram("serving_ttft_s", mod.Histogram(
        bounds=(0.1, 1.0, 10.0)))
    t.instant("serving.request_done", rid=3, reason="length")
    return t


TRACER_CASES = ("prometheus", "parse", "merge", "events", "gauge_no_events",
                "clear", "histogram")


@pytest.mark.parametrize("case", TRACER_CASES)
def test_tracer_matches_jax(case):
    """The same calls into both packages' tracers: byte-identical
    exposition text, the same parsed structure and federation, the same
    event window (less timestamps and thread ids), the scrape gauge
    pushing no event, and ``clear`` keeping descriptions."""
    jt, tt = _feed(jtracer), _feed(ttracer)
    if case == "prometheus":
        assert tt.prometheus_text() == jt.prometheus_text()
        assert (tt.prometheus_text(prefix="serving_")
                == jt.prometheus_text(prefix="serving_"))
        assert ("# HELP serving_admitted requests admitted into slots"
                in tt.prometheus_text())
    elif case == "parse":
        text = tt.prometheus_text()
        assert (ttracer.parse_exposition(text)
                == jtracer.parse_exposition(text))
        parsed = ttracer.parse_exposition(text)
        assert parsed["types"]["serving_shed"] == "counter"
        assert set(parsed["histograms"]["serving_ttft_s"]["labeled"]) == {
            'tenant="a"'}
    elif case == "merge":
        sources = {"r0": tt.prometheus_text(),
                   "r1": jt.prometheus_text()}
        assert (ttracer.Tracer.merge_prometheus(sources)
                == jtracer.Tracer.merge_prometheus(sources))
    elif case == "events":
        def view(t):
            return [{k: v for k, v in e.items()
                     if k not in ("ts", "dur", "pid", "tid")}
                    for e in t.events()]

        assert view(tt) == view(jt)
        events, nxt = tt.events_since(0)
        jevents, jnxt = jt.events_since(0)
        assert nxt == jnxt and len(events) == len(jevents)
        assert (tt.counter_values("serving_admitted")
                == jt.counter_values("serving_admitted"))
    elif case == "gauge_no_events":
        assert tt.latest_counters() == jt.latest_counters()
        assert tt.prometheus_text().count("scrape_gauge") == 2
        n = len(tt.events())
        tt.observe("serving_e2e_s", 0.5)
        tt.gauge("scrape_gauge", 2.0)
        assert len(tt.events()) == n
    elif case == "clear":
        for t in (tt, jt):
            t.clear()
            assert t.histogram("serving_e2e_s") is None
            t.observe("serving_e2e_s", 0.1)
        assert "# HELP serving_e2e_s" in tt.prometheus_text()
        assert tt.prometheus_text() == jt.prometheus_text()
    else:
        # JAX's TestHistogram inputs: bounds, n-weighted observations,
        # quantiles, exposition and merge the same in both packages
        values = np.exp(np.random.default_rng(3).uniform(
            np.log(1e-3), np.log(1.0), 1000))
        hists = []
        for mod in (ttracer, jtracer):
            edge = mod.Histogram(bounds=(1.0, 2.0, 4.0))
            for v in (1.0, 2.0, 4.0, 0.5, 3.0, 5.0):
                edge.observe(v)
            h = mod.Histogram()
            for v in values:
                h.observe(float(v))
            h.observe(0.02, n=5)
            h.merge(mod.Histogram().merge(h))
            hists.append((edge.snapshot(), h.snapshot(),
                          [h.quantile(q) for q in (0, 0.1, 0.5, 0.99, 1)],
                          h.prometheus_lines("serving_ttft_s",
                                             help_text="ttft",
                                             labels='tenant="a"')))
            for bad in ((), (1.0, 1.0), (2.0, 1.0)):
                with pytest.raises(ValueError):
                    mod.Histogram(bounds=bad)
        assert hists[0] == hists[1]
        assert hists[0][0][0] == [2, 1, 2, 1]


def test_listener_and_device_trace(tmp_path):
    """``ProfilerIterationListener`` feeds iteration spans and the score
    counter; ``device_trace`` writes a Chrome trace of the block."""
    t = ttracer.Tracer()
    listener = ttracer.ProfilerIterationListener(t)
    model = types.SimpleNamespace(score_value=0.5)
    listener.iteration_done(model, 0)
    listener.iteration_done(model, 1)
    assert len(t.spans("iteration")) == 1
    assert t.counter_values("score") == [0.5, 0.5]
    with ttracer.device_trace(str(tmp_path)):
        torch.ones(4).sum()
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert len(t.events()) == 3
    t.save(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        assert len(json.load(f)["traceEvents"]) == 3
