"""Fault handling in the PyTorch port's ``DecodeEngine`` against the JAX
package: deadlines, cancellation, load shedding, fault plans with the
paranoid quarantine, and snapshot/restore.

One JAX-written model zip (JAX's fault-test net,
``transformer_lm(n_in=12, width=32, n_layers=2, n_heads=4)``, a 64-token
window) is loaded into both packages. The cases of
``tests/test_serving_faults.py`` (all but its two tracer assertions),
``TestSpecLifecycle`` (its first three) and ``TestSpecSnapshotRestore``
of ``tests/test_serving_spec.py`` and the paged snapshot cases of
``tests/test_serving_paged.py`` run as scenarios: each drives the same
requests, ``FaultPlan`` (rounds counted from the scenario's first round)
and ``ManualClock`` advances through a JAX engine and a port engine, and
at float32 greedy every request's finish reason, tokens, retries and
prefix reuse, the plan's injected events, the failure counters'
increments and the snapshot taken (less its clock readings and RNG)
must be identical. A JAX engine compiles for seconds, so the scenarios
of one engine configuration share one engine per package (a group),
run in the same order on both; each scenario is its own test, and
each also asserts what the JAX test it mirrors asserts.

The port's engines run under ``replaying_runner``'s stand-in capture
(a replay reruns the body on the graph's static inputs), so a fault
that rebound a pool tensor instead of writing it would never reach the
replayed round, and ``compile_counts()`` counts the graphs a card run
would capture (``decode`` and ``health_check`` 1).

Snapshots cross the packages both ways: each JAX snapshot restores in
the port and each port snapshot in the port, finishing with the ids of
the JAX engine that went on running; two port snapshots restore in the
JAX package. Port-only: ``poison_rows`` writes in place, a cancel
between an async round's dispatch and its landing, two restores of one
snapshot with sampled requests, the default knobs adding no graph and
no host sync, the knobs still refused, and the snapshot's RNG words."""

import contextlib
import json
import types

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.serving import FaultEvent as JEvent
from deeplearning4j_tpu.serving import FaultPlan as JPlan
from deeplearning4j_tpu.serving import ManualClock as JClock
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import Scheduler as JScheduler
from deeplearning4j_tpu.util.model_serializer import (
    restore_model as j_restore_model,
)
from deeplearning4j_tpu.util.model_serializer import write_model

from deeplearning4j_tpu_torch.nn import cuda_graphs
from deeplearning4j_tpu_torch.nn.streaming import tree_map
from deeplearning4j_tpu_torch.serving import DecodeEngine as TEngine
from deeplearning4j_tpu_torch.serving import FaultEvent, FaultPlan
from deeplearning4j_tpu_torch.serving import ManualClock
from deeplearning4j_tpu_torch.serving import Request as TRequest
from deeplearning4j_tpu_torch.serving import Scheduler as TScheduler
from deeplearning4j_tpu_torch.serving import engine as engine_module
from deeplearning4j_tpu_torch.serving.faults import poison_rows
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

V, WINDOW = 12, 64
FAILURE_KEYS = TEngine.FAILURE_KEYS
SHARED = [1, 4, 7, 2, 5, 3]
CHAOS_CASES = ([([1, 4, 7, 2, 5] + [i % V], 8) for i in range(4)]
               + [([9, 3, 3], 12), ([5, 2, 8, 1, 6, 0, 4], 6),
                  ([2, 2], 10), ([11, 0, 6], 7)])
CHAOS_PLAN = [(2, "nan", {"slot": 0}), (3, "admit_fail", {}),
              (4, "cache_corrupt", {}), (6, "nan", {"slot": 1})]
MID_RUN_CASES = [([1, 4, 7, 2], 9), ([9, 3, 3], 13),
                 ([5, 2, 8, 1, 6, 0, 4], 6), ([2, 2], 11), ([11, 0, 6], 7)]
PAGED_SHARED = [1, 4, 7, 2, 5, 9, 3, 3]
PAGED_CASES = [(PAGED_SHARED + [1, 6], 8), (PAGED_SHARED + [2, 0], 5),
               ([9, 3, 3], 11), (PAGED_SHARED + [4, 8], 7), ([2, 2], 9)]
SPEC_CASES = [([1, 2, 3, 1, 2, 3, 1], 20), ([5, 2, 5, 2, 5], 24),
              ([9, 3, 3], 16), ([2, 2], 18), ([1, 4, 7, 2], 15)]
PAGED = dict(paged_kv=True, block_tokens=8)
CHUNKED = dict(n_slots=2, decode_chunk=2, prefix_cache_rows=4,
               prefill_chunk=4, admission_policy="decode", paranoid=True,
               max_retries=3)

JAX = types.SimpleNamespace(name="jax", Engine=JEngine, Request=JRequest,
                            Plan=JPlan, Event=JEvent, Clock=JClock)
PORT = types.SimpleNamespace(name="port", Engine=TEngine, Request=TRequest,
                             Plan=FaultPlan, Event=FaultEvent,
                             Clock=ManualClock)

_CACHE = {}


def _cached(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    conf = jzoo.transformer_lm(n_in=V, width=32, n_layers=2, n_heads=4,
                               n_classes=V, seed=7)
    for c in conf.confs:
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    path = str(tmp_path_factory.mktemp("faults") / "lm.zip")
    write_model(JNet(conf).init(), path)
    return path


def _net(pkg, zip_path):
    if pkg is JAX:
        return _cached(("jnet", zip_path),
                       lambda: j_restore_model(zip_path))
    return restore_model(zip_path, device="cpu")


def _capture(self, body, inputs, key):
    """``GraphRunner._capture``'s stand-in: the body runs once on copies
    of the inputs (the generators' states put back), and a replay reruns
    it on the static inputs, writing into the captured outputs."""
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


@contextlib.contextmanager
def _replaying():
    """CPU tensors treated as card tensors by ``GraphRunner``, captured
    by :func:`_capture` (as ``tests/test_torch_port_spec.py``'s
    ``replaying_runner`` fixture, for a whole group's run)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_graphs, "_on_card", lambda leaves: True)
        mp.setattr(cuda_graphs.GraphRunner, "_capture", _capture)
        yield


@pytest.fixture
def replaying_runner():
    with _replaying():
        yield


# -- scenarios -----------------------------------------------------------
class _Ctx:
    """One package's engine in a group, as a scenario sees it."""

    def __init__(self, pkg, eng, clock):
        self.pkg, self.eng, self.clock = pkg, eng, clock
        self.plan = None

    def req(self, prompt, n, **kw):
        return self.eng.submit(self.pkg.Request(list(prompt), n, **kw))

    def set_plan(self, events):
        """A fault plan with rounds counted from the current round."""
        base = self.eng._round
        self.plan = self.pkg.Plan([self.pkg.Event(base + r, kind, **kw)
                                   for r, kind, kw in events])
        self.eng.fault_plan = self.plan

    def drain(self, res):
        while self.eng.has_work():
            self.eng.step(res)
        return res


def _results(res, ids):
    return [res[i] for i in ids]


def sc_queued_deadline(c):
    a = c.req([1, 2, 3], 12)
    b = c.req([4, 5], 8, deadline_s=1.0)
    res = c.eng.step()
    c.clock.advance(2.0)
    c.drain(res)
    return {"a": res[a], "b": res[b]}


def sc_queue_timeout_sheds(c):
    a = c.req([1, 2, 3], 12)
    b = c.req([4, 5], 8, queue_timeout_s=0.5)
    res = c.eng.step()
    c.clock.advance(1.0)
    c.drain(res)
    return {"a": res[a], "b": res[b]}


def sc_cancel_queued(c):
    a = c.req([1, 2, 3], 10)
    b = c.req([4, 5], 10)
    ok = c.eng.cancel(b)
    res = c.eng.run()
    return {"ok": ok, "a": res[a], "b": res[b]}


def sc_cancel_unknown_or_finished(c):
    rid = c.req([1, 2], 3)
    res = c.eng.run()
    return {"r": res[rid], "finished": c.eng.cancel(rid),
            "unknown": c.eng.cancel(999)}


def sc_cancel_while_idle(c):
    rid = c.req([1, 2], 3)
    ok = c.eng.cancel(rid)
    return {"ok": ok, "r": c.eng.run()[rid]}


def sc_admit_fail_backoff(c):
    c.set_plan([(0, "admit_fail", {})])
    rid = c.req([1, 2, 3], 5)
    return {"r": c.eng.run()[rid]}


def sc_capped_retries(c):
    c.set_plan([(r, "admit_fail", {}) for r in range(8)])
    rid = c.req([1, 2, 3], 5)
    return {"r": c.eng.run()[rid]}


def sc_queue_timeout_exempts_retries(c):
    c.set_plan([(0, "admit_fail", {})])
    rid = c.req([1, 2, 3], 5, queue_timeout_s=0.5)
    res = c.eng.step()
    c.clock.advance(2.0)
    return {"r": c.drain(res)[rid]}


def sc_unconsumed_admit_fail(c):
    c.set_plan([(0, "admit_fail", {})])
    c.eng.step()
    rid = c.req([1, 2, 3], 5)
    return {"r": c.eng.run()[rid]}


def sc_stall_slow_step(c):
    c.set_plan([(1, "stall", {"seconds": 2.0})])
    rid = c.req([1, 2, 3], 8)
    return {"r": c.eng.run()[rid]}


def sc_restore_issues_fresh_ids(c):
    a = c.req([1, 2, 3], 4)
    snap = c.eng.snapshot()
    return {"snapshot": snap, "a": c.eng.run()[a]}


def sc_restored_slot_keeps_duplicate_guard(c):
    a = c.req([1, 2, 3], 10)
    res = c.eng.step()
    snap = c.eng.snapshot()
    return {"snapshot": snap, "a": c.drain(res)[a]}


def sc_restore_keeps_elapsed_deadline(c):
    a = c.req([1, 2, 3], 30)
    doomed = c.req([4, 5], 30, deadline_s=10.0)
    res = c.eng.step()
    c.clock.advance(8.0)
    snap = c.eng.snapshot()
    c.clock.advance(3.0)
    c.drain(res)
    return {"snapshot": snap, "a": res[a], "doomed": res[doomed],
            "elapsed": snap["queue"][0]["elapsed_s"]}


def sc_running_deadline_partial(c):
    doomed = c.req([1, 2, 3], 40, deadline_s=5.0)
    healthy = c.req([9, 3, 3], 11)
    res = c.eng.step()
    c.clock.advance(10.0)
    c.drain(res)
    return {"doomed": res[doomed], "healthy": res[healthy]}


def sc_cancel_running_partial(c):
    a = c.req([1, 2, 3], 40)
    b = c.req([9, 3, 3], 11)
    res = c.eng.step()
    ok = c.eng.cancel(a)
    c.drain(res)
    return {"ok": ok, "a": res[a], "b": res[b]}


def sc_nan_quarantined(c):
    c.set_plan([(1, "nan", {"slot": 0})])
    victim = c.req([1, 2, 3], 9)
    healthy = c.req([9, 3, 3], 9)
    res = c.eng.run()
    return {"victim": res[victim], "healthy": res[healthy]}


def sc_idle_snapshot(c):
    a = c.req([1, 2, 3], 6)
    b = c.req([9, 3, 3], 4)
    snap = c.eng.snapshot()
    res = c.eng.run()
    return {"snapshot": snap, "a": res[a], "b": res[b]}


def sc_dense_snapshot_is_dense(c):
    return {"snapshot": c.eng.snapshot()}


def sc_plain(c):
    ids = [c.req(p, n) for p, n in MID_RUN_CASES]
    return {"res": _results(c.eng.run(), ids)}


def sc_undetected_without_paranoid(c):
    c.set_plan([(1, "nan", {"slot": 0})])
    victim = c.req([1, 2, 3], 9)
    healthy = c.req([9, 3, 3], 9)
    res = c.eng.run()
    # the victim's tokens are argmax over NaN: not compared
    return {"victim_reason": res[victim].finish_reason,
            "victim_retries": res[victim].retries,
            "healthy": res[healthy]}


def sc_reject_new(c):
    ids = [c.req([i + 1, i + 2], 4) for i in range(2)]
    shed = c.req([7, 8], 4)
    res = c.eng.run()
    return {"res": _results(res, ids), "shed": res[shed]}


def sc_shed_oldest(c):
    # JAX's shed-oldest engine: a queue of one
    c.eng.scheduler.max_queue = 1
    c.eng.shed_policy = "shed-oldest"
    a = c.req([1, 2], 6)
    b = c.req([3, 4], 6)
    cc = c.req([5, 6], 6)
    res = c.eng.run()
    return {"a": res[a], "b": res[b], "c": res[cc]}


def _corrupt_and_admit(c, victim_tokens):
    warm = c.req(SHARED + [8, 9], 4)
    warm_res = c.eng.run()[warm]
    inval0 = c.eng.prefix_cache.stats["invalidations"]
    row = c.eng.prefix_cache.stored_rows()[0]
    c.set_plan([(0, "cache_corrupt", {"row": row})])
    victim = c.req(SHARED + [10, 11], victim_tokens)
    res = c.eng.run()
    return {"warm": warm_res, "victim": res[victim],
            "invalidated": c.eng.prefix_cache.stats["invalidations"]
            - inval0}


def sc_cache_corruption(c):
    return _corrupt_and_admit(c, 6)


def sc_fault_at_admission(c):
    c.eng.prefix_cache.clear()      # JAX's test starts on an empty trie
    out = _corrupt_and_admit(c, 1)
    out["health_graphs"] = c.eng.compile_counts()["health_check"]
    return out


def _chaos(c, cases, json_roundtrip=False):
    c.set_plan(CHAOS_PLAN)
    ids = [c.req(p, n) for p, n in cases]
    res = {}
    for _ in range(8):
        c.eng.step(res)
    snap = c.eng.snapshot()
    if json_roundtrip:
        snap = json.loads(json.dumps(snap))
    c.drain(res)
    return {"snapshot": snap, "res": _results(res, ids)}


def sc_chaos(c):
    return _chaos(c, CHAOS_CASES)


def sc_mid_run_snapshot(c):
    ids = [c.req(p, n) for p, n in MID_RUN_CASES]
    res = {}
    for _ in range(3):
        c.eng.step(res)
    live = c.eng.has_work()
    snap = c.eng.snapshot()
    return {"live": live, "snapshot": snap,
            "res": _results(c.drain(res), ids)}


def sc_cancel_pending_admission(c):
    a = c.req(list(range(12)), 6)
    res = c.eng.step()
    pending = bool(c.eng._pending) and c.eng._pending[0].request.id == a
    ok = c.eng.cancel(a)
    reserved = sorted(c.eng._reserved)
    b = c.req([4, 5], 5)
    c.drain(res)
    return {"pending": pending, "ok": ok, "reserved": reserved,
            "a": res[a], "b": res[b]}


def sc_snapshot_is_plain_json(c):
    a = c.req([1, 2, 3], 8, deadline_s=30.0)
    res = c.eng.step()
    snap = c.eng.snapshot()
    json.dumps(snap)
    return {"snapshot": snap, "a": c.drain(res)[a]}


def sc_paged_snapshot_tables(c):
    ids = [c.req(p, n) for p, n in PAGED_CASES]
    res = {}
    for _ in range(4):
        c.eng.step(res)
    snap = c.eng.snapshot()
    return {"snapshot": snap, "res": _results(c.drain(res), ids)}


def sc_spec_cancel_drops_drafts(c):
    a = c.req([1, 2, 3, 1, 2, 3, 1], 40)
    b = c.req([5, 2, 5, 2], 11)
    res = c.eng.step()
    tables = len(c.eng.spec.slots())
    ok = c.eng.cancel(a)
    after = len(c.eng.spec.slots())
    c.drain(res)
    return {"tables": tables, "ok": ok, "after": after, "a": res[a],
            "b": res[b], "final": list(c.eng.spec.slots())}


def sc_spec_quarantine_drops_drafts(c):
    c.set_plan([(1, "nan", {"slot": 0})])
    victim = c.req([1, 2, 3, 1, 2, 3, 1], 9)
    healthy = c.req([5, 2, 5, 2], 9)
    res = c.eng.run()
    return {"victim": res[victim], "healthy": res[healthy],
            "final": list(c.eng.spec.slots())}


def sc_spec_deadline_partial(c):
    doomed = c.req([1, 2, 3, 1, 2, 3, 1], 40, deadline_s=5.0)
    res = c.eng.step()
    c.clock.advance(10.0)
    c.drain(res)
    return {"doomed": res[doomed], "final": list(c.eng.spec.slots())}


def sc_spec_chaos(c):
    return _chaos(c, SPEC_CASES, json_roundtrip=True)


def sc_spec_mid_run(c):
    ids = [c.req(p, n) for p, n in SPEC_CASES]
    res = {}
    for _ in range(3):
        c.eng.step(res)
    snap = json.loads(json.dumps(c.eng.snapshot()))
    return {"snapshot": snap, "res": _results(c.drain(res), ids)}


def sc_spec_round_trip(c):
    c.eng.scheduler.draft_len = 2
    a = c.req([1, 2, 3, 1, 2, 3, 1], 9)
    res = {}
    while not any(s is not None for s in c.eng._slots):
        c.eng.step(res)
    snap = json.loads(json.dumps(c.eng.snapshot()))
    return {"snapshot": snap, "a": c.drain(res)[a]}


def sc_adaptive_budget(c):
    budgets = []
    adapt = c.eng.scheduler.adapt_budget

    def recorded():
        budgets.append(adapt())
        return budgets[-1]

    c.eng.scheduler.adapt_budget = recorded
    ids = [c.req(list(range(1, 9)), 3) for _ in range(8)]
    return {"budgets": budgets, "res": _results(c.eng.run(), ids)}


#: engine configurations, each with the scenarios that share its engine
#: (run in this order on both packages)
GROUPS = {
    "solo": (dict(n_slots=1, decode_chunk=2, paranoid=True,
                  max_retries=1, retry_backoff_rounds=2,
                  stall_threshold_s=0.5), True,
             [sc_queued_deadline, sc_queue_timeout_sheds, sc_cancel_queued,
              sc_cancel_unknown_or_finished, sc_cancel_while_idle,
              sc_admit_fail_backoff, sc_capped_retries,
              sc_queue_timeout_exempts_retries, sc_unconsumed_admit_fail,
              sc_stall_slow_step, sc_restore_issues_fresh_ids,
              sc_restored_slot_keeps_duplicate_guard,
              sc_restore_keeps_elapsed_deadline]),
    "pairs": (dict(n_slots=2, decode_chunk=2, paranoid=True), True,
              [sc_running_deadline_partial, sc_cancel_running_partial,
               sc_nan_quarantined, sc_idle_snapshot,
               sc_dense_snapshot_is_dense]),
    "default": (dict(n_slots=2, decode_chunk=2), False,
                [sc_plain, sc_undetected_without_paranoid]),
    "shed": (dict(n_slots=1, decode_chunk=2, max_queue=2), False,
             [sc_reject_new, sc_shed_oldest]),
    "cache": (dict(n_slots=2, decode_chunk=2, prefix_cache_rows=4,
                   paranoid=True), False,
              [sc_cache_corruption, sc_fault_at_admission]),
    "chunked": (dict(CHUNKED), False,
                [sc_chaos, sc_mid_run_snapshot, sc_cancel_pending_admission,
                 sc_snapshot_is_plain_json]),
    "paged": (dict(CHUNKED, **PAGED), False,
              [sc_chaos, sc_paged_snapshot_tables]),
    "spec_life": (dict(n_slots=2, decode_chunk=2, seed=0,
                       spec_draft_len=4, paranoid=True), True,
                  [sc_spec_cancel_drops_drafts,
                   sc_spec_quarantine_drops_drafts,
                   sc_spec_deadline_partial]),
    "spec_snap": (dict(CHUNKED, seed=0, spec_draft_len=4), False,
                  [sc_spec_chaos, sc_spec_mid_run, sc_spec_round_trip]),
    "adaptive": (dict(n_slots=2, decode_chunk=2, prefix_cache_rows=2,
                      prefill_chunk=4, prefill_budget=16,
                      adaptive_prefill=True, pressure_high=30,
                      pressure_low=5), False, [sc_adaptive_budget]),
}
CASES = [(g, f.__name__[3:]) for g, (_, _, fs) in GROUPS.items()
         for f in fs]


def _build(pkg, zip_path, group, **extra):
    kw, clocked, _ = GROUPS[group]
    clock = pkg.Clock() if clocked else None
    eng = pkg.Engine(_net(pkg, zip_path), clock=clock, **dict(kw, **extra))
    return eng, clock


def _run_group(pkg, zip_path, group):
    """Every scenario of ``group`` in order on one engine of ``pkg``:
    {scenario: {"out", "stats" (failure-counter increments),
    "injected"}} and the engine's ``compile_counts()`` under
    ``"_counts"``."""
    eng, clock = _build(pkg, zip_path, group)
    records = {}
    for fn in GROUPS[group][2]:
        before = {k: eng.stats[k] for k in FAILURE_KEYS}
        ctx = _Ctx(pkg, eng, clock)
        out = fn(ctx)
        records[fn.__name__[3:]] = {
            "out": out,
            "stats": {k: eng.stats[k] - before[k] for k in FAILURE_KEYS},
            "injected": ([(e.round, e.kind, e.slot, e.row, e.seconds)
                          for e in ctx.plan.injected]
                         if ctx.plan is not None else [])}
        eng.fault_plan = None
    records["_counts"] = eng.compile_counts()
    return records


def _group(pkg, zip_path, group):
    def make():
        if pkg is PORT:
            with _replaying():
                return _run_group(pkg, zip_path, group)
        return _run_group(pkg, zip_path, group)

    return _cached((pkg.name, group), make)


def _res(r):
    return (r.finish_reason, list(r.tokens), r.retries,
            r.prefix_tokens_reused, r.spec_drafted, r.spec_accepted)


def _snap_view(snap):
    """A snapshot less what the packages read differently: the clock
    (``elapsed_s``), the RNG and the terminals' timings."""
    def strip(entry):
        return {k: v for k, v in entry.items() if k != "elapsed_s"}

    view = {k: v for k, v in snap.items()
            if k not in ("rng_key", "torch_rng_state")}
    view["slots"] = [None if s is None else strip(s) for s in snap["slots"]]
    for key in ("pending", "queue", "requeue"):
        view[key] = [strip(e) for e in snap[key]]
    view["terminal"] = [(t["id"], t["tokens"], t["finish_reason"],
                         t["retries"]) for t in snap["terminal"]]
    return view


def _norm(x):
    if hasattr(x, "finish_reason"):
        return _res(x)
    if isinstance(x, dict) and "version" in x and "config" in x:
        return _snap_view(x)
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _ok(r):
    return r.finish_reason in ("length", "eos")


def _expect(name, rec):
    """What the JAX test this scenario mirrors asserts, on the port's
    record."""
    o, st = rec["out"], rec["stats"]
    if name == "queued_deadline":
        assert o["b"].finish_reason == "deadline" and o["b"].tokens == []
        assert o["a"].finish_reason == "length"
    elif name == "queue_timeout_sheds":
        assert o["b"].finish_reason == "shed" and st["queue_timeouts"] == 1
    elif name == "cancel_queued":
        assert o["ok"] and o["b"].finish_reason == "cancelled"
        assert o["b"].tokens == []
    elif name == "cancel_unknown_or_finished":
        assert not o["finished"] and not o["unknown"]
    elif name == "cancel_while_idle":
        assert o["r"].finish_reason == "cancelled"
    elif name == "admit_fail_backoff":
        assert st["retries"] == 1 and o["r"].retries == 1 and _ok(o["r"])
    elif name == "capped_retries":
        assert o["r"].finish_reason == "fault" and o["r"].tokens == []
        assert o["r"].retries == 1 and st["retry_failures"] == 1
    elif name == "queue_timeout_exempts_retries":
        assert _ok(o["r"]) and o["r"].retries == 1
        assert st["queue_timeouts"] == 0
    elif name == "unconsumed_admit_fail":
        assert o["r"].retries == 0 and st["retries"] == 0
    elif name == "stall_slow_step":
        assert st["slow_steps"] == 1
    elif name in ("running_deadline_partial", "spec_deadline_partial"):
        assert o["doomed"].finish_reason == "deadline"
        assert 0 < len(o["doomed"].tokens) < 40
    elif name == "cancel_running_partial":
        assert o["ok"] and o["a"].finish_reason == "cancelled"
        assert 0 < len(o["a"].tokens) < 40
    elif name in ("nan_quarantined", "spec_quarantine_drops_drafts"):
        assert st["quarantined"] == 1 and o["victim"].retries == 1
        assert _ok(o["victim"]) and o["healthy"].retries == 0
    elif name == "undetected_without_paranoid":
        assert st["quarantined"] == 0 and o["victim_retries"] == 0
    elif name == "reject_new":
        assert o["shed"].finish_reason == "shed" and st["shed"] == 1
    elif name == "shed_oldest":
        assert [o[k].finish_reason for k in "abc"] == ["shed", "shed",
                                                       "length"]
    elif name in ("cache_corruption", "fault_at_admission"):
        assert st["quarantined"] == 1 and o["invalidated"] >= 1
        assert _ok(o["victim"]) and o["victim"].retries == 1
    elif name == "cancel_pending_admission":
        assert o["pending"] and o["ok"] and o["reserved"] == []
        assert o["a"].finish_reason == "cancelled" and _ok(o["b"])
    elif name == "mid_run_snapshot":
        assert o["live"]
    elif name == "spec_cancel_drops_drafts":
        assert (o["tables"], o["after"], o["final"]) == (2, 1, [])
    elif name == "adaptive_budget":
        assert o["budgets"] and min(o["budgets"]) < 16
    if name == "fault_at_admission":
        assert o["health_graphs"] == 1
    if name.startswith("spec_") and "final" in o:
        assert o["final"] == []
    if name in ("chaos", "spec_chaos"):
        assert len(rec["injected"]) >= 3
        assert {"nan", "admit_fail"} <= {e[1] for e in rec["injected"]}
        assert any(r.retries > 0 for r in o["res"])


@pytest.mark.parametrize("group,name", CASES,
                         ids=[f"{g}-{n}" for g, n in CASES])
def test_scenario_matches_jax(zip_path, group, name):
    """Per request the same finish reason, tokens, retries and prefix
    reuse; the same injected events and failure-counter increments; the
    same snapshot (less clock and RNG) as the JAX engine; and what the
    mirrored JAX test asserts."""
    want = _group(JAX, zip_path, group)[name]
    got = _group(PORT, zip_path, group)[name]
    assert _norm(got["out"]) == _norm(want["out"])
    assert got["stats"] == want["stats"]
    assert got["injected"] == want["injected"]
    _expect(name, got)


@pytest.mark.parametrize("group", ["pairs", "cache", "chunked", "paged",
                                   "spec_life", "spec_snap"])
def test_paranoid_engines_capture_one_health_graph(zip_path, group):
    counts = _group(PORT, zip_path, group)["_counts"]
    assert counts["health_check"] == 1
    assert counts["decode"] == 1


def test_fault_free_engine_matches_the_chaos_survivors(zip_path):
    """Every chaos request the plan did not end in ``fault`` finishes
    with the ids of the port's own fault-free run, on both layouts and
    under speculation (against the spec-off engine)."""
    with _replaying():
        for group, cases, kw in (("chunked", CHAOS_CASES, {}),
                                 ("paged", CHAOS_CASES, {}),
                                 ("spec_snap", SPEC_CASES,
                                  {"spec_draft_len": 0})):
            eng, _ = _build(PORT, zip_path, group, **kw)
            ids = [eng.submit(TRequest(list(p), n)) for p, n in cases]
            res = eng.run()
            name = "spec_chaos" if group == "spec_snap" else "chaos"
            got = _group(PORT, zip_path, group)[name]["out"]["res"]
            for r, rid in zip(got, ids):
                if r.finish_reason != "fault":
                    assert r.tokens == res[rid].tokens, (group, rid)


# -- snapshots across the packages ---------------------------------------
SNAP_CASES = [("solo", "restore_issues_fresh_ids"),
              ("pairs", "idle_snapshot"), ("chunked", "chaos"),
              ("chunked", "mid_run_snapshot"),
              ("chunked", "snapshot_is_plain_json"), ("paged", "chaos"),
              ("paged", "paged_snapshot_tables"),
              ("spec_snap", "spec_chaos"), ("spec_snap", "spec_mid_run"),
              ("spec_snap", "spec_round_trip")]


def _continued(out):
    """The continued engine's results, by request id."""
    rs = out["res"] if "res" in out else [
        v for v in out.values() if hasattr(v, "finish_reason")]
    return {r.id: r for r in rs}


@pytest.mark.parametrize("source", ["jax", "port"])
@pytest.mark.parametrize("group,name", SNAP_CASES,
                         ids=[f"{g}-{n}" for g, n in SNAP_CASES])
def test_snapshot_restores_in_the_port(zip_path, group, name, source,
                                       replaying_runner):
    """A snapshot taken mid-run (by the JAX engine or the port's),
    through JSON, restored in a fresh port engine: every request
    finishes as the JAX engine that went on running finished it (fault
    victims may end ``fault`` on either side); the restored engine holds
    one decode graph and, paranoid, one health graph."""
    pkg = JAX if source == "jax" else PORT
    snap = json.loads(json.dumps(
        _group(pkg, zip_path, group)[name]["out"]["snapshot"]))
    want = _continued(_group(JAX, zip_path, group)[name]["out"])
    eng = TEngine.restore(_net(PORT, zip_path), snap)
    res = eng.run()
    assert res
    for rid, r in res.items():
        if want[rid].finish_reason == "fault":
            continue
        assert _res(r)[:3] == _res(want[rid])[:3], rid
    counts = eng.compile_counts()
    assert counts["decode"] == 1
    assert counts.get("health_check", 1) == 1
    if snap["config"]["paged_kv"]:
        # no poisoned block survives, and only the trie holds blocks
        assert eng.block_pool.poisoned == set()
        trie = {b for tab in eng.prefix_cache.tables()
                for b in tab.blocks.values()}
        assert eng.block_pool.used_blocks == len(trie)


@pytest.mark.parametrize("group,name", [("chunked", "mid_run_snapshot"),
                                        ("paged", "paged_snapshot_tables")])
def test_port_snapshot_restores_in_jax(zip_path, group, name):
    """The JAX package's ``restore`` accepts a port snapshot (the
    refused knobs at their defaults, ``rng_key`` in JAX's shape, the
    port's ``torch_rng_state`` ignored) and finishes the JAX ids."""
    snap = json.loads(json.dumps(
        _group(PORT, zip_path, group)[name]["out"]["snapshot"]))
    want = _continued(_group(JAX, zip_path, group)[name]["out"])
    res = JEngine.restore(_net(JAX, zip_path), snap).run()
    assert set(res) <= set(want) and res
    for rid, r in res.items():
        assert _res(r)[:3] == _res(want[rid])[:3], rid


def test_paged_snapshot_names_tables_and_refcounts(zip_path):
    """The paged snapshot carries the slots' block tables and the
    refcounts of the first ``kv_blocks`` blocks, never the scratch
    block, and restores paged."""
    snap = _group(PORT, zip_path, "paged")["paged_snapshot_tables"][
        "out"]["snapshot"]
    eng, _ = _build(PORT, zip_path, "paged")
    paged = snap["paged"]
    assert snap["config"]["paged_kv"] is True
    assert snap["config"]["block_tokens"] == 8
    assert paged["kv_blocks"] == eng.kv_blocks
    assert paged["tables"]
    for tab in paged["tables"].values():
        assert tab["length"] >= 1 and tab["blocks"]
        assert str(eng.kv_blocks) not in tab["blocks"].values()
    assert paged["refcounts"]
    assert all(0 <= int(b) < eng.kv_blocks for b in paged["refcounts"])
    chaos = _group(PORT, zip_path, "paged")["chaos"]["out"]["snapshot"]
    assert all(0 <= int(b) < eng.kv_blocks
               for b in chaos["paged"]["refcounts"])
    assert TEngine.restore(_net(PORT, zip_path), snap).paged_kv


def test_dense_snapshot_restores_dense(zip_path):
    snap = _group(PORT, zip_path, "pairs")["dense_snapshot_is_dense"][
        "out"]["snapshot"]
    assert snap["config"]["paged_kv"] is False and snap["paged"] is None
    assert not TEngine.restore(_net(PORT, zip_path), snap).paged_kv


@pytest.mark.parametrize("source", ["jax", "port"])
def test_restore_issues_fresh_ids(zip_path, source):
    pkg = JAX if source == "jax" else PORT
    out = _group(pkg, zip_path, "solo")["restore_issues_fresh_ids"]["out"]
    eng = TEngine.restore(_net(PORT, zip_path), out["snapshot"])
    a = out["a"].id
    b = eng.submit(TRequest([4, 5], 3))
    assert b > a
    res = eng.run()
    assert set(res) == {a, b}
    assert res[a].tokens == out["a"].tokens


@pytest.mark.parametrize("source", ["jax", "port"])
def test_restored_slot_keeps_duplicate_guard(zip_path, source):
    pkg = JAX if source == "jax" else PORT
    out = _group(pkg, zip_path, "solo")[
        "restored_slot_keeps_duplicate_guard"]["out"]
    eng = TEngine.restore(_net(PORT, zip_path), out["snapshot"])
    with pytest.raises(ValueError, match="already submitted"):
        eng.submit(TRequest([4, 5], 3, id=out["a"].id))


@pytest.mark.parametrize("source", ["jax", "port"])
def test_restore_keeps_elapsed_deadline(zip_path, source):
    """8 of 10 s spent before the snapshot stay spent: 3 more in the
    restored engine expire the deadline."""
    pkg = JAX if source == "jax" else PORT
    out = _group(pkg, zip_path, "solo")[
        "restore_keeps_elapsed_deadline"]["out"]
    assert out["elapsed"] == 8.0
    clock = ManualClock()
    eng = TEngine.restore(_net(PORT, zip_path), out["snapshot"],
                          clock=clock)
    clock.advance(3.0)
    res = eng.run()
    assert res[out["doomed"].id].finish_reason == "deadline"
    assert res[out["a"].id].tokens == out["a"].tokens


def test_spec_snapshot_round_trips_the_live_k(zip_path):
    out = _group(PORT, zip_path, "spec_snap")["spec_round_trip"]["out"]
    snap = out["snapshot"]
    assert snap["config"]["spec_draft_len"] == 4
    assert snap["spec"]["draft_len"] == 2
    eng = TEngine.restore(_net(PORT, zip_path), snap)
    assert eng.spec_draft_len == 4 and eng.scheduler.draft_len == 2
    assert eng.spec.slots()


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_two_restores_of_one_snapshot_agree(zip_path, layout,
                                            replaying_runner):
    """The generator state rides the snapshot (``torch_rng_state``), so
    two restores draw the same samples: sampled requests included, the
    ids are identical."""
    kw = dict(n_slots=2, decode_chunk=2, prefix_cache_rows=4,
              prefill_chunk=4, seed=3, **(PAGED if layout == "paged"
                                           else {}))
    eng = TEngine(_net(PORT, zip_path), **kw)
    for i, (p, n) in enumerate(MID_RUN_CASES):
        eng.submit(TRequest(list(p), n + 6,
                            temperature=1.0 if i < 2 else 0.0))
    for _ in range(3):
        eng.step()
    snap = json.loads(json.dumps(eng.snapshot()))
    runs = [TEngine.restore(_net(PORT, zip_path), snap).run()
            for _ in range(2)]
    assert {k: r.tokens for k, r in runs[0].items()} == {
        k: r.tokens for k, r in runs[1].items()}
    assert len(runs[0]) == len(MID_RUN_CASES)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 5])
def test_snapshot_rng_key_is_jax_prng_key(zip_path, seed):
    """``rng_key`` holds what ``jax.random.PRNGKey(seed)`` holds."""
    snap = TEngine(_net(PORT, zip_path), n_slots=1,
                   seed=seed).snapshot()
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    assert snap["rng_key"] == want.tolist()
    assert isinstance(snap["torch_rng_state"], list)


# -- port-only ------------------------------------------------------------
def test_poison_rows_writes_in_place():
    """NaN lands in the given rows of every floating tensor, in the same
    storage (the graphs' static inputs); integer tensors and the
    ``scratch`` index are untouched."""
    pk = torch.zeros(5, 2, 3)
    pv = torch.ones(5, 2, 3, dtype=torch.bfloat16)
    filled = torch.arange(5, dtype=torch.int32)
    pool = {"l0": {"pk": pk, "pv": pv, "filled": filled, "scratch": 4}}
    ptrs = [pk.data_ptr(), pv.data_ptr(), filled.data_ptr()]
    out = poison_rows(pool, [1, 3, 3])
    assert out is pool and out["l0"]["pk"] is pk
    assert [pk.data_ptr(), pv.data_ptr(), filled.data_ptr()] == ptrs
    for t in (pk, pv):
        bad = torch.isnan(t.float()).reshape(5, -1).all(dim=1)
        assert bad.tolist() == [False, True, False, True, False]
    assert filled.tolist() == [0, 1, 2, 3, 4]
    assert pool["l0"]["scratch"] == 4


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_cancel_between_async_dispatch_and_landing(zip_path, layout,
                                                   replaying_runner):
    """A cancel while an async round is in flight: the landing skips the
    cancelled slot's rows, the neighbours' ids are those of the run
    without the cancel, and the cancelled request returns a prefix of
    its own uncancelled ids."""
    kw = dict(n_slots=3, decode_chunk=2, async_rounds=True,
              **(PAGED if layout == "paged" else {}))
    cases = [([1, 2, 3], 14), ([9, 3, 3], 11), ([2, 2], 9)]
    ref_eng = TEngine(_net(PORT, zip_path), **kw)
    ref_ids = [ref_eng.submit(TRequest(list(p), n)) for p, n in cases]
    ref = ref_eng.run()
    eng = TEngine(_net(PORT, zip_path), **kw)
    ids = [eng.submit(TRequest(list(p), n)) for p, n in cases]
    res = eng.step()
    res = eng.step(res)
    assert eng._inflight is not None
    assert eng.cancel(ids[1])
    while eng.has_work():
        eng.step(res)
    got = res[ids[1]]
    assert got.finish_reason == "cancelled"
    n = len(got.tokens)
    assert 0 < n < 11 and got.tokens == ref[ref_ids[1]].tokens[:n]
    for i in (0, 2):
        assert res[ids[i]].tokens == ref[ref_ids[i]].tokens
    assert eng.stats["cancelled"] == 1
    if layout == "paged":
        assert eng.block_pool.used_blocks == 0


@pytest.mark.parametrize("mode", [
    {}, {"fused_rounds": 4, "async_rounds": True}, {"spec_draft_len": 4}],
    ids=["stepped", "fused_async", "spec"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_default_knobs_add_no_graph_and_no_sync(zip_path, layout, mode,
                                                monkeypatch,
                                                replaying_runner):
    """Every fault knob at its default: no health check runs, one round
    event per dispatched round (the round's one host sync), no failure
    counted, ``compile_counts()`` holds the keys it held before the
    failure layer, and the ids equal a paranoid engine's with an empty
    fault plan and a clock."""
    def no_health(self):
        raise AssertionError("health check ran on a default engine")

    kw = dict(n_slots=2, decode_chunk=2, **mode,
              **(PAGED if layout == "paged" else {}))
    ids_of = {}
    for knobs in ({}, {"paranoid": True, "fault_plan": FaultPlan([]),
                       "clock": ManualClock(), "max_queue": 64}):
        eng = TEngine(_net(PORT, zip_path), **kw, **knobs)
        if not knobs:
            monkeypatch.setattr(eng, "_health", types.MethodType(
                no_health, eng))
            events = []
            event = eng._round_event
            monkeypatch.setattr(eng, "_round_event",
                                lambda: events.append(1) or event())
        rids = [eng.submit(TRequest(list(p), n)) for p, n in MID_RUN_CASES]
        res = eng.run()
        ids_of[bool(knobs)] = [res[r].tokens for r in rids]
        if not knobs:
            assert len(events) == eng.stats["chunks"]
            assert all(eng.stats[k] == 0 for k in FAILURE_KEYS)
            counts = eng.compile_counts()
            assert "health_check" not in counts
            assert counts["decode"] == 1
            want = {"prefill", "chunk_prefill", "admit", "decode"}
            if "fused_rounds" in mode:
                want.add("fused_decode")
            if "spec_draft_len" in mode:
                want.add("verify")
            if layout == "paged":
                want |= {"paged_scatter", "paged_tok", "kv_import",
                         "kv_gather", "paged_copy", "paged_zero"}
            assert set(counts) == want
    assert ids_of[False] == ids_of[True]


def test_engine_knob_validation(zip_path):
    net = _net(PORT, zip_path)
    with pytest.raises(ValueError, match="shed_policy"):
        TEngine(net, n_slots=1, shed_policy="drop-all")
    with pytest.raises(ValueError, match="max_queue"):
        TEngine(net, n_slots=1, max_queue=0)
    with pytest.raises(ValueError, match="max_retries"):
        TEngine(net, n_slots=1, max_retries=-1)
    with pytest.raises(ValueError, match="retry_backoff_rounds"):
        TEngine(net, n_slots=1, retry_backoff_rounds=-1)


def test_request_deadline_validation():
    with pytest.raises(ValueError, match="deadline_s"):
        TRequest([1], 4, deadline_s=0)
    with pytest.raises(ValueError, match="queue_timeout_s"):
        TRequest([1], 4, queue_timeout_s=-1.0)


def test_fault_event_validation():
    with pytest.raises(ValueError, match="fault kind"):
        FaultEvent(0, "meteor")
    with pytest.raises(ValueError, match="fault kind"):
        FaultPlan.random(0, 5, kinds=("meteor",))
    with pytest.raises(ValueError, match="round"):
        FaultEvent(-1, "nan")


def test_random_plan_matches_jax():
    """A seeded plan is the JAX package's plan, event for event."""
    a = FaultPlan.random(3, 50, rate=0.3)
    b = JPlan.random(3, 50, rate=0.3)
    assert len(a) > 0
    assert ([(e.round, e.kind, e.slot, e.row, e.seconds) for e in a.events]
            == [(e.round, e.kind, e.slot, e.row, e.seconds)
                for e in b.events])
    assert FaultPlan.random(3, 50, rate=0.3).events == a.events


def test_scheduler_steps_budget_down_and_recovers():
    """JAX's ``TestAdaptiveBudget`` scheduler case on the port's
    ``Scheduler``, beside the JAX one."""
    budgets = []
    for cls, req in ((TScheduler, TRequest), (JScheduler, JRequest)):
        s = cls(64, prefill_chunk=4, prefill_budget=16, pressure_high=40,
                pressure_low=8)
        for _ in range(8):
            s.submit(req(list(range(10)), 4))
        seq = [s.pressure()] + [s.adapt_budget() for _ in range(4)]
        while s.pending:
            s.pop()
        seq += [s.adapt_budget() for _ in range(4)]
        budgets.append(seq)
    assert budgets[0] == budgets[1] == [80, 12, 8, 4, 4, 8, 12, 16, 16]


def test_unported_knobs_stay_refused(zip_path):
    net = _net(PORT, zip_path)
    for name, value in (("tenants", object()), ("tp", 2),
                        ("kv_host_tier_bytes", 1 << 20)):
        with pytest.raises(NotImplementedError, match=name):
            TEngine(net, n_slots=1, **{name: value})
    snap = TEngine(net, n_slots=1).snapshot()
    for key, value in (("tp", 2), ("kv_host_tier_bytes", 1 << 20)):
        bad = json.loads(json.dumps(snap))
        bad["config"][key] = value
        with pytest.raises(NotImplementedError, match=key):
            TEngine.restore(net, bad)
    bad = json.loads(json.dumps(snap))
    bad["tenants"] = {"default": {}}
    with pytest.raises(NotImplementedError, match="tenants"):
        TEngine.restore(net, bad)
    assert set(engine_module._UNPORTED) == {
        "tp", "tenants", "kv_host_tier_bytes", "kv_disk_tier_path",
        "kv_disk_tier_bytes"}


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_health_check_verdicts(zip_path, layout):
    """The health check flags a NaN, a +inf and a -inf in a slot's rows
    (dense) or a referenced block (paged) and an out-of-vocabulary
    current token; paged, the scratch block is never judged, so NaN
    there flags nothing; a freed block is not reported."""
    eng = TEngine(_net(PORT, zip_path), n_slots=4, decode_chunk=2,
                  paranoid=True, **(PAGED if layout == "paged" else {}))
    rids = [eng.submit(TRequest([1 + i, 2, 3], 30)) for i in range(4)]
    eng.step()
    assert all(eng._slots) and eng._health().all()
    layer = next(iter(eng._pool.values()))
    if layout == "paged":
        scratch = layer["scratch"]
        assert scratch == eng.kv_blocks
        poison_rows(eng._pool, [scratch])
        assert eng._paged_health()[0] == set()
        blocks = [next(iter(eng._kv_tabs[s].blocks.values()))
                  for s in range(3)]
        for b, v in zip(blocks, (float("nan"), float("inf"),
                                 -float("inf"))):
            layer["pv"][b, 0, 0, 0] = v
        eng._toks[3] = V
        bad, toks_ok = eng._paged_health()
        assert bad == set(blocks) == eng.block_pool.poisoned
        assert toks_ok.tolist() == [True, True, True, False]
        healthy = eng._quarantine([0, 1, 2, 3])
        assert healthy == [] and eng.stats["quarantined"] == 4
        assert eng.block_pool.poisoned == set()
        assert eng.block_pool.stats["scrubbed"] == 3
    else:
        for s, v in zip(range(3), (float("nan"), float("inf"),
                                   -float("inf"))):
            layer["v"][s, 0, -1, 0] = v
        eng._toks[3] = -1
        assert eng._health().tolist() == [False] * 4
        assert eng._quarantine([0, 1, 2, 3]) == []
        # eviction zeroed the rows (the stale token waits for the next
        # admission to overwrite it)
        assert eng._health()[:3].all()
    res = eng.run()
    assert all(res[r].retries == 1 and _ok(res[r]) for r in rids)
