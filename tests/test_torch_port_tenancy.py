"""Tenancy in the PyTorch port against the JAX package: the weighted-fair
scheduler, the token bucket, the registry, the engine's QoS round and
snapshots with tenants, and the gateway's and CLI's tenancy surface.

One JAX-written model zip (``transformer_lm(n_in=16, width=64,
n_layers=2, n_heads=4)``, a 64-token window) is loaded into both
packages. Scheduler level: a seeded script of a few hundred
operations drives both packages' ``WeightedFairScheduler``s and every
decision and ``tenant_retry_after_s`` must be identical; the
``TokenBucket``s run under one fake clock; registries and specs cross
the packages as dicts and CLI spellings. Engine level, on both layouts
at float32 greedy: a flooding tenant fills the slots, a higher-priority
arrival preempts one, and the ids, the admission order, the preemption
counts, ``tenant_stats`` and each result's tenant must be JAX's; a
default-tenant registry gives the ids of no registry; a JAX snapshot
with tenants restores into the port and a port snapshot into JAX, with
the ids of the engine that went on. One JAX engine a layout serves
every JAX-side case of that layout, plus one JAX restore. Gateway and
CLI (port only): a tenant's full queue answers 429 naming the tenant,
with ``Retry-After`` and the labelled ``serving_gateway_429`` series
(the stepping thread held while the queue fills, never raced), the
reserved ``system`` tenant is refused from the wire and bills warmup,
and ``--tenant`` reaches the engine."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.serving import ManualClock as JClock
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import TenantRegistry as JRegistry
from deeplearning4j_tpu.serving import TenantSpec as JSpec
from deeplearning4j_tpu.serving import TokenBucket as JBucket
from deeplearning4j_tpu.serving import WeightedFairScheduler as JWFS
from deeplearning4j_tpu.util.model_serializer import (
    restore_model as j_restore_model,
)
from deeplearning4j_tpu.util.model_serializer import write_model

from deeplearning4j_tpu_torch.cli.driver import (
    build_parser,
    gateway_from_args,
)
from deeplearning4j_tpu_torch.serving import DecodeEngine as TEngine
from deeplearning4j_tpu_torch.serving import (
    GatewayClient,
    GatewayError,
    ManualClock,
    ServingGateway,
)
from deeplearning4j_tpu_torch.serving import Request as TRequest
from deeplearning4j_tpu_torch.serving import TenantRegistry as TRegistry
from deeplearning4j_tpu_torch.serving import TenantSpec as TSpec
from deeplearning4j_tpu_torch.serving import TokenBucket as TBucket
from deeplearning4j_tpu_torch.serving import WeightedFairScheduler as TWFS
from deeplearning4j_tpu_torch.util.model_serializer import restore_model
from torch_port_threads import one_torch_thread  # noqa: F401

V, WINDOW = 16, 64
LAYOUTS = {"dense": {}, "paged": dict(paged_kv=True, block_tokens=8)}
GEOMETRY = dict(n_slots=2, decode_chunk=2, seed=0)
FLOOD = [([1, 2, 3], 30), ([2, 3, 4], 30)]
PREMIUM = ([4, 5, 6], 4)
PROMPTS = [[1, 4, 7, 2], [9, 3, 3], [5, 2, 8, 1, 6, 0, 4], [2, 2],
           [11, 0, 6]]
LENS = [6, 11, 4, 9, 13]
SPECS = (dict(tenant="premium", priority=2, weight=4.0),
         dict(tenant="standard", priority=1, weight=2.0, max_queued=3),
         dict(tenant="flood", priority=0, weight=1.0, max_slots=2,
              max_queued=5))

JAX = types.SimpleNamespace(name="jax", Engine=JEngine, Request=JRequest,
                            Registry=JRegistry, Spec=JSpec, WFS=JWFS,
                            Bucket=JBucket, Clock=JClock)
PORT = types.SimpleNamespace(name="port", Engine=TEngine, Request=TRequest,
                             Registry=TRegistry, Spec=TSpec, WFS=TWFS,
                             Bucket=TBucket, Clock=ManualClock)

_CACHE = {}


def _registry(pkg):
    return pkg.Registry(tuple(pkg.Spec(**kw) for kw in SPECS))


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    conf = jzoo.transformer_lm(n_in=V, width=64, n_layers=2, n_heads=4,
                               n_classes=V, seed=7)
    for c in conf.confs:
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    path = str(tmp_path_factory.mktemp("tenancy") / "lm.zip")
    write_model(JNet(conf).init(), path)
    return path


def _net(pkg, zip_path):
    if pkg is JAX:
        key = ("jnet", zip_path)
        if key not in _CACHE:
            _CACHE[key] = j_restore_model(zip_path)
        return _CACHE[key]
    return restore_model(zip_path, device="cpu")


# -- scheduler level ---------------------------------------------------
TENANTS = ("premium", "standard", "flood", "default", "guest")


def _scheduler_script(pkg, seed=0, n_ops=400):
    """Drive one package's WeightedFairScheduler through a seeded
    script; returns the log of every decision and hint."""
    rng = np.random.default_rng(seed)
    s = pkg.WFS(WINDOW, tenants=_registry(pkg), max_queue=10)
    log, ids = [], []
    for _ in range(n_ops):
        op = rng.choice(["submit"] * 7 + ["begin", "usage", "admit",
                                          "pop", "plan", "shed",
                                          "remove", "hint"])
        if op == "submit":
            tenant = str(rng.choice(TENANTS))
            prio = (None if rng.random() < 0.7
                    else int(rng.integers(-1, 4)))
            req = pkg.Request(rng.integers(0, V, rng.integers(1, 9))
                              .tolist(), int(rng.integers(1, 20)),
                              tenant=tenant, priority=prio)
            if s.tenant_full(tenant) or s.full:
                log.append(("full", tenant, s.tenant_full(tenant)))
                continue
            ids.append(s.submit(req))
            log.append(("submit", ids[-1]))
        elif op == "begin":
            running = {str(t): int(rng.integers(0, 3))
                       for t in rng.choice(TENANTS, 2)}
            s.begin_round(running)
            log.append(("begin", sorted(running.items())))
        elif op == "usage":
            used = {str(t): int(rng.integers(0, 40))
                    for t in rng.choice(TENANTS, 2)}
            s.note_usage(used)
            log.append(("usage", sorted(s._pass.items())))
        elif op == "admit":
            req = s.pop_admissible()
            log.append(("admit", None if req is None else req.id))
        elif op == "pop" and s.pending:
            log.append(("pop", s.pop().id))
        elif op == "plan":
            view = [(slot, str(rng.choice(TENANTS)),
                     int(rng.integers(-1, 3)))
                    for slot in range(int(rng.integers(0, 6)))]
            free = int(rng.integers(0, 3))
            log.append(("plan", s.plan_preemptions(view, free)))
        elif op == "shed" and s.pending:
            log.append(("shed", s.shed_victim().id))
        elif op == "remove" and ids:
            rid = int(rng.choice(ids))
            req = s.remove(rid)
            log.append(("remove", rid, None if req is None else req.id))
        elif op == "hint":
            tenant = str(rng.choice(TENANTS))
            log.append(("hint", tenant,
                        s.tenant_retry_after_s(tenant, 4, 0.7),
                        s.retry_after_s(4, 0.7)))
        log.append(("state", s.pending, s.pressure(),
                    [r.id for r in s.queued_requests()],
                    {t: s.tenant_depth(t) for t in TENANTS}))
    return log


@pytest.mark.parametrize("seed", [0, 1])
def test_weighted_fair_scheduler_script_matches_jax(seed):
    """A seeded script of submits (full queues refused), rounds, usage
    charges, admissions, pops, preemption plans, sheds, removals and
    retry hints: every decision, hint and queue view is JAX's."""
    want = _scheduler_script(JAX, seed)
    got = _scheduler_script(PORT, seed)
    assert len(got) == len(want) > 400
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
    kinds = {entry[0] for entry in got}
    assert {"submit", "admit", "plan", "shed", "hint", "full"} <= kinds
    assert any(e[0] == "plan" and e[1] for e in got)


def test_token_bucket_under_a_fake_clock():
    """Both buckets under one fake clock: the same waits, levels and
    restored levels."""
    out = {}
    for pkg in (JAX, PORT):
        now = [0.0]
        bucket = pkg.Bucket(2.0, burst=3.0, clock=lambda: now[0])
        log = []
        for dt, n in [(0, 1), (0, 1), (0, 1), (0, 1), (0.25, 1),
                      (0.5, 1), (2.0, 2.5), (0, 4), (10.0, 1)]:
            now[0] += dt
            log.append((bucket.try_take(n), bucket.tokens))
        bucket.restore_level(0.5, age_s=0.5)
        log.append(bucket.tokens)
        log.append(pkg.Bucket(4.0, clock=lambda: 0.0).capacity)
        out[pkg.name] = log
    assert out["port"] == out["jax"]
    assert out["port"][3][0] == pytest.approx(0.5)


def test_registry_and_spec_cross_the_packages():
    """Registry dicts round-trip across the packages (either way),
    ``TenantSpec.parse`` reads the CLI spelling alike, unknown tenants
    get default service under their own name, priorities clamp, and
    both refuse the same bad specs and names."""
    for src, dst in ((JAX, PORT), (PORT, JAX)):
        reg = _registry(src)
        back = dst.Registry.from_dict(json.loads(json.dumps(
            reg.to_dict())))
        assert back.to_dict() == reg.to_dict()
        assert back.tenants() == reg.tenants()
    for text in ("premium:priority=2:weight=4:slots=4:rps=50",
                 "b:queue=3:burst=2.5:weight=0.5", "plain"):
        assert dataclasses.asdict(TSpec.parse(text)) == \
            dataclasses.asdict(JSpec.parse(text))
    for pkg in (JAX, PORT):
        reg = _registry(pkg)
        assert reg.spec_of("guest").tenant == "guest"
        assert reg.spec_of("guest").max_slots is None
        assert reg.effective_priority(
            pkg.Request([1], 2, tenant="standard", priority=9)) == 1
        assert reg.effective_priority(
            pkg.Request([1], 2, tenant="standard", priority=-3)) == -3
        for bad in ("x:slots", "x:color=3"):
            with pytest.raises(ValueError):
                pkg.Spec.parse(bad)
        for kw in (dict(tenant="bad name"), dict(tenant="w", weight=0),
                   dict(tenant="q", max_queued=0)):
            with pytest.raises(ValueError):
                pkg.Spec(**kw)
        with pytest.raises(ValueError):
            reg.register(pkg.Spec("system", max_slots=1))


# -- engine level --------------------------------------------------------
def _engine(pkg, zip_path, layout, tenants=True, **kw):
    return pkg.Engine(_net(pkg, zip_path), clock=pkg.Clock(),
                      tenants=_registry(pkg) if tenants else None,
                      **GEOMETRY, **LAYOUTS[layout], **kw)


def _jax_engine(zip_path, layout):
    """The layout's shared JAX tenancy engine (compiled once)."""
    key = ("jeng", zip_path, layout)
    if key not in _CACHE:
        _CACHE[key] = _engine(JAX, zip_path, layout)
    return _CACHE[key]


def _preemption_run(pkg, eng):
    """Two flood requests fill both slots for two rounds, then a
    premium arrival: it preempts one flood slot in the round it
    arrives. Returns what both packages must agree on."""
    order = []
    start = eng._start_admission

    def record(request, slot):
        order.append((request.id, request.tenant, slot))
        return start(request, slot)

    eng._start_admission = record
    pre = eng.stats["preempted"], eng.stats["qos_preempted"]
    try:
        flood = [eng.submit(pkg.Request(list(p), n, tenant="flood"))
                 for p, n in FLOOD]
        res = {}
        eng.step(res)
        eng.step(res)
        full = all(s is not None for s in eng._slots)
        prem = eng.submit(pkg.Request(list(PREMIUM[0]), PREMIUM[1],
                                      tenant="premium"))
        eng.step(res)
        admitted_now = any(s is not None and s.request.id == prem
                           for s in eng._slots) or prem in res
        while eng.has_work():
            eng.step(res)
    finally:
        eng._start_admission = start
    ids = flood + [prem]
    return {"full": full, "admitted_now": admitted_now,
            "tokens": [res[i].tokens for i in ids],
            "reasons": [res[i].finish_reason for i in ids],
            "tenants": [res[i].tenant for i in ids],
            "order": order,
            "preempted": (eng.stats["preempted"] - pre[0],
                          eng.stats["qos_preempted"] - pre[1]),
            "tenant_stats": json.loads(json.dumps(eng.tenant_stats))}


def _default_run(pkg, eng):
    ids = [eng.submit(pkg.Request(list(p), n))
           for p, n in zip(PROMPTS, LENS)]
    res = eng.run()
    return [res[i].tokens for i in ids], [res[i].tenant for i in ids]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_preemption_and_tenant_accounting_match_jax(zip_path, layout):
    """The higher-priority arrival is admitted in the round it arrives
    by recompute-preempting the youngest flood slot; the flood requests
    regenerate the ids of a tenancy-off engine. Ids, admission order,
    preemption counts, ``tenant_stats`` and each result's tenant are
    JAX's."""
    want = _preemption_run(JAX, _jax_engine(zip_path, layout))
    got = _preemption_run(PORT, _engine(PORT, zip_path, layout))
    assert got == want
    assert got["full"] and got["admitted_now"]
    assert got["preempted"] == (1, 1)
    assert got["tenants"] == ["flood", "flood", "premium"]
    assert got["reasons"] == ["length"] * 3
    assert got["tenant_stats"]["flood"]["preempted"] == 1
    solo = _engine(PORT, zip_path, layout, tenants=False)
    ids = [solo.submit(TRequest(list(p), n)) for p, n in FLOOD]
    res = solo.run()
    assert got["tokens"][:2] == [res[i].tokens for i in ids]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_default_tenant_registry_gives_the_ids_of_no_registry(zip_path,
                                                               layout):
    """Default-tenant traffic through a registry admits in arrival
    order: the ids of the tenancy-off engine and of JAX's tenancy
    engine; only a tenancy engine's results carry the tenant."""
    j_ids, j_tenants = _default_run(JAX, _jax_engine(zip_path, layout))
    t_ids, t_tenants = _default_run(PORT, _engine(PORT, zip_path, layout))
    off_ids, off_tenants = _default_run(
        PORT, _engine(PORT, zip_path, layout, tenants=False))
    assert t_ids == j_ids == off_ids
    assert t_tenants == j_tenants == ["default"] * len(PROMPTS)
    assert off_tenants == [None] * len(PROMPTS)


def _snapshot_midway(pkg, eng):
    """A premium request (lowered to priority 1) and a flood request
    admitted, one round, a snapshot through JSON; the engine goes on.
    Returns (snapshot, ids, the going engine's results)."""
    a = eng.submit(pkg.Request([1, 2, 3], 12, tenant="premium",
                               priority=1))
    b = eng.submit(pkg.Request([2, 3, 4], 12, tenant="flood"))
    c = eng.submit(pkg.Request([3, 4, 5], 9, tenant="flood"))
    eng.step()
    snap = json.loads(json.dumps(eng.snapshot()))
    res = eng.run()
    return snap, [a, b, c], res


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_snapshots_with_tenants_cross_the_packages(zip_path, layout):
    """A JAX snapshot with tenants restores into the port, and a port
    snapshot into JAX: the registry rides the snapshot, the restored
    scheduler is weighted-fair, and the ids and tenants are those of
    the engine that went on."""
    jsnap, jids, jres = _snapshot_midway(JAX,
                                         _jax_engine(zip_path, layout))
    tsnap, tids, tres = _snapshot_midway(PORT,
                                         _engine(PORT, zip_path, layout))
    assert tsnap["tenants"] == jsnap["tenants"]
    assert [tres[i].tokens for i in tids] == [jres[i].tokens for i in jids]
    port = TEngine.restore(_net(PORT, zip_path), jsnap,
                           clock=ManualClock())
    assert isinstance(port.scheduler, TWFS)
    assert port.tenants.spec_of("flood").max_slots == 2
    pres = port.run()
    assert [pres[i].tokens for i in jids] == [jres[i].tokens for i in jids]
    assert [pres[i].tenant for i in jids] == ["premium", "flood", "flood"]
    jax = JEngine.restore(_net(JAX, zip_path), tsnap, clock=JClock())
    assert isinstance(jax.scheduler, JWFS)
    back = jax.run()
    assert [back[i].tokens for i in tids] == [tres[i].tokens for i in tids]
    assert [back[i].tenant for i in tids] == ["premium", "flood", "flood"]


def test_tenant_queue_bound_sheds_only_that_tenant(zip_path):
    """A tenant at its ``max_queued`` sheds its own new request (and
    the labelled counters say whose), whatever the others hold."""
    eng = _engine(PORT, zip_path, "dense")
    flood = [eng.submit(TRequest([1, 2], 6, tenant="flood"))
             for _ in range(6)]
    ok = eng.submit(TRequest([4, 5], 6, tenant="premium"))
    res = eng.run()
    assert [res[i].finish_reason for i in flood] == ["length"] * 5 + [
        "shed"]
    assert res[ok].finish_reason == "length"
    assert eng.stats["shed"] == 1


# -- gateway and CLI -----------------------------------------------------
def _pause(gw, paused: bool) -> None:
    """Hold (or release) the gateway's stepping thread between rounds."""
    with gw._wake:
        gw._paused = paused
        gw._wake.notify_all()


def test_gateway_per_tenant_429_and_labelled_series(zip_path):
    """With the stepping thread held, the flood tenant fills its own
    queue (``max_queued`` 2); its next request answers 429 naming the
    tenant with a ``Retry-After`` header, counted in
    ``serving_gateway_429`` and its ``{tenant="flood"}`` twin, while a
    premium request queued beside them is admitted first and billed
    to premium; the labelled tracks reach ``/v1/metrics``."""
    reg = TRegistry((TSpec("premium", priority=2, weight=4.0),
                     TSpec("flood", max_queued=2)))
    eng = TEngine(_net(PORT, zip_path), n_slots=1, decode_chunk=2, seed=0,
                  tenants=reg)
    with ServingGateway(eng, keepalive_s=0.1) as gw:
        client = GatewayClient(gw.address, timeout_s=60.0)
        _pause(gw, True)
        streams = [client.stream([9, 3, 3, i], 4, tenant="flood")
                   for i in range(2)]
        assert eng.scheduler.tenant_full("flood")
        with pytest.raises(GatewayError) as err:
            client.generate([9, 3, 1], 4, tenant="flood")
        assert err.value.status == 429
        assert err.value.payload["tenant"] == "flood"
        assert err.value.payload["error"] == "tenant queue full"
        assert err.value.retry_after_s >= 1
        premium = client.stream([1, 4, 7], 4, tenant="premium")
        _pause(gw, False)
        assert len([t for d in premium for t in d]) == 4
        assert premium.result["finish_reason"] == "length"
        assert premium.result["tenant"] == "premium"
        for st in streams:
            assert len([t for d in st for t in d]) == 4
            assert st.result["tenant"] == "flood"
        text = client.metrics()
    assert 'serving_gateway_429{tenant="flood"} 1' in text
    assert "serving_gateway_429 1" in text
    assert 'serving_ttft_s_bucket{tenant="premium",le=' in text
    assert 'serving_admitted{tenant="flood"}' in text
    assert eng.tenant_stats["flood"]["admitted"] == 2


def test_gateway_reserves_the_system_tenant(zip_path):
    """``system`` is refused from the wire (400), and ``/v1/warmup``
    bills it: no user tenant is charged for the boot handshake."""
    eng = TEngine(_net(PORT, zip_path), n_slots=2, decode_chunk=2, seed=0,
                  prefix_cache_rows=4, tenants=_registry(PORT))
    with ServingGateway(eng, keepalive_s=0.1) as gw:
        client = GatewayClient(gw.address, timeout_s=60.0)
        with pytest.raises(GatewayError) as err:
            client.generate([1, 4, 7], 2, tenant="system")
        assert err.value.status == 400
        assert "reserved" in err.value.payload["error"]
        with pytest.raises(GatewayError) as err:
            client.generate([1, 4, 7], 2, tenant="bad name{x}")
        assert err.value.status == 400
        out = client.warmup([[1, 4, 7, 2], [9, 3, 3, 1]])
        assert out["warmed"] == 2
        assert eng.tenant_stats["system"]["admitted"] == 2
        assert not {"default", "premium"} & set(eng.tenant_stats)


def test_cli_tenant_flags_reach_the_engine(tmp_path, zip_path):
    """Repeated ``--tenant`` specs in ``TenantSpec.parse``'s spelling
    build the engine's registry (JAX's specs for the same text); no
    ``--tenant`` leaves the FIFO scheduler."""
    model = zip_path
    specs = ["premium:priority=2:weight=4:slots=1", "flood:queue=3"]
    argv = ["serve", "--model", model, "--device", "cpu", "--port", "0",
            "--slots", "2", "--snapshot", str(tmp_path / "s.json")]
    args = build_parser().parse_args(
        argv + [x for s in specs for x in ("--tenant", s)])
    gw = gateway_from_args(args).start()
    try:
        reg = gw.engine.tenants
        assert isinstance(gw.engine.scheduler, TWFS)
        for text in specs:
            spec = JSpec.parse(text)
            assert dataclasses.asdict(reg.spec_of(spec.tenant)) == \
                dataclasses.asdict(spec)
        out = GatewayClient(gw.address).generate([1, 4, 7], 3,
                                                  tenant="premium")
        assert out["tenant"] == "premium"
    finally:
        gw.close()
    gw = gateway_from_args(build_parser().parse_args(argv)).start()
    try:
        assert gw.engine.tenants is None
    finally:
        gw.close()
