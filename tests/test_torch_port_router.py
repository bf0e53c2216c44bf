"""The PyTorch port's serving router against the JAX package's.

The port's ``ServingRouter`` fronts the port's ``LocalReplica``s on the
CPU, over one JAX-written zip (``transformer_lm``, 2 layers, width 32,
f32; every replica runs ``torch_port_fleet.ENGINE``, paged with a
prefix trie). Greedy ids through the router, blocking and streamed,
equal JAX's direct engine. A replica killed mid-stream (``hard_kill``)
is replayed on the survivor with identical ids, and every SSE event id
is the delivered-token count, none repeated or skipped; a sampled
stream ends ``fault`` instead, and so does a greedy one whose survivor
computes another function (two output classes swapped), through
``_ReplayDiverged`` and with no token spliced. A 429 parks the replica
without killing it, the breaker opens and a half-open probe brings the
replica back, a drain hands its streams to the survivor, and the warm
import on an affinity miss serves the receiver warm (a truncated
payload falls back to recompute). The rendezvous ranking and
``parse_prometheus`` equal JAX's as pure functions; the federated
``/v1/fleet/metrics`` and the stitched ``/v1/trace`` have JAX's
families and lanes, and ``scripts/latency_report.py`` reads the port
router's scrape. A mixed fleet, one JAX gateway and one port gateway,
replays either one's killed stream onto the other with identical ids.

No case waits on a wall-clock race: health ticks and probes are called
(``torch_port_fleet.tick``), a kill lands while the owner's stepping
thread is held by a ``Gate`` (an event), and waits poll a condition
under a generous bound."""

import threading

import pytest

from deeplearning4j_tpu.profiler.tracer import (
    parse_exposition as j_parse_exposition,
)
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.serving import LocalReplica as JLocalReplica
from deeplearning4j_tpu.serving import RouterClient as JRouterClient
from deeplearning4j_tpu.serving import ServingRouter as JRouter
from deeplearning4j_tpu.serving import TenantRegistry as JTenantRegistry
from deeplearning4j_tpu.serving import TenantSpec as JTenantSpec
from deeplearning4j_tpu.serving.router import (
    parse_prometheus as j_parse_prometheus,
)
from deeplearning4j_tpu.util.model_serializer import (
    restore_model as j_restore_model,
)

from deeplearning4j_tpu_torch.profiler.tracer import parse_exposition
from deeplearning4j_tpu_torch.serving import (
    DecodeEngine,
    GatewayClient,
    RouterClient,
    ServingGateway,
    ServingRouter,
    TenantRegistry,
    TenantSpec,
)
from deeplearning4j_tpu_torch.serving.router import parse_prometheus
from scripts.latency_report import run_fleet_report, run_tenant_report
from torch_port_fleet import (
    AFFINITY,
    ENGINE,
    JaxReference,
    assert_event_ids_exact,
    close_all,
    gated_replica,
    manual_router,
    owner_of,
    port_net,
    read_stream,
    swap_head_classes,
    tick,
    wait_for,
    write_lm_zip,
)
from torch_port_threads import one_torch_thread  # noqa: F401

PROMPTS = [[1, 4, 7, 2, 5, 9, 3, 3, 1, 6], [9, 3, 3],
           [5, 2, 8, 1, 6, 0, 4, 2, 2, 7, 1], [3, 1, 4, 1, 5, 9, 2, 6]]
N_GEN = 24
#: the JAX engine's histogram of the feature the port refuses (tensor
#: parallelism), empty in a JAX scrape and absent from the port's
JAX_ONLY = {"serving_tp_dispatch_s"}


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    return write_lm_zip(tmp_path_factory.mktemp("router") / "lm.zip")


@pytest.fixture(scope="module")
def ref(zip_path):
    r = JaxReference(zip_path)
    r.many([(p, N_GEN) for p in PROMPTS])
    return r


@pytest.fixture(scope="module")
def tnet(zip_path):
    return port_net(zip_path)


@pytest.fixture
def fleet(request, tnet):
    """``make(n=2, nets=None, **engine_kwargs) -> (router, replicas)``:
    fresh gated port replicas behind a manual router, closed after the
    test; the first tick has taught the router their ids."""
    made = []

    def make(n=2, nets=None, router_kwargs=None, **engine_kwargs):
        nets = nets or [tnet] * n
        reps = [gated_replica(net, f"rep-{i}", **engine_kwargs)
                for i, net in enumerate(nets)]
        router = manual_router([r.address for r in reps],
                               **(router_kwargs or {}))
        made.append((router, reps))
        tick(router)
        return router, reps

    yield make
    for router, reps in made:
        close_all(router, reps)


def _admission_steps(prompt) -> int:
    return -(-len(prompt) // ENGINE["prefill_chunk"])


def _kill_owner_mid_stream(router, reps, prompt, n, **params):
    """Stream through the router; once the first delta is in and the
    owner's stepping thread is held, release the others and kill the
    owner. Returns ``(stream, tokens, events, killed)``."""
    for r in reps:
        r.gate.hold_after(_admission_steps(prompt) + 3)
    s = RouterClient(router.address, timeout_s=120.0).stream(
        prompt, n, **params)
    killed = []

    def kill():
        owner = owner_of(router, reps, s.id)
        assert owner.gate.held.wait(60)
        for r in reps:
            if r is not owner:
                r.gate.release()
        owner.sigkill()
        killed.append(owner)

    toks, events = read_stream(s, after_first=kill)
    assert killed, "the stream ended before its first delta"
    return s, toks, events, killed[0]


def _diverged(router, rid) -> bool:
    return any(h[1] == "replay_diverged"
               for h in router._journal[rid].history)


# -- pure functions ------------------------------------------------------

def _unstarted(cls, addrs):
    return cls(addrs, affinity_block_tokens=AFFINITY)


def _close_unstarted(router):
    router._service._httpd.server_close()


@pytest.mark.parametrize("ids", [
    ["rep-0", "rep-1"], ["a", "b", "c"],
    ["fleet-0", "fleet-1", "fleet-auto-0", "fleet-auto-1"],
])
def test_rendezvous_ranking_matches_jax(ids):
    """The affinity key, the rendezvous score and the pick (bounded load
    included: a saturated owner spills down the ranking) are JAX's for
    the same replica ids and prompts, with no server behind them."""
    addrs = [f"127.0.0.1:{9100 + i}" for i in range(len(ids))]
    routers = [_unstarted(ServingRouter, addrs),
               _unstarted(JRouter, addrs)]
    try:
        prompts = [[(7 * i + j) % 12 for j in range(3 + i % 13)]
                   for i in range(40)]
        for r in routers:
            for rep, rid in zip(r._replicas, ids):
                rep.replica_id = rid
                rep.n_slots = 2
        picks = []
        for r in routers:
            got = []
            for p in prompts:
                key = r._affinity_key(p)
                scores = (None if key is None else
                          [r._rendezvous_score(key, i) for i in ids])
                chosen, info = r._pick(p, set())
                got.append((key, scores, chosen.replica_id,
                            info["rank"], info["key"]))
            picks.append(got)
            # every claim held: a second round walks the ranking
            got2 = [r._pick(p, set())[0].replica_id for p in prompts]
            picks.append(got2)
        assert picks[0] == picks[2] and picks[1] == picks[3]
        assert any(rank for *_, rank, _ in picks[0] if rank)
    finally:
        for r in routers:
            _close_unstarted(r)


def test_parse_prometheus_matches_jax(fleet):
    router, reps = fleet(n=1)
    GatewayClient(reps[0].address).generate(PROMPTS[1], 4)
    scraped = GatewayClient(reps[0].address).metrics()
    synthetic = (
        "# HELP x_total a counter\n# TYPE x_total counter\n"
        "x_total 3\nsome_gauge -1.5e-3\nnan_gauge NaN\n"
        "inf_gauge +Inf\nlabeled{tenant=\"a\",le=\"0.1\"} 4\n"
        "broken line without value\n  \nh_bucket{le=\"+Inf\"} 9\n")
    for text in (scraped, synthetic, ""):
        got, want = parse_prometheus(text), j_parse_prometheus(text)
        assert sorted(got) == sorted(want)
        for k in got:
            assert (got[k] == want[k]
                    or (got[k] != got[k] and want[k] != want[k])), k
    assert parse_prometheus(scraped)["serving_gateway_queue_depth"] == 0


# -- the relay -----------------------------------------------------------

def test_blocking_and_streaming_match_jax_engine(fleet, ref):
    router, reps = fleet()
    client = RouterClient(router.address, timeout_s=120.0)
    for p in PROMPTS:
        want = ref(p, N_GEN)
        out = client.generate(p, N_GEN)
        assert out["tokens"] == want
        assert (out["finish_reason"], out["status"], out["replays"]) \
            == ("length", 200, 0)
        s = client.stream(p, N_GEN)
        toks, events = read_stream(s)
        assert toks == want == s.result["tokens"]
        assert_event_ids_exact(toks, events)
    assert router.stats["requests"] == 2 * len(PROMPTS)
    audit = router.journal_audit()
    assert audit["lost"] == [] and audit["open"] == []


@pytest.mark.parametrize("mode", ["stream", "blocking"])
def test_hard_kill_mid_stream_replays_identically(fleet, ref, mode):
    router, reps = fleet()
    prompt = PROMPTS[0]
    want = ref(prompt, N_GEN)
    if mode == "stream":
        s, toks, events, killed = _kill_owner_mid_stream(
            router, reps, prompt, N_GEN)
        assert_event_ids_exact(toks, events)
        result = s.result
    else:
        for r in reps:
            r.gate.hold_after(_admission_steps(prompt) + 3)
        out = {}
        client = RouterClient(router.address, timeout_s=120.0)
        t = threading.Thread(
            target=lambda: out.update(client.generate(prompt, N_GEN)))
        t.start()
        wait_for(lambda: 0 in router._journal
                 and router._journal[0].tokens, msg="first tokens")
        killed = owner_of(router, reps, 0)
        assert killed.gate.held.wait(60)
        next(r for r in reps if r is not killed).gate.release()
        killed.sigkill()
        t.join(timeout=120)
        assert not t.is_alive()
        toks, result = out["tokens"], out
    assert toks == want == result["tokens"]
    assert result["finish_reason"] == "length"
    assert result["replays"] >= 1 and router.stats["replays"] >= 1
    assert not _diverged(router, 0)
    audit = router.journal_audit()
    assert audit["lost"] == [] and audit["open"] == []
    assert 0 in audit["replayed"]
    # the data plane charged the breaker; one tick more opens it
    tick(router)
    state = {r["replica_id"]: r["state"] for r in router.replica_status()}
    assert state[killed.replica_id] == "dead"


def test_sampled_stream_ends_fault_after_kill(fleet):
    router, reps = fleet()
    s, toks, events, _ = _kill_owner_mid_stream(
        router, reps, PROMPTS[0], N_GEN, temperature=0.7)
    assert s.result["finish_reason"] == "fault"
    assert s.result["status"] == 500
    assert s.result["tokens"] == toks and toks
    assert router.stats["request_faults"] == 1
    assert_event_ids_exact(toks, events)


def test_survivor_with_swapped_head_ends_fault(fleet, ref, zip_path):
    """The replay regenerates the streamed prefix on a survivor whose
    first greedy token is another class: ``_ReplayDiverged`` ends the
    stream ``fault`` with only the tokens streamed before the kill."""
    prompt = PROMPTS[0]
    want = ref(prompt, N_GEN)
    other = (want[0] + 1) % 12
    nets = [port_net(zip_path, swap=(want[0], other)) for _ in range(2)]
    router, reps = fleet(nets=nets)
    # route the stream to a replica with the true head: swap that one
    # back, so only the survivor computes another function
    key = router._affinity_key(prompt)
    top = max(reps, key=lambda r: router._rendezvous_score(
        key, r.replica_id))
    swap_head_classes(top.gw.engine.net, want[0], other)
    s, toks, events, killed = _kill_owner_mid_stream(
        router, reps, prompt, N_GEN)
    assert killed is top
    assert s.result["finish_reason"] == "fault"
    assert toks == want[:len(toks)] and toks
    assert s.result["tokens"] == toks
    assert _diverged(router, s.id)
    spans = [e for e in router.tracer.events()
             if e.get("name") == "router.replay"]
    assert spans and spans[-1]["args"]["overlap_ok"] is False
    assert_event_ids_exact(toks, events)


# -- backpressure, breaker, drain ----------------------------------------

def test_429_parks_the_replica_and_does_not_kill_it(fleet, ref):
    router, reps = fleet(n_slots=1, max_queue=1)
    prompt = [7] * 8
    key = router._affinity_key(prompt)
    owner = max(reps, key=lambda r: router._rendezvous_score(
        key, r.replica_id))
    owner.gate.hold_after(0)
    # one queued request fills the owner's queue; nothing steps
    busy = GatewayClient(owner.address, timeout_s=120.0).stream(
        [2, 2], 6)
    out = RouterClient(router.address, timeout_s=120.0).generate(
        prompt, 4)
    assert out["finish_reason"] == "length"
    assert out["tokens"] == ref(prompt, 4)
    assert router.stats["rerouted_429"] >= 1
    status = {r["replica_id"]: r for r in router.replica_status()}
    assert status[owner.replica_id]["state"] == "live"
    rep = next(r for r in router._replicas
               if r.replica_id == owner.replica_id)
    assert rep.backoff_until > 0 and rep.failures == 0
    owner.gate.release()
    toks, _ = read_stream(busy)
    assert busy.result["finish_reason"] == "length"


def test_breaker_opens_and_half_open_probe_recovers(fleet, tnet):
    router, reps = fleet()
    victim = reps[0]
    host, port = victim.gw._service.host, victim.gw._service.port
    victim.sigkill()
    states = []
    for _ in range(router.failure_threshold):
        tick(router)
        states.append(router.replica_status()[0]["state"])
    assert states == ["degraded"] * (router.failure_threshold - 1) \
        + ["dead"]
    assert RouterClient(router.address).generate(PROMPTS[1], 4)[
        "finish_reason"] == "length"
    tick(router)  # the probe is not due yet: still dead
    assert router.replica_status()[0]["state"] == "dead"
    revived = ServingGateway(DecodeEngine(tnet, **ENGINE), host=host,
                             port=port, replica_id="rep-0").start()
    try:
        tick(router, probe=True)
        assert router.replica_status()[0]["state"] == "live"
    finally:
        revived.close()


def test_drain_replica_hands_streams_to_survivor(fleet, ref):
    router, reps = fleet()
    prompt = PROMPTS[2]
    want = ref(prompt, N_GEN)
    for r in reps:
        r.gate.hold_after(_admission_steps(prompt) + 3)
    client = RouterClient(router.address, timeout_s=120.0)
    s = client.stream(prompt, N_GEN)
    drained = {}

    def drain():
        owner = owner_of(router, reps, s.id)
        assert owner.gate.held.wait(60)
        next(r for r in reps if r is not owner).gate.release()
        drained.update(client.drain_replica(owner.replica_id,
                                            timeout_s=0.2))
        drained["owner"] = owner

    toks, events = read_stream(s, after_first=drain)
    assert toks == want and s.result["replays"] >= 1
    assert_event_ids_exact(toks, events)
    assert s.id in drained["open_requests_handed_off"]
    assert drained["drain"]["carried"] >= 1
    status = {r["replica_id"]: r["state"] for r in router.replica_status()}
    assert status[drained["owner"].replica_id] == "dead"
    tick(router, probe=True)  # decommissioned: never resurrected
    status = {r["replica_id"]: r["state"] for r in router.replica_status()}
    assert status[drained["owner"].replica_id] == "dead"


# -- the KV transfer plane -----------------------------------------------

def _cold_sibling(router):
    with router._lock:
        owner_addr = [e.replica_address for e in router._journal.values()
                      if e.replica_address][-1]
        return next(r for r in router._replicas
                    if r.address != owner_addr)


def test_warm_import_on_affinity_miss(fleet, ref):
    router, reps = fleet()
    assert all(r["kv_capable"] for r in router.replica_status())
    prompt = PROMPTS[0] + [2, 0]
    want = ref(prompt, 6)
    assert RouterClient(router.address).generate(prompt, 6)[
        "tokens"] == want
    other = _cold_sibling(router)
    before = router.stats["kv_transfers"]
    entry = router._journal_entry(list(prompt), {"max_new_tokens": 6})
    router._maybe_kv_transfer(entry, other)
    assert router.stats["kv_transfers"] == before + 1
    assert router.stats["kv_transferred_tokens"] > 0
    res = GatewayClient(other.address).generate(prompt, 6)
    assert res["tokens"] == want
    assert res["prefix_tokens_reused"] >= len(prompt) - 1
    entry2 = router._journal_entry(list(prompt), {"max_new_tokens": 6})
    router._maybe_kv_transfer(entry2, other)
    assert router.stats["kv_transfers"] == before + 1
    assert "serving_kv_transfer_s_bucket" in router.fleet_metrics_text()


def test_truncated_payload_falls_back_to_recompute(fleet, ref):
    router, reps = fleet()
    prompt = PROMPTS[3] + [5, 3]
    want = ref(prompt, 6)
    assert RouterClient(router.address).generate(prompt, 6)[
        "tokens"] == want
    orig = router._fetch_kv_payload
    router._fetch_kv_payload = (
        lambda donor, p: (orig(donor, p) or b"")[:11] or None)
    other = _cold_sibling(router)
    entry = router._journal_entry(list(prompt), {"max_new_tokens": 6})
    router._maybe_kv_transfer(entry, other)
    assert router.stats["kv_transfers"] == 0
    assert router.stats["kv_transfer_failures"] >= 1
    res = GatewayClient(other.address).generate(prompt, 6)
    assert res["tokens"] == want
    assert res["prefix_tokens_reused"] == 0


# -- fleet observability against JAX's router ----------------------------

def _obs_fleet(pkg, net):
    """Two replicas with a tenant table behind a manual router of one
    package, three requests through it (two tenants), ticked so the
    metrics, clocks and trace windows are scraped."""
    if pkg == "jax":
        reg = JTenantRegistry((JTenantSpec("premium", priority=2),))
        reps = [gated_replica(net, f"rep-{i}", engine_cls=JEngine,
                              replica_cls=JLocalReplica, tenants=reg)
                for i in range(2)]
        router = JRouter([r.address for r in reps],
                         affinity_block_tokens=AFFINITY,
                         metrics_every=1)
        router._service.start()
        client = JRouterClient(router.address, timeout_s=120.0)
    else:
        reg = TenantRegistry((TenantSpec("premium", priority=2),))
        reps = [gated_replica(net, f"rep-{i}", tenants=reg)
                for i in range(2)]
        router = manual_router([r.address for r in reps],
                               metrics_every=1)
        client = RouterClient(router.address, timeout_s=120.0)
    tick(router)
    for i, p in enumerate(PROMPTS[:3]):
        client.generate(p, 6, tenant="premium" if i % 2 else None)
    tick(router)
    return router, reps, client


def _lanes(doc):
    return sorted(e["args"]["name"] for e in doc["traceEvents"]
                  if e.get("name") == "process_name")


@pytest.fixture(scope="module")
def obs(zip_path, tnet):
    built = {"jax": _obs_fleet("jax", j_restore_model(zip_path)),
             "torch": _obs_fleet("torch", tnet)}
    yield built
    for router, reps, _ in built.values():
        close_all(router, reps)


def test_fleet_metrics_have_jax_families(obs):
    parsed = {}
    for pkg, (router, _, client) in obs.items():
        text = client.fleet_metrics()
        assert 'serving_e2e_s_bucket{replica="rep-0"' in text
        assert "router_replay_gap_s_bucket" in text
        parsed[pkg] = (parse_exposition(text) if pkg == "torch"
                       else j_parse_exposition(text))
    t, j = parsed["torch"], parsed["jax"]
    assert set(t["histograms"]) == set(j["histograms"]) - JAX_ONLY
    assert set(t) == set(j)
    for kind in t:
        if kind != "histograms" and isinstance(t[kind], dict):
            assert set(t[kind]) == set(j[kind]) - JAX_ONLY, kind
    ttft_t = t["histograms"]["serving_ttft_s"]
    ttft_j = j["histograms"]["serving_ttft_s"]
    assert ttft_t["count"] == ttft_j["count"] == 3
    assert set(ttft_t.get("labeled", {})) == set(ttft_j.get("labeled", {}))


def test_stitched_trace_has_jax_lanes(obs):
    docs = {pkg: client.trace_events()
            for pkg, (_, _, client) in obs.items()}
    assert _lanes(docs["torch"]) == _lanes(docs["jax"]) == [
        "replica rep-0", "replica rep-1", "router"]
    names = {pkg: {e.get("name") for e in doc["traceEvents"]
                   if e.get("pid") == 0}
             for pkg, doc in docs.items()}
    assert names["torch"] == names["jax"]
    assert {"router.route", "router.queue_wait", "fleet.stitch"} \
        <= names["torch"]
    stitch = next(e for e in docs["torch"]["traceEvents"]
                  if e.get("name") == "fleet.stitch")
    info = stitch["args"]["replicas"]
    assert [r["lane"] for r in info] == [1, 2]
    assert all(r["skew_corrected"] and r["source"] == "live"
               for r in info)


def test_latency_report_reads_the_port_router(obs):
    reports = {pkg: (run_tenant_report(router.address),
                     run_fleet_report(router.address))
               for pkg, (router, _, _) in obs.items()}
    (t_ten, t_fleet), (j_ten, j_fleet) = reports["torch"], reports["jax"]
    assert set(t_ten["tenants"]) == set(j_ten["tenants"]) >= {"premium"}
    for tid, rows in t_ten["tenants"].items():
        assert [(r["phase"], r["count"]) for r in rows] == [
            (r["phase"], r["count"]) for r in j_ten["tenants"][tid]]
    assert [(r["phase"], r["count"]) for r in t_fleet["fleet"]] == [
        (r["phase"], r["count"]) for r in j_fleet["fleet"]]


# -- a mixed fleet: one JAX gateway, one port gateway --------------------

@pytest.mark.parametrize("victim", ["jax", "torch"])
def test_mixed_fleet_replays_across_packages(zip_path, tnet, ref, victim):
    jnet = j_restore_model(zip_path)
    reps = [gated_replica(jnet, "jax-0", engine_cls=JEngine,
                          replica_cls=JLocalReplica),
            gated_replica(tnet, "torch-0")]
    router = manual_router([r.address for r in reps])
    try:
        tick(router)
        want_id = {"jax": "jax-0", "torch": "torch-0"}[victim]
        prompt = next(
            p for p in ([(3 * i + j) % 12 for j in range(10)]
                        for i in range(40))
            if max(("jax-0", "torch-0"), key=lambda rid:
                   router._rendezvous_score(router._affinity_key(p),
                                            rid)) == want_id)
        want = ref(prompt, N_GEN)
        s, toks, events, killed = _kill_owner_mid_stream(
            router, reps, prompt, N_GEN)
        assert killed.replica_id == want_id
        assert toks == want == s.result["tokens"]
        assert s.result["finish_reason"] == "length"
        assert s.result["replays"] >= 1
        assert not _diverged(router, s.id)
        assert_event_ids_exact(toks, events)
    finally:
        close_all(router, reps)


def test_router_refuses_an_empty_fleet():
    with pytest.raises(ValueError, match="at least one replica"):
        ServingRouter([])
    with pytest.raises(ValueError, match="duplicate replica"):
        ServingRouter(["127.0.0.1:9", "http://127.0.0.1:9"])
