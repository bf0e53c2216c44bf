"""The PyTorch port's fleet controller, replica handles and ``route`` /
``fleet`` subcommands against the JAX package's.

``FleetController.decide`` (a pure function of the signals and the
controller's streak and cooldown state) and the windowed TTFT p99
answer what JAX's answer on tables of synthetic signals and scrapes.
``scale_up`` / ``scale_down`` and ``rolling_upgrade`` run over the
port's ``LocalReplica`` factory; the upgrade runs while greedy streams
are held mid-flight on the old replicas, and loses and duplicates
nothing. ``router_from_args`` / ``fleet_from_args`` build the router
and the child argv (``python -m deeplearning4j_tpu_torch.cli serve``
with ``--device``); ``--tp 2`` still exits naming its ROADMAP item. One
real ``ReplicaProcess`` (the ``serve`` subcommand on the CPU, its engine
held after a step budget so the kill lands mid-stream) is SIGKILLed
behind the router and its stream replayed on an in-process replica.

Controller evaluations are called, never left to the control loop's
timer; waits poll a condition under a generous bound."""

import os
import signal
import sys
import threading

import pytest

from deeplearning4j_tpu.cli.driver import (
    _serve_child_argv as j_serve_child_argv,
)
from deeplearning4j_tpu.cli.driver import build_parser as j_build_parser
from deeplearning4j_tpu.profiler.tracer import Histogram as JHistogram
from deeplearning4j_tpu.profiler.tracer import Tracer as JTracer
from deeplearning4j_tpu.serving import FleetController as JController

from deeplearning4j_tpu_torch.cli import driver
from deeplearning4j_tpu_torch.profiler.tracer import Histogram, Tracer
from deeplearning4j_tpu_torch.serving import (
    DecodeEngine,
    FleetController,
    ReplicaProcess,
    RouterClient,
    ServingRouter,
)
from deeplearning4j_tpu_torch.serving import replica_proc
from deeplearning4j_tpu_torch.serving.replica_proc import free_port
from torch_port_fleet import (
    ENGINE,
    JaxReference,
    assert_event_ids_exact,
    close_all,
    gated_replica,
    manual_router,
    port_net,
    read_stream,
    tick,
    wait_for,
    write_lm_zip,
)
from torch_port_threads import one_torch_thread  # noqa: F401

PROMPTS = [[1, 4, 7, 2, 5, 9, 3, 3, 1, 6], [9, 3, 3, 5],
           [5, 2, 8, 1, 6, 0, 4, 2, 2, 7, 1], [3, 1, 4, 1, 5, 9, 2, 6]]
N_GEN = 24
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    return write_lm_zip(tmp_path_factory.mktemp("fleet") / "lm.zip")


@pytest.fixture(scope="module")
def ref(zip_path):
    r = JaxReference(zip_path)
    r.many([(p, N_GEN) for p in PROMPTS])
    return r


@pytest.fixture(scope="module")
def tnet(zip_path):
    return port_net(zip_path)


# -- the decision layer --------------------------------------------------

class _StubRouter:
    """Just enough router for the decision layer: a tracer, an empty
    status and a queue of federated scrapes."""

    def __init__(self, tracer, texts=()):
        self.tracer = tracer
        self.health_interval_s = 0.1
        self._texts = list(texts)

    def replica_status(self):
        return []

    def fleet_metrics_text(self):
        return self._texts.pop(0) if self._texts else ""


def _controllers(texts=(), **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 3)
    kw.setdefault("breach_evals", 2)
    kw.setdefault("idle_evals", 3)
    kw.setdefault("cooldown_s", 5.0)
    return (FleetController(_StubRouter(Tracer(), texts), **kw),
            JController(_StubRouter(JTracer(), texts), **kw))


def _sig(n_live=1, pressure=0.5, ttft=None):
    return {"n_live": n_live, "n_registered": n_live,
            "slots": 3 * n_live, "inflight": 0, "queued": 0,
            "pressure": pressure, "ttft_p99_s": ttft,
            "ttft_window_n": 0}


#: (controller kwargs, steps); a step is (signal, now), or
#: ("cooldown", t) for what a scale event sets, or ("recovery", t) for
#: an up-scale whose breach has not cleared yet
SCENARIOS = {
    "breach_streak": ({}, [(_sig(pressure=5.0), 0.0),
                           (_sig(pressure=5.0), 0.1)]),
    "spike_resets_streak": ({}, [(_sig(pressure=5.0), 0.0),
                                 (_sig(pressure=1.0), 0.1),
                                 (_sig(pressure=5.0), 0.2),
                                 (_sig(pressure=5.0), 0.3)]),
    "ttft_slo": ({"ttft_p99_slo_s": 0.5},
                 [(_sig(pressure=0.5, ttft=1.2), 0.0),
                  (_sig(pressure=0.5, ttft=1.2), 0.1),
                  (_sig(pressure=0.5, ttft=0.2), 0.2)]),
    "hysteresis_band": ({}, [(_sig(n_live=2, pressure=1.0), 0.1 * i)
                             for i in range(20)]),
    "idle_streak": ({"idle_evals": 3},
                    [(_sig(n_live=2, pressure=0.1), 0.1 * i)
                     for i in range(4)]),
    "idle_at_min": ({}, [(_sig(n_live=1, pressure=0.1), 0.1 * i)
                         for i in range(6)]),
    "cooldown": ({"cooldown_s": 5.0},
                 [(_sig(pressure=5.0), 0.0), (_sig(pressure=5.0), 0.1),
                  ("cooldown", 5.1), (_sig(pressure=5.0), 1.0),
                  (_sig(pressure=5.0), 5.2)]),
    "max_bound": ({"max_replicas": 2},
                  [(_sig(n_live=2, pressure=9.0), 0.1 * i)
                   for i in range(5)]),
    "alternating_burst": ({}, [(_sig(n_live=2,
                                     pressure=5.0 if i % 2 else 0.05),
                                0.1 * i) for i in range(30)]),
    "recovery_stamp": ({}, [("recovery", 10.0),
                            (_sig(pressure=5.0), 11.0),
                            (_sig(pressure=0.5), 12.5)]),
    "breach_then_idle": ({"idle_evals": 2, "cooldown_s": 0.5},
                         [(_sig(n_live=2, pressure=3.0), 0.0),
                          (_sig(n_live=2, pressure=3.0), 0.1),
                          ("cooldown", 0.6),
                          (_sig(n_live=3, pressure=0.1), 0.3),
                          (_sig(n_live=3, pressure=0.1), 0.7),
                          (_sig(n_live=3, pressure=0.1), 0.8)]),
}


def _run(ctl, steps):
    out, stamped = [], []
    for sig, now in steps:
        if sig == "cooldown":
            ctl._cooldown_until = now
            continue
        if sig == "recovery":
            ev = {"action": "up"}
            stamped.append(ev)
            ctl._pending_recovery = (ev, now)
            continue
        action = ctl.decide(dict(sig), now=now)
        out.append((action, dict(ctl.last_signals), ctl._reason,
                    ctl._breach_streak, ctl._idle_streak))
    return out, stamped


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decide_matches_jax(name):
    kw, steps = SCENARIOS[name]
    port, jax_ctl = _controllers(**kw)
    got, want = _run(port, steps), _run(jax_ctl, steps)
    assert got == want
    actions = [a for a, *_ in got[0]]
    if name in ("breach_streak", "ttft_slo"):
        assert actions[1] == "up"
    if name in ("hysteresis_band", "idle_at_min", "max_bound",
                "alternating_burst"):
        assert not any(actions)
    if name == "recovery_stamp":
        assert got[1][0]["recovered_after_s"] == pytest.approx(2.5)


def _texts(hist_cls, batches, tenant=None):
    h, texts = hist_cls(), []
    for batch in batches:
        for value, n in batch:
            h.observe(value, n)
        name = ("serving_ttft_s" if tenant is None
                else f'serving_ttft_s{{tenant="{tenant}"}}')
        lines = "\n".join(h.prometheus_lines(name)) + "\n"
        if tenant is not None:
            lines = ("\n".join(hist_cls().prometheus_lines(
                "serving_ttft_s")) + "\n" + lines)
        texts.append(lines)
    return texts


@pytest.mark.parametrize("case", ["window", "regression", "tenant"])
def test_window_ttft_p99_matches_jax(case):
    batches = {"window": [[(0.001, 1000)], [(10.0, 100)],
                          [(0.001, 100)], []],
               "regression": [[(0.1, 5)], [], [(0.1, 1)]],
               "tenant": [[(0.002, 10)], [(3.0, 20)], [(0.01, 5)]]}[case]
    tenant = "premium" if case == "tenant" else None
    if case == "regression":
        full = _texts(Histogram, [[(0.1, 5)]])[0]
        texts = [full, full, _texts(Histogram, [[(0.1, 2)]])[0]]
    else:
        texts = _texts(Histogram, batches, tenant)
        assert texts == _texts(JHistogram, batches, tenant)
    kw = {"ttft_p99_slo_s": 0.5, "slo_tenant": tenant}
    port, jax_ctl = _controllers(texts=texts, **kw)
    got = [port._window_ttft_p99() for _ in texts]
    want = [jax_ctl._window_ttft_p99() for _ in texts]
    assert got == want
    assert got[0] == (None, 0)
    if case == "window":
        assert got[1] == (pytest.approx(10.0), 100)


def test_bad_bounds_rejected():
    for kw in ({"min_replicas": 0}, {"max_replicas": 1,
                                     "min_replicas": 2},
               {"pressure_high": 0.2, "pressure_low": 0.5}):
        with pytest.raises(ValueError):
            FleetController(_StubRouter(Tracer()), **kw)


# -- scale actions and the rolling upgrade over LocalReplicas ------------

def _factory(tnet, made):
    def factory(rid):
        rep = gated_replica(tnet, rid)
        made.append(rep)
        return rep
    return factory


def test_scale_up_then_down(tnet, ref):
    made = []
    factory = _factory(tnet, made)
    seed = factory("seed-0")
    router = ServingRouter([seed.address], affinity_block_tokens=4,
                           health_interval_s=0.05).start()
    ctl = FleetController(router, factory, min_replicas=1,
                          max_replicas=3, cooldown_s=0.0)
    ctl.adopt(seed)
    try:
        client = RouterClient(router.address, timeout_s=120.0)
        prompt = PROMPTS[3]
        first = client.generate(prompt, 6)
        assert first["tokens"] == ref(prompt, 6)
        new_id = ctl.scale_up(reason="test")
        assert new_id in [s["replica_id"] for s in router.replica_status()
                          if s["state"] == "live"]
        up = ctl.events[-1]
        assert up["action"] == "up" and up["n_live"] == 2
        assert up["warmed"] >= 1  # the transfer / warmup handshake
        assert client.generate(prompt, 6)["tokens"] == first["tokens"]
        drained = ctl.scale_down(reason="test")
        assert drained is not None and ctl.events[-1]["action"] == "down"
        live = [s for s in router.replica_status()
                if s["state"] in ("live", "degraded")]
        assert len(live) == 1
        assert client.generate(prompt, 6)["tokens"] == first["tokens"]
        actions = [(e.get("args") or {}).get("action")
                   for e in router.tracer.events()
                   if e.get("name") == "fleet.scale"]
        assert "up" in actions and "down" in actions
        assert ctl.scale_down(reason="test") is None  # at min_replicas
        with pytest.raises(RuntimeError):
            FleetController(router, None).scale_up(reason="test")
    finally:
        ctl.close()
        router.close()
        ctl.shutdown_fleet()
        close_all(None, made)


def test_rolling_upgrade_under_greedy_streams(tnet, ref):
    """Both seed replicas hold their streams mid-flight (their gates),
    the upgrade replaces them one at a time, each drain hands its
    streams to a replica of the new generation, and every stream ends
    ``length`` with JAX's ids and exact event ids."""
    made = []
    factory = _factory(tnet, made)
    seeds = [factory(f"seed-{i}") for i in range(2)]
    router = ServingRouter([s.address for s in seeds],
                           affinity_block_tokens=4,
                           health_interval_s=0.05).start()
    ctl = FleetController(router, factory, min_replicas=1,
                          max_replicas=4, cooldown_s=0.0,
                          drain_timeout_s=0.2, id_prefix="gen2")
    for s in seeds:
        ctl.adopt(s)
    try:
        wait_for(lambda: {r["replica_id"] for r in
                          router.replica_status()} == {"seed-0",
                                                       "seed-1"},
                 msg="router to learn the seed ids")
        for s in seeds:
            s.gate.hold_after(10)
        client = RouterClient(router.address, timeout_s=120.0)
        streams, results = [], {}
        for p in PROMPTS:
            streams.append((p, client.stream(p, N_GEN)))

        def drain(i, p, s):
            results[i] = read_stream(s)

        threads = [threading.Thread(target=drain, args=(i, p, s))
                   for i, (p, s) in enumerate(streams)]
        for t in threads:
            t.start()
        wait_for(lambda: all(router._journal[s.id].tokens
                             for _, s in streams),
                 msg="every stream to deliver a token")
        summary = ctl.rolling_upgrade()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert summary["upgraded"] == 2
        assert summary["replaced"] == ["seed-0", "seed-1"]
        for i, (p, s) in enumerate(streams):
            toks, events = results[i]
            assert toks == ref(p, N_GEN) == s.result["tokens"], i
            assert s.result["finish_reason"] == "length"
            assert_event_ids_exact(toks, events)
        audit = router.journal_audit()
        assert audit["lost"] == [] and audit["open"] == []
        assert audit["replayed"]  # the drains handed streams over
        assert not any(s.alive for s in seeds)
        doc = client.trace_events()
        ups = [e for e in doc["traceEvents"]
               if e.get("name") == "fleet.scale"]
        assert [e["args"]["action"] for e in ups] == ["upgrade"] * 2
        live = {s["replica_id"] for s in router.replica_status()
                if s["state"] == "live"}
        assert live == {"gen2-0", "gen2-1"}
    finally:
        ctl.close()
        router.close()
        ctl.shutdown_fleet()
        close_all(None, made)


# -- the CLI -------------------------------------------------------------

def test_route_cli_builds_the_router(tmp_path):
    args = driver.build_parser().parse_args(
        ["route", "--replicas", "127.0.0.1:9001, 127.0.0.1:9002",
         "--port", "0", "--affinity-block-tokens", "8",
         "--failure-threshold", "5", "--max-replays", "2",
         "--journal-path", str(tmp_path / "r.wal"), "--fsync", "off",
         "--tenant", "premium:rps=5:burst=2"])
    router = driver.router_from_args(args)
    try:
        assert [r.address for r in router._replicas] == [
            "127.0.0.1:9001", "127.0.0.1:9002"]
        assert (router.affinity_block_tokens, router.failure_threshold,
                router.max_replays) == (8, 5, 2)
        assert router._wal is not None and router._wal.fsync == "off"
        assert router.tenants.spec_of("premium").rate_rps == 5
    finally:
        router._service._httpd.server_close()
        router._wal.close()


class _FakeProcess:
    """Stands in for ``ReplicaProcess`` in ``fleet_from_args``: records
    the argv and boots at once (or fails to, for ``fail_id``)."""

    made = []
    fail_id = None

    def __init__(self, argv, replica_id, port, ready_pattern="READY"):
        self.argv, self.replica_id = list(argv), replica_id
        self.address = f"127.0.0.1:{port}"
        self.ready_pattern = ready_pattern
        self.alive = True
        _FakeProcess.made.append(self)

    def wait_ready(self, timeout_s=120.0):
        if self.replica_id == _FakeProcess.fail_id:
            raise RuntimeError("never became ready")

    def shutdown(self):
        self.alive = False


@pytest.fixture
def fake_process(monkeypatch):
    _FakeProcess.made, _FakeProcess.fail_id = [], None
    monkeypatch.setattr(replica_proc, "ReplicaProcess", _FakeProcess)
    return _FakeProcess


FLEET_ARGS = ["fleet", "--model", "m.zip", "--replicas", "2", "--port",
              "0", "--paged-kv", "--kv-blocks", "64",
              "--kv-disk-tier-path", "tiers", "--kv-host-tier-bytes",
              "4096", "--use-flash-paged", "on", "--fused-rounds", "4",
              "--tenant", "premium:priority=2", "--prefix-cache-rows",
              "4"]


@pytest.mark.parametrize("device", [None, "cpu"])
def test_fleet_cli_child_argv(fake_process, device):
    argv = FLEET_ARGS + ([] if device is None else ["--device", device])
    args = driver.build_parser().parse_args(argv)
    seeds, router, ctl = driver.fleet_from_args(args)
    try:
        assert [s.replica_id for s in seeds] == ["fleet-0", "fleet-1"]
        assert all(s.ready_pattern == "serving on" for s in seeds)
        child = seeds[0].argv
        assert child[:4] == [sys.executable, "-m",
                             "deeplearning4j_tpu_torch.cli", "serve"]
        assert child[child.index("--device") + 1] == (device or "cuda")
        assert child[child.index("--kv-disk-tier-path") + 1] == \
            os.path.join("tiers", "fleet-0")
        # the rest is JAX's child argv, flag for flag
        jargs = j_build_parser().parse_args(FLEET_ARGS)
        port = int(child[child.index("--port") + 1])
        want = j_serve_child_argv(jargs, port, "fleet-0")
        i = child.index("--device")
        assert child[4:i] + child[i + 2:] == want[4:]
        assert sorted(ctl._handles) == ["fleet-0", "fleet-1"]
        assert ctl.id_prefix == "fleet-auto"
    finally:
        router._service._httpd.server_close()


def test_fleet_cli_reaps_every_seed_on_a_failed_boot(fake_process):
    fake_process.fail_id = "fleet-1"
    args = driver.build_parser().parse_args(FLEET_ARGS
                                            + ["--replicas", "3"])
    with pytest.raises(RuntimeError, match="never became ready"):
        driver.fleet_from_args(args)
    assert len(fake_process.made) == 3
    assert not any(p.alive for p in fake_process.made)


def test_tp_2_still_refused_naming_item_11(fake_process, tmp_path):
    args = driver.build_parser().parse_args(FLEET_ARGS + ["--tp", "2"])
    with pytest.raises(SystemExit, match="ROADMAP item 11"):
        driver.fleet_from_args(args)
    assert fake_process.made == []  # refused before any child
    serve = driver.build_parser().parse_args(
        ["serve", "--model", str(tmp_path / "absent.zip"), "--tp", "2"])
    with pytest.raises(SystemExit, match="ROADMAP item 11"):
        driver.gateway_from_args(serve)
    with pytest.raises(NotImplementedError, match="tp=2"):
        DecodeEngine(None, tp=2)


# -- one real subprocess replica ------------------------------------------

#: runs the port's ``serve`` subcommand with every engine step counted:
#: past the budget (argv[1]) the stepping thread waits forever, so the
#: stream it serves is in flight when the test kills the process
_HELD_SERVE = (
    "import sys, threading\n"
    "from deeplearning4j_tpu_torch.serving import engine\n"
    "from deeplearning4j_tpu_torch.cli import driver\n"
    "budget = [int(sys.argv[1])]\n"
    "step = engine.DecodeEngine.step\n"
    "def held(self, sink=None):\n"
    "    if budget[0] <= 0:\n"
    "        threading.Event().wait()\n"
    "    budget[0] -= 1\n"
    "    return step(self, sink)\n"
    "engine.DecodeEngine.step = held\n"
    "sys.exit(driver.main(sys.argv[2:]))\n")


def test_subprocess_replica_sigkilled_and_replayed(zip_path, tnet, ref):
    port = free_port()
    prompt = PROMPTS[0]
    budget = -(-len(prompt) // ENGINE["prefill_chunk"]) + 3
    argv = [sys.executable, "-c", _HELD_SERVE, str(budget), "serve",
            "--model", zip_path, "--device", "cpu", "--port", str(port),
            "--replica-id", "proc-0", "--slots", "2",
            "--decode-chunk", "2", "--paged-kv", "--block-tokens", "4",
            "--prefix-cache-rows", "4", "--prefill-chunk", "4"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = ReplicaProcess(argv, replica_id="proc-0", port=port,
                          ready_pattern="serving on", env=env, cwd=ROOT)
    local = gated_replica(tnet, "local-0")
    router = None
    try:
        proc.wait_ready(timeout_s=120.0)
        router = manual_router([proc.address, local.address])
        tick(router)
        assert {r["replica_id"] for r in router.replica_status()} == {
            "proc-0", "local-0"}
        key = router._affinity_key(prompt)
        owner = max(("proc-0", "local-0"),
                    key=lambda r: router._rendezvous_score(key, r))
        if owner != "proc-0":  # make the process the affinity owner
            prompt = next(
                p for p in ([(5 * i + j) % 12 for j in range(10)]
                            for i in range(60))
                if max(("proc-0", "local-0"), key=lambda r:
                       router._rendezvous_score(
                           router._affinity_key(p), r)) == "proc-0")
        s = RouterClient(router.address, timeout_s=120.0).stream(
            prompt, N_GEN)
        killed = []

        def kill():
            assert router._journal[s.id].replica_address == proc.address
            proc.sigkill()
            killed.append(proc.proc.returncode)

        toks, events = read_stream(s, after_first=kill)
        assert killed == [-signal.SIGKILL]
        assert toks == ref(prompt, N_GEN) == s.result["tokens"]
        assert s.result["finish_reason"] == "length"
        assert s.result["replays"] >= 1
        assert_event_ids_exact(toks, events)
        tick(router)
        state = {r["replica_id"]: r["state"]
                 for r in router.replica_status()}
        assert state["proc-0"] == "dead" and state["local-0"] == "live"
    finally:
        close_all(router, [local])
        replica_proc.shutdown_all([proc])
        assert not proc.alive


#: the port's ``serve`` subcommand whose engine step fails, as a kernel
#: that cannot launch would
_FAILING_SERVE = (
    "import sys\n"
    "from deeplearning4j_tpu_torch.serving import engine\n"
    "from deeplearning4j_tpu_torch.cli import driver\n"
    "def failing(self, sink=None):\n"
    "    raise RuntimeError('paged attention kernel launch failed')\n"
    "engine.DecodeEngine.step = failing\n"
    "sys.exit(driver.main(sys.argv[1:]))\n")


def test_serve_child_exits_non_zero_when_its_stepping_thread_dies(
        zip_path, tnet, ref):
    """A replica whose engine cannot step exits non-zero instead of
    serving requests that never finish; behind the router its request
    is replayed on the survivor. On the CPU it builds no kernel."""
    port = free_port()
    argv = [sys.executable, "-c", _FAILING_SERVE, "serve", "--model",
            zip_path, "--device", "cpu", "--port", str(port),
            "--replica-id", "broken", "--paged-kv", "--block-tokens", "4",
            "--prefix-cache-rows", "4"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = ReplicaProcess(argv, replica_id="broken", port=port,
                          ready_pattern="serving on", env=env, cwd=ROOT)
    local = gated_replica(tnet, "local-0")
    router = None
    try:
        proc.wait_ready(timeout_s=120.0)
        assert proc.boot_lines == []  # no kernel on the CPU
        router = manual_router([proc.address, local.address])
        tick(router)
        prompt = next(
            p for p in ([(5 * i + j) % 12 for j in range(8)]
                        for i in range(60))
            if max(("broken", "local-0"), key=lambda r:
                   router._rendezvous_score(router._affinity_key(p), r))
            == "broken")
        out = RouterClient(router.address, timeout_s=120.0).generate(
            prompt, 6)
        assert out["tokens"] == ref(prompt, 6)
        assert out["replays"] >= 1
        assert proc.proc.wait(timeout=60) == 1
    finally:
        close_all(router, [local])
        replica_proc.shutdown_all([proc])


def test_build_kernels_for_a_cpu_engine_builds_nothing(tnet):
    from deeplearning4j_tpu_torch.serving import ServingGateway

    gw = ServingGateway(DecodeEngine(tnet, **ENGINE))
    try:
        assert driver.build_kernels_for(gw) == {}
    finally:
        gw._service._httpd.server_close()
