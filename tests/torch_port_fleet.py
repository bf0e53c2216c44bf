"""Helpers the port's fleet test modules share (``test_torch_port_router``
and ``test_torch_port_fleet``): the tiny LM zip JAX's ``write_model``
writes, the one engine configuration every replica runs, greedy
references from JAX's direct engine, a gate that holds a gateway's
stepping thread after a step budget (so a kill lands mid-stream on an
event, never on a sleep), a router whose health ticks the test drives
by hand, and an SSE reader that keeps each event's id."""

import contextlib
import threading
import time

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.util.model_serializer import (
    restore_model as j_restore_model,
)
from deeplearning4j_tpu.util.model_serializer import write_model

from deeplearning4j_tpu_torch.serving import (
    DecodeEngine,
    LocalReplica,
    ServingRouter,
)
from deeplearning4j_tpu_torch.util.model_serializer import restore_model
from chip_smoke import swap_head_classes  # noqa: F401 - the tests' too

V, WINDOW, NET_SEED = 12, 96, 11
#: every replica's engine (both packages): paged KV with a prefix trie
#: (so replicas speak the KV transfer plane) and chunked admission
ENGINE = dict(n_slots=2, decode_chunk=2, seed=0, paged_kv=True,
              block_tokens=4, prefix_cache_rows=4, prefill_chunk=4)
#: the router's affinity blocks match the replicas' KV blocks
AFFINITY = 4


def write_lm_zip(path) -> str:
    """A 2-layer, width-32, f32 ``transformer_lm`` written by JAX's
    ``write_model`` (seed 11 gives non-constant greedy streams)."""
    conf = jzoo.transformer_lm(n_in=V, width=32, n_layers=2, n_heads=4,
                               n_classes=V, seed=NET_SEED)
    for c in conf.confs:
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    write_model(JNet(conf).init(), str(path))
    return str(path)


class JaxReference:
    """Greedy ids of JAX's direct engine on the zip, cached per
    (prompt, n). One engine serves every call (its compiled programs
    are reused); a batch of requests runs in one ``run()``."""

    def __init__(self, zip_path: str):
        self.net = j_restore_model(zip_path)
        self.engine = JEngine(self.net, **ENGINE)
        self._cache = {}

    def many(self, cases):
        todo = [(tuple(p), int(n)) for p, n in cases
                if (tuple(p), int(n)) not in self._cache]
        if todo:
            rids = [self.engine.submit(JRequest(list(p), n))
                    for p, n in todo]
            res = self.engine.run()
            for key, rid in zip(todo, rids):
                self._cache[key] = [int(t) for t in res[rid].tokens]
        return [self._cache[(tuple(p), int(n))] for p, n in cases]

    def __call__(self, prompt, n):
        return self.many([(prompt, n)])[0]


def port_net(zip_path: str, swap=None):
    """The port's net from the zip on the CPU; ``swap=(a, b)`` swaps the
    output head's weights of classes a and b (a survivor that computes
    a different function from the same zip)."""
    net = restore_model(zip_path, device="cpu")
    if swap is not None:
        swap_head_classes(net, *swap)
    return net


class Gate:
    """Holds a gateway's stepping thread: after ``hold_after(n)`` the
    engine runs n more steps, then the gateway pauses (its loop waits on
    its condition without the lock, so submits, healthz and
    ``hard_kill`` still get through) and ``held`` is set. ``release()``
    resumes it. Works on either package's gateway."""

    def __init__(self, gw):
        self.gw = gw
        self.budget = None
        self.steps = 0
        self.held = threading.Event()
        orig = gw.engine.step

        def step(sink=None):
            out = orig(sink)
            self.steps += 1
            if self.budget is not None:
                self.budget -= 1
                if self.budget <= 0:
                    self.budget = None
                    gw._paused = True
                    self.held.set()
            return out

        gw.engine.step = step

    def hold_after(self, n: int) -> None:
        with self.gw._engine_access():
            self.held.clear()
            if n <= 0:
                self.budget = None
                self.gw._paused = True
                self.held.set()
            else:
                self.budget = n

    def release(self) -> None:
        with self.gw._engine_access():
            self.budget = None
            self.gw._paused = False
            self.gw._wake.notify_all()


def gated_replica(net, replica_id, engine_cls=DecodeEngine,
                  replica_cls=LocalReplica, **engine_kwargs):
    """One in-process replica (either package's, by the classes passed)
    with a :class:`Gate` on its gateway as ``rep.gate``."""
    cfg = dict(ENGINE, **engine_kwargs)
    rep = replica_cls(engine_cls(net, **cfg), replica_id=replica_id)
    rep.gate = Gate(rep.gw)
    return rep


def manual_router(addresses, **kw) -> ServingRouter:
    """A port router serving HTTP with NO health thread: the test
    drives health ticks and breaker probes through :func:`tick`."""
    kw.setdefault("affinity_block_tokens", AFFINITY)
    kw.setdefault("failure_threshold", 2)
    router = ServingRouter(list(addresses), **kw)
    router._service.start()
    return router


def tick(router, metrics: bool = True, probe: bool = False) -> None:
    """One health tick over every replica (the health loop's body);
    ``probe`` makes a dead replica's half-open probe due now."""
    for r in list(router._replicas):
        if probe:
            r.next_probe_t = 0.0
        router._check_replica(r, scrape_metrics=metrics)
    router._wal_flush()


def owner_of(router, replicas, rid):
    """The replica handle currently serving router request ``rid``."""
    addr = router._journal[rid].replica_address
    return next(r for r in replicas if r.address == addr)


def read_stream(stream, after_first=None):
    """Drain a router/gateway SSE stream: ``(tokens, events)`` where
    ``events[i]`` is ``(SSE id committed with delta i, tokens delivered
    through delta i)``. ``after_first()`` runs once the first delta is
    in."""
    tokens, events = [], []
    for delta in stream:
        tokens.extend(delta)
        events.append((stream.last_event_id, len(tokens)))
        if after_first is not None and len(events) == 1:
            after_first()
    return tokens, events


def assert_event_ids_exact(tokens, events) -> None:
    """Each event's id is the count of tokens delivered through it: the
    ids rise strictly, none repeats, no token goes without one, and the
    last is the token count."""
    assert events, "no delta arrived"
    assert all(eid == count for eid, count in events), events
    ids = [eid for eid, _ in events]
    assert ids == sorted(set(ids)), ids
    assert ids[-1] == len(tokens)


def wait_for(cond, timeout=60.0, msg="condition"):
    """Poll ``cond`` until true; a generous timeout only bounds a hang
    (no outcome depends on how long it takes)."""
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.005)


def close_all(router=None, replicas=()) -> None:
    if router is not None:
        with contextlib.suppress(Exception):
            router.close()
    for r in replicas:
        with contextlib.suppress(Exception):
            r.gate.release()
        with contextlib.suppress(Exception):
            r.shutdown()
