"""The PyTorch port's serving gateway, client and ``serve`` CLI against
the JAX package's, on the wire.

One JAX-written model zip (``transformer_lm(n_in=12, width=32,
n_layers=2, n_heads=4)``, a 64-token window) is loaded into both
packages. For each configuration one JAX gateway and one port gateway
serve in process on 127.0.0.1 and run the same scripted workload, one
connection at a time where the bytes are compared:

- the SSE streams of the same greedy requests, sent one after another:
  the same event ids (delivered-token counts), the same deltas, the
  same concatenated tokens, the same terminal-event keys and values
  apart from ``ttft_s`` and ``timing``; the blocking endpoint, polls,
  ``/v1/requests/<id>/trace`` and ``/v1/trace`` alike;
- the status codes 200, 429 with ``Retry-After``, 499 (cancel), 504
  (a deadline on a ``ManualClock``), 503 (draining) and 404, with the
  same payload keys;
- the metric families and histogram names of both ``/v1/metrics``
  scrapes (``parse_exposition``), less the JAX engine's histogram of
  the feature the port refuses, and ``scripts/latency_report.py``
  reading the port's live gateway.

Port-only: concurrent streams against the in-process engine, the KV
transfer endpoints (through ``GatewayClient``: an export, its POST
twin, a declined and a malformed import), drain -> snapshot -> boot
through ``gateway_from_args`` with the port's parser, the CLI's
refusal of ``--tp`` and its tenancy and KV-tier flags reaching the
engine. Waits poll a condition
(``_wait_for``); no case asserts a time."""

import os
import threading
import time

import pytest

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.profiler.tracer import (
    parse_exposition as j_parse_exposition,
)
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.serving import GatewayClient as JClient
from deeplearning4j_tpu.serving import GatewayError as JGatewayError
from deeplearning4j_tpu.serving import ManualClock as JClock
from deeplearning4j_tpu.serving import ServingGateway as JGateway
from deeplearning4j_tpu.util.model_serializer import (
    restore_model as j_restore_model,
)
from deeplearning4j_tpu.util.model_serializer import write_model

from deeplearning4j_tpu_torch.cli.driver import (
    build_parser,
    gateway_from_args,
)
from deeplearning4j_tpu_torch.profiler.tracer import parse_exposition
from deeplearning4j_tpu_torch.serving import (
    ROLES,
    STATUS_OF_REASON,
    DecodeEngine,
    GatewayClient,
    GatewayError,
    ManualClock,
    Request,
    ServingGateway,
    WeightedFairScheduler,
    unpack_prefix,
)
from deeplearning4j_tpu_torch.util.model_serializer import (
    restore_model,
)
from deeplearning4j_tpu_torch.util.model_serializer import (
    write_model as t_write_model,
)
from scripts.latency_report import run_report
from torch_port_threads import one_torch_thread  # noqa: F401

V, WINDOW = 12, 64
PROMPTS = [[1, 4, 7, 2], [9, 3, 3], [5, 2, 8, 1, 6, 0, 4], [2, 2],
           [11, 0, 6]]
LENS = [6, 11, 4, 9, 13]
PLAIN = dict(n_slots=2, decode_chunk=3, seed=0)
BOUNDED = dict(n_slots=1, decode_chunk=2, seed=0, max_queue=1)
#: terminal fields whose values are wall times
TIMED = ("ttft_s", "timing")

_JNET = {}


def _wait_for(cond, timeout=30.0, interval=0.01, msg="condition"):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(interval)


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    conf = jzoo.transformer_lm(n_in=V, width=32, n_layers=2, n_heads=4,
                               n_classes=V, seed=7)
    for c in conf.confs:
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    path = str(tmp_path_factory.mktemp("gateway") / "lm.zip")
    write_model(JNet(conf).init(), path)
    return path


def _jnet(zip_path):
    if zip_path not in _JNET:
        _JNET[zip_path] = j_restore_model(zip_path)
    return _JNET[zip_path]


def _tnet(zip_path):
    return restore_model(zip_path, device="cpu")


class _Served:
    """One package's engine, gateway and client."""

    def __init__(self, pkg, zip_path, clock=None, **cfg):
        self.pkg = pkg
        if pkg == "jax":
            self.engine = JEngine(_jnet(zip_path), clock=clock, **cfg)
            self.gw = JGateway(self.engine, keepalive_s=0.1)
            self.client = JClient(self.gw.address, timeout_s=60.0)
            self.Error = JGatewayError
        else:
            self.engine = DecodeEngine(_tnet(zip_path), clock=clock, **cfg)
            self.gw = ServingGateway(self.engine, keepalive_s=0.1)
            self.client = GatewayClient(self.gw.address, timeout_s=60.0)
            self.Error = GatewayError
        self.gw.start()

    def close(self):
        self.gw.close()


def _served(request, pkg, zip_path, **kw):
    s = _Served(pkg, zip_path, **kw)
    request.addfinalizer(s.close)
    return s


#: the JAX engine's histogram of the feature the port refuses (tensor
#: parallelism: ROADMAP item 8), empty in a JAX scrape and absent from
#: the port's
JAX_ONLY = {"serving_tp_dispatch_s"}


def _strip(d):
    """A terminal or poll payload less its wall times (keys kept)."""
    return {k: (None if k in TIMED else v) for k, v in d.items()}


def _stream_events(s, prompt, n):
    """Every SSE data event of one stream with its event id, the
    terminal's wall-time values blanked."""
    st = s.client.stream(prompt, n)
    out = [(0, {"id": st.id})]
    for kind, event in st.raw_events():
        if kind == "event":
            out.append((st.last_event_id, _strip(event)))
    st.close()
    return out


def _plain_script(s):
    """The plain configuration's scripted workload: three sequential
    streams, two blocking generates, polls, traces and a scrape."""
    obs = {"streams": [_stream_events(s, PROMPTS[i], LENS[i])
                       for i in range(3)]}
    obs["blocking"] = [_strip(s.client.generate(PROMPTS[i], LENS[i]))
                       for i in (3, 4)]
    obs["poll"] = _strip(s.client.poll(0))
    with pytest.raises(s.Error) as err:
        s.client.poll(10_000)
    obs["poll_unknown"] = err.value.status
    trace = s.client.trace(1)
    obs["trace"] = (sorted(trace), trace["finish_reason"],
                    [[e["phase"] for e in a["events"]]
                     for a in trace["attempts"]])
    names = {e["name"] for e in s.client.trace_events()["traceEvents"]}
    obs["trace_events"] = sorted(names)
    obs["health"] = sorted(s.client.healthz())
    text = s.client.metrics()
    parsed = parse_exposition(text)
    obs["families"] = parsed["types"]
    obs["histograms"] = sorted(parsed["histograms"])
    obs["exposition_parses_alike"] = (j_parse_exposition(text) == parsed)
    obs["latency_report"] = [(r["phase"], r["count"])
                             for r in run_report(s.gw.address)]
    return obs


def test_plain_gateway_matches_jax_on_the_wire(request, zip_path):
    """Sequential SSE streams, the blocking endpoint, polls, traces,
    healthz and the metrics scrape of the plain configuration: the
    port's gateway answers what the JAX gateway answers."""
    want = _plain_script(_served(request, "jax", zip_path, **PLAIN))
    port = _served(request, "port", zip_path, **PLAIN)
    got = _plain_script(port)
    for i, (g, w) in enumerate(zip(got["streams"], want["streams"])):
        assert g == w, f"stream {i}"
        assert [eid for eid, _ in g][-1] == LENS[i]
        assert g[-1][1]["done"] and g[-1][1]["status"] == 200
    for key in ("blocking", "poll", "poll_unknown", "trace",
                "trace_events", "health", "latency_report"):
        assert got[key] == want[key], key
    # the families of the features both packages carry
    assert got["families"] == {k: v for k, v in want["families"].items()
                               if k not in JAX_ONLY}
    assert got["histograms"] == sorted(set(want["histograms"]) - JAX_ONLY)
    assert JAX_ONLY <= set(want["histograms"])
    assert got["poll_unknown"] == 404
    assert "serving.decode_chunk" in got["trace_events"]
    assert got["exposition_parses_alike"]
    assert {"serving_ttft_s", "serving_itl_s", "serving_e2e_s",
            "serving_queue_wait_s", "serving_round_s"} <= set(
                got["histograms"])
    assert dict(got["latency_report"])["ttft"] == 5
    assert port.engine.compile_counts()["decode"] == 0   # CPU: eager


def _bounded_script(s, clock):
    """429, 504, 499, 503 on the bounded configuration: one stream
    holds the only slot, a deadline-carrying request waits in the queue
    of one, a third is refused; the clock blows the deadline, the stream
    is cancelled, the gateway drains."""
    obs = {}
    st = s.client.stream([1, 4, 7, 2], 100_000)
    first = next(iter(st))
    assert first
    out = {}

    def queued():
        try:
            out["r"] = s.client.generate([9, 3, 3], 3, deadline_s=5.0)
        except s.Error as e:
            out["err"] = e

    t = threading.Thread(target=queued)
    t.start()
    _wait_for(lambda: s.engine.scheduler.pending == 1,
              msg="second request queued")
    with pytest.raises(s.Error) as err:
        s.client.generate([5, 2, 8], 3)
    obs["429"] = (err.value.status, sorted(err.value.payload),
                  err.value.retry_after_s >= 1)
    clock.advance(10.0)
    t.join(timeout=60)
    assert not t.is_alive()
    e = out["err"]
    obs["504"] = (e.status, _strip(e.payload))
    cancel = s.client.cancel(st.id)
    list(st)
    obs["499"] = (cancel, _strip(st.result))
    obs["poll_cancelled"] = _strip(s.client.poll(st.id))
    obs["drain"] = sorted(s.client.drain(timeout_s=5.0))
    with pytest.raises(s.Error) as err:
        s.client.generate([1, 2], 2)
    obs["503"] = (err.value.status, err.value.payload)
    obs["stats"] = {k: v for k, v in s.gw.stats.items()}
    obs["failures"] = {k: s.engine.stats[k] for k in (
        "deadline_expired", "cancelled", "shed")}
    for key in ("serving_gateway_429", "serving_deadline_expired",
                "serving_cancelled"):
        obs[key] = s.engine.tracer.latest_counters().get(key)
    return obs


def test_status_codes_match_jax(request, zip_path):
    """429 with Retry-After, 504 with the deadline's terminal, 499 on a
    cancelled stream (its final SSE event) and its poll, 503 while
    draining: the same codes, payload keys and counters in both."""
    jclock, tclock = JClock(), ManualClock()
    want = _bounded_script(_served(request, "jax", zip_path, clock=jclock,
                                   **BOUNDED), jclock)
    got = _bounded_script(_served(request, "port", zip_path, clock=tclock,
                                  **BOUNDED), tclock)
    assert got["429"] == want["429"] == (
        429, ["error", "retry_after_s"], True)
    assert got["504"][0] == 504
    assert got["504"][1]["finish_reason"] == "deadline"
    # the cancelled stream's token count depends on when the cancel
    # lands: compare the rest
    for key in ("499", "poll_cancelled"):
        g, w = (got[key][1] if key == "499" else got[key],
                want[key][1] if key == "499" else want[key])
        assert sorted(g) == sorted(w), key
        assert (g["status"], g["finish_reason"]) == (
            w["status"], w["finish_reason"]) == (499, "cancelled")
    assert got["499"][0]["cancelled"] and want["499"][0]["cancelled"]
    for key in ("504", "drain", "503", "stats", "failures",
                "serving_gateway_429", "serving_deadline_expired",
                "serving_cancelled"):
        assert got[key] == want[key], key
    assert got["503"][0] == 503


def test_concurrent_streams_match_the_in_process_engine(request,
                                                        zip_path):
    """Five streams at once over two slots: each client's concatenated
    deltas and terminal equal the in-process port engine's ids (the
    JAX ``test_concurrent_streams_bit_identical`` twin), and the
    gateway hands the engine back on close."""
    ref = DecodeEngine(_tnet(zip_path), **PLAIN)
    ids = [ref.submit(Request(list(p), n)) for p, n in zip(PROMPTS, LENS)]
    want = ref.run()
    s = _served(request, "port", zip_path, **PLAIN)
    outs = {}

    def one(i):
        st = s.client.stream(PROMPTS[i], LENS[i])
        toks = [t for d in st for t in d]
        outs[i] = (toks, st.result)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for i, rid in enumerate(ids):
        toks, result = outs[i]
        assert toks == result["tokens"] == want[rid].tokens
        assert result["status"] == STATUS_OF_REASON["length"]
    assert s.engine.on_delta is not None
    s.close()
    assert s.engine.on_delta is None
    assert ROLES == ("any", "prefill", "decode")


def _cli_args(model, snap, *extra):
    return build_parser().parse_args(
        ["serve", "--model", model, "--device", "cpu", "--port", "0",
         "--slots", "2", "--decode-chunk", "2", "--paged-kv",
         "--block-tokens", "8", "--prefix-cache-rows", "4",
         "--snapshot", snap, *extra])


def test_cli_serves_a_port_zip_drains_and_boots(tmp_path, zip_path):
    """``gateway_from_args`` over the port's parser serves a zip the
    port wrote: generate over HTTP equals the in-process engine, the KV
    transfer endpoints answer through ``GatewayClient`` (the GET and
    POST exports of the generated prompt's cached prefix are one
    payload, which the same engine imports as an entry of its own and
    then declines as already warm; a malformed frame is a 400), a drain
    with requests in flight writes the snapshot, and a second
    ``gateway_from_args`` boots from it and finishes the same ids."""
    model = str(tmp_path / "port.zip")
    t_write_model(_tnet(zip_path), model)
    snap = str(tmp_path / "serve.snap.json")
    cfg = dict(n_slots=2, decode_chunk=2, paged_kv=True, block_tokens=8,
               prefix_cache_rows=4)
    ref = DecodeEngine(restore_model(model, device="cpu"), **cfg)
    rids = [ref.submit(Request(list(p), n))
            for p, n in zip(PROMPTS[:3], [5, 60, 58])]
    want = ref.run()
    gw = gateway_from_args(_cli_args(model, snap)).start()
    try:
        client = GatewayClient(gw.address)
        out = client.generate(PROMPTS[0], 5)
        assert out["tokens"] == want[rids[0]].tokens
        assert client.healthz()["kv_transfer"] is True
        payload = client.kv_export([1, 4, 7])
        assert payload == client._kv_export_post([1, 4, 7])
        assert unpack_prefix(payload)["header"]["tokens"] == [1, 4]
        summary = {"prefix_len": 2, "tokens": 2, "blocks": 1}
        assert client.kv_import(payload) == dict(
            summary, imported=True, reason="imported")
        assert client.kv_import(payload) == dict(
            summary, imported=False, reason="already_warm")
        with pytest.raises(GatewayError) as err:
            client.kv_import(b"DKV1" + bytes(12))
        assert err.value.status == 400
        streams, started = {}, []

        def one(i):
            st = client.stream(PROMPTS[i], [5, 60, 58][i])
            started.append(st.id)
            toks = []
            try:
                for d in st:
                    toks.extend(d)
            except GatewayError:
                pass     # drained mid-stream: no terminal event
            streams[i] = (st.id, toks)

        threads = [threading.Thread(target=one, args=(i,)) for i in (1, 2)]
        for t in threads:
            t.start()
        _wait_for(lambda: len(started) == 2
                  and gw.engine.stats["tokens_generated"] >= 8,
                  msg="streams admitted")
        summary = client.drain(timeout_s=0.0)
        assert summary["snapshot"] == snap and summary["carried"] >= 1
    finally:
        gw.close()
    for t in threads:
        t.join(timeout=30)
    gw2 = gateway_from_args(_cli_args(model, snap)).start()
    try:
        assert os.path.exists(snap + ".restored")
        client = GatewayClient(gw2.address)
        for i in (1, 2):
            rid, toks = streams[i]
            want_toks = want[rids[i]].tokens
            if rid not in summary["carried_ids"]:
                assert toks == want_toks
                continue
            _wait_for(lambda r=rid: client.poll(r).get("finish_reason"),
                      msg=f"restored request {rid}")
            res = client.poll(rid)
            assert res["tokens"] == want_toks
            assert toks == want_toks[:len(toks)]
            trace = client.trace(rid)
            assert trace["attempts"][0]["events"][0]["phase"] == "restored"
    finally:
        gw2.close()


@pytest.mark.parametrize("flag,value,item", [
    ("--tp", "2", "ROADMAP item 8"), ("--tenant", "premium", "item 7b"),
    ("--kv-host-tier-bytes", "1024", "item 8"),
    ("--kv-disk-tier-path", "tier", "item 8"),
])
def test_cli_refuses_unported_flags(tmp_path, zip_path, flag, value, item):
    """``--tp``, the flag of the one knob the port refuses, parses as in
    JAX's CLI and exits with a message naming its ROADMAP item at a
    non-default value; ``--tenant`` and the KV-tier flags, refused the
    same way until they were ported, are accepted and reach the
    engine (``item`` names where they were filed)."""
    if flag == "--tp":
        args = _cli_args(str(tmp_path / "absent.zip"),
                         str(tmp_path / "s.json"), flag, value)
        with pytest.raises(SystemExit, match=item):
            gateway_from_args(args)
        return
    if flag == "--kv-disk-tier-path":
        value = str(tmp_path / value)
    model = str(tmp_path / "port.zip")
    t_write_model(_tnet(zip_path), model)
    gw = gateway_from_args(_cli_args(model, str(tmp_path / "s.json"),
                                     flag, value)).start()
    try:
        eng = gw.engine
        if flag == "--tenant":
            assert isinstance(eng.scheduler, WeightedFairScheduler)
            assert "premium" in eng.tenants.tenants()
        else:
            assert eng.kv_tier is not None
            assert (eng.kv_host_tier_bytes, eng.kv_disk_tier_path) == (
                (1024, None) if flag == "--kv-host-tier-bytes"
                else (0, value))
    finally:
        gw.close()
