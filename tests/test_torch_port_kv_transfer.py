"""KV transfer (DKV1) and the KV spill tiers in the PyTorch port against
the JAX package.

One JAX-written model zip (``transformer_lm(n_in=16, width=64,
n_layers=2, n_heads=4)``, a 64-token window) is loaded into both
packages; the paged engines use 8-token blocks, at float32 greedy.

- Wire format: JAX's ``pack_prefix`` bytes unpack in the port and pack
  back to the same bytes, and the port's bytes do the same in JAX, at
  float32 and at bf16 (the JAX side's bf16 arrays through
  ``ml_dtypes``, here only; the port writes bf16 as raw 16-bit words);
  truncated frames, a bad magic, a bad version and trailing bytes
  raise ``KVTransferError`` in both.
- Across the packages: a JAX paged engine warms and exports a prompt;
  the port imports it and its ids equal the JAX engine's local run. The
  port's own export of the prompt carries JAX's header and block count
  with buffers within 1e-4 of JAX's, and a JAX engine that imports it
  gives the same ids. Declines and raises match JAX's: already warm,
  no live slot preempted for an import, block-size mismatch, a dense
  engine, the export cap checked before any gather.
- Tiers: a seeded script drives the port's and JAX's ``KVTierStore``
  (host LRU and a disk ring under ``tmp_path``) alike; a thrashing
  round-robin of long prompts over a small pool gives the untiered
  engine's ids on a tiered one, with a reload at every revisit and
  JAX's tier counts; the disk ring reloads; a quarantined block or an
  invalidated entry is never spilled; the staging cap holds; an export
  falls through to the tier; a snapshot records the tier knobs and not
  the payloads; the gateway's ``/v1/kv/*`` answers 200 / 400 / 404 /
  413 over HTTP, with the healthz fields.

JAX engines compile for seconds, so one JAX donor and one JAX receiver
serve every cross-package case, and one JAX tiered engine the thrash
parity."""

import http.client
import json
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.serving import KVTransferError as JKVError
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import kv_tier as j_kv_tier
from deeplearning4j_tpu.serving import kv_transfer as j_kv
from deeplearning4j_tpu.util.model_serializer import (
    restore_model as j_restore_model,
)
from deeplearning4j_tpu.util.model_serializer import write_model

from deeplearning4j_tpu_torch.serving import DecodeEngine as TEngine
from deeplearning4j_tpu_torch.serving import (
    GatewayClient,
    GatewayError,
    KVTierStore,
    KVTransferError,
    KVTransferTooLarge,
    ServingGateway,
    pack_prefix,
    unpack_prefix,
)
from deeplearning4j_tpu_torch.serving import Request as TRequest
from deeplearning4j_tpu_torch.serving import kv_transfer as t_kv
from deeplearning4j_tpu_torch.util.model_serializer import restore_model
from torch_port_threads import one_torch_thread  # noqa: F401

V, WINDOW, BT = 16, 64, 8
PAGED = dict(n_slots=2, decode_chunk=2, seed=0, paged_kv=True,
             block_tokens=BT, prefix_cache_rows=4)
PROMPT = [1, 4, 7, 2, 5, 9, 3, 3, 1, 6, 2, 0, 8, 8, 4, 11, 13, 2, 6, 9]
N_GEN = 12
SHORT = [3, 1, 4, 1, 5]
#: the thrash workload: 3 prompts of 4 blocks, round-robin over a pool
#: of one slot's minimum (12 blocks), so a revisit finds its prefix
#: evicted from the trie
THRASH = dict(n_slots=1, decode_chunk=2, seed=0, paged_kv=True,
              block_tokens=BT, kv_blocks=12, prefix_cache_rows=8,
              prefill_chunk=16)
THRASH_PROMPTS = [np.random.default_rng(3 + i).integers(0, V, 32).tolist()
                  for i in range(3)]
THRASH_PASSES = 3

_CACHE = {}


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    conf = jzoo.transformer_lm(n_in=V, width=64, n_layers=2, n_heads=4,
                               n_classes=V, seed=7)
    for c in conf.confs:
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    path = str(tmp_path_factory.mktemp("kv") / "lm.zip")
    write_model(JNet(conf).init(), path)
    return path


def _jnet(zip_path):
    key = ("jnet", zip_path)
    if key not in _CACHE:
        _CACHE[key] = j_restore_model(zip_path)
    return _CACHE[key]


def _tnet(zip_path):
    return restore_model(zip_path, device="cpu")


def _run(eng, req_cls, prompt, n=N_GEN):
    rid = eng.submit(req_cls(list(prompt), n))
    return eng.run()[rid]


def _donor(zip_path):
    """The JAX paged engine that warmed PROMPT: (engine, its ids, its
    export)."""
    key = ("donor", zip_path)
    if key not in _CACHE:
        eng = JEngine(_jnet(zip_path), **PAGED)
        ids = _run(eng, JRequest, PROMPT).tokens
        payload = eng.export_kv(PROMPT)
        assert payload is not None
        _CACHE[key] = (eng, ids, payload)
    return _CACHE[key]


def _port_donor(zip_path):
    key = ("tdonor", zip_path)
    if key not in _CACHE:
        eng = TEngine(_tnet(zip_path), **PAGED)
        ids = _run(eng, TRequest, PROMPT).tokens
        _CACHE[key] = (eng, ids, eng.export_kv(PROMPT))
    return _CACHE[key]


# -- the wire format -------------------------------------------------------
def _j_layers(rng, n, dtype):
    return [(str(i), rng.standard_normal((n, BT, 4, 16)).astype(dtype),
             rng.standard_normal((n, BT, 4, 16)).astype(dtype))
            for i in range(2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dkv1_bytes_cross_the_packages(dtype):
    """JAX's frame unpacks in the port and packs back to the same
    bytes; the port's frame does the same in JAX; the values (bf16: the
    16-bit words) are JAX's."""
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    rng = np.random.default_rng(0)
    layers = _j_layers(rng, 2, np_dtype)
    tokens = list(range(1, 13))
    j_bytes = j_kv.pack_prefix(tokens, [0, 1], 0, BT, layers)
    got = unpack_prefix(j_bytes)
    assert got["header"] == j_kv.unpack_prefix(j_bytes)["header"]
    t_layers = [(name,) + got["layers"][name] for name in ("0", "1")]
    assert pack_prefix(tokens, [0, 1], 0, BT, t_layers) == j_bytes
    for (name, pk, pv), (_, tk, tv) in zip(layers, t_layers):
        assert str(tk.dtype) == f"torch.{dtype}"
        bits = torch.int16 if dtype == "bfloat16" else torch.int32
        np_bits = np.int16 if dtype == "bfloat16" else np.int32
        np.testing.assert_array_equal(tk.view(bits).numpy(),
                                      pk.view(np_bits))
        np.testing.assert_array_equal(tv.view(bits).numpy(),
                                      pv.view(np_bits))
    # and the other way: the port frames, JAX reads and re-frames
    t_bytes = pack_prefix(tokens[:9], [0, 1], 1, BT, t_layers)
    back = j_kv.unpack_prefix(t_bytes)
    assert j_kv.pack_prefix(tokens[:9], [0, 1], 1, BT, [
        (name,) + back["layers"][name] for name in ("0", "1")]) == t_bytes


def test_malformed_frames_raise_in_both():
    """Truncations, a bad magic, an unsupported version, trailing bytes
    and blocks that skip one: ``KVTransferError`` in both packages."""
    layers = _j_layers(np.random.default_rng(1), 2, np.float32)
    good = j_kv.pack_prefix(list(range(1, 13)), [0, 1], 0, BT, layers)
    bad = [good[:cut] for cut in (2, 7, 30, -1, -100)]
    bad.append(b"XXXX" + good[4:])
    bad.append(good[:4] + struct.pack("<I", 2) + good[8:])
    bad.append(good + b"\0\0")
    bad.append(j_kv.pack_prefix(list(range(1, 13)), [0, 2], 0, BT, layers))
    for payload in bad:
        with pytest.raises(KVTransferError):
            unpack_prefix(payload)
        with pytest.raises(JKVError):
            j_kv.unpack_prefix(payload)
    with pytest.raises(KVTransferError, match="version 2"):
        unpack_prefix(bad[6])


# -- across the packages -----------------------------------------------------
def test_jax_export_imports_into_the_port(zip_path):
    """The JAX donor's payload imported into a cold port engine (its
    pool made by the import): the admission splices the whole prefix
    and the ids are the donor's local run's; a second import declines
    as already warm, as JAX's does."""
    _, want, payload = _donor(zip_path)
    recv = TEngine(_tnet(zip_path), **PAGED)
    assert recv._pool is None
    out = recv.import_kv(payload)
    assert out == {"imported": True, "reason": "imported",
                   "prefix_len": len(PROMPT) - 1,
                   "tokens": len(PROMPT) - 1, "blocks": 3}
    res = _run(recv, TRequest, PROMPT)
    assert res.tokens == want
    assert res.prefix_tokens_reused == len(PROMPT) - 1
    assert recv.stats["kv_imports"] == 1
    assert recv.stats["kv_imported_blocks"] == 3
    assert recv.histograms["serving_kv_import_s"].count == 1
    again = recv.import_kv(payload)
    assert again["reason"] == "already_warm" and not again["imported"]
    assert recv.stats["kv_import_declined"] == 1


def test_port_export_matches_jax_and_imports_into_jax(zip_path):
    """The port's export of the prompt: JAX's header (tokens, blocks,
    floor, layer dtypes and sizes) and block count, buffers within 1e-4
    of JAX's; a JAX engine that imports it gives the donor's ids and
    declines a second import as the port does."""
    _, want, j_payload = _donor(zip_path)
    _, ids, payload = _port_donor(zip_path)
    assert ids == want
    got, ref = unpack_prefix(payload), unpack_prefix(j_payload)
    assert got["header"] == ref["header"]
    assert len(payload) == len(j_payload)
    for name in ref["layers"]:
        for a, b in zip(got["layers"][name], ref["layers"][name]):
            assert float((a - b).abs().max()) <= 1e-4
    recv = JEngine(_jnet(zip_path), **PAGED)
    assert recv.import_kv(payload)["imported"]
    assert _run(recv, JRequest, PROMPT).tokens == want
    port = TEngine(_tnet(zip_path), **PAGED)
    assert port.import_kv(payload)["imported"]
    again = port.import_kv(payload)
    assert again == recv.import_kv(payload)
    assert again["reason"] == "already_warm"


def test_declines_and_raises_match_jax(zip_path, monkeypatch):
    """A block-size mismatch and a dense receiver raise (the same
    message as JAX's); a dense or cold engine exports nothing; the cap
    raises ``KVTransferTooLarge`` before any gather, in both."""
    _, _, payload = _donor(zip_path)
    pairs = [(TEngine(_tnet(zip_path), **dict(PAGED, block_tokens=16)),
              JEngine(_jnet(zip_path), **dict(PAGED, block_tokens=16))),
             (TEngine(_tnet(zip_path), n_slots=2, prefix_cache_rows=4),
              JEngine(_jnet(zip_path), n_slots=2, prefix_cache_rows=4))]
    for port, jax in pairs:
        with pytest.raises(KVTransferError) as err:
            port.import_kv(payload)
        with pytest.raises(JKVError) as jerr:
            jax.import_kv(payload)
        assert str(err.value) == str(jerr.value)
    assert pairs[1][0].export_kv(PROMPT) is None
    assert TEngine(_tnet(zip_path), **PAGED).export_kv(PROMPT) is None
    jdonor = _donor(zip_path)[0]
    tdonor = _port_donor(zip_path)[0]
    gathers = []
    monkeypatch.setattr(t_kv, "gather_blocks",
                        lambda *a: gathers.append(a))
    with pytest.raises(KVTransferTooLarge):
        tdonor.export_kv(PROMPT, cap_bytes=64)
    with pytest.raises(j_kv.KVTransferTooLarge):
        jdonor.export_kv(PROMPT, cap_bytes=64)
    assert gathers == []


def test_import_never_preempts_a_live_slot(zip_path):
    """A pool of one slot's minimum (12 blocks) whose live slot holds 9
    of them: a 4-block import evicts the one trie entry and then
    declines; nothing is preempted and the live request finishes with
    its own ids."""
    donor = TEngine(_tnet(zip_path), **PAGED)
    _run(donor, TRequest, THRASH_PROMPTS[0], 2)
    payload = donor.export_kv(THRASH_PROMPTS[0])
    assert unpack_prefix(payload)["header"]["blocks"] == [0, 1, 2, 3]
    geo = dict(PAGED, kv_blocks=12, prefix_cache_rows=2)
    solo = _run(TEngine(_tnet(zip_path), **geo), TRequest, SHORT, 80)
    recv = TEngine(_tnet(zip_path), **geo)
    rid = recv.submit(TRequest(list(SHORT), 80))
    res = {}
    for _ in range(30):
        recv.step(res)
    assert recv.block_pool.free_blocks == 2
    out = recv.import_kv(payload)
    assert out["reason"] == "no_blocks" and not out["imported"]
    assert recv.stats["preempted"] == 0
    assert recv.stats["kv_import_declined"] == 1
    assert recv._slots[0].request.id == rid
    while recv.has_work():
        recv.step(res)
    assert res[rid].tokens == solo.tokens


# -- the spill tiers ---------------------------------------------------------
def _tier_script(cls, tmp, seed=0):
    """A seeded script of puts, matches, takes, drops and a clear over
    a 3 KB host LRU and a 5 KB disk ring: every answer and the books."""
    rng = np.random.default_rng(seed)
    store = cls(host_budget_bytes=3000, disk_path=str(tmp),
                disk_budget_bytes=5000)
    log, keys = [], []
    for step in range(200):
        op = rng.choice(["put", "put", "match", "take", "drop"]
                        + (["clear"] if step % 97 == 96 else []))
        if op == "put":
            key = rng.integers(0, 4, int(rng.integers(1, 6))).tolist()
            size = int(rng.integers(100, 2600))
            keys.append(key)
            log.append(("put", store.put(key, bytes([len(key)]) * size)))
        elif op == "match":
            prompt = rng.integers(0, 4, int(rng.integers(1, 7))).tolist()
            hit = store.match(prompt)
            log.append(("match", None if hit is None
                        else (hit[0], len(hit[1]), hit[2])))
        elif op in ("take", "drop") and keys:
            key = keys[int(rng.integers(0, len(keys)))]
            log.append((op, getattr(store, op)(key)))
        elif op == "clear":
            log.append(("clear", store.clear()))
        health = store.health()
        log.append(("books", dict(store.stats), len(store),
                    sorted(store.keys()), health))
    store.close()
    return log


def test_tier_store_script_matches_jax(tmp_path):
    """The port's ``KVTierStore`` (a copy) answers a seeded script of
    spills, reloads, faults and a clear as JAX's does: tiers, matches,
    books and health, a disk ring under ``tmp_path`` each."""
    got = _tier_script(KVTierStore, tmp_path / "port")
    want = _tier_script(j_kv_tier.KVTierStore, tmp_path / "jax")
    assert got == want
    assert {e[1] for e in got if e[0] == "put"} >= {"host", "disk"}
    assert any(e[0] == "books" and e[1]["demotions"] for e in got)
    assert any(e[0] == "books" and e[1]["hits_disk"] for e in got)
    for e in got:
        if e[0] == "books":
            s = e[1]
            assert s["spills"] == s["reloads"] + s["drops"] + e[2]


def _thrash(eng, req_cls):
    """THRASH_PASSES round-robins of THRASH_PROMPTS, 4 new tokens each;
    the ids in order."""
    ids = []
    for _ in range(THRASH_PASSES):
        for p in THRASH_PROMPTS:
            ids.append(_run(eng, req_cls, p, 4).tokens)
    return ids


def test_thrash_reloads_every_revisit_with_untiered_ids(zip_path):
    """Three 4-block prompts round-robin over a 12-block pool: the
    tiered port engine's ids are the untiered engine's and JAX's tiered
    engine's, every revisit reloads from the host tier (the tier's
    counts are JAX's), every spill is accounted for and the spill and
    reload histograms are filled."""
    off = _thrash(TEngine(_tnet(zip_path), **THRASH), TRequest)
    eng = TEngine(_tnet(zip_path), kv_host_tier_bytes=1 << 20, **THRASH)
    got = _thrash(eng, TRequest)
    jeng = JEngine(_jnet(zip_path), kv_host_tier_bytes=1 << 20, **THRASH)
    want = _thrash(jeng, JRequest)
    assert got == off == want
    s = eng.kv_tier.stats
    assert s == jeng.kv_tier.stats
    revisits = (THRASH_PASSES - 1) * len(THRASH_PROMPTS)
    assert s["reloads"] == s["hits_host"] == revisits
    assert s["spills"] == s["reloads"] + s["drops"] + len(eng.kv_tier)
    assert eng.stats["kv_tier_reloads"] == revisits
    assert eng.histograms["serving_kv_reload_s"].count == revisits
    assert eng.histograms["serving_kv_spill_s"].count == s["spills"]
    assert eng._pending_spills == []


@pytest.mark.parametrize("kw", [
    {"async_rounds": True}, {"fused_rounds": 2}, {"spec_draft_len": 2},
    {"paranoid": True}], ids=["async", "fused", "spec", "paranoid"])
def test_tiers_on_every_engine_variant(zip_path, kw):
    """The thrash workload on the engine's other round paths: tiered ids
    are the untiered engine's and every revisit reloads (an async round
    lands before the next admission's reload; a spill's gather is
    queued before any later write to its blocks)."""
    off = _thrash(TEngine(_tnet(zip_path), **THRASH, **kw), TRequest)
    eng = TEngine(_tnet(zip_path), kv_host_tier_bytes=1 << 20, **THRASH,
                  **kw)
    assert _thrash(eng, TRequest) == off
    revisits = (THRASH_PASSES - 1) * len(THRASH_PROMPTS)
    assert eng.kv_tier.stats["reloads"] == revisits


def _drain_all(eng):
    while eng.prefix_cache.evict_one():
        pass
    eng.drain_spills()


def test_disk_tier_reloads(zip_path, tmp_path):
    """Host budget 0: every spill is a ring file under ``tmp_path``, and
    the revisit reads it back with the first run's ids."""
    eng = TEngine(_tnet(zip_path), kv_disk_tier_path=str(tmp_path / "ring"),
                  **PAGED)
    ref = _run(eng, TRequest, PROMPT).tokens
    _drain_all(eng)
    assert eng.kv_tier.health()["disk_entries"] == 1
    assert len(list((tmp_path / "ring").iterdir())) == 1
    assert _run(eng, TRequest, PROMPT).tokens == ref
    assert eng.kv_tier.stats["hits_disk"] == 1
    assert eng.kv_tier.stats["reloads"] == 1
    assert list((tmp_path / "ring").iterdir()) == []


def test_poisoned_or_invalidated_entries_never_spill(zip_path):
    """A pressure eviction of an entry holding a poisoned block stages
    nothing, and a quarantine invalidation never calls the hook."""
    eng = TEngine(_tnet(zip_path), kv_host_tier_bytes=1 << 20, **PAGED)
    _run(eng, TRequest, PROMPT)
    _run(eng, TRequest, SHORT)
    row = eng.prefix_cache.stored_rows()[0]
    eng.block_pool.poisoned.add(
        next(iter(eng.prefix_cache.payload(row).blocks.values())))
    for row in list(eng.prefix_cache.stored_rows()[1:]):
        assert eng.prefix_cache.invalidate_row(row)
    _drain_all(eng)
    assert eng.kv_tier.stats["spills"] == 0 and len(eng.kv_tier) == 0


def test_spill_staging_cap_holds(zip_path):
    """Past ``MAX_PENDING_SPILLS`` staged spills, an eviction is dropped
    and counted, never staged."""
    eng = TEngine(_tnet(zip_path), kv_host_tier_bytes=1 << 20, **PAGED)
    _run(eng, TRequest, PROMPT)
    eng._pending_spills = [None] * eng.MAX_PENDING_SPILLS
    assert eng.prefix_cache.evict_one()
    assert eng.stats["kv_tier_spill_skipped"] == 1
    assert len(eng._pending_spills) == eng.MAX_PENDING_SPILLS
    eng._pending_spills = []


def test_export_falls_through_to_the_tier(zip_path):
    """A trie-cold engine whose tier holds the prefix exports the stored
    payload (read-only: it stays resident, and the cap still applies);
    a receiver importing it gives the donor's ids."""
    donor = TEngine(_tnet(zip_path), kv_host_tier_bytes=1 << 20, **PAGED)
    ref = _run(donor, TRequest, PROMPT).tokens
    _drain_all(donor)
    payload = donor.export_kv(PROMPT)
    assert payload is not None and donor.stats["kv_tier_exports"] == 1
    assert len(donor.kv_tier) == 1
    with pytest.raises(KVTransferTooLarge):
        donor.export_kv(PROMPT, cap_bytes=16)
    recv = TEngine(_tnet(zip_path), **PAGED)
    assert recv.import_kv(payload)["imported"]
    assert _run(recv, TRequest, PROMPT).tokens == ref


def test_snapshot_records_tier_knobs_not_payloads(zip_path, tmp_path):
    """The snapshot's config carries the three knobs (plain JSON), no
    payload rides along, and the restored engine has an empty tier and
    the same ids."""
    ring = str(tmp_path / "ring")
    eng = TEngine(_tnet(zip_path), kv_host_tier_bytes=1 << 20,
                  kv_disk_tier_path=ring, kv_disk_tier_bytes=1 << 22,
                  **PAGED)
    ref = _run(eng, TRequest, PROMPT).tokens
    _drain_all(eng)
    snap = json.loads(json.dumps(eng.snapshot()))
    cfg = snap["config"]
    assert (cfg["kv_host_tier_bytes"], cfg["kv_disk_tier_path"],
            cfg["kv_disk_tier_bytes"]) == (1 << 20, ring, 1 << 22)
    assert "kv_tier" not in snap
    back = TEngine.restore(_tnet(zip_path), snap)
    assert back.kv_tier is not None and len(back.kv_tier) == 0
    assert back.kv_tier.host_budget_bytes == 1 << 20
    assert _run(back, TRequest, PROMPT).tokens == ref


def _post(gw, path, body):
    conn = http.client.HTTPConnection(gw._service.host, gw._service.port,
                                      timeout=10.0)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json",
                              "Content-Length": str(len(body))})
        return conn.getresponse().status
    finally:
        conn.close()


def test_gateway_kv_endpoints_over_http(zip_path):
    """A tiered paged gateway whose transfer cap admits one block and a
    half: the GET and POST exports of a short cached prompt are one
    payload; a long one answers 413, and so does its import; malformed
    queries and bodies 400, a cold prompt 404, a malformed frame 400; a
    short peer payload imports (200); healthz carries ``kv_transfer``
    and the tier block. A dense gateway: ``kv_transfer`` False, no
    tier, exports 404."""
    _, _, long_payload = _donor(zip_path)
    short = TEngine(_tnet(zip_path), **PAGED)
    _run(short, TRequest, [7, 7, 7, 1, 2])
    short_payload = short.export_kv([7, 7, 7, 1, 2])
    cap = 12_000
    assert len(short_payload) < cap < len(long_payload)
    eng = TEngine(_tnet(zip_path), kv_host_tier_bytes=1 << 20, **PAGED)
    with ServingGateway(eng, kv_transfer_cap_bytes=cap) as gw:
        assert gw.kv_transfer_cap_bytes == cap
        client = GatewayClient(gw.address, timeout_s=60.0)
        client.generate(SHORT, 4)
        client.generate(PROMPT, 4)
        payload = client.kv_export(SHORT)
        assert payload == client._kv_export_post(SHORT)
        assert unpack_prefix(payload)["header"]["tokens"] == SHORT[:-1]
        for call, status in (
                (lambda: client.kv_export(PROMPT), 413),
                (lambda: client.kv_import(long_payload), 413),
                (lambda: client._kv_export_post([15, 15, 15]), 404),
                (lambda: client.kv_import(b"DKV1" + bytes(12)), 400)):
            with pytest.raises(GatewayError) as err:
                call()
            assert err.value.status == status
        for body in (b"{not json", b"{}", b'{"tokens": []}',
                     b'{"tokens": "1,2,3"}', b'{"tokens": [1, "a"]}'):
            assert _post(gw, "/v1/kv/export", body) == 400
        for query in ("", "?tokens=", "?tokens=a,b"):
            conn = http.client.HTTPConnection(gw._service.host,
                                              gw._service.port, timeout=10)
            conn.request("GET", "/v1/kv/export" + query)
            assert conn.getresponse().status == 400
            conn.close()
        assert client.kv_export([15, 15, 15]) is None    # the 404
        assert client.kv_import(short_payload)["imported"]
        h = client.healthz()
        assert h["kv_transfer"] is True
        assert h["kv_tier"]["host_budget_bytes"] == 1 << 20
        assert set(h["kv_tier"]) >= {"entries", "host_bytes", "spills",
                                     "reloads", "drops"}
    dense = TEngine(_tnet(zip_path), n_slots=2, prefix_cache_rows=4)
    with ServingGateway(dense) as gw:
        client = GatewayClient(gw.address, timeout_s=60.0)
        client.generate(SHORT, 2)
        h = client.healthz()
        assert h["kv_transfer"] is False and h["kv_tier"] is None
        assert client.kv_export(SHORT) is None
        with pytest.raises(GatewayError) as err:
            client._kv_export_post(SHORT)
        assert err.value.status == 404
