"""The PyTorch port's paged-KV ``DecodeEngine`` against the JAX engine.

Both engines serve the same model zip (built in JAX) with the same
geometry: ``paged_kv=True``, ``block_tokens=8``, ``n_slots=2``,
``decode_chunk=4`` and a 64-token window. Five greedy requests, more
than the slots (so slots evict and re-admit), with prompt + generation
lengths past the window (so blocks slide out and the floor moves).
Greedy ids must be identical at float32, and every request must finish
by length."""

import numpy as np
import pytest

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.util.model_serializer import write_model

import torch

from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention
from deeplearning4j_tpu_torch.serving.block_pool import BlockPool
from deeplearning4j_tpu_torch.serving import DecodeEngine as TEngine
from deeplearning4j_tpu_torch.serving import engine as engine_module
from deeplearning4j_tpu_torch.serving import Request as TRequest
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

V, WINDOW = 16, 64
GEOMETRY = dict(paged_kv=True, block_tokens=8, n_slots=2, decode_chunk=4)
# (prompt length, max_new_tokens): three pass the 64-token window
WORKLOAD = [(5, 70), (30, 50), (3, 9), (60, 20), (10, 1)]


def _zip(tmp_path, arch):
    if arch == "flagship":
        conf = jzoo.transformer_lm_flagship(vocab=V, width=32, n_layers=2,
                                            n_heads=4, seed=5)
    else:
        conf = jzoo.transformer_lm(n_in=V, width=32, n_layers=2,
                                   n_heads=4, n_classes=V, seed=5)
    for c in conf.confs:
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    path = str(tmp_path / f"{arch}.zip")
    write_model(JNet(conf).init(), path)
    return path


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, n).tolist(), g) for n, g in WORKLOAD]


def _serve(engine, request_cls, prompts):
    ids = [engine.submit(request_cls(list(p), g)) for p, g in prompts]
    res = engine.run()
    return [res[i] for i in ids]


@pytest.mark.parametrize("arch", ["flagship", "transformer_lm"])
def test_greedy_ids_identical_across_slide_and_eviction(tmp_path, arch):
    path = _zip(tmp_path, arch)
    prompts = _prompts()
    assert any(len(p) + g > WINDOW for p, g in prompts)
    assert len(prompts) > GEOMETRY["n_slots"]
    jres = _serve(JEngine(JNet.load(path), seed=0, **GEOMETRY),
                  JRequest, prompts)
    launches = paged_attention.launches
    teng = TEngine(restore_model(path, device="cpu"), seed=0, **GEOMETRY)
    tres = _serve(teng, TRequest, prompts)
    for (p, g), j, t in zip(prompts, jres, tres):
        assert t.finish_reason == j.finish_reason == "length"
        assert len(t.tokens) == g
        assert t.tokens == j.tokens, f"prompt len {len(p)}"
        assert t.prompt_len == len(p) and t.ttft_s is not None
    assert teng.stats["evicted"] == len(prompts)
    assert teng.stats["blocks_used"] == 0
    # the CPU path never launches the CUDA kernel
    assert paged_attention.launches == launches


def test_floor_moves_and_blocks_free_as_the_window_slides(tmp_path):
    eng = TEngine(restore_model(_zip(tmp_path, "flagship"), device="cpu"),
                  seed=0, **GEOMETRY)
    eng.submit(TRequest([1, 2, 3], 90))
    peak = 0
    while eng.has_work():
        eng.step()
        tab = eng._kv_tabs[0]
        if tab is not None:
            peak = max(peak, len(tab.blocks))
            lo = min(tab.blocks)
            assert (lo + 1) * 8 > tab.length - WINDOW
    # a slot never holds more than a window plus a round of blocks
    assert peak <= WINDOW // 8 + 2
    assert eng.block_pool.free_blocks == eng.kv_blocks


def test_preemption_under_pool_pressure_keeps_ids(tmp_path):
    """A pool too small for two full windows preempts the younger slot
    and requeues it; greedy ids are the same as without pressure."""
    path = _zip(tmp_path, "flagship")
    prompts = _prompts(1)[:2]
    free = _serve(TEngine(restore_model(path, device="cpu"), seed=0,
                          **GEOMETRY), TRequest, prompts)
    tight = TEngine(restore_model(path, device="cpu"), seed=0,
                    kv_blocks=14, **GEOMETRY)
    got = _serve(tight, TRequest, prompts)
    assert tight.stats["preempted"] > 0
    assert [r.tokens for r in got] == [r.tokens for r in free]


def test_eos_and_sampling(tmp_path):
    eng = TEngine(restore_model(_zip(tmp_path, "flagship"), device="cpu"),
                  seed=3, **GEOMETRY)
    greedy = _serve(eng, TRequest, [([4, 5, 6], 12)])[0].tokens
    eos = greedy[3]
    first = greedy.index(eos)
    r = _serve(eng, TRequest, [([4, 5, 6], 12)])[0]
    assert r.tokens == greedy
    rid = eng.submit(TRequest([4, 5, 6], 12, eos_id=eos))
    r = eng.run()[rid]
    assert r.finish_reason == "eos" and r.tokens == greedy[:first + 1]
    rid = eng.submit(TRequest([4, 5, 6], 12, temperature=1.0, top_k=3))
    r = eng.run()[rid]
    assert r.finish_reason == "length" and len(r.tokens) == 12
    assert all(0 <= t < V for t in r.tokens)


#: knobs this test once listed as unported that the port now carries
#: (chunked prefill and the prefix caches, speculative decoding, fault
#: handling, incremental delivery): they must be accepted
PORTED_KNOBS = ("prefix_cache_rows", "prefill_chunk", "adaptive_prefill",
                "spec_draft_len", "paranoid", "max_queue", "fault_plan",
                "emit_deltas")


@pytest.mark.parametrize("knob,value", [
    ("prefix_cache_rows", 4), ("prefill_chunk", 8),
    ("spec_draft_len", 2), ("paranoid", True), ("tp", 2),
    ("adaptive_prefill", True), ("max_queue", 4), ("tenants", object()),
    ("kv_host_tier_bytes", 1 << 20), ("fault_plan", object()),
    ("emit_deltas", True), ("kv_disk_tier_path", "tier"),
])
def test_unported_knobs_raise(tmp_path, knob, value):
    net = restore_model(_zip(tmp_path, "flagship"), device="cpu")
    kw = dict(GEOMETRY, **{knob: value})
    if knob in PORTED_KNOBS:
        assert knob not in engine_module._UNPORTED
        TEngine(net, **kw)
        return
    with pytest.raises(NotImplementedError, match=knob):
        TEngine(net, **kw)


def test_unknown_knob_and_deadlines_raise(tmp_path):
    net = restore_model(_zip(tmp_path, "flagship"), device="cpu")
    with pytest.raises(TypeError, match="bogus"):
        TEngine(net, bogus=1)
    eng = TEngine(net, **GEOMETRY)
    # deadlines are ported (fault handling): accepted, and the sweep armed
    assert eng.submit(TRequest([1], 2, deadline_s=1.0)) >= 0
    assert eng._has_deadlines
    with pytest.raises(ValueError, match="outside vocab"):
        eng.submit(TRequest([V], 2))
    with pytest.raises(ValueError, match="window"):
        eng.submit(TRequest([1] * (WINDOW + 1), 2))


def test_use_flash_paged_false_matches_auto_on_cpu(tmp_path):
    path = _zip(tmp_path, "flagship")
    prompts = _prompts(2)[:3]
    auto = _serve(TEngine(restore_model(path, device="cpu"), seed=0,
                          **GEOMETRY), TRequest, prompts)
    plain = _serve(TEngine(restore_model(path, device="cpu"), seed=0,
                           use_flash_paged=False, **GEOMETRY), TRequest,
                   prompts)
    assert [r.tokens for r in auto] == [r.tokens for r in plain]


def test_block_pool_movers_write_in_place():
    pool = BlockPool(4, 2)
    pk = torch.arange(4 * 2 * 1 * 3, dtype=torch.float32).reshape(4, 2, 1, 3)
    tensors = {"0": {"pk": pk, "pv": pk.clone() + 100}}
    out = pool.copy_block_device(tensors, 1, 3)
    assert out is tensors and out["0"]["pk"] is pk
    assert torch.equal(pk[3], pk[1])
    assert torch.equal(tensors["0"]["pv"][3], tensors["0"]["pv"][1])
    pool.scrub_block_device(tensors, 2)
    assert not pk[2].any() and not tensors["0"]["pv"][2].any()
    assert pk[0].sum() > 0
    a, b = pool.alloc(), pool.alloc()
    pool.ref(a)
    assert pool.refcount(a) == 2 and not pool.deref(a) and pool.deref(a)
    assert pool.deref(b) and pool.free_blocks == 4
    with pytest.raises(AssertionError, match="free block"):
        pool.deref(b)


def test_no_table_ever_maps_the_scratch_block(tmp_path, monkeypatch):
    """The pool holds ``kv_blocks + 1`` blocks; the last is the scratch
    block the fixed-shape K/V scatters send dropped rows to. Across
    admissions, slides, evictions and idle slots no device table (the
    decode rounds' nor an admission's) maps it, the pool never hands it
    out, and users still see ``kv_blocks`` blocks."""
    eng = TEngine(restore_model(_zip(tmp_path, "flagship"), device="cpu"),
                  seed=0, **GEOMETRY)
    scratch = eng.kv_blocks
    seen = []
    rows, scatter = eng._paged_rnn_rows, eng._scatter_row

    def record_rows(tabs):
        rnn = rows(tabs)
        seen.append(next(iter(rnn.values()))["table"].numpy().copy())
        return rnn

    def record_scatter(rnn1, table_row, length):
        seen.append(np.asarray(table_row).copy())
        return scatter(rnn1, table_row, length)

    monkeypatch.setattr(eng, "_paged_rnn_rows", record_rows)
    monkeypatch.setattr(eng, "_scatter_row", record_scatter)
    res = _serve(eng, TRequest, _prompts())
    assert all(r.finish_reason == "length" for r in res)
    assert len(seen) > len(WORKLOAD)
    assert all(scratch not in tab for tab in seen)
    assert any((tab == -1).any() for tab in seen)   # idle rows were there
    for st in eng._pool.values():
        assert st["pk"].shape[0] == st["pv"].shape[0] == eng.kv_blocks + 1
        assert st["scratch"] == scratch
    assert eng.block_pool.n_blocks == eng.kv_blocks
    assert eng.stats["blocks_free"] == eng.kv_blocks
