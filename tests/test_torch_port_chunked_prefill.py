"""Chunked prefill and the prefix caches in the PyTorch port's
``DecodeEngine``, against the JAX engine and against the port's own
cache-off engine.

One JAX-written model zip (``transformer_lm(n_in=12, width=32,
n_layers=2, n_heads=4)``, a 64-token window) serves
``tests/test_serving_prefix_cache.py``'s shared-prefix cases at
``n_slots=2``, ``decode_chunk=3``, float32, on the dense layout and the
paged one (``block_tokens`` 4 and 8). Greedy ids must be identical to
the JAX engine's with the same knobs and to the port's engine with no
cache and blocking admission. Then the paged pool under sharing (a
splice references the trie's blocks, a block-aligned prefix needs no
copy-on-write, a shared block is never written in place, the idle pool
holds only trie blocks, preemption keeps ids exact), fused rounds with
admissions pending, and the decode round's static buffers, which a B=1
warm chunk must leave alone. ``Scheduler.plan_chunks`` and
``adapt_budget`` are held against the JAX package's over a grid. On the
CPU every path runs eagerly; on the card ``chip_smoke.py`` phase 13 runs
them at full width with K2 on the warm chunks."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving.scheduler import Scheduler as JScheduler
from deeplearning4j_tpu.util.model_serializer import write_model

from deeplearning4j_tpu_torch.nn.layers import attention
from deeplearning4j_tpu_torch.serving import DecodeEngine as TEngine
from deeplearning4j_tpu_torch.serving import Request as TRequest
from deeplearning4j_tpu_torch.serving.scheduler import Scheduler
from deeplearning4j_tpu_torch.util.model_serializer import restore_model
from torch_port_threads import one_torch_thread  # noqa: F401

V, WINDOW = 12, 64
SHARED = [1, 4, 7, 2, 9, 3, 5, 2]
GEOMETRY = dict(n_slots=2, decode_chunk=3, seed=0)
LAYOUTS = {"dense": {}, "paged4": dict(paged_kv=True, block_tokens=4),
           "paged8": dict(paged_kv=True, block_tokens=8)}
#: TestEnginePrefixParity's four kwargs, and adaptive pacing
KWARGS = {
    "cache": {"prefix_cache_rows": 4},
    "cache_chunk": {"prefix_cache_rows": 4, "prefill_chunk": 4},
    "cache_chunk_decode": {"prefix_cache_rows": 4, "prefill_chunk": 4,
                           "admission_policy": "decode"},
    "chunk": {"prefill_chunk": 4},
    "adaptive": {"prefix_cache_rows": 4, "prefill_chunk": 4,
                 "adaptive_prefill": True, "pressure_high": 8,
                 "pressure_low": 2},
}
# each kwargs case on the dense layout and on one paged block size
PARITY = [(k, "dense") for k in KWARGS] + [
    (k, "paged4" if i % 2 else "paged8") for i, k in enumerate(KWARGS)]

_CACHE = {}


def _cases(n_tails=5):
    cases = [(SHARED + [t], 4 + t % 3) for t in range(n_tails)]
    return cases + [(SHARED, 5), ([5, 2], 3)]


@pytest.fixture(scope="module")
def zip_path(tmp_path_factory):
    conf = jzoo.transformer_lm(n_in=V, width=32, n_layers=2, n_heads=4,
                               n_classes=V, seed=7)
    for c in conf.confs:
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    path = str(tmp_path_factory.mktemp("chunked") / "lm.zip")
    write_model(JNet(conf).init(), path)
    return path


def _net(zip_path, window=WINDOW):
    net = restore_model(zip_path, device="cpu")
    for c in net.conf.confs:
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = window
    return net


def _port(zip_path, window=WINDOW, **kw):
    return TEngine(_net(zip_path, window), **dict(GEOMETRY, **kw))


def _serve(eng, request_cls, cases):
    ids = [eng.submit(request_cls(list(p), n)) for p, n in cases]
    res = eng.run()
    return [res[i].tokens for i in ids]


def _cache_off(zip_path, layout, cases=None, window=WINDOW):
    key = ("off", layout, window, repr(cases))
    if key not in _CACHE:
        _CACHE[key] = _serve(_port(zip_path, window, **LAYOUTS[layout]),
                             TRequest, cases or _cases())
    return _CACHE[key]


@pytest.mark.parametrize("kw,layout", PARITY)
def test_greedy_ids_identical_to_jax_and_to_cache_off(zip_path, kw,
                                                      layout):
    knobs = dict(LAYOUTS[layout], **KWARGS[kw])
    want = _serve(JEngine(JNet.load(zip_path), **GEOMETRY, **knobs),
                  JRequest, _cases())
    eng = _port(zip_path, **knobs)
    got = _serve(eng, TRequest, _cases())
    assert got == want
    assert got == _cache_off(zip_path, layout)
    if "prefix_cache_rows" in knobs:
        assert eng.stats["prefill_tokens_skipped"] > 0
        assert eng.prefix_cache.stats["hits"] > 0
    if "prefill_chunk" in knobs:
        assert eng.stats["chunks_scheduled"] > len(_cases())
    counts = eng.compile_counts()
    assert counts["chunk_prefill"] == 0
    assert ("prefix_fetch" in counts) == (
        "prefix_cache_rows" in knobs and layout == "dense")


@pytest.mark.parametrize("layout", ["dense", "paged8"])
def test_exact_prompt_hit_restreams_the_last_token(zip_path, layout):
    eng = _port(zip_path, n_slots=1, decode_chunk=2, prefix_cache_rows=2,
                **LAYOUTS[layout])
    a = eng.submit(TRequest(SHARED, 6))
    res_a = eng.run()
    b = eng.submit(TRequest(list(SHARED), 6))
    res_b = eng.run()
    want = _cache_off(zip_path, layout, [(SHARED, 6)])[0]
    assert res_a[a].tokens == res_b[b].tokens == want
    assert res_b[b].prefix_tokens_reused == len(SHARED) - 1
    assert eng.prefix_cache.stats["hits"] == 1


@pytest.mark.parametrize("layout", ["dense", "paged4"])
def test_prompt_at_stream_max_t_admits_warm(zip_path, layout):
    prompt = [(i * 5 + 1) % V for i in range(WINDOW)]
    knobs = dict(LAYOUTS[layout], prefix_cache_rows=2, prefill_chunk=8)
    cases = [(prompt, 4), (list(prompt), 4)]
    jeng = JEngine(JNet.load(zip_path), **GEOMETRY, **knobs)
    want = [_serve(jeng, JRequest, [c])[0] for c in cases]
    eng = _port(zip_path, **knobs)
    got = [_serve(eng, TRequest, [c])[0] for c in cases]
    assert got == want == _cache_off(zip_path, layout, cases)
    assert eng.prefix_cache.stats["hits"] == 1


def _paged(zip_path, **kw):
    return _port(zip_path, **dict(LAYOUTS["paged8"], **kw))


def test_warm_hit_splices_the_entry_blocks_without_a_row_copy(zip_path):
    eng = _paged(zip_path, n_slots=1, decode_chunk=2, prefix_cache_rows=4)
    eng.submit(TRequest(SHARED + [1, 6], 6))
    eng.run()
    assert eng.stats["prefix_blocks_spliced"] == 0       # cold
    (row,) = eng.prefix_cache.stored_rows()
    entry = dict(eng.prefix_cache.payload(row).blocks)
    rid = eng.submit(TRequest(SHARED + [2, 0], 6))
    eng.step()                         # admission and one round
    # the slot's first block IS the entry's (a reference, no copy)
    assert eng._kv_tabs[0].blocks[0] == entry[0]
    assert eng.block_pool.refcount(entry[0]) >= 2
    res = eng.run()
    want = _cache_off(zip_path, "paged8", [(SHARED + [2, 0], 6)])[0]
    assert res[rid].tokens == want
    assert res[rid].prefix_tokens_reused == len(SHARED)
    assert eng.stats["prefix_blocks_spliced"] >= 1
    assert "prefix_fetch" not in eng.compile_counts()
    assert 1 <= eng.stats["cow_copies"] <= 4


def test_block_aligned_prefix_needs_no_cow(zip_path):
    eng = _paged(zip_path, n_slots=1, decode_chunk=2, prefix_cache_rows=4)
    eng.submit(TRequest(SHARED + [5, 2], 4))
    eng.run()
    cow = eng.block_pool.stats["cow_copies"]
    eng.submit(TRequest(SHARED + [9, 9], 6))
    eng._start_admission(eng.scheduler.pop_admissible(), 0)
    # the 8-token match is exactly one full block: the suffix starts a
    # fresh block, no copy
    assert eng.block_pool.stats["cow_copies"] == cow
    assert eng._slots[0].prefix_reused == len(SHARED)
    res = eng.run()
    want = _cache_off(zip_path, "paged8", [(SHARED + [9, 9], 6)])[0]
    assert list(res.values())[0].tokens == want


def test_shared_block_immutable_across_sharers(zip_path):
    eng = _paged(zip_path, prefix_cache_rows=4)
    cases = [(SHARED + t, 7) for t in ([1, 6], [2, 0], [4, 8])]
    assert _serve(eng, TRequest, cases) == _cache_off(
        zip_path, "paged8", cases)
    # the entries' blocks still hold what a cold prefill writes: a
    # fresh warm admission of each stored prompt matches cache-off
    assert _serve(eng, TRequest, cases) == _cache_off(
        zip_path, "paged8", cases)
    assert eng.stats["cow_copies"] >= 1


def test_a_chunk_into_a_shared_block_copies_it_first(zip_path):
    """The warm chunk's own K/V scatter writes into the spliced tail
    block only after ``_ensure_tab`` swapped in a copy: the entry's
    block keeps its bytes."""
    eng = _paged(zip_path, n_slots=2, prefix_cache_rows=4,
                 prefill_chunk=4)
    eng.submit(TRequest(SHARED + [1, 6, 3], 4))
    eng.run()
    (row,) = eng.prefix_cache.stored_rows()
    entry = eng.prefix_cache.payload(row)
    before = {name: (st["pk"][entry.blocks[1]].clone(),
                     st["pv"][entry.blocks[1]].clone())
              for name, st in eng._pool.items()}
    # diverges at 10: the splice shares block 1 (tokens 8..15) partially
    eng.submit(TRequest(SHARED + [1, 6, 0, 0], 4))
    eng._start_admission(eng.scheduler.pop_admissible(), 0)
    pending = eng._pending[-1]
    assert pending.tab.blocks[1] == entry.blocks[1]
    cow = eng.block_pool.stats["cow_copies"]
    assert eng._advance_prefill(pending, eng.prefill_chunk)
    assert pending.tab.blocks[1] != entry.blocks[1]
    assert eng.block_pool.stats["cow_copies"] == cow + 1
    for name, st in eng._pool.items():
        assert torch.equal(st["pk"][entry.blocks[1]], before[name][0])
        assert torch.equal(st["pv"][entry.blocks[1]], before[name][1])
    eng.run()


CASES = [(SHARED + [1, 6], 8), (SHARED + [2, 0], 5), ([9, 3, 3], 11),
         (SHARED + [4, 8], 7), ([2, 2], 9)]


def test_idle_pool_holds_only_trie_blocks(zip_path):
    eng = _paged(zip_path, prefix_cache_rows=4, prefill_chunk=4)
    assert _serve(eng, TRequest, CASES) == _cache_off(
        zip_path, "paged8", CASES)
    trie = eng.prefix_cache.block_ids()
    assert eng.block_pool.used_blocks == len(set(trie))
    for bid in set(trie):
        assert eng.block_pool.refcount(bid) == trie.count(bid)
    # no payload maps the scatter's scratch block
    scratch = {st["scratch"] for st in eng._pool.values()}
    assert scratch == {eng.kv_blocks} and not scratch & set(trie)
    eng.prefix_cache.clear()
    assert eng.block_pool.used_blocks == 0


def test_preemption_under_pressure_with_prefix_entries(zip_path):
    window, bt = 32, 4
    cases = [([1, 4, 7, 2, 5, 9, 3, 3, 8, 6][: 6 + (i % 4)], 18)
             for i in range(6)]
    eng = _port(zip_path, window, n_slots=4, decode_chunk=2,
                paged_kv=True, block_tokens=bt, kv_blocks=18,
                prefix_cache_rows=4, prefill_chunk=4)
    got = _serve(eng, TRequest, cases)
    assert got == _cache_off(zip_path, "paged4", cases, window)
    assert eng.stats["preempted"] >= 1
    assert eng.prefix_cache.stats["hits"] >= 1
    assert eng.prefix_cache.stats["evictions"] >= 1
    assert eng.block_pool.used_blocks == len(set(
        eng.prefix_cache.block_ids()))


def _recording(eng):
    """Record (graph key, an admission pending) at every dispatch."""
    eng.dispatches = []
    run_graph = eng._run_graph

    def record(key, body, ops):
        eng.dispatches.append((key, bool(eng._pending)))
        return run_graph(key, body, ops)

    eng._run_graph = record
    return eng


@pytest.mark.parametrize("layout", ["dense", "paged8"])
@pytest.mark.parametrize("async_rounds", [False, True])
def test_no_fused_window_while_an_admission_is_pending(zip_path, layout,
                                                       async_rounds):
    knobs = dict(LAYOUTS[layout], prefix_cache_rows=4, prefill_chunk=4,
                 admission_policy="decode")
    eng = _recording(_port(zip_path, fused_rounds=4,
                           async_rounds=async_rounds, **knobs))
    cases = CASES + [(SHARED + [7, 7], 12)]
    got = _serve(eng, TRequest, cases)
    assert got == _serve(_port(zip_path, **knobs), TRequest, cases)
    assert got == _cache_off(zip_path, layout, cases)
    fused = [k for k, _ in eng.dispatches if k != "decode"]
    assert fused, "no fused window ran"
    assert not [k for k, pend in eng.dispatches if k != "decode" and pend]
    assert any(pend for _, pend in eng.dispatches)
    assert eng.histograms["serving_fused_rounds"].count == len(fused)


def test_a_warm_chunk_leaves_the_rounds_static_buffers_alone(zip_path):
    """The decode round's tables live in static buffers keyed by name
    (``_round_buffer``) that its captured graph reads. A B=1 warm chunk
    between two rounds must build its own operands: the buffers keep
    their tensors and values, and ids stay exact."""
    knobs = dict(LAYOUTS["paged8"], prefix_cache_rows=4, prefill_chunk=4)
    eng = _port(zip_path, **knobs)
    first = eng.submit(TRequest(SHARED + [1, 6], 10))
    while not eng._round_bufs:
        eng.step()                     # admitted, one round dispatched
    bufs = dict(eng._round_bufs)
    values = {k: v.clone() for k, v in bufs.items()}
    second = eng.submit(TRequest(SHARED + [2, 0, 5], 6))
    eng._start_admission(eng.scheduler.pop_admissible(), 1)
    pending = eng._pending[-1]
    assert pending.tab is not None and pending.matched == len(SHARED)
    assert eng._advance_prefill(pending, eng.prefill_chunk)
    assert eng._round_bufs.keys() == bufs.keys()
    for k, v in eng._round_bufs.items():
        assert v is bufs[k] and torch.equal(v, values[k]), k
    # the trap itself: the round's operand function would broadcast a
    # B=1 table over every row of the static buffer (the next round
    # rewrites all of them from the host tables)
    table = eng._round_bufs["table"]
    assert not bool((table == table[0]).all())
    eng._paged_rnn_rows([pending.tab])
    assert bool((table == table[0]).all())
    res = eng.run()
    want = _cache_off(zip_path, "paged8",
                      [(SHARED + [1, 6], 10), (SHARED + [2, 0, 5], 6)])
    assert [res[first].tokens, res[second].tokens] == want


def test_paged_chunk_hands_the_kernel_a_contiguous_query(zip_path,
                                                         monkeypatch):
    """At t > 1 the heads split leaves q strided; the kernel takes
    contiguous operands, so ``_paged_attend`` passes a contiguous q (the
    CPU stands in for the launch)."""
    seen = []

    def kernel(q, *rest, tm):
        seen.append((q.shape[2], q.is_contiguous()))
        return attention.paged_attention_reference(q, *rest, tm=tm)

    monkeypatch.setattr(attention, "paged_attention", kernel)
    eng = _paged(zip_path, prefix_cache_rows=4, prefill_chunk=4)
    cases = [(SHARED + [1, 6], 4), (SHARED + [2, 0], 4)]
    got = []
    for case in cases:
        got += _serve(eng, TRequest, [case])
    assert got == _cache_off(zip_path, "paged8", cases)
    assert {t for t, _ in seen} == {1, 4}
    assert all(ok for _, ok in seen)


PLAN_REMAINING = [[], [3], [40], [16, 40], [30, 20, 10], [1, 1, 1, 1, 1],
                  [300, 5, 700], [8, 8, 8, 8, 8, 8]]


@pytest.mark.parametrize("policy", ["ttft", "decode"])
@pytest.mark.parametrize("chunk", [0, 4, 8, 256])
def test_plan_chunks_and_adapt_budget_match_jax(policy, chunk):
    for budget in (None, 1, 16, 600):
        for high, low in ((None, None), (40, 8)):
            kw = dict(prefill_chunk=chunk, prefill_budget=budget,
                      policy=policy, pressure_high=high, pressure_low=low)
            t, j = Scheduler(64, **kw), JScheduler(64, **kw)
            assert t.prefill_budget == j.prefill_budget
            for rem in PLAN_REMAINING:
                for verify in (0, 3):
                    assert (t.plan_chunks(rem, verify_tokens=verify)
                            == j.plan_chunks(rem, verify_tokens=verify))
            # pressure rises with the queue, then drains
            steps = []
            for n in range(6):
                t.submit(TRequest([1] * 20, 1))
                j.submit(JRequest([1] * 20, 1))
                steps.append((t.adapt_budget(), j.adapt_budget()))
            for n in range(6):
                t.pop(), j.pop()
                steps.append((t.adapt_budget(), j.adapt_budget()))
            assert all(a == b for a, b in steps), steps
