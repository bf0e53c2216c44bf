"""The PyTorch port's prefix caches (``deeplearning4j_tpu_torch/serving/
prefix_cache.py``) against the JAX package's.

The radix trie is host bookkeeping copied from the JAX package: the same
sequences of lookups, inserts, releases and invalidations (the cases of
``tests/test_serving_prefix_cache.py::TestRadixTrie``) must give the
same hits, rows, stored prefixes, leases, free rows and stats on both.
The dense cache's two device movers are plain torch here: ``fetch`` with
a rewind must equal the port's own prefill of the shorter prefix, and
the JAX package's prefill of it within 1e-4; a fetched state must own
its memory, since the port's pool is written in place. The paged cache
holds block references: the same operations on both packages' block
pools leave the same refcounts, payloads and free lists."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.serving.block_pool import BlockPool as JBlockPool
from deeplearning4j_tpu.serving.block_pool import BlockTable as JBlockTable
from deeplearning4j_tpu.serving.prefix_cache import (
    PagedPrefixCache as JPaged,
)
from deeplearning4j_tpu.serving.prefix_cache import (
    RadixPrefixCache as JRadix,
)
from deeplearning4j_tpu.util.model_serializer import write_model

from deeplearning4j_tpu_torch.serving.block_pool import BlockPool
from deeplearning4j_tpu_torch.serving.block_pool import BlockTable
from deeplearning4j_tpu_torch.serving.prefix_cache import (
    PagedPrefixCache,
    RadixPrefixCache,
)
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

V, WINDOW = 12, 64
SHARED = [1, 4, 7, 2, 9, 3, 5, 2]


def _fake_state(fill, lib, tokens_axis=8):
    """A B=1 attention-cache tree shaped like real engine state, the
    same values as a jax or a torch tree."""
    k = np.arange(2 * tokens_axis * 4, dtype=np.float32).reshape(
        1, 2, tokens_axis, 4) + fill
    if lib == "jax":
        return {"0": {"k": jnp.asarray(k), "v": jnp.asarray(k + 0.5),
                      "filled": jnp.asarray([fill], jnp.int32)}}
    return {"0": {"k": torch.from_numpy(k), "v": torch.from_numpy(k + 0.5),
                  "filled": torch.tensor([fill], dtype=torch.int32)}}


# each case: the operations of one TestRadixTrie case, as
# ("rows", n) first, then ("lookup", prompt) (leases a hit, kept in
# order, misses too), ("release", i) (the i-th lookup's hit), ("insert", prompt, fill),
# ("invalidate", prompt), ("invalidate_row", row), ("clear",)
TRIE_CASES = {
    "miss_then_hit_after_insert": [
        ("rows", 2), ("lookup", [1, 2, 3, 4]), ("insert", [1, 2, 3, 4], 4),
        ("lookup", [1, 2, 3, 4, 5, 6]), ("release", 1)],
    "exact_match_rewinds_one_token": [
        ("rows", 2), ("insert", [1, 2, 3, 4], 4), ("lookup", [1, 2, 3, 4]),
        ("release", 0)],
    "divergent_tail_is_rewound": [
        ("rows", 2), ("insert", SHARED + [0, 0], 8),
        ("lookup", SHARED + [3]), ("release", 0), ("lookup", SHARED),
        ("release", 1)],
    "one_token_prompt_never_hits": [
        ("rows", 2), ("insert", [5], 1), ("lookup", [5])],
    "edge_split_preserves_both_prompts": [
        ("rows", 4), ("insert", SHARED + [0], 8), ("insert", SHARED + [1], 8),
        ("lookup", SHARED + [0, 7]), ("release", 0),
        ("lookup", SHARED + [1, 7]), ("release", 1),
        ("lookup", SHARED + [2, 7]), ("release", 2)],
    "duplicate_insert_refreshes_not_duplicates": [
        ("rows", 2), ("insert", [1, 2, 3], 3), ("insert", [1, 2, 3], 3)],
    "lru_eviction_order": [
        ("rows", 2), ("insert", [1, 1, 1], 3), ("insert", [2, 2, 2], 3),
        ("lookup", [1, 1, 1, 9]), ("release", 0), ("insert", [3, 3, 3], 3)],
    "leased_row_survives_eviction_pressure": [
        ("rows", 1), ("insert", [1, 2, 3], 3), ("lookup", [1, 2, 3, 4]),
        ("insert", [7, 8, 9], 3), ("release", 0), ("insert", [7, 8, 9], 3)],
    "insert_survives_eviction_pruning_walk_path": [
        ("rows", 1), ("lookup", SHARED), ("insert", SHARED, 8),
        ("lookup", SHARED + [0, 1]), ("release", 1),
        ("insert", SHARED + [0, 1], 8),
        ("lookup", SHARED + [0, 1, 2, 3]), ("release", 2),
        ("insert", SHARED + [0, 1, 2, 3], 8)],
    "invalidate_scrubs_entry": [
        ("rows", 2), ("insert", [1, 2, 3], 3), ("insert", [1, 2, 3, 4, 5], 5),
        ("invalidate", [1, 2, 3]), ("invalidate", [1, 2, 3]),
        ("invalidate_row", 0), ("invalidate_row", 1),
        ("insert", [7, 7], 2), ("insert", [8, 8], 2)],
    "invalidate_leased_row_defers_free": [
        ("rows", 2), ("insert", [1, 2, 3, 4], 4),
        ("lookup", [1, 2, 3, 4, 9]), ("invalidate", [1, 2, 3, 4]),
        ("lookup", [1, 2, 3, 4, 9]), ("insert", [5, 5, 5], 3),
        ("release", 0), ("insert", [6, 6], 2)],
    "clear_unmaps_leased_rows_until_release": [
        ("rows", 3), ("insert", [1, 2, 3], 3), ("insert", [4, 5, 6], 3),
        ("lookup", [1, 2, 3, 9]), ("clear",), ("lookup", [4, 5, 6, 1]),
        ("release", 0), ("insert", [9, 9, 9], 3)],
}


def _snapshot(cache, result):
    hit = result
    if hit is not None and hasattr(hit, "row"):
        hit = (hit.row, hit.matched, hit.drop)
    return (hit, dict(cache.stats), cache.cached_prefixes(),
            cache.stored_rows(), cache.leased_rows(), sorted(cache._free),
            round(cache.hit_rate, 12))


def _run_trie(cls, lib, ops):
    cache, hits, trace = None, [], []
    for op in ops:
        kind = op[0]
        if kind == "rows":
            cache = cls(op[1])
            continue
        if kind == "lookup":
            result = cache.lookup(op[1])
            hits.append(result)
        elif kind == "release":
            result = cache.release(hits[op[1]])
        elif kind == "insert":
            result = cache.insert(op[1], _fake_state(op[2], lib))
        elif kind == "invalidate":
            result = cache.invalidate(op[1])
        elif kind == "invalidate_row":
            result = cache.invalidate_row(op[1])
            result = (result, cache.row_prefix(op[1]))
        else:
            result = cache.clear()
        trace.append(_snapshot(cache, result))
    return trace


@pytest.mark.parametrize("case", list(TRIE_CASES))
def test_trie_matches_jax_operation_by_operation(case):
    ops = TRIE_CASES[case]
    want = _run_trie(JRadix, "jax", ops)
    got = _run_trie(RadixPrefixCache, "torch", ops)
    assert got == want


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    conf = jzoo.transformer_lm(n_in=V, width=32, n_layers=2, n_heads=4,
                               n_classes=V, seed=7)
    for c in conf.confs:
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    path = str(tmp_path_factory.mktemp("prefix") / "lm.zip")
    jnet = JNet(conf).init()
    write_model(jnet, path)
    return jnet, restore_model(path, device="cpu")


def _one_hot(ids):
    x = np.zeros((1, V, len(ids)), np.float32)
    x[0, ids, np.arange(len(ids))] = 1.0
    return x


def _port_prefill(tnet, ids):
    tnet.rnn_clear_previous_state()
    with torch.no_grad():
        tnet.rnn_time_step(torch.from_numpy(_one_hot(ids)))
    return tnet._rnn_state


def test_fetch_rewind_matches_the_shorter_prefill(nets):
    """``drop_newest_tokens``' contract: fetching with drop=d gives the
    state of the d-tokens-shorter prefill (valid region and filled; the
    masked left region is don't-care), against the port's prefill and
    JAX's within 1e-4."""
    jnet, tnet = nets
    full = _port_prefill(tnet, SHARED)
    short = _port_prefill(tnet, SHARED[:-2])
    jnet.rnn_clear_previous_state()
    jnet.rnn_time_step(jnp.asarray(_one_hot(SHARED[:-2])))
    jshort = jnet._rnn_state
    cache = RadixPrefixCache(rows=1)
    assert cache.insert(SHARED, full)
    hit = cache.lookup(SHARED[:-2] + [11])
    assert (hit.matched, hit.drop) == (6, 2)
    got = cache.fetch(hit)
    assert set(got) == set(short) == set(jshort)
    for name, st in short.items():
        n = int(st["filled"][0])
        assert n == 6 and int(got[name]["filled"][0]) == n
        assert int(np.asarray(jshort[name]["filled"])[0]) == n
        for key in ("k", "v"):
            g = got[name][key][:, :, -n:, :]
            torch.testing.assert_close(g, st[key][:, :, -n:, :],
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(
                g.numpy(), np.asarray(jshort[name][key])[:, :, -n:, :],
                rtol=1e-4, atol=1e-4)
    cache.release(hit)


def test_fetched_state_owns_its_memory(nets):
    """The pool is written in place: a fetched state is a copy, so a
    later store into the same row (after the row is released and
    recycled) leaves it unchanged."""
    _, tnet = nets
    state_a = _port_prefill(tnet, SHARED)
    state_b = _port_prefill(tnet, [3] * 8)
    cache = RadixPrefixCache(rows=1)
    cache.insert(SHARED, state_a)
    hit = cache.lookup(SHARED)
    got = cache.fetch(hit)
    before = {n: {k: t.clone() for k, t in st.items()}
              for n, st in got.items()}
    pool_ptrs = {t.untyped_storage().data_ptr()
                 for st in cache.pool.values() for t in st.values()}
    for st in got.values():
        for t in st.values():
            assert t.untyped_storage().data_ptr() not in pool_ptrs
    cache.release(hit)
    assert cache.insert([3] * 8, state_b)       # evicts, reuses row 0
    assert cache.stored_rows() == [hit.row]
    for name, st in got.items():
        for key, t in st.items():
            assert torch.equal(t, before[name][key]), (name, key)
    # and the row now holds the new state
    hit_b = cache.lookup([3] * 8 + [1])
    assert hit_b.drop == 0
    got_b = cache.fetch(hit_b)
    for name, st in state_b.items():
        assert torch.equal(got_b[name]["k"], st["k"])


def test_compile_counts_keys():
    assert RadixPrefixCache(2).compile_counts() == {"prefix_fetch": 0,
                                                   "prefix_store": 0}
    pool = BlockPool(8, 4)
    assert PagedPrefixCache(2, 4, pool.ref, pool.deref).compile_counts() == {}


def _paged_ops(lib):
    """One sequence on a paged cache over a 12-block pool: two tables
    inserted, a duplicate, lookups with leases, an LRU eviction by
    insert, ``evict_one``, invalidation and clear. Returns what each
    step leaves: results, refcounts, free list, payloads, block ids."""
    pool = (JBlockPool if lib == "jax" else BlockPool)(12, 4)
    table = JBlockTable if lib == "jax" else BlockTable
    cache = (JPaged if lib == "jax" else PagedPrefixCache)(
        2, 4, ref_block=pool.ref, release_block=pool.deref)

    def tab(length):
        t = table(4, length=length)
        for g in range(-(-length // 4)):
            t.blocks[g] = pool.alloc()
        return t

    def state(result):
        payloads = {r: (sorted(p.blocks.items()), p.length, p.floor)
                    for r, p in sorted(cache._payloads.items())}
        if lib != "jax":              # the engine's view of the payloads
            assert cache.tables() == list(cache._payloads.values())
        return (result, [pool.refcount(b) for b in range(12)],
                sorted(pool._free), payloads, sorted(cache.block_ids()),
                dict(cache.stats))

    trace = []
    a, b = tab(9), tab(6)
    trace.append(state(cache.insert_blocks(SHARED + [0], a)))
    a.blocks[9] = 99                  # the payload is a frozen copy
    trace.append(state(cache.insert_blocks(SHARED + [0], a)))
    del a.blocks[9]
    trace.append(state(cache.insert_blocks([5, 5, 5, 5, 5, 1], b)))
    hit = cache.lookup(SHARED + [0, 3])
    trace.append(state((hit.row, hit.matched, hit.drop)))
    c = tab(4)
    trace.append(state(cache.insert_blocks([6, 6, 6, 6], c)))
    cache.release(hit)
    trace.append(state(cache.evict_one()))
    trace.append(state(cache.evict_one()))
    trace.append(state(cache.insert_blocks([7, 7, 7, 7], c)))
    trace.append(state(cache.invalidate([7, 7, 7, 7])))
    trace.append(state(cache.insert_blocks([6, 6, 6, 6], c)))
    trace.append(state(cache.clear()))
    for t in (a, b, c):
        for bid in t.blocks.values():
            pool.deref(bid)
    trace.append(state(None))
    return trace, cache


def test_paged_cache_matches_jax_on_the_same_block_pool_operations():
    want, _ = _paged_ops("jax")
    got, cache = _paged_ops("torch")
    assert got == want
    assert got[-1][1] == [0] * 12                 # every block free
    with pytest.raises(NotImplementedError):
        cache.fetch(None)
    with pytest.raises(NotImplementedError):
        cache.insert([1, 2], None)
