"""Speculative decoding in the PyTorch port's ``DecodeEngine`` against
the JAX package.

The pieces first: ``NgramDraftTable`` (a copy) gives JAX's drafts,
contexts and slots on seeded random and periodic streams; the acceptance
rules (``greedy_acceptance`` exactly, ``stochastic_acceptance``'s
``p_tau`` within 1e-6, its greedy rows by the equality rule, its
emitted marginals in distribution, ``residual_sample``'s ban after the
top-k filter) against ``deeplearning4j_tpu/serving/sampler.py``.

Then the engine. One JAX-written model zip (JAX's spec test net,
``transformer_lm(n_in=12, width=32, n_layers=2, n_heads=4)``, a 64-token
window) serves ``tests/test_serving_spec.py``'s REPEATS on both
packages with ``spec_draft_len=4`` (``n_slots=2``, ``decode_chunk=3``),
dense and paged (``block_tokens=8``), in the admission modes of JAX's
``TestSpecParity``: at float32 the ids, the spec counters (cumulative
and per request) and the final live K equal the JAX spec engine's, and
the ids equal the port's spec-off engine's. Further cases: fused and
async rounds, eos inside an accepted draft, short and brim prompts,
garbage and absent drafts, a sampled request beside a greedy one, the
verify graphs (one per pow2 width, none new on a rerun: the
``replaying_runner`` stand-in reruns each body on its static inputs,
which is where the paged ``filled`` chain and the dense rewind must
hold), the host buffers of a round's two outputs, knob validation and
the ring sizing. Nets, zips and JAX runs are made once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.serving import NgramDraftTable as JTable
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import greedy_acceptance as j_greedy
from deeplearning4j_tpu.serving import residual_sample as j_residual
from deeplearning4j_tpu.serving import stochastic_acceptance as j_stoch
from deeplearning4j_tpu.serving.sampler import (
    _scaled_filtered_logits as j_scaled,
)
from deeplearning4j_tpu.util.model_serializer import write_model

from deeplearning4j_tpu_torch.nn import cuda_graphs
from deeplearning4j_tpu_torch.nn.streaming import tree_map
from deeplearning4j_tpu_torch.serving import DecodeEngine as TEngine
from deeplearning4j_tpu_torch.serving import NgramDraftTable as TTable
from deeplearning4j_tpu_torch.serving import Request as TRequest
from deeplearning4j_tpu_torch.serving import engine as engine_module
from deeplearning4j_tpu_torch.serving import (
    greedy_acceptance,
    residual_sample,
    stochastic_acceptance,
)
from deeplearning4j_tpu_torch.serving.sampler import draft_probabilities
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

V, WINDOW, K = 12, 64, 4
REPEATS = [([1, 2, 3, 1, 2, 3, 1], 10), ([5, 2, 5, 2, 5], 8),
           ([9, 3, 3], 13), ([2, 2], 6), ([1, 4, 7, 2], 9)]
GEOMETRY = dict(n_slots=2, decode_chunk=3, seed=0)
LAYOUTS = {"dense": dict(), "paged": dict(paged_kv=True, block_tokens=8)}
#: JAX's TestSpecParity admission modes
MODES = {"blocking": {}, "warm": {"prefix_cache_rows": 4},
         "chunked_ttft": {"prefix_cache_rows": 4, "prefill_chunk": 4},
         "chunked_decode": {"prefix_cache_rows": 4, "prefill_chunk": 4,
                            "admission_policy": "decode"},
         "chunked_nocache": {"prefill_chunk": 4}}
SPEC_STATS = ("spec_rounds", "spec_fallback_rounds", "spec_drafted",
              "spec_accepted")

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
    path = str(tmp_path_factory.mktemp("spec") / "lm.zip")
    write_model(JNet(conf).init(), path)
    return path


def _port(zip_path, **kw):
    return TEngine(restore_model(zip_path, device="cpu"),
                   **dict(GEOMETRY, **kw))


def _serve(eng, request_cls, cases, **req):
    ids = [eng.submit(request_cls(list(p), n, **req)) for p, n in cases]
    res = eng.run()
    return [res[i] for i in ids]


def _ids(results):
    return [(r.tokens, r.finish_reason) for r in results]


def _spec_off(zip_path, layout, cases=tuple(REPEATS), **kw):
    key = ("off", layout, tuple((tuple(p), n) for p, n in cases),
           tuple(sorted(kw.items())))
    return _cached(key, lambda: _ids(_serve(
        _port(zip_path, **dict(LAYOUTS[layout], **kw)), TRequest,
        list(cases))))


# -- the draft table ---------------------------------------------------
def _streams():
    rng = np.random.default_rng(5)
    out = {f"random{v}": rng.integers(0, v, 60).tolist() for v in (3, 6)}
    out["periodic"] = ([4, 1, 4, 4, 7] * 12)[:57]
    out["period1"] = [2] * 9 + [3, 5, 2, 2, 2]
    return out


@pytest.mark.parametrize("ngram", [(3, 1), (4, 2), (1, 1)])
@pytest.mark.parametrize("stream", list(_streams()))
def test_draft_table_matches_jax(stream, ngram):
    ids = _streams()[stream]
    j, t = JTable(*ngram), TTable(*ngram)
    for table in (j, t):
        table.seed(0, ids[:5])
        table.seed(3, ids[10:12])
    for i in range(5, len(ids), 4):
        for table in (j, t):
            table.extend(0, ids[i:i + 4])
            table.extend(3, ids[i + 1:i + 2])
        for slot in (0, 3, 7):
            for k in (0, 1, 3, 8, 20):
                assert t.draft(slot, k) == j.draft(slot, k), (i, slot, k)
            assert t.context(slot) == j.context(slot)
        assert t.slots() == j.slots()
    for table in (j, t):
        table.drop(3)
        table.drop(9)
    assert t.slots() == j.slots() == [0]
    assert t.draft(3, 4) == j.draft(3, 4) == []


def test_draft_table_validation_matches_jax():
    for args in ((3, 0), (1, 2)):
        with pytest.raises(ValueError) as je:
            JTable(*args)
        with pytest.raises(ValueError) as te:
            TTable(*args)
        assert str(te.value) == str(je.value)


# -- the acceptance rules ----------------------------------------------
def _acceptance_case(seed, b=6, w=5):
    rng = np.random.default_rng(seed)
    probs = rng.dirichlet(np.ones(V) * 0.5, size=(b, w)).astype(np.float32)
    targets = probs.argmax(-1).astype(np.int32)
    draft = rng.integers(0, V, (b, w)).astype(np.int32)
    # some rows copy their targets for a while, so prefixes accept
    for r in range(0, b, 2):
        n = rng.integers(0, w + 1)
        draft[r, :n] = targets[r, :n]
    lens = rng.integers(0, w + 1, b).astype(np.int32)
    temps = np.where(rng.random(b) < 0.5, 0.0,
                     rng.uniform(0.3, 1.5, b)).astype(np.float32)
    top_ks = rng.choice([1, 3, V], b).astype(np.int64)
    return probs, targets, draft, lens, temps, top_ks


@pytest.mark.parametrize("seed", range(4))
def test_greedy_acceptance_is_exact(seed):
    _, targets, draft, lens, _, _ = _acceptance_case(seed)
    want = np.asarray(j_greedy(jnp.asarray(targets), jnp.asarray(draft),
                               jnp.asarray(lens)))
    got = greedy_acceptance(torch.as_tensor(targets), torch.as_tensor(draft),
                            torch.as_tensor(lens))
    assert got.dtype == torch.int32
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("seed", range(4))
def test_stochastic_acceptance_greedy_rows_and_p_tau(seed):
    probs, targets, draft, lens, temps, top_ks = _acceptance_case(seed)
    b, w, _ = probs.shape
    # p_tau(draft) as JAX's stochastic_acceptance computes it
    scaled = j_scaled(jnp.asarray(probs),
                      jnp.broadcast_to(jnp.asarray(temps)[:, None], (b, w)),
                      jnp.broadcast_to(jnp.asarray(top_ks)[:, None], (b, w)))
    want = np.take_along_axis(np.asarray(jax.nn.softmax(scaled, axis=-1)),
                              draft[..., None], axis=-1)[..., 0]
    got = draft_probabilities(torch.as_tensor(probs), torch.as_tensor(draft),
                              torch.as_tensor(temps),
                              torch.as_tensor(top_ks))
    assert float(np.abs(got.numpy() - want).max()) < 1e-6
    greedy = np.asarray(j_greedy(jnp.asarray(targets), jnp.asarray(draft),
                                 jnp.asarray(lens)))
    gen = torch.Generator().manual_seed(seed)
    for _ in range(3):
        acc = stochastic_acceptance(
            torch.as_tensor(probs), torch.as_tensor(draft),
            torch.as_tensor(lens), torch.as_tensor(temps),
            torch.as_tensor(top_ks), gen).numpy()
        assert (acc[temps == 0] == greedy[temps == 0]).all()
        assert ((acc >= 0) & (acc <= lens)).all()
    # all rows greedy: exactly JAX's acceptance, whatever the draws
    zeros = np.zeros(b, np.float32)
    want = np.asarray(j_stoch(jnp.asarray(probs), jnp.asarray(draft),
                              jnp.asarray(lens), jnp.asarray(zeros),
                              jnp.asarray(top_ks), jax.random.key(seed)))
    got = stochastic_acceptance(
        torch.as_tensor(probs), torch.as_tensor(draft),
        torch.as_tensor(lens), torch.as_tensor(zeros),
        torch.as_tensor(top_ks), gen)
    assert got.tolist() == want.tolist()


def test_certain_and_impossible_drafts():
    probs = np.full((2, 2, V), 1e-9, np.float32)
    probs[:, :, 3] = 1.0
    gen = torch.Generator().manual_seed(0)
    for _ in range(4):
        acc = stochastic_acceptance(
            torch.as_tensor(probs), torch.tensor([[3, 3], [3, 5]]),
            torch.tensor([2, 2]), torch.ones(2), torch.full((2,), 2), gen)
        assert acc.tolist() == [2, 1]


def test_residual_sample_never_emits_the_class_past_top_k():
    probs = np.zeros((2, V), np.float32)
    probs[:, 0], probs[:, 1], probs[:, 2] = 0.6, 0.3, 0.1
    args = (torch.tensor([0, 0]), torch.tensor([True, True]),
            torch.tensor([1.0, 0.0]), torch.full((2,), 2))
    gen = torch.Generator().manual_seed(1)
    for seed in range(8):
        tok = residual_sample(torch.as_tensor(probs), *args, gen).tolist()
        want = np.asarray(j_residual(jnp.asarray(probs),
                                     *(jnp.asarray(a.numpy()) for a in args),
                                     jax.random.key(seed))).tolist()
        assert tok == want == [1, 0]


@pytest.mark.parametrize("temp,top_k,drafted",
                         [(0.7, V, 3), (1.3, 4, 1), (1.0, 2, 5)])
def test_emitted_marginals_match_target_sampling(temp, top_k, drafted):
    """The accept-or-residual pipeline of one fixed row, run 4000 times
    at once (a batch of identical rows): the emitted token's frequencies
    match ``p_tau`` (JAX's test and bar)."""
    base = np.random.default_rng(4).dirichlet(np.ones(V) * 0.7).astype(
        np.float32)
    n = 4000
    probs = torch.as_tensor(base).expand(n, V).contiguous()
    temps, tks = torch.full((n,), temp), torch.full((n,), top_k)
    draft = torch.full((n, 1), drafted, dtype=torch.int32)
    gen = torch.Generator().manual_seed(11)
    acc = stochastic_acceptance(probs[:, None], draft,
                                torch.ones(n, dtype=torch.int32), temps,
                                tks, gen)
    bonus = residual_sample(probs, draft[:, 0], acc < 1, temps, tks, gen)
    toks = torch.where(acc == 1, draft[:, 0], bonus).numpy()
    emp = np.bincount(toks, minlength=V) / n
    logp = np.log(np.maximum(base, 1e-30))
    keep = np.argsort(-logp, kind="stable")[:top_k]
    scaled = np.full(V, -np.inf)
    scaled[keep] = logp[keep] / temp
    p_tau = np.exp(scaled - scaled.max())
    p_tau /= p_tau.sum()
    assert float(np.abs(emp - p_tau).sum()) < 0.08, (emp, p_tau)


# -- the engine against JAX's spec engine ------------------------------
def _spec_stats(eng):
    return ({k: eng.stats[k] for k in SPEC_STATS},
            eng.scheduler.draft_len)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mode", list(MODES))
def test_spec_engine_matches_jax(zip_path, mode, layout):
    kw = dict(GEOMETRY, spec_draft_len=K, **MODES[mode], **LAYOUTS[layout])
    jeng = JEngine(JNet.load(zip_path), **kw)
    jres = _serve(jeng, JRequest, REPEATS)
    teng = _port(zip_path, spec_draft_len=K, **MODES[mode],
                 **LAYOUTS[layout])
    tres = _serve(teng, TRequest, REPEATS)
    assert _ids(tres) == _ids(jres)
    assert _ids(tres) == _spec_off(zip_path, layout)
    assert [(r.spec_drafted, r.spec_accepted) for r in tres] == [
        (r.spec_drafted, r.spec_accepted) for r in jres]
    assert _spec_stats(teng) == _spec_stats(jeng)
    assert teng.stats["spec_rounds"] > 0
    assert teng.stats["spec_accepted"] > 0


class _Sometimes(TTable):
    """The n-gram table, silent whenever the context length is a
    multiple of 3: rounds with and without drafts alternate."""

    def draft(self, slot, k):
        if len(self._ctx.get(slot, ())) % 3 == 0:
            return []
        return super().draft(slot, k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spec_rides_fused_async_rounds(zip_path, layout, monkeypatch):
    """With ``fused_rounds=4, async_rounds=True`` no fused window runs
    on a round that drafted, windows run on the rounds that did not
    once nothing is queued, and the ids are the spec-off engine's."""
    plans = []
    plan = TEngine._plan_fused

    def spy(self, active, spec_round):
        k = plan(self, active, spec_round)
        plans.append((spec_round, k))
        return k

    monkeypatch.setattr(TEngine, "_plan_fused", spy)
    eng = _port(zip_path, spec_draft_len=K, fused_rounds=4,
                async_rounds=True, **LAYOUTS[layout])
    eng.spec = _Sometimes()
    cases = REPEATS + [([1, 4, 7, 2], 40)]
    assert _ids(_serve(eng, TRequest, cases)) == _spec_off(
        zip_path, layout, cases)
    assert all(k == 0 for spec, k in plans if spec)
    assert any(spec for spec, _ in plans)
    assert any(k > 0 for _, k in plans)
    assert eng.stats["spec_rounds"] > 0


class _Oracle(TTable):
    """Drafts the true greedy continuation of one known stream."""

    def __init__(self, prompt, stream):
        super().__init__()
        self.prompt, self.stream = prompt, stream

    def draft(self, slot, k):
        done = len(self._ctx.get(slot, ())) - len(self.prompt)
        return self.stream[done:done + k] if k >= 1 else []


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_eos_inside_an_accepted_draft(zip_path, layout):
    prompt = [9, 3, 3]
    base = _spec_off(zip_path, layout, [(prompt, 24)],
                     n_slots=1, decode_chunk=4)[0][0]
    eos = next(t for i, t in enumerate(base)
               if base.index(t) == i and i >= 3)
    stop = base.index(eos) + 1
    eng = _port(zip_path, n_slots=1, decode_chunk=4, spec_draft_len=16,
                **LAYOUTS[layout])
    eng.spec = _Oracle(prompt, base)
    r = _serve(eng, TRequest, [(prompt, 50)], eos_id=eos)[0]
    assert r.tokens == base[:stop] and r.finish_reason == "eos"
    assert eng.stats["spec_rounds"] > 0
    assert r.spec_accepted >= stop


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prompt_shorter_than_k(zip_path, layout):
    eng = _port(zip_path, n_slots=1, decode_chunk=2, spec_draft_len=8,
                **LAYOUTS[layout])
    cases = [([2, 2], 10)]
    assert _ids(_serve(eng, TRequest, cases)) == _spec_off(
        zip_path, layout, cases, n_slots=1, decode_chunk=2)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prompt_at_the_window_brim(zip_path, layout):
    """A prompt filling the window leaves no rewind headroom: no slot
    drafts while at the brim, and the ids stay exact."""
    cases = [(([1, 2, 3, 4] * 16)[:WINDOW], 12), ([1, 2, 3, 1], 8)]
    eng = _port(zip_path, decode_chunk=2, spec_draft_len=8,
                **LAYOUTS[layout])
    res = _serve(eng, TRequest, cases)
    assert _ids(res) == _spec_off(zip_path, layout, cases, decode_chunk=2)
    assert res[0].spec_drafted == 0 and res[1].spec_drafted > 0


class _Adversary(TTable):
    def draft(self, slot, k):
        ctx = self._ctx.get(slot)
        if not ctx or k < 1:
            return []
        return [(ctx[-1] + 1) % V] * k


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_garbage_drafts_stay_exact_and_step_k_down(zip_path, layout):
    eng = _port(zip_path, n_slots=1, decode_chunk=2, spec_draft_len=8,
                **LAYOUTS[layout])
    eng.spec = _Adversary()
    cases = [([1, 2, 3, 1, 2, 3, 1], 40)]
    assert _ids(_serve(eng, TRequest, cases)) == _spec_off(
        zip_path, layout, cases, n_slots=1, decode_chunk=2)
    assert eng.stats["spec_accepted"] < eng.stats["spec_drafted"]
    assert eng.scheduler.draft_len < 8


class _NeverMatches(TTable):
    def draft(self, slot, k):
        return []


@pytest.fixture
def replaying_runner(monkeypatch):
    """CPU tensors treated as card tensors by ``GraphRunner``, with a
    stand-in capture whose replay reruns the body on the static inputs
    and writes the results into the captured outputs (as in
    ``tests/test_torch_port_fused_rounds.py``)."""
    def capture(self, body, inputs, key):
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

    monkeypatch.setattr(cuda_graphs, "_on_card", lambda leaves: True)
    monkeypatch.setattr(cuda_graphs.GraphRunner, "_capture", capture)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_no_match_rounds_never_capture_a_verify_graph(zip_path, layout,
                                                      replaying_runner):
    eng = _port(zip_path, decode_chunk=2, spec_draft_len=K,
                **LAYOUTS[layout])
    eng.spec = _NeverMatches()
    assert _ids(_serve(eng, TRequest, REPEATS)) == _spec_off(
        zip_path, layout, decode_chunk=2)
    counts = eng.compile_counts()
    assert (counts["verify"], counts["decode"]) == (0, 1)
    assert eng.stats["spec_rounds"] == 0
    assert eng.stats["spec_fallback_rounds"] > 0


@pytest.mark.parametrize("async_rounds", [False, True])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_one_verify_graph_per_pow2_width_and_none_on_a_rerun(
        zip_path, layout, async_rounds, replaying_runner):
    """Replays of the captured decode and verify graphs (each body rerun
    on its static inputs) give the spec-off ids: the verify pass's
    rewind reaches the dense pool and the paged ``filled`` buffer the
    decode graph reads. Widths are pow2 buckets of K, and a rerun
    captures nothing new."""
    eng = _port(zip_path, spec_draft_len=K, async_rounds=async_rounds,
                **LAYOUTS[layout])
    want = _spec_off(zip_path, layout)
    assert _ids(_serve(eng, TRequest, REPEATS)) == want
    keys = set(eng._graphs.keys())
    assert keys - {"decode"} <= {("verify", w) for w in (1, 2, 4)}
    counts = eng.compile_counts()
    assert 1 <= counts["verify"] <= 3 and counts["decode"] == 1
    captures = eng._graphs.captures
    assert _ids(_serve(eng, TRequest, REPEATS)) == want
    assert eng._graphs.captures == captures
    assert eng.compile_counts() == counts


@pytest.mark.parametrize("async_rounds", [False, True])
def test_a_rounds_two_outputs_never_share_a_host_buffer(
        zip_path, async_rounds, monkeypatch):
    """``decode_chunk=3`` and K=2: the verify pass's ``emitted`` [B, 3]
    and the decode chunk's ``seq`` [B, 3] have one shape and dtype. The
    round's host copies go through the engine's buffers (plain host
    tensors here, pinned on the card): ids stay the spec-off engine's,
    and the round uses distinct buffers for the two."""
    eng = _port(zip_path, spec_draft_len=2, async_rounds=async_rounds)
    monkeypatch.setattr(eng, "_to_host", lambda outs: (
        engine_module._host_copies(eng._pinned, outs,
                                   lambda t: torch.empty_like(t))))
    assert _ids(_serve(eng, TRequest, REPEATS)) == _spec_off(zip_path,
                                                             "dense")
    assert eng.stats["spec_rounds"] > 0
    shapes = [k[1:] for k in eng._pinned if k[0] in ("seq",
                                                     "verify_emitted")]
    assert ((2, 3), torch.int32) in shapes and len(shapes) > len(
        set(shapes))


SAMPLED = ([5, 2] * 6, 24)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_a_sampled_request_rides_the_verify_pass(zip_path, layout):
    """A sampled request (temperature 0.5, top-k 2) with a periodic
    prompt, so its table matches, beside a greedy one: it drafts and
    accepts under the stochastic rule, its ids repeat from the same
    seed, and the greedy neighbour's ids stay the spec-off engine's."""
    greedy = REPEATS[0]

    def run():
        eng = _port(zip_path, decode_chunk=2, spec_draft_len=K, seed=3,
                    **LAYOUTS[layout])
        g = eng.submit(TRequest(*greedy))
        s = eng.submit(TRequest(*SAMPLED, temperature=0.5, top_k=2))
        res = eng.run()
        return res[g], res[s]

    g1, s1 = run()
    g2, s2 = run()
    assert (g1.tokens, g1.finish_reason) == _spec_off(
        zip_path, layout, [greedy], decode_chunk=2)[0]
    assert g1.spec_drafted > 0
    assert s1.spec_drafted > 0 and s1.spec_accepted > 0
    assert len(s1.tokens) == SAMPLED[1]
    assert s1.tokens == s2.tokens and g1.tokens == g2.tokens


# -- knobs, keys and sizing --------------------------------------------
@pytest.mark.parametrize("kw,match", [
    (dict(spec_draft_len=-1), "spec_draft_len"),
    (dict(spec_draft_len=4, draft_source="oracle"), "draft_source"),
    (dict(spec_draft_len=WINDOW), "window"),
])
def test_spec_knob_validation_matches_jax(zip_path, kw, match):
    with pytest.raises(ValueError, match=match) as je:
        JEngine(JNet.load(zip_path), n_slots=1, **kw)
    with pytest.raises(ValueError, match=match) as te:
        _port(zip_path, **kw)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_compile_count_keys_equal_the_jax_engine(zip_path, layout):
    kw = dict(spec_draft_len=K, **LAYOUTS[layout])
    want = set(JEngine(JNet.load(zip_path), **GEOMETRY,
                       **kw).compile_counts())
    assert "verify" in want
    assert set(_port(zip_path, **kw).compile_counts()) == want
    off = _port(zip_path, **LAYOUTS[layout])
    assert "verify" not in off.compile_counts() and off.spec is None


@pytest.mark.parametrize("kw", [
    dict(spec_draft_len=K), dict(spec_draft_len=13, decode_chunk=5),
    dict(spec_draft_len=2, fused_rounds=8),
    dict(spec_draft_len=6, prefix_cache_rows=3, block_tokens=4)])
def test_ring_and_default_kv_blocks_equal_the_jax_engine(zip_path, kw):
    kw = dict(GEOMETRY, **dict(dict(paged_kv=True, block_tokens=8), **kw))
    j = JEngine(JNet.load(zip_path), **kw)
    t = TEngine(restore_model(zip_path, device="cpu"), **kw)
    assert (t._ring_slots, t.kv_blocks) == (j._ring_slots, j.kv_blocks)
    off = TEngine(restore_model(zip_path, device="cpu"),
                  **dict(kw, spec_draft_len=0))
    assert t._ring_slots >= off._ring_slots
