"""The PyTorch port's dense-slot ``DecodeEngine`` (``paged_kv=False``,
the default) against the JAX engine's, and against the port's own paged
engine.

Both packages serve one JAX-written model zip with the same geometry:
``n_slots=2``, ``decode_chunk=4`` and a 64-token window, over
``test_torch_port_engine.py``'s workload (five greedy requests, more
than the slots, three of them past the window). Greedy ids must be
identical at float32. Sampled requests are matched in distribution:
every sampled token lies in its step's top-k, and the sampler's draws
follow the tempered, filtered distribution as JAX's do. On the CPU the
decode round runs its body eagerly; on the card it replays one captured
CUDA graph (``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.serving import DecodeEngine as JEngine
from deeplearning4j_tpu.serving import Request as JRequest
from deeplearning4j_tpu.serving import sampler as jsampler
from deeplearning4j_tpu.util.model_serializer import write_model

from deeplearning4j_tpu_torch.serving import DecodeEngine as TEngine
from deeplearning4j_tpu_torch.serving import Request as TRequest
from deeplearning4j_tpu_torch.serving import sampler as tsampler
from deeplearning4j_tpu_torch.util.model_serializer import restore_model

V, WINDOW = 16, 64
GEOMETRY = dict(n_slots=2, decode_chunk=4)
PAGED = dict(GEOMETRY, paged_kv=True, block_tokens=8)
# (prompt length, max_new_tokens): three pass the 64-token window
WORKLOAD = [(5, 70), (30, 50), (3, 9), (60, 20), (10, 1)]


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    d = tmp_path_factory.mktemp("dense_zips")
    out = {}
    for arch in ("flagship", "transformer_lm"):
        if arch == "flagship":
            conf = jzoo.transformer_lm_flagship(vocab=V, width=32,
                                                n_layers=2, n_heads=4,
                                                seed=5)
        else:
            conf = jzoo.transformer_lm(n_in=V, width=32, n_layers=2,
                                       n_heads=4, n_classes=V, seed=5)
        for c in conf.confs:
            if hasattr(c.layer, "stream_max_t"):
                c.layer.stream_max_t = WINDOW
        out[arch] = str(d / f"{arch}.zip")
        write_model(JNet(conf).init(), out[arch])
    return out


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, n).tolist(), g) for n, g in WORKLOAD]


def _serve(engine, request_cls, prompts, **kw):
    ids = [engine.submit(request_cls(list(p), g, **kw)) for p, g in prompts]
    res = engine.run()
    return [res[i] for i in ids]


def _port(zips, arch="flagship", **kw):
    return TEngine(restore_model(zips[arch], device="cpu"), seed=0,
                   **dict(GEOMETRY, **kw))


@pytest.mark.parametrize("arch", ["flagship", "transformer_lm"])
def test_greedy_ids_identical_to_jax_dense_engine(zips, arch):
    prompts = _prompts()
    assert any(len(p) + g > WINDOW for p, g in prompts)
    jres = _serve(JEngine(JNet.load(zips[arch]), seed=0, **GEOMETRY),
                  JRequest, prompts)
    teng = _port(zips, arch)
    assert teng.paged_kv is False and teng.block_pool is None
    tres = _serve(teng, TRequest, prompts)
    for (p, g), j, t in zip(prompts, jres, tres):
        assert t.finish_reason == j.finish_reason == "length"
        assert len(t.tokens) == g
        assert t.tokens == j.tokens, f"prompt len {len(p)}"
        assert t.prompt_len == len(p) and t.ttft_s is not None
    assert teng.stats["evicted"] == len(prompts)
    assert teng.stats["admitted"] == len(prompts)


@pytest.mark.parametrize("arch", ["flagship", "transformer_lm"])
def test_dense_engine_matches_the_paged_engine(zips, arch):
    prompts = _prompts(1)
    dense = _serve(_port(zips, arch), TRequest, prompts)
    paged = _serve(_port(zips, arch, **PAGED), TRequest, prompts)
    assert [r.tokens for r in dense] == [r.tokens for r in paged]


def test_dense_is_the_default_layout_and_its_pool_shape(zips):
    eng = TEngine(restore_model(zips["flagship"], device="cpu"),
                  n_slots=3, decode_chunk=2)
    assert eng.paged_kv is False
    eng.submit(TRequest([1, 2, 3], 2))
    eng.step()
    for st in eng._pool.values():
        assert tuple(st["k"].shape) == (3, 4, WINDOW, 8)
        assert st["k"].dtype == torch.float32
        assert st["filled"].dtype == torch.int32
    assert eng.compile_counts()["decode"] == 0     # eager on the CPU


def test_round_writes_the_pool_in_place(zips):
    """The decode round writes the dense pool and the token vector back
    into the same tensors: they are the captured graph's static inputs
    on the card, so they keep their storage from round to round."""
    eng = _port(zips)
    eng.submit(TRequest([4, 5, 6], 30))
    eng.step()
    ptrs = [a.data_ptr() for st in eng._pool.values() for a in st.values()]
    toks = eng._toks.data_ptr()
    filled = eng._pool["0"]["filled"].tolist()
    eng.step()
    assert ptrs == [a.data_ptr() for st in eng._pool.values()
                    for a in st.values()]
    assert eng._toks.data_ptr() == toks
    assert eng._pool["0"]["filled"].tolist() == [f + 4 for f in filled]


@pytest.mark.parametrize("paged", [False, True])
def test_compile_counts_has_the_jax_key_set(zips, paged):
    kw = PAGED if paged else GEOMETRY
    jeng = JEngine(JNet.load(zips["flagship"]), seed=0, **kw)
    teng = TEngine(restore_model(zips["flagship"], device="cpu"), seed=0,
                   **kw)
    _serve(teng, TRequest, _prompts()[:2])
    counts = teng.compile_counts()
    assert set(counts) == set(jeng.compile_counts())
    assert all(v == 0 for v in counts.values())   # nothing captured on CPU


def test_eos_is_honoured(zips):
    eng = _port(zips)
    greedy = _serve(eng, TRequest, [([4, 5, 6], 12)])[0].tokens
    eos = greedy[5]
    first = greedy.index(eos)
    r = _serve(eng, TRequest, [([4, 5, 6], 12)])[0]
    assert r.tokens == greedy
    rid = eng.submit(TRequest([4, 5, 6], 12, eos_id=eos))
    r = eng.run()[rid]
    assert r.finish_reason == "eos" and r.tokens == greedy[:first + 1]


def test_eviction_zeroes_the_slot_while_its_neighbour_decodes(zips):
    """A request of 1 + decode_chunk tokens finishes in the first round;
    its slot's rows are zeroed (the empty cache) as the other slot keeps
    decoding."""
    eng = _port(zips)
    short = eng.submit(TRequest([4, 5, 6], 1 + GEOMETRY["decode_chunk"]))
    long_ = eng.submit(TRequest([1, 2], 40))
    res = eng.step()
    assert short in res and long_ not in res
    for st in eng._pool.values():
        assert not st["k"][0].any() and not st["v"][0].any()
        assert int(st["filled"][0]) == 0
        assert int(st["filled"][1]) == 2 + GEOMETRY["decode_chunk"]
        assert st["k"][1].any()
    assert len(eng.run()[long_].tokens) == 40


def _top_k_sets(net, prompt, tokens, k):
    """The top-k ids at each generated position, from a full f32
    forward of prompt + tokens."""
    ids = torch.as_tensor(list(prompt) + list(tokens))
    x = torch.nn.functional.one_hot(ids, V).T[None].float()
    probs = net.output(x)[0]
    n = len(prompt)
    return [set(torch.topk(probs[:, n - 1 + i], k).indices.tolist())
            for i in range(len(tokens))]


def test_sampled_requests_stay_in_their_top_k(zips):
    eng = _port(zips)
    net = eng.net
    prompt = [3, 9, 1]
    res = _serve(eng, TRequest, [(prompt, 24)] * 3, temperature=1.5,
                 top_k=3)
    runs = [r.tokens for r in res]
    for toks in runs:
        assert len(toks) == 24
        for t, allowed in zip(toks, _top_k_sets(net, prompt, toks, 3)):
            assert t in allowed
    assert len({tuple(t) for t in runs}) > 1          # they do sample


def _tv_to(p_tau, draws):
    freq = np.bincount(draws, minlength=p_tau.shape[0]) / len(draws)
    return 0.5 * np.abs(freq - p_tau).sum()


@pytest.mark.parametrize("temps_on_device", [False, True])
def test_sampler_matches_jax_in_distribution(temps_on_device):
    """Both samplers' draws follow the tempered top-k distribution: the
    port's host-array call and its device-tensor call (the captured
    round's, which always carries the sampled branch) as JAX's do.
    Total variation from the exact distribution over 4000 draws, and
    greedy rows are argmax on every draw."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=V).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum()
    temp, k, n = 0.7, 5, 4000
    order = np.argsort(-probs, kind="stable")
    lp = np.full(V, -np.inf)
    lp[order[:k]] = np.log(probs[order[:k]]) / temp
    p_tau = np.exp(lp - lp.max())
    p_tau /= p_tau.sum()
    # n draws as n rows of one call: each row draws independently
    rows = np.tile(np.stack([probs, probs]), (n, 1))
    temps = np.tile(np.asarray([temp, 0.0], np.float32), n)
    top_ks = np.tile(np.asarray([k, V]), n)
    jdraws = np.asarray(jsampler.sample_tokens(
        jnp.asarray(rows), jnp.asarray(temps),
        jnp.asarray(top_ks, jnp.int32), jax.random.PRNGKey(0)))
    jdraws = jdraws.reshape(n, 2)
    gen = torch.Generator().manual_seed(0)
    ttemps, tks = temps, top_ks
    if temps_on_device:
        ttemps, tks = torch.as_tensor(temps), torch.as_tensor(top_ks)
    tdraws = tsampler.sample_tokens(torch.as_tensor(rows), ttemps, tks,
                                    gen).numpy().reshape(n, 2)
    assert (tdraws[:, 1] == probs.argmax()).all()
    assert (jdraws[:, 1] == probs.argmax()).all()
    assert set(tdraws[:, 0]) <= set(order[:k].tolist())
    assert _tv_to(p_tau, tdraws[:, 0]) < 0.05
    assert _tv_to(p_tau, jdraws[:, 0]) < 0.05


def test_all_greedy_host_batch_skips_the_draw():
    """Host arrays with no sampled row return argmax without drawing;
    device tensors draw (the captured round's branch) and still give
    argmax for greedy rows."""
    probs = torch.softmax(torch.randn(3, V, generator=torch.Generator()
                                      .manual_seed(1)), dim=1)
    gen = torch.Generator().manual_seed(2)
    state = gen.get_state()
    zeros, ks = np.zeros(3, np.float32), np.full(3, V)
    got = tsampler.sample_tokens(probs, zeros, ks, gen)
    assert torch.equal(gen.get_state(), state)
    dev = tsampler.sample_tokens(probs, torch.as_tensor(zeros),
                                 torch.as_tensor(ks), gen)
    assert not torch.equal(gen.get_state(), state)
    want = probs.argmax(dim=1).to(torch.int32)
    assert torch.equal(got, want) and torch.equal(dev, want)
