"""The PyTorch port's streaming decode against the JAX package.

``AttentionImpl._stream_attend`` on the same numpy inputs; the
streaming-state utilities of ``nn/streaming.py``; and
``rnn_time_step``, ``rnn_clear_previous_state`` and ``generate`` of
nets loaded from ONE JAX-written model zip (``transformer_lm`` and
``transformer_lm_flagship``, width 32, 2 layers, 4 heads, a 64-token
window), past the window. The port's ``generate`` runs its decode body
eagerly here (the CPU); on the card the same body replays as captured
CUDA graphs (``chip_smoke.py``). ``GraphRunner``'s bookkeeping is
checked with stand-ins for the CUDA graph calls.

Tolerances: 1e-4 absolute and relative at float32 on attention outputs,
caches and network outputs (the two frameworks sum in different
orders); ``filled`` and greedy ids exact at float32; at bf16 compute,
at least 0.9 of the generated ids agree (bench.py's decode gate)."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import deeplearning4j_tpu.nn.layers.attention as jattn_mod
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import streaming as jstream
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu.util.model_serializer import write_model

import deeplearning4j_tpu_torch.nn.layers.attention as tattn_mod
from deeplearning4j_tpu_torch.nn import cuda_graphs
from deeplearning4j_tpu_torch.nn import streaming as tstream
from deeplearning4j_tpu_torch.util.model_serializer import restore_model
from torch_port_threads import one_torch_thread  # noqa: F401

V, WINDOW = 16, 64
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def _write_zip(path, arch, compute_dtype=None, width=32, n_heads=4):
    if arch == "flagship":
        conf = jzoo.transformer_lm_flagship(vocab=V, width=width,
                                            n_layers=2, n_heads=n_heads,
                                            seed=5)
    else:
        conf = jzoo.transformer_lm(n_in=V, width=width, n_layers=2,
                                   n_heads=n_heads, n_classes=V, seed=5)
    for c in conf.confs:
        if compute_dtype:
            c.compute_dtype = compute_dtype
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    write_model(JNet(conf).init(), path)
    return path


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    d = tmp_path_factory.mktemp("zips")
    return {(arch, cd): _write_zip(str(d / f"{arch}_{cd}.zip"), arch, cd)
            for arch in ("flagship", "transformer_lm")
            for cd in (None, "bfloat16")}


def _pair(zips, arch, cd=None):
    path = zips[(arch, cd)]
    return JNet.load(path), restore_model(path, device="cpu")


def _one_hot(ids_rows):
    ids_rows = np.asarray(ids_rows)
    b, t = ids_rows.shape
    x = np.zeros((b, V, t), np.float32)
    for r in range(b):
        x[r, ids_rows[r], np.arange(t)] = 1.0
    return x


def _prompt(seed=0, b=2, t=10):
    return np.random.default_rng(seed).integers(0, V, (b, t))


# ------------------------------------------------------ _stream_attend
def _attn_beans(causal=True, tm=16):
    kw = dict(n_in=32, n_out=32, n_heads=4, causal=causal, stream_max_t=tm)
    return (jattn_mod.MultiHeadSelfAttention(**kw),
            tattn_mod.MultiHeadSelfAttention(**kw))


def _stream_case(rng, t, fill, masked, tm=16, n=3, h=4, dh=8):
    q, k, v = (rng.normal(size=(n, h, t, dh)).astype(np.float32)
               for _ in range(3))
    ck, cv = (rng.normal(size=(n, h, tm, dh)).astype(np.float32)
              for _ in range(2))
    filled = {"empty": [0, 0, 0], "partial": [0, 5, 11],
              "saturated": [tm, tm, tm]}[fill]
    filled = np.asarray(filled, np.int32)
    # positions a row has not filled hold zeros, as a real cache does
    for r in range(n):
        ck[r, :, :tm - filled[r]] = 0.0
        cv[r, :, :tm - filled[r]] = 0.0
    mask = None
    if masked:
        mask = np.ones((n, t), np.float32)
        mask[1, t // 2 + 1:] = 0.0
        mask[2, 1:] = 0.0
    return q, k, v, {"k": ck, "v": cv, "filled": filled}, mask


def _both_stream(q, k, v, cache, mask, causal=True, tm=16, q_dtype=None):
    jb, tb = _attn_beans(causal, tm)
    jq = jnp.asarray(q, q_dtype or jnp.float32)
    jo, jc = jattn_mod.AttentionImpl._stream_attend(
        jb, jq, jnp.asarray(k, jq.dtype), jnp.asarray(v, jq.dtype),
        {n: jnp.asarray(a) for n, a in cache.items()},
        None if mask is None else jnp.asarray(mask))
    tq = torch.as_tensor(q).to(torch.bfloat16 if q_dtype else torch.float32)
    to, tc = tattn_mod.AttentionImpl._stream_attend(
        tb, tq, torch.as_tensor(k).to(tq.dtype),
        torch.as_tensor(v).to(tq.dtype),
        {n: torch.as_tensor(a) for n, a in cache.items()},
        None if mask is None else torch.as_tensor(mask))
    return (jo, jc), (to, tc)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fill", ["empty", "partial", "saturated"])
@pytest.mark.parametrize("t", [1, 3])
def test_stream_attend_matches_jax(t, fill, masked):
    rng = np.random.default_rng(t * 10 + len(fill) + masked)
    q, k, v, cache, mask = _stream_case(rng, t, fill, masked)
    (jo, jc), (to, tc) = _both_stream(q, k, v, cache, mask)
    np.testing.assert_allclose(_np(to), np.asarray(jo), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]),
                                   **TOL)
    assert tc["filled"].dtype == torch.int32
    np.testing.assert_array_equal(tc["filled"].numpy(),
                                  np.asarray(jc["filled"]))


def test_stream_attend_bf16_queries_over_the_f32_cache():
    """A bf16 net carries its cache at the f32 master dtype: q, k and v
    in bf16 meet the f32 cache in f32, as under JAX's promotion, with
    the score divisor sqrt(dh) rounded to bf16."""
    rng = np.random.default_rng(3)
    q, k, v, cache, mask = _stream_case(rng, 3, "partial", True)
    (jo, jc), (to, tc) = _both_stream(q, k, v, cache, mask,
                                      q_dtype=jnp.bfloat16)
    assert jo.dtype == jnp.float32 and to.dtype == torch.float32
    np.testing.assert_allclose(_np(to), np.asarray(jo), **TOL)
    np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), **TOL)


def test_stream_attend_refuses_non_causal_and_long_chunks():
    rng = np.random.default_rng(4)
    q, k, v, cache, _ = _stream_case(rng, 3, "partial", False)
    tb = _attn_beans(causal=False)[1]
    args = [torch.as_tensor(a) for a in (q, k, v)]
    tcache = {n: torch.as_tensor(a) for n, a in cache.items()}
    with pytest.raises(ValueError, match="non-causal"):
        tattn_mod.AttentionImpl._stream_attend(tb, *args, tcache)
    q, k, v, cache, _ = _stream_case(rng, 5, "partial", False, tm=4)
    tb = _attn_beans(tm=4)[1]
    with pytest.raises(ValueError, match="stream_max_t=4"):
        tattn_mod.AttentionImpl._stream_attend(
            tb, *(torch.as_tensor(a) for a in (q, k, v)),
            {n: torch.as_tensor(a) for n, a in cache.items()})


def test_guard_streamable(zips):
    tattn_mod.guard_streamable([("0", _attn_beans()[1])])
    bean = _attn_beans()[1]
    bean.ring_axis = "sp"
    with pytest.raises(ValueError, match="ring_axis='sp'"):
        tattn_mod.guard_streamable([("3", bean)])
    _, tnet = _pair(zips, "flagship")
    tnet.conf.confs[0].layer.ring_axis = "sp"
    with pytest.raises(ValueError, match="layer 0"):
        tnet.rnn_time_step(_one_hot(_prompt()))


def test_rnn_time_step_refuses_a_non_causal_net(zips):
    _, tnet = _pair(zips, "transformer_lm")
    tnet.rnn_time_step(_one_hot(_prompt()))      # prefill: no stream yet
    for c in tnet.conf.confs:
        if hasattr(c.layer, "causal"):
            c.layer.causal = False
    with pytest.raises(ValueError, match="non-causal"):
        tnet.rnn_time_step(_one_hot(_prompt(t=1)))


# ------------------------------------------------- streaming utilities
def _dense_state(rng, n=3, tm=8, paged=False):
    st = {}
    for name in ("0", "1"):
        if paged:
            st[name] = {"pk": rng.normal(size=(5, 4, 2, 3)).astype(
                            np.float32),
                        "pv": rng.normal(size=(5, 4, 2, 3)).astype(
                            np.float32),
                        "filled": np.asarray([6, 9, 2], np.int32)}
        else:
            st[name] = {"k": rng.normal(size=(n, 2, tm, 3)).astype(
                            np.float32),
                        "v": rng.normal(size=(n, 2, tm, 3)).astype(
                            np.float32),
                        "filled": np.asarray([3, 8, 5], np.int32)}
    return st


def _jax_tree(st):
    return {n: {k: jnp.asarray(a) for k, a in s.items()}
            for n, s in st.items()}


def _torch_tree(st):
    return {n: {k: torch.as_tensor(a.copy()) for k, a in s.items()}
            for n, s in st.items()}


def _assert_trees_equal(tt, jt):
    assert set(tt) == set(jt)
    for n in jt:
        assert set(tt[n]) == set(jt[n])
        for k in jt[n]:
            np.testing.assert_array_equal(tt[n][k].numpy(),
                                          np.asarray(jt[n][k]))
            assert str(tt[n][k].dtype).split(".")[-1] == str(jt[n][k].dtype)


@pytest.mark.parametrize("slots", [[0], [2, 1], [1, 1], []])
def test_clear_state_rows_matches_jax(slots):
    st = _dense_state(np.random.default_rng(1))
    want = jstream.clear_state_rows(_jax_tree(st), slots)
    tt = _torch_tree(st)
    leaf = tt["0"]["k"]
    got = tstream.clear_state_rows(tt, slots)
    _assert_trees_equal(got, want)
    assert got["0"]["k"] is leaf     # in place: the pool keeps storage


def test_clear_state_rows_refuses_bad_slots_and_scalar_leaves():
    st = _torch_tree(_dense_state(np.random.default_rng(2)))
    with pytest.raises(ValueError, match=r"slots \[3\] out of range"):
        tstream.clear_state_rows(st, [3])
    with pytest.raises(ValueError, match="scalar"):
        tstream.clear_state_rows({"0": {"filled": torch.tensor(3)}}, [0])


@pytest.mark.parametrize("slots", [None, [1]])
def test_reset_streaming_state_matches_jax(slots):
    st = _dense_state(np.random.default_rng(5))
    want = jstream.reset_streaming_state(_jax_tree(st), slots)
    got = tstream.reset_streaming_state(_torch_tree(st), slots)
    if slots is None:
        assert got == {} and want == {}
    else:
        _assert_trees_equal(got, want)
    with pytest.raises(ValueError, match="no streaming state"):
        tstream.reset_streaming_state({}, [0])


@pytest.mark.parametrize("drop", [0, 2, [1, 0, 3]],
                         ids=["zero", "scalar", "per_row"])
@pytest.mark.parametrize("paged", [False, True])
def test_drop_newest_tokens_matches_jax(paged, drop):
    st = _dense_state(np.random.default_rng(6), paged=paged)
    jdrop = np.asarray(drop, np.int32) if isinstance(drop, list) else drop
    want = jstream.drop_newest_tokens(_jax_tree(st), jdrop)
    got = tstream.drop_newest_tokens(_torch_tree(st), drop)
    _assert_trees_equal(got, want)


def test_drop_newest_tokens_refuses_bad_input():
    st = _torch_tree(_dense_state(np.random.default_rng(7)))
    with pytest.raises(ValueError, match="scalar or per-row"):
        tstream.drop_newest_tokens(st, [[1]])
    with pytest.raises(ValueError, match="'filled' vector"):
        tstream.drop_newest_tokens({"0": {"h": torch.zeros(2)}}, 1)


def test_scan_length_bucket_matches_jax():
    for n in (0, 1, 7, 8, 9, 99, 128, 129, 1000):
        assert tstream.scan_length_bucket(n) == jstream.scan_length_bucket(n)


# ------------------------------------------------ network streaming
@pytest.mark.parametrize("arch", ["flagship", "transformer_lm"])
def test_rnn_time_step_past_the_window_matches_jax(zips, arch):
    """A 10-token prompt then 70 greedy single steps (past the 64-token
    window), each side feeding back its own argmax."""
    jnet, tnet = _pair(zips, arch)
    x = _one_hot(_prompt())
    jo = np.asarray(jnet.rnn_time_step(x))
    to = tnet.rnn_time_step(x)
    np.testing.assert_allclose(_np(to), jo, **TOL)
    jtok = jo[:, :, -1].argmax(axis=1)
    ttok = _np(to)[:, :, -1].argmax(axis=1)
    for _ in range(70):
        np.testing.assert_array_equal(ttok, jtok)
        jo = np.asarray(jnet.rnn_time_step(_one_hot(jtok[:, None])))
        to = tnet.rnn_time_step(_one_hot(ttok[:, None]))
        np.testing.assert_allclose(_np(to), jo, **TOL)
        jtok, ttok = jo[:, :, 0].argmax(axis=1), _np(to)[:, :, 0].argmax(
            axis=1)
    for name, st in jnet._rnn_state.items():
        np.testing.assert_array_equal(
            tnet._rnn_state[name]["filled"].numpy(), np.asarray(st["filled"]))
        np.testing.assert_allclose(_np(tnet._rnn_state[name]["k"]),
                                   np.asarray(st["k"]), **TOL)


def test_rnn_time_step_chunk_equals_single_steps(zips):
    """Streaming a 3-token chunk gives the same outputs and cache as
    streaming its tokens one at a time."""
    _, a = _pair(zips, "flagship")
    _, b = _pair(zips, "flagship")
    x = _one_hot(_prompt())
    a.rnn_time_step(x)
    b.rnn_time_step(x)
    chunk = _one_hot(_prompt(seed=1, t=3))
    ya = a.rnn_time_step(chunk)
    yb = torch.cat([b.rnn_time_step(chunk[:, :, i]) for i in range(3)],
                   dim=2)
    np.testing.assert_allclose(_np(ya), _np(yb), atol=1e-5)
    for name in a._rnn_state:
        np.testing.assert_allclose(_np(a._rnn_state[name]["k"]),
                                   _np(b._rnn_state[name]["k"]), atol=1e-5)


def test_rnn_clear_previous_state_slots_matches_jax(zips):
    """Clearing one row restarts that row as an empty cache while the
    other keeps streaming, in both packages."""
    jnet, tnet = _pair(zips, "flagship")
    x = _one_hot(_prompt())
    jnet.rnn_time_step(x)
    tnet.rnn_time_step(x)
    jnet.rnn_clear_previous_state(slots=[1])
    tnet.rnn_clear_previous_state(slots=[1])
    step = _one_hot(_prompt(seed=2, t=2))
    np.testing.assert_allclose(_np(tnet.rnn_time_step(step)),
                               np.asarray(jnet.rnn_time_step(step)), **TOL)
    assert tnet._rnn_state["1"]["filled"].tolist() == [12, 2]
    tnet.rnn_clear_previous_state()
    assert tnet._rnn_state == {}
    with pytest.raises(ValueError, match="no streaming state"):
        tnet.rnn_clear_previous_state(slots=[0])


@pytest.mark.parametrize("n", [1, 12, 100])
@pytest.mark.parametrize("arch", ["flagship", "transformer_lm"])
def test_generate_matches_jax(zips, arch, n):
    jnet, tnet = _pair(zips, arch)
    x = _one_hot(_prompt())
    want = np.asarray(jnet.generate(x, n))
    got = tnet.generate(x, n)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, n)
    np.testing.assert_array_equal(got.numpy(), want)
    for name, st in jnet._rnn_state.items():
        np.testing.assert_array_equal(
            tnet._rnn_state[name]["filled"].numpy(), np.asarray(st["filled"]))
        np.testing.assert_allclose(_np(tnet._rnn_state[name]["v"]),
                                   np.asarray(st["v"]), **TOL)


@pytest.mark.parametrize("arch", ["flagship", "transformer_lm"])
def test_generate_bf16_agrees_with_jax(zips, arch):
    jnet, tnet = _pair(zips, arch, "bfloat16")
    x = _one_hot(_prompt())
    want = np.asarray(jnet.generate(x, 100))
    got = tnet.generate(x, 100).numpy()
    assert (got == want).mean() >= 0.9


def test_generate_equals_its_rnn_time_step_loop_and_state_continues(zips):
    """JAX ``tests/test_decode_generate.py``'s contract, on the port:
    ``generate`` gives the greedy loop's ids, and the state it leaves
    continues the same sequence."""
    _, loop = _pair(zips, "flagship")
    _, gen = _pair(zips, "flagship")
    x = _one_hot(_prompt(b=1))
    out = loop.rnn_time_step(x)
    tok = int(out[0, :, -1].argmax())
    ids = [tok]
    for _ in range(11):
        out = loop.rnn_time_step(_one_hot([[tok]]))
        tok = int(out[0, :, 0].argmax())
        ids.append(tok)
    assert gen.generate(x, 12)[0].tolist() == ids
    cont = gen.rnn_time_step(_one_hot([[ids[-1]]]))
    nxt = loop.rnn_time_step(_one_hot([[ids[-1]]]))
    np.testing.assert_allclose(_np(cont), _np(nxt), atol=1e-6)
    with pytest.raises(ValueError, match="n_tokens 0"):
        gen.generate(x, 0)


def test_generate_runs_the_eager_body_on_the_cpu(zips):
    """On the CPU the decode body runs eagerly: no graph is captured,
    and the private eager call gives the same ids."""
    _, a = _pair(zips, "flagship")
    _, b = _pair(zips, "flagship")
    x = _one_hot(_prompt())
    ids = a.generate(x, 20)
    assert len(a.generate_graphs) == 0 and a.generate_graphs.captures == 0
    assert torch.equal(b._generate(x, 20, None), ids)


def test_prefill_through_k1_matches_jax(tmp_path, monkeypatch):
    """An unmasked prompt prefills through K1 on both sides at T=256:
    the JAX Pallas kernel in interpret mode, the port's plain version
    (its dispatch patched to take K1, which on CPU tensors is
    ``flash_attention_reference``). Cache and first-token logits agree
    within 1e-4."""
    calls = {"jax": 0, "port": 0}

    def jax_flash(use_flash, q, mask):
        calls["jax"] += 1
        return True

    def port_flash(use_flash, q, mask):
        calls["port"] += 1
        return True

    monkeypatch.setattr(jattn_mod, "_should_use_flash", jax_flash)
    monkeypatch.setattr(tattn_mod, "_should_use_flash", port_flash)
    path = _write_zip(str(tmp_path / "k1.zip"), "flagship", width=128,
                      n_heads=2)
    jnet, tnet = JNet.load(path), restore_model(path, device="cpu")
    x = _one_hot(_prompt(seed=4, b=1, t=256))
    with pltpu.force_tpu_interpret_mode():
        jo = np.asarray(jnet.rnn_time_step(x))
    to = tnet.rnn_time_step(x)
    assert calls["jax"] >= 2 and calls["port"] == 2
    np.testing.assert_allclose(_np(to)[:, :, -1], jo[:, :, -1], **TOL)
    for name, st in jnet._rnn_state.items():
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(tnet._rnn_state[name][k]),
                                       np.asarray(st[k]), **TOL)
        np.testing.assert_array_equal(
            tnet._rnn_state[name]["filled"].numpy(), np.asarray(st["filled"]))


# ------------------------------------------------------ GraphRunner
class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay reruns what the
    captured body registered."""

    def __init__(self):
        self.generators, self.replay_fn = [], None

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replay_fn()


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors treated as card tensors, with CUDA's stream and graph
    calls replaced by stand-ins."""
    capturing = []

    @contextlib.contextmanager
    def graph(g, pool=None):
        capturing.append(g)
        yield
        capturing.pop()

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(cuda_graphs, "_on_card", lambda leaves: True)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    return capturing


def test_graph_runner_static_buffers_and_launch_counts(fake_card):
    """Warm-up on copies, capture, replays over static inputs; a kernel
    wrapper's count is its launches: the warm-up's and one per replay,
    not the capture's."""
    gen = torch.Generator()
    gen.manual_seed(0)
    seen = []

    def body(ops):
        seen.append(ops["x"])
        tattn_mod.paged_attention.launches += 1   # as a wrapper counts
        out = ops["x"] * 2 + torch.rand((), generator=gen) * 0
        if fake_card:
            fake_card[-1].replay_fn = lambda: out.copy_(ops["x"] * 2)
        return {"y": out}

    runner = cuda_graphs.GraphRunner([gen])
    n0 = tattn_mod.paged_attention.launches
    x = torch.arange(4.0)
    y = runner.run("k", body, {"x": x})["y"]
    assert torch.equal(y, x * 2) and len(runner) == 1
    assert runner.captures == 1
    assert seen[0] is not x and seen[1] is x      # warm-up ran on a copy
    assert tattn_mod.paged_attention.launches == n0 + 2
    assert runner._graphs["k"].graph.generators == [gen]
    x2 = torch.arange(4.0) + 10
    y2 = runner.run("k", body, {"x": x2})["y"]
    assert y2 is y and torch.equal(y, x2 * 2) and torch.equal(x, x2)
    assert runner.captures == 1 and len(seen) == 2
    assert tattn_mod.paged_attention.launches == n0 + 3
    runner.run("k", body, {"x": x})   # the static input itself: no copy
    with pytest.raises(ValueError, match="captured with"):
        runner.run("k", body, {"x": torch.zeros(5)})
    runner.run("other", body, {"x": torch.ones(4)})
    assert len(runner) == 2 and runner.captures == 2
    runner.drop()
    assert len(runner) == 0
    tattn_mod.paged_attention.launches = n0


def test_graph_runner_capture_failure_raises(fake_card):
    """A body that fails under capture raises out of ``run``: nothing
    runs eagerly in its place and no graph is kept."""
    calls = []

    def body(ops):
        calls.append(bool(fake_card))
        if fake_card:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return ops["x"] + 1

    runner = cuda_graphs.GraphRunner()
    with pytest.raises(RuntimeError, match="capturing"):
        runner.run("k", body, {"x": torch.zeros(2)})
    assert calls == [False, True]       # the warm-up, then the capture
    assert len(runner) == 0 and runner.captures == 0


def test_graph_runner_runs_cpu_tensors_eagerly():
    runner = cuda_graphs.GraphRunner()
    out = runner.run("k", lambda ops: ops["x"] + 1, {"x": torch.zeros(2)})
    assert torch.equal(out, torch.ones(2))
    assert len(runner) == 0 and runner.captures == 0
