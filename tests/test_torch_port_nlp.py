"""The PyTorch port's embedding trainers and text pipeline against the
JAX package, on the CPU.

The same corpus (``raw_sentences(limit=...)``) and the same seeds give
the same vocabulary, Huffman codes, unigram table and mined pairs in
both packages (the miner's draws are numpy's in both, through the C++
miner or its numpy version). From tables carried across, one HS chunk
per code-length class, one NS chunk fed JAX's negatives, a whole
HS-only ``fit``, a GloVe pass with the same permutation and
``infer_vector``'s loop with JAX's initial vector and draws agree with
JAX at 1e-5 (the two frameworks sum in different orders; ``index_add_``
and XLA's scatter-add both sum duplicate rows). The serializer's text
and Google-binary files are byte-identical from the same vectors, and
each package loads the other's. Small sizes throughout: D=16, batches
of 256, chunks of 4 batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.fixtures import raw_sentences
from deeplearning4j_tpu.nlp import glove as jglove
from deeplearning4j_tpu.nlp import moving_window as jmw
from deeplearning4j_tpu.nlp import paragraph_vectors as jpvmod
from deeplearning4j_tpu.nlp import sentence_iterator as jsi
from deeplearning4j_tpu.nlp import serializer as jser
from deeplearning4j_tpu.nlp import tokenization as jtok
from deeplearning4j_tpu.nlp import vectorizers as jvec
from deeplearning4j_tpu.nlp import vocab as jvocab
from deeplearning4j_tpu.nlp import word2vec_iterator as jw2vit
from deeplearning4j_tpu.nlp import document_iterator as jdoc
from deeplearning4j_tpu.nlp import labels as jlabels
from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JWord2Vec
from deeplearning4j_tpu.native_rt import lib as jlib

from deeplearning4j_tpu_torch.nlp import glove as tglove
from deeplearning4j_tpu_torch.nlp import moving_window as tmw
from deeplearning4j_tpu_torch.nlp import paragraph_vectors as tpvmod
from deeplearning4j_tpu_torch.nlp import sentence_iterator as tsi
from deeplearning4j_tpu_torch.nlp import serializer as tser
from deeplearning4j_tpu_torch.nlp import tokenization as ttok
from deeplearning4j_tpu_torch.nlp import vectorizers as tvec
from deeplearning4j_tpu_torch.nlp import vocab as tvocab
from deeplearning4j_tpu_torch.nlp import word2vec_iterator as tw2vit
from deeplearning4j_tpu_torch.nlp import document_iterator as tdoc
from deeplearning4j_tpu_torch.nlp import labels as tlabels
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec as TWord2Vec
from deeplearning4j_tpu_torch.native_rt import lib as tlib
from torch_port_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
D, BATCH, CHUNK = 16, 256, 4
LRS = np.asarray([0.025, 0.02, 0.015, 0.01], np.float32)
W2V = dict(layer_size=D, window=5, min_word_frequency=2, batch_size=BATCH,
           seed=3, subsampling=1e-3)


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(
        t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def sents():
    return raw_sentences(limit=2000)


@pytest.fixture(scope="module")
def pair(sents):
    """A JAX Word2Vec and a port one on the same vocabulary (HS and NS
    both on), the port's tables carried from JAX's with syn1/syn1neg
    made nonzero."""
    kw = dict(W2V, use_hierarchic_softmax=True, negative=5)
    j = JWord2Vec(**kw)
    j.build_vocab_from(sents)
    t = TWord2Vec(device="cpu", **kw)
    t.build_vocab_from(sents)
    rng = np.random.default_rng(0)
    v = j.vocab.num_words()
    syn1 = (rng.normal(size=(v, D)) * 0.1).astype(np.float32)
    syn1neg = (rng.normal(size=(v, D)) * 0.1).astype(np.float32)
    j.syn1, j.syn1neg = jnp.asarray(syn1), jnp.asarray(syn1neg)
    t.load_tables(np.asarray(j.syn0), syn1, syn1neg)
    return j, t


def _batches(model, sents, seed=3):
    flat, seq = model._tokenize_corpus(sents)
    return list(model._mine_pairs_from_ids(flat, seq,
                                           np.random.default_rng(seed)))


# ---------------------------------------------------------------------------
# vocabulary, Huffman codes, mined pairs
# ---------------------------------------------------------------------------

def test_vocab_huffman_and_unigram_table_match(pair):
    j, t = pair
    jw = [(w.word, w.count, w.index) for w in j.vocab.vocab_words()]
    tw = [(w.word, w.count, w.index) for w in t.vocab.vocab_words()]
    assert jw == tw
    for a, b in zip(jvocab.huffman_arrays(j.vocab),
                    tvocab.huffman_arrays(t.vocab)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(j._neg_table),
                                  _np(t._neg_table).astype(np.int32))
    np.testing.assert_array_equal(np.asarray(j._codes), _np(t._codes))
    np.testing.assert_array_equal(np.asarray(j._points),
                                  _np(t._points).astype(np.int32))


@pytest.mark.parametrize("miner", ["native", "numpy"])
def test_mined_pairs_match(pair, sents, miner, monkeypatch):
    j, t = pair
    if miner == "numpy":
        monkeypatch.setattr(jlib, "native_available", lambda: False)
        monkeypatch.setattr(tlib, "native_available", lambda: False)
    else:
        assert jlib.native_available() == tlib.native_available()
    flat_j, seq_j = j._tokenize_corpus(sents)
    flat_t, seq_t = t._tokenize_corpus(sents)
    np.testing.assert_array_equal(flat_j, flat_t)
    np.testing.assert_array_equal(seq_j, seq_t)
    bj, bt = _batches(j, sents), _batches(t, sents)
    assert len(bj) == len(bt) > 8
    for (cj, xj, lj, oj), (ct, xt, lt, ot) in zip(bj, bt):
        np.testing.assert_array_equal(cj, ct)
        np.testing.assert_array_equal(xj, xt)
        assert (lj, oj) == (lt, ot)


# ---------------------------------------------------------------------------
# one chunk of each objective, from carried tables
# ---------------------------------------------------------------------------

def _chunk(batches, lmax):
    sel = [b for b in batches if b[2] == lmax and len(b[0]) == BATCH]
    assert len(sel) >= CHUNK, (lmax, len(sel))
    cen = np.stack([b[0] for b in sel[:CHUNK]])
    ctx = np.stack([b[1] for b in sel[:CHUNK]])
    return cen, ctx


@pytest.mark.parametrize("cls", ["short", "long"])
def test_hs_chunk_matches(pair, sents, cls):
    j, t = pair
    lmaxes = sorted({b[2] for b in _batches(j, sents)})
    assert len(lmaxes) == 2
    lmax = lmaxes[0] if cls == "short" else lmaxes[1]
    cen, ctx = _chunk(_batches(j, sents), lmax)
    s0, s1, jloss = j._hs_step(lmax)(
        jnp.array(j.syn0), jnp.array(j.syn1), jnp.asarray(cen),
        jnp.asarray(ctx), jnp.asarray(LRS))
    tables = (t.syn0.clone(), t.syn1.clone())
    tloss = t.hs_chunk(torch.as_tensor(cen), torch.as_tensor(ctx),
                       torch.as_tensor(LRS), lmax, tables)
    np.testing.assert_allclose(_np(tables[0]), np.asarray(s0), **TOL)
    np.testing.assert_allclose(_np(tables[1]), np.asarray(s1), **TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    assert not np.array_equal(_np(tables[1]), _np(t.syn1))


def _jax_draws(key, s, b, k, table_size):
    """The draws JAX's scanned NS step makes from ``key``: one split per
    batch, ``randint`` on the subkey."""
    out = []
    for _ in range(s):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (b, k), 0,
                                                 table_size)))
    return np.stack(out)


def test_ns_chunk_matches_with_jax_negatives(pair, sents):
    j, t = pair
    batches = _batches(j, sents)
    cen, ctx = _chunk(batches, batches[0][2])
    key = jax.random.key(17)
    s0, s1n, jloss = j._ns_step(
        jnp.array(j.syn0), jnp.array(j.syn1neg), jnp.asarray(cen),
        jnp.asarray(ctx), jnp.asarray(LRS), key)
    draws = _jax_draws(key, CHUNK, BATCH, j.negative, j._neg_table.shape[0])
    tables = (t.syn0.clone(), t.syn1neg.clone())
    tloss = t.ns_chunk(torch.as_tensor(cen), torch.as_tensor(ctx),
                       torch.as_tensor(LRS), torch.as_tensor(draws), tables)
    np.testing.assert_allclose(_np(tables[0]), np.asarray(s0), **TOL)
    np.testing.assert_allclose(_np(tables[1]), np.asarray(s1n), **TOL)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)


def test_hs_fit_matches_from_carried_tables(sents):
    """HS-only ``fit`` draws nothing on the device: from JAX's initial
    syn0 both packages train the same pairs, chunk by chunk (tails
    included), and end with the same tables."""
    kw = dict(W2V, use_hierarchic_softmax=True, negative=0, epochs=2)
    j = JWord2Vec(**kw)
    j._DISPATCH_CHUNK = CHUNK
    j.build_vocab_from(sents[:600])
    t = TWord2Vec(device="cpu", **kw)
    t._DISPATCH_CHUNK = CHUNK
    t.build_vocab_from(sents[:600])
    t.load_tables(np.asarray(j.syn0))
    j.fit(sents[:600])
    t.fit(sents[:600])
    assert t._pairs_trained == j._pairs_trained > 0
    np.testing.assert_allclose(_np(t.syn0), np.asarray(j.syn0), **TOL)
    np.testing.assert_allclose(_np(t.syn1), np.asarray(j.syn1), **TOL)
    assert len(t.pass_losses) == 2
    assert all(np.isfinite(d["hs"]) for d in t.pass_losses)


@pytest.fixture
def replaying_runner(monkeypatch):
    """CPU tensors treated as card tensors by ``GraphRunner``, with a
    stand-in capture whose replay reruns the body on the static inputs
    and writes the results into the captured outputs, as a graph replay
    overwrites them (``tests/test_torch_port_graph.py``'s)."""
    from deeplearning4j_tpu_torch.nn import cuda_graphs
    from deeplearning4j_tpu_torch.nn.streaming import tree_map

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


def _fit_hs_ns(sents):
    t = TWord2Vec(device="cpu", **dict(W2V, use_hierarchic_softmax=True,
                                       negative=5, epochs=2))
    t._DISPATCH_CHUNK = CHUNK
    t.build_vocab_from(sents[:600])
    t.fit(sents[:600])
    return t


def test_fit_through_replayed_chunks_equals_eager(sents, replaying_runner):
    """``fit`` with its full chunks replayed from captured graphs (each
    later chunk's indices and learning rates copied into the first
    chunk's static inputs, the tables updated in place, the negatives
    drawn from the registered generator) trains exactly what the eager
    chunks train."""
    from deeplearning4j_tpu_torch.nn import cuda_graphs

    replayed = _fit_hs_ns(sents)
    assert {k[0] for k in replayed.graphs.keys()} == {"hs", "ns"}
    assert replayed.graphs.captures == len(replayed.graphs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_graphs, "_on_card", lambda leaves: False)
        eager = _fit_hs_ns(sents)
    assert len(eager.graphs) == 0
    for n in ("syn0", "syn1", "syn1neg"):
        np.testing.assert_array_equal(_np(getattr(replayed, n)),
                                      _np(getattr(eager, n)))
    assert replayed.pass_losses == eager.pass_losses


# ---------------------------------------------------------------------------
# GloVe, ParagraphVectors
# ---------------------------------------------------------------------------

def test_glove_pass_matches(sents):
    corpus = [s.split() for s in sents[:400]]
    kw = dict(layer_size=D, window=4, min_word_frequency=2, x_max=10.0,
              seed=1, batch_size=BATCH)
    j = jglove.Glove(**kw)
    t = tglove.Glove(device="cpu", **kw)
    for m in (j, t):
        m.vocab = jvocab.build_vocab(corpus, 2) if m is j else \
            tvocab.build_vocab(corpus, 2)
        m.init_tables()
    t.load_tables(**{n: np.asarray(getattr(j, n))
                     for n in j.TABLE_NAMES})
    rows, cols, xij = j._count_cooccurrences(corpus)
    rt, ct, xt = t._count_cooccurrences(corpus)
    np.testing.assert_array_equal(rows, rt)
    np.testing.assert_array_equal(xij, xt)
    for _ in range(2):
        lj = j.train_cooccurrences(rows, cols, xij)
        lt = t.train_cooccurrences(rows, cols, xij)
        np.testing.assert_allclose(lt, lj, **TOL)
    for n in j.TABLE_NAMES:
        np.testing.assert_allclose(_np(getattr(t, n)),
                                   np.asarray(getattr(j, n)), **TOL,
                                   err_msg=n)
    np.testing.assert_allclose(_np(t.syn0), np.asarray(j.syn0), **TOL)


def _topic_docs(n=12, seed=2):
    rng = np.random.default_rng(seed)
    day = ["day", "sun", "light", "morning", "noon"]
    night = ["night", "moon", "dark", "evening", "star"]
    docs = [" ".join(rng.choice(day if i % 2 == 0 else night, size=10))
            for i in range(n)]
    return docs, [f"D{i}" for i in range(n)]


def test_infer_vector_matches_with_jax_init_and_draws():
    docs, labels = _topic_docs()
    kw = dict(layer_size=D, epochs=3, seed=8, negative=3,
              use_hierarchic_softmax=True, batch_size=BATCH)
    j = jpvmod.ParagraphVectors(**kw)
    j.fit_documents(docs, labels)
    toks = ["sun", "light", "noon", "day", "moon"]
    idxs = jnp.asarray([j.vocab.index_of(w) for w in toks], jnp.int32)
    codes = j._codes[idxs].astype(jnp.float32)
    points, cmask = j._points[idxs], j._code_mask[idxs]
    key = jax.random.key(5)
    vec0 = (jax.random.uniform(key, (D,)) - 0.5) / D
    steps, lr0 = 20, 0.025
    want = j._infer_fn(vec0, idxs, j.syn1, j.syn1neg, codes, points, cmask,
                       j._neg_table, key, lr0, steps)
    draws = _jax_draws(key, steps, len(toks), 3, j._neg_table.shape[0])
    tt = lambda a, dt=None: torch.as_tensor(np.array(a), dtype=dt)
    got = tpvmod.infer_steps(
        tt(vec0), tt(idxs, torch.int64), tt(j.syn1), tt(j.syn1neg),
        tt(codes), tt(points, torch.int64), tt(cmask),
        tt(j._neg_table, torch.int64), lr0, steps, True, tt(draws))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)

    t = tpvmod.ParagraphVectors(device="cpu", **kw)
    t.fit_documents(docs, labels)
    v = t.infer_vector("sun light noon day")
    assert v.shape == (D,) and np.isfinite(v).all()
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    np.testing.assert_array_equal(t.infer_vector("sun day", generator=g1),
                                  t.infer_vector("sun day", generator=g2))


def test_paragraph_vectors_label_pairs_match():
    docs, labels = _topic_docs()
    kw = dict(layer_size=D, epochs=1, seed=8, batch_size=16)
    j = jpvmod.ParagraphVectors(**kw)
    t = tpvmod.ParagraphVectors(device="cpu", **kw)
    j.fit_documents(docs, labels)
    t.fit_documents(docs, labels)
    tokens = [j.tokenizer_factory.create(d).get_tokens() for d in docs]
    bj = list(j._mine_pairs(j._label_sequences(tokens, labels), None))
    bt = list(t._mine_pairs(t._label_sequences(tokens, labels), None))
    assert len(bj) == len(bt) > 1
    for a, b in zip(bj, bt):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2:] == b[2:]
    assert t.doc_vector("D0").shape == (D,)
    assert t.vocab.index_of("D3") == j.vocab.index_of("D3")


# ---------------------------------------------------------------------------
# the serializer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["text", "google_binary"])
def test_serializer_files_identical_and_cross_load(pair, tmp_path, fmt):
    j, t = pair
    t.load_tables(np.asarray(j.syn0))
    write = {"text": "write_word_vectors",
             "google_binary": "write_google_binary"}[fmt]
    load = {"text": "load_txt_vectors",
            "google_binary": "load_google_binary"}[fmt]
    pj, pt = tmp_path / "j.vec", tmp_path / "t.vec"
    getattr(jser, write)(j, str(pj))
    getattr(tser, write)(t, str(pt))
    assert pj.read_bytes() == pt.read_bytes()
    from_j = getattr(tser, load)(str(pj), device="cpu")
    from_t = getattr(jser, load)(str(pt))
    assert from_j.vocab.words() == j.vocab.words() == from_t.vocab.words()
    want = np.asarray(j.syn0) if fmt != "text" else np.asarray(
        from_t.syn0)
    np.testing.assert_array_equal(_np(from_j.syn0), want)
    np.testing.assert_array_equal(np.asarray(from_t.syn0), _np(from_j.syn0))


# ---------------------------------------------------------------------------
# the copied text pipeline
# ---------------------------------------------------------------------------

def _tokens(mod, factory, text):
    return getattr(mod, factory)().create(text).get_tokens()


PIPELINE_CASES = ["default_tokenizer", "ngram_tokenizer", "preprocessors",
                  "collection_iterator", "line_iterator",
                  "document_windows", "moving_windows", "vectorizers",
                  "word2vec_dataset_iterator", "labels_source"]


@pytest.mark.parametrize("case", PIPELINE_CASES)
def test_text_pipeline_copies_match(pair, sents, tmp_path, case):
    j, t = pair
    text = sents[:40]
    if case == "default_tokenizer":
        for s in text:
            assert (_tokens(jtok, "DefaultTokenizerFactory", s)
                    == _tokens(ttok, "DefaultTokenizerFactory", s))
    elif case == "ngram_tokenizer":
        for s in text:
            assert (jtok.NGramTokenizerFactory(1, 3).create(s).get_tokens()
                    == ttok.NGramTokenizerFactory(1, 3).create(s)
                    .get_tokens())
    elif case == "preprocessors":
        for s in text:
            for name in ("CommonPreprocessor", "LowCasePreProcessor",
                         "EndingPreProcessor"):
                fj, ft = (jtok.DefaultTokenizerFactory(),
                          ttok.DefaultTokenizerFactory())
                fj.set_token_pre_processor(getattr(jtok, name)())
                ft.set_token_pre_processor(getattr(ttok, name)())
                assert (fj.create(s).get_tokens()
                        == ft.create(s).get_tokens())
    elif case == "collection_iterator":
        assert (list(jsi.CollectionSentenceIterator(text))
                == list(tsi.CollectionSentenceIterator(text)) == text)
    elif case == "line_iterator":
        p = tmp_path / "lines.txt"
        p.write_text("\n".join(text) + "\n")
        assert (list(jsi.LineSentenceIterator(str(p)))
                == list(tsi.LineSentenceIterator(str(p))))
    elif case == "document_windows":
        toks = " ".join(text).split()
        wj, wt = jdoc.windows(toks, 5), tdoc.windows(toks, 5)
        assert [repr(w) for w in wj] == [repr(w) for w in wt]
    elif case == "moving_windows":
        for s in text[:10]:
            wj = jmw.windows(jmw.input_homogenization(s), 5)
            wt = tmw.windows(tmw.input_homogenization(s), 5)
            assert [w.as_tokens() for w in wj] == [w.as_tokens() for w in wt]
            for a, b in zip(wj, wt):
                np.testing.assert_array_equal(
                    jmw.WindowConverter.as_example_array(a, j),
                    tmw.WindowConverter.as_example_array(b, j))
    elif case == "vectorizers":
        for name in ("BagOfWordsVectorizer", "TfidfVectorizer"):
            a = getattr(jvec, name)(min_word_frequency=2).fit_transform(text)
            b = getattr(tvec, name)(min_word_frequency=2).fit_transform(text)
            np.testing.assert_allclose(b, a, rtol=1e-12)
    elif case == "word2vec_dataset_iterator":
        labels = ["pos", "neg"]
        lab = [labels[i % 2] for i in range(len(text))]
        t.load_tables(np.asarray(j.syn0))
        ij = jw2vit.Word2VecDataSetIterator(
            j, jsi.LabelledCollectionSentenceIterator(text, lab), labels,
            batch=8)
        it = tw2vit.Word2VecDataSetIterator(
            t, tsi.LabelledCollectionSentenceIterator(text, lab), labels,
            batch=8)
        for _ in range(3):
            a, b = ij.next(), it.next()
            np.testing.assert_allclose(np.asarray(b.features),
                                       np.asarray(a.features), **TOL)
            np.testing.assert_array_equal(np.asarray(b.labels),
                                          np.asarray(a.labels))
    elif case == "labels_source":
        sj, st = jlabels.LabelsSource(), tlabels.LabelsSource()
        assert ([sj.next_label() for _ in range(5)]
                == [st.next_label() for _ in range(5)])
        bj = jlabels.BasicLabelAwareIterator(
            jsi.CollectionSentenceIterator(text[:5]))
        bt = tlabels.BasicLabelAwareIterator(
            tsi.CollectionSentenceIterator(text[:5]))
        assert ([(d.content, d.label) for d in bj]
                == [(d.content, d.label) for d in bt])
