"""The PyTorch port's graph package and DeepWalk against the JAX
package, on the CPU.

The walks are numpy's in both packages, so the same graph and seed give
the same walks (unweighted, weighted, self-looping and through the
iterator facades). DeepWalk trains with hierarchical softmax only,
which draws nothing on the device: from JAX's initial ``syn0`` one
training chunk and a whole ``fit`` give the same tables at 1e-5. The
port's own run meets JAX's clique-structure criterion, and at
``chip_smoke.py``'s size (twice the JAX test's walks and epochs) it
meets it by a margin over several seeds of its initial tables."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.graph import DeepWalk as JDeepWalk
from deeplearning4j_tpu.graph import Graph as JGraph
from deeplearning4j_tpu.graph import loader as jloader
from deeplearning4j_tpu.graph import walker as jwalker

from deeplearning4j_tpu_torch.graph import DeepWalk as TDeepWalk
from deeplearning4j_tpu_torch.graph import Graph as TGraph
from deeplearning4j_tpu_torch.graph import loader as tloader
from deeplearning4j_tpu_torch.graph import walker as twalker
from deeplearning4j_tpu_torch.graph.api import NoEdgesException
from torch_port_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
CHUNK = 4


def _two_cliques(cls, k=6):
    """Two k-cliques joined by a single bridge edge (JAX's test graph)."""
    g = cls(2 * k)
    for base in (0, k):
        for i in range(k):
            for j in range(i + 1, k):
                g.add_edge(base + i, base + j)
    g.add_edge(0, k)
    return g


def _weighted(cls):
    g = cls(5)
    for a, b, w in ((0, 1, 100.0), (0, 2, 0.01), (1, 3, 2.0), (3, 4, 0.5),
                    (2, 4, 1.0)):
        g.add_edge(a, b, weight=w)
    return g


@pytest.mark.parametrize("case", ["cliques", "weighted", "self_loop",
                                  "iterator", "weighted_iterator"])
def test_walks_match(case):
    if case == "cliques":
        a = jwalker.generate_walks(_two_cliques(JGraph), 12, 3, seed=4)
        b = twalker.generate_walks(_two_cliques(TGraph), 12, 3, seed=4)
    elif case == "weighted":
        a = jwalker.generate_walks(_weighted(JGraph), 8, 4, weighted=True,
                                   seed=9)
        b = twalker.generate_walks(_weighted(TGraph), 8, 4, weighted=True,
                                   seed=9)
    elif case == "self_loop":
        gj, gt = JGraph(3), TGraph(3)
        gj.add_edge(0, 1)
        gt.add_edge(0, 1)
        a = jwalker.generate_walks(gj, 5, seed=0)
        b = twalker.generate_walks(gt, 5, seed=0)
        with pytest.raises(NoEdgesException):
            twalker.generate_walks(
                gt, 5, no_edge_handling=twalker.NoEdgeHandling
                .EXCEPTION_ON_DISCONNECTED)
    elif case == "iterator":
        a = list(jwalker.RandomWalkIterator(_two_cliques(JGraph), 5, seed=3))
        b = list(twalker.RandomWalkIterator(_two_cliques(TGraph), 5, seed=3))
    else:
        a = list(jwalker.WeightedRandomWalkIterator(_weighted(JGraph), 4,
                                                    seed=5))
        b = list(twalker.WeightedRandomWalkIterator(_weighted(TGraph), 4,
                                                    seed=5))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_loaders_match(tmp_path):
    p = tmp_path / "edges.txt"
    p.write_text("# comment\n0,1\n1,2\n2,3\n")
    pw = tmp_path / "weighted.txt"
    pw.write_text("0,1,0.5\n1,2,2.0\n")
    for fn, path, n in (("load_undirected_graph", p, 4),
                        ("load_weighted_edge_list", pw, 3)):
        gj = getattr(jloader, fn)(str(path), n)
        gt = getattr(tloader, fn)(str(path), n)
        for x, y in zip(gj.neighbor_table(), gt.neighbor_table()):
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def walkers():
    """A JAX DeepWalk and a port one initialized on the same graph, the
    port's syn0 carried from JAX's."""
    kw = dict(vector_size=16, window_size=4, walks_per_vertex=4, epochs=2,
              seed=7, batch_size=128, learning_rate=0.05)
    j = JDeepWalk(**kw)
    t = TDeepWalk(device="cpu", **kw)
    j.initialize(_two_cliques(JGraph))
    t.initialize(_two_cliques(TGraph))
    j._sv._DISPATCH_CHUNK = t._sv._DISPATCH_CHUNK = CHUNK
    t._sv.load_tables(np.asarray(j._sv.syn0))
    return j, t


def test_one_training_chunk_matches(walkers):
    j, t = walkers
    walks = jwalker.generate_walks(j._graph, 20, 4, seed=j.seed)
    seqs = [[str(int(v)) for v in w] for w in walks]
    flat, seq = j._sv._tokenize_corpus(seqs)
    batches = list(j._sv._mine_pairs_from_ids(
        flat, seq, np.random.default_rng(1)))
    lmax = batches[0][2]
    sel = [b for b in batches if b[2] == lmax][:CHUNK]
    cen = np.stack([b[0] for b in sel])
    ctx = np.stack([b[1] for b in sel])
    lrs = np.full((len(sel),), 0.05, np.float32)
    s0, s1, _ = j._sv._hs_step(lmax)(
        jnp.array(j._sv.syn0), jnp.array(j._sv.syn1), jnp.asarray(cen),
        jnp.asarray(ctx), jnp.asarray(lrs))
    tables = (t._sv.syn0.clone(), t._sv.syn1.clone())
    t._sv.hs_chunk(torch.as_tensor(cen), torch.as_tensor(ctx),
                   torch.as_tensor(lrs), lmax, tables)
    np.testing.assert_allclose(tables[0].numpy(), np.asarray(s0), **TOL)
    np.testing.assert_allclose(tables[1].numpy(), np.asarray(s1), **TOL)


def test_fit_matches_and_cliques_cluster(walkers):
    j, t = walkers
    j.fit(walk_length=20)
    t.fit(walk_length=20)
    np.testing.assert_allclose(t._sv.syn0.numpy(), np.asarray(j._sv.syn0),
                               **TOL)
    np.testing.assert_allclose(t._sv.syn1.numpy(), np.asarray(j._sv.syn1),
                               **TOL)
    same = [t.similarity(a, b) for a in range(6) for b in range(a + 1, 6)]
    cross = [t.similarity(a, b + 6) for a in range(1, 6)
             for b in range(1, 6)]
    assert np.mean(same) > np.mean(cross)
    assert t.verts_nearest(1, 3) == j.verts_nearest(1, 3)
    assert t.get_vertex_vector(0).shape == (16,)


@pytest.mark.parametrize("seed", [0, 1, 6])
def test_cliques_cluster_at_the_smoke_size(seed):
    """At the JAX test's size (20 walks a vertex, 2 epochs) the
    criterion fails for some of these seeds; at twice that it holds by
    more than 0.25."""
    dw = TDeepWalk(vector_size=32, window_size=4, walks_per_vertex=40,
                   epochs=4, seed=seed, batch_size=512, learning_rate=0.05,
                   device="cpu")
    dw.initialize(_two_cliques(TGraph))
    dw.fit(walk_length=20)
    same = np.mean([dw.similarity(a, b) for a in range(6)
                    for b in range(a + 1, 6)])
    cross = np.mean([dw.similarity(a, b + 6) for a in range(1, 6)
                     for b in range(1, 6)])
    assert same - cross > 0.25, (same, cross)
