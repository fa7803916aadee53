"""Parity of the port's dense graph models (``triangle_count``, ``k_truss``,
``maximal_matching``, ``betweenness_centrality``, ``louvain`` and
``modularity``) with the JAX package's, case for case with
``tests/test_models.py`` (:166, :174, :208, :269, :290, :315, :342), and
each model on random graphs against the JAX function.

The same numpy-seeded graphs go through both packages on the CPU.  Triangle
counts, k-truss edge sets and matching masks are exact; Louvain labels are
exact on integer weights (the one-hot products are sums of integers, exact
in float32, and both argmaxes take the first maximum).  Betweenness is held
within 1e-5 relative: its float32 path counts and dependencies are summed in
another order by torch than by XLA (the matmuls and the final sum over
sources).  networkx is the third opinion where the reference's tests use
it.  The CUDA tests (``-m cuda``; they skip here) hold the card's results to
the CPU's.
"""

import numpy as np
import pytest
import torch

import importlib

import graphblas_tpu_torch as P
from graphblas_tpu_torch import models as PM

plouvain = importlib.import_module("graphblas_tpu_torch.models.louvain")  # the module: the package exports the function


@pytest.fixture(scope="module")
def RM():
    pytest.importorskip("jax")
    import graphblas_tpu.models as RM

    return RM


@pytest.fixture(autouse=True)
def _pinned():
    with P.tx.config.set(platform="cpu"):
        yield


def both_graphs(RM, src, dst, w=None, n=None):
    return PM.Graph.from_arrays(src, dst, w, n=n), RM.Graph.from_arrays(src, dst, w, n=n)


def random_edges(seed, n, e, weights=None):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    if weights == "int":
        return src, dst, rng.integers(1, 5, e).astype(np.float32)
    if weights == "float":
        return src, dst, (rng.random(e) * 9 + 1).astype(np.float32)
    return src, dst, None


def undirected(seed, n, e):
    """Deduplicated undirected pairs (lo < hi), as the reference's tests draw them."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    keep = src != dst
    return np.unique(np.stack([np.minimum(src[keep], dst[keep]), np.maximum(src[keep], dst[keep])], 1), axis=0)


def edge_set(g):
    valid = g.valid.numpy()
    return set(zip(g.src.numpy()[valid].tolist(), g.dst.numpy()[valid].tolist()))


# ---------------------------------------------------------------------------
# tests/test_models.py's cases
# ---------------------------------------------------------------------------


def test_triangle_count(RM):
    # K4 has 4 triangles
    edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    src, dst = (np.array(x, np.int32) for x in zip(*edges))
    pg, rg = both_graphs(RM, src, dst, n=4)
    assert PM.triangle_count(pg) == RM.triangle_count(rg) == 4


def test_triangle_count_random(RM):
    rng = np.random.default_rng(7)
    n, e = 60, 300
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = (rng.random(e) * 9 + 1).astype(np.float32)
    pg, rg = both_graphs(RM, src, dst, w, n)
    got = PM.triangle_count(pg)
    A = np.zeros((n, n), bool)
    A[src, dst] = True
    A |= A.T
    np.fill_diagonal(A, False)
    Ai = A.astype(np.int64)
    assert got == RM.triangle_count(rg) == int(np.trace(Ai @ Ai @ Ai) // 6)


def test_louvain_two_communities(RM):
    # two dense cliques connected by one edge
    edges = []
    for i in range(5):
        for j in range(i + 1, 5):
            edges.append((i, j))
            edges.append((i + 5, j + 5))
    edges.append((0, 5))
    src, dst = (np.array(x, np.int32) for x in zip(*edges))
    pg, rg = both_graphs(RM, src, dst, n=10)
    labels = PM.louvain(pg).numpy()
    np.testing.assert_array_equal(labels, np.asarray(RM.louvain(rg)))
    assert len(set(labels[:5].tolist())) == 1
    assert len(set(labels[5:].tolist())) == 1
    assert labels[0] != labels[5]


def test_betweenness_centrality_vs_networkx(RM):
    nx = pytest.importorskip("networkx")
    rng = np.random.default_rng(3)
    n = 40
    src = rng.integers(0, n, 200).astype(np.int32)
    dst = rng.integers(0, n, 200).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    pg, rg = both_graphs(RM, src, dst, n=n)
    bc = PM.betweenness_centrality(pg).numpy()
    np.testing.assert_allclose(bc, np.asarray(RM.betweenness_centrality(rg)), rtol=1e-5)
    G = nx.DiGraph()
    G.add_nodes_from(range(n))
    G.add_edges_from(zip(src.tolist(), dst.tolist()))
    ref = nx.betweenness_centrality(G, normalized=False)
    assert np.allclose(bc, [ref[i] for i in range(n)], atol=1e-3)
    # sampled-sources variant returns a per-vertex partial sum
    part = PM.betweenness_centrality(pg, sources=[0, 5, 7]).numpy()
    assert part.shape == (n,)
    np.testing.assert_allclose(part, np.asarray(RM.betweenness_centrality(rg, sources=[0, 5, 7])), rtol=1e-5)


def test_betweenness_centrality_undirected_convention(RM):
    nx = pytest.importorskip("networkx")
    und = undirected(11, 30, 120)
    n = 30
    s = np.concatenate([und[:, 0], und[:, 1]]).astype(np.int32)
    d = np.concatenate([und[:, 1], und[:, 0]]).astype(np.int32)
    pg, rg = both_graphs(RM, s, d, n=n)
    bc = PM.betweenness_centrality(pg).numpy() / 2.0
    np.testing.assert_allclose(bc, np.asarray(RM.betweenness_centrality(rg)) / 2.0, rtol=1e-5)
    G = nx.Graph()
    G.add_nodes_from(range(n))
    G.add_edges_from(und.tolist())
    ref = nx.betweenness_centrality(G, normalized=False)
    assert np.allclose(bc, [ref[i] for i in range(n)], atol=1e-3)


def test_k_truss_vs_networkx(RM):
    nx = pytest.importorskip("networkx")
    und = undirected(3, 40, 200)
    n = 40
    pg, rg = both_graphs(RM, und[:, 0].astype(np.int32), und[:, 1].astype(np.int32), n=n)
    G = nx.Graph()
    G.add_nodes_from(range(n))
    G.add_edges_from(und.tolist())
    for k in (3, 4, 5):
        kt = PM.k_truss(pg, k)
        rk = RM.k_truss(rg, k)
        np.testing.assert_array_equal(kt.src.numpy(), np.asarray(rk.src))
        np.testing.assert_array_equal(kt.dst.numpy(), np.asarray(rk.dst))
        np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(rk.valid))
        assert (kt.n, kt.nedges) == (rk.n, rk.nedges)
        mine = {(a, b) for a, b in edge_set(kt) if a < b}
        theirs = {(min(a, b), max(a, b)) for a, b in nx.k_truss(G, k).edges()}
        assert mine == theirs, k
    with pytest.raises(ValueError, match="k must be >= 3 for a k-truss; got 2"):
        PM.k_truss(pg, 2)


def test_maximal_matching(RM):
    rng = np.random.default_rng(5)
    n = 50
    src = rng.integers(0, n, 250).astype(np.int32)
    dst = rng.integers(0, n, 250).astype(np.int32)
    pg, rg = both_graphs(RM, src, dst, n=n)
    for seed in (0, 1, 2):
        matched = PM.maximal_matching(pg, seed=seed).numpy()
        np.testing.assert_array_equal(matched, np.asarray(RM.maximal_matching(rg, seed=seed)))
        s, d, valid = pg.src.numpy(), pg.dst.numpy(), pg.valid.numpy()
        ms, md = s[matched], d[matched]
        # it's a matching: each vertex in at most one matched edge
        touched = np.concatenate([ms, md])
        assert len(touched) == len(np.unique(touched))
        # maximal: every live edge has a matched endpoint
        used = np.zeros(n, bool)
        used[ms] = True
        used[md] = True
        live = valid & (s != d)
        assert (used[s[live]] | used[d[live]]).all()


# ---------------------------------------------------------------------------
# each model on random graphs against the JAX function
# ---------------------------------------------------------------------------

GRAPHS = [(1, 50, 400), (2, 97, 900), (3, 130, 2000)]


@pytest.mark.parametrize("seed,n,e", GRAPHS)
def test_triangle_count_matches_reference(RM, seed, n, e):
    src, dst, _ = random_edges(seed, n, e)
    pg, rg = both_graphs(RM, src, dst, n=n)
    assert PM.triangle_count(pg) == RM.triangle_count(rg)


def test_triangle_count_blocks_and_matrix_input(RM):
    """Past one 1024-row block (n = 1500: two blocks, the second padded),
    and from a Matrix (``Graph.from_matrix``)."""
    src, dst, _ = random_edges(4, 1500, 30000)
    pg, rg = both_graphs(RM, src, dst, n=1500)
    assert PM.triangle_count(pg) == RM.triangle_count(rg) > 0
    A = P.Matrix.from_coo(src, dst, 1.0, P.dtypes.FP32, nrows=1500, ncols=1500, dup_op=P.binary.plus)
    assert PM.triangle_count(A) == RM.triangle_count(rg)


@pytest.mark.parametrize("seed,n,e", GRAPHS)
@pytest.mark.parametrize("k", [3, 4, 6])
def test_k_truss_matches_reference(RM, seed, n, e, k):
    src, dst, _ = random_edges(seed, n, e)
    pg, rg = both_graphs(RM, src, dst, n=n)
    kt, rk = PM.k_truss(pg, k), RM.k_truss(rg, k)
    for a, b in ((kt.src, rk.src), (kt.dst, rk.dst), (kt.valid, rk.valid)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert kt.nedges == rk.nedges and kt.weights is None and kt.src.dtype == torch.int32


@pytest.mark.parametrize("seed,n,e", GRAPHS)
def test_maximal_matching_matches_reference(RM, seed, n, e):
    src, dst, _ = random_edges(seed, n, e)
    pg, rg = both_graphs(RM, src, dst, n=n)
    for s in (0, 9):
        np.testing.assert_array_equal(PM.maximal_matching(pg, seed=s).numpy(), np.asarray(RM.maximal_matching(rg, seed=s)))


@pytest.mark.parametrize("seed,n,e", GRAPHS)
def test_betweenness_centrality_matches_reference(RM, seed, n, e):
    src, dst, _ = random_edges(seed, n, e)
    pg, rg = both_graphs(RM, src, dst, n=n)
    sources = np.random.default_rng(seed).choice(n, 8, replace=False)
    for kw in ({}, {"sources": sources}, {"sources": sources, "max_levels": 3}):
        got = PM.betweenness_centrality(pg, **kw).numpy()
        want = np.asarray(RM.betweenness_centrality(rg, **kw))
        assert got.dtype == want.dtype == np.float32
        # float32 sums reordered (matmuls and the sum over sources): 1e-5
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed,n,e", GRAPHS)
@pytest.mark.parametrize("weights", [None, "int"])
def test_louvain_matches_reference(RM, seed, n, e, weights):
    src, dst, w = random_edges(seed, n, e, weights)
    pg, rg = both_graphs(RM, src, dst, w, n)
    for it in (1, 50):
        np.testing.assert_array_equal(PM.louvain(pg, max_iters=it).numpy(), np.asarray(RM.louvain(rg, max_iters=it)))


@pytest.mark.parametrize("seed,n,e", GRAPHS)
def test_louvain_float_weights_and_modularity(RM, seed, n, e):
    """Float weights: the symmetrized duplicates and the degrees are float32
    sums in another order than numpy's and XLA's, so a near-tie of gains
    could flip a label; on these graphs none does, and the labels are held
    exactly.  ``modularity`` of both packages on the same adjacency and
    labels agrees within 1e-6 relative (a float32 sum of n^2 terms, reduced
    in each library's order), and with a float64 numpy oracle within 1e-5."""
    import jax.numpy as jnp

    rlouvain = importlib.import_module("graphblas_tpu.models.louvain")
    src, dst, w = random_edges(seed, n, e, "float")
    pg, rg = both_graphs(RM, src, dst, w, n)
    got, want = PM.louvain(pg).numpy(), np.asarray(RM.louvain(rg))
    np.testing.assert_array_equal(got, want)
    adj = np.zeros((n, n), np.float32)
    np.add.at(adj, (src, dst), w)
    np.add.at(adj, (dst, src), w)
    np.fill_diagonal(adj, 0.0)
    two_m = max(float(adj.sum()), 1.0)
    q_port = float(plouvain.modularity(torch.from_numpy(adj), torch.from_numpy(got), torch.tensor(two_m)))
    q_ref = float(rlouvain.modularity(jnp.asarray(adj), jnp.asarray(want), jnp.float32(two_m)))
    assert q_port == pytest.approx(q_ref, rel=1e-6)
    a64, k64 = adj.astype(np.float64), adj.astype(np.float64).sum(1)
    q64 = np.where(got[:, None] == got[None, :], a64 - np.outer(k64, k64) / two_m, 0.0).sum() / two_m
    assert q_port == pytest.approx(q64, rel=1e-5)


def test_louvain_as_vector_and_matrix_input(RM):
    import graphblas_tpu as R

    src, dst, w = random_edges(5, 40, 200, "int")
    A = P.Matrix.from_coo(src, dst, w, P.dtypes.FP64, nrows=40, ncols=40, dup_op=P.binary.plus)
    RA = R.Matrix.from_coo(src, dst, w, R.dtypes.FP64, nrows=40, ncols=40, dup_op=R.binary.plus)
    v, rv = PM.louvain(A, as_vector=True), RM.louvain(RA, as_vector=True)
    assert v.dtype.name == rv.dtype.name and v.size == rv.size == 40 and v.nvals == rv.nvals
    np.testing.assert_array_equal(v.to_dense(), np.asarray(rv.to_dense()))


# ---------------------------------------------------------------------------
# the Graph builders' device
# ---------------------------------------------------------------------------


def test_graph_builders_follow_the_platform():
    """``rmat`` and ``Graph.from_arrays`` put their tensors on
    ``tx.config["platform"]``; an explicit ``device=`` wins."""
    g = PM.rmat(6, 4, seed=1)
    assert g.src.device.type == g.valid.device.type == "cpu"
    h = PM.Graph.from_arrays(np.array([0, 1], np.int32), np.array([1, 2], np.int32))
    assert h.dst.device.type == "cpu"
    assert PM.rmat(6, 4, seed=1, device="cpu").src.device.type == "cpu"
    seen = []
    real_to = torch.Tensor.to
    try:
        # the test needs no card: it records where the builders send their tensors
        torch.Tensor.to = lambda t, dev, *a, **k: (seen.append(str(dev)), t)[1]
        with P.tx.config.set(platform="cuda"):
            PM.Graph.from_arrays(np.array([0], np.int32), np.array([1], np.int32))
            PM.rmat(4, 2, seed=1)
            PM.Graph.from_arrays(np.array([0], np.int32), np.array([1], np.int32), device="cpu")
    finally:
        torch.Tensor.to = real_to
    assert seen == ["cuda"] * 6 + ["cpu"] * 3


# ---------------------------------------------------------------------------
# the card (skipped here)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_cuda_dense_models_match_the_cpu(card):
    """Every model at a small size on the card against the same model on
    the CPU: counts, edge sets, masks and integer-weight labels exactly,
    betweenness within 1e-5 (float32 sums in the card's order)."""
    src, dst, _ = random_edges(8, 700, 9000)
    w = np.random.default_rng(8).integers(1, 5, 9000).astype(np.float32)
    gc = PM.Graph.from_arrays(src, dst, w, n=700, device="cuda")
    gh = PM.Graph.from_arrays(src, dst, w, n=700, device="cpu")
    assert PM.triangle_count(gc) == PM.triangle_count(gh)
    for k in (3, 5):
        a, b = PM.k_truss(gc, k), PM.k_truss(gh, k)
        assert a.src.is_cuda
        np.testing.assert_array_equal(a.src.cpu().numpy(), b.src.numpy())
        np.testing.assert_array_equal(a.dst.cpu().numpy(), b.dst.numpy())
    m = PM.maximal_matching(gc, seed=3)
    assert m.is_cuda
    np.testing.assert_array_equal(m.cpu().numpy(), PM.maximal_matching(gh, seed=3).numpy())
    sources = np.arange(0, 700, 23)
    bc = PM.betweenness_centrality(gc, sources, max_levels=12)
    assert bc.is_cuda
    np.testing.assert_allclose(bc.cpu().numpy(), PM.betweenness_centrality(gh, sources, max_levels=12).numpy(), rtol=1e-5, atol=1e-6)
    lab = PM.louvain(gc)
    assert lab.is_cuda
    np.testing.assert_array_equal(lab.cpu().numpy(), PM.louvain(gh).numpy())
