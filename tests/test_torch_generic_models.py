"""Parity of the port's generic graph models (``models.bfs_level``,
``bfs_parent``, ``sssp``, ``pagerank``, ``connected_components`` over the
edge-wise ops of ``ops/edgewise.py``) and ``Graph``'s Matrix conversions
with the JAX package's, case for case with ``tests/test_models.py``
(:38-165, :186-207), and the sparse DSL's path through the kernels.

The same numpy-seeded graphs go through both packages' models on the CPU:
levels, parents and components exactly; SSSP distances bit for bit (a min
over float32 path sums is the same whatever order relaxes it); PageRank
within 1e-5 relative (float32 sums: ``index_add_`` and XLA's segment sum add
in their own orders).  The edge-wise reductions are held against
``jax.ops.segment_sum/min/max``: empty segments, NaN, a tie of signed zeros.
The CUDA tests (``-m cuda``; they skip here) hold phase 6s of
``chip_smoke.py`` at a small size on the card.
"""

import heapq

import numpy as np
import pytest
import torch
from test_torch_sparse import pinned, ref, sparse_ns  # noqa: F401

import graphblas_tpu_torch as P
from graphblas_tpu_torch import kernels
from graphblas_tpu_torch import models as PM
from graphblas_tpu_torch.ops import edgewise as pew


@pytest.fixture(scope="module")
def R_models():
    pytest.importorskip("jax")
    import graphblas_tpu.models as RM

    return RM


def random_arrays(seed=7, n=60, e=300):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = (rng.random(e) * 9 + 1).astype(np.float32)
    return src, dst, w, n


def graphs(R_models, seed=7, n=60, e=300):
    src, dst, w, n = random_arrays(seed, n, e)
    return PM.Graph.from_arrays(src, dst, w, n=n, device="cpu"), R_models.Graph.from_arrays(src, dst, w, n=n), (src, dst, w, n)


def _adj(src, dst, w=None):
    adj = {}
    for i in range(len(src)):
        adj.setdefault(int(src[i]), []).append((int(dst[i]), float(w[i]) if w is not None else 1.0))
    return adj


@pytest.mark.parametrize("source", [0, 7, 59])
def test_bfs_level_matches_reference_and_oracle(R_models, source):
    pg, rg, (src, dst, w, n) = graphs(R_models)
    levels = PM.bfs_level(pg, source).numpy()
    np.testing.assert_array_equal(levels, np.asarray(R_models.bfs_level(rg, source)))
    adj = _adj(src, dst)
    expected = -np.ones(n, np.int64)
    expected[source] = 0
    frontier, depth = [source], 0
    while frontier:
        depth += 1
        nxt = []
        for u in frontier:
            for v, _ in adj.get(u, []):
                if expected[v] < 0:
                    expected[v] = depth
                    nxt.append(v)
        frontier = nxt
    np.testing.assert_array_equal(levels, expected)


@pytest.mark.parametrize("source", [0, 7])
def test_bfs_parent_matches_reference(R_models, source):
    pg, rg, (src, dst, w, n) = graphs(R_models)
    parents = PM.bfs_parent(pg, source).numpy()
    np.testing.assert_array_equal(parents, np.asarray(R_models.bfs_parent(rg, source)))
    levels = PM.bfs_level(pg, source).numpy()
    edges = set(zip(src.tolist(), dst.tolist()))
    assert parents[source] == source
    for v in range(n):
        if v != source:
            assert parents[v] == -1 if levels[v] < 0 else ((parents[v], v) in edges and levels[parents[v]] == levels[v] - 1)


@pytest.mark.parametrize("source", [0, 13])
def test_sssp_matches_reference_bit_for_bit(R_models, source):
    pg, rg, (src, dst, w, n) = graphs(R_models)
    dist = PM.sssp(pg, source).numpy()
    want = np.asarray(R_models.sssp(rg, source))
    np.testing.assert_array_equal(dist.view(np.int32), want.view(np.int32))
    adj = _adj(src, dst, w)
    d = [float("inf")] * n
    d[source] = 0.0
    pq = [(0.0, source)]
    while pq:
        du, u = heapq.heappop(pq)
        if du > d[u]:
            continue
        for v, wt in adj.get(u, []):
            if du + wt < d[v]:
                d[v] = du + wt
                heapq.heappush(pq, (d[v], v))
    for i in range(n):
        assert dist[i] > 1e37 if d[i] == float("inf") else np.isclose(dist[i], d[i], rtol=1e-5)


def test_models_as_vector_match_reference(ref, R_models):
    """as_vector=True: the DSL Vectors of the reference's types and patterns."""
    from test_torch_collections import assert_same

    pg, rg, _ = graphs(R_models)
    for name, kw in (("bfs_level", {"source": 0}), ("bfs_parent", {"source": 0}), ("sssp", {"source": 0}), ("pagerank", {}), ("connected_components", {})):
        p = getattr(PM, name)(pg, as_vector=True, **kw)
        r = getattr(R_models, name)(rg, as_vector=True, **kw)
        assert_same(p, r, name, rtol=1e-5)  # pagerank: float32 sums reordered


@pytest.mark.parametrize("tol, iters", [(1e-10, 100), (1e-6, 100), (0.0, 7)])
def test_pagerank_matches_reference(R_models, tol, iters):
    """Within 1e-5 relative: float32 sums in index_add_'s order and XLA's."""
    pg, rg, (src, dst, w, n) = graphs(R_models)
    r = PM.pagerank(pg, tol=tol, max_iters=iters).numpy()
    np.testing.assert_allclose(r, np.asarray(R_models.pagerank(rg, tol=tol, max_iters=iters)), rtol=1e-5)
    if tol == 1e-10:
        assert np.isclose(r.sum(), 1.0, atol=1e-4)
        M = np.zeros((n, n))
        np.add.at(M, (dst, src), 1.0)
        outdeg = np.bincount(src, minlength=n).astype(np.float64)
        M = M / np.where(outdeg > 0, outdeg, 1)[None, :]
        x = np.full(n, 1.0 / n)
        for _ in range(200):
            x = 0.15 / n + 0.85 * (M @ x + x[outdeg == 0].sum() / n)
        np.testing.assert_allclose(r, x, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_connected_components_match_reference(R_models, seed):
    pg, rg, (src, dst, w, n) = graphs(R_models, seed=seed, e=60)
    f = PM.connected_components(pg).numpy()
    np.testing.assert_array_equal(f, np.asarray(R_models.connected_components(rg)))
    small = PM.Graph.from_arrays(np.array([0, 1, 3], np.int32), np.array([1, 2, 4], np.int32), n=6, device="cpu")
    assert PM.connected_components(small).tolist() == [0, 0, 0, 3, 3, 5]


def test_graph_matrix_roundtrip_matches_reference(ref, R_models):
    from test_torch_collections import assert_same

    pg, rg, (src, dst, w, n) = graphs(R_models)
    A, RA = pg.to_matrix(), rg.to_matrix()
    assert_same(A, RA, "to_matrix", rtol=1e-6)
    g2 = PM.Graph.from_matrix(A)
    assert g2.n == n and g2.has_weights and not PM.Graph.from_arrays(src, dst, n=n, device="cpu").has_weights
    np.testing.assert_array_equal(PM.bfs_level(g2, 0).numpy(), PM.bfs_level(pg, 0).numpy())
    rev = pg.reverse()
    np.testing.assert_array_equal(PM.bfs_level(rev, 0).numpy(), np.asarray(R_models.bfs_level(rg.reverse(), 0)))
    # a sparse Matrix (forced) converts the same way
    with P.tx.config.set(dense_limit=0):
        As = PM.Graph.from_arrays(src, dst, w, n=n, device="cpu").to_matrix()
    assert As._sparse is not None
    np.testing.assert_array_equal(PM.sssp(PM.Graph.from_matrix(As), 0).numpy(), PM.sssp(g2, 0).numpy())
    # the models take a Matrix too
    np.testing.assert_array_equal(PM.bfs_level(As, 3).numpy(), PM.bfs_level(pg, 3).numpy())


def test_rmat_runs_and_matches_reference(R_models):
    pg = PM.rmat(8, 4, seed=1, device="cpu")
    from graphblas_tpu.models.graph import rmat as rrmat

    rg = rrmat(8, 4, seed=1)
    src = pg.src.numpy()[pg.valid.numpy()]
    source = int(np.bincount(src, minlength=pg.n).argmax())
    levels = PM.bfs_level(pg, source).numpy()
    assert (levels >= 0).sum() > 1
    np.testing.assert_array_equal(levels, np.asarray(R_models.bfs_level(rg, source)))
    r = PM.pagerank(pg, max_iters=20).numpy()
    assert np.isfinite(r).all()
    np.testing.assert_allclose(r, np.asarray(R_models.pagerank(rg, max_iters=20)), rtol=1e-5)


# ---------------------------------------------------------------------------
# the edge-wise reductions against jax.ops.segment_*
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "float64", "int32", "int64"])
@pytest.mark.parametrize("which", ["segment_sum", "segment_min", "segment_max"])
def test_edgewise_segments_match_jax(which, dt):
    """Empty segments (0, the type's max, its min), a NaN in a segment and a
    tie of signed zeros, as jax.ops gives them, bit for bit."""
    jax = pytest.importorskip("jax")
    ids = np.array([0, 0, 1, 1, 2, 2, 3, 5, 5, 5])
    if dt.startswith("float"):
        data = np.array([1.0, np.nan, 0.0, -0.0, -0.0, 0.0, -0.0, 3.0, -2.0, 7.5], dt)
    else:
        data = np.array([1, -4, 0, 9, -7, 7, 3, 5, -2, 8], dt)
    want = np.asarray(getattr(jax.ops, which)(data, ids, num_segments=7))
    got = getattr(pew, which)(torch.from_numpy(data), torch.from_numpy(ids), 7).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(f"int{got.itemsize * 8}"), want.view(f"int{want.itemsize * 8}"))


def test_edgewise_spmvs_match_reference():
    """Each edge-wise SpMV against the reference's, on a padded edge list."""
    pytest.importorskip("jax")
    from graphblas_tpu.ops import edgewise as rew

    src, dst, w, n = random_arrays(3, 40, 150)
    ps, pd, pw, pv = (torch.from_numpy(a) for a in pew.pad_edges(src, dst, w))
    rs, rd, rw, rv = rew.pad_edges(src, dst, w)
    rng = np.random.default_rng(4)
    x = (rng.random(n) * 5).astype(np.float32)
    fr = rng.random(n) < 0.3
    big = np.float32(3.4e38) / 4
    xb = np.where(rng.random(n) < 0.5, x, big).astype(np.float32)
    cases = [
        (pew.spmv_plus_times(ps, pd, pw, pv, torch.from_numpy(x), n), rew.spmv_plus_times(rs, rd, rw, rv, x, n)),
        (pew.spmv_plus_first(ps, pd, pv, torch.from_numpy(x), n), rew.spmv_plus_first(rs, rd, rv, x, n)),
        (pew.spmv_min_plus(ps, pd, pw, pv, torch.from_numpy(xb), n, big=big), rew.spmv_min_plus(rs, rd, rw, rv, xb, n, big=big)),
        (pew.spmv_any_reach(ps, pd, pv, torch.from_numpy(fr), n), rew.spmv_any_reach(rs, rd, rv, fr, n)),
        (pew.spmv_any_parent(ps, pd, pv, torch.from_numpy(fr), n), rew.spmv_any_parent(rs, rd, rv, fr, n)),
        (pew.spmv_min_second(ps, pd, pv, torch.from_numpy(np.arange(n, dtype=np.int32)), n, big=n), rew.spmv_min_second(rs, rd, rv, np.arange(n, dtype=np.int32), n, big=n)),
        (pew.degrees(pd, pv, n), rew.degrees(rd, rv, n)),
    ]
    for i, (p, r) in enumerate(cases):
        r = np.asarray(r)
        if r.dtype.kind == "f":
            np.testing.assert_allclose(p.numpy(), r, rtol=1e-6, err_msg=str(i))
        else:
            np.testing.assert_array_equal(p.numpy(), r, err_msg=str(i))


# ---------------------------------------------------------------------------
# the sparse DSL path: plain versions on the CPU, kernels on the card
# ---------------------------------------------------------------------------


def _sparse_dsl_drive(dev, n_log2=9, tri_n=256):
    """Examples 07, 02, 01 and 05's statements on sparse collections (forced
    at this size), on ``dev``: (ranks, levels, distances, triangles)."""
    from graphblas_tpu_torch import Matrix, Vector, binary, dtypes, monoid, semiring, unary

    g = PM.rmat(n_log2, 8, seed=5, weighted=True, device=dev)
    valid = g.valid.cpu().numpy()
    src, dst, w = (a.cpu().numpy()[valid] for a in (g.src, g.dst, g.weights))
    n = g.n
    with P.tx.config.set(platform=dev.type, mxv_strategy="plan"):
        with P.tx.config.set(dense_limit=0):
            A = Matrix.from_coo(src, dst, 1.0, dtypes.FP32, nrows=n, ncols=n, dup_op=binary.first)
            A_w = Matrix.from_coo(src, dst, w, dtypes.FP32, nrows=n, ncols=n, dup_op=binary.min)
            rng = np.random.default_rng(6)
            tr, tc = rng.integers(0, tri_n, 8 * tri_n), rng.integers(0, tri_n, 8 * tri_n)
            keep = tr > tc
            L = Matrix.from_coo(tr[keep], tc[keep], 1.0, dtypes.FP32, nrows=tri_n, ncols=tri_n, dup_op=binary.first)
        assert A._sparse is not None and L._sparse is not None
        outdeg = A.reduce_rowwise(binary.plus).new(dtypes.FP32)
        inv_deg = outdeg.apply(unary.minv).new()
        rank = Vector.from_dense(np.full(n, 1.0 / n, np.float32))
        for _ in range(5):
            contrib = rank.ewise_mult(inv_deg, binary.times).new()
            pulled = contrib.vxm(A, semiring.plus_first).new()
            dangling = float(rank.reduce(binary.plus).new().value) - float(contrib.ewise_mult(outdeg, binary.times).reduce(binary.plus).new().value)
            rank = pulled.apply(binary.times, right=0.85).apply(binary.plus, right=0.15 / n + 0.85 * dangling / n).new(dtypes.FP32)
        s = int(np.bincount(src, minlength=n).argmax())
        levels = Vector(dtypes.INT64, n)
        frontier = Vector(dtypes.BOOL, n)
        frontier[s] = True
        levels[s] = 0
        level = 0
        while frontier.nvals > 0:
            level += 1
            frontier(~levels.S, replace=True) << A.T.mxv(frontier, semiring.any_pair)
            levels(frontier.S) << frontier.apply(lambda x: 0 * x + level).new(dtypes.INT64)
        dist = Vector(dtypes.FP32, n)
        dist[s] = 0.0
        for _ in range(n):
            prev = dist.dup()
            dist(accum=binary.min) << A_w.T.mxv(dist, semiring.min_plus)
            if dist.isequal(prev):
                break
        C = Matrix(dtypes.FP32, tri_n, tri_n)
        C(L.S) << L.mxm(L.T.new(), semiring.plus_pair)
        count = int(C.reduce_scalar(monoid.plus[dtypes.INT64]).new().value)
    return rank, levels, dist, count, (g, s, L)


def test_sparse_dsl_path_on_cpu_calls_only_plain_versions():
    """The sparse DSL's statements on CPU tensors take every kernel's plain
    version (never a launch); the results agree with the generic models and
    scipy."""
    import scipy.sparse as scsp

    kernels.reset_counts()
    rank, levels, dist, count, (g, s, L) = _sparse_dsl_drive(torch.device("cpu"))
    launches, plain = kernels.launch_counts(), kernels.plain_counts()
    assert not any(launches.values()), launches
    for name in ("gather", "segscan_contrib_gather", "segscan", "eqjoin"):
        assert plain[name] > 0, (name, plain)
    np.testing.assert_array_equal(levels.to_dense(-1), PM.bfs_level(g, s).numpy())
    d = PM.sssp(g, s).numpy()
    reach = d < 1e37
    di, dv = dist.to_coo()
    np.testing.assert_array_equal(di.astype(np.int64), np.flatnonzero(reach))
    np.testing.assert_array_equal(dv, d[reach])
    lr, lc, _ = L.to_coo()
    lm = scsp.csr_matrix((np.ones(len(lr)), (lr.astype(np.int64), lc.astype(np.int64))), shape=L.shape)
    assert count == int((lm @ lm.T).multiply(lm).sum())
    assert rank.dtype == P.dtypes.FP32 and bool(np.isfinite(rank.to_coo()[1]).all())


@pytest.mark.cuda
def test_sparse_dsl_path_on_cuda_launches_only_kernels():
    """On the card the same statements launch G, C with its fused gather,
    the generic scan and eqjoin, never a plain version, and equal their plain replay (float
    PageRank within 1e-5: the adds are reordered) and the generic models."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    kernels.reset_counts()
    got = _sparse_dsl_drive(dev)
    torch.cuda.synchronize()
    launches, plain = kernels.launch_counts(), kernels.plain_counts()
    for name in ("gather", "segscan_contrib_gather", "segscan", "eqjoin"):
        assert launches[name] > 0, (name, launches)
    assert not any(plain.values()), plain
    with kernels.plain_versions():
        want = _sparse_dsl_drive(dev)
    pi, pv = got[0].to_coo()
    qi, qv = want[0].to_coo()
    np.testing.assert_array_equal(pi, qi)
    np.testing.assert_allclose(pv, qv, rtol=1e-5)
    assert got[1].isequal(want[1]) and got[2].isequal(want[2]) and got[3] == want[3]
    g, s = got[4][0], got[4][1]
    np.testing.assert_array_equal(got[1].to_dense(-1), PM.bfs_level(g, s).cpu().numpy())


@pytest.mark.cuda
def test_generic_models_on_cuda_match_the_loop_layout_models():
    """(e) of phase 6s at scale 12: the generic models on the card against
    models.fast (bfs_level and sssp bit for bit, pagerank within 1e-4: the
    float32 adds run in other orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from graphblas_tpu_torch.models import fast
    from graphblas_tpu_torch.ops.scan import STATE_BIG

    g = PM.rmat(12, 16, seed=5, weighted=True, device="cuda")
    plan = fast.analyze(g)
    n = g.n
    src = g.src.cpu().numpy()[g.valid.cpu().numpy()]
    s = int(np.bincount(src, minlength=n).argmax())
    assert torch.equal(PM.bfs_level(g, s), fast.bfs_level(plan, s, n))
    d, d_fast = PM.sssp(g, s), fast.sssp(plan, s, n)
    reach = d_fast != STATE_BIG
    assert torch.equal(d[reach], d_fast[reach]) and torch.equal(reach, d < 1e37)
    outdeg = torch.from_numpy(np.bincount(src, minlength=n)).cuda()
    torch.testing.assert_close(PM.pagerank(g, tol=0.0, max_iters=30), fast.pagerank(plan, outdeg, n, tol=0.0, max_iters=30), rtol=1e-4, atol=0)
