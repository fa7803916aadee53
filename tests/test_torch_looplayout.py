"""Parity of the port's edge-layout lowering of compiled DSL loops
(``core/looplayout.py``) with the JAX package's, case for case with
``tests/test_looplayout.py``.

The compiler may run a loop body with its state in the edge space: one G
route fewer per SpMV on the card (loop route -> fill -> perm route -> C,
against place -> fill -> perm -> C -> collect).  Each case builds the same
numpy-seeded graph in both packages (matrices sparse, vectors dense, as the
reference's fixture sets ``dense_limit``) and holds the port to the
reference: ``layout`` equal (applied where eligible, declined for two
directions, an indexed assign, a positional op), and the results of the two
lowerings the same (bit for bit for SSSP and BFS; PageRank within 1e-6
absolute, as the reference's test) and the same as the reference's (float
plus within 1e-5 relative: float32 sums in another order).
"""

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as P


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    import graphblas_tpu as R

    return R


@pytest.fixture(autouse=True)
def _force_sparse_matrices(monkeypatch):
    # matrices (n*n cells) sparse-backed, vectors (n) dense: the big-graph
    # storage the edge layout targets
    monkeypatch.setenv("GRAPHBLAS_TPU_DSL_EDGE_LAYOUT", "1")
    with P.tx.config.set(platform="cpu", dense_limit=20000):
        yield


def ns(pkg):
    from test_torch_compile import ns as base

    return base(pkg)


def both(R, fn):
    out = []
    for pkg in (P, R):
        with pkg.tx.config.set(dense_limit=20000):
            out.append(fn(ns(pkg)))
    return out


def _graph(n=200, e=900, seed=7, indeg0_tail=50):
    """Random digraph whose last ``indeg0_tail`` vertices have NO in-edges
    (the total plan's state slots)."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, e) % (n - indeg0_tail)
    c = rng.integers(0, n, e)
    key = r.astype(np.int64) * n + c
    _, idx = np.unique(key, return_index=True)
    r, c = r[idx], c[idx]
    w = (rng.random(len(r)) + 0.1).astype(np.float32)
    return r, c, w, n


def _with_layout(monkeypatch, flag, fn):
    monkeypatch.setenv("GRAPHBLAS_TPU_DSL_EDGE_LAYOUT", flag)
    return fn()


def _dense(v, fill=0.0):
    return np.asarray(v.to_dense(fill_value=fill))


def test_pagerank_edge_layout_matches_n_space(R, monkeypatch):
    r, c, w, n = _graph()

    def run(g):
        AT = g.Matrix.from_coo(r, c, w, nrows=n, ncols=n)
        assert AT._sparse is not None

        def one():
            runner = g.dsl.pagerank_runner(AT, max_iters=15)
            return runner.layout, _dense(runner())

        return _with_layout(monkeypatch, "0", one), _with_layout(monkeypatch, "1", one)

    p, ref = both(R, run)
    assert (p[0][0], p[1][0]) == (ref[0][0], ref[1][0]) == ("n", "edge")
    np.testing.assert_allclose(p[0][1], p[1][1], atol=1e-6)
    np.testing.assert_allclose(p[1][1], ref[1][1], rtol=1e-5, atol=1e-7)


def test_sssp_edge_layout_bit_identical(R, monkeypatch):
    r, c, w, n = _graph(seed=3)

    def run(g):
        AT = g.Matrix.from_coo(r, c, w, nrows=n, ncols=n)

        def one():
            runner = g.dsl.sssp_runner(AT, 2)
            return runner.runner.layout, _dense(runner(), np.inf)

        return _with_layout(monkeypatch, "0", one), _with_layout(monkeypatch, "1", one)

    p, ref = both(R, run)
    assert (p[0][0], p[1][0]) == (ref[0][0], ref[1][0]) == ("n", "edge")
    np.testing.assert_array_equal(p[0][1], p[1][1])
    np.testing.assert_array_equal(p[1][1], ref[1][1])


def test_bfs_dense_edge_layout_bit_identical(R, monkeypatch):
    r, c, _, n = _graph(seed=5)

    def run(g):
        AT = g.Matrix.from_coo(r, c, np.ones(len(r), np.float32), nrows=n, ncols=n)

        def one():
            runner = g.dsl.bfs_level_dense_runner(AT, 2)
            return runner.runner.layout, _dense(runner(), -1), int(runner.runner.last_iters)

        return _with_layout(monkeypatch, "0", one), _with_layout(monkeypatch, "1", one)

    p, ref = both(R, run)
    assert (p[0][0], p[1][0]) == (ref[0][0], ref[1][0]) == ("n", "edge")
    assert p[0][2] == p[1][2] == ref[1][2]
    np.testing.assert_array_equal(p[0][1], p[1][1])
    np.testing.assert_array_equal(p[1][1], ref[1][1])


def test_two_direction_loop_rejects_edge_layout(R):
    # cc pulls AND pushes (two plans): it stays in the n space, and is right
    r, c, _, n = _graph(seed=11)

    def run(g):
        AT = g.Matrix.from_coo(r, c, np.ones(len(r), np.float32), nrows=n, ncols=n)
        runner = g.dsl.connected_components_runner(AT)
        return runner.runner.layout, _dense(runner(), -1)

    p, ref = both(R, run)
    assert p[0] == ref[0] == "n"
    np.testing.assert_array_equal(p[1], ref[1])
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(r, c):
        parent[find(a)] = find(b)
    roots = np.array([find(v) for v in range(n)])
    rng = np.random.default_rng(0)
    for a, b in zip(rng.integers(0, n, 300), rng.integers(0, n, 300)):
        assert (p[1][a] == p[1][b]) == (roots[a] == roots[b])


def test_indexed_assign_in_body_rejects_edge_layout(R):
    r, c, w, n = _graph(seed=13)

    def run(g):
        AT = g.Matrix.from_coo(r, c, w, nrows=n, ncols=n)

        def body(x):
            y = AT.mxv(x, g.semiring.plus_times).new(g.dtm.FP32)
            out = x.ewise_add(y, g.binary.plus).new(g.dtm.FP32).dup()
            out[3] = 7.0  # a vertex-indexed write: not expressible in the edge layout
            return out

        runner = g.gb.loop_runner(3, body, g.Vector.from_dense(np.zeros(n, np.float32)))
        return runner.layout, _dense(runner()), getattr(runner, "capture", None)

    p, ref = both(R, run)
    assert p[0] == ref[0] == "n"  # declined, still right
    np.testing.assert_allclose(p[1], ref[1], rtol=1e-6)
    x = np.zeros(n)
    A = np.zeros((n, n))
    A[r, c] = w
    for _ in range(3):
        x = x + A @ x
        x[3] = 7.0
    np.testing.assert_allclose(p[1], x.astype(np.float32), atol=1e-4)
    assert p[2] == "graph"  # a one-element region is a slice copy: nothing uploaded per step


def test_positional_apply_in_body_rejects_edge_layout(R):
    r, c, w, n = _graph(seed=17)

    def run(g):
        AT = g.Matrix.from_coo(r, c, w, nrows=n, ncols=n)

        def body(x):
            y = AT.mxv(x, g.semiring.plus_times).new(g.dtm.FP32)
            idx = x.apply("positioni").new(g.dtm.FP32)  # slot ids != vertex ids
            return y.ewise_add(idx, g.binary.plus).new(g.dtm.FP32)

        runner = g.gb.loop_runner(2, body, g.Vector.from_dense(np.zeros(n, np.float32)))
        return runner.layout, _dense(runner())

    p, ref = both(R, run)
    assert p[0] == ref[0] == "n"
    np.testing.assert_allclose(p[1], ref[1], rtol=1e-6)
    x = np.zeros(n)
    A = np.zeros((n, n))
    A[r, c] = w
    for _ in range(2):
        x = A @ x + np.arange(n)
    np.testing.assert_allclose(p[1], x.astype(np.float32), rtol=1e-4)


def test_edge_layout_complement_mask_in_body(R, monkeypatch):
    # a complemented value mask in the body: the universe guard keeps the
    # non-state slots out of the structure
    r, c, w, n = _graph(seed=19)

    def run(g):
        AT = g.Matrix.from_coo(r, c, w, nrows=n, ncols=n)

        def body(x, f):
            y = AT.mxv(x, g.semiring.plus_times).new(g.dtm.FP32)
            big = y.apply(g.binary.gt, right=5.0).new(g.dtm.BOOL)
            x2 = x.dup()
            x2(~big.V)[:] = 1.0  # where y <= 5 (or absent)
            s = x2.reduce(g.monoid.plus).new(g.dtm.FP32)
            return x2, f.apply(g.binary.plus, right=s).new(g.dtm.FP32)

        def one():
            runner = g.gb.loop_runner(3, body, g.Vector.from_dense(np.full(n, 10.0, np.float32)), g.Vector.from_dense(np.zeros(n, np.float32)))
            x, f = runner()
            return runner.layout, _dense(x), _dense(f)

        return _with_layout(monkeypatch, "0", one), _with_layout(monkeypatch, "1", one)

    p, ref = both(R, run)
    assert (p[0][0], p[1][0]) == (ref[0][0], ref[1][0])
    np.testing.assert_allclose(p[0][1], p[1][1], atol=1e-4)
    np.testing.assert_allclose(p[0][2], p[1][2], rtol=1e-5)
    np.testing.assert_allclose(p[1][1], ref[1][1], rtol=1e-5)
    np.testing.assert_allclose(p[1][2], ref[1][2], rtol=1e-5)


def test_edge_layout_runner_with_new_state(R):
    # runner(*state): the n -> edge conversion on the device per call
    r, c, w, n = _graph(seed=23)
    v1 = np.linspace(0, 1, n).astype(np.float32)

    def run(g):
        AT = g.Matrix.from_coo(r, c, w, nrows=n, ncols=n)

        def body(x):
            y = AT.mxv(x, g.semiring.plus_times).new(g.dtm.FP32)
            return y.ewise_add(x, g.binary.plus).new(g.dtm.FP32)

        runner = g.gb.loop_runner(2, body, g.Vector.from_dense(np.ones(n, np.float32)))
        return runner.layout, _dense(runner(g.Vector.from_dense(v1)))

    p, ref = both(R, run)
    assert p[0] == ref[0] == "edge"
    np.testing.assert_allclose(p[1], ref[1], rtol=1e-6)
    A = np.zeros((n, n))
    A[r, c] = w
    x = v1.astype(np.float64)
    for _ in range(2):
        x = A @ x + x
    np.testing.assert_allclose(p[1], x.astype(np.float32), rtol=1e-4)


def test_edge_layout_total_plan_indeg0_values_preserved(R):
    # vertices with no in-edges keep their evolving state (the total plan's
    # state slots): their value changes every round
    r, c, w, n = _graph(seed=29, indeg0_tail=60)

    def run(g):
        AT = g.Matrix.from_coo(r, c, w, nrows=n, ncols=n)

        def body(x):
            y = AT.mxv(x, g.semiring.plus_times).new(g.dtm.FP32)
            return y.ewise_add(x.apply(g.binary.times, right=2.0), g.binary.plus).new(g.dtm.FP32)

        runner = g.gb.loop_runner(3, body, g.Vector.from_dense(np.arange(n, dtype=np.float32)))
        return runner.layout, _dense(runner())

    p, ref = both(R, run)
    assert p[0] == ref[0] == "edge"
    np.testing.assert_allclose(p[1], ref[1], rtol=1e-6)
    A = np.zeros((n, n))
    A[r, c] = w
    x = np.arange(n, dtype=np.float64)
    for _ in range(3):
        x = A @ x + 2.0 * x
    np.testing.assert_allclose(p[1], x.astype(np.float32), rtol=2e-4)


def test_edge_mxv_is_one_route_fewer(monkeypatch):
    """On the plan engine an edge-layout SpMV is loop route -> fill -> perm
    route -> C: one route fewer than the n space's routed expand (place ->
    fill -> perm -> C -> collect), which the n space now replaces by C with
    x's gather fused and the collect: two launches a step against the edge
    layout's four (counted by the plain versions here)."""
    from graphblas_tpu_torch import kernels

    r, c, w, n = _graph(seed=31)
    AT = P.Matrix.from_coo(r, c, w, nrows=n, ncols=n)
    g = ns(P)

    def body(x):
        return AT.mxv(x, g.semiring.plus_times).new(g.dtm.FP32).ewise_add(x, g.binary.plus).new(g.dtm.FP32)

    calls = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("GRAPHBLAS_TPU_DSL_EDGE_LAYOUT", flag)
        with P.tx.config.set(mxv_strategy="plan"):
            runner = P.loop_runner(4, body, P.Vector.from_dense(np.ones(n, np.float32)))
            kernels.reset_counts()
            out = runner()
        calls[runner.layout] = (kernels.plain_counts(), _dense(out))
    (n_counts, n_out), (e_counts, e_out) = calls["n"], calls["edge"]
    np.testing.assert_allclose(e_out, n_out, rtol=1e-6)
    assert n_counts["gather"] == 4 * 1 and e_counts["gather"] == 4 * 2 + 1  # + one collect at the exit
    assert n_counts["gather_fill"] == 0 and e_counts["gather_fill"] == 4
    assert n_counts["segscan_contrib_gather"] == e_counts["segscan_contrib"] == 4
    assert n_counts["segscan_contrib"] == e_counts["segscan_contrib_gather"] == 0
    assert torch.is_tensor(runner._values0[0]) and runner._values0[0].shape[0] == runner._edge[1].e_pad


@pytest.mark.parametrize(
    "flag,device,strategy,tried",
    [
        (None, "cpu", "plan", True),  # the reference's default, on CPU state
        (None, "cuda", "plan", False),  # the card's default: the n space
        ("1", "cuda", "plan", True),
        ("1", "cpu", "plan", True),
        ("0", "cpu", "plan", False),
        ("0", "cuda", "plan", False),
        ("1", "cpu", "generic", False),  # a plan-engine feature
    ],
)
def test_which_lowering_the_build_tries(monkeypatch, flag, device, strategy, tried):
    """The edge layout is tried where GRAPHBLAS_TPU_DSL_EDGE_LAYOUT is 1, and
    unset on CPU state (the reference's default); unset on the card the
    build keeps the n space, which the card runs faster (PERF.md)."""
    from types import SimpleNamespace

    from graphblas_tpu_torch.core.compiler import CompiledLoop

    if flag is None:
        monkeypatch.delenv("GRAPHBLAS_TPU_DSL_EDGE_LAYOUT", raising=False)
    else:
        monkeypatch.setenv("GRAPHBLAS_TPU_DSL_EDGE_LAYOUT", flag)
    loop = SimpleNamespace(_device=torch.device(device))
    with P.tx.config.set(mxv_strategy=strategy):
        assert CompiledLoop._edge_layout_enabled(loop) is tried
