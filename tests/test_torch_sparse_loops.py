"""Compiled DSL loops over a sparse A past ``dense_limit`` on the CPU, held to
the JAX package's results.

The port has one lowering of a compiled loop on the CPU and on the card: the
state lives in the n space (``runner.layout == "n"``) and every SpMV is C
with x's gather fused, then the collect.  The reference may lower the same
loops to its edge layout, a TPU lowering the port leaves out; its results
are the same, so each case builds the same numpy-seeded graph in both
packages (matrices sparse, vectors dense, as the reference's fixture sets
``dense_limit``) and compares the results (bit for bit for SSSP, BFS and CC;
float plus within 1e-5 relative: float32 sums in another order), ``mode``
and, for ``until`` loops, ``last_iters``.  The inputs are those of the
reference's ``tests/test_looplayout.py``, and of ROADMAP's fault F4.
"""

import numpy as np
import pytest

import graphblas_tpu_torch as P


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    import graphblas_tpu as R

    return R


@pytest.fixture(autouse=True)
def _force_sparse_matrices():
    # matrices (n*n cells) sparse-backed, vectors (n) dense: big-graph storage
    with P.tx.config.set(platform="cpu", dense_limit=20000):
        yield


def ns(pkg):
    from test_torch_compile import ns as base

    return base(pkg)


def both(R, fn, dense_limit=20000):
    out = []
    for pkg in (P, R):
        with pkg.tx.config.set(dense_limit=dense_limit):
            out.append(fn(ns(pkg)))
    return out


def _graph(n=200, e=900, seed=7, indeg0_tail=50):
    """Random digraph whose last ``indeg0_tail`` vertices have NO in-edges."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, e) % (n - indeg0_tail)
    c = rng.integers(0, n, e)
    key = r.astype(np.int64) * n + c
    _, idx = np.unique(key, return_index=True)
    r, c = r[idx], c[idx]
    w = (rng.random(len(r)) + 0.1).astype(np.float32)
    return r, c, w, n


def _dense(v, fill=0.0):
    return np.asarray(v.to_dense(fill_value=fill))


def _loop(runner):
    """The CompiledLoop of a runner (a DSL recipe's wraps one)."""
    return getattr(runner, "runner", runner)


def _port_layout(p):
    assert p["layout"] == "n"


def test_pagerank(R):
    r, c, w, n = _graph()

    def run(g):
        AT = g.Matrix.from_coo(r, c, w, nrows=n, ncols=n)
        assert AT._sparse is not None
        runner = g.dsl.pagerank_runner(AT, max_iters=15)
        return {"layout": runner.layout, "mode": runner.mode, "out": _dense(runner())}

    p, ref = both(R, run)
    _port_layout(p)
    assert p["mode"] == ref["mode"]
    np.testing.assert_allclose(p["out"], ref["out"], rtol=1e-5, atol=1e-7)


def test_sssp(R):
    r, c, w, n = _graph(seed=3)

    def run(g):
        AT = g.Matrix.from_coo(r, c, w, nrows=n, ncols=n)
        runner = g.dsl.sssp_runner(AT, 2)
        out = _dense(runner(), np.inf)
        loop = _loop(runner)
        return {"layout": loop.layout, "mode": loop.mode, "iters": int(loop.last_iters), "out": out}

    p, ref = both(R, run)
    _port_layout(p)
    assert (p["mode"], p["iters"]) == (ref["mode"], ref["iters"])
    np.testing.assert_array_equal(p["out"], ref["out"])


def test_bfs_dense(R):
    r, c, _, n = _graph(seed=5)

    def run(g):
        AT = g.Matrix.from_coo(r, c, np.ones(len(r), np.float32), nrows=n, ncols=n)
        runner = g.dsl.bfs_level_dense_runner(AT, 2)
        out = _dense(runner(), -1)
        loop = _loop(runner)
        return {"layout": loop.layout, "mode": loop.mode, "iters": int(loop.last_iters), "out": out}

    p, ref = both(R, run)
    _port_layout(p)
    assert (p["mode"], p["iters"]) == (ref["mode"], ref["iters"])
    np.testing.assert_array_equal(p["out"], ref["out"])


def test_two_direction_cc(R):
    # cc pulls AND pushes (two plans)
    r, c, _, n = _graph(seed=11)

    def run(g):
        AT = g.Matrix.from_coo(r, c, np.ones(len(r), np.float32), nrows=n, ncols=n)
        runner = g.dsl.connected_components_runner(AT)
        out = _dense(runner(), -1)
        loop = _loop(runner)
        return {"layout": loop.layout, "mode": loop.mode, "iters": int(loop.last_iters), "out": out}

    p, ref = both(R, run)
    _port_layout(p)
    assert (p["mode"], p["iters"]) == (ref["mode"], ref["iters"])
    np.testing.assert_array_equal(p["out"], ref["out"])
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
        assert (p["out"][a] == p["out"][b]) == (roots[a] == roots[b])


def test_indexed_assign_in_body(R):
    r, c, w, n = _graph(seed=13)

    def run(g):
        AT = g.Matrix.from_coo(r, c, w, nrows=n, ncols=n)

        def body(x):
            y = AT.mxv(x, g.semiring.plus_times).new(g.dtm.FP32)
            out = x.ewise_add(y, g.binary.plus).new(g.dtm.FP32).dup()
            out[3] = 7.0  # a vertex-indexed write
            return out

        runner = g.gb.loop_runner(3, body, g.Vector.from_dense(np.zeros(n, np.float32)))
        out = _dense(runner())
        return {"layout": runner.layout, "mode": runner.mode, "out": out, "capture": getattr(runner, "capture", None)}

    p, ref = both(R, run)
    _port_layout(p)
    assert p["mode"] == ref["mode"]
    np.testing.assert_allclose(p["out"], ref["out"], rtol=1e-6)
    x = np.zeros(n)
    A = np.zeros((n, n))
    A[r, c] = w
    for _ in range(3):
        x = x + A @ x
        x[3] = 7.0
    np.testing.assert_allclose(p["out"], x.astype(np.float32), atol=1e-4)
    assert p["capture"] == "graph"  # a one-element region is a slice copy: nothing uploaded per step


def test_positional_apply_in_body(R):
    r, c, w, n = _graph(seed=17)

    def run(g):
        AT = g.Matrix.from_coo(r, c, w, nrows=n, ncols=n)

        def body(x):
            y = AT.mxv(x, g.semiring.plus_times).new(g.dtm.FP32)
            idx = x.apply("positioni").new(g.dtm.FP32)
            return y.ewise_add(idx, g.binary.plus).new(g.dtm.FP32)

        runner = g.gb.loop_runner(2, body, g.Vector.from_dense(np.zeros(n, np.float32)))
        out = _dense(runner())
        return {"layout": runner.layout, "mode": runner.mode, "out": out}

    p, ref = both(R, run)
    _port_layout(p)
    assert p["mode"] == ref["mode"]
    np.testing.assert_allclose(p["out"], ref["out"], rtol=1e-6)
    x = np.zeros(n)
    A = np.zeros((n, n))
    A[r, c] = w
    for _ in range(2):
        x = A @ x + np.arange(n)
    np.testing.assert_allclose(p["out"], x.astype(np.float32), rtol=1e-4)


def test_complement_mask_in_body(R):
    # a complemented value mask in the body
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

        runner = g.gb.loop_runner(
            3, body, g.Vector.from_dense(np.full(n, 10.0, np.float32)), g.Vector.from_dense(np.zeros(n, np.float32))
        )
        x, f = runner()
        return {"layout": runner.layout, "mode": runner.mode, "x": _dense(x), "f": _dense(f)}

    p, ref = both(R, run)
    _port_layout(p)
    assert p["mode"] == ref["mode"]
    np.testing.assert_allclose(p["x"], ref["x"], rtol=1e-5)
    np.testing.assert_allclose(p["f"], ref["f"], rtol=1e-5)


def test_runner_with_new_state(R):
    r, c, w, n = _graph(seed=23)
    v1 = np.linspace(0, 1, n).astype(np.float32)

    def run(g):
        AT = g.Matrix.from_coo(r, c, w, nrows=n, ncols=n)

        def body(x):
            y = AT.mxv(x, g.semiring.plus_times).new(g.dtm.FP32)
            return y.ewise_add(x, g.binary.plus).new(g.dtm.FP32)

        runner = g.gb.loop_runner(2, body, g.Vector.from_dense(np.ones(n, np.float32)))
        out = _dense(runner(g.Vector.from_dense(v1)))
        return {"layout": runner.layout, "mode": runner.mode, "out": out}

    p, ref = both(R, run)
    _port_layout(p)
    assert p["mode"] == ref["mode"]
    np.testing.assert_allclose(p["out"], ref["out"], rtol=1e-6)
    A = np.zeros((n, n))
    A[r, c] = w
    x = v1.astype(np.float64)
    for _ in range(2):
        x = A @ x + x
    np.testing.assert_allclose(p["out"], x.astype(np.float32), rtol=1e-4)


def test_indeg0_values_preserved(R):
    # vertices with no in-edges keep their evolving state: their value
    # changes every round
    r, c, w, n = _graph(seed=29, indeg0_tail=60)

    def run(g):
        AT = g.Matrix.from_coo(r, c, w, nrows=n, ncols=n)

        def body(x):
            y = AT.mxv(x, g.semiring.plus_times).new(g.dtm.FP32)
            return y.ewise_add(x.apply(g.binary.times, right=2.0), g.binary.plus).new(g.dtm.FP32)

        runner = g.gb.loop_runner(3, body, g.Vector.from_dense(np.arange(n, dtype=np.float32)))
        out = _dense(runner())
        return {"layout": runner.layout, "mode": runner.mode, "out": out}

    p, ref = both(R, run)
    _port_layout(p)
    assert p["mode"] == ref["mode"]
    np.testing.assert_allclose(p["out"], ref["out"], rtol=1e-6)
    A = np.zeros((n, n))
    A[r, c] = w
    x = np.arange(n, dtype=np.float64)
    for _ in range(3):
        x = A @ x + 2.0 * x
    np.testing.assert_allclose(p["out"], x.astype(np.float32), rtol=2e-4)


def test_sssp_until_past_dense_limit_f4(R):
    """ROADMAP's F4: Bellman-Ford under ``until_runner`` (the benchmark's
    SSSP body) with n 512 and ``dense_limit=1024``, so the matrix is sparse
    and the distances dense, on the plan and auto strategies.  The port once
    raised ``TracerError`` here, in the edge layout's warm step."""
    n = 512
    rng = np.random.default_rng(0)
    r, c = rng.integers(0, n, 4000), rng.integers(0, n, 4000)
    _, idx = np.unique(r.astype(np.int64) * n + c, return_index=True)
    r, c = r[idx], c[idx]
    w = np.ones(len(r), np.float32)

    def run(g):
        FP32, BOOL = g.dtm.FP32, g.dtm.BOOL
        A = g.Matrix.from_coo(r, c, w, nrows=n, ncols=n)
        assert A._sparse is not None

        def body(dist, changed):
            relaxed = A.mxv(dist, g.semiring.min_plus).new(FP32)
            new = dist.dup()
            new(accum=g.binary.min) << relaxed
            changed = new.ewise_mult(dist, g.binary.lt).reduce(g.monoid.lor).new(BOOL)
            return new, changed

        def cond(dist, changed):
            return changed

        dist = g.Vector.from_scalar(float("inf"), n, FP32)
        dist[0] = 0.0
        runner = g.gb.until_runner(cond, body, dist, g.Scalar.from_value(True, BOOL), max_iters=n)
        out, _ = runner()
        return {"layout": runner.layout, "mode": runner.mode, "iters": runner.last_iters, "out": _dense(out, np.inf)}

    for strategy in ("plan", "auto"):
        with P.tx.config.set(mxv_strategy=strategy), R.tx.config.set(mxv_strategy=strategy):
            p, ref = both(R, run, dense_limit=1024)
        _port_layout(p)
        assert (p["mode"], p["iters"]) == (ref["mode"], ref["iters"]), strategy
        np.testing.assert_array_equal(p["out"], ref["out"])
        assert np.isfinite(p["out"]).sum() > 1


def test_compiled_mxv_is_the_gather_fused_scan_and_the_collect():
    """A compiled SpMV in the n space on the plan engine is two launches a
    step: C with x's gather fused (``segscan_contrib_gather``) and the
    collect (one G), and never C on a routed xe (``segscan_contrib``) or a
    fill; counted by the plain versions here, the result the generic
    path's."""
    from graphblas_tpu_torch import kernels

    r, c, w, n = _graph(seed=31)
    AT = P.Matrix.from_coo(r, c, w, nrows=n, ncols=n)
    g = ns(P)

    def body(x):
        return AT.mxv(x, g.semiring.plus_times).new(g.dtm.FP32).ewise_add(x, g.binary.plus).new(g.dtm.FP32)

    outs = {}
    for strategy in ("plan", "generic"):
        with P.tx.config.set(mxv_strategy=strategy):
            runner = P.loop_runner(4, body, P.Vector.from_dense(np.ones(n, np.float32)))
            kernels.reset_counts()
            outs[strategy] = _dense(runner())
            if strategy == "plan":
                counts = kernels.plain_counts()
        assert runner.layout == "n"
    np.testing.assert_allclose(outs["plan"], outs["generic"], rtol=1e-6)
    assert counts["gather"] == 4 * 1
    assert counts["gather_fill"] == 0
    assert counts["segscan_contrib_gather"] == 4
    assert counts["segscan_contrib"] == 0
