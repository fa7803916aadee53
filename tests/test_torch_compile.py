"""Parity of the port's compiled loops (``gb.compile``, ``gb.loop``,
``gb.until``, ``models.dsl``) with the JAX package's, case for case with
``tests/test_compile.py``.

Each case runs the same loop body on the same numpy-seeded inputs through
both packages, with ``tx.config["mxv_strategy"]`` pinned on both, and holds
the port to the reference: results bit for bit for integer, bool, min and
max (BFS levels, SSSP distances: a min over float32 path sums, CC labels);
float plus within 1e-6 relative; PageRank within 1e-5 (float32 sums, and
the plan channel's scan adds in another order than the reference's
segment sum).  ``mode``, ``layout`` and ``last_iters`` equal the
reference's.  The port runs on the CPU, where a compiled loop runs its steps
eagerly; ``capture`` reports the decision the card takes ("graph" unless
the body uploads host data or reads the card).  Host reads inside a body
raise ``TracerError``.

The CUDA tests (``-m cuda``; they skip here) hold the captured CUDA graphs
against the same runners run eagerly on the card, across two replays:
``python -m pytest --noconftest -m cuda tests/test_torch_compile.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as P
from graphblas_tpu_torch import exceptions as pexc

N = 120


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    import graphblas_tpu as R

    return R


@pytest.fixture(autouse=True)
def _pinned():
    with P.tx.config.set(platform="cpu"):
        yield


def ns(pkg):
    from importlib import import_module

    name = pkg.__name__
    return SimpleNamespace(
        gb=pkg, Matrix=pkg.Matrix, Vector=pkg.Vector, Scalar=pkg.Scalar, binary=pkg.binary, monoid=pkg.monoid,
        semiring=pkg.semiring, unary=pkg.unary, dtm=import_module(f"{name}.core.dtypes"),
        dsl=import_module(f"{name}.models.dsl"), compiler=import_module(f"{name}.core.compiler"), tx=pkg.tx,
    )


def both(R, fn, strategy="auto", **cfg):
    """fn(ns) on the port and on the reference, each with ``mxv_strategy``
    pinned (and any other tx.config keys)."""
    out = []
    for pkg in (P, R):
        with pkg.tx.config.set(mxv_strategy=strategy, **cfg):
            out.append(fn(ns(pkg)))
    return out


def dense(v, fill=0.0):
    return np.asarray(v.to_dense(fill_value=fill))


def _rand_graph(n=N, e=700, seed=0, weighted=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    pair = src.astype(np.int64) * n + dst
    _, uidx = np.unique(pair, return_index=True)
    src, dst = src[uidx], dst[uidx]
    w = (rng.random(len(src)) + 0.1).astype(np.float32) if weighted else None
    return src, dst, w


def _pull_matrix(g, src, dst, w, n, sparse):
    vals = np.float32(1.0) if w is None else w
    dup = g.binary.first if w is None else g.binary.min
    if sparse:
        with g.tx.config.set(dense_limit=0):
            return g.Matrix.from_coo(dst, src, vals, g.dtm.FP32, nrows=n, ncols=n, dup_op=dup)
    return g.Matrix.from_coo(dst, src, vals, g.dtm.FP32, nrows=n, ncols=n, dup_op=dup)


def _union_find_minlabel(src, dst, n):
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for s, t in zip(src, dst):
        rs, rt = find(int(s)), find(int(t))
        if rs != rt:
            parent[rs] = rt
    roots = np.array([find(i) for i in range(n)])
    minlab = {}
    for i in range(n):
        minlab.setdefault(roots[i], i)
    return np.array([minlab[roots[i]] for i in range(n)])


# ---------------------------------------------------------------------------
# gb.loop basics
# ---------------------------------------------------------------------------


def test_loop_vector_values_only(R):
    def run(g):
        v = g.Vector.from_dense(np.arange(8, dtype=np.float64))
        r = g.gb.loop_runner(5, lambda x: x.apply(g.binary.plus, right=1.0).new(x.dtype), v)
        out = r()
        return dense(out), r.mode, g.compiler.last_loop_mode(), type(out).__name__

    p, r = both(R, run)
    np.testing.assert_array_equal(p[0], r[0])
    assert p[1:] == r[1:] == ("hoisted", "hoisted", "Vector")


def test_loop_multi_state_and_scalar(R):
    def run(g):
        v = g.Vector.from_dense(np.ones(6))
        s = g.Scalar.from_value(0.0)

        def body(x, acc):
            x2 = x.apply(g.binary.times, right=2.0).new(x.dtype)
            acc2 = (acc + x2.reduce(g.monoid.plus)).new(acc.dtype)
            return x2, acc2

        x, acc = g.gb.loop(3, body, v, s)
        return dense(x), float(np.asarray(acc.value))

    p, r = both(R, run)
    np.testing.assert_array_equal(p[0], r[0])
    assert p[1] == r[1] == 84.0


def test_loop_zero_iters_identity(R):
    def run(g):
        v = g.Vector.from_dense(np.arange(4, dtype=np.float64))
        return dense(g.gb.loop(0, lambda x: x.apply(g.binary.plus, right=1.0).new(x.dtype), v))

    p, r = both(R, run)
    np.testing.assert_array_equal(p, r)
    np.testing.assert_array_equal(p, np.arange(4))


def test_loop_structure_fallback_when_struct_changes(R):
    def run(g):
        v = g.Vector.from_coo([0], [1.0], g.dtm.FP64, size=6)
        ones = g.Vector.from_dense(np.ones(6))
        out = g.gb.loop(2, lambda x: x.ewise_add(ones, g.binary.first).new(x.dtype), v)
        return g.compiler.last_loop_mode(), out.nvals, dense(out)

    p, r = both(R, run)
    assert p[:2] == r[:2] == ("carried", 6)
    np.testing.assert_array_equal(p[2], r[2])


def test_loop_body_arity_error(R):
    for pkg in (P, R):
        g = ns(pkg)
        v = g.Vector.from_dense(np.ones(4))
        with pytest.raises(TypeError, match="same number of state"):
            g.gb.loop(2, lambda x: (x, x), v)


def test_loop_empty_scalar_state_rejected(R):
    for pkg in (P, R):
        g = ns(pkg)
        with pytest.raises(TypeError, match="empty Scalar"):
            g.gb.loop(1, lambda x: x, g.Scalar(g.dtm.FP64))


def test_loop_sparse_matrix_state_rejected(R):
    for pkg in (P, R):
        g = ns(pkg)
        with g.tx.config.set(dense_limit=0):
            A = g.Matrix.from_coo([0, 1], [1, 0], [1.0, 2.0], g.dtm.FP64, nrows=2, ncols=2)
        assert A._sparse is not None
        with pytest.raises(TypeError, match="sparse-format"):
            g.gb.loop(1, lambda x: x, A)


# ---------------------------------------------------------------------------
# gb.until
# ---------------------------------------------------------------------------


def test_until_scalar_condition(R):
    def run(g):
        v = g.Vector.from_dense(np.array([1.0, 2.0, 3.0]))
        r = g.gb.until_runner(
            lambda x: (x.reduce(g.monoid.plus) < 100.0).new(g.dtm.BOOL),
            lambda x: x.apply(g.binary.times, right=2.0).new(x.dtype),
            v,
        )
        return dense(r()), int(r.last_iters), r.mode

    p, r = both(R, run)
    np.testing.assert_array_equal(p[0], r[0])
    np.testing.assert_array_equal(p[0], np.array([1.0, 2.0, 3.0]) * 32)
    assert p[1:] == r[1:] == (5, "hoisted")


def test_until_max_iters(R):
    def run(g):
        v = g.Vector.from_dense(np.ones(3))
        r = g.gb.until_runner(
            lambda x: (x.reduce(g.monoid.plus) > 0.0).new(g.dtm.BOOL),
            lambda x: x.apply(g.binary.plus, right=1.0).new(x.dtype),
            v,
            max_iters=4,
        )
        return dense(r()), int(r.last_iters)

    p, r = both(R, run)
    np.testing.assert_array_equal(p[0], r[0])
    np.testing.assert_array_equal(p[0], np.full(3, 5.0))
    assert p[1] == r[1] == 4


# ---------------------------------------------------------------------------
# gb.compile
# ---------------------------------------------------------------------------


def test_compile_simple_function(R):
    def run(g):
        @g.gb.compile
        def fused(x, y):
            s = x.ewise_add(y, g.binary.plus).new(x.dtype)
            return s.apply(g.binary.times, right=3.0).new(s.dtype)

        a = g.Vector.from_dense(np.arange(5, dtype=np.float64))
        b = g.Vector.from_dense(np.ones(5))
        out, out2 = fused(a, b), fused(a, b)
        return dense(out), dense(out2), len(fused._cache)

    p, r = both(R, run)
    np.testing.assert_array_equal(p[0], (np.arange(5) + 1) * 3.0)
    for a, b in zip(p[:2], r[:2]):
        np.testing.assert_array_equal(a, b)
    assert p[2] == r[2] == 1


def test_compile_returns_tuple_and_scalar(R):
    def run(g):
        @g.gb.compile
        def fn(x):
            doubled = x.apply(g.binary.times, right=2.0).new(x.dtype)
            return doubled, doubled.reduce(g.monoid.plus).new(x.dtype)

        d, t = fn(g.Vector.from_dense(np.arange(4, dtype=np.float64)))
        return dense(d), float(np.asarray(t.value))

    p, r = both(R, run)
    np.testing.assert_array_equal(p[0], r[0])
    assert p[1] == r[1] == 12.0


@pytest.mark.parametrize("strategy", ["generic", "plan"])
def test_compile_sparse_matrix_static_operand(R, strategy):
    src, dst, _ = _rand_graph()

    def run(g):
        with g.tx.config.set(dense_limit=0):
            AT = g.Matrix.from_coo(dst, src, np.float32(1.0), g.dtm.FP32, nrows=N, ncols=N)
        assert AT._sparse is not None

        @g.gb.compile
        def step(A, x):
            return A.mxv(x, g.semiring.plus_times).new(g.dtm.FP32)

        return dense(step(AT, g.Vector.from_dense(np.ones(N, np.float32))))

    p, r = both(R, run, strategy)
    np.testing.assert_array_equal(p, r)  # counts: exact
    np.testing.assert_array_equal(p, np.bincount(dst, minlength=N).astype(np.float32))


def test_compile_loop_inside_compile(R):
    def run(g):
        @g.gb.compile
        def fn(x):
            return g.gb.loop(3, lambda v: v.apply(g.binary.plus, right=1.0).new(v.dtype), x)

        return dense(fn(g.Vector.from_dense(np.zeros(4))))

    p, r = both(R, run)
    np.testing.assert_array_equal(p, r)
    np.testing.assert_array_equal(p, np.full(4, 3.0))


# ---------------------------------------------------------------------------
# DSL algorithm parity (models.dsl against the reference's)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sparse", [False, True])
def test_dsl_pagerank_matches_model(R, sparse):
    src, dst, _ = _rand_graph(seed=3)

    def run(g):
        r = g.dsl.pagerank_runner(_pull_matrix(g, src, dst, None, N, sparse), max_iters=25)
        return dense(r()), r.mode, r.layout

    p, r = both(R, run)
    assert p[1:] == r[1:] and p[1] == "hoisted"  # rank vector is structurally stable
    # float32 sums over 25 rounds, added in another order than XLA's
    np.testing.assert_allclose(p[0], r[0], rtol=1e-5, atol=1e-7)
    # and the port's own hand-written model
    from graphblas_tpu_torch.models import fast as pf

    g = P.models.Graph.from_arrays(src, dst, n=N, device="cpu")
    outdeg = torch.from_numpy(np.bincount(src, minlength=N).astype(np.int32))
    r_model = pf.pagerank(pf.analyze(g), outdeg, N, max_iters=25, tol=0.0).numpy()
    np.testing.assert_allclose(p[0], r_model, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sparse", [False, True])
def test_dsl_bfs_matches_model(R, sparse):
    src, dst, _ = _rand_graph(seed=4)

    def run(g):
        run = g.dsl.bfs_level_runner(_pull_matrix(g, src, dst, None, N, sparse), 0)
        idx, vals = run().to_coo()
        got = np.full(N, -1, np.int64)
        got[np.asarray(idx).astype(np.int64)] = vals
        return got, run.runner.mode, int(run.runner.last_iters)

    p, r = both(R, run)
    assert p[1:] == r[1:]
    np.testing.assert_array_equal(p[0], r[0])


@pytest.mark.parametrize("sparse", [False, True])
def test_dsl_sssp_matches_oracle(R, sparse):
    src, dst, w = _rand_graph(seed=5, weighted=True)

    def run(g):
        run = g.dsl.sssp_runner(_pull_matrix(g, src, dst, w, N, sparse), 0)
        return dense(run(), np.inf), run.runner.mode, int(run.runner.last_iters)

    p, r = both(R, run)
    assert p[1:] == r[1:] and p[1] == "hoisted"  # dense distance vector
    np.testing.assert_array_equal(p[0], r[0])  # a min over float32 path sums: bit for bit


@pytest.mark.parametrize("sparse", [False, True])
def test_dsl_connected_components_matches_unionfind(R, sparse):
    src, dst, _ = _rand_graph(seed=6)
    u, v = np.concatenate([src, dst]), np.concatenate([dst, src])

    def run(g):
        run = g.dsl.connected_components_runner(_pull_matrix(g, u, v, None, N, sparse))
        return dense(run(), -1).astype(np.int64), run.runner.mode, int(run.runner.last_iters)

    p, r = both(R, run)
    assert p[1:] == r[1:]
    np.testing.assert_array_equal(p[0], r[0])
    np.testing.assert_array_equal(p[0], _union_find_minlabel(src, dst, N))


def test_dsl_pagerank_plan_strategy(R):
    """The plan engine under the compiled loop (what the card runs) against
    the generic path: the same ranks."""
    src, dst, _ = _rand_graph(seed=7)

    def run(g):
        with g.tx.config.set(dense_limit=0):
            AT = g.Matrix.from_coo(dst, src, np.float32(1.0), g.dtm.FP32, nrows=N, ncols=N)
        r_generic = dense(g.dsl.pagerank(AT, max_iters=20))
        with g.tx.config.set(mxv_strategy="plan"):
            r_plan = dense(g.dsl.pagerank(AT, max_iters=20))
        return r_generic, r_plan

    p, r = both(R, run, "auto")
    np.testing.assert_allclose(p[1], p[0], atol=1e-6)
    np.testing.assert_allclose(p[1], r[1], rtol=1e-5, atol=1e-7)


def test_dsl_cc_plan_strategy(R):
    src, dst, _ = _rand_graph(seed=8)
    u, v = np.concatenate([src, dst]), np.concatenate([dst, src])

    def run(g):
        with g.tx.config.set(dense_limit=0):
            ATs = g.Matrix.from_coo(v, u, np.float32(1.0), g.dtm.FP32, nrows=N, ncols=N, dup_op=g.binary.first)
        p0 = dense(g.dsl.connected_components(ATs), -1)
        with g.tx.config.set(mxv_strategy="plan"):
            p1 = dense(g.dsl.connected_components(ATs), -1)
        return p0, p1

    p, r = both(R, run, "auto")
    np.testing.assert_array_equal(p[0], p[1])
    np.testing.assert_array_equal(p[1], r[1])


@pytest.mark.parametrize("sparse", [False, True])
def test_dsl_fastsv_matches_unionfind(R, sparse):
    src, dst, _ = _rand_graph(seed=9)
    u, v = np.concatenate([src, dst]), np.concatenate([dst, src])

    def run(g):
        return dense(g.dsl.fastsv(_pull_matrix(g, u, v, None, N, sparse)), -1).astype(np.int64)

    p, r = both(R, run)
    np.testing.assert_array_equal(p, r)
    np.testing.assert_array_equal(p, _union_find_minlabel(src, dst, N))


def test_dsl_fastsv_plan_strategy(R):
    src, dst, _ = _rand_graph(seed=10)
    u, v = np.concatenate([src, dst]), np.concatenate([dst, src])

    def run(g):
        with g.tx.config.set(dense_limit=0):
            ATs = g.Matrix.from_coo(v, u, np.float32(1.0), g.dtm.FP32, nrows=N, ncols=N, dup_op=g.binary.first)
        f0 = dense(g.dsl.fastsv(ATs), -1)
        with g.tx.config.set(mxv_strategy="plan"):
            f1 = dense(g.dsl.fastsv(ATs), -1)
        return f0, f1

    p, r = both(R, run, "auto")
    np.testing.assert_array_equal(p[0], p[1])
    np.testing.assert_array_equal(p[1], r[1])


def test_bfs_level_dense_hoisted(R):
    """The dense-frontier BFS recipe compiles in HOISTED mode and matches the
    notebook recipe's levels."""
    rng = np.random.default_rng(3)
    n = 60
    src = rng.integers(0, n, 240)
    dst = rng.integers(0, n, 240)
    keep = src != dst

    def run(g):
        AT = g.Matrix.from_coo(dst[keep], src[keep], 1.0, g.dtm.FP32, nrows=n, ncols=n, dup_op="first")
        run = g.dsl.bfs_level_dense_runner(AT, int(src[0]))
        v = dense(run(), -1)
        ri, rl = g.dsl.bfs_level(AT, int(src[0])).to_coo()
        return v, {int(i): int(l) for i, l in zip(ri, rl)}, run.mode, int(run.runner.last_iters)

    p, r = both(R, run)
    assert p[2:] == r[2:] and p[2] == "hoisted"
    np.testing.assert_array_equal(p[0], r[0])
    assert {i: int(p[0][i]) for i in range(n) if p[0][i] >= 0} == p[1] == r[1]


def test_until_unroll_matches_sequential(R):
    """unroll=K runs K body steps per condition read: the same fixpoint, and
    the same step counts as the reference.  The body builds a Matrix from
    host arrays every step, so on the card it runs eagerly."""

    def run(g):
        def cond(d):
            return d.reduce(g.monoid.max).apply(g.binary.gt, right=4.0)

        def body(d):
            n = d.size
            A = g.Matrix.from_coo(np.arange(1, n), np.arange(n - 1), np.ones(n - 1, np.float32), nrows=n, ncols=n)
            new = d.dup()
            new(accum=g.binary.min) << A.mxv(d, "min_plus").new(g.dtm.FP32)
            return new

        outs = {}
        for k in (1, 2, 3):
            d0 = g.Vector.from_dense(np.array([0.0, 100.0, 100.0, 100.0, 100.0], np.float32))
            r = g.gb.until_runner(cond, body, d0, max_iters=64, unroll=k)
            outs[k] = (dense(r()), int(r.last_iters), r.mode, getattr(r, "capture", None))
        return outs

    p, r = both(R, run)
    for k in (1, 2, 3):
        np.testing.assert_array_equal(p[k][0], r[k][0])
        np.testing.assert_array_equal(p[k][0], p[1][0])
        assert p[k][1:3] == r[k][1:3] and p[k][1] % k == 0
        assert p[k][3] == "eager"


def test_dsl_unroll_env_matches_default(R, monkeypatch):
    """GRAPHBLAS_TPU_DSL_UNROLL=2 gives identical BFS/SSSP/CC results, in both
    packages."""
    rng = np.random.default_rng(4)
    src = rng.integers(0, 60, 500)
    dst = rng.integers(0, 60, 500)

    def run(g):
        AT = g.Matrix.from_coo(dst, src, np.ones(500, np.float32), nrows=60, ncols=60, dup_op=g.binary.plus)
        ATs = g.Matrix.from_coo(
            np.concatenate([dst, src]), np.concatenate([src, dst]), np.ones(1000, np.float32),
            nrows=60, ncols=60, dup_op=g.binary.first,
        )
        return {
            "bfs": dense(g.dsl.bfs_level_dense(AT, 0), -1),
            "bfsc": sorted(zip(*(np.asarray(a).tolist() for a in g.dsl.bfs_level(AT, 0).to_coo()))),
            "sssp": np.asarray(g.dsl.sssp(AT, 0).to_dense()),
            "cc": np.asarray(g.dsl.connected_components(ATs).to_dense()),
        }

    base = both(R, run)
    monkeypatch.setenv("GRAPHBLAS_TPU_DSL_UNROLL", "2")
    unrolled = both(R, run)
    for got in base[1:] + unrolled:
        for k in ("bfs", "sssp", "cc"):
            np.testing.assert_array_equal(got[k], base[0][k])
        assert got["bfsc"] == base[0]["bfsc"]


def test_compiled_loop_consts_all_committed(R):
    """Every constant of a compiled recipe is on the state's device once the
    runner is built (the warm step uploads it): no step uploads host data,
    so the card captures every recipe in a CUDA graph.  (The reference's
    counterpart asserts its hoisted consts are device arrays.)"""
    src, dst, w = _rand_graph(80, 400, seed=5, weighted=True)
    g = ns(P)
    AT = g.Matrix.from_coo(dst, src, w, nrows=80, ncols=80, dup_op=g.binary.plus)
    runners = [
        g.dsl.pagerank_runner(AT, max_iters=3),
        g.dsl.sssp_runner(AT, 0).runner,
        g.dsl.bfs_level_dense_runner(AT, 0).runner,
        g.dsl.connected_components_runner(AT).runner,
        g.dsl.bfs_level_runner(AT, 0).runner,
    ]
    dev = torch.device("cpu")
    for r in runners:
        assert r.capture == "graph", r.capture_reason
        assert all(t.device == dev for t in r._leaves0)
        if r.mode == "hoisted":
            assert all(t.device == dev for t in r._values0)
            assert all(s is None or s.device == dev for s in r._structs)
    # the same recipes' modes as the reference's
    g_r = ns(R)
    AT_r = g_r.Matrix.from_coo(dst, src, w, nrows=80, ncols=80, dup_op=g_r.binary.plus)
    modes_r = [
        g_r.dsl.pagerank_runner(AT_r, max_iters=3).mode,
        g_r.dsl.sssp_runner(AT_r, 0).mode,
        g_r.dsl.bfs_level_dense_runner(AT_r, 0).mode,
        g_r.dsl.connected_components_runner(AT_r).mode,
        g_r.dsl.bfs_level_runner(AT_r, 0).mode,
    ]
    assert [r.mode for r in runners] == modes_r


@pytest.mark.parametrize("sparse", [False, True])
def test_dsl_cc_directed_wcc(R, sparse):
    """connected_components on a NON-symmetric adjacency computes weakly
    connected components."""
    src, dst, _ = _rand_graph(n=100, e=150, seed=9)

    def run(g):
        return dense(g.dsl.connected_components(_pull_matrix(g, dst, src, None, 100, sparse)), -1).astype(np.int64)

    p, r = both(R, run)
    np.testing.assert_array_equal(p, r)
    np.testing.assert_array_equal(p, _union_find_minlabel(src, dst, 100))


def test_dsl_seed_round_ab(R, monkeypatch):
    """The build-time seed round changes no result (GRAPHBLAS_TPU_SEED_ROUND=0
    and =1 agree, corner sources included), and both packages agree."""
    src, dst, w = _rand_graph(n=90, e=300, seed=12, weighted=True)
    keep = ~np.isin(src, [80, 83]) & ~np.isin(dst, [81, 83])
    src, dst, w = src[keep], dst[keep], w[keep]

    def run(g):
        AT = _pull_matrix(g, dst, src, w, 90, True)
        res = {}
        for s in (0, 80, 81, 83):
            res[("bfs", s)] = dense(g.dsl.bfs_level_dense(AT, s), -1)
            res[("sssp", s)] = np.asarray(g.dsl.sssp(AT, s).to_dense())
        res["cc"] = dense(g.dsl.connected_components(AT), -1)
        return res

    got = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("GRAPHBLAS_TPU_SEED_ROUND", flag)
        got[flag] = both(R, run)
    for k in got["0"][0]:
        np.testing.assert_array_equal(got["1"][0][k], got["0"][0][k], err_msg=str(k))
        for flag in ("0", "1"):
            np.testing.assert_array_equal(got[flag][0][k], got[flag][1][k], err_msg=str(k))


# ---------------------------------------------------------------------------
# the port's own contract: host reads raise, the capture decision, new state
# ---------------------------------------------------------------------------


READS = {
    "float": lambda x, s: float(s),
    "value": lambda x, s: s.value,
    "to_coo": lambda x, s: x.to_coo(),
    "repr": lambda x, s: repr(x),
    "nvals": lambda x, s: x.select(">", 1.0).new().nvals,
    "bool": lambda x, s: bool(s),
}


@pytest.mark.parametrize("what", sorted(READS))
def test_host_reads_inside_a_body_raise(what):
    g = ns(P)
    v = g.Vector.from_dense(np.arange(6, dtype=np.float32))

    def body(x):
        y = x.apply(g.binary.plus, right=1.0).new(x.dtype)
        READS[what](y, y.reduce(g.monoid.plus).new())
        return y

    with pytest.raises(pexc.TracerError):
        g.gb.loop(2, body, v)
    assert isinstance(pexc.TracerError("x"), TypeError)


def test_nvals_of_a_constant_structure_reads_the_host_value():
    """``.nvals`` of a hoisted (constant) structure counts on the host, as
    the reference counts its numpy structure; the loop still captures."""
    g = ns(P)
    v = g.Vector.from_coo([0, 3], [1.0, 2.0], g.dtm.FP32, size=6)
    seen = []

    def body(x):
        seen.append(x.nvals)
        return x.apply(g.binary.times, right=2.0).new(x.dtype)

    r = g.gb.loop_runner(3, body, v)
    out = r()
    assert (r.mode, r.capture) == ("hoisted", "graph") and set(seen) == {2}
    np.testing.assert_array_equal(dense(out), [8.0, 0, 0, 16.0, 0, 0])


def test_capture_decision_names_its_reason():
    """A body that reads a closed-over device value on the host (concrete, as
    under the reference's trace) runs eagerly on the card (``capture ==
    "eager"``), with the reason; one that does neither is captured.  A value
    computed inside the body is traced: reading it raises."""
    g = ns(P)
    k = g.Vector.from_dense(np.full(4, 2.0, np.float32))
    v = g.Vector.from_dense(np.ones(4, np.float32))

    def reads(x):
        scale = float(k.to_coo()[1].max())  # a closed-over (concrete) value, read on the host
        return x.apply(g.binary.times, right=scale).new(x.dtype)

    r = g.gb.loop_runner(2, reads, v)
    assert r.capture == "eager" and "reads device values" in r.capture_reason
    np.testing.assert_array_equal(dense(r()), np.full(4, 4.0))
    with pytest.raises(pexc.TracerError):
        g.gb.loop(2, lambda x: x.apply(g.binary.times, right=float(k.reduce(g.monoid.max).new())).new(x.dtype), v)
    r2 = g.gb.loop_runner(2, lambda x: x.ewise_mult(k, g.binary.times).new(x.dtype), v)
    assert (r2.capture, r2.capture_reason) == ("graph", None)
    np.testing.assert_array_equal(dense(r2()), np.full(4, 4.0))


def test_runner_new_state_and_structure_check(R):
    """runner(*state) reruns from new collections; in hoisted mode a new
    structure raises, as in the reference."""

    def run(g):
        v = g.Vector.from_dense(np.ones(5, np.float32))
        r = g.gb.loop_runner(2, lambda x: x.apply(g.binary.times, right=3.0).new(x.dtype), v)
        a = dense(r(g.Vector.from_dense(np.arange(5, dtype=np.float32))))
        b = dense(r())
        with pytest.raises(ValueError, match="fixed structure"):
            r(g.Vector.from_coo([1], [1.0], g.dtm.FP32, size=5))
        return a, b

    p, r = both(R, run)
    for a, b in zip(p, r):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(p[0], np.arange(5) * 9.0)


def test_results_do_not_share_the_runners_buffers():
    """Each call returns its own tensors: a second run leaves the first
    result as it was."""
    g = ns(P)
    r = g.gb.loop_runner(2, lambda x: x.apply(g.binary.plus, right=1.0).new(x.dtype), g.Vector.from_dense(np.zeros(3)))
    a = r()
    b = r(g.Vector.from_dense(np.full(3, 10.0)))
    np.testing.assert_array_equal(dense(a), np.full(3, 2.0))
    np.testing.assert_array_equal(dense(b), np.full(3, 12.0))


@pytest.mark.parametrize("strategy", ["generic", "plan"])
def test_a_capture_keeps_what_it_reads(strategy):
    """A CUDA graph replays on the addresses its inputs had at capture, so
    the capture scope keeps every tensor made outside it that an operation
    inside reads (the closed-over matrix's device arrays or plan, the
    closed-over operand's values) and none that it made itself.  The scope
    is the same on the CPU, where it is shown here."""
    from graphblas_tpu_torch.core import capture

    g = ns(P)
    src, dst, _ = _rand_graph()
    with g.tx.config.set(mxv_strategy=strategy):
        AT = _pull_matrix(g, src, dst, None, N, sparse=True)
        k = g.Vector.from_dense(np.linspace(1.0, 2.0, N).astype(np.float32))

        def body(x):
            y = AT.mxv(x, g.semiring.plus_times).new(g.dtm.FP32)
            return y.ewise_mult(k, g.binary.times).new(g.dtm.FP32)

        x = g.Vector.from_dense(np.ones(N, np.float32))
        with capture.Scope("warm"):
            body(g.Vector._from_arrays(capture.traced(x._values.clone()), x._struct, x.dtype))
        with capture.Scope("capture") as scope:
            y = body(g.Vector._from_arrays(capture.traced(x._values.clone()), x._struct, x.dtype))
    kept = {id(t) for t in scope.kept.values()}
    assert id(k._values) in kept and id(y._values) not in kept
    device_arrays = [t for key, t in AT._sparse._dev.items()]
    if strategy == "plan":
        device_arrays += list(AT._sparse.plan("pull", "cpu").arrays().values())
    assert any(id(t) in kept for t in device_arrays)
    np.testing.assert_allclose(
        dense(y), np.bincount(dst, minlength=N).astype(np.float32) * np.linspace(1.0, 2.0, N).astype(np.float32),
        rtol=1e-6,
    )


CLOSED_OVER = (
    "compile", "loop_runner", "until_runner", "loop_runner_updated_before_first_call",
    "until_runner_updated_before_first_call", "until_runner_more_steps", "nested_until_more_steps",
    "sparse_loop_runner_updated_before_first_call",
)


def _closed_over_case(g, what):
    """(runner, the state of each call, update the operands) for one case of
    ``test_closed_over_operands_keep_their_first_calls_values``: a closed-over
    Vector ``k`` or Matrix ``M`` of small integers, state of halves."""
    k = g.Vector.from_dense(np.linspace(1.0, 2.0, 5).astype(np.float32))
    m = np.arange(25, dtype=np.float32).reshape(5, 5) % 4
    if what.startswith("sparse"):
        with g.tx.config.set(dense_limit=0):
            M = g.Matrix.from_coo(*np.nonzero(m), m[m != 0], g.dtm.FP32, nrows=5, ncols=5)
    else:
        M = g.Matrix.from_dense(m)
    x0 = g.Vector.from_dense(np.arange(5, dtype=np.float32))
    small = g.Vector.from_dense(np.arange(5, dtype=np.float32) / 64)  # exact: more steps to reach 1000

    def mxv(x):
        return M.mxv(x, g.semiring.plus_times).new(g.dtm.FP32)

    def below(x):
        return x.reduce(g.monoid.max).new() < 1000.0

    def update():
        k << k.apply(g.binary.times, right=3.0)
        M << M.apply(g.binary.times, right=3.0)

    if what == "compile":
        return g.gb.compile(lambda x: x.ewise_mult(k, g.binary.times).new(g.dtm.FP32)), [(x0,), (x0,)], update
    if what == "nested_until_more_steps":
        call = g.gb.compile(lambda x: g.gb.until(below, mxv, x, max_iters=20))
        return call, [(x0,), (small,)], update
    if "loop_runner" in what:
        return g.gb.loop_runner(2, mxv, x0), [(), ()], update
    call = g.gb.until_runner(below, mxv, x0, max_iters=20)
    return call, [(), (small,) if what.endswith("more_steps") else ()], update


@pytest.mark.parametrize("what", CLOSED_OVER)
def test_closed_over_operands_keep_their_first_calls_values(R, what):
    """A closed-over operand updated after a compiled function or runner
    was made leaves it reading the operand as the reference traced it: a
    runner at build (``loop_runner``/``until_runner`` trace there), a
    compiled function at its first call.  The port's warm step (a runner's
    build) or first call records what it read in a ``capture.Pin``; the
    card's graph replays the same tensors.  The cases update the operands
    after the first call, between build and first call, and before a call
    that takes more steps than the first (a runner, and an until nested in a
    compiled function).  Every call equals the reference's (products of
    exact small integers and halves: bit for bit), with ``M`` dense and in
    the sparse format."""

    def run(g):
        call, states, update = _closed_over_case(g, what)
        if what.endswith("before_first_call"):
            update()
        out = [dense(call(*states[0]))]
        steps = [getattr(call, "last_iters", None)]
        if not what.endswith("before_first_call"):
            update()
        out.append(dense(call(*states[1])))
        steps.append(getattr(call, "last_iters", None))
        return out, steps

    (p, p_steps), (r, _) = both(R, run)
    for a, b in zip(p, r):
        np.testing.assert_array_equal(a, b)
    if what.endswith("more_steps") and what.startswith("until"):
        assert p_steps[1] > p_steps[0]  # the second call ran steps the first did not


# ---------------------------------------------------------------------------
# the card: CUDA graphs against the same runners run eagerly
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the graphs run there)")


def _card_graph(n=2000, e=20000, seed=1):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = (rng.random(e) + 0.1).astype(np.float32)
    return src, dst, w, n


# the recipes the reference lowers to the edge layout (tests/test_looplayout.py)
EDGE_RECIPES = ("pagerank", "bfs_level_dense", "sssp")


def _recipes(dsl, AT, ATw):
    return {
        "pagerank": (dsl.pagerank_runner(AT, max_iters=10), lambda out: out),
        "bfs_level": (dsl.bfs_level_runner(AT, 0).runner, lambda out: out[0]),
        "bfs_level_dense": (dsl.bfs_level_dense_runner(AT, 0).runner, lambda out: out[0]),
        "sssp": (dsl.sssp_runner(ATw, 0).runner, lambda out: out[0]),
        "connected_components": (dsl.connected_components_runner(AT).runner, lambda out: out[0]),
    }


def _host(v, fill):
    return np.asarray(v.to_dense(fill_value=fill))


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,edge", [("plan", None), ("plan", "1"), ("generic", None)])
def test_cuda_recipes_graph_equals_eager(card, strategy, edge, monkeypatch):
    """Each recipe's graph against the same runner run eagerly on the card,
    across two replays: in the card's default lowering (the n space) and,
    with GRAPHBLAS_TPU_DSL_EDGE_LAYOUT=1, in the edge layout."""
    from graphblas_tpu_torch import kernels
    from graphblas_tpu_torch.models import dsl

    if edge is not None:
        monkeypatch.setenv("GRAPHBLAS_TPU_DSL_EDGE_LAYOUT", edge)
    src, dst, w, n = _card_graph()
    bad = []
    with P.tx.config.set(platform="cuda", mxv_strategy=strategy):
        with P.tx.config.set(dense_limit=0):  # the matrices sparse, the vectors dense
            AT = P.Matrix.from_coo(dst, src, np.float32(1.0), P.dtypes.FP32, nrows=n, ncols=n, dup_op=P.binary.plus)
            ATw = P.Matrix.from_coo(dst, src, w, P.dtypes.FP32, nrows=n, ncols=n, dup_op=P.binary.min)
        for name, (runner, pick) in _recipes(dsl, AT, ATw).items():
            if runner.layout != ("edge" if edge and name in EDGE_RECIPES else "n"):
                bad.append((name, "layout", runner.layout))
            if runner.capture != "graph":
                bad.append((name, "capture", runner.capture, runner.capture_reason))
                continue
            fill = -1 if name.startswith("bfs") else 0.0
            eager = _host(pick(runner.eager()), fill)
            kernels.reset_counts()
            first = _host(pick(runner()), fill)
            counts = kernels.launch_counts()
            second = _host(pick(runner()), fill)
            if name == "pagerank":
                # float sums: C's look-back (plan) or index_add_'s atomics
                # (generic) may add in another order from run to run
                ok = np.allclose(first, eager, rtol=1e-6, atol=0)
            else:
                ok = np.array_equal(first, eager)
            if not ok:
                bad.append((name, "graph != eager", float(np.max(np.abs(first - eager)))))
            if not np.array_equal(second, first) and not (name == "pagerank" and np.allclose(second, first, rtol=1e-6, atol=0)):
                bad.append((name, "second replay != first"))
            scan = "segscan" if name == "bfs_level" else "segscan_contrib"  # any_pair counts with the generic scan
            if strategy == "plan" and not counts.get(scan, 0):
                bad.append((name, "launches", counts))
    assert not bad, bad


@pytest.mark.cuda
def test_cuda_compile_replays_and_returns_clones(card):
    from graphblas_tpu_torch import kernels

    src, dst, _, n = _card_graph(seed=2)
    with P.tx.config.set(platform="cuda", mxv_strategy="plan"):
        with P.tx.config.set(dense_limit=0):
            AT = P.Matrix.from_coo(dst, src, np.float32(1.0), P.dtypes.FP32, nrows=n, ncols=n, dup_op=P.binary.plus)

        @P.compile
        def step(A, x):
            return A.mxv(x, P.semiring.plus_times).new(P.dtypes.FP32)

        x1 = P.Vector.from_dense(np.ones(n, np.float32))
        x2 = P.Vector.from_dense(np.arange(n, dtype=np.float32))
        kernels.reset_counts()
        a = step(AT, x1)
        b = step(AT, x2)
        assert len(step._cache) == 1 and next(iter(step._cache.values())).capture == "graph"
        # the warm step's launch, then one a replay (the capture launches nothing)
        assert kernels.launch_counts()["segscan_contrib"] == 3
        with P.tx.config.set(platform="cuda"):
            ea = AT.mxv(x1, P.semiring.plus_times).new(P.dtypes.FP32)
            eb = AT.mxv(x2, P.semiring.plus_times).new(P.dtypes.FP32)
        np.testing.assert_array_equal(_host(a, 0.0), _host(ea, 0.0))  # a survived the second replay
        np.testing.assert_allclose(_host(b, 0.0), _host(eb, 0.0), rtol=1e-6)


@pytest.mark.cuda
def test_cuda_graphs_keep_their_inputs_alive(card):
    """A graph captured on the matrix's plain plan replays right after a
    loop runner on the same matrix replaced that plan in its cache (the
    blocks of the old plan would otherwise go to the new one), and a
    closed-over operand updated after the capture leaves the graph reading
    the value it was captured with, as the reference's trace bakes it."""
    from graphblas_tpu_torch.models import dsl

    src, dst, _, n = _card_graph(seed=3)
    with P.tx.config.set(platform="cuda", mxv_strategy="plan"):
        with P.tx.config.set(dense_limit=0):
            AT = P.Matrix.from_coo(dst, src, np.float32(1.0), P.dtypes.FP32, nrows=n, ncols=n, dup_op=P.binary.plus)
        k = P.Vector.from_dense(np.linspace(1.0, 2.0, n).astype(np.float32))

        @P.compile
        def step(A, x):
            return A.mxv(x, P.semiring.plus_times).new(P.dtypes.FP32).ewise_mult(k, P.binary.times).new(P.dtypes.FP32)

        x = P.Vector.from_dense(np.arange(n, dtype=np.float32))
        first = _host(step(AT, x), 0.0)
        assert next(iter(step._cache.values())).capture == "graph"
        with P.tx.config.set(platform="cuda"):
            eager = _host(AT.mxv(x, P.semiring.plus_times).new(P.dtypes.FP32).ewise_mult(k, P.binary.times).new(), 0.0)
        np.testing.assert_allclose(first, eager, rtol=1e-6, atol=0)
        import os

        os.environ["GRAPHBLAS_TPU_DSL_EDGE_LAYOUT"] = "1"  # the loop plan replaces the plain one
        try:
            pr = dsl.pagerank_runner(AT, max_iters=5)
        finally:
            os.environ.pop("GRAPHBLAS_TPU_DSL_EDGE_LAYOUT")
        assert pr.layout == "edge"
        pr()
        again = _host(step(AT, x), 0.0)
        np.testing.assert_allclose(again, eager, rtol=1e-6, atol=0)
        k << k.apply(P.binary.times, right=3.0)  # the operand moves on; the graph keeps its capture
        torch.cuda.synchronize()
        np.testing.assert_allclose(_host(step(AT, x), 0.0), eager, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["loop_runner", "until_runner_more_steps"])
def test_cuda_runner_eager_equals_graph_after_an_operand_update(card, what):
    """On the card a runner's graph and ``runner.eager()`` both read the
    closed-over operands as the build's warm step read them: the operands
    are updated after the capture, and eager() is first called after that."""
    g = ns(P)
    with P.tx.config.set(platform="cuda"):
        call, states, update = _closed_over_case(g, what)
        first = dense(call(*states[0]))
        assert call.capture == "graph"
        update()
        graph = dense(call(*states[1]))
        eager = dense(call.eager(*states[1]))
    with P.tx.config.set(platform="cpu"):
        call, states, update = _closed_over_case(g, what)
        cpu = [dense(call(*states[0]))]
        update()
        cpu.append(dense(call(*states[1])))
    np.testing.assert_array_equal(first, cpu[0])
    np.testing.assert_array_equal(graph, cpu[1])
    np.testing.assert_array_equal(eager, cpu[1])
