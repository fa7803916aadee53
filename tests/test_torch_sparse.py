"""Parity of the port's sparse format (``Matrix`` past ``tx.config
["dense_limit"]``) with the JAX package's, case for case with
``tests/test_sparse.py``, ``test_sparse_more.py`` and the parts of
``test_tx_sparse.py`` that are not ``tx``.

Each case builds the same collections in both packages from seeded numpy COO
arrays, forcing the sparse format where the reference's test forces it
(``tx.config.set(dense_limit=0)`` on both packages' own config; 2^40
dimensions are sparse without it), runs the same statements on both, and
compares the results through ``to_coo()`` (``test_torch_collections``'s
helpers): indices and integer and bool values exactly, floats within 1e-6
relative (1e-5 where the plan channel or a brick matmul sums in another
order than the reference, named in the case).  The port runs on the CPU, so
its kernels' plain versions run; the reference's Pallas kernels run as its
own tests run them there.
"""

import numpy as np
import pytest
from test_torch_collections import assert_same, ns

import graphblas_tpu_torch as P

HUGE = 1 << 40


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import graphblas_tpu as R

    return R


@pytest.fixture(autouse=True)
def pinned(request):
    """The port on the CPU; mapnumpy on in both (the reference's harness draws it)."""
    if "ref" not in request.fixturenames:
        with P.tx.config.set(platform="cpu"):
            yield
        return
    R = request.getfixturevalue("ref")
    old = (R.config["mapnumpy"], P.config["mapnumpy"])
    R.config["mapnumpy"] = P.config["mapnumpy"] = True
    try:
        with P.tx.config.set(platform="cpu"):
            yield
    finally:
        R.config["mapnumpy"], P.config["mapnumpy"] = old


def sparse_ns(pkg):
    """The package's namespace, with ``sp()``: the sparse format forced."""
    g = ns(pkg)
    g.sp = lambda **kw: pkg.tx.config.set(dense_limit=0, **kw)
    g.cfg = pkg.tx.config.set
    g.exc = pkg.exceptions
    return g


def is_sparse(x):
    return getattr(x, "_sparse", None) is not None


def compare(p, r, label="", rtol=1e-6):
    """A port result against the reference's: collections through to_coo(),
    containers item by item, everything else by ==."""
    if isinstance(r, (list, tuple)):
        assert isinstance(p, (list, tuple)) and len(p) == len(r), label
        for i, (a, b) in enumerate(zip(p, r)):
            compare(a, b, f"{label}[{i}]", rtol)
    elif isinstance(r, np.ndarray):
        assert p.dtype == r.dtype, label
        if r.dtype.kind == "f":
            np.testing.assert_allclose(p, r, rtol=rtol, err_msg=label)
        else:
            np.testing.assert_array_equal(p, r, err_msg=label)
    elif hasattr(r, "to_coo") or type(r).__name__ == "Scalar":
        assert_same(p, r, label, rtol=rtol)
        if hasattr(r, "_sparse"):
            assert is_sparse(p) == is_sparse(r), (label, "storage format")
    elif isinstance(r, float):
        assert p == pytest.approx(r, rel=rtol), label
    else:
        assert p == r, (label, p, r)


def run_both(ref, fn, rtol=1e-6):
    compare(fn(sparse_ns(P)), fn(sparse_ns(ref)), fn.__name__, rtol)


def graph(seed=3, n=45, e=260):
    rng = np.random.default_rng(seed)
    return n, rng.integers(0, n, e), rng.integers(0, n, e), rng.random(e)


def pair(g, r, c, v, n, dtype=None):
    """The same matrix dense and in the sparse format."""
    dense = g.Matrix.from_coo(r, c, v, dtype, nrows=n, ncols=n, dup_op=g.binary.plus)
    with g.sp():
        sparse = g.Matrix.from_coo(r, c, v, dtype, nrows=n, ncols=n, dup_op=g.binary.plus)
    assert is_sparse(sparse) and not is_sparse(dense)
    return dense, sparse


def coo_vector(g, n, seed, frac=0.75, dtype=None):
    rng = np.random.default_rng(seed)
    xs = rng.random(n) < frac
    return g.Vector.from_coo(np.flatnonzero(xs), rng.random(int(xs.sum())), dtype, size=n)


# ---------------------------------------------------------------------------
# the cases: each runs on one package's namespace and returns its results
# ---------------------------------------------------------------------------


def construction_and_exports(g):
    n, r, c, v = graph()
    Ad, As = pair(g, r, c, v, n)
    out = [As, Ad.nvals == As.nvals, As.to_dicts() == Ad.to_dicts()]
    for meth in ("to_csr", "to_csc", "to_dcsr", "to_dcsc"):
        out += [list(getattr(As, meth)())]
    out += [(int(r[0]), int(c[0])) in As, As.get(int(r[0]), int(c[0])), As.get(0, 0, default=-1)]
    return out + [As.to_edgelist()[0], repr(As)]


def mxv_vxm(srname):
    def case(g):
        n, r, c, v = graph()
        Ad, As = pair(g, r, c, v, n)
        x = coo_vector(g, n, 4)
        sr = getattr(g.semiring, srname)
        return [A.mxv(x, sr).new() for A in (As, As.T)] + [x.vxm(A, sr).new() for A in (As, As.T)]

    case.__name__ = f"mxv_vxm_{srname}"
    return case


def mxv_masked_update(g):
    n, r, c, v = graph()
    _, As = pair(g, r, c, v, n)
    rng = np.random.default_rng(5)
    x = g.Vector.from_dense(rng.random(n))
    m = g.Vector.from_coo(np.flatnonzero(rng.random(n) < 0.5), True, size=n)
    out = g.Vector(g.dtypes.FP64, n)
    out(m.S) << As.mxv(x, g.semiring.plus_times)
    first = out.dup()
    out(m.S, g.binary.plus) << As.mxv(x, g.semiring.min_plus)
    return [first, out]


def plan_vs_generic(srname):
    """mxv and vxm of an FP32 matrix on the plan channel and on the generic
    path, in both packages (float plus within 1e-5: the plan's scans sum in
    another order than the segment sum)."""

    def case(g):
        n, r, c, v = graph()
        with g.sp():
            As = g.Matrix.from_coo(r, c, v.astype(np.float32), g.dtypes.FP32, nrows=n, ncols=n, dup_op=g.binary.plus)
        x = coo_vector(g, n, 6, 0.7, g.dtypes.FP32)
        sr = getattr(g.semiring, srname)
        out = []
        for strategy in ("generic", "plan"):
            with g.cfg(mxv_strategy=strategy):
                ys = [As.mxv(x, sr).new(), x.vxm(As, sr).new()]
            # 'any' may pick different members: its pattern only
            out += [y.apply(g.unary.one).new() if srname == "any_secondi" else y for y in ys]
        return out

    case.__name__ = f"plan_vs_generic_{srname}"
    return case


def reduce(g):
    n, r, c, v = graph()
    _, As = pair(g, r, c, v, n)
    out = []
    for op in ("plus", "min", "max", "times"):
        out += [As.reduce_rowwise(op).new(), As.reduce_columnwise(op).new(), As.reduce_scalar(op).new()]
        out += [As.T.reduce_rowwise(op).new()]
    return out


def apply_select_transpose(g):
    n, r, c, v = graph()
    _, As = pair(g, r, c, v, n)
    exprs = [
        lambda A: A.apply(g.unary.sqrt),
        lambda A: A.apply(g.binary.plus, right=2.5),
        lambda A: A.apply(g.binary.minus, left=10.0),
        lambda A: A.apply(g.indexunary.rowindex),
        lambda A: A.apply(g.indexunary.colindex, 3),
        lambda A: A.select("value > 0.6"),
        lambda A: A.select("triu"),
        lambda A: A.select("tril", -1),
    ]
    return [e(As).new() for e in exprs] + [As.T.new()]


def dup_resize_clear_diag(g):
    n, r, c, v = graph()
    Ad, As = pair(g, r, c, v, n)
    d = As.dup()
    As2 = As.dup()
    As2.resize(20, 30)
    before = As2.dup()
    As2.clear()
    return [d, d.isequal(As), before, As2, As2.shape, As.diag(1), As.diag(-2), As.dup(g.dtypes.INT64)]


def huge_dimensions(g):
    H = g.Matrix.from_coo([0, HUGE - 1, 12345], [HUGE - 1, 0, 12345], [1.0, 2.0, 3.5], nrows=HUGE, ncols=HUGE)
    out = [H, H.nvals, H.shape, H.get(12345, 12345), H.select("value > 1.5").new(), H.T.new()]
    out += [H.T.new().get(HUGE - 1, 0), H.reduce_scalar("plus").new(), H.apply(g.unary.ainv).new()]
    with pytest.raises(g.exc.OutOfMemory):
        H._values  # noqa: B018
    return out


def dup_combination(g):
    r, c, v = np.array([0, 0, 1, 0]), np.array([1, 1, 2, 1]), np.array([1.0, 2.0, 5.0, 4.0])
    with g.sp():
        out = [g.Matrix.from_coo(r, c, v, nrows=3, ncols=3, dup_op=op) for op in (g.binary.plus, g.binary.max, g.binary.first, g.binary.second, g.binary.times)]
        with pytest.raises(ValueError, match="[Dd]uplicate"):
            g.Matrix.from_coo(r, c, v, nrows=3, ncols=3)
    return out


def pagerank_dsl(g):
    """The DSL PageRank over the sparse matrix, against the same statements
    over the dense one (and, across the packages, the reference's)."""
    rng = np.random.default_rng(8)
    n, e = 60, 400
    r, c = rng.integers(0, n, e), rng.integers(0, n, e)
    dense = g.Matrix.from_coo(r, c, 1.0, nrows=n, ncols=n, dup_op=g.binary.first)
    with g.sp():
        sparse = g.Matrix.from_coo(r, c, 1.0, nrows=n, ncols=n, dup_op=g.binary.first)

    def pagerank(A, iters=15, damping=0.85):
        outdeg = A.reduce_rowwise("plus").new(g.dtypes.FP64)
        rank = g.Vector.from_dense(np.full(n, 1.0 / n))
        contrib = g.Vector(g.dtypes.FP64, n)
        for _ in range(iters):
            contrib << rank.ewise_mult(outdeg.apply(g.unary.minv), g.binary.times)
            pulled = contrib.vxm(A, g.semiring.plus_first).new()
            dangling = float(rank.reduce("plus").new().value) - float(
                contrib.ewise_mult(outdeg, g.binary.times).reduce("plus").new().value
            )
            rank << pulled.apply(g.binary.times, right=damping).apply(
                g.binary.plus, right=(1.0 - damping) / n + damping * dangling / n
            )
        return rank

    rd, rs = pagerank(dense), pagerank(sparse)
    np.testing.assert_allclose(rs.to_dense(0.0), rd.to_dense(0.0), rtol=1e-9)
    return [rs]


def masked_spgemm_vs_dense(g):
    rng = np.random.default_rng(9)
    n, e = 40, 250
    r1, c1, r2, c2 = (rng.integers(0, n, e) for _ in range(4))
    mr, mc = rng.integers(0, n, 120), rng.integers(0, n, 120)
    v1, v2 = rng.random(e), rng.random(e)
    Md = g.Matrix.from_coo(mr, mc, True, nrows=n, ncols=n, dup_op=g.binary.lor)
    Mv = g.Matrix.from_coo(mr, mc, rng.integers(0, 2, 120).astype(bool), nrows=n, ncols=n, dup_op=g.binary.lor)
    with g.sp():
        As = g.Matrix.from_coo(r1, c1, v1, nrows=n, ncols=n, dup_op=g.binary.plus)
        Bs = g.Matrix.from_coo(r2, c2, v2, nrows=n, ncols=n, dup_op=g.binary.plus)
    out = []
    for srname in ("plus_times", "min_plus", "plus_pair", "max_first"):
        sr = getattr(g.semiring, srname)
        got = g.Matrix(sr[g.dtypes.FP64].return_type, n, n)
        got(Md.S) << As.mxm(Bs, sr)
        want = As.dup().mxm(Bs, sr).new(mask=Md.S)
        out += [got, want]
    got = g.Matrix(g.dtypes.FP64, n, n)
    got(Mv.V) << As.mxm(Bs.T, g.semiring.plus_times)
    return out + [got]


def masked_spgemm_triangle_count(g):
    import networkx as nx

    G = nx.gnm_random_graph(60, 300, seed=7)
    edges = np.array(G.edges())
    r = np.concatenate([edges[:, 0], edges[:, 1]])
    c = np.concatenate([edges[:, 1], edges[:, 0]])
    with g.sp():
        A = g.Matrix.from_coo(r, c, 1.0, nrows=60, ncols=60, dup_op=g.binary.first)
    L = A.select("tril", -1).new()
    C = g.Matrix(g.dtypes.FP64, 60, 60)
    C(L.S) << L.mxm(L.T.new(), g.semiring.plus_pair)
    tc = int(float(C.reduce_scalar("plus").new().value))
    assert tc == sum(nx.triangles(G).values()) // 3
    return [C, tc]


def masked_spgemm_hub_splitting(g):
    n = 2 * 256 + 13  # past the segment width cap of 256: chunk-pair tasks
    rows, cols = np.arange(n - 1), np.full(n - 1, n - 1)
    with g.sp():
        A = g.Matrix.from_coo(rows, cols, 1.0, nrows=n, ncols=n)
        B = g.Matrix.from_coo(cols, rows, 2.0, nrows=n, ncols=n)
        AB = g.Matrix.from_coo(rows, rows, 2.0, nrows=n, ncols=n)
    M = g.Matrix.from_coo([0, 1, 5], [3, 4, 5], True, nrows=n, ncols=n)
    got = g.Matrix(g.dtypes.FP64, n, n)
    got(M.S) << A.mxm(B, g.semiring.plus_times)
    got2 = g.Matrix(g.dtypes.FP64, n, n)
    got2(AB.S) << A.mxm(B, g.semiring.min_plus)
    return [got, got2]


def _clustered(g, seed, vals=None, n=256, csize=64):
    """L, U = L^T of a graph of cliques of 64 plus random edges: dense
    128 x 128 bricks (the brick path of the FP32 plus_pair / plus_times SpGEMM)."""
    rng = np.random.default_rng(seed)
    base = np.arange(n) - (np.arange(n) % csize)
    rs = np.concatenate([np.tile(np.arange(n), csize - 1), rng.integers(0, n, 2 * n)])
    cs = np.concatenate([np.concatenate([base + (np.arange(n) + d) % csize for d in range(1, csize)]), rng.integers(0, n, 2 * n)])
    lo, hi = np.minimum(rs, cs), np.maximum(rs, cs)
    keep = lo != hi
    v = (rng.random(keep.sum()) + 0.5).astype(np.float32) if vals is None else np.float32(vals)
    with g.sp():
        L = g.Matrix.from_coo(hi[keep], lo[keep], v, g.dtypes.FP32, nrows=n, ncols=n, dup_op=g.binary.first)
        U = L.T.new()
    return L, U


def masked_spgemm_bricks_and_net(g):
    """C(L.S) << L.mxm(U) in FP32: plus_pair and plus_times run the bricks and
    the reduce net, min_plus and max_first the net alone, INT64 the scatter
    combine (plus_times within 1e-5: the bricks sum in another order)."""
    L, U = _clustered(g, 10)
    out = []
    for srname in ("plus_pair", "plus_times", "min_plus", "max_first"):
        C = g.Matrix(g.dtypes.FP32, L.nrows, L.ncols)
        C(L.S) << L.mxm(U, getattr(g.semiring, srname)[g.dtypes.FP32])
        out.append(C)
    C = g.Matrix(g.dtypes.INT64, L.nrows, L.ncols)
    C(L.S) << L.mxm(U, g.semiring.plus_pair[g.dtypes.INT64])
    return out + [C]


def spgemm_engine_plans(g):
    """sparse_spgemm_analyze / execute on both packages: without bricks,
    with bricks at a 512-entry threshold, with the reduce net, with both; the
    rows, cols, values and flops of each execute (values within 1e-5: the
    bricks and the net sum in other orders); a brick plan rejects min_plus."""
    from importlib import import_module

    sps = import_module(g.gb.__name__ + ".core.sparse")
    get_typed_op = import_module(g.gb.__name__ + ".core.operator").get_typed_op
    L, U = _clustered(g, 11)
    lsp, usp = L._sparse, U._sparse
    dev = {"device": "cpu"} if g.gb is P else {}
    out = []
    for srname in ("plus_pair", "plus_times"):
        sr = get_typed_op(getattr(g.semiring, srname), g.dtypes.FP32, g.dtypes.FP32, kind="semiring")
        for kw in ({}, {"bricks": True, "brick_thresh": 512}, {"reduce_net": True}, {"bricks": True, "brick_thresh": 512, "reduce_net": True}):
            plan = sps.sparse_spgemm_analyze(lsp, usp, lsp.rows, lsp.cols, **kw, **dev)
            out.append(list(sps.sparse_spgemm_execute(plan, sr, g.dtypes.FP32)))
    plan = sps.sparse_spgemm_analyze(lsp, usp, lsp.rows, lsp.cols, bricks=True, brick_thresh=512, **dev)
    assert plan.brick is not None
    with pytest.raises(ValueError):
        sps.sparse_spgemm_execute(plan, get_typed_op(g.semiring.min_plus, g.dtypes.FP32, g.dtypes.FP32, kind="semiring"), g.dtypes.FP32)
    return out


def ewise_huge_dims(g):
    n = HUGE
    A = g.Matrix.from_coo([0, 10, n - 1], [5, n - 2, 3], [1.0, 2.0, 3.0], g.dtypes.FP32, nrows=n, ncols=n)
    B = g.Matrix.from_coo([0, 10, 7], [5, 4, 3], [10.0, 20.0, 30.0], g.dtypes.FP32, nrows=n, ncols=n)
    out = [A.ewise_mult(B, g.binary.plus).new(), A.ewise_add(B, g.binary.plus).new()]
    out += [A.ewise_union(B, g.binary.minus, 100.0, 200.0).new(), A.T.ewise_mult(B.T, g.binary.times).new()]
    out += [A.apply("ainv").new(), A.select("value>", 1.5).new(), A.reduce_scalar().new(), A.isequal(A.dup())]
    return out


def ewise_vs_dense(g):
    rng = np.random.default_rng(12)
    n = 24
    r1, c1, r2, c2 = (rng.integers(0, n, 40) for _ in range(4))
    v1, v2 = rng.random(40), rng.random(40)
    with g.sp():
        S1 = g.Matrix.from_coo(r1, c1, v1, g.dtypes.FP64, nrows=n, ncols=n, dup_op="plus")
        S2 = g.Matrix.from_coo(r2, c2, v2, g.dtypes.FP64, nrows=n, ncols=n, dup_op="plus")
    D1 = g.Matrix.from_coo(*S1.to_coo(), g.dtypes.FP64, nrows=n, ncols=n)
    D2 = g.Matrix.from_coo(*S2.to_coo(), g.dtypes.FP64, nrows=n, ncols=n)
    out = []
    for a, b in ((S1, S2), (D1, D2)):
        out += [a.ewise_mult(b, g.binary.times).new(), a.ewise_add(b, g.binary.max).new()]
        out += [a.ewise_union(b, g.binary.minus, 5.0, 7.0).new()]
    for i in range(3):
        assert out[i].to_dicts() == out[i + 3].to_dicts()
    return out


def ewise_int_exact(g):
    rng = np.random.default_rng(13)
    n = 40
    r1, c1, r2, c2 = (rng.integers(0, n, 60) for _ in range(4))
    v1, v2 = rng.integers(-100, 100, 60), rng.integers(-100, 100, 60)
    out = []
    for dt in (g.dtypes.INT64, g.dtypes.INT8, g.dtypes.UINT16):
        with g.sp():
            S1 = g.Matrix.from_coo(r1, c1, v1, dt, nrows=n, ncols=n, dup_op="plus")
            S2 = g.Matrix.from_coo(r2, c2, v2, dt, nrows=n, ncols=n, dup_op="plus")
        out += [S1.ewise_add(S2, g.binary.minus).new(), S1.ewise_mult(S2, g.binary.times).new()]
        out += [S1.ewise_union(S2, g.binary.max, 3, -3).new()]
    return out


def reduce_and_apply_int(g):
    rng = np.random.default_rng(14)
    n = 30
    r1, c1 = rng.integers(0, n, 50), rng.integers(0, n, 50)
    v1 = rng.integers(1, 50, 50)
    with g.sp():
        S = g.Matrix.from_coo(r1, c1, v1, g.dtypes.INT64, nrows=n, ncols=n, dup_op="max")
        B = g.Matrix.from_coo(r1, c1, v1 % 2 == 0, g.dtypes.BOOL, nrows=n, ncols=n, dup_op="lor")
    out = [S.reduce_scalar("plus").new(), S.reduce_scalar("max").new(), S.apply(g.binary.times, right=2).new()]
    out += [S.reduce_rowwise(g.monoid.times).new(), S.reduce_columnwise(g.monoid.min).new()]
    out += [B.reduce_rowwise(g.monoid.lor).new(), B.reduce_columnwise(g.monoid.land).new(), B.reduce_scalar(g.monoid.plus).new()]
    return out


def select_tril_triu_diag_huge(g):
    A = g.Matrix.from_coo([2, 5, 9], [5, 2, 9], [1.0, 2.0, 3.0], g.dtypes.FP64, nrows=HUGE, ncols=HUGE)
    D = g.Matrix.from_coo([0, 3, 7], [0, 3, 8], [1.0, 2.0, 3.0], g.dtypes.FP64, nrows=HUGE, ncols=HUGE)
    return [A.select("tril").new(), A.select("triu").new(), D.select("diag").new(), D.diag(1)]


def assign_row_then_mxv(g):
    """Assign into sparse storage, then the mxv engine on the new pattern."""
    with g.sp(mxv_strategy="generic"):
        A = g.Matrix.from_coo([0, 1], [1, 2], [1.0, 1.0], g.dtypes.FP32, nrows=4, ncols=4)
        x = g.Vector.from_dense(np.ones(4, np.float32))
        y0 = A.mxv(x, g.semiring.plus_times).new()
        A[0, 3] = 5.0
        return [y0, A.mxv(x, g.semiring.plus_times).new(), A]


def apply_after_delete(g):
    A = g.Matrix.from_coo([0, 5], [1, 2], [4.0, 9.0], g.dtypes.FP64, nrows=HUGE, ncols=HUGE)
    del A[0, 1]
    return [A, A.apply(g.unary.sqrt).new()]


def extract_after_transpose_view(g):
    A = g.Matrix.from_coo([1, 2], [5, 7], [1.0, 2.0], g.dtypes.FP64, nrows=HUGE, ncols=HUGE)
    x = g.Vector.from_coo([1, 2], [10.0, 20.0], g.dtypes.FP64, size=HUGE)
    return [A.T.mxv(x, g.semiring.plus_times).new(), A.T[5, :].new(), A[[1, 2], [5, 7, 7]].new()]


def limits_and_guards(g):
    """spgemm_flop_limit, the iso from_scalar guard, densify past
    densify_limit: OutOfMemory in both."""
    out = [g.gb.tx.config.get("spgemm_flop_limit")]
    with g.cfg(spgemm_flop_limit=64):
        out.append(g.gb.tx.config.get("spgemm_flop_limit"))
    with pytest.raises(g.exc.OutOfMemory, match="iso"):
        g.Matrix.from_scalar(1.0, 1 << 30, 1 << 30)
    out.append(g.Matrix.from_scalar(2.5, 3, 4))
    with g.sp():
        A = g.Matrix.from_coo([0, 9], [9, 0], [1.0, 2.0], nrows=10, ncols=10)
    with g.cfg(densify_limit=50), pytest.raises(g.exc.OutOfMemory, match="densify"):
        A.kronecker(A, g.binary.times).new()
    return out


def vxm_int_channel_matches_generic(g):
    rng = np.random.default_rng(11)
    n = 100
    src, dst = rng.integers(0, n, 400), rng.integers(0, n, 400)
    vals = rng.integers(-50, 50, 400).astype(np.int32)
    xv = rng.integers(-50, 50, n).astype(np.int32)
    out = []
    for strat in ("plan", "generic"):
        with g.sp(mxv_strategy=strat):
            A = g.Matrix.from_coo(src, dst, vals, g.dtypes.INT32, nrows=n, ncols=n, dup_op=g.binary.plus)
        x = g.Vector.from_dense(xv, dtype=g.dtypes.INT32)
        with g.cfg(mxv_strategy=strat):
            out += [x.vxm(A, g.semiring.min_plus).new(), x.vxm(A, g.semiring.plus_times).new()]
    return out


def unmasked_mxm(g):
    """C = A.mxm(B) on sparse operands: the sparse output of the host
    expand-join (transposed operands and a positional semiring too); past
    spgemm_flop_limit it raises."""
    rng = np.random.default_rng(15)
    n = 30
    r1, c1, r2, c2 = (rng.integers(0, n, 90) for _ in range(4))
    with g.sp():
        A = g.Matrix.from_coo(r1, c1, rng.random(90), nrows=n, ncols=n, dup_op="plus")
        B = g.Matrix.from_coo(r2, c2, rng.integers(1, 9, 90), g.dtypes.INT64, nrows=n, ncols=n, dup_op="plus")
    out = [A.mxm(B, sr).new() for sr in (g.semiring.plus_times, g.semiring.min_plus, g.semiring.max_first, g.semiring.any_secondi)]
    out += [B.mxm(B, g.semiring.plus_times).new(), A.T.mxm(B.T, g.semiring.plus_times).new(), A.mxm(B.T, g.semiring.min_firstj).new()]
    with g.cfg(spgemm_flop_limit=10), pytest.raises(g.exc.OutOfMemory, match="spgemm_flop_limit"):
        A.mxm(B, g.semiring.plus_times).new()
    H = g.Matrix.from_coo([0, 7, HUGE - 1], [7, HUGE - 1, 3], [2.0, 3.0, 4.0], nrows=HUGE, ncols=HUGE)
    return out + [H.mxm(H, g.semiring.plus_times).new()]


def tx_pairs_and_iso(g):
    """The non-tx parts of test_tx_sparse.py: a dense and a sparse copy of the
    same data agree; iso values show in the repr's format column."""
    rng = np.random.default_rng(0)
    n, e = 20, 60
    r, c, v = rng.integers(0, n, e), rng.integers(0, n, e), rng.random(e).round(3)
    dense, sp = pair(g, r, c, v, n)
    iso = g.Matrix.from_coo([0, HUGE - 1], [1, 2], 3.0, nrows=HUGE, ncols=HUGE)
    return [sp, dense.isequal(sp), sp.isequal(dense), repr(iso).splitlines()[1], repr(sp).splitlines()[1]]


def set_storage(g):
    """The in-place conversion between the formats (the reference's
    ``_set_storage``, which its ``tx`` config drives)."""
    n, r, c, v = graph()
    A, As = pair(g, r, c, v, n)
    x = coo_vector(g, n, 4)
    A._set_storage("coo")
    x._set_storage("sparse")
    out = [A, x, is_sparse(A), is_sparse(x)]
    As._set_storage("densemasked")
    x._set_storage("auto")
    out += [As, x, is_sparse(As), is_sparse(x)]
    with pytest.raises(ValueError, match="storage format"):
        A._set_storage("csr")
    return out


CASES = [
    construction_and_exports,
    set_storage,
    *(mxv_vxm(s) for s in ("plus_times", "min_plus", "max_second", "plus_first", "any_pair", "min_secondi")),
    mxv_masked_update,
    *(plan_vs_generic(s) for s in ("plus_times", "min_plus", "max_first", "plus_second", "plus_pair", "any_secondi")),
    reduce,
    apply_select_transpose,
    dup_resize_clear_diag,
    huge_dimensions,
    dup_combination,
    pagerank_dsl,
    masked_spgemm_vs_dense,
    masked_spgemm_triangle_count,
    masked_spgemm_hub_splitting,
    masked_spgemm_bricks_and_net,
    spgemm_engine_plans,
    ewise_huge_dims,
    ewise_vs_dense,
    ewise_int_exact,
    reduce_and_apply_int,
    select_tril_triu_diag_huge,
    assign_row_then_mxv,
    apply_after_delete,
    extract_after_transpose_view,
    limits_and_guards,
    vxm_int_channel_matches_generic,
    unmasked_mxm,
    tx_pairs_and_iso,
]
# float sums in another order than the reference's: the plan channel's scans,
# the bricks' matmuls
RTOL = {"plan_vs_generic_plus_times": 1e-5, "plan_vs_generic_plus_second": 1e-5, "masked_spgemm_bricks_and_net": 1e-5, "spgemm_engine_plans": 1e-5}


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_sparse_matrix_statement_matches_reference(ref, case):
    run_both(ref, case, RTOL.get(case.__name__, 1e-6))


def test_sparse_results_stay_sparse_and_on_their_device():
    """A sparse operand gives a sparse result (apply, select, ewise, T, the
    masked SpGEMM), on the operand's device, and .nvals is the host length."""
    with P.tx.config.set(dense_limit=0):
        A = P.Matrix.from_coo([0, 1, 2], [1, 2, 0], [1.0, 2.0, 3.0], nrows=3, ncols=3)
    assert A._device == torch_device("cpu") and A.nvals == 3
    outs = [A.apply(P.unary.ainv).new(), A.select("tril").new(), A.ewise_add(A.T).new(), A.T.new()]
    with P.tx.config.set(dense_limit=0):
        C = P.Matrix(P.dtypes.FP64, 3, 3)
    C(A.S) << A.mxm(A, P.semiring.plus_times)
    for x in outs + [C]:
        assert x._sparse is not None and x._device == A._device


def torch_device(name):
    import torch

    return torch.device(name)


def test_shared_arrays_keep_their_values_after_updates(ref):
    """A dup() and a mask of a sparse matrix share its host indices (and their
    device caches); every update installs new arrays, so what was shared keeps
    its values, and everything equals the reference after the same
    statements (test_torch_collections' test of the dense format, sparse)."""
    rng = np.random.default_rng(17)
    r, c = rng.integers(0, 6, 20), rng.integers(0, 6, 20)
    v = rng.integers(-9, 9, 20)

    def run(g):
        with g.sp():
            A = g.Matrix.from_coo(r, c, v, g.dtypes.INT64, nrows=6, ncols=6, dup_op=g.binary.plus, name="A")
            B = g.Matrix.from_coo(c, r, v, g.dtypes.INT64, nrows=6, ncols=6, dup_op=g.binary.plus, name="B")
            D = A.dup()
            M = A.dup(g.dtypes.BOOL)
            S = A.S
            early = A.apply(g.unary.ainv).new()
            A[0, 1] = 99
            A(accum=g.binary.plus)[1:3, :] = 5
            del A[2, 2]
            A << A.ewise_add(B, g.binary.times)
            C = g.Matrix(g.dtypes.INT64, 6, 6)
            C(S) << B.mxm(B, g.semiring.plus_times)
            return [A, D, M, early, C, B]

    with P.tx.config.set(dense_limit=0):
        A0 = P.Matrix.from_coo(r, c, v, P.dtypes.INT64, nrows=6, ncols=6, dup_op=P.binary.plus)
    held = A0._sparse
    kept = [a.copy() for a in (held.rows, held.cols, held.vals)]
    A0[0, 1] = 99
    del A0[held.rows[0], held.cols[0]]
    for a, b in zip((held.rows, held.cols, held.vals), kept):
        np.testing.assert_array_equal(a, b)
    compare(run(sparse_ns(P)), run(sparse_ns(ref)), "shared")


def test_segment_min_max_follow_jax_on_nan_and_signed_zeros(ref):
    """reduce_rowwise min/max over sparse storage: a row holding a NaN is NaN
    and a tie of zeros is -0.0 for min, +0.0 for max, as jax.ops.segment_min
    and segment_max give, bit for bit."""
    rows = np.array([0, 0, 1, 1, 2, 2, 3])
    cols = np.array([0, 1, 0, 1, 0, 1, 0])
    vals = np.array([1.0, np.nan, 0.0, -0.0, -0.0, 0.0, -0.0])

    def run(g):
        with g.sp():
            A = g.Matrix.from_coo(rows, cols, vals, g.dtypes.FP64, nrows=5, ncols=2)
        return [A.reduce_rowwise(m).new() for m in (g.monoid.min, g.monoid.max)] + [A.T.reduce_columnwise(g.monoid.min).new()]

    for p, r in zip(run(sparse_ns(P)), run(sparse_ns(ref))):
        np.testing.assert_array_equal(p.to_coo()[0], r.to_coo()[0])
        np.testing.assert_array_equal(p.to_coo()[1].view(np.int64), r.to_coo()[1].view(np.int64))


def test_queue_4_left_outs_name_their_queue():
    """The mesh branches came later, with queue 8: _mesh_context() is the
    engaged parallel.Context, None outside one, and the module's docstring
    names the mesh routes.  (The other left-out, the edge-layout loop body,
    came with the compiled loops and has since been deleted.)"""
    from graphblas_tpu_torch.core import collection_ops

    assert collection_ops._mesh_context() is None
    with P.parallel.Context() as ctx:
        assert collection_ops._mesh_context() is ctx
    assert collection_ops._mesh_context() is None
    assert "engaged mesh Context" in collection_ops.__doc__


def test_transposed_view_runs_its_parents_plan():
    """A.T.mxv(x) and A.T.mxm(B) over a sparse A run on A itself: the mxv on
    the push direction of A's own plan (built once, kept on A), with no
    transposed copy; the results equal those of the materialized transpose."""
    rng = np.random.default_rng(21)
    r, c, v = rng.integers(0, 30, 120), rng.integers(0, 30, 120), rng.random(120).astype(np.float32)
    with P.tx.config.set(dense_limit=0):
        A = P.Matrix.from_coo(r, c, v, P.dtypes.FP32, nrows=30, ncols=30, dup_op=P.binary.plus)
    x = P.Vector.from_dense(rng.random(30).astype(np.float32))
    with P.tx.config.set(mxv_strategy="plan"):
        y = A.T.mxv(x, P.semiring.plus_times).new()
        assert A._sparse.plan_ready("push", "cpu") and not A._sparse.plan_ready("pull", "cpu")
        plan = A._sparse.plan("push", "cpu")
        A.T.mxv(x, P.semiring.min_plus).new()
        assert A._sparse.plan("push", "cpu") is plan
        want = A.T.new().mxv(x, P.semiring.plus_times).new()
    assert y.isclose(want, rel_tol=1e-5)  # the plan's scan sums in another order
    assert A.T.mxm(A, P.semiring.plus_times).new().isclose(A.T.new().mxm(A, P.semiring.plus_times).new(), rel_tol=1e-6)


@pytest.mark.parametrize("dim", [45, 1 << 40, 1 << 62])
def test_sort_order_is_lexsorts(dim):
    """The canonical COO order: one int64 key where every key fits, else the
    lexsort; the same stable permutation either way."""
    from graphblas_tpu_torch.core.sparse import _sort_order

    rng = np.random.default_rng(dim % 1000)
    r, c = rng.integers(0, dim, 3000), rng.integers(0, min(dim, 50), 3000)
    np.testing.assert_array_equal(_sort_order(r, c, dim), np.lexsort((c, r)))
