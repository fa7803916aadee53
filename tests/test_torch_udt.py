"""Parity of the port's user-defined-type (UDT) collections with the JAX
package's, case for case with ``tests/test_udt.py``.

A UDT collection keeps its values as a dict of field tensors (struct of
arrays), each field in its type's carrier (``core.dtypes``).  Each case runs
the same statements on the same inputs through both packages on the CPU and
compares what comes out: indices, structures and every field exactly (the
fields' sums and products here are of small integers and halves), and the
port's result also meets the reference test's own asserts.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import graphblas_tpu_torch as P

HUGE = 1 << 30


@pytest.fixture(scope="module")
def R():
    pytest.importorskip("jax")
    import graphblas_tpu as R

    return R


@pytest.fixture(autouse=True)
def _pinned():
    with P.tx.config.set(platform="cpu"):
        yield


def _point(pkg):
    """The point type under the reference test's own name and logic
    (``tests/test_udt.py``'s ``Point`` fixture), so that whichever file
    registers it first in a process, the other finds it."""
    try:
        return pkg.dtypes.register_new("PointXY", [("x", np.float64), ("y", np.float64)])
    except ValueError:
        return pkg.dtypes.PointXY


def ns(pkg):
    from importlib import import_module

    dtm = import_module(f"{pkg.__name__}.core.dtypes")
    point = _point(pkg)
    return SimpleNamespace(
        gb=pkg, Matrix=pkg.Matrix, Vector=pkg.Vector, Scalar=pkg.Scalar, binary=pkg.binary, monoid=pkg.monoid,
        unary=pkg.unary, semiring=pkg.semiring, dtypes=pkg.dtypes, dtm=dtm, Point=point, tx=pkg.tx,
    )


def both(R, fn):
    """fn(ns) on the port, then on the reference; both results."""
    return fn(ns(P)), fn(ns(R))


def same(p, r, label=""):
    """Results compared exactly: numpy (structured) arrays field by field,
    containers item by item, the rest by ==."""
    if isinstance(r, (list, tuple)):
        assert isinstance(p, (list, tuple)) and len(p) == len(r), label
        for i, (a, b) in enumerate(zip(p, r)):
            same(a, b, f"{label}[{i}]")
    elif isinstance(r, dict):
        assert isinstance(p, dict) and p.keys() == r.keys(), label
        for k in r:
            same(p[k], r[k], f"{label}.{k}")
    elif isinstance(r, (np.ndarray, np.void)):
        p, r = np.asarray(p), np.asarray(r)
        assert p.dtype == r.dtype and p.shape == r.shape, (label, p.dtype, r.dtype)
        if r.dtype.names:
            for f in r.dtype.names:
                np.testing.assert_array_equal(p[f], r[f], err_msg=f"{label}.{f}")
        else:
            np.testing.assert_array_equal(p, r, err_msg=label)
    else:
        assert p == r, (label, p, r)


def _pts(vals):
    arr = np.zeros(len(vals), dtype=[("x", np.float64), ("y", np.float64)])
    for i, (x, y) in enumerate(vals):
        arr[i] = (x, y)
    return arr


def coo(c):
    return [np.asarray(a) for a in c.to_coo()]


def padd(a, b):
    return {"x": a["x"] + b["x"], "y": a["y"] + b["y"]}


def test_vector_roundtrip(R):
    def run(g):
        vals = _pts([(1.0, 2.0), (3.0, 4.0)])
        v = g.Vector.from_coo([0, 3], vals.astype(g.Point.np_type), g.Point, size=5)
        assert v.dtype is g.Point
        w = v.dup()
        return v.nvals, coo(v), w.isequal(v), coo(w)

    p, r = both(R, run)
    same(p, r)
    assert p[0] == 2 and p[1][0].tolist() == [0, 3] and p[2]
    assert p[1][1]["x"].tolist() == [1.0, 3.0] and p[1][1]["y"].tolist() == [2.0, 4.0]


def test_matrix_roundtrip(R):
    def run(g):
        vals = _pts([(1.0, 2.0), (3.0, 4.0), (5.0, 6.0)]).astype(g.Point.np_type)
        A = g.Matrix.from_coo([0, 1, 1], [1, 0, 2], vals, g.Point, nrows=2, ncols=3)
        B = A.dup()
        return A.nvals, coo(A), B.isequal(A)

    p, r = both(R, run)
    same(p, r)
    assert p[0] == 3 and p[1][2]["x"].tolist() == [1.0, 3.0, 5.0] and p[2]


def test_udt_ewise(R):
    def run(g):
        op = g.binary.register_anonymous(padd, "point_add")
        vals1 = _pts([(1.0, 2.0), (3.0, 4.0)]).astype(g.Point.np_type)
        vals2 = _pts([(10.0, 20.0), (30.0, 40.0)]).astype(g.Point.np_type)
        v = g.Vector.from_coo([0, 1], vals1, g.Point, size=3)
        w = g.Vector.from_coo([1, 2], vals2, g.Point, size=3)
        return coo(v.ewise_add(w, op).new()), coo(v.ewise_mult(w, op).new())

    p, r = both(R, run)
    same(p, r)
    assert p[0][1]["x"].tolist() == [1.0, 13.0, 30.0] and p[0][1]["y"].tolist() == [2.0, 24.0, 40.0]
    assert p[1][1]["x"].tolist() == [13.0]


def test_udt_apply_and_reduce(R):
    def run(g):
        flip_op = g.unary.register_anonymous(lambda p: {"x": p["y"], "y": p["x"]}, "flip")
        vals = _pts([(1.0, 2.0), (3.0, 4.0)]).astype(g.Point.np_type)
        v = g.Vector.from_coo([0, 1], vals, g.Point, size=2)
        got = v.apply(flip_op).new()
        mon = g.monoid.register_anonymous(padd, {"x": 0.0, "y": 0.0}, "point_add_mon")
        s = v.reduce(mon).new()
        assert s.dtype._is_udt
        return coo(got), s.value, s.nvals, s.dtype.np_type

    p, r = both(R, run)
    same(p, r)
    assert p[0][1]["x"].tolist() == [2.0, 4.0]
    assert p[1]["x"] == 4.0 and p[1]["y"] == 6.0


def test_udt_extract_assign(R):
    def run(g):
        vals = _pts([(1.0, 2.0), (3.0, 4.0)]).astype(g.Point.np_type)
        v = g.Vector.from_coo([0, 1], vals, g.Point, size=4)
        out = [coo(v[[0, 2]].new()), v[1].new().value]
        v[2] = (9.0, 9.5)
        out += [v.nvals, v.get(2)]
        v[3] = {"x": -1.0, "y": -2.0}
        out.append(v.get(3))
        del v[0]
        out += [v.nvals, coo(v)]
        # masks work structurally
        o = g.Vector(g.Point, 4)
        o(v.S) << v.apply(lambda p: {"x": p["x"] * 2, "y": p["y"]})
        out += [o.nvals, o.get(2), coo(o)]
        return out

    p, r = both(R, run)
    same(p, r)
    assert p[0][0].tolist() == [0] and p[1]["x"] == 3.0
    assert p[2] == 3 and p[3]["y"] == 9.5 and p[4]["x"] == -1.0 and p[5] == 3
    assert p[7] == 3 and p[8]["x"] == 18.0


def test_udt_scalar(R):
    def run(g):
        s = g.Scalar(g.Point)
        assert s.is_empty
        s.value = (1.5, 2.5)
        t = g.Scalar.from_value(s.value)
        return s.value, s.nvals, t.dtype.np_type, t.value, t.dtype._is_udt

    p, r = both(R, run)
    same(p, r)
    assert p[0]["x"] == 1.5 and p[2] == ns(P).Point.np_type


def test_udt_mxm_builtin_semiring_raises(R):
    def run(g):
        vals = _pts([(1.0, 2.0)]).astype(g.Point.np_type)
        A = g.Matrix.from_coo([0], [0], vals, g.Point, nrows=2, ncols=2)
        with pytest.raises(KeyError) as info:
            A.mxm(A, "plus_times").new()
        return str(info.value)

    p, r = both(R, run)
    assert p == r


@pytest.fixture
def padd_sr():
    def make(g):
        bop = g.binary.register_anonymous(padd, "padd_mxm")
        mon = g.monoid.register_anonymous(padd, {"x": 0.0, "y": 0.0}, "padd_mxm_mon")
        return g.semiring.register_anonymous(mon, bop, "padd_padd_mxm")

    return make


def _A(g):
    return g.Matrix.from_coo(
        [0, 0, 1], [0, 1, 1], _pts([(1, 2), (3, 4), (5, 6)]).astype(g.Point.np_type), g.Point, nrows=2, ncols=2
    )


def test_udt_mxm(R, padd_sr):
    def run(g):
        B = g.Matrix.from_coo([0, 1], [0, 0], _pts([(10, 20), (30, 40)]).astype(g.Point.np_type), g.Point, nrows=2, ncols=2)
        return coo(_A(g).mxm(B, padd_sr(g)).new())

    p, r = both(R, run)
    same(p, r)
    assert list(zip(p[0].tolist(), p[1].tolist())) == [(0, 0), (1, 0)]
    assert p[2]["x"].tolist() == [44.0, 35.0] and p[2]["y"].tolist() == [66.0, 46.0]


def test_udt_mxv_vxm_inner(R, padd_sr):
    def run(g):
        sr = padd_sr(g)
        A = _A(g)
        v = g.Vector.from_coo([0, 1], _pts([(100, 200), (1000, 2000)]).astype(g.Point.np_type), g.Point, size=2)
        return coo(A.mxv(v, sr).new()), coo(v.vxm(A, sr).new()), v.inner(v, sr).new().value

    p, r = both(R, run)
    same(p, r)
    assert p[0][1]["x"].tolist() == [1104.0, 1005.0] and p[0][1]["y"].tolist() == [2206.0, 2006.0]
    assert p[1][1]["x"].tolist() == [101.0, 1108.0] and p[1][1]["y"].tolist() == [202.0, 2210.0]
    assert p[2]["x"] == 2200.0 and p[2]["y"] == 4400.0


def test_udt_mxm_masked_accum(R, padd_sr):
    def run(g):
        A = _A(g)
        C = g.Matrix.from_coo([0, 1], [0, 0], _pts([(0.5, 0.5), (7, 7)]).astype(g.Point.np_type), g.Point, nrows=2, ncols=2)
        mask = g.Matrix.from_coo([0], [0], [True], g.dtypes.BOOL, nrows=2, ncols=2)
        C(mask.S, accum=g.binary.register_anonymous(padd, "padd_acc")) << A.mxm(A, padd_sr(g))
        return coo(C), C[0, 0].new().value, C[1, 0].new().value

    p, r = both(R, run)
    same(p, r)
    assert (0, 0) in list(zip(p[0][0].tolist(), p[0][1].tolist()))
    assert p[1]["x"] == 2.5 and p[1]["y"] == 4.5 and p[2]["x"] == 7.0


def test_udt_resize_repr_asmatrix(R):
    def run(g):
        vals = _pts([(1.0, 2.0)]).astype(g.Point.np_type)
        v = g.Vector.from_coo([0], vals, g.Point, size=2)
        v.resize(4)
        out = [v.size, v.nvals, coo(v)]
        v.resize(1)
        m = v._as_matrix()
        out += [v.size, m.shape, coo(m), "nvals" in repr(v)]
        A = g.Matrix.from_coo([0], [0], vals, g.Point, nrows=2, ncols=2)
        A.resize(3, 3)
        out += [A.shape, A.nvals, coo(A), "nvals" in repr(A)]
        return out

    p, r = both(R, run)
    same(p, r)
    assert p[:2] == [4, 1] and p[3:5] == [1, (1, 1)] and p[6] and p[7:9] == [(3, 3), 1] and p[10]


def test_udt_dense_roundtrip(R):
    def run(g):
        Point = g.Point
        vals = _pts([(1.0, 2.0), (3.0, 4.0), (0.0, 0.0)]).astype(Point.np_type)
        v = g.Vector.from_dense(vals, missing_value=(0.0, 0.0), dtype=Point)
        out = [v.nvals, v.to_dense(fill_value=(-1.0, -1.0))]
        full = g.Vector.from_dense(vals, dtype=Point)
        out += [full.nvals, full.to_dense()]
        with pytest.raises(TypeError):
            v.to_dense()  # not full, no fill
        with pytest.raises(TypeError):
            full.to_dense(dtype="FP64")  # UDT cannot cast
        grid = np.zeros((2, 2), Point.np_type)
        grid[0, 1] = (5.0, 6.0)
        A = g.Matrix.from_dense(grid, missing_value=(0.0, 0.0), dtype=Point)
        out += [A.nvals, A.to_dense(fill_value={"x": 9.0, "y": 9.5})]
        return out

    p, r = both(R, run)
    same(p, r)
    assert p[0] == 2 and p[1]["x"].tolist() == [1.0, 3.0, -1.0] and p[1]["y"].tolist() == [2.0, 4.0, -1.0]
    assert p[2] == 3 and p[3]["x"].tolist() == [1.0, 3.0, 0.0]
    assert p[4] == 1 and p[5][0, 1]["x"] == 5.0 and p[5][1, 1]["y"] == 9.5


# ---------------------------------------------------------------------------
# UDTs in the sparse format
# ---------------------------------------------------------------------------


def test_udt_sparse_matrix_roundtrip_huge(R):
    def run(g):
        Point = g.dtm.register_anonymous([("x", "<f8"), ("y", "<i8")], name="PointRT")
        n = HUGE
        vals = np.array([(1.5, 2), (3.5, 4), (5.5, 6)], dtype=Point.np_type)
        A = g.Matrix.from_coo(np.array([0, 5, n - 1]), np.array([1, n - 2, 3]), vals, Point, nrows=n, ncols=n)
        assert A._sparse is not None
        out = [coo(A), A[5, n - 2].new().value]
        del A[5, n - 2]
        B = A.dup()
        return out + [A.nvals, B.isequal(A), coo(B)]

    p, r = both(R, run)
    same(p, r)
    assert p[0][0].tolist() == [0, 5, HUGE - 1] and p[0][2]["x"].tolist() == [1.5, 3.5, 5.5]
    assert p[0][2]["y"].tolist() == [2, 4, 6] and p[1]["x"] == 3.5 and p[2] == 2 and p[3]


def test_udt_sparse_ewise_add_mult(R):
    def run(g):
        Pair = g.dtm.register_anonymous([("a", "<f8"), ("b", "<f8")], name="PairEW")
        op = g.binary.register_anonymous(lambda x, y: {"a": x["a"] + y["a"], "b": x["b"] + y["b"]}, name="padd_sparse", is_udt=True)
        vals1 = np.array([(1.0, 2.0), (3.0, 4.0)], dtype=Pair.np_type)
        vals2 = np.array([(10.0, 20.0), (30.0, 40.0)], dtype=Pair.np_type)
        A = g.Matrix.from_coo([0, 7], [1, 2], vals1, Pair, nrows=HUGE, ncols=HUGE)
        B = g.Matrix.from_coo([0, 9], [1, 5], vals2, Pair, nrows=HUGE, ncols=HUGE)
        assert A._sparse is not None and B._sparse is not None
        C = A.ewise_add(B, op).new()
        M = A.ewise_mult(B, op).new()
        return C._sparse is not None, coo(C), coo(M)

    p, r = both(R, run)
    same(p, r)
    got = {(int(a), int(b)): (v["a"].item(), v["b"].item()) for a, b, v in zip(*p[1])}
    assert p[0] and got == {(0, 1): (11.0, 22.0), (7, 2): (3.0, 4.0), (9, 5): (30.0, 40.0)}
    assert p[2][0].tolist() == [0] and p[2][2]["a"].tolist() == [11.0]


def test_udt_sparse_small_matches_dense(R):
    def run(g):
        Duo = g.dtm.register_anonymous([("p", "<i8"), ("q", "<f4")], name="DuoSp")
        if g.gb is P:
            import torch

            def dmin(x, y):
                return {"p": torch.minimum(x["p"], y["p"]), "q": torch.minimum(x["q"], y["q"])}
        else:
            import jax.numpy as jnp

            def dmin(x, y):
                return {"p": jnp.minimum(x["p"], y["p"]), "q": jnp.minimum(x["q"], y["q"])}

        op = g.binary.register_anonymous(dmin, name="dmin_sp", is_udt=True)
        vals1 = np.array([(5, 1.0), (2, 9.0)], dtype=Duo.np_type)
        vals2 = np.array([(3, 2.0), (8, 0.5)], dtype=Duo.np_type)
        dense_a = g.Matrix.from_coo([0, 1], [0, 1], vals1, Duo, nrows=3, ncols=3)
        dense_b = g.Matrix.from_coo([0, 2], [0, 0], vals2, Duo, nrows=3, ncols=3)
        with g.tx.config.set(dense_limit=0):
            # the storage conversion that tx.config["storage"] = "coo" makes
            sp_a = dense_a.dup()
            sp_a._set_storage("coo")
            sp_b = dense_b.dup()
            sp_b._set_storage("coo")
        assert sp_a._sparse is not None and dense_a._sparse is None
        return coo(dense_a.ewise_add(dense_b, op).new()), coo(sp_a.ewise_add(sp_b, op).new())

    p, r = both(R, run)
    same(p, r)
    same(p[0], p[1])


def test_udt_isclose_and_isequal(R):
    def run(g):
        Point = g.dtypes.register_anonymous([("x", "float32"), ("y", "float32")], "PtIC")
        v = g.Vector(Point, 3)
        w = g.Vector(Point, 3)
        v[0] = {"x": 1.0, "y": 2.0}
        w[0] = {"x": 1.0 + 5e-6, "y": 2.0}  # representable f32 perturbation
        out = [v.isclose(w, rel_tol=1e-4), v.isclose(w, rel_tol=1e-8), v.isequal(w)]
        w[0] = {"x": 5.0, "y": 2.0}
        out.append(v.isclose(w))
        u = g.Vector(g.dtypes.FP32, 3)
        u[0] = 1.0
        return out + [v.isclose(u, check_dtype=False)]

    p, r = both(R, run)
    assert p == r == [True, False, False, False, False]


# the names and record types the reference's own tests register
# (tests/test_udt.py, tests/test_fixtures.py); this file registers the same
# records in the reference under the same names, or none
REFERENCE_NAMED = [
    ("PointRT", [("x", "<f8"), ("y", "<i8")]),
    ("PairEW", [("a", "<f8"), ("b", "<f8")]),
    ("DuoSp", [("p", "<i8"), ("q", "<f4")]),
    ("PtIC", [("x", "float32"), ("y", "float32")]),
]


def test_registrations_leave_the_reference_tests_their_types(R):
    """After this file's registrations in both packages, the reference
    tests' fixtures still get their types: ``register_new("PointXY", ...)``
    or, when it was registered before, ``dtypes.PointXY`` (the reference
    refuses a second name for one record dtype, so a different name here
    made its fixture error whenever the two files shared a process)."""
    ns(P), ns(R)
    for name, spec in REFERENCE_NAMED:
        for g in (P, R):
            g.dtypes.register_anonymous(spec, name)
    spec = [("x", np.float64), ("y", np.float64)]
    try:
        point = R.dtypes.register_new("PointXY", spec)
    except ValueError:
        point = R.dtypes.PointXY
    assert point.np_type == np.dtype(spec) and point.name == "PointXY"
    for name, spec in REFERENCE_NAMED:
        assert R.dtypes.register_anonymous(spec, name).np_type == np.dtype(spec)
