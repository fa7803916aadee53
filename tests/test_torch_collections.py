"""Parity of the port's collections (``graphblas_tpu_torch``'s ``Matrix``,
``Vector``, ``Scalar``, masks, the update protocol and the reprs) with the
JAX package's.

Collections cross between the packages as numpy: the same seeded numpy COO
arrays build both (``from_coo``), the same statements run on both, and
``to_coo()`` is compared: indices exactly, integer and bool values exactly,
floats within 1e-6 relative (1e-5 where a float plus is summed over a
matmul: ``torch.matmul`` and XLA's dot sum in their own orders).  Reprs are
compared string for string, and with the goldens of
``tests/test_formatting_goldens.py``.  ``tests/oracle.py`` gives a third
opinion on the masked updates.

Pinned, so the test harness's random draws decide nothing here: the port
runs on the CPU (``tx.config["platform"]``), ``mxm_strategy`` is set on
both packages (parametrized where it selects a path), ``mapnumpy`` is on in
both.  The harness's blocking draw changes only when the reference
synchronizes, never a value.  The JAX package is imported by the ``ref``
fixture, not at import time.
"""

import ast
import inspect
import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as P
from graphblas_tpu_torch.core import dtypes as pdt

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import graphblas_tpu as R

    return R


@pytest.fixture(autouse=True)
def pinned(request):
    """The port on the CPU; mxm_strategy "auto" and mapnumpy on in both."""
    if "ref" not in request.fixturenames:
        with P.tx.config.set(platform="cpu", mxm_strategy="auto"):
            yield
        return
    R = request.getfixturevalue("ref")
    old = (R.config["mapnumpy"], P.config["mapnumpy"])
    R.config["mapnumpy"] = P.config["mapnumpy"] = True
    try:
        with P.tx.config.set(platform="cpu", mxm_strategy="auto"), R.tx.config.set(mxm_strategy="auto"):
            yield
    finally:
        R.config["mapnumpy"], P.config["mapnumpy"] = old


def ns(pkg):
    return SimpleNamespace(
        gb=pkg, Matrix=pkg.Matrix, Vector=pkg.Vector, Scalar=pkg.Scalar, dtypes=pkg.dtypes, binary=pkg.binary,
        unary=pkg.unary, monoid=pkg.monoid, semiring=pkg.semiring, select=pkg.select, indexunary=pkg.indexunary, agg=pkg.agg,
    )


def coo_values(dtn, n, rng):
    npt = pdt.lookup_dtype(dtn).np_type
    if npt == np.bool_:
        return rng.random(n) < 0.6
    if npt.kind in "iu":
        return rng.integers(0 if npt.kind == "u" else -5, 9, n).astype(npt)
    v = rng.random(n) * 4 - 1
    if npt.kind == "c":
        v = v + 1j * rng.random(n)
    return v.astype(npt)


def matrix_coo(rng, nrows, ncols, dtn, density=0.4):
    cells = np.flatnonzero(rng.random(nrows * ncols) < density)
    return cells // ncols, cells % ncols, coo_values(dtn, len(cells), rng)


def make_matrix(pkg, coo, dtn, nrows, ncols, name=None):
    r, c, v = coo
    return pkg.Matrix.from_coo(r, c, v, getattr(pkg.dtypes, dtn), nrows=nrows, ncols=ncols, name=name)


def make_vector(pkg, coo, dtn, size, name=None):
    i, v = coo
    return pkg.Vector.from_coo(i, v, getattr(pkg.dtypes, dtn), size=size, name=name)


def assert_same(p, r, label="", rtol=1e-6):
    """A port collection against a reference one, through to_coo()."""
    assert type(p).__name__ == type(r).__name__, label
    assert p.dtype.name == r.dtype.name, (label, p.dtype, r.dtype)
    assert p.shape == r.shape, (label, p.shape, r.shape)
    if p.ndim == 0:
        assert p.is_empty == r.is_empty, label
        if not r.is_empty:
            np.testing.assert_allclose(np.asarray(p.value), np.asarray(r.value), rtol=rtol, err_msg=label)
        return
    pc, rc = p.to_coo(), r.to_coo()
    for a, b in zip(pc[:-1], rc[:-1]):
        np.testing.assert_array_equal(a, b, err_msg=label)
    want = rc[-1]
    assert pc[-1].dtype == want.dtype, label
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(pc[-1], want, err_msg=label)
    else:
        np.testing.assert_allclose(pc[-1], want, rtol=rtol, atol=0, equal_nan=True, err_msg=label)


def both(fn, ref):
    """Run ``fn(namespace)`` on both packages."""
    return fn(ns(P)), fn(ns(ref))


# ---------------------------------------------------------------------------
# constructors and exporters
# ---------------------------------------------------------------------------

TYPES = ["BOOL", "INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32", "UINT64", "FP32", "FP64", "FC32", "FC64"]


@pytest.mark.parametrize("dtn", TYPES)
def test_constructors_and_exporters_match_reference(ref, dtn):
    """from_coo (with duplicates), from_dense, from_scalar, from_dicts,
    from_csr/csc, build, and every exporter, per type; the values live on
    the CPU tensors as the type's carrier and come back as the reference's
    numpy dtype, bit for bit."""
    rng = np.random.default_rng(TYPES.index(dtn))
    coo = matrix_coo(rng, 5, 6, dtn)
    dense = coo_values(dtn, 30, rng).reshape(5, 6)
    vcoo = (np.array([4, 0, 2]), coo_values(dtn, 3, rng))

    def build(g):
        t = getattr(g.dtypes, dtn)
        A = make_matrix(g.gb, coo, dtn, 5, 6, "A")
        out = [A, A.T.new(), g.Matrix.from_dense(dense, dtype=t), g.Matrix.from_scalar(dense[1, 2], 3, 4, t)]
        out.append(g.Matrix.from_dense(dense, missing_value=dense[0, 0], dtype=t))
        out.append(g.Matrix.from_coo([0, 0, 2], [1, 1, 3], np.array([1, 2, 3]).astype(t.np_type), t, nrows=3, ncols=4, dup_op=g.binary.plus))
        out.append(g.Matrix.from_coo([0, 0, 2], [1, 1, 3], np.array([1, 2, 3]).astype(t.np_type), t, nrows=3, ncols=4, dup_op=g.binary.first))
        out.append(g.Matrix.from_csr(*A.to_csr(), dtype=t, ncols=6))
        out.append(g.Matrix.from_csc(*A.to_csc(), dtype=t, nrows=5))
        out.append(g.Matrix.from_dicts(A.to_dicts(), t, nrows=5, ncols=6))
        B = g.Matrix(t, 5, 6)
        B.build(*coo)
        out.append(B)
        out += [make_vector(g.gb, vcoo, dtn, 6, "v"), g.Vector.from_dense(dense[0], dtype=t), g.Vector.from_scalar(dense[2, 2], 4, t)]
        out.append(g.Vector.from_coo([1, 1, 3], np.array([4, 5, 6]).astype(t.np_type), t, size=5, dup_op=g.binary.second))
        out.append(A.diag(1))
        out.append(A.T.diag(-1))
        out.append(out[-6].diag(1))
        return out, A

    (pouts, pA), (routs, rA) = both(build, ref)
    for i, (p, r) in enumerate(zip(pouts, routs)):
        assert_same(p, r, f"{dtn} #{i}")
    for fn in ("to_csr", "to_csc", "to_dcsr", "to_dcsc", "to_edgelist"):
        for a, b in zip(getattr(pA, fn)(), getattr(rA, fn)()):
            np.testing.assert_array_equal(a, b, err_msg=fn)
    assert pA.to_dicts() == rA.to_dicts()
    np.testing.assert_array_equal(pA.to_dense(fill_value=0), rA.to_dense(fill_value=0))
    np.testing.assert_array_equal(pA.T.to_dense(fill_value=1), rA.T.to_dense(fill_value=1))
    assert pA.nvals == rA.nvals and pA.T.nvals == rA.T.nvals
    assert pA.get(int(coo[0][0]), int(coo[1][0])) == rA.get(int(coo[0][0]), int(coo[1][0]))
    assert pA.get(4, 5, "absent") == rA.get(4, 5, "absent")
    assert ((1, 2) in pA) == ((1, 2) in rA) and list(pA) == list(rA)
    assert pouts[11].to_dict() == routs[11].to_dict() and list(pouts[11]) == list(routs[11])
    assert pA.isequal(make_matrix(P, coo, dtn, 5, 6)) and pA.isclose(make_matrix(P, coo, dtn, 5, 6))
    assert pA.isequal(pouts[10]) == rA.isequal(routs[10])


def test_resize_clear_dup_and_reposition_match_reference(ref):
    rng = np.random.default_rng(5)
    coo = matrix_coo(rng, 5, 6, "INT32")
    vcoo = (np.array([0, 3, 5]), np.array([1.5, -2.0, 4.0]))

    def run(g):
        A = make_matrix(g.gb, coo, "INT32", 5, 6)
        out = [A.dup(), A.dup(g.dtypes.FP32), A.dup(clear=True), A.dup(mask=A.V), A.reposition(1, -2).new()]
        out.append(A.reposition(-1, 3, nrows=7, ncols=4).new())
        A.resize(7, 4)
        out.append(A.dup())
        A.resize(3, 8)
        out.append(A.dup())
        A.clear()
        out.append(A)
        v = make_vector(g.gb, vcoo, "FP64", 7)
        out += [v.reposition(2).new(), v.reposition(-1, size=9).new()]
        v.resize(9)
        out.append(v.dup())
        v.resize(4)
        out.append(v)
        out.append(make_matrix(g.gb, (coo[0], coo[1] % 5, coo[2]), "INT32", 5, 5).power(3).new())
        out.append(make_matrix(g.gb, (coo[0], coo[1] % 5, coo[2]), "INT32", 5, 5).power(0).new())
        return out

    for i, (p, r) in enumerate(zip(*both(run, ref))):
        assert_same(p, r, f"#{i}")


@pytest.mark.parametrize("dtn", ["INT64", "FP32", "UINT8", "BOOL"])
def test_scalar_matches_reference(ref, dtn):
    """Scalar values, arithmetic (the ewise recipe: an empty operand gives
    an empty result), apply, select, reduce into a Scalar with accum."""
    rng = np.random.default_rng(7)
    vcoo = (np.array([0, 2, 3]), coo_values(dtn, 3, rng))

    def run(g):
        t = getattr(g.dtypes, dtn)
        s = g.Scalar.from_value(vcoo[1][0], t, name="s")
        e = g.Scalar(t)
        x = make_vector(g.gb, vcoo, dtn, 5)
        out = [s, e, s.dup(), (s + s).new() if dtn != "BOOL" else (s | s).new(), s.ewise_mult(e).new(), s.ewise_add(e).new()]
        out += [s.apply(g.unary.identity).new(), s.select("==", vcoo[1][0]).new(), s.ewise_union(e, g.binary.plus, 1, 2).new()]
        r = g.Scalar(t)
        r << x.reduce(g.monoid.max if dtn != "BOOL" else g.monoid.lor)
        out.append(r.dup())
        r(accum=g.binary.plus) << x.reduce(g.monoid.plus)
        out.append(r)
        c = g.Scalar(t)
        c << x.reduce(g.monoid.plus, allow_empty=False)
        out.append(c)
        out.append(g.Vector(t, 4).reduce(allow_empty=False).new())
        out.append(g.Vector(t, 4).reduce().new())
        return out, (bool(s), s.value, s.is_empty, e.value, s.isequal(vcoo[1][0]), s == s.dup(), e.nvals, s.get(), e.get(-1))

    (p, pinfo), (r, rinfo) = both(run, ref)
    for i, (a, b) in enumerate(zip(p, r)):
        assert_same(a, b, f"{dtn} #{i}")
    assert pinfo == rinfo


# ---------------------------------------------------------------------------
# the update protocol: masks x accum x replace
# ---------------------------------------------------------------------------

MASKS = ["none", "S", "V", "~S", "~V", "bool"]


UPDATE_CASES = [
    (mask, accum, replace)
    for mask in MASKS
    for accum in (None, "plus", "min", "second")
    for replace in (False, True)
    if not (replace and mask == "none")  # replace requires a mask
]


@pytest.mark.parametrize("mask, accum, replace", UPDATE_CASES)
def test_update_mask_accum_replace_matches_reference(ref, mask, accum, replace):
    """C(mask, accum, replace) << expr for every mask kind (and a BOOL
    collection lifted to a value mask) x accum x replace, into a C of
    another type than the expression's (INT32 C, FP64 expression), for a
    matrix product, a vector ewise and an apply; held to the reference and,
    for the product, to ``tests/oracle.py``."""
    import oracle as orc

    rng = np.random.default_rng(MASKS.index(mask) * 10 + (accum is None) + 2 * replace)
    a, b, c = matrix_coo(rng, 6, 5, "FP64"), matrix_coo(rng, 5, 6, "FP64"), matrix_coo(rng, 6, 6, "INT32")
    m = matrix_coo(rng, 6, 6, "INT8", 0.5)
    mb = matrix_coo(rng, 6, 6, "BOOL", 0.5)
    vx, vy, vm = (np.array([0, 2, 5]), np.array([1.5, 2.5, -1.0])), (np.array([1, 2, 4]), np.array([3.0, 4.0, 5.0])), (np.array([0, 1, 2, 4]), np.array([1, 0, 2, 3]))

    def run(g):
        A, B = make_matrix(g.gb, a, "FP64", 6, 5), make_matrix(g.gb, b, "FP64", 5, 6)
        C = make_matrix(g.gb, c, "INT32", 6, 6, "C")
        M = make_matrix(g.gb, mb if mask == "bool" else m, "BOOL" if mask == "bool" else "INT8", 6, 6, "M")
        kinds = {"none": None, "S": M.S, "V": M.V, "~S": ~M.S, "~V": ~M.V, "bool": M}
        args = [kinds[mask]] if kinds[mask] is not None else []
        acc = None if accum is None else getattr(g.binary, accum)
        C(*args, accum=acc, replace=replace) << A.mxm(B, g.semiring.plus_times)
        x, y = make_vector(g.gb, vx, "FP64", 6), make_vector(g.gb, vy, "FP64", 6, "y")
        vmask = make_vector(g.gb, vm, "INT64", 6, "vm")
        vkinds = {"none": None, "S": vmask.S, "V": vmask.V, "~S": ~vmask.S, "~V": ~vmask.V, "bool": vmask.V}
        vargs = [vkinds[mask]] if vkinds[mask] is not None else []
        y(*vargs, accum=acc, replace=replace) << x.ewise_add(y, g.binary.times)
        D = make_matrix(g.gb, c, "INT32", 6, 6)
        D(*args, accum=acc, replace=replace) << D.apply(g.unary.ainv)
        return C, y, D

    (pC, py, pD), (rC, ry, rD) = both(run, ref)
    assert_same(pC, rC, "mxm", rtol=1e-5)
    assert_same(py, ry, "ewise")
    assert_same(pD, rD, "apply")
    # the third opinion: the oracle's mxm + merge on dicts
    z = orc.mxm(dict(zip(zip(a[0].tolist(), a[1].tolist()), a[2].tolist())), dict(zip(zip(b[0].tolist(), b[1].tolist()), b[2].tolist())), lambda x, y: x + y, lambda x, y, i, k, j: x * y)
    cdict = dict(zip(zip(c[0].tolist(), c[1].tolist()), c[2].tolist()))
    mc = mb if mask == "bool" else m
    mdict = dict(zip(zip(mc[0].tolist(), mc[1].tolist()), mc[2].tolist()))
    universe = [(i, j) for i in range(6) for j in range(6)]
    if mask == "none":
        allowed = set(universe)
    else:
        struct = mask in ("S", "~S")
        hit = {k for k, v in mdict.items() if struct or v}
        allowed = set(universe) - hit if mask.startswith("~") else hit
    accf = {None: None, "plus": lambda x, y: x + y, "min": min, "second": lambda x, y: y}[accum]
    want = {}
    for key in universe:
        zv = int(np.int32(np.float64(z[key]).astype(np.int32))) if key in z else None
        cv = cdict.get(key)
        if accf is not None:
            merged = zv if cv is None else cv if zv is None else int(np.int32(accf(cv, zv)))
        else:
            merged = zv
        if key in allowed:
            if merged is not None:
                want[key] = merged
        elif not replace and cv is not None:
            want[key] = cv
    r_, c_, v_ = pC.to_coo()
    got = dict(zip(zip(r_.tolist(), c_.tolist()), v_.tolist()))
    assert got == want


def test_masks_combine_and_materialize_as_reference(ref):
    rng = np.random.default_rng(9)
    m1, m2 = matrix_coo(rng, 4, 5, "INT16", 0.5), matrix_coo(rng, 4, 5, "FP32", 0.5)

    def run(g):
        M1, M2 = make_matrix(g.gb, m1, "INT16", 4, 5, "M1"), make_matrix(g.gb, m2, "FP32", 4, 5, "M2")
        out = [M1.S.new(), M1.V.new(g.dtypes.INT8), (~M1.S).new(), (~M2.V).new(complement=True), M1.S.new(mask=M2.V)]
        out += [(M1.S & M2.V).new(), (M1.V | ~M2.S).new(), M1.dup(mask=~M2.S)]
        return out

    for i, (p, r) in enumerate(zip(*both(run, ref))):
        assert_same(p, r, f"#{i}")


# ---------------------------------------------------------------------------
# reprs, string for string
# ---------------------------------------------------------------------------


def _golden_cases():
    """(name, source of the object, expected repr) from the JAX package's
    golden file."""
    tree = ast.parse(open(os.path.join(HERE, "test_formatting_goldens.py")).read())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        assigns = {t.targets[0].id: t.value for t in fn.body if isinstance(t, ast.Assign)}
        if "obj" in assigns and "expected" in assigns:
            out.append((fn.name, ast.unparse(assigns["obj"]), ast.literal_eval(assigns["expected"])))
    return out


GOLDENS = _golden_cases()


@pytest.mark.parametrize("name, source, expected", GOLDENS, ids=[g[0] for g in GOLDENS])
def test_golden_reprs(ref, name, source, expected):
    """Each golden of tests/test_formatting_goldens.py, built on both
    packages: the port's repr equals the reference's and the golden (the
    2^40-entry vector in the sparse format on both)."""
    env = lambda g: {**vars(ns(g)), "np": np}  # noqa: E731
    robj = eval(source, env(ref))  # noqa: S307
    if "2 ** 40" in source:
        pobj = eval(source, env(P))  # noqa: S307
        assert pobj._sparse is not None and robj._sparse is not None
    if "BF16" in source and getattr(P.dtypes, "BF16", None) is None:
        pytest.skip("no bfloat16 numpy type here")
    pobj = eval(source, env(P))  # noqa: S307
    assert repr(pobj) == repr(robj) == expected


REPR_CASES = {
    "matrix": lambda g, A, v: A,
    "transposed": lambda g, A, v: A.T,
    "mask_S": lambda g, A, v: A.S,
    "mask_V": lambda g, A, v: A.V,
    "mask_notS": lambda g, A, v: ~A.S,
    "mask_notV": lambda g, A, v: ~v.V,
    "vector": lambda g, A, v: v,
    "big_grid": lambda g, A, v: g.Matrix.from_scalar(1.5, 25, 18, g.dtypes.FP32, name="G"),
    "big_vector": lambda g, A, v: g.Vector.from_coo(np.arange(0, 60, 2), np.arange(30), size=60, name="bv"),
    "mxv_expr": lambda g, A, v: A.mxv(v, g.semiring.min_plus),
    "ewise_expr": lambda g, A, v: A.ewise_mult(A, g.binary.times),
    "select_expr": lambda g, A, v: A.select(g.select.tril),
    "reduce_expr": lambda g, A, v: A.reduce_rowwise(g.monoid.max),
    "scalar_expr": lambda g, A, v: v.reduce(g.monoid.plus),
    "extract_expr": lambda g, A, v: A[[0, 2], :],
    "infix_or": lambda g, A, v: A | A,
    "infix_matmul": lambda g, A, v: A @ A,
    "transpose_expr": lambda g, A, v: A.T.new(),
    "empty": lambda g, A, v: g.Matrix(g.dtypes.INT8, 0, 3),
}


@pytest.mark.parametrize("case", sorted(REPR_CASES))
@pytest.mark.parametrize("autocompute", [True, False])
def test_reprs_match_reference(ref, case, autocompute):
    """Collections, transposed views, the four masks, truncated grids and
    COO tables, and delayed/infix expression reprs (autocomputed or not)."""
    rng = np.random.default_rng(13)
    a = matrix_coo(rng, 5, 5, "FP64", 0.5)
    v = (np.array([0, 3]), np.array([1.0, 2.0]))

    def run(g):
        with g.gb.config.set(autocompute=autocompute):
            return repr(REPR_CASES[case](g, make_matrix(g.gb, a, "FP64", 5, 5, "A"), make_vector(g.gb, v, "FP64", 5, "v")))

    p, r = both(run, ref)
    assert p == r


# ---------------------------------------------------------------------------
# the port's own rules: aliasing, the nvals cache, devices, waiting features
# ---------------------------------------------------------------------------


def test_shared_tensors_keep_their_values_after_updates(ref):
    """Hard spot of the port: torch tensors mutate, JAX arrays do not.  A
    dup(), a mask, a transposed view and an expression share the original's
    tensors; every update installs new tensors, so what was shared keeps its
    values, and everything equals the reference after the same statements."""
    rng = np.random.default_rng(17)
    a, b = matrix_coo(rng, 5, 5, "INT64"), matrix_coo(rng, 5, 5, "INT64")

    def run(g):
        A, B = make_matrix(g.gb, a, "INT64", 5, 5, "A"), make_matrix(g.gb, b, "INT64", 5, 5, "B")
        D = A.dup()
        S = A.S.new()
        early = A.ewise_add(B, g.binary.plus).new()
        expr = A.ewise_mult(B, g.binary.times)  # computed after the updates
        held = getattr(A, "_values", None), getattr(A, "_struct", None)
        A(accum=g.binary.plus) << A.mxm(B, g.semiring.plus_times)
        A[0, 1] = 99
        A[1, :] = make_matrix(g.gb, b, "INT64", 5, 5)[2, :].new()
        del A[2, 2]
        A(A.S, replace=True) << A.apply(g.unary.ainv)
        A(B.S)[1:3, 0:2] = 7
        A << A.T
        C = B.dup()
        C(accum=g.binary.plus) << C.mxm(C, g.semiring.plus_times)
        return [A, D, S, early, expr.new(), C, B], held

    (pouts, (pv, ps)), (routs, _) = both(run, ref)
    for i, (p, r) in enumerate(zip(pouts, routs)):
        assert_same(p, r, f"#{i}")
    # the tensors A held before the updates are untouched
    assert pv._version == 0 and ps._version == 0
    np.testing.assert_array_equal(pouts[1]._values.numpy(), pv.numpy())


def test_nvals_is_cached_on_the_struct_tensor_and_its_version():
    A = P.Matrix.from_coo([0, 1, 2], [0, 1, 2], [1.0, 2.0, 3.0], nrows=3, ncols=3)
    assert A.nvals == 3
    cache = A._nvals_cache
    assert cache[0] is A._struct and A.nvals == 3 and A._nvals_cache is cache
    A[0, 2] = 5.0
    assert A.nvals == 4 and A._nvals_cache[0] is A._struct
    A._struct[1, 1] = False  # an in-place write (never made by the package) is caught by the version
    assert A.nvals == 3


def test_collections_go_on_the_configured_device():
    """tx.config["platform"]: "cuda" by default, so with no card building a
    collection raises as PyTorch does; "cpu" puts every tensor on the CPU;
    operands on two devices raise."""
    assert P.tx.config["platform"] == "cpu"  # pinned by the fixture
    with P.tx.config.set(platform="cuda"):
        if not torch.cuda.is_available():
            for build in (lambda: P.Matrix(P.dtypes.FP64, 2, 2), lambda: P.Vector.from_coo([0], [1.0]), lambda: P.Matrix.from_scalar(1, 2, 2)):
                with pytest.raises((RuntimeError, AssertionError)):
                    build()
    assert P.tx.config.set.__doc__ and P.tx.__name__ == "graphblas_tpu_torch.tx"
    with pytest.raises(ValueError):
        P.tx.config["platform"] = "tpu"
    A = P.Matrix.from_coo([0, 1], [1, 0], [1.0, 2.0], nrows=2, ncols=2)
    assert A._values.device.type == "cpu" and A._struct.device.type == "cpu"
    meta = P.Matrix._from_arrays(torch.zeros(2, 2, device="meta"), torch.zeros(2, 2, dtype=torch.bool, device="meta"), P.dtypes.FP64)
    for stmt in (lambda: A.ewise_add(meta), lambda: A.mxm(meta), lambda: A.isequal(meta), lambda: A.kronecker(meta)):
        with pytest.raises(ValueError, match="device"):
            stmt()


def test_value_helpers_name_their_device():
    """core.dtypes.to_tensor and scalar_tensor put nothing on a default
    device: the caller names it."""
    for fn in (pdt.to_tensor, pdt.scalar_tensor):
        assert inspect.signature(fn).parameters["device"].default is inspect.Parameter.empty
    with pytest.raises(TypeError):
        pdt.to_tensor(np.zeros(2), pdt.FP64)


def test_waiting_features_raise_naming_their_queue(ref):
    """The features of later queues raise, naming their queue.  The sparse
    format (queue 4) is ported: the collections past dense_limit that raised
    before build, and their shape, nvals and format equal the reference's."""
    past_limit = [
        lambda g: g.Matrix(g.dtypes.FP64, 1 << 13, 1 << 12),
        lambda g: g.Matrix.from_coo([0], [0], [1.0], nrows=1 << 13, ncols=1 << 12),
        lambda g: g.Vector(g.dtypes.INT8, (1 << 24) + 1),
        lambda g: g.Matrix.from_scalar(1, 1 << 12, (1 << 12) + 1),
    ]
    for build in past_limit:
        p, r = build(P), build(ref)
        assert (p.shape, p.nvals, p.dtype.name) == (r.shape, r.nvals, r.dtype.name)
        assert (getattr(p, "_sparse", None) is None) == (getattr(r, "_sparse", None) is None)
        assert repr(p).splitlines()[:2] == repr(r).splitlines()[:2]
    udt = P.dtypes.register_anonymous(np.dtype([("x", np.int32), ("y", np.float64)]))
    cases = [
        (lambda: P.Matrix(udt, 2, 2), "queue 3b"),
        (lambda: P.Vector(udt, 2), "queue 3b"),
        (lambda: P.Scalar(udt), "queue 3b"),
        (lambda: P.compile(lambda: None), "queue 5"),
        (lambda: P.loop(3), "queue 5"),
        (lambda: P.Matrix(P.dtypes.FP64, 2, 2).tx, "queue 7"),
        (lambda: P.Vector(P.dtypes.FP64, 2).ss, "queue 7"),
        (lambda: pickle.dumps(P.Matrix(P.dtypes.FP64, 2, 2)), "queue 7"),
        (lambda: P.io, "queue 7"),
        (lambda: P.parallel, "queue 8"),
    ]
    for fn, queue in cases:
        with pytest.raises(NotImplementedError, match=queue):
            out = fn()
            if callable(out):
                out()
    # 4096^2 = 2^24 cells is the dense-masked limit, and fits
    assert P.Matrix(P.dtypes.BOOL, 1 << 12, 1 << 12).shape == (4096, 4096)


def test_blocking_mode_synchronizes_without_changing_values(monkeypatch):
    monkeypatch.setattr(P, "is_blocking", True)
    A = P.Matrix.from_coo([0, 1], [1, 0], [1.0, 2.0], nrows=2, ncols=2)
    A << A.mxm(A)
    assert A.to_coo()[2].tolist() == [2.0, 2.0] and A.wait() is A
