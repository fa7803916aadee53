"""Parity of the port's sparse Vector and of the sparse extract, assign,
delete and unmasked mxm with the JAX package's, case for case with
``tests/test_sparse_vector.py`` and ``tests/test_sparse_assign.py``.

As in ``test_torch_sparse.py`` (whose helpers run the cases): the same
seeded statements on both packages, 2^40 dimensions sparse by themselves and
small ones forced sparse by ``tx.config.set(dense_limit=0)`` on both;
indices and integer and bool values exact, floats within 1e-6 relative.
"""

import numpy as np
import pytest
from test_torch_sparse import HUGE, is_sparse, pinned, ref, run_both, sparse_ns  # noqa: F401

import graphblas_tpu_torch as P


def _sv(g, idx, vals, size=HUGE, dtype=None):
    return g.Vector.from_coo(idx, vals, g.dtypes.FP64 if dtype is None else dtype, size=size)


def _huge_matrix(g):
    rows = np.array([0, 5, 5, 1 << 30, HUGE - 1])
    cols = np.array([1, 2, 1 << 35, 3, 4])
    return g.Matrix.from_coo(rows, cols, [1.0, 2.0, 3.0, 4.0, 5.0], g.dtypes.FP64, nrows=HUGE, ncols=HUGE)


# -- test_sparse_vector.py ----------------------------------------------------


def huge_vector_storage(g):
    v = _sv(g, [3, 10, HUGE - 1], [1.0, 2.0, 3.0])
    empty = g.Vector(g.dtypes.FP32, HUGE)
    w = _sv(g, [5], [7.0])
    w.clear()
    return [v, v.size, v.nvals, (HUGE - 1) in v, 4 in v, v.get(10), v.get(11, default=-1), list(v), empty, w, repr(v)]


def huge_vector_dup_isequal_dup_op(g):
    v = _sv(g, [1, 2, 1 << 35], [1.0, 2.0, 3.0])
    d = g.Vector.from_coo([5, 5, 9], [1.0, 2.0, 4.0], g.dtypes.FP64, size=HUGE, dup_op=g.binary.plus)
    return [v.dup(), v.isequal(v.dup()), v.dup(dtype=g.dtypes.FP32), v.isequal(_sv(g, [1, 2], [1.0, 2.0])), d, v.dup(clear=True)]


def vector_ewise(g):
    a = _sv(g, [1, 5, 9, 1 << 33], [1.0, 2.0, 3.0, 4.0])
    b = _sv(g, [5, 9, 11], [10.0, 20.0, 30.0])
    out = [a.ewise_mult(b, g.binary.times).new(), a.ewise_add(b, g.binary.plus).new()]
    out += [a.ewise_union(b, g.binary.minus, left_default=0.0, right_default=100.0).new()]
    with g.sp():
        c = g.Vector.from_coo([0, 2], [5.0, 6.0], g.dtypes.FP64, size=8)
    d = g.Vector.from_coo([2, 3], [7.0, 8.0], g.dtypes.FP64, size=8)
    return out + [c.ewise_add(d, g.binary.plus).new(), d.ewise_mult(c, g.binary.minus).new(), (a + b).new()]


def vector_apply_select_reduce(g):
    v = _sv(g, [1, 4, 1 << 39], [1.0, -2.0, 3.0])
    out = [v.apply(g.unary.abs).new(), v.apply(g.binary.times, right=10).new(), v.apply(g.binary.minus, left=1.0).new()]
    out += [v.select("value>0").new(), v.select("value>=3").new(), v.select("index<=", 100).new()]
    out += [v.reduce(m).new() for m in (g.monoid.plus, g.monoid.min, g.monoid.max, g.monoid.times)]
    out += [v.apply("rowindex", 0).new(), v.apply(g.unary.positioni).new()]
    empty = g.Vector(g.dtypes.FP64, HUGE)
    return out + [empty.reduce(g.monoid.plus).new(), empty.reduce(g.monoid.plus, allow_empty=False).new()]


def vector_inner_and_apply_forced(g):
    with g.sp():
        a = g.Vector.from_coo([0, 2, 5], [1.0, 2.0, 3.0], g.dtypes.FP64, size=8)
        i = g.Vector.from_coo([1, 3], [2, 4], g.dtypes.INT32, size=6)
    b = g.Vector.from_coo([2, 5, 7], [10.0, 20.0, 30.0], g.dtypes.FP64, size=8)
    return [a.inner(b, g.semiring.plus_times).new(), a.apply(g.binary.plus, right=1.0).new(), i.apply(g.binary.times, right=3).new(), i.reduce().new()]


def huge_mxv_vxm(g):
    rows = np.array([0, 1 << 30, 1 << 30, HUGE - 1])
    cols = np.array([5, 7, 1 << 20, 7])
    A = g.Matrix.from_coo(rows, cols, [2.0, 3.0, 4.0, 5.0], g.dtypes.FP64, nrows=HUGE, ncols=HUGE)
    x = _sv(g, [5, 7], [10.0, 100.0])
    B = g.Matrix.from_coo([3, 5], [1 << 35, 2], [2.0, 3.0], g.dtypes.FP64, nrows=HUGE, ncols=HUGE)
    y = _sv(g, [3, 5], [1.0, 10.0])
    C = g.Matrix.from_coo([10, 10, 20], [1, 2, 1], [5.0, 1.0, 7.0], g.dtypes.FP64, nrows=HUGE, ncols=HUGE)
    z = _sv(g, [1, 2], [100.0, 200.0])
    out = [A.mxv(x, g.semiring.plus_times).new(), y.vxm(B, g.semiring.plus_times).new(), A.T.mxv(_sv(g, [0, HUGE - 1], [1.0, 2.0]), g.semiring.max_first).new()]
    return out + [C.mxv(z, g.semiring.min_plus).new(), C.mxv(z, g.semiring.min_secondi).new(), C.mxv(z, g.semiring.any_pair).new()]


def small_mxv_with_sparse_vector(g):
    """A sparse vector into a small dense matrix: a dense output."""
    with g.sp():
        x = g.Vector.from_coo([0, 2], [1.0, 2.0], g.dtypes.FP64, size=4)
    A = g.Matrix.from_dense(np.arange(12, dtype=np.float64).reshape(3, 4))
    with g.sp():
        As = g.Matrix.from_dense(np.arange(12, dtype=np.float64).reshape(3, 4))
    return [A.mxv(x, g.semiring.plus_times).new(), As.mxv(x, g.semiring.plus_times).new(), x.vxm(As.T, g.semiring.min_plus).new()]


def forced_sparse_matches_dense(g):
    rng = np.random.default_rng(0)
    idx, idx2 = (np.sort(rng.choice(64, size=k, replace=False)) for k in (20, 15))
    vals, vals2 = rng.random(20), rng.random(15)
    out = []
    for ctx in (lambda: g.cfg(), g.sp):
        with ctx():
            a = g.Vector.from_coo(idx, vals, g.dtypes.FP64, size=64)
            b = g.Vector.from_coo(idx2, vals2, g.dtypes.FP64, size=64)
        out += [a.ewise_mult(b, g.binary.plus).new(), a.ewise_add(b, g.binary.plus).new(), a.reduce(g.monoid.plus).new()]
    for i in range(3):
        assert out[i].isequal(out[i + 3]) if i < 2 else out[i].value == pytest.approx(out[i + 3].value)
    return out


# -- test_sparse_assign.py ----------------------------------------------------


def huge_extract(g):
    A = _huge_matrix(g)
    v = _sv(g, [3, 10, 1 << 35], [1.0, 2.0, 3.0])
    out = [A[[0, 5, 1 << 30], [1, 2, 3]].new(), A[5, :].new(), A[:, 2].new(), A[:, :].new(), A[:, :].new().isequal(A)]
    out += [A[5, 2].new(), A[6, 2].new(), A[HUGE - 1, 4].new(), A[[5, 5, 0], :].new()]
    return out + [v[[10, 3, 4]].new(), v[:].new(), v[1 << 35].new(), v[[3, 3]].new()]


def extract_duplicate_indices(g):
    rng = np.random.default_rng(1)
    r, c, v = rng.integers(0, 16, 30), rng.integers(0, 16, 30), rng.random(30)
    with g.sp():
        sp = g.Matrix.from_coo(r, c, v, g.dtypes.FP64, nrows=16, ncols=16, dup_op=g.binary.plus)
        vec = g.Vector.from_coo(r, v, g.dtypes.FP64, size=16, dup_op=g.binary.max)
    return [sp[[0, 3, 3, 7], [1, 1, 5]].new(), sp[3, [1, 1, 5]].new(), sp[[4, 4], 2].new(), vec[[2, 2, 9]].new()]


def huge_assign_delete(g):
    A = _huge_matrix(g)
    A[7, 8] = 9.5
    out = [A.dup(), A[7, 8].new()]
    A[5, 2] = 20.0  # overwrite existing
    del A[7, 8]
    out += [A.dup()]
    B = _huge_matrix(g)
    B[5, :] = _sv(g, [2, 1 << 20], [7.0, 8.0])  # the region replaced
    C = _huge_matrix(g)
    C(accum=g.binary.plus)[5, :] = _sv(g, [2, 9], [10.0, 1.0])
    D = _huge_matrix(g)
    D[[1, 2], [3, 4]] = 5.5
    E = _huge_matrix(g)
    del E[[5, 0], [1, 2, 1 << 35]]
    F = _huge_matrix(g)
    F[:, 4] = _sv(g, [HUGE - 1, 3], [-1.0, -2.0])
    F(accum=g.binary.times)[[0, 5], [1, 2]] = g.Matrix.from_coo([0, 1], [0, 1], [3.0, 4.0], nrows=2, ncols=2)
    with pytest.raises(g.exc.OutOfMemory, match="iso"):
        _huge_matrix(g)[:, 5] = 1.0
    return out + [B, C, D, E, F]


def huge_vector_assign_delete(g):
    v = _sv(g, [3, 10], [1.0, 2.0])
    v[1 << 30] = 7.0
    out = [v.dup()]
    v[[3, 4]] = g.Vector.from_coo([0, 1], [8.0, 9.0], g.dtypes.FP64, size=2)
    out += [v.dup()]
    del v[[10, 4]]
    out += [v.dup()]
    v(accum=g.binary.plus)[3] = 2.0
    v[[5, 6]] = 1.5
    v(accum=g.binary.max)[[5, 1 << 30]] = np.array([0.5, 9.0])
    return out + [v]


def assign_matches_dense(g):
    rng = np.random.default_rng(2)
    n = 24
    r, c, v = rng.integers(0, n, 60), rng.integers(0, n, 60), rng.random(60)
    val = g.Matrix.from_coo([0, 1, 2], [0, 1, 1], [1.5, 2.5, 3.5], g.dtypes.FP64, nrows=3, ncols=2)
    out = []
    for ctx in (lambda: g.cfg(), g.sp):
        with ctx():
            M = g.Matrix.from_coo(r, c, v, g.dtypes.FP64, nrows=n, ncols=n, dup_op=g.binary.plus)
        M[[3, 11, 7], [0, 5]] = val
        out.append(M.dup())
        M(accum=g.binary.plus)[[3, 11, 7], [0, 5]] = val
        out.append(M.dup())
        M[[0, 1], [2, 3]] = 9.0
        del M[3, :]
        M[4, [1, 2]] = g.Vector.from_coo([0], [6.0], size=2)
        out.append(M)
    for i in range(3):
        assert out[i].isequal(out[i + 3])
    return out


def masked_assign_into_sparse(g):
    """A masked assign into sparse storage takes the dense path (densify
    guarded), as the reference's does."""
    with g.sp():
        A = g.Matrix.from_coo([0, 1, 2], [0, 1, 2], [1.0, 2.0, 3.0], nrows=4, ncols=4)
        M = g.Matrix.from_coo([0, 3], [1, 3], True, nrows=4, ncols=4)
    A(M.S)[:, :] = 7.0
    return [A]


def unmasked_mxm_cases(g):
    rows = np.array([0, 0, 1 << 30])
    A = g.Matrix.from_coo(rows, [2, 3, 2], [1.0, 2.0, 3.0], g.dtypes.FP64, nrows=HUGE, ncols=HUGE)
    B = g.Matrix.from_coo([2, 3], [1 << 39, 1 << 39], [10.0, 100.0], g.dtypes.FP64, nrows=HUGE, ncols=HUGE)
    out = [A.mxm(B, g.semiring.plus_times).new()]
    rng = np.random.default_rng(3)
    n = 20
    with g.sp():
        As = g.Matrix.from_coo(rng.integers(0, n, 50), rng.integers(0, n, 50), rng.random(50), g.dtypes.FP64, nrows=n, ncols=n, dup_op=g.binary.plus)
        Bs = g.Matrix.from_coo(rng.integers(0, n, 50), rng.integers(0, n, 50), rng.random(50), g.dtypes.FP64, nrows=n, ncols=n, dup_op=g.binary.plus)
        P3 = g.Matrix.from_coo([0, 1], [1, 2], [1.0, 1.0], g.dtypes.FP64, nrows=3, ncols=3)
        Q3 = g.Matrix.from_coo([1, 2], [0, 0], [1.0, 1.0], g.dtypes.FP64, nrows=3, ncols=3)
    out += [As.mxm(Bs, sr).new() for sr in (g.semiring.plus_times, g.semiring.min_plus, g.semiring.max_first)]
    out += [As.T.mxm(As, g.semiring.plus_times).new(), P3.mxm(Q3, g.semiring.min_secondi).new()]
    n = 1 << 30
    r600 = np.arange(600)
    F = g.Matrix.from_coo(r600, np.zeros(600, np.int64), np.ones(600), g.dtypes.FP64, nrows=n, ncols=n)
    G = g.Matrix.from_coo(np.zeros(600, np.int64), r600, np.ones(600), g.dtypes.FP64, nrows=n, ncols=n)
    with g.cfg(spgemm_flop_limit=1000), pytest.raises(g.exc.OutOfMemory, match="flop_limit"):
        F.mxm(G, g.semiring.plus_times).new()
    return out


CASES = [
    huge_vector_storage,
    huge_vector_dup_isequal_dup_op,
    vector_ewise,
    vector_apply_select_reduce,
    vector_inner_and_apply_forced,
    huge_mxv_vxm,
    small_mxv_with_sparse_vector,
    forced_sparse_matches_dense,
    huge_extract,
    extract_duplicate_indices,
    huge_assign_delete,
    huge_vector_assign_delete,
    assign_matches_dense,
    masked_assign_into_sparse,
    unmasked_mxm_cases,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_sparse_vector_and_surgery_match_reference(ref, case):
    run_both(ref, case)


def test_sparse_vector_repr_does_not_densify(ref):
    for g in (sparse_ns(P), sparse_ns(ref)):
        v = _sv(g, [1, 1 << 33], [1.0, 2.0])
        assert "1099511627776" in repr(v) and is_sparse(v)


def test_sparse_vector_device_caches_follow_the_values():
    """A sparse vector's device caches are keyed on the device and dropped
    with the values they hold; a copy with new values shares only the index
    cache."""
    import torch

    v = _sv(sparse_ns(P), [2, 7], [1.0, 2.0])
    sv = v._sparse
    idx, vals = sv.device("idx", "cpu"), sv.device("vals", "cpu")
    assert sv.device("idx", "cpu") is idx and idx.dtype == torch.int64  # 2^40 needs int64
    w = sv.copy(vals=np.array([5.0, 6.0]))
    assert w.device("idx", "cpu") is idx and w.device("vals", "cpu") is not vals
    assert w.device("vals", "cpu").tolist() == [5.0, 6.0] and vals.tolist() == [1.0, 2.0]
