"""op x mask x accum x replace sweeps on the sparse format, in both packages,
case for case with ``tests/test_sparse_sweeps.py``.

Each sweep point forces sparse storage for the operands (``dense_limit=0``
on both packages) and drives a real masked, accumulated update; the port's
result equals the reference's (through ``to_coo()``: indices exactly, float
values within 1e-6 relative), and in each package the sparse operands give
what the dense ones give.  The helpers are ``test_torch_sparse.py``'s.
"""

import numpy as np
import pytest
from test_torch_sparse import compare, is_sparse, pinned, ref, sparse_ns  # noqa: F401

import graphblas_tpu_torch as P


def _mk(g, seed, n=12, e=40, sparse=False, dtype=None):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, e), rng.integers(0, n, e)
    v = (rng.random(e) * 8).round(2) + 0.5
    dtype = g.dtypes.FP64 if dtype is None else dtype
    with (g.sp() if sparse else g.cfg()):
        return g.Matrix.from_coo(r, c, v, dtype, nrows=n, ncols=n, dup_op=g.binary.plus)


def _mkv(g, seed, n=12, k=7, sparse=False):
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n, k, replace=False))
    v = (rng.random(k) * 8).round(2) + 0.5
    with (g.sp() if sparse else g.cfg()):
        return g.Vector.from_coo(idx, v, g.dtypes.FP64, size=n)


MASK_KINDS = ["S", "V", "~S", "~V", None]
ACCUMS = [None, "plus", "min"]


def _mask(parent, kind):
    if kind is None:
        return None
    m = parent.S if kind.endswith("S") else parent.V
    return ~m if kind.startswith("~") else m


def _update(target, m, accum, replace, expr):
    if m is not None:
        target(m, accum=accum, replace=replace) << expr
    else:
        target(accum=accum) << expr
    return target


def both(ref, fn):
    outs = [fn(sparse_ns(pkg)) for pkg in (P, ref)]
    compare(*outs, fn.__name__)
    return outs


@pytest.mark.parametrize("mask_kind", MASK_KINDS)
@pytest.mark.parametrize("accum", ACCUMS, ids=["none", "plus", "min"])
def test_sweep_sparse_ewise_add_masked(ref, mask_kind, accum):
    def case(g):
        acc = getattr(g.binary, accum) if accum else None
        mb = _mk(g, 7, dtype=g.dtypes.BOOL)
        out = []
        for replace in (False, True):
            if replace and mask_kind is None:
                continue
            for sparse in (False, True):
                c = _mk(g, 101, e=25)  # a dense target; the operands sparse
                expr = _mk(g, 2, sparse=sparse).ewise_add(_mk(g, 3, sparse=sparse), g.binary.plus)
                out.append(_update(c, _mask(mb, mask_kind), acc, replace, expr))
            assert out[-1].isequal(out[-2])
        return out

    both(ref, case)


@pytest.mark.parametrize("mask_kind", MASK_KINDS)
@pytest.mark.parametrize("srname", ["plus_times", "min_plus", "max_first"])
def test_sweep_sparse_mxv_masked(ref, mask_kind, srname):
    def case(g):
        sr = getattr(g.semiring, srname)
        vb = _mkv(g, 8)
        out = []
        for sparse in (False, True):
            w = _mkv(g, 11)
            A, x = _mk(g, 4, sparse=sparse), _mkv(g, 5, sparse=sparse)
            out.append(_update(w, _mask(vb, mask_kind), g.binary.plus if mask_kind else None, False, A.mxv(x, sr)))
        assert out[0].isclose(out[1], rel_tol=1e-12)
        return out

    both(ref, case)


@pytest.mark.parametrize("mask_kind", MASK_KINDS)
def test_sweep_sparse_apply_select_masked(ref, mask_kind):
    def case(g):
        mb = _mk(g, 9, dtype=g.dtypes.BOOL)
        out = []
        for name in ("apply", "select"):
            for sparse in (False, True):
                a = _mk(g, 6, sparse=sparse)
                expr = a.apply(g.unary.sqrt) if name == "apply" else a.select("value>2")
                out.append(_update(_mk(g, 102, e=25), _mask(mb, mask_kind), None, mask_kind is not None, expr))
            assert out[-1].isequal(out[-2])
        return out

    both(ref, case)


@pytest.mark.parametrize("accum", ACCUMS, ids=["none", "plus", "min"])
def test_sweep_sparse_assign_region_accum(ref, accum):
    def case(g):
        acc = getattr(g.binary, accum) if accum else None
        out = []
        for sparse in (False, True):
            c = _mk(g, 10, sparse=sparse)
            val = g.Matrix.from_coo([0, 1], [0, 1], [5.0, 6.0], g.dtypes.FP64, nrows=2, ncols=2)
            c(accum=acc)[[2, 5], [1, 3]] = val
            c(accum=acc)[7, [0, 4, 4]] = g.Vector.from_coo([0, 2], [1.0, 2.0], size=3)
            assert is_sparse(c) == sparse
            out.append(c)
        assert out[0].isequal(out[1])
        return out

    both(ref, case)


def test_sweep_sparse_reduce_all_monoids(ref):
    def case(g):
        out = []
        for mon in (g.monoid.plus, g.monoid.min, g.monoid.max, g.monoid.times):
            for sparse in (False, True):
                a = _mk(g, 12, sparse=sparse)
                out += [a.reduce_scalar(mon).new(), a.reduce_rowwise(mon).new(), a.reduce_columnwise(mon).new()]
            for i in range(-3, 0):
                assert out[i].isclose(out[i - 3], rel_tol=1e-12) if i > -3 else out[i].value == pytest.approx(out[i - 3].value)
        return out

    both(ref, case)


def test_sweep_sparse_transpose_ops(ref):
    def case(g):
        out = []
        x = _mkv(g, 14)
        for sparse in (False, True):
            a = _mk(g, 13, sparse=sparse)
            out += [a.T.mxv(x, g.semiring.plus_times).new(), a.T.ewise_mult(a, g.binary.times).new(), a.T.reduce_rowwise().new()]
        return out

    both(ref, case)
