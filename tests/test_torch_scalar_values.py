"""A Scalar's host value and ``build_spmv_plan``'s range error, against the JAX
package's (ROADMAP section 3, F1 and F2, closed).

F1: a Scalar assigned from a Scalar, and every aggregator through the same
update, held a (1,) array where the reference holds a numpy scalar.  Each case
compares the type, shape and value of ``.value`` with the reference's on the
same statement (values exactly: the inputs are small integers in float).
F2: ``build_spmv_plan`` raised ``IndexError`` where the reference raises its
``IndexOutOfBound``.

The port runs on the CPU; the JAX package is imported by the ``ref`` fixture.
"""

import numpy as np
import pytest

import graphblas_tpu_torch as P

AGGS = ["mean", "argmax", "argmin", "first", "last", "first_index", "sum", "count"]


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import graphblas_tpu as R

    return R


@pytest.fixture(autouse=True)
def on_the_cpu():
    with P.tx.config.set(platform="cpu"):
        yield


def same_value(p, r):
    """The port's ``.value`` is the reference's: type, shape and value."""
    assert type(p) is type(r), (type(p), type(r))
    assert np.shape(p) == np.shape(r) == ()
    assert np.asarray(p).dtype == np.asarray(r).dtype
    assert p == r


@pytest.mark.parametrize("accum", [False, True])
def test_scalar_from_scalar(ref, accum):
    def run(gb):
        t = gb.Scalar.from_value(1.25)
        if accum:
            t(accum=gb.binary.plus) << gb.Scalar.from_value(3.5)
        else:
            t << gb.Scalar.from_value(3.5)
        return t.value

    same_value(run(P), run(ref))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("name", AGGS)
def test_vector_aggregators(ref, name, sparse):
    def run(gb):
        with gb.tx.config.set(dense_limit=0 if sparse else 1 << 24):
            v = gb.Vector.from_coo([0, 3, 5, 8], [4.0, 9.0, 1.0, 9.0], size=10)
            assert (v._sparse is not None) == sparse
            s = v.reduce(getattr(gb.agg, name)).new()
            into = gb.Scalar(s.dtype)
            into << v.reduce(getattr(gb.agg, name))
            return s.value, into.value

    for p, r in zip(run(P), run(ref)):
        same_value(p, r)


@pytest.mark.parametrize("name", ["mean", "argmax"])
def test_matrix_reduce_scalar(ref, name):
    def run(gb):
        A = gb.Matrix.from_coo([0, 1, 2, 2], [1, 0, 2, 3], [2.0, 7.0, 1.0, 6.0], nrows=3, ncols=4)
        s = gb.Scalar(gb.dtypes.FP64 if name == "mean" else gb.dtypes.INT64)
        s << A.reduce_scalar(getattr(gb.agg, name))
        return s.value

    same_value(run(P), run(ref))


def test_compiled_function_returns_a_0d_scalar(ref):
    """Inside a compiled function a Scalar keeps a 0-d device value
    (``Scalar._device_value``), and the result reads back as a numpy scalar."""

    def run(gb):
        @gb.compile
        def fn(x):
            s = gb.Scalar.from_value(2.5)
            t = gb.Scalar(gb.dtypes.FP64)
            t << s
            t(accum=gb.binary.plus) << x.reduce(gb.monoid.plus)
            if gb is P:
                assert tuple(t._device_value().shape) == ()
            return t

        x = gb.Vector.from_dense(np.arange(4, dtype=np.float64))
        return fn(x).value, fn(x).value

    for p, r in zip(run(P), run(ref)):
        # the reference's compiled result holds a 0-d jax array, the port's a numpy scalar
        assert np.shape(p) == np.shape(r) == ()
        assert np.asarray(p).dtype == np.asarray(r).dtype
        assert p == float(r) == 8.5


@pytest.mark.parametrize(
    "src, dst", [([0, 70], [1, 2]), ([0, 1], [-1, 2]), ([-3, 1], [1, 64])], ids=["past-n", "negative-dst", "both"]
)
def test_build_spmv_plan_range_error(ref, src, dst):
    from graphblas_tpu.ops.fastspmv import build_spmv_plan as ref_build

    from graphblas_tpu_torch.ops.fastspmv import build_spmv_plan

    with pytest.raises(ref.exceptions.IndexOutOfBound) as r:
        ref_build(np.array(src), np.array(dst), None, n=64)
    with pytest.raises(P.exceptions.IndexOutOfBound) as p:
        build_spmv_plan(np.array(src), np.array(dst), None, n=64, device="cpu")
    assert not isinstance(p.value, IndexError)
    assert str(p.value) == str(r.value)
