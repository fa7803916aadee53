"""Parity of the port's DSL with the JAX package's: infix expressions,
operator calls on collections (``_call_op``), the aggregator recipes,
extract / assign / delete (with masks, accumulators, subassign and
input masks), the arithmetic dunders, ``Recorder`` strings, and the
reference's intro examples (``examples/01``-``07``, ``09``, ``10``) run
through the port.

Each test builds the same collections in both packages from seeded numpy
COO arrays and runs the same statements on both; results are compared
through ``to_coo()`` as in ``test_torch_collections.py`` (its helpers):
integers and bool exactly, floats within 1e-6 relative (1e-5 for a float
plus over a matmul, summed in torch's and XLA's own orders).  The port runs
on the CPU; ``mxm_strategy`` is pinned on both packages and parametrized
where it selects a path, ``mapnumpy`` is on in both.  The JAX package is
imported by the ``ref`` fixture, not at import time.
"""

import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
from test_torch_collections import assert_same, make_matrix, make_vector, matrix_coo, ns, pinned  # noqa: F401

import graphblas_tpu_torch as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import graphblas_tpu as R

    return R


def run_both(ref, fn, strategy="auto"):
    outs = []
    for pkg in (P, ref):
        with pkg.tx.config.set(mxm_strategy=strategy):
            outs.append(fn(ns(pkg)))
    return outs


def compare_all(pouts, routs, rtol=1e-6):
    assert len(pouts) == len(routs)
    for i, (p, r) in enumerate(zip(pouts, routs)):
        if isinstance(r, (bool, int, float, str, tuple, list, type(None))):
            assert p == r, (i, p, r)
        else:
            assert_same(p, r, f"#{i}", rtol=rtol)


def operands(seed):
    rng = np.random.default_rng(seed)
    return SimpleNamespace(
        a=matrix_coo(rng, 5, 6, "FP64"), b=matrix_coo(rng, 6, 5, "FP64"), c=matrix_coo(rng, 5, 6, "FP64"),
        i=matrix_coo(rng, 5, 6, "INT32"), x=(np.array([0, 2, 5]), np.array([1.5, -2.0, 3.0])),
        y=(np.array([1, 2, 4]), np.array([2.0, 0.5, -1.0])),
    )


def build(g, d):
    return (
        make_matrix(g.gb, d.a, "FP64", 5, 6, "A"), make_matrix(g.gb, d.b, "FP64", 6, 5, "B"),
        make_matrix(g.gb, d.c, "FP64", 5, 6, "C"), make_matrix(g.gb, d.i, "INT32", 5, 6, "I"),
        make_vector(g.gb, d.x, "FP64", 6, "x"), make_vector(g.gb, d.y, "FP64", 6, "y"),
    )


# ---------------------------------------------------------------------------
# infix and operator calls
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["auto", "generic"])
def test_infix_expressions_match_reference(ref, strategy):
    d = operands(1)

    def run(g):
        A, B, C, I, x, y = build(g, d)
        bA = make_matrix(g.gb, (d.a[0], d.a[1], d.a[2] > 0), "BOOL", 5, 6)
        return [
            (A @ B).new(), (A @ x).new(), (B @ make_vector(g.gb, d.y, "FP64", 5)).new(),
            (x @ y).new(), g.binary.plus(A | C).new(), g.binary.times(A & C).new(), g.binary.minus(A | C, left_default=1, right_default=2).new(),
            (bA | bA).new(), (bA & bA).new(), g.semiring.min_plus(A @ B).new(),
            g.monoid.max(A | C).new(), (A @ B.T.T).new(),
            (A + C).new(), (A - C).new(), (A * C).new(), (A / C).new(), (A + 1).new(), (2 * A).new(), (A ** 2).new(), (-A).new(),
            abs(A).new(), (A > 0).new(), (A == C).new(), (1 - A).new(), (I // 3).new(), (I % 4).new(), (~bA).new(),
            (x + y).new(), (x < y).new(), (A @ B).new().nvals,
        ]

    compare_all(*run_both(ref, run, strategy), rtol=1e-5)


def test_operator_calls_match_reference(ref):
    """``_call_op``: every operator kind called on collections and infix
    expressions, bound with a scalar on either side."""
    d = operands(2)

    def run(g):
        A, B, C, I, x, y = build(g, d)
        return [
            g.unary.abs(A).new(), g.unary.ainv[g.dtypes.FP64](x).new(), g.binary.plus(A, 1).new(), g.binary.minus(3, A).new(),
            g.binary.plus(x | y).new(), g.binary.plus[g.dtypes.FP64](x & y).new(), g.monoid.min(x | y).new(), g.semiring.plus_times(A @ B).new(),
            g.indexunary.rowindex(A).new(), g.indexunary.tril(A, 1).new(), g.select.tril(A).new(), g.select.valuegt(A, 0.5).new(),
            g.select.rowle(I, 2).new(), g.binary.max(x, 0.0).new(), g.unary.one(I).new(),
        ]

    compare_all(*run_both(ref, run))
    A = P.Matrix.from_coo([0], [1], [2.0], nrows=2, ncols=2)
    for bad in (lambda: P.binary.plus(A), lambda: P.binary.plus(A, A), lambda: P.binary.plus(1, 2)):
        with pytest.raises(TypeError):
            bad()


# ---------------------------------------------------------------------------
# aggregators
# ---------------------------------------------------------------------------

AGGS = sorted(P.agg._ops)


@pytest.mark.parametrize("name", AGGS)
def test_aggregators_match_reference(ref, name):
    """Every aggregator recipe (monoid family, composite finalizers,
    argmin/argmax/first/last) rowwise, columnwise, to a scalar and over a
    vector, and through ``agg(...)`` calls and masked/accumulated updates."""
    rng = np.random.default_rng(AGGS.index(name))
    a = matrix_coo(rng, 5, 4, "FP64", 0.5)
    a[2][::3] = np.abs(a[2][::3]) + 0.5
    ia = matrix_coo(rng, 5, 4, "INT64", 0.5)

    def run(g):
        agg = getattr(g.agg, name)
        out = []
        for dtn, coo in (("FP64", a), ("INT64", ia)):
            if getattr(g.dtypes, dtn) not in agg:
                continue
            A = make_matrix(g.gb, coo, dtn, 5, 4, "A")
            v = A[:, 1].new()
            out += [A.reduce_rowwise(agg).new(), A.reduce_columnwise(agg).new(), A.reduce_scalar(agg).new(), v.reduce(agg).new()]
            out += [agg(v).new(), agg(A, rowwise=True).new(), agg(A.T, columnwise=True).new()]
            w = g.Vector.from_coo([0, 4], [1, 1], getattr(g.dtypes, dtn), size=5)
            w(w.S, accum=g.binary.plus) << A.reduce_rowwise(agg)
            out.append(w)
        return out

    compare_all(*run_both(ref, run), rtol=1e-9)


# ---------------------------------------------------------------------------
# extract / assign / delete
# ---------------------------------------------------------------------------


def test_extract_matches_reference(ref):
    d = operands(3)

    def run(g):
        A, B, C, I, x, y = build(g, d)
        M = make_matrix(g.gb, d.i, "INT32", 5, 6, "M")
        return [
            A[[0, 3], [1, 2, 5]].new(), A[1:4, ::2].new(), A[2, :].new(), A[:, 3].new(), A[-1, [0, 5]].new(), A[1, 1].new(),
            x[[5, 0, 2]].new(), x[1:].new(), x[2].new(), A.T[1, :].new(), A[[0, 2], :].new(mask=C[[0, 2], :].new().S),
            A[1:3, :].new(input_mask=M.S), A[2, :].new(input_mask=M.V), x[[0, 2]].new(input_mask=y.S), A[3, 4].value, x.get(5), A[0, 0].new().is_empty,
        ]

    compare_all(*run_both(ref, run))


ASSIGNS = {
    "scalar_region": lambda g, A, B, x, M, v: A.__setitem__((slice(1, 3), [0, 4]), 7.5),
    "matrix_region": lambda g, A, B, x, M, v: A.__setitem__(([0, 2], [1, 3]), B[[1, 2], [0, 4]].new()),
    "row_vector": lambda g, A, B, x, M, v: A.__setitem__((2, slice(None)), v),
    "col_vector": lambda g, A, B, x, M, v: A.__setitem__((slice(None), 1), g.Vector.from_coo([0, 4], [1.0, 2.0], size=5)),
    "masked_assign": lambda g, A, B, x, M, v: A(M.S).__setitem__((slice(None), slice(None)), 3.0),
    "masked_replace": lambda g, A, B, x, M, v: A(~M.S, replace=True).__setitem__(([1, 2], [2, 3]), 4.0),
    "accum_assign": lambda g, A, B, x, M, v: A(accum=g.binary.plus).__setitem__(([0, 1], slice(0, 3)), B[[0, 1], 0:3].new()),
    "subassign_mask": lambda g, A, B, x, M, v: A[[1, 3], [0, 2]](M[[1, 3], [0, 2]].new().V) << 9.0,
    "subassign_accum": lambda g, A, B, x, M, v: A[0, :](accum=g.binary.max) << v,
    "subassign_replace": lambda g, A, B, x, M, v: A[1:4, 1:4](M[1:4, 1:4].new().S, replace=True) << B[0:3, 0:3].new(),
    "vector_assign": lambda g, A, B, x, M, v: x.__setitem__([0, 3], 5.0),
    "vector_masked": lambda g, A, B, x, M, v: x(v.S).__setitem__(slice(None), 1.0),
    "vector_list": lambda g, A, B, x, M, v: x.__setitem__([1, 4], [6.0, 7.0]),
    "empty_scalar": lambda g, A, B, x, M, v: A.__setitem__((0, slice(None)), g.Scalar(g.dtypes.FP64)),
    "delete": lambda g, A, B, x, M, v: A.__delitem__((1, 2)),
    "delete_region": lambda g, A, B, x, M, v: A.__delitem__((slice(0, 2), [0, 1])),
    "masked_delete": lambda g, A, B, x, M, v: A(M.S).__delitem__((slice(None), slice(None))),
    "vector_delete": lambda g, A, B, x, M, v: x.__delitem__([2, 5]),
    "update_extract": lambda g, A, B, x, M, v: x(accum=g.binary.plus) << A[3, :].new(),
    "setdiag": lambda g, A, B, x, M, v: A.setdiag(2.0, 1),
    "setdiag_vector": lambda g, A, B, x, M, v: A.setdiag(g.Vector.from_coo([0, 2], [3.0, 4.0], size=5), 0, accum=g.binary.plus),
}


@pytest.mark.parametrize("case", sorted(ASSIGNS))
def test_assign_and_delete_match_reference(ref, case):
    d = operands(4)

    def run(g):
        A = make_matrix(g.gb, d.a, "FP64", 5, 6, "A")
        B = make_matrix(g.gb, (d.c[0], d.c[1], d.c[2]), "FP64", 5, 6, "B")
        M = make_matrix(g.gb, d.i, "INT32", 5, 6, "M")
        x = make_vector(g.gb, d.x, "FP64", 6, "x")
        v = make_vector(g.gb, d.y, "FP64", 6, "v")
        ASSIGNS[case](g, A, B, x, M, v)
        return [A, x]

    compare_all(*run_both(ref, run))


# ---------------------------------------------------------------------------
# the rest of the DSL surface
# ---------------------------------------------------------------------------


def test_methods_match_reference(ref):
    d = operands(5)

    def run(g):
        A, B, C, I, x, y = build(g, d)
        out = [
            A.kronecker(make_matrix(g.gb, (np.array([0, 1]), np.array([1, 0]), np.array([2.0, 3.0])), "FP64", 2, 2), g.binary.times).new(),
            x.outer(y, g.binary.minus).new(), x.inner(y).new(), A.mxv(x, "min_plus").new(), x.vxm(B, g.semiring.max_first).new(),
            A.ewise_union(C, "minus", 0.5, 1.5).new(), A.apply("abs").new(), A.apply(g.binary.times, right=2).new(), A.apply("rowindex", 1).new(),
            A.select(">", 0.2).new(), A.select("row<=", 2).new(), A.select(C.V).new(), A.reduce_rowwise("max").new(), A.reduce_scalar(g.binary.plus).new(),
            I.reduce_columnwise(g.monoid.bxor).new(), I.reduce_scalar("min").new(), A.T.reduce_rowwise().new(), I.apply(g.unary.positioni).new(),
            A.ewise_add(x, g.binary.plus).new(), x.ewise_mult(A.T, g.binary.times).new(), A.dup(g.dtypes.INT16), A.T.new(mask=C.T.new().S),
            A.mxm(B, g.semiring.plus_times).new(g.dtypes.FP32), A.mxm(B).new(),
            I.apply(lambda v: v * 2 + 1).new(), A.select(g.select.valuegt, 0.0).new(mask=~C.S),
        ]
        s = g.Scalar(g.dtypes.FP64)
        s << x.inner(y)
        s(accum=g.binary.plus) << x.reduce()
        out.append(s)
        z = g.Vector(g.dtypes.FP64, 5)
        z(x[:5].new().S) << A.mxv(x)
        z << A.mxv(x, g.semiring.any_pair)
        out.append(z)
        return out

    compare_all(*run_both(ref, run), rtol=1e-5)


def test_recorder_strings_match_reference(ref):
    """The Recorder's lines: each engine call with its operator and operand
    names, the same strings in both packages."""
    d = operands(6)

    def run(g):
        A, B, C, I, x, y = build(g, d)
        with g.gb.Recorder() as rec:
            D = A.mxm(B, g.semiring.min_plus).new(name="D")
            D(D.S, accum=g.binary.plus) << A.mxm(B)
            x(accum=g.binary.min) << A.T.mxv(make_vector(g.gb, d.y, "FP64", 5, "w"), g.semiring.min_plus)
            A[0, 1] = 3.0
            del A[1, 1]
            A.reduce_rowwise(g.monoid.max).new(name="r")
            g.binary.plus(A | C).new(name="u")
        return list(rec.data), len(rec), rec.is_recording

    p, r = run_both(ref, run)
    assert p == r and p[0]


EXAMPLES = [
    "01_sssp.py",
    "02_level_bfs.py",
    "03_parent_bfs.py",
    "04_pagerank.py",
    "05_triangle_count.py",
    "06_compiled_models.py",
    "07_sparse_pagerank.py",
    "08_multichip.py",
    "09_components_louvain.py",
    "10_compiled_dsl_loops.py",
]


def _printed_numbers(out):
    return [(line.split(":")[0], float(line.split(":")[1])) for line in out.strip().splitlines()]


@pytest.mark.parametrize("example", EXAMPLES)
def test_examples_run_on_the_port(example, capsys, request):
    """The reference's intro recipes, with only the package name changed,
    run on the port (each asserts its own result and prints OK; example 10,
    the compiled loops, prints its results, held to the reference's run of
    the same file: counts exactly, the PageRank mass within 1e-6)."""
    src = open(os.path.join(REPO, "examples", example)).read()
    port_src = re.sub(r"\bgraphblas_tpu\b", "graphblas_tpu_torch", src)
    exec(compile(port_src, example, "exec"), {"__name__": "__main__"})  # noqa: S102
    out = capsys.readouterr().out
    if " OK" in out:
        return
    request.getfixturevalue("ref")
    exec(compile(src, example, "exec"), {"__name__": "__main__"})  # noqa: S102
    got, want = _printed_numbers(out), _printed_numbers(capsys.readouterr().out)
    assert [k for k, _ in got] == [k for k, _ in want] and len(got) == 3
    for (key, a), (_, b) in zip(got, want):
        assert a == pytest.approx(b, rel=1e-6) if key.startswith("pagerank") else a == b, (key, a, b)


@pytest.mark.parametrize("strategy", ["mxu", "generic", "pallas"])
def test_descriptor_opts_and_burble_match_reference(ref, strategy, capsys):
    """Per-call descriptor opts (``mxm_strategy`` through ``new(**opts)`` and
    ``update``) select the same path as the config, unknown opts raise, and
    the burble lines are the reference's."""
    d = operands(7)

    def run(g):
        import importlib

        importlib.import_module(f"{g.gb.__name__}.core.descriptor")
        A, B, C, I, x, y = build(g, d)
        out = [A.mxm(B, g.semiring.min_plus).new(mxm_strategy=strategy), I.mxm(I.T, g.semiring.plus_times).new(nthreads=4)]
        z = g.Vector(g.dtypes.FP64, 5)
        z.update(A.mxv(x, g.semiring.plus_times), mxm_strategy=strategy)
        out.append(z)
        with pytest.raises(ValueError):
            A.mxm(B).new(not_an_option=1)
        desc = g.gb.core.descriptor.descriptor_lookup(mask_structure=True, output_replace=True, mxm_strategy=strategy)
        capsys.readouterr()
        with g.gb.tx.config.set(burble=True):
            C(A.S) << A.ewise_add(C, g.binary.plus)
        out.append((desc._name, desc.opts == {"mxm_strategy": strategy}, capsys.readouterr().out))
        return out

    p, r = run_both(ref, run)
    compare_all(p, r, rtol=1e-5)
