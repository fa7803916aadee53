"""Parity of the port's dense-masked engine (``graphblas_tpu_torch.ops.densemasked``)
with the JAX package's (``graphblas_tpu.ops.densemasked``), function by
function, called directly.

The same numpy (values, struct) pairs, made from a seed, go through both
engines with each package's own typed operators, on the CPU.  Values are
compared as the reference's numpy dtype: integers and bool exactly, floats
bit for bit where both sides compute the same float operations in the same
order (min/max and their signed zeros, the halving tree, the generic
contraction, the tropical matmul), else within 1e-6 relative.  Looser only
for float plus over a matmul (1e-5): ``torch.matmul`` and XLA's dot sum the
k products in their own orders.  The reference sums narrow integers in
int64 (``jnp.sum``) and so does torch; the results agree after the
conversion to the monoid's type, which the comparison applies.

The JAX package is imported by the ``ref`` fixture, not at import time.
``mxm_strategy`` is passed explicitly on both sides, so the test harness's
random draw of it decides nothing here.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as P
from graphblas_tpu_torch.core import dtypes as pdt
from graphblas_tpu_torch.core.operator import get_typed_op as pget
from graphblas_tpu_torch.ops import densemasked as pdm

TYPES = ["BOOL", "INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32", "UINT64", "FP32", "FP64", "FC32", "FC64"]
# one type of each carrier kind: bool, a narrow integer (wraps), UINT16 (a
# masked wider carrier), UINT64 (int64 bits), a float, a complex; each
# reference call compiles per type, so the tests keep to these
CARRIERS = ["BOOL", "INT8", "UINT16", "UINT64", "FP32", "FC64"]
REAL = [t for t in CARRIERS if not t.startswith("FC")]


def reference():
    """The JAX package, its engine and jax.numpy (skips without JAX)."""
    jnp = pytest.importorskip("jax.numpy")
    import graphblas_tpu as R
    from graphblas_tpu.core.operator import get_typed_op as rget
    from graphblas_tpu.ops import densemasked as rdm

    return SimpleNamespace(R=R, jnp=jnp, dm=rdm, get=rget)


@pytest.fixture(scope="module")
def ref():
    return reference()


def values(dtn, shape, rng, special=True):
    """Values of type ``dtn``; floats hold NaN, +-0.0 and +-inf, integers
    their extremes, where ``special``."""
    npt = pdt.lookup_dtype(dtn).np_type
    if npt == np.bool_:
        return rng.random(shape) < 0.5
    if npt.kind in "iu":
        lo = 0 if npt.kind == "u" else -5
        v = rng.integers(lo, 9, shape).astype(npt)
        if special and v.size > 4:
            info = np.iinfo(npt)
            flat = v.reshape(-1)
            flat[rng.integers(0, v.size, 2)] = info.max
            flat[rng.integers(0, v.size, 1)] = info.min if npt.kind == "i" else info.max - 1
        return v
    v = rng.random(shape) * 4 - 1
    if npt.kind == "c":
        v = v + 1j * (rng.random(shape) - 0.5)
    v = v.astype(npt)
    if special and npt.kind == "f" and v.size > 6:
        flat = v.reshape(-1)
        pos = rng.permutation(v.size)[:4]
        flat[pos] = [np.nan, -0.0, 0.0, np.inf]
    return v


def operand(dtn, shape, rng, density=0.6, special=True):
    """A canonical (values, struct) pair: absent cells hold 0."""
    s = rng.random(shape) < density
    v = np.where(s, values(dtn, shape, rng, special), np.zeros((), pdt.lookup_dtype(dtn).np_type))
    return v, s


def both(ref, v, s, dtn):
    """The pair as the reference's arrays and the port's CPU tensors."""
    return (ref.jnp.asarray(v), ref.jnp.asarray(s)), (pdt.to_tensor(v, dtn, "cpu"), torch.from_numpy(np.asarray(s)))


def assert_same(pout, rout, dtn, label, rtol=1e-6, bits=False):
    """``pout`` (port tensors of type ``dtn``) against ``rout`` (reference
    arrays, converted to ``dtn``'s numpy dtype)."""
    dt = pdt.lookup_dtype(dtn)
    pv, ps = pout
    rv, rs = rout
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs), err_msg=f"{label}: structure")
    got = pdt.to_numpy(pv, dt)
    want = np.asarray(rv).astype(dt.np_type)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    if dt.np_type.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=label)
    elif bits and dt.np_type.kind == "c":
        for part in (np.real, np.imag):
            _bits_equal(part(got), part(want), label)
    elif bits:
        _bits_equal(got, want, label)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True, err_msg=label)


def _bits_equal(got, want, label):
    """Equal values with equal signs (so -0.0 != +0.0); NaN for NaN."""
    nan = np.isnan(got) & np.isnan(want)
    np.testing.assert_array_equal(np.where(nan, 0, got), np.where(nan, 0, want), err_msg=label)
    np.testing.assert_array_equal(np.signbit(got) | nan, np.signbit(want) | nan, err_msg=f"{label}: signs")


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

MONOIDS = ["plus", "times", "min", "max", "lor", "land", "any", "bor", "band", "bxor", "lxor", "eq"]


@pytest.mark.parametrize("name", MONOIDS)
def test_reduce_axis_and_all_match_reference(ref, name):
    """reduce_axis (rows, columns) and reduce_all per monoid and type: the
    fast paths (sum, prod, amin/amax in the type's order with jnp's NaN and
    signed-zero rules) and the halving tree for the rest; min/max bit for
    bit."""
    rng = np.random.default_rng(11)
    pm, rm = getattr(P.monoid, name), getattr(ref.R.monoid, name)
    for dtn in CARRIERS + (["INT32", "FP64"] if name in ("min", "max") else []):
        if dtn not in pm:
            continue
        pt, rt = pget(pm, dtn, kind="monoid"), ref.get(rm, dtn, kind="monoid")
        v, s = operand(pt.type_.name, (6, 9), rng)  # the collection layer converts to the monoid's type
        (rv, rs), (pv, ps) = both(ref, v, s, pt.type_.name)
        out = pt.return_type.name
        exact = name in ("min", "max", "any")
        axis = 0 if dtn in ("INT8", "FP32") else 1
        assert_same(pdm.reduce_axis(pv, ps, pt, axis), ref.dm.reduce_axis(rv, rs, rt, axis), out, f"{name}[{dtn}] axis {axis}", bits=exact)
        assert_same(pdm.reduce_all(pv, ps, pt), ref.dm.reduce_all(rv, rs, rt), out, f"{name}[{dtn}] all", bits=exact)


@pytest.mark.parametrize("dtn", ["INT8", "UINT8", "UINT16", "UINT32", "UINT64"])
def test_narrow_integer_sums_wrap_as_the_reference(ref, dtn):
    """jnp.sum promotes INT8/UINT8 to the default int and torch.sum to
    int64; the sums agree after the conversion to the monoid's type."""
    info = np.iinfo(pdt.lookup_dtype(dtn).np_type)
    v = np.full((3, 40), info.max, pdt.lookup_dtype(dtn).np_type)
    s = np.ones_like(v, bool)
    (rv, rs), (pv, ps) = both(ref, v, s, dtn)
    pt, rt = pget(P.monoid.plus, dtn, kind="monoid"), ref.get(ref.R.monoid.plus, dtn, kind="monoid")
    assert_same(pdm.reduce_axis(pv, ps, pt, 1), ref.dm.reduce_axis(rv, rs, rt, 1), dtn, "plus")
    assert_same(pdm.reduce_all(pv, ps, pt), ref.dm.reduce_all(rv, rs, rt), dtn, "plus all")


@pytest.mark.parametrize("width", [1, 2, 7, 37, 128])
def test_pair_reduce_is_the_reference_halving_tree(ref, width):
    """Float32 plus through the halving tree: the same sums in the same
    order, bit for bit."""
    rng = np.random.default_rng(width)
    v, s = operand("FP32", (5, width), rng, special=False)
    (rv, rs), (pv, ps) = both(ref, v, s, "FP32")
    pfn = pget(P.binary.plus, "FP32", kind="binary").fn
    rfn = ref.get(ref.R.binary.plus, "FP32", kind="binary").fn
    assert_same(pdm._pair_reduce(pv, ps, pfn, (1,)), ref.dm._pair_reduce(rv, rs, rfn, (1,)), "FP32", "tree", bits=True)


# ---------------------------------------------------------------------------
# elementwise family
# ---------------------------------------------------------------------------

UNARY = ["identity", "ainv", "abs", "minv", "one", "lnot", "bnot"]


@pytest.mark.parametrize("name", UNARY)
def test_apply_unary_matches_reference(ref, name):
    rng = np.random.default_rng(3)
    for dtn in CARRIERS:
        if dtn not in getattr(P.unary, name):
            continue
        pt, rt = pget(getattr(P.unary, name), dtn, kind="unary"), ref.get(getattr(ref.R.unary, name), dtn, kind="unary")
        v, s = operand(pt.type_.name, (4, 5), rng)
        (rv, rs), (pv, ps) = both(ref, v, s, pt.type_.name)
        assert_same(pdm.apply_unary(pv, ps, pt), ref.dm.apply_unary(rv, rs, rt), pt.return_type.name, f"{name}[{dtn}]")


BOUND = ["plus", "minus", "div", "truediv", "floordiv", "pow", "max", "lt", "second"]


@pytest.mark.parametrize("name", BOUND)
def test_apply_bound_matches_reference(ref, name):
    """A binary op with the scalar bound left and right; integer division
    meets absent cells (0) through the safe fill."""
    rng = np.random.default_rng(5)
    for dtn in REAL:
        pop, rop = getattr(P.binary, name), getattr(ref.R.binary, name)
        if dtn not in pop:
            continue
        pt, rt = pget(pop, dtn, kind="binary"), ref.get(rop, dtn, kind="binary")
        v, s = operand(pt.type_.name, (4, 5), rng, special=False)
        (rv, rs), (pv, ps) = both(ref, v, s, pt.type_.name)
        b = np.asarray(values(pt.type2.name, (), rng, special=False))
        for side in ("left", "right"):
            rb = ref.jnp.asarray(b)
            pb = pdt.scalar_tensor(b, pt.type2, "cpu")
            assert_same(
                pdm.apply_bound(pv, ps, pt, pb, side), ref.dm.apply_bound(rv, rs, rt, rb, side), pt.return_type.name, f"{name}[{dtn}] {side}"
            )


@pytest.mark.parametrize("name", ["rowindex", "colindex", "diagindex", "tril", "triu", "valueeq", "valuegt", "rowle", "colgt", "offdiag"])
def test_apply_indexunary_and_select_match_reference(ref, name):
    rng = np.random.default_rng(7)
    for dtn in ["INT32", "FP64"] if name in ("valueeq", "valuegt") else ["UINT8"]:
        pop, rop = getattr(P.indexunary, name), getattr(ref.R.indexunary, name)
        if dtn not in pop:
            continue
        pt, rt = pget(pop, dtn, kind="indexunary"), ref.get(rop, dtn, kind="indexunary")
        thunk_t = pt.parent._thunk_dtype or pt.type_
        v, s = operand(dtn, (5, 6), rng, special=False)
        (rv, rs), (pv, ps) = both(ref, v, s, dtn)
        th = np.asarray(1, thunk_t.np_type)
        pth, rth = pdt.scalar_tensor(th, thunk_t, "cpu"), ref.jnp.asarray(th)
        assert_same(pdm.apply_indexunary(pv, ps, pt, pth), ref.dm.apply_indexunary(rv, rs, rt, rth), pt.return_type.name, f"{name}[{dtn}]")
        if name in dir(P.select):
            ps_t, rs_t = pget(getattr(P.select, name), dtn, kind="select"), ref.get(getattr(ref.R.select, name), dtn, kind="select")
            assert_same(pdm.select_op(pv, ps, ps_t, pth), ref.dm.select_op(rv, rs, rs_t, rth), dtn, f"select {name}[{dtn}]")
    for op, delta in (("positioni", 0), ("positionj1", 1)):
        pt, rt = pget(getattr(P.unary, op), "INT64", kind="unary"), ref.get(getattr(ref.R.unary, op), "INT64", kind="unary")
        v, s = operand("INT64", (5, 6), rng)
        (rv, rs), (pv, ps) = both(ref, v, s, "INT64")
        assert_same(pdm.apply_positional_unary(pv, ps, pt, 0), ref.dm.apply_positional_unary(rv, rs, rt, 0), pt.return_type.name, op)


EWISE = ["plus", "minus", "div", "min", "max", "second", "lt", "pair", "firsti", "bxor"]


@pytest.mark.parametrize("name", EWISE)
def test_ewise_add_mult_union_match_reference(ref, name):
    rng = np.random.default_rng(13)
    for dtn in CARRIERS:
        pop, rop = getattr(P.binary, name), getattr(ref.R.binary, name)
        if dtn not in pop:
            continue
        pt, rt = pget(pop, dtn, kind="binary"), ref.get(rop, dtn, kind="binary")
        a = operand(pt.type_.name, (4, 6), rng)
        b = operand(pt.type2.name, (4, 6), rng)
        (ra, ras), (pa, pas) = both(ref, *a, pt.type_.name)
        (rb, rbs), (pb, pbs) = both(ref, *b, pt.type2.name)
        out = pt.return_type.name
        exact = name in ("min", "max")
        assert_same(pdm.ewise_add(pa, pas, pb, pbs, pt), ref.dm.ewise_add(ra, ras, rb, rbs, rt), out, f"add {name}[{dtn}]", bits=exact)
        assert_same(pdm.ewise_mult(pa, pas, pb, pbs, pt), ref.dm.ewise_mult(ra, ras, rb, rbs, rt), out, f"mult {name}[{dtn}]", bits=exact)
        ld, rd = np.asarray(values(pt.type_.name, (), rng, False)), np.asarray(values(pt.type2.name, (), rng, False))
        assert_same(
            pdm.ewise_union(pa, pas, pb, pbs, pt, pdt.scalar_tensor(ld, pt.type_, "cpu"), pdt.scalar_tensor(rd, pt.type2, "cpu")),
            ref.dm.ewise_union(ra, ras, rb, rbs, rt, ref.jnp.asarray(ld), ref.jnp.asarray(rd)),
            out,
            f"union {name}[{dtn}]",
            bits=exact,
        )


# ---------------------------------------------------------------------------
# extract / assign
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtn", ["INT64", "FP32", "UINT64", "BOOL", "FC32"])
def test_extract_and_scatter_match_reference(ref, dtn):
    rng = np.random.default_rng(29)
    c = operand(dtn, (6, 7), rng)
    (rc, rcs), (pc, pcs) = both(ref, *c, dtn)
    rows, cols = np.array([4, 0, 2]), np.array([1, 6, 3, 3])
    assert_same(pdm.extract_matrix(pc, pcs, rows, cols), ref.dm.extract_matrix(rc, rcs, ref.jnp.asarray(rows), ref.jnp.asarray(cols)), dtn, "extract")
    assert_same(pdm.extract_vector(pc[2], pcs[2], cols), ref.dm.extract_vector(rc[2], rcs[2], ref.jnp.asarray(cols)), dtn, "extract row")
    a = operand(dtn, (3, 3), rng)
    (ra, ras), (pa, pas) = both(ref, *a, dtn)
    rows, cols = np.array([5, 1, 3]), np.array([0, 4, 2])
    p_out = pdm.scatter_region_matrix(pc, pcs, rows, cols, pa, pas)
    r_out = ref.dm.scatter_region_matrix(rc, rcs, ref.jnp.asarray(rows), ref.jnp.asarray(cols), ra, ras)
    assert_same(p_out[:2], r_out[:2], dtn, "scatter")
    np.testing.assert_array_equal(p_out[2].numpy(), np.asarray(r_out[2]))
    p_out = pdm.scatter_region_matrix_contig(pc, pcs, pa, pas, rstart=2, cstart=4)
    r_out = ref.dm.scatter_region_matrix_contig(rc, rcs, ra, ras, rstart=2, cstart=4)
    assert_same(p_out[:2], r_out[:2], dtn, "scatter contig")
    np.testing.assert_array_equal(p_out[2].numpy(), np.asarray(r_out[2]))
    v = operand(dtn, (9,), rng)
    x = operand(dtn, (3,), rng)
    (rv, rvs), (pv, pvs) = both(ref, *v, dtn)
    (rx, rxs), (px, pxs) = both(ref, *x, dtn)
    idx = np.array([8, 0, 4])
    p_out = pdm.scatter_region_vector(pv, pvs, idx, px, pxs)
    r_out = ref.dm.scatter_region_vector(rv, rvs, ref.jnp.asarray(idx), rx, rxs)
    assert_same(p_out[:2], r_out[:2], dtn, "scatter vector")
    p_out = pdm.scatter_region_vector_contig(pv, pvs, px, pxs, start=5)
    r_out = ref.dm.scatter_region_vector_contig(rv, rvs, rx, rxs, start=5)
    assert_same(p_out[:2], r_out[:2], dtn, "scatter vector contig")
    np.testing.assert_array_equal(p_out[2].numpy(), np.asarray(r_out[2]))
    for idx, dim in ((np.array([2, 3, 4]), 9), (np.array([2, 4]), 9), (np.array([7, 8, 9]), 9), (np.array([], np.int64), 9)):
        assert pdm._contig_start(idx, dim) == ref.dm._contig_start(idx, dim)
    # the inputs are untouched (every function returns new tensors)
    np.testing.assert_array_equal(pcs.numpy(), c[1])
    np.testing.assert_array_equal(pdt.to_numpy(pc, pdt.lookup_dtype(dtn)), c[0])


# ---------------------------------------------------------------------------
# positional reductions and structure ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtn", ["BOOL", "INT8", "UINT16", "UINT64", "FP32"])
def test_argminmax_and_firstlast_match_reference(ref, dtn):
    rng = np.random.default_rng(37)
    v, s = operand(dtn, (5, 8), rng, 0.5)
    s[3] = False  # an empty row
    v = np.where(s, v, np.zeros((), v.dtype))
    (rv, rs), (pv, ps) = both(ref, v, s, dtn)
    dt = pdt.lookup_dtype(dtn)
    for which in ("min", "max"):
        for axis in (0, 1):
            assert_same(pdm.argminmax_axis(pv, ps, which, axis, dt), ref.dm.argminmax_axis(rv, rs, which, axis), "INT64", f"arg{which} {axis}")
    for which in ("first", "last"):
        for axis in (0, 1):
            pvals, pidx, pss = pdm.firstlast_axis(pv, ps, which, axis)
            rvals, ridx, rss = ref.dm.firstlast_axis(rv, rs, which, axis)
            assert_same((pidx, pss), (ridx, rss), "INT64", f"{which} index {axis}")
            assert_same((pvals, pss), (rvals, rss), dtn, f"{which} value {axis}", bits=True)


@pytest.mark.parametrize("dtn", ["FP64", "UINT64"])
def test_structure_ops_match_reference(ref, dtn):
    rng = np.random.default_rng(41)
    v, s = operand(dtn, (5, 7), rng)
    (rv, rs), (pv, ps) = both(ref, v, s, dtn)
    assert_same(pdm.transpose(pv, ps), ref.dm.transpose(rv, rs), dtn, "transpose", bits=True)
    assert_same(pdm.flatten_matrix(pv, ps), ref.dm.flatten_matrix(rv, rs), dtn, "flatten", bits=True)
    for off in ((1, 2), (-2, 0), (0, -3), (4, -6)):
        assert_same(pdm.reposition_matrix(pv, ps, *off), ref.dm.reposition_matrix(rv, rs, *off), dtn, f"reposition {off}", bits=True)
    for k in (-2, 0, 3):
        assert_same(pdm.diag_extract(pv, ps, k), ref.dm.diag_extract(rv, rs, k), dtn, f"diag {k}", bits=True)
        x = operand(dtn, (4,), rng)
        (rx, rxs), (px, pxs) = both(ref, *x, dtn)
        n = 4 + abs(k)
        assert_same(pdm.diag_build(px, pxs, k, n, n), ref.dm.diag_build(rx, rxs, k, n, n), dtn, f"diag build {k}", bits=True)


@pytest.mark.parametrize("name", ["plus", "min", "times", "bxor"])
def test_prefix_scan_matches_reference(ref, name):
    """The reference's associative_scan recursion, ported step for step:
    float32 plus bit for bit, odd and even lengths."""
    rng = np.random.default_rng(43)
    for dtn in ["FP32", "UINT32"]:
        if dtn not in getattr(P.monoid, name):
            continue
        pt, rt = pget(getattr(P.monoid, name), dtn, kind="monoid"), ref.get(getattr(ref.R.monoid, name), dtn, kind="monoid")
        for shape in ((4, 9), (3, 16)):
            v, s = operand(dtn, shape, rng, special=False)
            (rv, rs), (pv, ps) = both(ref, v, s, dtn)
            for axis in (0, 1):
                assert_same(pdm.prefix_scan(pv, ps, pt, axis), ref.dm.prefix_scan(rv, rs, rt, axis), dtn, f"scan {name}[{dtn}] {shape} {axis}", bits=True)


def test_engine_functions_are_pure():
    """No engine function writes into its inputs: the tensors a collection
    shares with a dup(), a mask or an expression operand keep their values."""
    rng = np.random.default_rng(47)
    v, s = operand("INT32", (4, 4), rng)
    pv, ps = pdt.to_tensor(v, "INT32", "cpu"), torch.from_numpy(s.copy())
    versions = (pv._version, ps._version)
    plus = pget(P.binary.plus, "INT32", kind="binary")
    pdm.masked_merge(pv, ps, pv, ~ps, ps, plus, True, True, c_type=pdt.INT32, z_type=pdt.INT32)
    pdm.scatter_region_matrix(pv, ps, np.array([0, 1]), np.array([2]), pv[:2, :1], ps[:2, :1])
    pdm.diag_extract(pv, ps, 0)
    pdm.reduce_axis(pv, ps, pget(P.monoid.plus, "INT32", kind="monoid"), 1)
    assert (pv._version, ps._version) == versions
    np.testing.assert_array_equal(pv.numpy(), v)
    np.testing.assert_array_equal(ps.numpy(), s)
