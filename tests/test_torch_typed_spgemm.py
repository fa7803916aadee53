"""The port's typed masked SpGEMM and ``_combine_dups``
(``graphblas_tpu_torch.core.sparse``) against the JAX package's: every add x
mul pair of builtin operators the reference takes against the reference's
operators, each monoid and user operators against the reference's engine,
and typed, untyped and UDF dup_ops against the reference's.

For each pair, C(M) = A (+).(x) A^T on a 12-vertex random matrix and a
40-entry mask runs through ``graphblas_tpu_torch.core.sparse``'s
``sparse_mxm_masked`` (its eqjoin kernel's plain version where the pair is
the kernel's, else the plain bucket path, in the multiply's own input
types), and the oracle applies the reference's typed multiply to every
matching (A[i, k], A[j, k]) and folds each entry's products with the
reference's typed monoid, k ascending, eagerly on jnp arrays (``any`` as
the reference's engine reduces it, by max).  The
reference's own ``sparse_mxm_masked`` jit-compiles a program per semiring,
about a second each on the CPU, so the engine-to-engine parity is held per
monoid in tests/test_torch_typed_engine.py and here the reference's
operators are the spec.  Each pair runs at the first of INT32, FP32, BOOL,
UINT16, FC32 its semiring takes, and, for the monoids of ``UNSIGNED_TOO``,
at UINT64 where it takes that.
Positional multiplies are left out: the reference's SpGEMM has no index
source for them.  Values: integers and bool bit for bit, floats within 1e-6
relative (sums reorder).
"""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest

import graphblas_tpu_torch as P
from graphblas_tpu_torch.core import dtypes as pdt
from graphblas_tpu_torch.core import sparse as ps
from graphblas_tpu_torch.core.operator import get_semiring

MONOIDS = sorted(P.monoid._ops)
MULS = sorted(n for n, op in P.binary._ops.items() if hasattr(op, "types") and op.positional is None)


@pytest.fixture(scope="module")
def ref():
    jnp = pytest.importorskip("jax.numpy")
    import graphblas_tpu as R
    from graphblas_tpu.core import sparse as rs
    from graphblas_tpu.core.operator import get_semiring as rsemiring

    return SimpleNamespace(R=R, jnp=jnp, get_semiring=rsemiring, sparse=rs)


def values(dtn, k, rng):
    return _values(pdt.lookup_dtype(dtn).np_type, k, rng)


def assert_same(got, want, label):
    want = np.asarray(want)
    assert got.dtype == want.dtype, (label, got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=label)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, equal_nan=True, err_msg=label)


def _values(npt, k, rng):
    if npt == np.bool_:
        return rng.random(k) < 0.6
    if npt.kind in "iu":
        return rng.integers(0 if npt.kind == "u" else -5, 9, k).astype(npt)
    v = rng.random(k) * 4 - 1
    return (v + 1j * (rng.random(k) - 0.5) if npt.kind == "c" else v).astype(npt)


def _operands(dt, seed):
    rng = np.random.default_rng(seed)
    n = 12
    a = ps.SparseMatrixData.from_arrays(rng.integers(0, n, 50), rng.integers(0, n, 50), _values(dt.np_type, 50, rng), n, n, "first")
    mr, mc = np.divmod(np.sort(rng.choice(n * n, 40, replace=False)), n)
    return a, mr, mc


def _matches(a, mr, mc):
    """Every (entry, A[i, k], A[j, k]) with both present, k ascending."""
    dense = {}
    for i, k, v in zip(a.rows, a.cols, a.vals):
        dense.setdefault(int(i), {})[int(k)] = v
    ent, av, bv = [], [], []
    for e, (i, j) in enumerate(zip(mr, mc)):
        ri, rj = dense.get(int(i), {}), dense.get(int(j), {})
        for k in sorted(set(ri) & set(rj)):
            ent.append(e)
            av.append(ri[k])
            bv.append(rj[k])
    return np.array(ent, np.int64), np.array(av, a.vals.dtype), np.array(bv, a.vals.dtype)


PAD = 256  # every oracle array has this length: jnp compiles each op once per type


def _pad(x):
    return np.concatenate([x, np.repeat(x[:1], PAD - len(x))])


def _oracle(ref, rt, ent, av, bv):
    """Entries with a match and their values: the reference's typed multiply,
    then its monoid folded over each entry's products in order (``any`` as
    the reference's engine reduces it: max)."""
    jnp = ref.jnp
    mul, mon = rt.binaryop, rt.monoid
    out_np = np.dtype(rt.return_type.np_type)
    a = jnp.asarray(_pad(av)).astype(mul.type_.np_type)
    b = jnp.asarray(_pad(bv)).astype(mul.type2.np_type)
    prods = np.broadcast_to(np.asarray(mul.fn(a, b)).astype(out_np), (PAD,))[: len(av)]
    combine = mon.fn if mon.parent.name != "any" else jnp.maximum
    first = np.concatenate([[True], ent[1:] != ent[:-1]])
    starts = np.flatnonzero(first)
    lens = np.diff(np.concatenate([starts, [len(ent)]]))
    acc = _pad(prods[starts])
    for r in range(1, int(lens.max())):
        live = _pad(lens > r)
        nxt = _pad(prods[np.minimum(starts + r, len(ent) - 1)])
        acc = np.where(live, np.asarray(combine(jnp.asarray(acc), jnp.asarray(nxt))).astype(out_np), acc)
    return ent[starts], acc[: len(starts)]


def _types_of(rsr, add):
    out = []
    # any over complex: the reference's engine has no order to reduce by (it
    # raises), nor has the port's
    for t in ("INT32", "FP32", "BOOL", "UINT16") + (("FC32",) if add != "any" else ()):
        try:
            if t in rsr:
                out.append(t)
                break
        except Exception:  # noqa: BLE001 - a type the multiply fails to trace for
            continue
    if add in UNSIGNED_TOO and "UINT64" in rsr and "UINT64" not in out:
        out.append("UINT64")
    return out


# the monoids that also run at UINT64 (unsigned order, division, wrap)
UNSIGNED_TOO = ("plus", "times", "min", "max", "band", "bor", "bxor", "bxnor")


@pytest.mark.parametrize("add", MONOIDS)
def test_every_mul_matches_the_reference_operators(ref, add):
    compared = 0
    for mul in MULS:
        rsg = ref.get_semiring(getattr(ref.R.monoid, add), getattr(ref.R.binary, mul))
        psg = get_semiring(getattr(P.monoid, add), getattr(P.binary, mul))
        for dtn in _types_of(rsg, add):
            rt, pt = rsg[dtn], psg[dtn]
            if add == "any" and rt.return_type._is_complex:
                continue  # see _types_of
            assert (rt.return_type.name, rt.type_.name, rt.type2.name) == (pt.return_type.name, pt.type_.name, pt.type2.name)
            a, mr, mc = _operands(pdt.lookup_dtype(dtn), seed=len(add) * 7 + len(mul))
            ent, av, bv = _matches(a, mr, mc)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                hit_e, want = _oracle(ref, rt, ent, av, bv)
            rows, cols, vals, flops = ps.sparse_mxm_masked(a, a.transposed(), mr, mc, pt, pt.return_type, device="cpu")
            label = f"{add}_{mul}[{dtn}]"
            np.testing.assert_array_equal(rows, mr[hit_e], err_msg=label)
            np.testing.assert_array_equal(cols, mc[hit_e], err_msg=label)
            assert flops == 2 * len(ent), label
            assert vals.dtype == want.dtype, label
            if want.dtype.kind in "biu":
                np.testing.assert_array_equal(vals, want, err_msg=label)
            else:
                np.testing.assert_allclose(vals, want, rtol=1e-6, atol=0, equal_nan=True, err_msg=label)
            compared += 1
    assert compared >= len(MULS) // 2


# ---------------------------------------------------------------------------
# masked SpGEMM
# ---------------------------------------------------------------------------


def _spgemm_operands(ref, dtn, rng):
    n = 12
    r, c = rng.integers(0, n, 50), rng.integers(0, n, 50)
    v = values(dtn, 50, rng)
    ra = ref.sparse.SparseMatrixData.from_arrays(r, c, v, n, n, "first")
    pa = ps.SparseMatrixData.from_arrays(r, c, v, n, n, "first")
    mr, mc = np.divmod(rng.choice(n * n, 40, replace=False), n)
    return ra, pa, mr, mc


@pytest.mark.parametrize("add", MONOIDS)
def test_mxm_masked_matches_reference_engine(ref, add):
    """``sparse_mxm_masked`` against the reference's, one multiply a monoid
    (first; times where the monoid is bitwise), at INT32 or BOOL
    (tests/test_torch_typed_spgemm.py holds every add x mul pair against the
    reference's operators)."""
    rng = np.random.default_rng(MONOIDS.index(add))
    mul = "times" if add.startswith("b") else "first"
    rsr = ref.get_semiring(getattr(ref.R.monoid, add), getattr(ref.R.binary, mul))
    psr = get_semiring(getattr(P.monoid, add), getattr(P.binary, mul))
    dtn = "INT32" if "INT32" in rsr else "UINT32" if "UINT32" in rsr else "BOOL"
    ra, pa, mr, mc = _spgemm_operands(ref, dtn, rng)
    rt, pt = rsr[dtn], psr[dtn]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref.sparse.sparse_mxm_masked(ra, ra, mr, mc, rt, rt.return_type)
    got = ps.sparse_mxm_masked(pa, pa, mr, mc, pt, pt.return_type, device="cpu")
    label = f"{add}_{mul}[{dtn}]"
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w, err_msg=label)
    assert_same(got[2], want[2], label)
    assert got[3] == want[3] > 0, label


@pytest.mark.parametrize("case", ["user_monoid", "user_mul", "udf_mul_user_monoid"])
def test_spgemm_execute_user_operators_match_reference(ref, case):
    """A user monoid (the plain path's scan and the per-bucket combine) and
    a UDF multiply, on a plan whose hub entry spans several buckets."""
    rng = np.random.default_rng(5)
    n = 600
    hub = n - 1
    r = np.concatenate([np.full(n - 1, hub), rng.integers(0, n - 1, 3 * n)])
    c = np.concatenate([np.arange(n - 1), rng.integers(0, n - 1, 3 * n)])
    v = rng.integers(-3, 4, len(r)).astype(np.int32)
    ra = ref.sparse.SparseMatrixData.from_arrays(r, c, v, n, n, "first")
    pa = ps.SparseMatrixData.from_arrays(r, c, v, n, n, "first")
    rb, pb = ra.transposed(), pa.transposed()
    mr = np.concatenate([np.full(n, hub), np.arange(n - 1)])
    mc = np.concatenate([np.arange(n), np.full(n - 1, hub)])
    srs = []
    for pkg in (ref.R, P):
        mon = pkg.monoid.register_anonymous(pkg.binary.register_anonymous(lambda x, y: x + y + x * y, "xpypxy"), 0)
        mul = pkg.binary.register_anonymous(lambda x, y: x * 2 - y, "twice_minus")
        add = mon if case != "user_mul" else pkg.monoid.plus
        mul = mul if case != "user_monoid" else pkg.binary.times
        srs.append(pkg.semiring.register_anonymous(add, mul)["INT32"])
    rplan = ref.sparse.sparse_spgemm_analyze(ra, rb, mr, mc)
    pplan = ps.sparse_spgemm_analyze(pa, pb, mr, mc, device="cpu")
    assert len({b[0] for b in pplan.buckets}) > 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref.sparse.sparse_spgemm_execute(rplan, srs[0], ref.R.dtypes.INT32)
    got = ps.sparse_spgemm_execute(pplan, srs[1], pdt.INT32)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[3] == want[3] > 0


# ---------------------------------------------------------------------------
# duplicates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "dup_op,dtn",
    [("minus", "INT32"), ("minus", "UINT16"), ("times", "UINT64"), ("pow", "UINT8"), ("cdiv", "INT16"), ("max", "FP32"),
     ("rminus", "FP64"), ("bxor", "UINT32"), ("lxor", "BOOL"), ("plus[INT64]", "INT64"), ("typed_min", "UINT64"),
     ("udf", "INT32"), ("udf", "UINT32"), ("udf", "FP64")],
)
def test_combine_dups_matches_reference(ref, dup_op, dtn):
    """Typed, untyped and UDF dup_ops over groups of 1-5 duplicates."""
    rng = np.random.default_rng(9)
    rows = np.repeat(np.arange(8), [1, 2, 3, 5, 1, 4, 2, 3])
    cols = np.repeat(np.arange(8) % 3, [1, 2, 3, 5, 1, 4, 2, 3])
    perm = rng.permutation(len(rows))
    v = values(dtn, len(rows), rng)
    if dup_op == "udf":
        rop = ref.R.binary.register_anonymous(lambda x, y: x * 3 + y, "dup_udf")
        pop = P.binary.register_anonymous(lambda x, y: x * 3 + y, "dup_udf")
    elif dup_op == "typed_min":
        rop, pop = ref.R.binary.min[dtn], P.binary.min[dtn]
    else:
        rop = pop = dup_op
    want = ref.sparse.SparseMatrixData.from_arrays(rows[perm], cols[perm], v[perm], 8, 3, rop)
    got = ps.SparseMatrixData.from_arrays(rows[perm], cols[perm], v[perm], 8, 3, pop)
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.cols, want.cols)
    assert_same(got.vals, want.vals, f"{dup_op}[{dtn}]")
