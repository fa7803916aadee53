"""Parity of the port's typed SpMV entry point (``sparse_mxv`` of
``graphblas_tpu_torch.core.sparse``) with the JAX package's, at small sizes
(the typed SpGEMM and ``_combine_dups``: tests/test_torch_typed_spgemm.py).

The same numpy COO arrays and vectors feed both packages; each takes its own
typed operators of the same names.  ``sparse_mxv`` runs under
``mxv_strategy`` "plan" (the SpmvPlan engine: in the port its kernels' plain
versions on the CPU) and "generic" (gather + segment reduce).  The
reference's Pallas paths run in interpret mode on the CPU, as its own tests
run them.  Values: integers and bool bit for bit; floats within 1e-6
relative (float sums reorder), 1e-4 for a user float monoid whose combine
compounds rounding (another tree than the reference's ``associative_scan``;
stated where used).  Where the reference raises for a case (``ROADMAP.md``
section 3: a BOOL plus monoid on its generic path, a narrow integer channel
with ``wrap`` on its plan path), the port is held to the reference's other
path.  The JAX package is imported by the ``ref`` fixture.
"""

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as P
from graphblas_tpu_torch.core import dtypes as pdt
from graphblas_tpu_torch.core import sparse as ps
from graphblas_tpu_torch.core.operator import get_typed_op as pget

TYPES = ["BOOL", "INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32", "UINT64", "FP32", "FP64", "FC32", "FC64"]


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import graphblas_tpu as R
    from graphblas_tpu.core import sparse as rs
    from graphblas_tpu.core.operator import get_semiring as rsemiring
    from graphblas_tpu.core.operator import get_typed_op as rget

    return SimpleNamespace(R=R, jax=jax, jnp=jnp, sparse=rs, get=rget, get_semiring=rsemiring)


def values(dtn, k, rng):
    npt = pdt.lookup_dtype(dtn).np_type
    if npt == np.bool_:
        return rng.random(k) < 0.6
    if npt.kind in "iu":
        lo = 0 if npt.kind == "u" else -5
        return rng.integers(lo, 9, k).astype(npt)
    v = rng.random(k) * 4 - 1
    if npt.kind == "c":
        v = v + 1j * (rng.random(k) - 0.5)
    return v.astype(npt)


def graph(rng, n=40, e=200):
    return rng.integers(0, n, e), rng.integers(0, n, e), n


def assert_same(got, want, label, rtol=1e-6):
    want = np.asarray(want)
    assert got.dtype == want.dtype, (label, got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=label)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True, err_msg=label)


# ---------------------------------------------------------------------------
# sparse_mxv
# ---------------------------------------------------------------------------

MXV_SEMIRINGS = [
    "plus_times", "min_plus", "max_first", "any_pair", "plus_pair", "times_times", "bor_band",
    # positional multiplies
    "min_secondi", "any_firsti", "max_secondj1",
]


def _ref_mxv(ref, rsp, pull, a_first, xv, xs, sr, out, strategy):
    """The reference's result under ``strategy``, else under the other one
    where it raises; None where both raise."""
    for strat in (strategy, "generic" if strategy == "plan" else "plan"):
        def call(x, s, strat=strat):
            return ref.sparse.sparse_mxv(rsp, pull, a_first, x, s, sr, out)

        # the generic path traced as a compiled loop traces it: one program,
        # where eagerly a user monoid's associative_scan compiles ~100 ops
        fn = ref.jax.jit(call) if strat == "generic" else call
        try:
            with ref.R.tx.config.set(mxv_strategy=strat), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                y, s = fn(ref.jnp.asarray(xv), ref.jnp.asarray(xs))
            return np.asarray(y), np.asarray(s)
        except Exception:  # noqa: BLE001 - the reference's faults, logged in ROADMAP.md section 3
            continue
    return None


def _mxv_cases(ref, name, sr_of, rng, types=TYPES):
    r, c, n = graph(rng)
    for dtn in types:
        rsr, psr = sr_of(ref.R, name), sr_of(P, name)
        if dtn not in rsr:
            assert dtn not in psr, (name, dtn)
            continue
        v = values(dtn, len(r), rng)
        rsp = ref.sparse.SparseMatrixData.from_arrays(r, c, v, n, n, "first")
        psp = ps.SparseMatrixData.from_arrays(r, c, v, n, n, "first")
        xv, xs = values(dtn, n, rng), rng.random(n) < 0.7
        rt = ref.get(rsr, getattr(ref.R.dtypes, dtn), kind="semiring")
        pt = pget(psr, pdt.lookup_dtype(dtn), kind="semiring")
        yield dtn, rsp, psp, xv, xs, rt, pt


def _check_mxv(ref, name, sr_of, seed, rtol=1e-6, types=TYPES):
    rng = np.random.default_rng(seed)
    compared = 0
    for dtn, rsp, psp, xv, xs, rt, pt in _mxv_cases(ref, name, sr_of, rng, types):
        assert rt.return_type.name == pt.return_type.name
        out = pt.return_type
        # a monoid the plan engine does not take runs the generic path under
        # either strategy, in both packages: once is enough
        for strategy in ("plan", "generic") if rt.monoid.parent.name in ps._PLAN_ADDS else ("generic",):
            # mxv everywhere; vxm for the positional muls (where the role of
            # each index matters), plus_times and min_plus
            both = pt.is_positional or name in ("plus_times", "min_plus")
            for pull, a_first in ((True, True), (False, False), (True, False))[: 3 if pt.is_positional else 2 if both else 1]:
                want = _ref_mxv(ref, rsp, pull, a_first, xv, xs, rt, rt.return_type, strategy)
                try:
                    with P.tx.config.set(mxv_strategy=strategy):
                        yv, ys = ps.sparse_mxv(psp, pull, a_first, pdt.to_tensor(xv, dtn, "cpu"), torch.from_numpy(xs), pt, out, x_type=pdt.lookup_dtype(dtn))
                except TypeError:
                    assert want is None  # complex any: only where the reference fails too
                    continue
                label = f"{name}[{dtn}] {strategy} pull={pull} a_first={a_first}"
                if want is None:  # the reference raises on both paths (complex any)
                    continue
                assert yv.dtype == out.carrier and ys.dtype == torch.bool, label
                np.testing.assert_array_equal(ys.numpy(), want[1], err_msg=label)
                assert_same(pdt.to_numpy(yv, out), want[0], label, rtol)
                compared += 1
    assert compared > 0


@pytest.mark.parametrize("name", MXV_SEMIRINGS)
def test_sparse_mxv_matches_reference(ref, name):
    """Every builtin type the semiring takes, both strategies; mxv, and vxm
    and the stored matrix as the multiply's second argument where noted."""
    _check_mxv(ref, name, lambda pkg, n: getattr(pkg.semiring, n), seed=len(name))


def _user_semiring(pkg, name):
    """A user integer monoid (a UDF: x + y + x * y, identity 0, associative)
    with times, or a user multiply (a UDF) with the builtin plus monoid."""
    if name == "user_monoid":
        op = pkg.binary.register_anonymous(lambda x, y: x + y + x * y, "xpypxy")
        mon = pkg.monoid.register_anonymous(op, 0)
        return pkg.semiring.register_anonymous(mon, pkg.binary.times)
    mul = pkg.binary.register_anonymous(lambda x, y: x * 2 - y, "twice_minus")
    return pkg.semiring.register_anonymous(pkg.monoid.plus, mul)


@pytest.mark.parametrize("name", ["user_monoid", "user_mul"])
def test_sparse_mxv_user_semirings_match_reference(ref, name):
    """A user monoid (the generic path's segmented log-step scan) and a user
    multiply, at INT32, UINT16 (on its int32 carrier) and FP32."""
    cache = {}

    def sr_of(pkg, _):
        if pkg not in cache:
            cache[pkg] = _user_semiring(pkg, name)
        return cache[pkg]

    # x + y + x * y compounds each combine's rounding: the two trees (the
    # reference's associative_scan, the port's log-step scan) differ by up to
    # 1.25e-5 relative in float32 at these sizes
    _check_mxv(ref, name, sr_of, seed=11, rtol=1e-4 if name == "user_monoid" else 1e-6, types=("INT32", "UINT16", "FP32"))


def test_plan_choice_follows_the_strategy(ref):
    """'generic' never builds a plan; 'plan' builds one per direction and
    device and reuses it; 'auto' takes the plan only for CUDA tensors of at
    least 2^17 entries (never here)."""
    rng = np.random.default_rng(3)
    r, c, n = graph(rng)
    psp = ps.SparseMatrixData.from_arrays(r, c, np.ones(len(r), np.float32), n, n, "first")
    sr = P.semiring.plus_times["FP32"]
    x, xs = torch.rand(n), torch.ones(n, dtype=torch.bool)
    for strategy, built in (("generic", False), ("auto", False), ("plan", True)):
        with P.tx.config.set(mxv_strategy=strategy):
            ps.sparse_mxv(psp, True, True, x, xs, sr, pdt.FP32)
        assert psp.plan_ready("pull", "cpu") is built, strategy
    plan = psp.plan("pull", "cpu")
    with P.tx.config.set(mxv_strategy="plan"):
        ps.sparse_mxv(psp, True, True, x, xs, sr, pdt.FP32)
    assert psp.plan("pull", "cpu") is plan and not psp.plan_ready("push", "cpu")


def test_no_entry_point_raises_not_implemented(ref):
    """Every builtin monoid (with first) through ``sparse_mxv`` and
    ``sparse_mxm_masked``, and every builtin binary op as a dup_op, at a type
    the reference's operator takes: none raises NotImplementedError (the
    name tables that stood in for typed operators are gone)."""
    assert not hasattr(ps, "_not_ported") and not hasattr(ps, "_check_semiring")
    rng = np.random.default_rng(4)
    r, c, n = graph(rng, n=10, e=30)
    for add in sorted(P.monoid._ops):
        psr = P.semiring.register_anonymous(getattr(P.monoid, add), P.binary.first)
        rsr = ref.R.semiring.register_anonymous(getattr(ref.R.monoid, add), ref.R.binary.first)
        dtn = next(t for t in ("INT32", "BOOL", "UINT32") if t in rsr)
        assert dtn in psr
        pt, dt = psr[dtn], pdt.lookup_dtype(dtn)
        sp = ps.SparseMatrixData.from_arrays(r, c, values(dtn, len(r), rng), n, n, "first")
        ps.sparse_mxv(sp, True, True, pdt.to_tensor(values(dtn, n, rng), dt, "cpu"), torch.ones(n, dtype=torch.bool), pt, pt.return_type)
        ps.sparse_mxm_masked(sp, sp.transposed(), sp.rows, sp.cols, pt, pt.return_type, device="cpu")
    for name in sorted(n for n, op in P.binary._ops.items() if hasattr(op, "types") and op.positional is None):
        rop = getattr(ref.R.binary, name)
        dtn = next((t for t in ("INT32", "FP64", "BOOL") if t in [d.name for d in rop.types]), None)
        if dtn is None:
            continue
        v = values(dtn, 6, rng)
        ps.SparseMatrixData.from_arrays([0, 0, 1, 1, 1, 2], [1, 1, 0, 0, 0, 2], v, 3, 3, getattr(P.binary, name))
