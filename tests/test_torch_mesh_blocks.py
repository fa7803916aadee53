"""The mesh's resident shards: placed collections keep their blocks on the
shards' devices (``graphblas_tpu_torch.parallel.blocks``), and the ewise,
apply, select, merge and reduce families and SUMMA run block by block.

Each case makes its inputs from a numpy seed, runs the same statements on
the JAX package on its 8 virtual CPU devices (a 2 x 4 mesh, axes ``i``,
``j``) and on the port on an 8-shard CPU mesh, and compares:

- each output's spec with the reference's ``x._values.sharding.spec`` (the
  output of XLA's propagation over the same placed operands), over all 8
  shards;
- its values with the reference's: bit for bit (the signs of zeros and
  the places of NaN included), and FP64 plus reductions within rtol 1e-12, the reference's
  own tolerance (``tests/test_parallel.py``): each block sums its part, the
  partials add in shard order;
- ``parallel.blocks.counts()["gathers"]``, which does not move inside the statements: a
  placed operand is never assembled on one device.

The CUDA cases (``-m cuda``; they skip here) hold the same families and the
compiled loops on a mesh of 8 shards on one card:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_blocks.py
"""

import numpy as np
import pytest
import torch
from test_torch_parallel import jmesh, pinned, pmesh, ref  # noqa: F401 (fixtures)

import graphblas_tpu_torch as P
from graphblas_tpu_torch import parallel as PP
from graphblas_tpu_torch.parallel import blocks as pblocks
from graphblas_tpu_torch.parallel import mesh as pmesh_mod


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _coll(pkg, shape, rng, density=0.7, dtype="FP64", vals=None):
    v = rng.random(shape) if vals is None else vals
    s = rng.random(shape) < density
    cls = pkg.Matrix if len(shape) == 2 else pkg.Vector
    return _with_struct(pkg, cls.from_dense(np.where(s, v, 0.0), dtype=getattr(pkg.dtypes, dtype)), s)


def _with_struct(pkg, x, s):
    """``x`` with the structure ``s`` (numpy bool), on x's device."""
    if pkg is P:
        x._struct = torch.from_numpy(s).to(x._device)
    else:
        import jax.numpy as jnp

        x._struct = jnp.asarray(s)
    return x


def _spec(pkg, x):
    """The placement spec of an output: the port's blocks, the reference's
    sharding (None: a whole array on one device)."""
    if pkg is P:
        pl = pmesh_mod.placement(x)
        return None if pl is None else pl[1]
    sh = x._values.sharding
    if not hasattr(sh, "spec"):
        return None
    assert len(sh.device_set) == 8
    return tuple(sh.spec)


def _arrays(x):
    return _np(x._values), _np(x._struct)


def _same(p, r, rtol=None, label=""):
    """A port collection or scalar against the reference's: structure and
    values bit for bit (signed zeros, NaN), or values within ``rtol``."""
    if not hasattr(p, "_values"):
        a, b = np.asarray(p), np.asarray(r)
        if rtol is None:
            np.testing.assert_array_equal(a, b, err_msg=label)
            assert np.isnan(a) or np.signbit(a) == np.signbit(b), label
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg=label)
        return
    assert p.dtype.name == r.dtype.name and p.shape == r.shape, label
    (pv, ps), (rv, rs) = _arrays(p), _arrays(r)
    np.testing.assert_array_equal(ps, rs, err_msg=label)
    pv, rv = np.where(ps, pv, 0), np.where(rs, rv, 0)
    if rtol is None:
        np.testing.assert_array_equal(pv, rv, err_msg=label)
        if pv.dtype.kind == "f":  # the zeros' signs (a NaN's sign bit carries no value)
            np.testing.assert_array_equal(np.signbit(pv) & ~np.isnan(pv), np.signbit(rv) & ~np.isnan(rv), err_msg=label)
    else:
        np.testing.assert_allclose(pv, rv, rtol=rtol, atol=0, err_msg=label)


def _both(ref, jmesh, pmesh, fn):
    """``fn(pkg, ctx, rng)`` on the port (counting its gathers) and on the
    reference, with one seed each."""
    rng = np.random.default_rng(17)
    with P.tx.config.set(platform="cpu"):
        pctx = PP.Context(mesh=pmesh)
        with pctx:
            p = fn(P, pctx, np.random.default_rng(17))
    rctx = ref.parallel.Context(mesh=jmesh)
    with rctx:
        r = fn(ref, rctx, rng)
    return p, r


def _counted(fn):
    """``fn()`` and the gathers and reshards it made."""
    before = pblocks.counts()
    out = fn()
    after = pblocks.counts()
    return out, {k: after[k] - before[k] for k in after}


# ---------------------------------------------------------------------------
# the families on placed operands
# ---------------------------------------------------------------------------


def _family(pkg, ctx, rng):
    par = pkg.parallel
    A, B = (par.shard_matrix(_coll(pkg, (16, 24), rng)) for _ in range(2))
    M = par.shard_matrix(_coll(pkg, (16, 24), rng, 0.5))
    C = par.shard_matrix(_coll(pkg, (16, 24), rng))
    u, w = (par.shard_vector(_coll(pkg, (48,), rng)) for _ in range(2))
    b, sel, un = pkg.binary, pkg.select, pkg.unary

    def statements():
        C(M.V, accum=b.plus, replace=True) << A.ewise_add(B, b.max)
        return {
            "ewise_add": A.ewise_add(B, b.plus).new(),
            "ewise_mult": A.ewise_mult(B, b.times).new(),
            "ewise_union": A.ewise_union(B, b.minus, 1.5, -2.0).new(),
            "apply ainv": A.apply(un.ainv).new(),
            "apply bound": A.apply(b.times, right=3.0).new(),
            "apply bound left": A.apply(b.minus, left=1.0).new(),
            "select valuegt": A.select(sel.valuegt, 0.5).new(),
            "select mask": A.select(M.S).new(),
            "masked merge": C,
            "merge new mask": A.ewise_mult(B, b.plus).new(mask=~M.S),
            "reduce_rowwise plus": A.reduce_rowwise("plus").new(),
            "reduce_rowwise min": A.reduce_rowwise(pkg.monoid.min).new(),
            "reduce_columnwise max": A.reduce_columnwise("max").new(),
            "reduce_columnwise plus": A.reduce_columnwise("plus").new(),
            "reduce_scalar plus": A.reduce_scalar("plus").new().value,
            "reduce_scalar max": A.reduce_scalar("max").new().value,
            "vector ewise_add": u.ewise_add(w, b.plus).new(),
            "vector ewise_mult": u.ewise_mult(w, b.min).new(),
            "vector apply": u.apply(un.abs).new(),
            "vector select": u.select(sel.valuele, 0.25).new(),
            "vector reduce plus": u.reduce("plus").new().value,
            "vector reduce min": u.reduce(pkg.monoid.min).new().value,
        }

    if pkg is not P:
        return statements(), None
    out, moved = _counted(statements)
    return out, moved


SUMS = {"reduce_rowwise plus", "reduce_columnwise plus", "reduce_scalar plus", "vector reduce plus"}
SPECS = {
    "ewise_add": ("i", "j"), "reduce_rowwise plus": ("i",), "reduce_columnwise max": ("j",),
    "vector ewise_add": ("j",), "masked merge": ("i", "j"), "reduce_scalar plus": None,
}


def test_families_block_by_block(ref, jmesh, pmesh):
    """Every family's output on placed operands: the reference's spec over
    all 8 shards and its values; no gather inside the statements, and no
    reshard (every operand already sits in the output's layout)."""
    (p, moved), (r, _) = _both(ref, jmesh, pmesh, _family)
    assert moved == {"gathers": 0, "reshards": 0}, moved
    for name in r:
        if hasattr(r[name], "_values"):
            assert _spec(P, p[name]) == _spec(ref, r[name]), name
        _same(p[name], r[name], 1e-12 if name in SUMS else None, name)
    for name, spec in SPECS.items():
        if spec is not None:
            assert _spec(P, p[name]) == spec, name


def test_families_equal_single_device(pmesh):
    """The same statements on unplaced operands on one device: bit for bit,
    FP64 plus reductions within rtol 1e-12."""
    with P.tx.config.set(platform="cpu"):
        ctx = PP.Context(mesh=pmesh)
        with ctx:
            placed, _ = _family(P, ctx, np.random.default_rng(3))
        real = PP.shard_matrix, PP.shard_vector
        try:
            PP.shard_matrix = PP.shard_vector = lambda x, *a, **k: x
            plain, _ = _family(P, ctx, np.random.default_rng(3))
        finally:
            PP.shard_matrix, PP.shard_vector = real
    for name in placed:
        _same(placed[name], plain[name], 1e-12 if name in SUMS else None, name)
        if hasattr(plain[name], "_values"):
            assert pmesh_mod.placement(plain[name]) is None


def test_nvals_and_single_device_paths_do_not_count(pmesh):
    """nvals of a placed collection counts its blocks (no gather); with no
    Context and no placed operand nothing gathers or reshards."""
    rng = np.random.default_rng(4)
    with P.tx.config.set(platform="cpu"):
        A = _coll(P, (16, 24), rng)
        B = _coll(P, (16, 24), rng)
        want = A.nvals

        def plain():
            A.ewise_add(B, P.binary.plus).new().reduce_rowwise("plus").new()
            (A.apply(P.unary.ainv).new() @ B.T).new()
            return A.select("tril", 0).new().nvals

        _, moved = _counted(plain)
        assert moved == {"gathers": 0, "reshards": 0}
        PP.shard_matrix(A, PP.Context(mesh=pmesh))
        n, moved = _counted(lambda: A.nvals)
        assert n == want and moved == {"gathers": 0, "reshards": 0}


# ---------------------------------------------------------------------------
# placement rules
# ---------------------------------------------------------------------------


def test_shard_matrix_rejects_nondivisible_and_sparse(ref, jmesh, pmesh):
    """13 x 22 on a 2 x 4 mesh and a vector of 22 over j: ValueError, as the
    reference's device_put; a sparse matrix: the reference's TypeError."""

    def run(pkg, ctx, rng):
        out = []
        for fn, x in (
            (pkg.parallel.shard_matrix, _coll(pkg, (13, 22), rng)),
            (pkg.parallel.shard_matrix, _coll(pkg, (16, 22), rng)),
            (pkg.parallel.shard_vector, _coll(pkg, (22,), rng)),
        ):
            with pytest.raises(ValueError):
                fn(x)
            out.append(_spec(pkg, x))
        L = pkg.Matrix.from_coo([0, 1], [1, 0], [1.0, 2.0], nrows=1 << 30, ncols=1 << 30)
        with pytest.raises(TypeError, match="dense-format"):
            pkg.parallel.shard_matrix(L)
        return out

    p, r = _both(ref, jmesh, pmesh, run)
    assert p == [None, None, None]
    assert len(r) == 3


def _mixed(pkg, ctx, rng):
    par, b, un = pkg.parallel, pkg.binary, pkg.unary
    A = par.shard_matrix(_coll(pkg, (16, 16), rng))
    At = par.shard_matrix(_coll(pkg, (16, 16), rng), spec=("j", "i"))
    U = _coll(pkg, (16, 16), rng)
    R = par.replicate(_coll(pkg, (16, 16), rng))
    P1 = A.mxm(A, pkg.semiring.plus_times).new()
    vi = par.shard_vector(_coll(pkg, (16,), rng), axis="i")
    vj = par.shard_vector(_coll(pkg, (16,), rng))
    u = _coll(pkg, (16,), rng)
    out = {
        "placed+unplaced": A.ewise_add(U, b.plus).new(),
        "unplaced+placed": U.ewise_mult(A, b.times).new(),
        "ij+ji": A.ewise_add(At, b.plus).new(),
        "ij+i": A.ewise_add(P1, b.plus).new(),
        "replicated+unplaced": R.ewise_add(U, b.plus).new(),
        "replicated+placed": R.ewise_add(A, b.plus).new(),
        "vec i+unplaced": vi.ewise_add(u, b.plus).new(),
        "vec i+j": vi.ewise_add(vj, b.plus).new(),
        "transposed": A.T.new(),
        "transposed+placed": A.T.ewise_add(A, b.plus).new(),
        "rowwise of ji": At.reduce_rowwise("plus").new(),
        "colwise of i": P1.reduce_columnwise("max").new(),
        "union placed+unplaced": A.ewise_union(U, b.minus, 1.0, 2.0).new(),
        "dup": A.dup(),
    }
    C = par.shard_matrix(_coll(pkg, (16, 16), rng))
    C << U.apply(un.ainv)
    out["placed C << unplaced"] = C
    C = _coll(pkg, (16, 16), rng)
    C(A.S) << U.apply(un.ainv)
    out["unplaced C, placed mask"] = C
    C = _coll(pkg, (16, 16), rng)
    C(accum=b.plus) << P1.apply(un.ainv)
    out["unplaced C accum << i"] = C
    C = par.shard_matrix(_coll(pkg, (16, 16), rng))
    C(accum=b.plus) << U.apply(un.ainv)
    out["placed C accum << unplaced"] = C
    w = _coll(pkg, (16,), rng)
    w(vj.S) << u.apply(un.ainv)
    out["vector mask j"] = w
    return out


def test_mixed_layouts_follow_the_reference(ref, jmesh, pmesh):
    """A placed operand beside an unplaced one, two layouts that disagree,
    a replicated one, a transposed view, and C, the mask and the result in
    different layouts: each output's spec is the reference's, and its
    values (plus sums rtol 1e-12: the SUMMA product's partials)."""
    p, r = _both(ref, jmesh, pmesh, _mixed)
    for name in r:
        assert _spec(P, p[name]) == _spec(ref, r[name]), name
        _same(p[name], r[name], 1e-12, name)
    assert _spec(P, p["ij+ji"]) == () and _spec(P, p["placed C << unplaced"]) is None


def _positional(pkg, ctx, rng):
    par, un, sel, iu = pkg.parallel, pkg.unary, pkg.select, pkg.indexunary
    A = par.shard_matrix(_coll(pkg, (16, 24), rng, dtype="FP64"))
    v = par.shard_vector(_coll(pkg, (24,), rng))
    return {
        "positioni": A.apply(un.positioni).new(),
        "positionj1": A.apply(un.positionj1).new(),
        "rowindex": A.apply(iu.rowindex, 2).new(),
        "colindex": A.apply(iu.colindex, -1).new(),
        "index vector": v.apply(iu.rowindex, 3).new(),
        "tril": A.select(sel.tril, 1).new(),
        "triu": A.select(sel.triu, -3).new(),
        "diag": A.select(sel.diag, 2).new(),
        "rowle": A.select(sel.rowle, 9).new(),
        "colgt": A.select(sel.colgt, 13).new(),
        "vector indexle": v.select(sel.indexle, 17).new(),
        "ewise firsti": A.ewise_add(A, pkg.binary.firsti).new(),
        "ewise secondj": A.ewise_mult(A, pkg.binary.secondj).new(),
    }


def test_positional_ops_take_global_offsets(ref, jmesh, pmesh):
    """Positional apply, indexunary apply, positional select and positional
    ewise ops see each block's global row and column: = the reference's."""
    p, r = _both(ref, jmesh, pmesh, _positional)
    for name in r:
        assert _spec(P, p[name]) == _spec(ref, r[name]), name
        _same(p[name], r[name], None, name)


def _edges(pkg, ctx, rng):
    """Blocks with no entry, a matrix with none, and min/max over NaN and
    zeros of both signs in different blocks."""
    par = pkg.parallel
    s = rng.random((16, 24)) < 0.6
    s[:8, :] = False  # row blocks i = 0: no entry
    s[:, 6:12] = False  # column block j = 1: no entry
    vals = rng.random((16, 24))
    A = par.shard_matrix(_with_struct(pkg, pkg.Matrix.from_dense(np.where(s, vals, 0.0), dtype=pkg.dtypes.FP64), s))
    E = par.shard_matrix(pkg.Matrix(pkg.dtypes.FP64, 16, 24))
    z = np.full((16, 24), 1.0)
    z[0, 0], z[0, 7], z[9, 13], z[9, 20], z[12, 23] = -0.0, 0.0, 0.0, -0.0, -0.0
    z[:, 18:] = -z[:, 18:]
    Z = par.shard_matrix(pkg.Matrix.from_dense(z, dtype=pkg.dtypes.FP64))
    z[3, 2] = z[14, 19] = np.nan
    N = par.shard_matrix(pkg.Matrix.from_dense(z, dtype=pkg.dtypes.FP64))
    N1 = pkg.Matrix.from_dense(z, dtype=pkg.dtypes.FP64)
    mn, mx = pkg.monoid.min, pkg.monoid.max
    nan = {}
    for tag, X in (("placed", N), ("single", N1)):
        nan[f"nan rowwise min {tag}"] = X.reduce_rowwise(mn).new()
        nan[f"nan colwise max {tag}"] = X.reduce_columnwise(mx).new()
        nan[f"nan scalar min {tag}"] = X.reduce_scalar(mn).new().value
        nan[f"nan ewise max {tag}"] = X.ewise_add(Z, pkg.binary.max).new()
    return nan | {
        "empty blocks rowwise": A.reduce_rowwise("plus").new(),
        "empty blocks colwise max": A.reduce_columnwise(mx).new(),
        "empty blocks scalar": A.reduce_scalar(mn).new().value,
        "empty blocks apply": A.apply(pkg.unary.ainv).new(),
        "empty ewise": E.ewise_add(A, pkg.binary.plus).new(),
        "empty rowwise": E.reduce_rowwise(mx).new(),
        "empty nvals": E.nvals,
        "zeros rowwise min": Z.reduce_rowwise(mn).new(),
        "zeros rowwise max": Z.reduce_rowwise(mx).new(),
        "zeros colwise min": Z.reduce_columnwise(mn).new(),
        "zeros colwise max": Z.reduce_columnwise(mx).new(),
        "zeros scalar min": Z.reduce_scalar(mn).new().value,
        "zeros scalar max": Z.reduce_scalar(mx).new().value,
        "zeros ewise min": Z.ewise_add(Z.apply(pkg.unary.ainv).new(), pkg.binary.min).new(),
    }


def test_empty_blocks_nan_and_signed_zeros(ref, jmesh, pmesh):
    """All-absent blocks and an empty matrix reduce to absent entries; min
    and max across shards order -0.0 below +0.0, bit for bit with the
    reference.  NaN propagates through min and max across shards as within
    one (``jnp.minimum``): the placed results = the reference's on one
    device.  (The reference's own cross-device min and max on its virtual
    CPU devices drop a NaN that one shard holds, so its placed results
    differ from its single-device ones there; the port keeps one answer.)"""
    p, r = _both(ref, jmesh, pmesh, _edges)
    for name in r:
        want = r[name.replace("placed", "single")]
        if hasattr(r[name], "_values") and "single" not in name:
            assert _spec(P, p[name]) == _spec(ref, r[name]), name
        _same(p[name], want, 1e-12 if name == "empty blocks rowwise" else None, name)
    assert np.isnan(p["nan scalar min placed"]) and np.isnan(_np(p["nan rowwise min placed"]._values)[3])


def test_udt_matrix_placed_field_by_field(pmesh):
    """A UDT matrix placed over the mesh: its fields blocked one by one, and
    ewise_add with a user op on the blocks = the unplaced statement."""
    from graphblas_tpu_torch.core import dtypes as pdt

    T = pdt.register_anonymous(np.dtype([("x", np.float64), ("y", np.int32)]))

    def add(a, b):
        return {"x": a["x"] + b["x"], "y": torch.maximum(a["y"], b["y"])}

    op = P.binary.register_anonymous(add, "mesh_blocks_udt_add")
    rng = np.random.default_rng(6)
    with P.tx.config.set(platform="cpu"):
        mats = []
        for _ in range(2):
            r, c = rng.integers(0, 8, 40), rng.integers(0, 16, 40)
            vals = np.zeros(40, T.np_type)
            vals["x"], vals["y"] = rng.random(40), rng.integers(0, 100, 40)
            mats.append(P.Matrix.from_coo(r, c, vals, T, nrows=8, ncols=16, dup_op=P.binary.first))
        plain = mats[0].ewise_add(mats[1], op).new()
        ctx = PP.Context(mesh=pmesh)
        A, B = (PP.shard_matrix(m.dup(), ctx) for m in mats)
        assert set(A._values_.parts[0]) == {"x", "y"}
        placed, moved = _counted(lambda: A.ewise_add(B, op).new())
        assert moved == {"gathers": 0, "reshards": 0}
        assert pmesh_mod.placement(placed)[1] == ("i", "j")
        assert placed.isequal(plain)


def test_sparse_target_and_nvals_in_a_loop(pmesh):
    """A masked statement with a placed result into a sparse-format target
    densifies the target and places it; a compiled loop body reads .nvals
    of placed state whose structure is a constant of the loop."""
    rng = np.random.default_rng(8)
    with P.tx.config.set(platform="cpu"):
        ctx = PP.Context(mesh=pmesh)
        A = PP.shard_matrix(_coll(P, (16, 24), rng), ctx)
        M = _coll(P, (16, 24), rng, 0.5)
        with P.tx.config.set(dense_limit=0):
            C = P.Matrix(P.dtypes.FP64, 16, 24)
        assert C._sparse is not None
        C(M.S) << A.apply(P.unary.ainv)
        want = _coll(P, (16, 24), np.random.default_rng(8))
        D = P.Matrix(P.dtypes.FP64, 16, 24)
        D(M.S) << want.apply(P.unary.ainv)
        assert C.isequal(D) and pmesh_mod.placement(C)[1] == ("i", "j")
        v = PP.shard_vector(P.Vector.from_dense(np.arange(16.0)), ctx)
        counts = []

        def body(x):
            counts.append(x.nvals)
            return x.apply(P.binary.plus, right=1.0).new()

        out = P.loop(3, body, v)
        assert counts and set(counts) == {16}
        np.testing.assert_array_equal(_np(out._values), np.arange(16.0) + 3)


# ---------------------------------------------------------------------------
# SUMMA's product stays placed
# ---------------------------------------------------------------------------


def _summa(pkg, ctx, rng):
    par, sr = pkg.parallel, pkg.semiring
    A = par.shard_matrix(_coll(pkg, (16, 24), rng))
    B = par.shard_matrix(_coll(pkg, (24, 16), rng))
    x = _coll(pkg, (24,), rng)
    Pm = A.mxm(B, sr.min_plus).new()
    Pp = A.mxm(B, sr.plus_times).new()
    y = A.mxv(x, sr.plus_times).new()

    def after():
        return {
            "mxm min_plus": Pm,
            "mxm plus_times": Pp,
            "mxv": y,
            "after: ewise_add": Pm.ewise_add(Pm, pkg.binary.plus).new(),
            "after: rowwise": Pm.reduce_rowwise(pkg.monoid.min).new(),
            "after: apply": y.apply(pkg.binary.times, right=2.0).new(),
        }

    if pkg is not P:
        return after(), None
    return _counted(after)


def test_summa_product_stays_placed(ref, jmesh, pmesh):
    """A.mxm(B) and A.mxv(x) inside the Context leave Blocks P(i,) (the
    reference's out_specs); a statement after them runs block by block, with
    no gather; values = the reference's (min_plus exact, plus rtol 1e-12)."""
    (p, moved), (r, _) = _both(ref, jmesh, pmesh, _summa)
    assert moved == {"gathers": 0, "reshards": 0}, moved
    for name in r:
        assert _spec(P, p[name]) == _spec(ref, r[name]), name
        _same(p[name], r[name], None if "min" in name or "ewise" in name else 1e-12, name)
    assert _spec(P, p["mxm min_plus"]) == ("i",) and _spec(P, p["mxv"]) == ("i",)


# ---------------------------------------------------------------------------
# compiled loops under an engaged Context
# ---------------------------------------------------------------------------


def _graph(pkg, n, sparse, seed=7):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, 8 * n), rng.integers(0, n, 8 * n)
    with pkg.tx.config.set(dense_limit=0 if sparse else 1 << 24):
        A = pkg.Matrix.from_coo(src, dst, 1.0, pkg.dtypes.FP32, nrows=n, ncols=n, dup_op=pkg.binary.first)
        return A.T.new()


@pytest.mark.parametrize("sparse", [False, True], ids=["dense-summa", "sparse-sharded-spmv"])
def test_compiled_loops_under_context(ref, jmesh, pmesh, sparse, monkeypatch):
    """``models.dsl`` PageRank (gb.loop) and level BFS (gb.until) built and
    run inside the Context: the mesh route runs in the loop (SUMMA on the
    dense graph, the sharded SpMV on the sparse one), the port reports its
    mode and capture decision (on the CPU the decision is made, the steps
    run eagerly), and the results = the reference's jitted loops under its
    Context (ranks rtol 1e-5, levels exact)."""
    from graphblas_tpu_torch.core import compiler
    from graphblas_tpu_torch.models import dsl as pdsl
    from graphblas_tpu_torch.parallel import fastspmv as pfast
    from graphblas_tpu_torch.parallel import summa as psumma

    calls = {"summa": 0, "spmv": 0}
    for mod, name, key in ((psumma, "summa_mxv_arrays", "summa"), (pfast, "sharded_spmv_masked", "spmv")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    n = 2048 if sparse else 64
    cfg = {"mxv_strategy": "plan"} if sparse else {}

    def run(pkg, ctx, rng):
        AT = _graph(pkg, n, sparse)
        dsl = __import__(f"{pkg.__name__}.models.dsl", fromlist=["dsl"])
        with pkg.tx.config.set(**cfg):
            pr = dsl.pagerank_runner(AT, max_iters=10)
            rank = pr()
            bfs = dsl.bfs_level_runner(AT, 0)
            levels = bfs()
        return pr, rank, bfs, levels

    with P.tx.config.set(platform="cpu"):
        pctx = PP.Context(mesh=pmesh)
        with pctx:
            ppr, prank, pbfs, plevels = run(P, pctx, None)
    with ref.parallel.Context(mesh=jmesh):
        _, rrank, _, rlevels = run(ref, None, None)
    assert calls["spmv" if sparse else "summa"] > 0 and calls["summa" if sparse else "spmv"] == 0
    assert (ppr.mode, pbfs.mode) == ("hoisted", "carried")
    assert (ppr.capture, ppr.capture_reason, pbfs.runner.capture, pbfs.runner.capture_reason) == ("graph", None, "graph", None)
    assert compiler.last_loop_mode() == "carried"
    with P.tx.config.set(platform="cpu", **cfg), pctx:
        again, moved = _counted(ppr)
    assert moved["gathers"] == 0, moved  # the state stays where the routes leave it
    np.testing.assert_allclose(_np(again._values), _np(prank._values), rtol=1e-6)
    np.testing.assert_allclose(_np(prank._values), np.asarray(rrank._values), rtol=1e-5)
    _same(plevels, rlevels)
    # the dense route keeps the rank vector placed as SUMMA leaves it
    assert _spec(P, prank) == (None if sparse else ("i",))


def test_compiled_loop_on_distinct_devices_runs_eagerly(pmesh):
    """A mesh whose shards sit on more than one device cannot be one CUDA
    graph: the loop reports an eager capture and names why (two CPU
    "devices" stand in here through the check's own input)."""
    from graphblas_tpu_torch.core import compiler

    with P.tx.config.set(platform="cpu"):
        x = PP.shard_vector(_coll(P, (16,), np.random.default_rng(2)), PP.Context(mesh=pmesh))
        leaf = x._values_
        assert compiler._mesh_devices_reason([leaf]) is None
        leaf.layout.devices[1] = torch.device("meta")
        assert "2 devices" in compiler._mesh_devices_reason([leaf])


# ---------------------------------------------------------------------------
# on the card: 8 shards on one GPU
# ---------------------------------------------------------------------------


def _cuda_ctx():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return PP.Context(devices=[torch.device("cuda", 0)] * 8, shape=(2, 4))


@pytest.mark.cuda
def test_cuda_families_block_by_block():
    """The families on placed operands on the card = the same statements on
    one device (bit for bit; FP64 plus rtol 1e-12), no gather."""
    ctx = _cuda_ctx()
    with P.tx.config.set(platform="cuda"):
        with ctx:
            placed, moved = _family(P, ctx, np.random.default_rng(3))
        real = PP.shard_matrix, PP.shard_vector
        try:
            PP.shard_matrix = PP.shard_vector = lambda x, *a, **k: x
            plain, _ = _family(P, ctx, np.random.default_rng(3))
        finally:
            PP.shard_matrix, PP.shard_vector = real
    assert moved == {"gathers": 0, "reshards": 0}
    for name in placed:
        _same(placed[name], plain[name], 1e-12 if name in SUMS else None, name)
        if name in SPECS and SPECS[name] is not None:
            assert pmesh_mod.placement(placed[name])[1] == SPECS[name]


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [False, True], ids=["dense-summa", "sparse-sharded-spmv"])
def test_cuda_compiled_pagerank_replays_a_graph(sparse):
    """A compiled DSL PageRank inside the Context on 8 shards of one card
    replays as a CUDA graph (SUMMA on a placed dense graph, its state
    placed; the sharded SpMV on a sparse one), = the loop outside (rtol
    1e-5) and = its own eager run."""
    ctx = _cuda_ctx()
    from graphblas_tpu_torch.models import dsl as pdsl

    with P.tx.config.set(platform="cuda", **({"mxv_strategy": "plan"} if sparse else {})):
        AT = _graph(P, 1 << 15 if sparse else 512, sparse)
        want = pdsl.pagerank_runner(AT, max_iters=10)()
        with ctx:
            if not sparse:
                PP.shard_matrix(AT)
            run = pdsl.pagerank_runner(AT, max_iters=10)
            got, moved = _counted(run)
            again = run.eager()
    assert (run.capture, run.capture_reason) == ("graph", None)
    assert moved["gathers"] == 0, moved
    assert _spec(P, got) == (None if sparse else ("i",))
    torch.testing.assert_close(got._values, want._values, rtol=1e-5, atol=0)
    torch.testing.assert_close(got._values, again._values, rtol=1e-6, atol=0)
