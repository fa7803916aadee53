"""Parity of the port's mesh layer (``graphblas_tpu_torch.parallel``) with the
JAX package's, case for case with ``tests/test_parallel.py``,
``tests/test_misc.py::test_parallel_context`` and the checks of
``__graft_entry__.dryrun_multichip``.

Each case makes its inputs from a numpy seed and runs them through the JAX
package on the harness's 8 virtual CPU devices and through the port on an
8-shard CPU mesh (``parallel.Context()`` on the CPU platform), and compares:
structures, integers, bool, min, max, levels, distances and parents bit for
bit; float sums within the tolerance the case states (the port folds the
shards' partials in shard order, XLA's psum in its own; within a shard the
scans and matmuls sum in their own order).  The DSL cases also show the mesh
path ran, by a call count of the mesh function.

The CUDA cases (``-m cuda``; they skip here) hold the sharded SpMV, SUMMA
and the sharded SpGEMM on a mesh of 8 shards on one card against the
single-device engine, every kernel launched and no plain version:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel.py
"""

import importlib
import types

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as P
from graphblas_tpu_torch import kernels
from graphblas_tpu_torch import parallel as PP
from graphblas_tpu_torch.core.operator import get_typed_op as p_typed
from graphblas_tpu_torch.parallel import blocks as pblocks
from graphblas_tpu_torch.parallel import mesh as pmesh_mod
from graphblas_tpu_torch.parallel import spgemm as p_spgemm

# ---------------------------------------------------------------------------
# fixtures: the reference on its 8 virtual devices, the port on 8 CPU shards
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import graphblas_tpu as R

    return R


@pytest.fixture(scope="module")
def jmesh(ref):
    import jax

    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return ref.parallel.Context(devices=devices[:8]).mesh


@pytest.fixture(scope="module")
def pmesh():
    with P.tx.config.set(platform="cpu"):
        return PP.Context().mesh


@pytest.fixture(autouse=True)
def pinned():
    with P.tx.config.set(platform="cpu"):
        yield


def _np(a):
    if pblocks.is_blocks(a):  # a placed result (SUMMA's product): its whole array
        a = pblocks.whole(a)
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rand_masked(rng, shape, density=0.7):
    return rng.random(shape), rng.random(shape) < density


def _dense_matrix(pkg, vals, struct, dtype="FP64"):
    A = pkg.Matrix.from_dense(np.where(struct, vals, 0.0), dtype=getattr(pkg.dtypes, dtype))
    A._struct = _like(pkg, struct)
    return A


def _dense_vector(pkg, vals, struct):
    v = pkg.Vector.from_dense(np.where(struct, vals, 0.0))
    v._struct = _like(pkg, struct)
    return v


def _like(pkg, a):
    if pkg is P:
        return torch.from_numpy(np.ascontiguousarray(a))
    import jax.numpy as jnp

    return jnp.asarray(a)


def _typed(pkg, sr, dtype="FP64"):
    if pkg is P:
        return p_typed(getattr(P.semiring, sr), P.dtypes.FP64 if dtype == "FP64" else P.dtypes.FP32, kind="semiring")
    from graphblas_tpu.core.operator import get_typed_op

    t = getattr(pkg.dtypes, dtype)
    return get_typed_op(getattr(pkg.semiring, sr), t, t, kind="semiring")


def _both(ref, jmesh, pmesh, fn):
    """``fn(pkg, mesh)`` on the port and on the reference."""
    return fn(P, pmesh), fn(ref, jmesh)


def _same(p, r, label="", rtol=None):
    """Port arrays against the reference's: exact, or within ``rtol``."""
    p, r = _np(p), np.asarray(r)
    assert p.shape == r.shape, (label, p.shape, r.shape)
    if rtol is None:
        np.testing.assert_array_equal(p, r, err_msg=label)
    else:
        np.testing.assert_allclose(p, r, rtol=rtol, atol=0, err_msg=label)


class _Count:
    """Wrap a module function with a call counter (monkeypatch)."""

    def __init__(self, monkeypatch, module, name):
        self.n = 0
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            self.n += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)


# ---------------------------------------------------------------------------
# Context, Mesh and placement
# ---------------------------------------------------------------------------


def test_parallel_context(ref):
    """tests/test_misc.py::test_parallel_context on both packages: the
    thread-local stack, shard_matrix on a dense Matrix."""

    def run(pkg):
        par = pkg.parallel
        out = [par.current_context() is None]
        with par.Context() as ctx:
            out.append(par.current_context() is ctx)
            A = pkg.Matrix.from_coo([0, 1], [1, 0], [1.0, 2.0], nrows=8, ncols=8)
            par.shard_matrix(A)
            out.append(A.nvals)
            out.append(repr(ctx))
        out.append(par.current_context() is None)
        return out

    assert run(P) == run(ref) == [True, True, 2, "parallel.Context(mesh=(('i', 2), ('j', 4)))", True]


def test_public_names_match_reference(ref):
    names = [
        {n for n in dir(pkg.parallel) if not n.startswith("_") and not isinstance(getattr(pkg.parallel, n), types.ModuleType)}
        for pkg in (P, ref)
    ]
    assert names[0] == names[1]
    import graphblas_tpu.parallel.spgemm as r_spgemm

    for name in ("sharded_spgemm_analyze", "sharded_spgemm_execute", "sharded_masked_mxm_arrays", "ShardedSpgemmPlan"):
        assert callable(getattr(p_spgemm, name)) and callable(getattr(r_spgemm, name)), name


def test_context_device_rules():
    """The CPU platform: 8 shards by default, ``shape``'s size otherwise,
    the squarest factorization; named devices may repeat; a mesh of another
    size than its devices raises; the CUDA platform with no card raises."""
    ctx = PP.Context()
    assert ctx.mesh.shape == {"i": 2, "j": 4} and ctx.mesh.size == 8
    assert all(d == torch.device("cpu") for d in ctx.mesh.device_list())
    assert PP.Context(shape=(3, 1)).mesh.shape == {"i": 3, "j": 1}
    assert PP.Context(devices=["cpu"] * 6).mesh.shape == {"i": 2, "j": 3}
    assert PP.Context(devices=["cpu"] * 4, axis_names=("r", "c")).axis_names == ("r", "c")
    with pytest.raises(ValueError):
        PP.Context(devices=["cpu"] * 4, shape=(2, 4))
    if not torch.cuda.is_available():
        with P.tx.config.set(platform="cuda"), pytest.raises((RuntimeError, AssertionError, ValueError)):
            PP.Context(shape=(2, 4))


def test_shard_annotations_roundtrip(ref, jmesh, pmesh):
    """shard_matrix / shard_vector / replicate leave the values and record
    the placement (the port's counterpart of a NamedSharding)."""
    rng = np.random.default_rng(21)
    a, v = rng.random((8, 8)), rng.random(8)

    def run(pkg, mesh):
        with pkg.parallel.Context(mesh=mesh):
            A = pkg.Matrix.from_dense(a, dtype=pkg.dtypes.FP64)
            pkg.parallel.shard_matrix(A)
            x = pkg.Vector.from_dense(v)
            pkg.parallel.shard_vector(x)
            pkg.parallel.replicate(x)
            return A, x

    (pA, px), (rA, rx) = _both(ref, jmesh, pmesh, run)
    assert pA.nvals == rA.nvals == 64 and px.nvals == rx.nvals == 8
    assert pA.isequal(P.Matrix.from_dense(a, dtype=P.dtypes.FP64))
    assert pmesh_mod.placement(pA) == (pmesh, ("i", "j"))
    assert pmesh_mod.placement(px) == (pmesh, ())
    # a statement on the replicated vector stays replicated, as the
    # reference's P(); whole tensors written over it drop the placement, as
    # the reference's result on one device
    for x in (px, rx):
        x << x.apply(type(x).__module__.startswith("graphblas_tpu_torch") and P.unary.ainv or ref.unary.ainv)
    assert pmesh_mod.placement(px) == (pmesh, ()) and tuple(rx._values.sharding.spec) == ()
    px << P.Vector.from_dense(v)
    rx << ref.Vector.from_dense(v)
    assert pmesh_mod.placement(px) is None and not hasattr(rx._values.sharding, "spec")
    with pytest.raises(ValueError, match="No mesh Context"):
        PP.shard_vector(px)


# ---------------------------------------------------------------------------
# SUMMA
# ---------------------------------------------------------------------------


def _summa_mxm(rng, m, k, n, sr, density=0.7):
    av, as_ = _rand_masked(rng, (m, k), density)
    bv, bs = _rand_masked(rng, (k, n), density)

    def run(pkg, mesh):
        A, B = _dense_matrix(pkg, av, as_), _dense_matrix(pkg, bv, bs)
        return pkg.parallel.summa_mxm(A, B, _typed(pkg, sr), pkg.dtypes.FP64, mesh)

    return run, (av, as_, bv, bs)


def test_summa_mxm_plus_times(ref, jmesh, pmesh):
    """Against the reference (structure exact, values rtol 1e-12: float64
    sums in another order) and numpy."""
    run, (av, as_, bv, bs) = _summa_mxm(np.random.default_rng(1), 16, 32, 12, "plus_times")
    (pv, ps), (rv, rs) = _both(ref, jmesh, pmesh, run)
    _same(ps, rs, "struct")
    _same(pv, rv, "values", rtol=1e-12)
    exp_s = (as_.astype(int) @ bs.astype(int)) > 0
    _same(ps, exp_s)
    np.testing.assert_allclose(_np(pv)[exp_s], (np.where(as_, av, 0.0) @ np.where(bs, bv, 0.0))[exp_s], rtol=1e-12)


def test_summa_mxm_min_plus_generic_monoid(ref, jmesh, pmesh):
    """min is not plus: the gather and left-to-right fold; bit for bit."""
    run, _ = _summa_mxm(np.random.default_rng(2), 8, 16, 8, "min_plus")
    (pv, ps), (rv, rs) = _both(ref, jmesh, pmesh, run)
    _same(ps, rs, "struct")
    _same(pv, rv, "values")


def test_summa_mxm_nondivisible_shapes(ref, jmesh, pmesh):
    """7 x 13 x 5 divides by no mesh axis: the absent padding, cut back."""
    run, _ = _summa_mxm(np.random.default_rng(3), 7, 13, 5, "plus_times", density=0.9)
    (pv, ps), (rv, rs) = _both(ref, jmesh, pmesh, run)
    assert tuple(pv.shape) == (7, 5)
    _same(ps, rs, "struct")
    _same(pv, rv, "values", rtol=1e-12)


@pytest.mark.parametrize("sr,shape", [("plus_times", (16, 24)), ("min_plus", (11, 9))])
def test_summa_mxv(ref, jmesh, pmesh, sr, shape):
    """plus_times (rtol 1e-12) and min_plus on a non-divisible shape (exact)."""
    rng = np.random.default_rng(4)
    m, k = shape
    av, as_ = _rand_masked(rng, (m, k))
    xv, xs = _rand_masked(rng, (k,))

    def run(pkg, mesh):
        return pkg.parallel.summa_mxv(_dense_matrix(pkg, av, as_), _dense_vector(pkg, xv, xs), _typed(pkg, sr), pkg.dtypes.FP64, mesh)

    (pv, ps), (rv, rs) = _both(ref, jmesh, pmesh, run)
    _same(ps, rs, "struct")
    _same(pv, rv, "values", rtol=1e-12 if sr == "plus_times" else None)


def test_sharded_spmv_step(ref, jmesh, pmesh):
    """Edge-partitioned plus_times step: rtol 1e-12 against the reference
    (float64 partial sums folded in another order) and numpy."""
    rng = np.random.default_rng(5)
    n, ne = 64, 8 * 37
    src, dst = rng.integers(0, n, ne), rng.integers(0, n, ne)
    w, valid, x = rng.random(ne), rng.random(ne) < 0.8, rng.random(n)

    def run(pkg, mesh):
        step = pkg.parallel.sharded_spmv_step(mesh, n)
        return step(*(_like(pkg, a) for a in (src.astype(np.int32), dst.astype(np.int32), w, valid, x)))

    py, ry = _both(ref, jmesh, pmesh, run)
    _same(py, ry, rtol=1e-12)
    expected = np.zeros(n)
    np.add.at(expected, dst[valid], w[valid] * x[src[valid]])
    np.testing.assert_allclose(_np(py), expected, rtol=1e-12)


def _dsl_operands(seed, m=12, k=20, n=10):
    rng = np.random.default_rng(seed)
    return rng.random((m, k)), rng.random((k, n)), rng.random(k)


def test_dsl_routes_through_summa_under_context(ref, jmesh, pmesh, monkeypatch):
    """Inside an engaged Context A.mxm(B), A.mxv(x) and x.vxm(B) run SUMMA
    (one summa_mxm_arrays and two summa_mxv_arrays calls) and equal the same
    statements outside it and the reference's (rtol 1e-12)."""
    av, bv, xv = _dsl_operands(6)
    from graphblas_tpu_torch.parallel import summa as p_summa

    c_mxm = _Count(monkeypatch, p_summa, "summa_mxm_arrays")
    c_mxv = _Count(monkeypatch, p_summa, "summa_mxv_arrays")

    def run(pkg, mesh):
        A, B = pkg.Matrix.from_dense(av, dtype=pkg.dtypes.FP64), pkg.Matrix.from_dense(bv, dtype=pkg.dtypes.FP64)
        x = pkg.Vector.from_dense(xv)
        sr = pkg.semiring
        outside = [A.mxm(B, sr.plus_times).new(), A.mxv(x, sr.min_plus).new(), x.vxm(B, sr.plus_times).new()]
        with pkg.parallel.Context(mesh=mesh):
            inside = [A.mxm(B, sr.plus_times).new(), A.mxv(x, sr.min_plus).new(), x.vxm(B, sr.plus_times).new()]
        return outside, inside

    (p0, p1), (r0, r1) = _both(ref, jmesh, pmesh, run)
    assert (c_mxm.n, c_mxv.n) == (1, 2)
    for a, b, c in zip(p1, p0, r1):
        np.testing.assert_allclose(_np(a._values), _np(b._values), rtol=1e-12)
        np.testing.assert_allclose(_np(a._values), np.asarray(c._values), rtol=1e-12)


def test_dsl_pagerank_on_mesh(ref, jmesh, pmesh, monkeypatch):
    """A DSL PageRank loop runs unchanged inside the Context (its A.T.mxv on
    SUMMA, 10 calls), = outside and = the reference's (rtol 1e-10)."""
    rng = np.random.default_rng(7)
    n, e = 24, 120
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    from graphblas_tpu_torch.parallel import summa as p_summa

    calls = _Count(monkeypatch, p_summa, "summa_mxv_arrays")

    def run(pkg, mesh):
        A = pkg.Matrix.from_coo(src, dst, 1.0, nrows=n, ncols=n, dup_op=pkg.binary.first)

        def pagerank(iters=10, damping=0.85):
            outdeg = A.reduce_rowwise("plus").new(pkg.dtypes.FP64)
            inv = outdeg.apply(pkg.unary.minv).new()
            rank = pkg.Vector.from_dense(np.full(n, 1.0 / n))
            for _ in range(iters):
                contrib = rank.ewise_mult(inv, pkg.binary.times).new()
                pulled = A.T.mxv(contrib, pkg.semiring.plus_times).new()
                rank = pulled.apply(pkg.binary.times, right=damping).apply(pkg.binary.plus, right=(1.0 - damping) / n).new()
            return _np(rank._values)

        r0 = pagerank()
        with pkg.parallel.Context(mesh=mesh):
            r1 = pagerank()
        return r0, r1

    (p0, p1), (r0, r1) = _both(ref, jmesh, pmesh, run)
    assert calls.n == 10
    np.testing.assert_allclose(p1, p0, rtol=1e-10)
    np.testing.assert_allclose(p1, r1, rtol=1e-10)


# ---------------------------------------------------------------------------
# the sharded SpMV engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sharded_graph(ref, jmesh, pmesh):
    rng = np.random.default_rng(11)
    n, e = 300, 2500
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    with P.tx.config.set(platform="cpu"):
        psplan = PP.build_sharded_spmv_plan(src, dst, w, n=n, mesh=pmesh)
    jsplan = ref.parallel.build_sharded_spmv_plan(src, dst, w, n=n, mesh=jmesh)
    return {"p": psplan, "j": jsplan, "src": src, "dst": dst, "w": w, "n": n}


_PLAIN_ARRAYS = (
    "src_sorted", "w_dst_order", "indptr_src", "indptr_dst", "valid_dst_order", "src_dst_order", "seg_start_src",
    "seg_start_dst", "dst_nonempty", "start_has_state", "is_last_dst", "outdeg_start", "last_dangling",
)
_ROUTES = (("perm_idx", "perm_plan"), ("place_idx", "place_plan"), ("collect_idx", "collect_plan"), ("loop_idx", "loop_plan"))


def test_sharded_plan_arrays_match_reference_leaves(sharded_graph):
    """Each shard's SpmvPlan equals the reference's stacked leaf of that
    shard slot for slot (routes as the reference networks applied to
    arange, fill_src from its seg_start_src); the dst bounds are equal."""
    import jax
    import jax.numpy as jnp
    from graphblas_tpu.ops.permute import apply_plan

    from graphblas_tpu_torch.ops.scan import build_fill_tables

    ps, js = sharded_graph["p"], sharded_graph["j"]
    assert ps.bounds == js.bounds and (ps.ndev, ps.n) == (js.ndev, js.n) == (8, 300)
    for k, plan in enumerate(ps.plans):
        jk = jax.tree.map(lambda a, k=k: a[k], js.stacked)
        assert plan.e_pad == int(jk.e_pad) and plan.k_iso_dangling == int(jk.k_iso_dangling) == 0
        assert plan.device == torch.device("cpu")
        for name in _PLAIN_ARRAYS:
            _same(getattr(plan, name), getattr(jk, name), f"shard {k} {name}")
        for idx_name, net_name in _ROUTES:
            routed = apply_plan(jnp.arange(plan.e_pad, dtype=jnp.int32), getattr(jk, net_name))
            _same(getattr(plan, idx_name), routed, f"shard {k} {idx_name}")
        _same(plan.fill_src, build_fill_tables(np.asarray(jk.seg_start_src)), f"shard {k} fill_src")


def test_row_blocks_and_dst_bounds_match_reference(ref):
    from graphblas_tpu.parallel import spgemm as r_spgemm

    rng = np.random.default_rng(12)
    for rows, nrows, ndev in (
        (np.sort(rng.integers(0, 100, 700)), 100, 8),
        (np.repeat(np.arange(5), [1, 50, 2, 0, 9]), 5, 8),
        (np.empty(0, np.int64), 37, 8),
        (np.arange(3), 3, 4),
    ):
        assert p_spgemm._row_blocks(rows, nrows, ndev) == r_spgemm._row_blocks(rows, nrows, ndev)
    for n, ndev in ((300, 8), (7, 8), (1 << 12, 3)):
        src = dst = np.arange(n) % max(n, 1)
        got = PP.build_sharded_spmv_plan(src, dst, n=n, mesh=PP.Context(devices=["cpu"] * ndev, shape=(1, ndev)).mesh).bounds
        assert got == [(k * n) // ndev for k in range(ndev + 1)]


_SPMV_CASES = [(a, m) for a in ("plus", "min", "max") for m in ("times", "first", "second")]


def test_sharded_fastspmv_vs_single_device(sharded_graph):
    """The 8-shard engine against the reference's 8-device one and the port's
    single-device spmv: min and max bit for bit, plus within rtol 1e-5
    (float32 scans in another order)."""
    from graphblas_tpu.parallel import sharded_spmv as r_sharded

    from graphblas_tpu_torch.ops import fastspmv as pfs

    g = sharded_graph
    x = np.random.default_rng(13).random(g["n"]).astype(np.float32)
    single = pfs.build_spmv_plan(g["src"], g["dst"], g["w"], n=g["n"], device="cpu")
    for add, mul in _SPMV_CASES:
        y = PP.sharded_spmv(g["p"], torch.from_numpy(x), add=add, mul=mul)
        assert y.dtype == torch.float32 and y.shape == (g["n"],)
        rtol = 1e-5 if add == "plus" else None
        _same(y, r_sharded(g["j"], x, add=add, mul=mul), f"{add}_{mul}", rtol)
        _same(y, pfs.spmv(single, torch.from_numpy(x), add, mul), f"{add}_{mul} single", rtol)


def test_sharded_fastspmv_masked_secondi(sharded_graph):
    """Masked SpMV with the positional parent-BFS semiring: structures, min
    and any/secondi bit for bit, plus rtol 1e-5."""
    from graphblas_tpu.parallel import sharded_spmv_masked as r_masked

    g = sharded_graph
    rng = np.random.default_rng(14)
    x, xs = rng.random(g["n"]).astype(np.float32), rng.random(g["n"]) > 0.4
    for add, mul in (("plus", "times"), ("min", "times"), ("any", "secondi")):
        pv, ps = PP.sharded_spmv_masked(g["p"], torch.from_numpy(x), torch.from_numpy(xs), add=add, mul=mul)
        rv, rs = r_masked(g["j"], x, xs, add=add, mul=mul)
        _same(ps, rs, f"{add}_{mul} struct")
        assert str(pv.dtype).split(".")[-1] == str(np.asarray(rv).dtype), (pv.dtype, np.asarray(rv).dtype)
        _same(pv, rv, f"{add}_{mul}", 1e-5 if add == "plus" else None)


def test_sharded_pagerank_vs_oracle(sharded_graph):
    """The whole PageRank loop against the reference's (rtol 1e-5, the same
    iteration count) and a float64 dense oracle (atol 3e-5, as the
    reference's test)."""
    from graphblas_tpu.parallel import sharded_pagerank as r_pagerank

    g = sharded_graph
    r, iters = PP.sharded_pagerank(g["p"])
    rj, itj = r_pagerank(g["j"])
    assert iters == int(itj) and iters > 1
    _same(r, rj, rtol=1e-5)
    n = g["n"]
    A = np.zeros((n, n))
    np.add.at(A, (g["src"], g["dst"]), 1.0)
    deg = A.sum(1)
    dang = deg == 0
    PT = (A / np.where(dang, 1.0, deg)[:, None]).T
    rr = np.full(n, 1.0 / n)
    for _ in range(300):
        rr = 0.15 / n + 0.85 * (PT @ rr + rr[dang].sum() / n)
    np.testing.assert_allclose(_np(r), rr, atol=3e-5)


def test_sharded_bfs_and_sssp(sharded_graph):
    """Level BFS and SSSP over the mesh = the reference's sharded loops and
    the port's single-device models.fast, bit for bit."""
    from graphblas_tpu.parallel import sharded_bfs_level as r_bfs
    from graphblas_tpu.parallel import sharded_sssp as r_sssp

    from graphblas_tpu_torch.models import fast as pf

    g = sharded_graph
    plan = pf.build_spmv_plan(g["src"], g["dst"], g["w"], n=g["n"], device="cpu")
    for s0 in (0, 7):
        lv = PP.sharded_bfs_level(g["p"], s0)
        assert lv.dtype == torch.int32
        _same(lv, r_bfs(g["j"], s0), f"bfs {s0}")
        _same(lv, pf.bfs_level(plan, s0, g["n"]), f"bfs {s0} single")
        d = PP.sharded_sssp(g["p"], s0)
        _same(d, r_sssp(g["j"], s0), f"sssp {s0}")
        ds = _np(pf.sssp(plan, s0, g["n"]))
        reach = ds < 1e30
        np.testing.assert_array_equal(_np(d)[reach], ds[reach])


def test_sharded_fastspmv_empty_partition(ref, jmesh, pmesh):
    """Shards 1-7 own no edge: they contribute identities only; = the
    reference and the single-device plan."""
    from graphblas_tpu_torch.ops import fastspmv as pfs

    n = 160
    src = np.arange(40)
    dst = (np.arange(40) * 7) % (n // 8)
    x = np.linspace(0.5, 2.0, n).astype(np.float32)
    ps = PP.build_sharded_spmv_plan(src, dst, None, n=n, mesh=pmesh)
    js = ref.parallel.build_sharded_spmv_plan(src, dst, None, n=n, mesh=jmesh)
    assert [int(p.valid_dst_order.sum()) for p in ps.plans] == [40] + [0] * 7
    y = PP.sharded_spmv(ps, torch.from_numpy(x), add="plus", mul="first")
    _same(y, ref.parallel.sharded_spmv(js, x, add="plus", mul="first"), rtol=1e-6)
    _same(y, pfs.spmv(pfs.build_spmv_plan(src, dst, None, n=n, device="cpu"), torch.from_numpy(x), "plus", "first"), rtol=1e-6)


def test_dsl_sparse_mxv_inside_context(ref, jmesh, pmesh, monkeypatch):
    """A sparse-format DSL mxv and vxm inside an engaged Context run the
    sharded engine (two sharded_spmv_masked calls; the plans cached by
    direction and device list) and = outside (rtol 1e-5) and the
    reference's inside (rtol 1e-5)."""
    from graphblas_tpu_torch.parallel import fastspmv as p_fs

    calls = _Count(monkeypatch, p_fs, "sharded_spmv_masked")
    rng = np.random.default_rng(15)
    n, e = 300, 3000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    xi = rng.integers(0, n, 150)

    def run(pkg, mesh):
        with pkg.tx.config.set(dense_limit=0, mxv_strategy="plan"):
            A = pkg.Matrix.from_coo(src, dst, w, pkg.dtypes.FP32, nrows=n, ncols=n, dup_op="plus")
            x = pkg.Vector.from_coo(xi, 1.0, pkg.dtypes.FP32, size=n, dup_op="first")
            expected = A.mxv(x, pkg.semiring.plus_times).new()
            assert A._sparse is not None and A._sparse._sharded_plans == {}
            with pkg.parallel.Context(mesh=mesh):
                got = A.mxv(x, pkg.semiring.plus_times).new()
                got_vxm = x.vxm(A, pkg.semiring.min_plus).new()
            assert A._sparse._sharded_plans
            expected_vxm = x.vxm(A, pkg.semiring.min_plus).new()
        return got, expected, got_vxm, expected_vxm, A

    (pg, pe, pgv, pev, pA), (rg, re_, rgv, rev, _) = _both(ref, jmesh, pmesh, run)
    assert calls.n == 2
    assert set(pA._sparse._sharded_plans) == {("pull", pmesh.key()), ("push", pmesh.key())}
    assert pg.isclose(pe, rel_tol=1e-5) and pgv.isequal(pev)
    from test_torch_collections import assert_same

    assert_same(pg, rg, "mxv", rtol=1e-5)
    assert_same(pgv, rgv, "vxm", rtol=0)


# ---------------------------------------------------------------------------
# the sharded masked SpGEMM
# ---------------------------------------------------------------------------


def _tri_graph(pkg, rng_seed, ns=400, extra=1200):
    """Lower-triangle L of a random clustered undirected graph and its U."""
    rng = np.random.default_rng(rng_seed)
    base = np.arange(ns) - (np.arange(ns) % 8)
    rs = np.concatenate([np.arange(ns)] * 3 + [rng.integers(0, ns, extra)])
    cs = np.concatenate([base + (np.arange(ns) + d) % 8 for d in (1, 2, 3)] + [rng.integers(0, ns, extra)])
    lo, hi = np.minimum(rs, cs), np.maximum(rs, cs)
    keep = lo != hi
    with pkg.tx.config.set(dense_limit=0):
        L = pkg.Matrix.from_coo(
            hi[keep], lo[keep], np.float32(1.0), pkg.dtypes.FP32, nrows=ns, ncols=ns, dup_op=pkg.binary.first
        )
        U = L.T.new()
    return L, U


def _key_sorted(r, c, v):
    order = np.lexsort((np.asarray(c), np.asarray(r)))
    return np.asarray(r)[order], np.asarray(c)[order], np.asarray(v)[order]


def _masked(ref, pmesh, jmesh, sr, mask_rows=None, **tri):
    """(port, reference) sharded and single-device masked products."""
    from graphblas_tpu.core.sparse import sparse_mxm_masked as r_single
    from graphblas_tpu.parallel.spgemm import sharded_masked_mxm_arrays as r_sharded

    from graphblas_tpu_torch.core.sparse import sparse_mxm_masked as p_single

    out = {}
    for pkg, mesh, sharded, single in ((P, pmesh, p_spgemm.sharded_masked_mxm_arrays, p_single), (ref, jmesh, r_sharded, r_single)):
        L, U = _tri_graph(pkg, 16, **tri)
        lsp, usp = L._sparse, U._sparse
        mr, mc = np.asarray(lsp.rows), np.asarray(lsp.cols)
        if mask_rows is not None:
            keep = mr < mask_rows
            mr, mc = mr[keep], mc[keep]
        srt = _typed(pkg, sr, "FP32")
        kw = {"device": "cpu"} if pkg is P else {}
        a = sharded(lsp, usp, mr, mc, srt, pkg.dtypes.FP32, pkg.parallel.Context(mesh=mesh))
        b = single(lsp, usp, mr, mc, srt, pkg.dtypes.FP32, **kw)
        out[pkg is P] = (a, b, lsp, usp, mr, mc)
    return out[True], out[False]


def test_sharded_masked_spgemm_plus_pair_vs_single(ref, jmesh, pmesh):
    """The sharded plus_pair product = the single-device one and the
    reference's sharded one, entry for entry (counts in f32: exact); the
    work spreads over several shards."""
    (pa, pb, lsp, usp, mr, mc), (ra, rb, *_) = _masked(ref, pmesh, jmesh, "plus_pair")
    for got, want in ((pa, pb), (pa, ra), (rb, ra)):
        for x, y in zip(_key_sorted(*got[:3]), _key_sorted(*want[:3])):
            np.testing.assert_array_equal(x, y)
        assert int(got[3]) == int(want[3])
    splan = p_spgemm.sharded_spgemm_analyze(lsp, usp, mr, mc, pmesh.device_list())
    assert sum(p is not None for _, p, _ in splan.blocks) > 1


def test_sharded_masked_spgemm_min_plus_and_empty_blocks(ref, jmesh, pmesh):
    """min_plus through the sharded path with a mask on 8 rows: blocks with
    no mask entry get no plan; = single device and the reference, bit for
    bit."""
    (pa, pb, lsp, usp, mr, mc), (ra, *_) = _masked(ref, pmesh, jmesh, "min_plus", mask_rows=8, ns=64, extra=100)
    for got, want in ((pa, pb), (pa, ra)):
        for x, y in zip(_key_sorted(*got[:3]), _key_sorted(*want[:3])):
            np.testing.assert_array_equal(x, y)
    splan = p_spgemm.sharded_spgemm_analyze(lsp, usp, mr, mc, pmesh.device_list())
    assert any(p is None for _, p, _ in splan.blocks)
    vals, hits, flops = p_spgemm.sharded_spgemm_execute(splan, _typed(P, "min_plus", "FP32"), P.dtypes.FP32)
    assert vals.shape == hits.shape == (len(mr),) and int(flops) == int(pa[3])


def test_dsl_masked_mxm_routes_through_mesh(ref, jmesh, pmesh, monkeypatch):
    """C(L.S) << L.mxm(U, plus_pair) inside a Context (one sharded call) =
    outside = the reference's, and the triangle counts agree."""
    calls = _Count(monkeypatch, p_spgemm, "sharded_masked_mxm_arrays")

    def run(pkg, mesh):
        L, U = _tri_graph(pkg, 17, ns=200, extra=600)
        single = L.mxm(U, pkg.semiring.plus_pair).new(mask=L.S)
        with pkg.parallel.Context(mesh=mesh):
            meshed = L.mxm(U, pkg.semiring.plus_pair).new(mask=L.S)
        return single, meshed, float(meshed.reduce_scalar("plus").new().value)

    (ps, pm, pt), (rs, rm, rt) = _both(ref, jmesh, pmesh, run)
    assert calls.n == 1
    assert ps.isequal(pm, check_dtype=True) and pt == rt == float(ps.reduce_scalar("plus").new().value)
    from test_torch_collections import assert_same

    assert_same(pm, rm, rtol=0)


def test_shard_matrix_rejects_sparse(ref, jmesh, pmesh):
    for pkg, mesh in ((P, pmesh), (ref, jmesh)):
        L, _ = _tri_graph(pkg, 18, ns=64, extra=50)
        assert L._sparse is not None
        with pkg.parallel.Context(mesh=mesh), pytest.raises(TypeError, match="dense-format"):
            pkg.parallel.shard_matrix(L)


# ---------------------------------------------------------------------------
# masks, accumulators and the other op families on placed operands
# ---------------------------------------------------------------------------


def _placed_mats(pkg, mesh, arrays, shard=True):
    mats = [_dense_matrix(pkg, v, s) for v, s in arrays]
    if shard:
        for M in mats:
            pkg.parallel.shard_matrix(M, pkg.parallel.Context(mesh=mesh))
    return mats


def test_summa_masked_accum_replace_through_dsl(ref, jmesh, pmesh):
    """C(M.S, accum=plus, replace) << A.mxm(B) on sharded operands inside
    the Context = outside (rtol 1e-12, float64 sums reordered) = reference."""
    rng = np.random.default_rng(19)
    arr = [_rand_masked(rng, (16, 32)), _rand_masked(rng, (32, 16)), _rand_masked(rng, (16, 16), 0.5), _rand_masked(rng, (16, 16))]

    def run(pkg, mesh):
        A, B, M, C_single = _placed_mats(pkg, mesh, arr[:3] + arr[3:], shard=False)
        C_mesh = _dense_matrix(pkg, *arr[3])
        C_single(M.S, accum=pkg.binary.plus, replace=True) << A.mxm(B, pkg.semiring.plus_times)
        with pkg.parallel.Context(mesh=mesh):
            pkg.parallel.shard_matrix(A)
            pkg.parallel.shard_matrix(B)
            C_mesh(M.S, accum=pkg.binary.plus, replace=True) << A.mxm(B, pkg.semiring.plus_times)
        return C_single, C_mesh

    (ps, pm), (rs, rm) = _both(ref, jmesh, pmesh, run)
    assert ps.isclose(pm, rel_tol=1e-12, check_dtype=True)
    from test_torch_collections import assert_same

    assert_same(pm, rm, rtol=1e-12)


def test_summa_masked_complement_mask_through_dsl(ref, jmesh, pmesh):
    rng = np.random.default_rng(20)
    arr = [_rand_masked(rng, (16, 16)), _rand_masked(rng, (16, 16)), _rand_masked(rng, (16, 16), 0.5)]

    def run(pkg, mesh):
        A, B, M = _placed_mats(pkg, mesh, arr, shard=False)
        single = A.mxm(B, pkg.semiring.plus_times).new(mask=~M.S)
        with pkg.parallel.Context(mesh=mesh):
            meshed = A.mxm(B, pkg.semiring.plus_times).new(mask=~M.S)
        return single, meshed

    (ps, pm), (rs, rm) = _both(ref, jmesh, pmesh, run)
    assert ps.isclose(pm, rel_tol=1e-12, check_dtype=True)
    from test_torch_collections import assert_same

    assert_same(pm, rm, rtol=1e-12)


def _family_case(ref, jmesh, pmesh, arrays, statements, sums=()):
    """``statements(pkg, mats)`` on plain operands and on placed ones inside
    the Context: equal (bit for bit; the outputs at ``sums``, FP64 plus
    reductions, within rtol 1e-12, the reference's own tolerance), placed
    over all 8 shards with the reference's spec, and = the reference's."""
    from test_torch_collections import assert_same

    def run(pkg, mesh):
        plain = statements(pkg, _placed_mats(pkg, mesh, arrays, shard=False))
        with pkg.parallel.Context(mesh=mesh):
            placed = statements(pkg, _placed_mats(pkg, mesh, arrays))
        return plain, placed

    (p0, p1), (r0, r1) = _both(ref, jmesh, pmesh, run)
    for t, (a, b, c) in enumerate(zip(p0, p1, r1)):
        if hasattr(a, "isequal"):
            if t in sums:
                assert a.isclose(b, rel_tol=1e-12, check_dtype=True)
            else:
                assert a.isequal(b, check_dtype=True)
            mesh, spec = pmesh_mod.placement(b)
            assert mesh is pmesh and spec == tuple(c._values.sharding.spec)
            assert len(c._values.sharding.device_set) == mesh.size == 8
            assert_same(b, c, rtol=1e-12)
        else:
            np.testing.assert_allclose(float(b), float(a), rtol=1e-12)
            np.testing.assert_allclose(float(b), float(c), rtol=1e-12)


def test_sharded_ewise_add_mult(ref, jmesh, pmesh):
    rng = np.random.default_rng(22)
    _family_case(
        ref, jmesh, pmesh, [_rand_masked(rng, (16, 24)), _rand_masked(rng, (16, 24))],
        lambda pkg, m: [
            m[0].ewise_add(m[1], pkg.binary.plus).new(),
            m[0].ewise_mult(m[1], pkg.binary.times).new(),
            m[0].ewise_union(m[1], pkg.binary.minus, 1.5, -2.0).new(),
        ],
    )


def test_sharded_ewise_masked_accum_replace(ref, jmesh, pmesh):
    rng = np.random.default_rng(23)

    def statements(pkg, m):
        A, B, M, C = m
        C(M.V, accum=pkg.binary.plus, replace=True) << A.ewise_add(B, pkg.binary.max)
        return [C]

    _family_case(ref, jmesh, pmesh, [_rand_masked(rng, (16, 16)) for _ in range(2)] + [_rand_masked(rng, (16, 16), 0.5), _rand_masked(rng, (16, 16))], statements)


def test_sharded_apply_and_select(ref, jmesh, pmesh):
    rng = np.random.default_rng(24)
    _family_case(
        ref, jmesh, pmesh, [_rand_masked(rng, (16, 24))],
        lambda pkg, m: [m[0].apply(pkg.unary.ainv).new(), m[0].select(pkg.select.valuegt, 0.5).new()],
    )


def test_sharded_reduce_rowwise_colwise_scalar(ref, jmesh, pmesh):
    rng = np.random.default_rng(25)
    _family_case(
        ref, jmesh, pmesh, [_rand_masked(rng, (24, 16))],
        lambda pkg, m: [
            m[0].reduce_rowwise("plus").new(),
            m[0].reduce_columnwise("max").new(),
            m[0].reduce_scalar("plus").new().value,
        ],
        sums=(0,),
    )


def test_sharded_vector_ewise_and_reduce(ref, jmesh, pmesh):
    rng = np.random.default_rng(26)
    av, as_, bv, bs = rng.random(48), rng.random(48) < 0.7, rng.random(48), rng.random(48) < 0.7

    def run(pkg, mesh):
        def statements(u, w):
            return u.ewise_add(w, pkg.binary.plus).new(), float(u.reduce("plus").new().value)

        plain = statements(_dense_vector(pkg, av, as_), _dense_vector(pkg, bv, bs))
        with pkg.parallel.Context(mesh=mesh):
            placed = statements(pkg.parallel.shard_vector(_dense_vector(pkg, av, as_)), pkg.parallel.shard_vector(_dense_vector(pkg, bv, bs)))
        return plain, placed

    (p0, p1), (r0, r1) = _both(ref, jmesh, pmesh, run)
    assert p0[0].isequal(p1[0], check_dtype=True)
    from test_torch_collections import assert_same

    assert_same(p1[0], r1[0], rtol=0)
    np.testing.assert_allclose(p1[1], p0[1], rtol=1e-12)
    np.testing.assert_allclose(p1[1], r1[1], rtol=1e-12)


# ---------------------------------------------------------------------------
# __graft_entry__.dryrun_multichip's checks, on the port's 8-shard mesh
# ---------------------------------------------------------------------------


def _dryrun(pkg, ctx, check):
    """One check of the dryrun on ``pkg``: its shapes (m = 8 pi, k = 8 pj),
    its inputs (numpy seed 0 in the dryrun's order), its statements; returns
    what it compares."""
    mesh = ctx.mesh
    pi, pj = (mesh.shape[a] for a in mesh.axis_names)
    m, k = 8 * pi, 8 * pj
    rng = np.random.default_rng(0)
    F = pkg.dtypes.FP32
    A = pkg.Matrix.from_dense(rng.random((m, k)), missing_value=None, dtype=F)
    B = pkg.Matrix.from_dense(rng.random((k, m)), dtype=F)
    x = pkg.Vector.from_dense(rng.random(k).astype(np.float32))
    with ctx:
        pkg.parallel.shard_matrix(A)
        pkg.parallel.shard_vector(x)
    a_np, b_np, x_np = _np(A._values), _np(B._values), _np(x._values)
    if check == "dsl_summa":
        with ctx:
            C = A.mxm(B, pkg.semiring.plus_times).new()
        return _np(C._values), a_np @ b_np
    if check == "summa_mxm":
        cv, _ = pkg.parallel.summa_mxm(A, B, _typed(pkg, "plus_times", "FP32"), F, mesh)
        return _np(cv), a_np @ b_np
    if check == "summa_mxv_min_plus":
        yv, _ = pkg.parallel.summa_mxv(A, x, _typed(pkg, "min_plus", "FP32"), F, mesh)
        return _np(yv), (a_np[:, :, None] + x_np[None, :, None]).min(axis=1)[:, 0]
    graph = importlib.import_module(f"{pkg.__name__}.models.graph")
    g = graph.rmat(6, 4, seed=1, weighted=True, **({"device": "cpu"} if pkg is P else {}))
    src, dst, w, valid = (_np(a) for a in (g.src, g.dst, g.weights, g.valid))
    total = max(mesh.size, -(-len(src) // mesh.size) * mesh.size)
    if total != len(src):
        extra = total - len(src)
        src, dst, w, valid = (np.pad(a, (0, extra)) for a in (src, dst, w, valid))
    want = np.zeros(g.n, np.float32)
    np.add.at(want, dst[valid], w[valid])
    if check == "spmv_step":
        step = pkg.parallel.sharded_spmv_step(mesh, g.n)
        y = step(*(_like(pkg, a) for a in (src, dst, w, valid)), _like(pkg, np.ones(g.n, np.float32)))
        return _np(y), want
    if check == "sharded_spmv_pagerank":
        splan = pkg.parallel.build_sharded_spmv_plan(src[valid].astype(np.int64), dst[valid].astype(np.int64), w[valid], n=g.n, mesh=mesh)
        y = pkg.parallel.sharded_spmv(splan, _like(pkg, np.ones(g.n, np.float32)), add="plus", mul="times")
        r, iters = pkg.parallel.sharded_pagerank(splan)
        assert int(iters) > 1
        return np.concatenate([_np(y), [float(np.sum(_np(r)))]]), np.concatenate([want, [1.0]])
    if check == "masked_spgemm":
        ns = 96
        rs, cs = rng.integers(0, ns, 600), rng.integers(0, ns, 600)
        lo, hi = np.minimum(rs, cs), np.maximum(rs, cs)
        keep = lo != hi
        with pkg.tx.config.set(dense_limit=0):
            L = pkg.Matrix.from_coo(hi[keep], lo[keep], np.float32(1.0), F, nrows=ns, ncols=ns, dup_op=pkg.binary.first)
            U = L.T.new()
        single = L.mxm(U, pkg.semiring.plus_pair).new(mask=L.S)
        with ctx:
            meshed = L.mxm(U, pkg.semiring.plus_pair).new(mask=L.S)
        assert single.isequal(meshed, check_dtype=True)
        return np.asarray([float(meshed.reduce_scalar("plus").new().value)]), None
    assert check == "mask_accum_replace"
    rng = np.random.default_rng(1)
    Mv, Ms = rng.random((m, m)).astype(np.float32), rng.random((m, m)) < 0.5
    M = pkg.Matrix.from_dense(np.where(Ms, Mv, 0.0), dtype=F)
    M._struct = _like(pkg, Ms)
    C0 = pkg.Matrix.from_dense(rng.random((m, m)), dtype=F)
    C1 = C0.dup()
    C0(M.S, accum=pkg.binary.plus, replace=True) << A.mxm(B, pkg.semiring.plus_times)
    with ctx:
        C1(M.S, accum=pkg.binary.plus, replace=True) << A.mxm(B, pkg.semiring.plus_times)
    # the dryrun asks isequal; the port's SUMMA sums the f32 partials of
    # k = 8 pj in four parts, one torch.matmul sums them at once: rel 1e-6
    assert C0.isclose(C1, rel_tol=1e-6, check_dtype=True)
    return _np(C1._values), _np(C0._values)


DRYRUN_CHECKS = ["dsl_summa", "summa_mxm", "summa_mxv_min_plus", "spmv_step", "sharded_spmv_pagerank", "masked_spgemm", "mask_accum_replace"]


@pytest.mark.parametrize("check", DRYRUN_CHECKS)
def test_dryrun_multichip_checks(ref, jmesh, pmesh, check):
    """Each check of ``__graft_entry__.dryrun_multichip`` holds on the port
    (its own numpy comparison, rtol 1e-4 as there) and equals the
    reference's run of it (rtol 1e-5; min_plus and counts exact)."""
    pg, pw = _dryrun(P, PP.Context(mesh=pmesh), check)
    rg, _ = _dryrun(ref, ref.parallel.Context(mesh=jmesh), check)
    if pw is not None:
        np.testing.assert_allclose(pg, pw, rtol=1e-3 if check == "sharded_spmv_pagerank" else 1e-4)
    exact = check in ("summa_mxv_min_plus", "masked_spgemm")
    _same(pg, rg, check, None if exact else 1e-5)


# ---------------------------------------------------------------------------
# on the card: 8 shards on one GPU (phase 6p of chip_smoke.py at full size)
# ---------------------------------------------------------------------------


def _cuda_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return PP.Context(devices=[torch.device("cuda", 0)] * 8, shape=(2, 4)).mesh


def _launched(names):
    torch.cuda.synchronize()
    launches, plain = kernels.launch_counts(), kernels.plain_counts()
    for name in names:
        assert launches[name] > 0, (name, launches)
    assert not any(plain.values()), plain


@pytest.mark.cuda
def test_cuda_sharded_spmv_matches_single_device():
    """RMAT scale 12: the sharded SpMV and masked SpMV = the single-device
    engine on the card (min, max, any/secondi bit for bit, plus rtol 1e-5),
    through G, C with its fused gather, C and the generic scan."""
    mesh = _cuda_mesh()
    from graphblas_tpu_torch.models import graph as pg
    from graphblas_tpu_torch.ops import fastspmv as pfs

    g = pg.rmat(12, 16, seed=5, weighted=True, device="cuda")
    valid = g.valid.cpu().numpy()
    src, dst, w = (a.cpu().numpy()[valid] for a in (g.src, g.dst, g.weights))
    single = pfs.build_spmv_plan(src, dst, w, n=g.n)
    kernels.reset_counts()
    splan = PP.build_sharded_spmv_plan(src, dst, w, n=g.n, mesh=mesh)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.rand(g.n, generator=gen, device="cuda")
    xs = torch.rand(g.n, generator=gen, device="cuda") < 0.3
    for add, mul in (("plus", "times"), ("max", "first"), ("min", "plus")):
        y, ys = PP.sharded_spmv(splan, x, add, mul), pfs.spmv(single, x, add, mul)
        if add == "plus":
            torch.testing.assert_close(y, ys, rtol=1e-5, atol=0)
        else:
            assert torch.equal(y, ys), (add, mul)
    for add, mul in (("plus", "times"), ("min", "secondi")):
        (v, s), (v1, s1) = PP.sharded_spmv_masked(splan, x, xs, add, mul), pfs.spmv_masked(single, x, xs, add, mul)
        assert torch.equal(s, s1)
        if add == "plus":
            torch.testing.assert_close(v, v1, rtol=1e-5, atol=0)
        else:
            assert torch.equal(v, v1)
    _launched(("gather", "segscan_contrib_gather", "segscan_contrib", "segscan"))


@pytest.mark.cuda
def test_cuda_summa_reaches_gb_tropical():
    """SUMMA at 512^2 on the card: min_plus bit for bit against the
    single-device engine, each (256 x 128) . (128 x 512) block on gb_tropical;
    plus_times within rtol 1e-5 (TF32 off)."""
    mesh = _cuda_mesh()
    from graphblas_tpu_torch.ops import densemasked as dm

    rng = np.random.default_rng(8)
    a, b = (torch.from_numpy(rng.random((512, 512), np.float32)).cuda() for _ in range(2))
    s = torch.ones(512, 512, dtype=torch.bool, device="cuda")
    kernels.reset_counts()
    for sr, exact in (("min_plus", True), ("plus_times", False)):
        t = p_typed(getattr(P.semiring, sr), P.dtypes.FP32, kind="semiring")
        placed, (dv, ds) = PP.summa_mxm_arrays(a, s, b, s, t, P.dtypes.FP32, mesh), dm.mxm(a, s, b, s, t, P.dtypes.FP32)
        assert placed[0].spec == ("i",)  # the product stays on its shards, P(i,)
        cv, cs = (pblocks.whole(x) for x in placed)
        assert torch.equal(cs, ds)
        if exact:
            assert torch.equal(cv, dv)
        else:
            torch.testing.assert_close(cv, dv, rtol=1e-5, atol=0)
    _launched(("tropical_mxm",))
    assert kernels.launch_counts()["tropical_mxm"] >= 9  # 8 blocks and the single-device reference


@pytest.mark.cuda
def test_cuda_sharded_spgemm_matches_single_device():
    """The masked plus_pair SpGEMM in 8 row blocks on the card = the
    single-device result bit for bit, through eqjoin."""
    mesh = _cuda_mesh()
    from graphblas_tpu_torch.core.sparse import sparse_mxm_masked

    L, U = _tri_graph(P, 16)
    lsp, usp = L._sparse, U._sparse
    sr = p_typed(P.semiring.plus_pair, P.dtypes.FP32, kind="semiring")
    kernels.reset_counts()
    got = p_spgemm.sharded_masked_mxm_arrays(lsp, usp, lsp.rows, lsp.cols, sr, P.dtypes.FP32, PP.Context(mesh=mesh))
    _launched(("eqjoin",))
    want = sparse_mxm_masked(lsp, usp, lsp.rows, lsp.cols, sr, P.dtypes.FP32)
    for x, y in zip(_key_sorted(*got[:3]), _key_sorted(*want[:3])):
        np.testing.assert_array_equal(x, y)
    assert got[3] == want[3]
