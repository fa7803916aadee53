"""Parity of the port's masked SpGEMM (``graphblas_tpu_torch.core.sparse``)
with the JAX package's (``graphblas_tpu.core.sparse``).

The same numpy COO arrays build both packages' containers.  The plan is
compared slot for slot (buckets, chunks, task entries, key and value tiles,
bricks, the reduce net's routes); the execute's (acc, hit, flops) on the
same plans, with every value exact except float plus / times accumulations
of values, which each package sums in its own order (segment scatter, scan,
brick matmul): rtol 1e-5.  Both packages take the same typed semirings
(``sr(add, mul, type)``, each package's own).  The JAX package is imported
by the ``ref`` fixture, not at import time.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from graphblas_tpu_torch import kernels
from graphblas_tpu_torch import semiring as psemiring
from graphblas_tpu_torch.core import dtypes as pdt
from graphblas_tpu_torch.core import sparse as ps
from graphblas_tpu_torch.core.operator import get_typed_op as pget

WMAX = ps._SPGEMM_WMAX


def psr(add, mul, dt):
    """The port's semiring ``add_mul`` typed at ``dt`` (a type name or DataType)."""
    dt = pdt.lookup_dtype(dt)
    return pget(getattr(psemiring, f"{add}_{mul}"), dt, dt, kind="semiring")


@pytest.fixture(scope="module")
def ref():
    """The JAX package's SpGEMM, semirings and dtypes."""
    jnp = pytest.importorskip("jax.numpy")
    from graphblas_tpu import semiring
    from graphblas_tpu.core import dtypes
    from graphblas_tpu.core import sparse as rs
    from graphblas_tpu.core.operator import get_typed_op
    from graphblas_tpu.ops.permute import apply_plan

    def sr(add, mul, dt):
        return get_typed_op(getattr(semiring, f"{add}_{mul}"), dt, dt, kind="semiring")

    return SimpleNamespace(jnp=jnp, sparse=rs, dtypes=dtypes, sr=sr, apply_plan=apply_plan)


def clustered(n=256, csize=64, seed=0, dt=np.float32):
    """The clustered lower triangle of tests/test_sparse.py (cliques of
    ``csize`` plus 2n random edges): block-dense diagonal bricks."""
    rng = np.random.default_rng(seed)
    base = np.arange(n) - (np.arange(n) % csize)
    rs_, cs_ = [], []
    for d in range(1, csize):
        rs_.append(np.arange(n))
        cs_.append(base + (np.arange(n) + d) % csize)
    rs_.append(rng.integers(0, n, 2 * n))
    cs_.append(rng.integers(0, n, 2 * n))
    r, c = np.concatenate(rs_), np.concatenate(cs_)
    lo, hi = np.minimum(r, c), np.maximum(r, c)
    keep = lo != hi
    vals = (rng.random(keep.sum()) + 0.5).astype(dt)
    return hi[keep], lo[keep], vals, n


def hub_graph(dt=np.float32):
    """The hub graph of tests/test_sparse.py: every vertex -> a hub column."""
    n = 2 * WMAX + 13
    rows = np.arange(n - 1)
    cols = np.full(n - 1, n - 1)
    a = (rows, cols, np.ones(n - 1, dt), n)
    b = (cols, rows, np.full(n - 1, 2, dt), n)
    return a, b, np.array([0, 1, 5]), np.array([3, 4, 5])


def hub_row_graph(dt=np.float32, seed=1):
    """A hub row of A (2 * WMAX + 12 entries) against a hub column of
    B = A^T, so the entry (hub, hub) splits into 3 x 3 chunk-pair tasks."""
    rng = np.random.default_rng(seed)
    n = 2 * WMAX + 13
    hub = n - 1
    r = np.concatenate([np.full(n - 1, hub), rng.integers(0, n - 1, 3 * n)])
    c = np.concatenate([np.arange(n - 1), rng.integers(0, n - 1, 3 * n)])
    vals = (rng.random(len(r)) + 0.5).astype(dt)
    return r, c, vals, n


def _pair_of_containers(ref, r, c, v, n, dup_op="first"):
    """(JAX container, port container) from the same COO arrays; the port's
    from the JAX one's numpy fields, unchanged."""
    rsp = ref.sparse.SparseMatrixData.from_arrays(r, c, v, n, n, dup_op)
    psp = ps.SparseMatrixData.from_arrays(rsp.rows, rsp.cols, rsp.vals, rsp.nrows, rsp.ncols, sorted_dedup=True)
    own = ps.SparseMatrixData.from_arrays(r, c, v, n, n, dup_op)
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(own, name), getattr(rsp, name))
    return rsp, psp


def _operands(ref, graph, dt=np.float32):
    """((A, B, M) of the reference, (A, B, M) of the port)."""
    if graph == "hub":
        (ar, ac, av, n), (br, bc, bv, _), mr, mc = hub_graph(dt)
        ra, pa = _pair_of_containers(ref, ar, ac, av, n)
        rb, pb = _pair_of_containers(ref, br, bc, bv, n)
        return (ra, rb, mr, mc), (pa, pb, mr, mc)
    r, c, v, n = clustered(dt=dt) if graph == "clustered" else hub_row_graph(dt)
    rl, pl = _pair_of_containers(ref, r, c, v, n)
    ru, pu = rl.transposed(), pl.transposed()
    if graph == "clustered":  # the triangle-counting shape: M = L's pattern
        return (rl, ru, rl.rows, rl.cols), (pl, pu, pl.rows, pl.cols)
    # A with a hub row against A^T, masked by A A^T's pattern on the hub row and column
    hub = n - 1
    mr = np.concatenate([np.full(n, hub), np.arange(n - 1)])
    mc = np.concatenate([np.arange(n), np.full(n - 1, hub)])
    return (rl, ru, mr, mc), (pl, pu, mr, mc)


PLAN_CASES = [
    ("clustered", False, False), ("clustered", False, True), ("clustered", True, True),
    ("hub", False, True), ("hub_row", False, True),
]


def _plans(ref, graph, bricks, net, dt=np.float32):
    (ra, rb, mr, mc), (pa, pb, _, _) = _operands(ref, graph, dt)
    kw = dict(bricks=bricks, brick_thresh=512, reduce_net=net)
    rplan = ref.sparse.sparse_spgemm_analyze(ra, rb, mr, mc, **kw)
    pplan = ps.sparse_spgemm_analyze(pa, pb, mr, mc, device="cpu", **kw)
    return rplan, pplan


@pytest.mark.parametrize("graph,bricks,net", PLAN_CASES)
def test_plan_matches_reference_slot_for_slot(ref, graph, bricks, net):
    rplan, pplan = _plans(ref, graph, bricks, net)
    assert pplan.n_entries == rplan.n_entries and pplan.device == torch.device("cpu")
    np.testing.assert_array_equal(pplan.m_rows, rplan.m_rows)
    assert [b[0] for b in pplan.buckets] == [b[0] for b in rplan.buckets]
    for pb, rb in zip(pplan.buckets, rplan.buckets):
        assert pb[7] == rb[7], pb[0]  # chunk
        np.testing.assert_array_equal(pb[1], rb[1])  # task_entry
        np.testing.assert_array_equal(pb[2], rb[2])  # multi
        for i in (3, 4, 5, 6, 8):  # akT, avT, bkT, bvT, entry ids
            assert pb[i].dtype == torch.from_numpy(np.zeros(0, np.asarray(rb[i]).dtype)).dtype
            np.testing.assert_array_equal(pb[i].numpy(), np.asarray(rb[i]))
    assert (pplan.brick is None) == (rplan.brick is None) == (not bricks)
    if bricks:
        assert pplan.brick.kmax == rplan.brick.kmax
        for name in ("a_bricks", "b_bricks", "a_idx", "b_idx", "entry_cell"):
            np.testing.assert_array_equal(getattr(pplan.brick, name).numpy(), np.asarray(getattr(rplan.brick, name)))
    assert (pplan.reduce_net is None) == (rplan.reduce_net is None) == (not net)
    if net:
        order, last, seg_start, has_task = pplan.reduce_net
        net1, net2, r_seg, r_has = rplan.reduce_net
        np.testing.assert_array_equal(seg_start.numpy(), np.asarray(r_seg))
        np.testing.assert_array_equal(has_task.numpy(), np.asarray(r_has))
        ar = ref.jnp.arange(seg_start.shape[0], dtype=ref.jnp.int32)
        np.testing.assert_array_equal(order.numpy(), np.asarray(ref.apply_plan(ar, net1)))
        np.testing.assert_array_equal(last.numpy(), np.asarray(ref.apply_plan(ar, net2)))
    if graph == "hub_row":  # the hub entry splits into chunk-pair tasks of a (256, 256) bucket
        te = np.concatenate([b[1] for b in pplan.buckets])
        assert np.bincount(te).max() > 1
        assert any(b[0] == (WMAX, WMAX) for b in pplan.buckets)


# (add, mul, out dtype name, plan (bricks, net) combinations)
FP32 = ("FP32", torch.float32)
EXEC_CASES = [
    ("plus", "times", FP32, [(False, False), (False, True), (True, False), (True, True)]),
    ("plus", "pair", FP32, [(False, False), (False, True), (True, True)]),
    ("min", "plus", FP32, [(False, False), (False, True)]),
    ("max", "first", FP32, [(False, False), (False, True)]),
    ("plus", "second", FP32, [(False, True)]),
    ("times", "times", FP32, [(False, False)]),
    ("any", "pair", FP32, [(False, False), (False, True)]),
    ("lor", "pair", ("BOOL", torch.bool), [(False, False)]),
    ("plus", "pair", ("INT32", torch.int32), [(False, True)]),
    ("plus", "times", ("FP64", torch.float64), [(False, True)]),
]


def _exec_params():
    for add, mul, out, combos in EXEC_CASES:
        for bricks, net in combos:
            yield pytest.param("clustered", add, mul, out, bricks, net, id=f"clustered-{add}_{mul}-{out[0]}-b{int(bricks)}n{int(net)}")
    for add, mul in (("plus", "times"), ("min", "plus")):
        yield pytest.param("hub_row", add, mul, FP32, False, True, id=f"hub_row-{add}_{mul}")
    yield pytest.param("hub", "plus", "times", FP32, False, False, id="hub-plus_times")


def _values_close(got, want, add, mul):
    if add in ("plus", "times") and mul != "pair" and got.dtype.is_floating_point:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("graph,add,mul,out,bricks,net", list(_exec_params()))
def test_execute_matches_reference(ref, graph, add, mul, out, bricks, net):
    (rname, tdt) = out
    vdt = np.float64 if rname == "FP64" else np.float32
    rplan, pplan = _plans(ref, graph, bricks, net, vdt)
    rdt = getattr(ref.dtypes, rname)
    vt = ref.dtypes.FP64 if vdt is np.float64 else ref.dtypes.FP32
    racc, rhit, rflops = ref.sparse.sparse_spgemm_execute(rplan, ref.sr(add, mul, vt), rdt, keep_on_device=True)
    pdtype = pdt.lookup_dtype(rname)
    psr_t = psr(add, mul, vt.name)
    kernels.reset_counts()
    acc, hit, flops = ps.sparse_spgemm_execute(pplan, psr_t, pdtype, keep_on_device=True)
    assert acc.dtype == tdt == pdtype.carrier and hit.dtype == torch.bool and flops.dtype == torch.int64
    assert int(flops) == int(rflops) > 0
    np.testing.assert_array_equal(hit.numpy(), np.asarray(rhit))
    _values_close(acc, racc, add, mul)
    # the host form: the entries with a match
    r_rows, r_cols, r_vals, r_flops = ref.sparse.sparse_spgemm_execute(rplan, ref.sr(add, mul, vt), rdt)
    rows, cols, vals, f = ps.sparse_spgemm_execute(pplan, psr_t, pdtype)
    assert f == r_flops and isinstance(f, int)
    np.testing.assert_array_equal(rows, r_rows)
    np.testing.assert_array_equal(cols, r_cols)
    assert vals.dtype == np.asarray(r_vals).dtype
    _values_close(torch.from_numpy(vals), r_vals, add, mul)
    counts = kernels.plain_counts()
    if ps._bucket_kernel_ok(add, mul, pplan.buckets[0][3], pplan.buckets[0][5], pdtype):
        assert counts["eqjoin"] > 0  # the plain version stands in for the kernel on the CPU
    else:
        assert counts["eqjoin"] == 0  # the reference's XLA formulation, in plain torch
    used_net = net and add in ("plus", "min", "max", "any") and tdt == torch.float32
    assert (counts["segscan"] > 0) == used_net and (counts["gather"] > 0) == used_net


@pytest.mark.parametrize(
    "add,mul,dtype,kernel",
    [
        ("plus", "times", pdt.FP32, True), ("lor", "pair", pdt.BOOL, True),
        ("plus", "pair", pdt.INT32, True), ("min", "plus", pdt.INT32, False),
        ("plus", "times", pdt.FP64, False), ("max", "second", pdt.FP64, False),
    ],
)
def test_bucket_branch_is_chosen_by_dtype(add, mul, dtype, kernel):
    """eqjoin takes int32 keys into float32, or any pair; every other dtype
    runs the reference's XLA formulation in plain torch (never as a fallback
    when a kernel fails)."""
    keys = torch.zeros((4, 512), dtype=torch.int32)
    assert ps._bucket_kernel_ok(add, mul, keys, keys, dtype) is kernel
    assert not ps._bucket_kernel_ok(add, mul, keys.long(), keys.long(), dtype)


def test_mxm_masked_matches_reference_and_scipy(ref):
    """The triangle count of the clustered graph through sparse_mxm_masked
    (bricks and the reduce net on) equals the reference and scipy's."""
    sp = pytest.importorskip("scipy.sparse")
    (rl, ru, mr, mc), (pl, pu, _, _) = _operands(ref, "clustered")
    sr = ref.sr("plus", "pair", ref.dtypes.FP32)
    want = ref.sparse.sparse_mxm_masked(rl, ru, mr, mc, sr, ref.dtypes.FP32)
    got = ps.sparse_mxm_masked(pl, pu, mr, mc, psr("plus", "pair", "FP32"), pdt.FP32, device="cpu")
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]
    n = pl.nrows
    L = sp.csr_matrix((np.ones(pl.nvals), (pl.rows, pl.cols)), shape=(n, n))
    assert got[2].astype(np.float64).sum() == (L @ L.T).multiply(L).sum()


def test_mxm_masked_empty_operands():
    a = ps.SparseMatrixData.from_arrays([0, 1], [1, 0], np.ones(2, np.float32), 3, 3)
    empty = ps.SparseMatrixData.from_arrays([], [], np.zeros(0, np.float32), 3, 3)
    for args in ((a, empty, [0], [0]), (empty, a, [0], [0]), (a, a, [], [])):
        rows, cols, vals, flops = ps.sparse_mxm_masked(*args, psr("plus", "times", "FP32"), pdt.FP64, device="cpu")
        assert rows.shape == cols.shape == vals.shape == (0,) and vals.dtype == np.float64 and flops == 0
    # no intersection at all: nothing hits
    rows, _, vals, flops = ps.sparse_mxm_masked(a, a, [0], [1], psr("plus", "times", "FP32"), pdt.FP32, device="cpu")
    assert rows.size == 0 and vals.dtype == np.float32 and flops == 0


def test_brick_plan_rejects_other_semirings(ref):
    _, pplan = _plans(ref, "clustered", True, False)
    assert pplan.brick is not None
    for add, mul, dt in (("min", "plus", pdt.FP32), ("plus", "times", pdt.FP64)):
        with pytest.raises(ValueError, match="bricks=False"):
            ps.sparse_spgemm_execute(pplan, psr(add, mul, "FP32"), dt)


def test_names_outside_the_ported_operators_raise(ref):
    """The names the port's name-based engine refused (bor_pair, plus_minus,
    dup_op "minus") now arrive as typed operators and agree with the
    reference; a name that is no operator still raises."""
    r, c = np.array([0, 1, 1, 2]), np.array([1, 0, 2, 1])
    for vals, (add, mul) in ((np.array([3, 5, 6, 9], np.uint32), ("bor", "pair")), (np.array([1.5, 2.0, 4.0, -1.0], np.float32), ("plus", "minus"))):
        rsp = ref.sparse.SparseMatrixData.from_arrays(r, c, vals, 3, 3)
        psp = ps.SparseMatrixData.from_arrays(r, c, vals, 3, 3)
        dt = vals.dtype.name.upper().replace("FLOAT", "FP")
        want = ref.sparse.sparse_mxm_masked(rsp, rsp, [0, 1, 2], [0, 1, 2], ref.sr(add, mul, getattr(ref.dtypes, dt)), getattr(ref.dtypes, dt))
        got = ps.sparse_mxm_masked(psp, psp, [0, 1, 2], [0, 1, 2], psr(add, mul, dt), pdt.lookup_dtype(dt), device="cpu")
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert got[3] == want[3]
    with pytest.raises(AttributeError):
        psr("plus", "no_such_op", "FP32")
    want = ref.sparse.SparseMatrixData.from_arrays([0, 0], [1, 1], np.array([5.0, 2.0]), 3, 3, dup_op="minus")
    got = ps.SparseMatrixData.from_arrays([0, 0], [1, 1], np.array([5.0, 2.0]), 3, 3, dup_op="minus")
    np.testing.assert_array_equal(got.vals, want.vals)
    with pytest.raises(ValueError, match="Unknown"):
        ps.SparseMatrixData.from_arrays([0, 0], [1, 1], np.ones(2), 3, 3, dup_op="no_such_op")


@pytest.mark.parametrize("dup_op,want", [
    ("plus", [5.0, 4.0]), ("times", [6.0, 4.0]), ("min", [2.0, 4.0]), ("max", [3.0, 4.0]),
    ("first", [2.0, 4.0]), ("second", [3.0, 4.0]), ("any", [3.0, 4.0]),
])
def test_from_arrays_combines_duplicates(dup_op, want):
    sp = ps.SparseMatrixData.from_arrays([1, 0, 0], [1, 2, 2], np.array([4.0, 2.0, 3.0]), 2, 3, dup_op)
    np.testing.assert_array_equal(sp.rows, [0, 1])
    np.testing.assert_array_equal(sp.cols, [2, 1])
    np.testing.assert_array_equal(sp.vals, want)
    with pytest.raises(ValueError, match="dup_op"):
        ps.SparseMatrixData.from_arrays([0, 0], [1, 1], np.ones(2), 2, 2)
    t = sp.transposed()
    assert (t.nrows, t.ncols, t.nvals) == (3, 2, 2)
    np.testing.assert_array_equal(t.rows, [1, 2])


def _port_plan(graph):
    """The port's plan of a test graph, from the COO arrays alone (no reference)."""
    if graph == "hub":
        (ar, ac, av, n), (br, bc, bv, _), mr, mc = hub_graph()
        a = ps.SparseMatrixData.from_arrays(ar, ac, av, n, n, "first")
        b = ps.SparseMatrixData.from_arrays(br, bc, bv, n, n, "first")
    else:
        r, c, v, n = clustered() if graph == "clustered" else hub_row_graph()
        a = ps.SparseMatrixData.from_arrays(r, c, v, n, n, "first")
        b = a.transposed()
        if graph == "clustered":
            mr, mc = a.rows, a.cols
        else:
            hub = n - 1
            mr = np.concatenate([np.full(n, hub), np.arange(n - 1)])
            mc = np.concatenate([np.arange(n), np.full(n - 1, hub)])
    return ps.sparse_spgemm_analyze(a, b, mr, mc, reduce_net=True, device="cpu")


# (Wa, Wb, T) of the bench triangle-count plan and the RMAT scale-14 plan that
# chip_smoke.py runs, as tools/profile_spgemm_roofline.py printed them on the card
CHIP_PLAN_SHAPES = [
    (4, 4, 116224), (4, 16, 868352), (4, 64, 1048576), (4, 256, 2048), (16, 4, 97280), (16, 16, 86528),
    (16, 64, 196608), (16, 256, 1024), (64, 4, 1310720), (64, 16, 262144), (64, 64, 81920), (64, 256, 2048),
    (256, 4, 512), (256, 16, 2048), (256, 64, 8192), (256, 256, 512),
    (4, 4, 1536), (4, 16, 4096), (4, 64, 3072), (4, 256, 12288), (16, 4, 2560), (16, 16, 3584), (16, 64, 6656),
    (16, 256, 32768), (64, 4, 5120), (64, 16, 8192), (64, 64, 24576), (64, 256, 36864), (256, 4, 30720),
    (256, 16, 49152), (256, 64, 73728), (256, 256, 117760),
]


@pytest.mark.parametrize("graph", ["clustered", "hub", "hub_row", "chip_smoke plans"])
def test_eqjoin_layout_choice_over_the_plan_buckets(graph):
    """The host's layout choice (``kernels.eqjoin.lanes_per_task``, a pure
    function of Wa, Wb and T) over every bucket shape of the three test plans
    and of chip_smoke.py's two plans: a layout the kernel takes; one thread a
    task where the tasks alone fill half the card's resident threads, or give
    every SM a block while a task's work is small; else the layout of least
    modelled cost; a wide
    bucket (Wa * Wb >= 16384) of fewer tasks than one 128-thread block per
    SM spread over lanes, to at least one block per SM where Wa allows it."""
    from graphblas_tpu_torch.kernels import eqjoin as ke

    if graph == "chip_smoke plans":
        shapes = CHIP_PLAN_SHAPES
    else:
        shapes = [(b[0][0], b[0][1], int(b[3].shape[1])) for b in _port_plan(graph).buckets]
    assert shapes
    for Wa, Wb, T in shapes:
        g = ke.lanes_per_task(Wa, Wb, T)
        assert g in ke.layouts(Wa), (Wa, Wb, T, g)
        if T >= ke.RESIDENT_THREADS // 2 or (T >= 132 * 128 and Wa * Wb < 1024):
            assert g == 1, (Wa, Wb, T)
        else:  # the layout of least modelled cost
            assert g == min(ke.layouts(Wa), key=lambda h: ke._layout_cost(Wa, Wb, T, h))
        if Wa * Wb >= 16384 and T < 132 * 128:
            most = max(ke.layouts(Wa))
            assert g > 1 and -(-T * g // 128) >= min(132, -(-T * most // 128)), (Wa, Wb, T, g)


@pytest.mark.parametrize("shape,lanes", [
    ((256, 256, 512), 32), ((256, 4, 30720), 1), ((64, 4, 1310720), 1), ((64, 256, 36864), 8),
    ((256, 256, 117760), 32), ((4, 256, 2048), 4), ((16, 4, 97280), 1), ((16, 16, 86528), 1),
])
def test_eqjoin_layout_choice_follows_the_sweep(shape, lanes):
    """Picks the layout sweep on an H100 settled (PERF.md): the (256, 256)
    bucket of 512 tasks on a warp a task; (256, 4) of 30,720 tasks on a
    thread a task, where handing the combine from lane to lane costs more
    than its 4 compares a key save; the bench's largest bucket, and its (16,
    4) and (16, 16) ones, where lanes ran slower than a thread a task,
    unchanged."""
    from graphblas_tpu_torch.kernels import eqjoin as ke

    assert ke.lanes_per_task(*shape) == lanes
