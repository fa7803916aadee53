"""Parity of the port's SpMV engine (graphblas_tpu_torch.ops.fastspmv) with
the JAX package's, on the CPU.

- The port's own analysis equals the reference plan carried across through
  ``save_spmv_plan`` -> ``plan_from_reference``, array by array.
- Every route index array equals the reference network applied to arange.
- One iteration of each loop algorithm matches slot for slot.
- ``spmv`` matches for plus_times, min_plus and max_first.

Exact everywhere except float add scans, which round in another order (the
TPU kernel's lane/row tree against the plain log-step scan): those compare
within rtol 1e-6 on one scan and 1e-5 through a whole SpMV.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphblas_tpu.models import fast as ref_fast
from graphblas_tpu.models import graph as ref_graph
from graphblas_tpu.ops import fastspmv as ref_fs
from graphblas_tpu.ops import pallas_scan as ref_scan
from graphblas_tpu.ops.permute import apply_plan
from graphblas_tpu_torch.models import fast as port_fast
from graphblas_tpu_torch.models import graph as port_graph
from graphblas_tpu_torch.ops import fastspmv as port_fs
from graphblas_tpu_torch.ops.permute import apply_perm
from graphblas_tpu_torch.ops.scan import segmented_scan_contrib, segmented_scan_state


def corner_graph():
    """The engineered graph of tests/test_models.py: vertex 80 a sink, 81 a
    source with no in-edges, 82 a self-loop only, 83 isolated."""
    rng = np.random.default_rng(11)
    n, e = 90, 400
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    keep = ~np.isin(src, [80, 82, 83]) & ~np.isin(dst, [81, 82, 83])
    src = np.concatenate([src[keep], [82]]).astype(np.int32)
    dst = np.concatenate([dst[keep], [82]]).astype(np.int32)
    w = (rng.random(len(src)) * 9 + 1).astype(np.float32)
    sources = [int(np.bincount(src, minlength=n).argmax()), 80, 81, 82, 83]
    return (
        ref_graph.Graph.from_arrays(src, dst, w, n=n),
        port_graph.Graph.from_arrays(src, dst, w, n=n),
        sources,
    )


def rmat_graph():
    """RMAT scale 10, edge factor 20: e_pad = 2 * 128^2, so the reference
    networks carry T and row-select stages."""
    g_ref = ref_graph.rmat(10, 20, seed=3, weighted=True)
    g_port = port_graph.rmat(10, 20, seed=3, weighted=True)
    src = np.asarray(g_ref.src)[np.asarray(g_ref.valid)]
    outdeg = np.bincount(src, minlength=g_ref.n)
    return g_ref, g_port, np.argsort(outdeg)[::-1][:3].tolist()


@pytest.fixture(scope="module", params=["rmat", "corners"])
def case(request, tmp_path_factory):
    g_ref, g_port, sources = rmat_graph() if request.param == "rmat" else corner_graph()
    jplan = ref_fast.analyze(g_ref)
    path = tmp_path_factory.mktemp("plan") / "plan.npz"
    ref_fs.save_spmv_plan(jplan, str(path))
    return {
        "g_ref": g_ref,
        "g_port": g_port,
        "jplan": jplan,
        "carried": port_fs.plan_from_reference(str(path)),
        "plan": port_fast.analyze(g_port),
        "sources": sources,
    }


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def test_rmat_graphs_are_identical():
    g_ref = ref_graph.rmat(8, 16, seed=5, weighted=True)
    g_port = port_graph.rmat(8, 16, seed=5, weighted=True)
    for name in ("src", "dst", "weights", "valid"):
        np.testing.assert_array_equal(_np(getattr(g_port, name)), np.asarray(getattr(g_ref, name)))
    assert (g_port.n, g_port.nedges) == (g_ref.n, g_ref.nedges)


def test_plan_arrays_match_reference(case):
    plan, carried, jplan = case["plan"], case["carried"], case["jplan"]
    assert (plan.n, plan.e_pad) == (jplan.n, jplan.e_pad) == (carried.n, carried.e_pad)
    assert plan.k_iso_dangling == carried.k_iso_dangling == jplan.k_iso_dangling
    assert plan.loop_donors and carried.loop_donors and not plan.total
    assert set(plan.arrays()) == set(carried.arrays()) == set(port_fs.ARRAYS)
    for name, a in plan.arrays().items():
        b = getattr(carried, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)
        if name.endswith("_idx") or name in ("src_sorted", "src_dst_order", "fill_src"):
            assert a.dtype == torch.int32, name


@pytest.mark.parametrize(
    "options",
    [{"total": True}, {"pad_to": 1 << 15}, {"endpoints": False}, {"loop_net": False}],
    ids=["total", "pad_to", "no_endpoints", "no_loop_net"],
)
def test_build_options_match_reference(tmp_path, options):
    """The builder's options give the reference's arrays too (corner graph)."""
    g_ref, g_port, _ = corner_graph()
    valid = np.asarray(g_ref.valid)
    src, dst, w = (np.asarray(a)[valid] for a in (g_ref.src, g_ref.dst, g_ref.weights))
    jplan = ref_fs.build_spmv_plan(src, dst, w, n=g_ref.n, **options)
    ref_fs.save_spmv_plan(jplan, str(tmp_path / "plan.npz"))
    carried = port_fs.plan_from_reference(str(tmp_path / "plan.npz"))
    plan = port_fs.build_spmv_plan(src, dst, w, n=g_port.n, **options)
    assert (plan.e_pad, plan.total, plan.loop_donors) == (jplan.e_pad, jplan.total, jplan.loop_donors)
    assert plan.k_iso_dangling == jplan.k_iso_dangling
    assert set(plan.arrays()) >= set(carried.arrays())
    for name, a in plan.arrays().items():
        # the reference saves the loop tables only with a loop network
        want = getattr(carried, name) if name in carried.arrays() else getattr(jplan, name)
        np.testing.assert_array_equal(_np(a), _np(want), err_msg=name)


@pytest.mark.parametrize(
    "idx_name,net_name",
    [("perm_idx", "perm_plan"), ("place_idx", "place_plan"), ("collect_idx", "collect_plan"), ("loop_idx", "loop_plan")],
)
def test_routes_equal_reference_networks(case, idx_name, net_name):
    plan, jplan = case["plan"], case["jplan"]
    routed = apply_plan(jnp.arange(jplan.e_pad, dtype=jnp.int32), getattr(jplan, net_name))
    np.testing.assert_array_equal(_np(getattr(plan, idx_name)), np.asarray(routed))


def _inject(plan, source):
    ip = _np(plan.indptr_src)
    inj = np.zeros(plan.e_pad, bool)
    if ip[source + 1] > ip[source]:
        inj[ip[source]] = True
    return inj


def _same(got, want, name, rtol=None):
    if rtol is None:
        np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=name)
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol, err_msg=name)


@pytest.mark.parametrize("mode", ["bfs", "sssp"])
def test_bfs_sssp_round_intermediates_match(case, mode):
    """Seed round, then one loop round: x_start, xe, xe_dst, scanned state."""
    plan, jplan = case["plan"], case["jplan"]
    for source in case["sources"][:2]:
        if mode == "bfs":
            st0 = np.full(plan.e_pad, -1, np.int32)
        else:
            st0 = np.full(plan.e_pad, ref_scan.STATE_BIG, np.float32)
        j_st, j_fr = ref_fast._seed_state(jplan, mode, source, jnp.asarray(st0))
        p_st, _ = port_fast._seed_state(plan, mode, source, _t(st0))
        _same(p_st, j_st, "seed state")
        inj = _inject(plan, source)
        if mode == "bfs":
            j_xs = jnp.maximum(apply_plan(j_fr, jplan.loop_plan), jnp.asarray(inj, jnp.float32))
            _, p_fr = port_fast._seed_state(plan, mode, source, _t(st0))
            _same(p_fr, j_fr, "seed frontier")
            p_xs = torch.maximum(apply_perm(p_fr, plan.loop_idx), _t(inj).float())
            w_j, w_p = None, None
        else:
            j_xs = jnp.where(jnp.asarray(inj), jnp.float32(0), apply_plan(j_st, jplan.loop_plan))
            p_xs = torch.where(_t(inj), torch.zeros(()), apply_perm(p_st, plan.loop_idx))
            w_j, w_p = jplan.w_dst_order, plan.w_dst_order
        _same(p_xs, j_xs, "x_start")
        j_xe = ref_fs._seg_fill(jplan, j_xs)
        p_xe = port_fs._seg_fill(plan, p_xs)
        _same(p_xe, j_xe, "xe")
        j_xd = apply_plan(j_xe, jplan.perm_plan)
        p_xd = apply_perm(p_xe, plan.perm_idx)
        _same(p_xd, j_xd, "xe_dst")
        j_new, j_ch = ref_scan.segmented_scan_state(
            mode, j_xd, w_j, jplan.valid_dst_order, jplan.seg_start_dst, jplan.is_last_dst,
            j_st, 1, interpret=True, fr_reduce=(mode == "sssp"),
        )
        p_new, p_ch = segmented_scan_state(
            mode, p_xd, w_p, plan.valid_dst_order, plan.seg_start_dst, plan.is_last_dst,
            p_st, 1, fr_reduce=(mode == "sssp"),
        )
        _same(p_new, j_new, "scanned state")
        if mode == "bfs":
            _same(p_ch, j_ch, "frontier")
        else:
            assert bool(p_ch[0]) == bool(np.asarray(j_ch).max() > 0)


def test_pagerank_iteration_intermediates_match(case):
    plan, jplan, n = case["plan"], case["jplan"], case["plan"].n
    is_last = _np(plan.is_last_dst)
    r0 = np.where(is_last, np.float32(1.0 / n), np.float32(0)).astype(np.float32)
    c = np.float32(1.0 / n)
    shs, od = _np(plan.start_has_state), _np(plan.outdeg_start)
    od_signed = np.where(shs, od, -od).astype(np.float32)

    def post(y, aux, s):
        return jnp.where(aux[0] > 0, y / aux[0], s[0] / (-aux[0]))

    j_xs = ref_fs.state_to_start_post(jplan, jnp.asarray(r0), post, aux=(jnp.asarray(od_signed),), scalars=(jnp.asarray(c),))
    p_xs = port_fs.state_to_start_post(plan, _t(r0), "pagerank", aux=_t(od_signed), scalar=torch.tensor(c))
    _same(p_xs, j_xs, "x_start")
    j_xe, p_xe = ref_fs._seg_fill(jplan, j_xs), port_fs._seg_fill(plan, p_xs)
    _same(p_xe, j_xe, "xe")
    j_xd, p_xd = apply_plan(j_xe, jplan.perm_plan), apply_perm(p_xe, plan.perm_idx)
    _same(p_xd, j_xd, "xe_dst")
    j_sc = ref_fs.spmv_state(jplan, j_xs, "plus", "first")
    p_sc = port_fs.spmv_state(plan, p_xs, "plus", "first")
    _same(p_sc, j_sc, "scanned", rtol=1e-6)
    p_direct = segmented_scan_contrib(p_xd, None, plan.valid_dst_order, plan.seg_start_dst, "add", "first")
    _same(p_direct, _np(p_sc), "spmv_state = fill, route, scan")


@pytest.mark.parametrize("add,mul", [("plus", "times"), ("min", "plus"), ("max", "first")])
def test_spmv_matches_reference(case, add, mul):
    plan, jplan = case["plan"], case["jplan"]
    x = np.random.default_rng(12).random(plan.n).astype(np.float32)
    want = ref_fs.spmv(jplan, jnp.asarray(x), add, mul)
    got = port_fs.spmv(plan, _t(x), add, mul)
    assert got.shape == (plan.n,) and got.dtype == torch.float32
    _same(got, want, f"spmv {add}_{mul}", rtol=1e-5 if add == "plus" else None)


def test_plan_moves_between_devices_whole(case):
    plan = case["plan"]
    moved = plan.to("meta")
    assert moved.device.type == "meta"
    assert all(t.device.type == "meta" for t in moved.arrays().values())
    assert (moved.n, moved.e_pad, moved.k_iso_dangling) == (plan.n, plan.e_pad, plan.k_iso_dangling)
