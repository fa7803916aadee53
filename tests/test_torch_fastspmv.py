"""Parity of the port's SpMV engine (graphblas_tpu_torch.ops.fastspmv) with
the JAX package's, on the CPU.

- The port's own analysis equals the reference plan carried across through
  ``save_spmv_plan`` -> ``plan_from_reference``, array by array.
- Every route index array equals the reference network applied to arange.
- One iteration of each loop algorithm matches slot for slot.
- ``spmv`` matches for plus_times, min_plus and max_first, on plans with and
  without endpoint routes; without them, the reduce (against the reference's
  ``_segment_reduce_dst``) matches slot for slot too.
- The port's plan files round-trip array by array, and ``load_spmv_plan(w=)``
  gives the plan a fresh build with those weights gives.
- x gathered through ``src_dst_order`` (the expand, and the contrib scan with
  the gather fused) equals the reference's routed expand and SpMVs, on v2,
  non-endpoint and total plans; a JAX-package plan file without that array
  gets it derived, and a plan file whose array leaves x is refused.

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
from graphblas_tpu_torch.ops.scan import segmented_scan, segmented_scan_contrib, segmented_scan_state


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
        port_graph.Graph.from_arrays(src, dst, w, n=n, device="cpu"),
        sources,
    )


def rmat_graph():
    """RMAT scale 10, edge factor 20: e_pad = 2 * 128^2, so the reference
    networks carry T and row-select stages."""
    g_ref = ref_graph.rmat(10, 20, seed=3, weighted=True)
    g_port = port_graph.rmat(10, 20, seed=3, weighted=True, device="cpu")
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
        "carried": port_fs.plan_from_reference(str(path), device="cpu"),
        "plan": port_fast.analyze(g_port),
        "sources": sources,
    }


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def test_rmat_graphs_are_identical():
    g_ref = ref_graph.rmat(8, 16, seed=5, weighted=True)
    g_port = port_graph.rmat(8, 16, seed=5, weighted=True, device="cpu")
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
    carried = port_fs.plan_from_reference(str(tmp_path / "plan.npz"), device="cpu")
    plan = port_fs.build_spmv_plan(src, dst, w, n=g_port.n, device="cpu", **options)
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


def _edges(g_ref):
    valid = np.asarray(g_ref.valid)
    return tuple(np.asarray(a)[valid] for a in (g_ref.src, g_ref.dst, g_ref.weights))


def _no_pad_graph():
    """128 edges over 100 vertices, so e_pad = 128 has no pad edge: the
    last vertices have no in-edge and their dst segments start at e_pad."""
    rng = np.random.default_rng(21)
    src = rng.integers(0, 100, 128).astype(np.int32)
    dst = rng.integers(0, 90, 128).astype(np.int32)
    return src, dst, (rng.random(128) * 9 + 1).astype(np.float32), 100


@pytest.fixture(scope="module", params=["rmat", "corners", "no_pad"])
def no_endpoints(request):
    """Reference and port plans built with endpoints=False."""
    if request.param == "no_pad":
        src, dst, w, n = _no_pad_graph()
    else:
        g_ref = rmat_graph()[0] if request.param == "rmat" else corner_graph()[0]
        (src, dst, w), n = _edges(g_ref), g_ref.n
    jplan = ref_fs.build_spmv_plan(src, dst, w, n=n, endpoints=False)
    plan = port_fs.build_spmv_plan(src, dst, w, n=n, endpoints=False, device="cpu")
    v2 = port_fs.build_spmv_plan(src, dst, w, n=n, device="cpu")
    assert plan.place_idx is None and jplan.place_plan is None
    return {"jplan": jplan, "plan": plan, "v2": v2}


@pytest.mark.parametrize("kind", ["plus", "min", "max"])
def test_dst_reduce_matches_reference_segment_reduce(no_endpoints, kind):
    """The non-endpoint reduce of spmv (a scan over the dst segments, read at
    their ends) against the reference's ``_segment_reduce_dst``."""
    plan, jplan = no_endpoints["plan"], no_endpoints["jplan"]
    seg_start, read = port_fs._dst_reduce(plan)
    rng = np.random.default_rng(14)
    for contrib in (rng.random(plan.e_pad).astype(np.float32), rng.integers(-50, 50, plan.e_pad).astype(np.int32)):
        want = ref_fs._segment_reduce_dst(jnp.asarray(contrib), jplan.indptr_dst, kind)
        op = port_fs._OPS[kind]
        got = read(segmented_scan(_t(contrib), seg_start, op), port_fs._ident(op, _t(contrib).dtype))
        float_add = kind == "plus" and contrib.dtype == np.float32
        _same(got, want, f"segment reduce {kind}", rtol=1e-6 if float_add else None)


@pytest.mark.parametrize("add,mul", [("plus", "times"), ("min", "plus"), ("max", "first"), ("max", "second")])
def test_spmv_without_endpoints_matches_reference(no_endpoints, add, mul):
    """Against the reference's non-v2 path, and exactly against the port's v2
    plan: both give the same dst-order slots to the same scan."""
    plan, jplan = no_endpoints["plan"], no_endpoints["jplan"]
    x = np.random.default_rng(15).random(plan.n).astype(np.float32)
    want = ref_fs.spmv(jplan, jnp.asarray(x), add, mul)
    got = port_fs.spmv(plan, _t(x), add, mul)
    _same(got, want, f"spmv {add}_{mul}", rtol=1e-5 if add == "plus" else None)
    _same(got, _np(port_fs.spmv(no_endpoints["v2"], _t(x), add, mul)), "non-v2 = v2")


def test_plan_file_round_trip(case, tmp_path):
    plan = case["plan"]
    path = str(tmp_path / "port_plan.npz")
    port_fs.save_spmv_plan(plan, path)
    loaded = port_fs.load_spmv_plan(path, device="cpu")
    assert (loaded.n, loaded.e_pad, loaded.k_iso_dangling, loaded.loop_donors, loaded.total) == (
        plan.n, plan.e_pad, plan.k_iso_dangling, plan.loop_donors, plan.total,
    )
    assert set(loaded.arrays()) == set(plan.arrays())
    for name, a in plan.arrays().items():
        b = getattr(loaded, name)
        assert a.dtype == b.dtype and a.device == b.device, name
        np.testing.assert_array_equal(_np(b), _np(a), err_msg=name)
    np.testing.assert_array_equal(loaded.order_dst, plan.order_dst)


@pytest.mark.parametrize("options", [{}, {"endpoints": False}, {"total": True}], ids=["v2", "no_endpoints", "total"])
def test_load_plan_with_new_weights_equals_fresh_build(tmp_path, options):
    g_ref, _, _ = corner_graph()
    src, dst, w = _edges(g_ref)
    plan = port_fs.build_spmv_plan(src, dst, w, n=g_ref.n, device="cpu", **options)
    path = str(tmp_path / "plan.npz")
    port_fs.save_spmv_plan(plan, path)
    w2 = (np.random.default_rng(16).random(len(src)) * 5).astype(np.float32)
    loaded = port_fs.load_spmv_plan(path, w=w2, device="cpu")
    fresh = port_fs.build_spmv_plan(src, dst, w2, n=g_ref.n, device="cpu", **options)
    assert set(loaded.arrays()) == set(fresh.arrays())
    for name, a in fresh.arrays().items():
        np.testing.assert_array_equal(_np(getattr(loaded, name)), _np(a), err_msg=name)
    # integer weights stay int32, as the builder keeps them
    w3 = np.arange(len(src), dtype=np.int32)
    assert port_fs.load_spmv_plan(path, w=w3, device="cpu").w_dst_order.dtype == torch.int32
    with pytest.raises(ValueError, match="edges"):
        port_fs.load_spmv_plan(path, w=w2[:-1], device="cpu")


def test_load_plan_refuses_other_files(case, tmp_path):
    jpath = str(tmp_path / "jax_plan.npz")
    ref_fs.save_spmv_plan(case["jplan"], jpath)
    with pytest.raises(ValueError, match="plan_from_reference"):
        port_fs.load_spmv_plan(jpath, device="cpu")
    plan = case["plan"]
    bare = port_fs.SpmvPlan(plan.n, plan.e_pad, plan.arrays())  # no order_dst
    path = str(tmp_path / "bare.npz")
    port_fs.save_spmv_plan(bare, path)
    with pytest.raises(ValueError, match="order_dst"):
        port_fs.load_spmv_plan(path, w=np.ones(3, np.float32), device="cpu")


def test_builders_default_to_the_card(tmp_path):
    """rmat, Graph.from_arrays, build_spmv_plan, plan_from_reference and
    load_spmv_plan put their tensors on the card unless told otherwise; with
    no card, they raise as PyTorch does (nothing falls back to the CPU)."""
    src, dst = np.array([0, 1, 2], np.int32), np.array([1, 2, 0], np.int32)
    port_fs.save_spmv_plan(port_fs.build_spmv_plan(src, dst, device="cpu"), str(tmp_path / "port.npz"))
    ref_fs.save_spmv_plan(ref_fs.build_spmv_plan(src, dst), str(tmp_path / "jax.npz"))
    calls = [
        lambda: port_graph.rmat(4, 4, seed=1).src,
        lambda: port_graph.Graph.from_arrays(src, dst).src,
        lambda: port_fs.build_spmv_plan(src, dst).perm_idx,
        lambda: port_fs.plan_from_reference(str(tmp_path / "jax.npz")).perm_idx,
        lambda: port_fs.load_spmv_plan(str(tmp_path / "port.npz")).perm_idx,
    ]
    if torch.cuda.is_available():
        for call in calls:
            assert call().device.type == "cuda"
    else:
        for call in calls:
            with pytest.raises((AssertionError, RuntimeError)):
                call()


# ---- x gathered straight into the contrib scan through src_dst_order -------

GATHER_PLANS = {"v2": {}, "no_endpoints": {"endpoints": False}, "total": {"total": True}}


@pytest.fixture(scope="module")
def gather_plans():
    """The corner graph's plans of each kind, the reference's and the
    port's."""
    g_ref, _, _ = corner_graph()
    (src, dst, w), n = _edges(g_ref), g_ref.n
    out = {"src": src, "dst": dst, "w": w, "n": n}
    for kind, opts in GATHER_PLANS.items():
        out[kind] = (ref_fs.build_spmv_plan(src, dst, w, n=n, **opts), port_fs.build_spmv_plan(src, dst, w, n=n, device="cpu", **opts))
    return out


def _ref_expand(jplan, x):
    if jplan.place_plan is not None:
        return apply_plan(ref_fs._expand_v2(x, jplan), jplan.perm_plan)
    return apply_plan(ref_fs._expand_src_sorted(x, jplan.indptr_src, jplan.e_pad), jplan.perm_plan)


def _wrap_oracle(src, dst, w, n, x, xs, wrap):
    """numpy: per present edge x[s] * int32(w) wrapped to ``wrap`` bits,
    summed per destination in int32 (plus_times on a narrow output)."""
    c = x[src].astype(np.int64) * w.astype(np.int32).astype(np.int64)
    bits, signed = wrap
    c &= (1 << bits) - 1
    if signed:
        c = np.where(c >= 1 << (bits - 1), c - (1 << bits), c)
    keep = xs[src]
    y = np.zeros(n, np.int64)
    np.add.at(y, dst[keep], c[keep])
    present = np.bincount(dst[keep], minlength=n) > 0
    return np.where(present, y, 0).astype(np.int32), present


@pytest.mark.parametrize("x_full", [False, True], ids=["x_struct", "x_full"])
@pytest.mark.parametrize("dt", ["f32", "i32"])
@pytest.mark.parametrize("kind", list(GATHER_PLANS))
def test_gathered_expand_and_spmv_match_reference(gather_plans, kind, dt, x_full):
    """x read by index through ``src_dst_order``: ``_expand_dst`` equals the
    reference's routed expand slot for slot; ``spmv`` and ``spmv_masked``
    through the fused scan equal the reference (float plus within rtol
    1e-6), wrapped int8 its numpy oracle."""
    jplan, plan = gather_plans[kind]
    src, dst, w, n = (gather_plans[k] for k in ("src", "dst", "w", "n"))
    rng = np.random.default_rng(31)
    x = (rng.random(n) + 0.5).astype(np.float32) if dt == "f32" else rng.integers(-300, 300, n).astype(np.int32)
    xs = np.ones(n, bool) if x_full else rng.random(n) < 0.4
    got = port_fs._expand_dst(_t(x), plan)
    assert got.dtype == _t(x).dtype and got.shape == (plan.e_pad,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_ref_expand(jplan, jnp.asarray(x))))
    present = port_fs._present_dst(_t(xs), plan)
    assert present.dtype == torch.bool
    np.testing.assert_array_equal(present.numpy(), np.asarray(_ref_expand(jplan, jnp.asarray(xs.astype(np.float32)))) > 0.5)

    for add, mul in [("plus", "times"), ("min", "plus"), ("max", "first")]:
        name = f"{kind} {dt} {add}_{mul}"
        if dt == "f32":
            y = port_fs.spmv(plan, _t(x), add, mul)
            _same(y, ref_fs.spmv(jplan, jnp.asarray(x), add, mul), f"spmv {name}", rtol=1e-6 if add == "plus" else None)
        yv, ys = port_fs.spmv_masked(plan, _t(x), _t(xs), add, mul, x_full)
        want = ref_fs.spmv_masked(jplan, jnp.asarray(x), jnp.asarray(xs), add, mul, x_full)
        np.testing.assert_array_equal(ys.numpy(), np.asarray(want[1]), err_msg=name)
        float_add = dt == "f32" and add == "plus"
        _same(yv, want[0], f"spmv_masked {name}", rtol=1e-6 if float_add else None)
    if dt == "i32":
        wrap = (8, True)
        yv, ys = port_fs.spmv_masked(plan, _t(x), _t(xs), "plus", "times", x_full, wrap)
        want_v, want_s = _wrap_oracle(src, dst, w, n, x, xs, wrap)
        np.testing.assert_array_equal(ys.numpy(), want_s)
        np.testing.assert_array_equal(yv.numpy(), want_v)


@pytest.mark.parametrize("kind", list(GATHER_PLANS))
def test_reference_plan_file_without_src_dst_order(gather_plans, kind, tmp_path):
    """A JAX-package plan file that lacks ``src_dst_order`` reads with the
    array derived from ``src_sorted`` and the perm route: the build's, slot
    for slot."""
    jplan, plan = gather_plans[kind]
    path = str(tmp_path / "jax.npz")
    ref_fs.save_spmv_plan(jplan, path)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if k != "src_dst_order"}
    carried = port_fs.plan_from_reference(arrays, device="cpu")
    assert carried.src_dst_order.dtype == torch.int32
    np.testing.assert_array_equal(_np(carried.src_dst_order), _np(plan.src_dst_order))


@pytest.mark.parametrize("bad", [-1, "n"], ids=["negative", "n"])
def test_plan_files_keep_src_dst_order_inside_x(gather_plans, tmp_path, bad):
    """The fused gather reads x[src_dst_order] unchecked on the card, so a
    plan file, the port's or the JAX package's, whose array leaves [0, n)
    is refused on reading."""
    from graphblas_tpu_torch.exceptions import IndexOutOfBound

    jplan, plan = gather_plans["v2"]
    bad = plan.n if bad == "n" else bad
    path = str(tmp_path / "port.npz")
    port_fs.save_spmv_plan(plan, path)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["src_dst_order"] = arrays["src_dst_order"].copy()
    arrays["src_dst_order"][3] = bad
    np.savez(path, **arrays)
    with pytest.raises(IndexOutOfBound, match="src_dst_order"):
        port_fs.load_spmv_plan(path, device="cpu")
    jpath = str(tmp_path / "jax.npz")
    ref_fs.save_spmv_plan(jplan, jpath)
    with np.load(jpath) as data:
        jarrays = {k: data[k] for k in data.files}
    jarrays["src_dst_order"] = arrays["src_dst_order"]
    with pytest.raises(IndexOutOfBound, match="src_dst_order"):
        port_fs.plan_from_reference(jarrays, device="cpu")
