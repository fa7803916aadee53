"""Parity of the port's ``spmv_masked`` with the JAX package's, on the CPU.

Both packages get the same numpy inputs: the engineered corner graph (a sink,
a vertex with no in-edge, a self-loop only, an isolated vertex) analyzed with
and without endpoint routes, x made from a seed, and x's structure with 40%
present.  Every add in {plus, min, max, any} meets every mul in {times,
plus, first, second, pair, secondi}, with x's structure read or x full.

Tolerances: the structure is exact; values are exact for integers, min, max,
any, pair and secondi.  A float plus sums each destination's present edges
in another order on each side (the reference's lane/row scan tree against
the port's log-step scan), so float plus compares within rtol 1e-6 on
positive inputs.

The reference cannot run ``wrap`` on a value channel (its contrib scan
traces ``wrap``; ROADMAP.md section 3), so those cases compare with a numpy
oracle; the pair channel's ``wrap`` runs in the reference and compares with
it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphblas_tpu.ops import fastspmv as ref_fs
from graphblas_tpu_torch import kernels
from graphblas_tpu_torch.ops import fastspmv as port_fs

ADDS = ("plus", "min", "max", "any")
MULS = ("times", "plus", "first", "second", "pair", "secondi")
PLANS = ("v2", "no_endpoints")


def corner_edges():
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
    return src, dst, w, n


@pytest.fixture(scope="module")
def graph():
    src, dst, w, n = corner_edges()
    plans = {}
    for kind, opts in (("v2", {}), ("no_endpoints", {"endpoints": False})):
        plans[kind] = (
            ref_fs.build_spmv_plan(src, dst, w, n=n, **opts),
            port_fs.build_spmv_plan(src, dst, w, n=n, device="cpu", **opts),
        )
    rng = np.random.default_rng(17)
    xs = rng.random(n) < 0.4
    # a destination with in-edges whose sources are all absent must come out absent
    masked_out = np.bincount(dst, minlength=n) > 0
    masked_out &= np.bincount(dst, weights=xs[src].astype(float), minlength=n) == 0
    assert masked_out.any()
    return {"src": src, "dst": dst, "w": w, "n": n, "plans": plans, "xs": xs, "masked_out": masked_out}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check(got, want, exact, name):
    gv, gs = got
    wv, ws = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gs.numpy(), ws, err_msg=f"{name}: structure")
    assert gv.numpy().dtype == wv.dtype, name
    if exact:
        np.testing.assert_array_equal(gv.numpy(), wv, err_msg=f"{name}: values")
    else:
        np.testing.assert_allclose(gv.numpy(), wv, rtol=1e-6, atol=0, err_msg=f"{name}: values")


@pytest.mark.parametrize("x_full", [False, True], ids=["x_struct", "x_full"])
@pytest.mark.parametrize("mul", MULS)
@pytest.mark.parametrize("add", ADDS)
def test_spmv_masked_matches_reference(graph, add, mul, x_full):
    x = (np.random.default_rng(18).random(graph["n"]) + 0.5).astype(np.float32)
    xs = graph["xs"]
    exact = not (add == "plus" and mul in ("times", "plus", "first", "second"))
    for kind in PLANS:
        jplan, plan = graph["plans"][kind]
        want = ref_fs.spmv_masked(jplan, jnp.asarray(x), jnp.asarray(xs), add, mul, x_full)
        got = port_fs.spmv_masked(plan, _t(x), _t(xs), add, mul, x_full)
        _check(got, want, exact, f"{kind} {add}_{mul}")
        if not x_full:
            assert not got[1][_t(graph["masked_out"])].any()


@pytest.mark.parametrize(
    "dt,add,mul",
    [("i32", "plus", "times"), ("i32", "min", "plus"), ("i32", "max", "second"), ("i32", "any", "first"),
     ("i8", "plus", "times"), ("i8", "max", "plus")],
)
def test_spmv_masked_integer_channels(graph, dt, add, mul):
    """int32 and int8 x: float weights are cast to x's dtype, as the
    reference aligns them; int8 rides every route at its own width (the
    non-v2 expand through the generic scan) and its sums wrap on store."""
    rng = np.random.default_rng(19)
    x = rng.integers(-300, 300, graph["n"]).astype(np.int32) if dt == "i32" else rng.integers(-20, 20, graph["n"]).astype(np.int8)
    for kind in PLANS:
        jplan, plan = graph["plans"][kind]
        want = ref_fs.spmv_masked(jplan, jnp.asarray(x), jnp.asarray(graph["xs"]), add, mul, False)
        got = port_fs.spmv_masked(plan, _t(x), _t(graph["xs"]), add, mul, False)
        _check(got, want, True, f"{kind} {dt} {add}_{mul}")


def _oracle(graph, x, add, mul, wrap):
    """numpy: per present edge the int32 product or sum of x[s] and the
    int32-cast weight, wrapped to ``wrap`` bits, then reduced per dst."""
    src, dst, n = graph["src"], graph["dst"], graph["n"]
    xs = graph["xs"]
    wi = graph["w"].astype(np.int32).astype(np.int64)
    c = x[src].astype(np.int64) * wi if mul == "times" else x[src].astype(np.int64) + wi
    bits, signed = wrap
    c &= (1 << bits) - 1
    if signed:
        c = np.where(c >= 1 << (bits - 1), c - (1 << bits), c)
    keep = xs[src]
    y = np.zeros(n, np.int64) if add == "plus" else np.full(n, np.iinfo(np.int64).min)
    (np.add if add == "plus" else np.maximum).at(y, dst[keep], c[keep])
    present = np.bincount(dst[keep], minlength=n) > 0
    return np.where(present, y, 0).astype(np.int32), present


@pytest.mark.parametrize("wrap", [(8, True), (16, False)])
@pytest.mark.parametrize("add,mul", [("plus", "times"), ("max", "plus")])
def test_spmv_masked_wrap_matches_numpy_oracle(graph, add, mul, wrap):
    x = np.random.default_rng(20).integers(-3000, 3000, graph["n"]).astype(np.int32)
    want_v, want_s = _oracle(graph, x, add, mul, wrap)
    assert (want_v != _oracle(graph, x, add, mul, (31, True))[0]).any()  # the wrap bites
    for kind in PLANS:
        _, plan = graph["plans"][kind]
        got_v, got_s = port_fs.spmv_masked(plan, _t(x), _t(graph["xs"]), add, mul, False, wrap)
        np.testing.assert_array_equal(got_s.numpy(), want_s, err_msg=kind)
        np.testing.assert_array_equal(got_v.numpy(), want_v, err_msg=kind)


@pytest.mark.parametrize("wrap", [(3, True), (2, False)])
def test_spmv_masked_pair_wrap_matches_reference(graph, wrap):
    """The pair channel wraps its count after the scan (the reference runs it)."""
    x = np.ones(graph["n"], np.int32)
    for kind in PLANS:
        jplan, plan = graph["plans"][kind]
        for x_full in (False, True):
            want = ref_fs.spmv_masked(jplan, jnp.asarray(x), jnp.asarray(graph["xs"]), "plus", "pair", x_full, wrap)
            got = port_fs.spmv_masked(plan, _t(x), _t(graph["xs"]), "plus", "pair", x_full, wrap)
            _check(got, want, True, f"{kind} pair wrap {wrap}")


def test_spmv_masked_on_cpu_calls_only_plain_versions(graph):
    _, plan = graph["plans"]["v2"]
    x = _t(np.ones(graph["n"], np.float32))
    kernels.reset_counts()
    port_fs.spmv_masked(plan, x, _t(graph["xs"]), "any", "secondi")
    plain = kernels.plain_counts()
    # per call on a v2 plan: x's structure gathered through src_dst_order, 2
    # collects; one contrib scan (secondi reads the index itself) and one count scan
    assert plain == {
        "gather": 3, "gather_fill": 0, "segscan_contrib": 1, "segscan_state": 0, "segscan": 1,
        "eqjoin": 0, "compare_probe": 0, "tropical_mxm": 0, "imatmul": 0, "segscan_contrib_gather": 0,
        "segscan_spmm": 0, "segscan_spmm_keep": 0,
    }, plain
    assert sum(kernels.launch_counts().values()) == 0
