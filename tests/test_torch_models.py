"""Parity of the port's loop algorithms (graphblas_tpu_torch.models.fast) with
the JAX package's on the CPU, on the same numpy-made graphs.

Tolerances: BFS levels, BFS parents and SSSP distances are exact (the f32
x + w and the min are the same operations on both sides; a parent is the
largest candidate id, as ``any`` is max on both).  PageRank compares within
rtol 1e-5, atol 1e-7: its float sums round in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphblas_tpu.models import fast as ref_fast
from graphblas_tpu.models import graph as ref_graph
from graphblas_tpu.ops import fastspmv as ref_fs
from graphblas_tpu_torch import kernels
from graphblas_tpu_torch.models import fast as port_fast
from graphblas_tpu_torch.models import graph as port_graph
from graphblas_tpu_torch.ops import fastspmv as port_fs
from graphblas_tpu_torch.ops.scan import STATE_BIG


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
    g_ref = ref_graph.rmat(9, 16, seed=7, weighted=True)
    g_port = port_graph.rmat(9, 16, seed=7, weighted=True, device="cpu")
    src = np.asarray(g_ref.src)[np.asarray(g_ref.valid)]
    outdeg = np.bincount(src, minlength=g_ref.n)
    # the bench's pick (highest out-degree), plus a vertex with no out-edge
    return g_ref, g_port, np.argsort(outdeg)[::-1][:2].tolist() + [int(np.flatnonzero(outdeg == 0)[0])]


@pytest.fixture(scope="module", params=["rmat", "corners"])
def case(request):
    g_ref, g_port, sources = rmat_graph() if request.param == "rmat" else corner_graph()
    src = np.asarray(g_ref.src)[np.asarray(g_ref.valid)]
    outdeg = np.bincount(src, minlength=g_ref.n).astype(np.int32)
    dst = np.asarray(g_ref.dst)[np.asarray(g_ref.valid)]
    return {
        "jplan": ref_fast.analyze(g_ref),
        "plan": port_fast.analyze(g_port),
        # the same graph without endpoint routes (spmv_masked's other path)
        "jplan_ne": ref_fs.build_spmv_plan(src, dst, n=g_ref.n, endpoints=False),
        "plan_ne": port_fs.build_spmv_plan(src, dst, n=g_ref.n, endpoints=False, device="cpu"),
        "n": g_ref.n,
        "sources": sources,
        "outdeg": outdeg,
    }


def test_bfs_level_matches_reference(case):
    plan, jplan, n = case["plan"], case["jplan"], case["n"]
    for s in case["sources"]:
        want = np.asarray(ref_fast.bfs_level(jplan, s, n))
        got = port_fast.bfs_level(plan, s, n)
        assert got.dtype.is_floating_point is False and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"source {s}")
        assert got[s] == 0


@pytest.mark.parametrize("plans", [("jplan", "plan"), ("jplan_ne", "plan_ne")], ids=["v2", "no_endpoints"])
def test_bfs_parent_matches_reference(case, plans):
    jplan, plan = case[plans[0]], case[plans[1]]
    n = case["n"]
    levels = None
    for s in case["sources"]:
        want = np.asarray(ref_fast.bfs_parent(jplan, s, n))
        got = port_fast.bfs_parent(plan, s, n)
        assert got.dtype == torch.int32 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"source {s}")
        assert got[s] == s
        levels = port_fast.bfs_level(case["plan"], s, n).numpy()
        np.testing.assert_array_equal(got.numpy() >= 0, levels >= 0, err_msg="reached = reachable")
    assert (levels < 0).any()  # the graphs have vertices a source cannot reach


def test_sssp_matches_reference(case):
    plan, jplan, n = case["plan"], case["jplan"], case["n"]
    for s in case["sources"]:
        want = np.asarray(ref_fast.sssp(jplan, s, n))
        got = port_fast.sssp(plan, s, n)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"source {s}")
        assert got[s] == 0
        assert ((got.numpy() == STATE_BIG) == (want == STATE_BIG)).all()


@pytest.mark.parametrize("tol,max_iters", [(0.0, 30), (1e-6, 100)])
def test_pagerank_matches_reference(case, tol, max_iters):
    plan, jplan, n = case["plan"], case["jplan"], case["n"]
    outdeg = case["outdeg"]
    want = np.asarray(ref_fast.pagerank(jplan, jnp.asarray(outdeg), n, tol=tol, max_iters=max_iters))
    got = port_fast.pagerank(plan, outdeg, n, tol=tol, max_iters=max_iters)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    assert abs(float(got.sum()) - 1.0) < 1e-4


def test_loop_path_on_cpu_calls_only_plain_versions(case):
    """The SpMV slice on CPU tensors: every plain version of its kernels runs,
    no other plain version and no kernel launches."""
    plan, n = case["plan"], case["n"]
    kernels.reset_counts()
    port_fast.bfs_level(plan, case["sources"][0], n)
    port_fast.sssp(plan, case["sources"][0], n)
    port_fast.pagerank(plan, None, n, tol=0.0, max_iters=2)
    port_fast.bfs_parent(plan, case["sources"][0], n)
    port_fs.spmv(case["plan_ne"], torch.ones(n), "min", "plus")
    plain = kernels.plain_counts()
    spmv_kernels = ("gather", "gather_fill", "segscan_contrib", "segscan_state", "segscan", "segscan_contrib_gather")
    assert all(plain[k] > 0 for k in spmv_kernels), plain
    assert all(v == 0 for k, v in plain.items() if k not in spmv_kernels), plain
    assert sum(kernels.launch_counts().values()) == 0


def test_plain_versions_scope_selects_plain_code():
    assert not kernels.plain_requested()
    with kernels.plain_versions():
        assert kernels.plain_requested()
    assert not kernels.plain_requested()
