"""The port's on-disk plan cache and background plan build
(``core/sparse.py``: ``SparseMatrixData.plan``, ``plan_background``,
``plan_ready``, the "auto" dispatch of ``sparse_mxv``) against the JAX
package's (``graphblas_tpu/core/sparse.py:219-318``, ``:510-527``).

A cache file carries the reference's pattern digest under a name the
reference never reads; a hit builds nothing and equals a fresh build array
by array, also for another matrix of the pattern with its own weights; the
two packages' files share a directory; a file there that is not a port plan
file is rebuilt.  A background build builds on the CPU once, its plan equals
the blocking build's, a failure raises on the next request, and a blocking
request waits for it.  The CUDA tests (``-m cuda``; they skip here) hold the
dispatch on the card, where "auto" takes the plan: the first eager call is
served on the generic path while the plan builds, and the build makes no
CUDA call while a CUDA graph is captured.
"""

import hashlib
import os
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as P
from graphblas_tpu_torch.core import dtypes as pdt
from graphblas_tpu_torch.core import sparse as ps
from graphblas_tpu_torch.ops import fastspmv as pfs

DIGEST = re.compile(r"_(pull|push)_([0-9a-f]{32})\.npz$")


@pytest.fixture(scope="module")
def R_sparse():
    pytest.importorskip("jax")
    from graphblas_tpu.core import sparse as R_sparse

    return R_sparse


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("GRAPHBLAS_TPU_PLAN_CACHE", str(tmp_path))
    return tmp_path


def coo(seed=3, n=400, e=2500):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e), rng.random(e).astype(np.float32), n


def matrix(seed=3, n=400, e=2500, vals=None):
    r, c, v, n = coo(seed, n, e)
    sp = ps.SparseMatrixData.from_arrays(r, c, v, n, n, "plus")
    return sp if vals is None else ps.SparseMatrixData(sp.rows, sp.cols, vals(sp), n, n)


def files(d, prefix):
    return sorted(f for f in os.listdir(d) if f.startswith(prefix))


def same_plan(a, b, w_scale=None):
    """Two plans array by array, their scalars and the dst order; with
    ``w_scale``, b's weights are a's times it."""
    assert (a.n, a.e_pad, a.k_iso_dangling, a.loop_donors, a.total) == (b.n, b.e_pad, b.k_iso_dangling, b.loop_donors, b.total)
    assert sorted(a.arrays()) == sorted(b.arrays())
    for k, t in a.arrays().items():
        want = t * w_scale if k == "w_dst_order" and w_scale is not None else t
        assert torch.equal(b.arrays()[k], want), k
    np.testing.assert_array_equal(a.order_dst, b.order_dst)


@pytest.fixture
def builds(monkeypatch):
    """The build_spmv_plan calls of a test (the counting wrapper calls the
    builder, or raises where ``builds.forbid`` is set)."""
    calls = []
    orig = pfs.build_spmv_plan

    def counting(*a, **k):
        calls.append(threading.current_thread().name)
        if counting.forbid:
            raise AssertionError("build_spmv_plan was called")
        return orig(*a, **k)

    counting.forbid = False
    counting.calls = calls
    monkeypatch.setattr(pfs, "build_spmv_plan", counting)
    return counting


@pytest.mark.parametrize("loop", [False, True])
@pytest.mark.parametrize("direction", ["pull", "push"])
@pytest.mark.parametrize("values", ["float32", "bool", "none"])
def test_cache_file_carries_the_reference_pattern_digest(R_sparse, cache, direction, loop, values):
    """The reference's plan() and the port's, on the same matrix with the
    cache set, write one file each: gbtpu_plan3_* and gbtorch_plan1_*, with
    the same blake2b digest of the pattern (b"noW" for no weights)."""
    r, c, v, n = coo(5)
    v = {"float32": v, "bool": v > 0.5, "none": v}[values]
    rsp = R_sparse.SparseMatrixData.from_arrays(r, c, v, n, n, "first")
    psp = ps.SparseMatrixData.from_arrays(r, c, v, n, n, "first")
    if values == "none":
        rsp = R_sparse.SparseMatrixData(rsp.rows, rsp.cols, None, n, n)
        psp = ps.SparseMatrixData(psp.rows, psp.cols, None, n, n)
    rsp.plan(direction, loop=loop)
    psp.plan(direction, "cpu", loop=loop)
    variant = "loopT_" if loop else ""
    (rf,), (pf,) = files(cache, "gbtpu_plan3_"), files(cache, "gbtorch_plan1_")
    assert rf.startswith(f"gbtpu_plan3_{variant}{direction}_") and pf.startswith(f"gbtorch_plan1_{variant}{direction}_")
    assert DIGEST.search(rf).group(2) == DIGEST.search(pf).group(2)
    h = hashlib.blake2b(digest_size=16)
    for part in (np.int64([n, n, psp.nvals]).tobytes(), psp.rows.tobytes(), psp.cols.tobytes()):
        h.update(part)
    if values == "none":
        h.update(b"noW")
    assert DIGEST.search(pf).group(2) == h.hexdigest()


@pytest.mark.parametrize("loop", [False, True])
@pytest.mark.parametrize("weights", ["same", "other"])
def test_a_hit_builds_nothing_and_equals_a_fresh_build(cache, builds, loop, weights):
    """A second matrix of the pattern loads the file with its own weights:
    no build, and the plan equals a fresh build array by array, the loop
    route and ``total`` included; the device cache stays by device."""
    first = matrix()
    first.plan("pull", "cpu", loop=loop)
    assert len(builds.calls) == 1 and len(files(cache, "gbtorch_plan1_")) == 1
    scale = 1.0 if weights == "same" else 2.0
    second = matrix(vals=lambda sp: sp.vals * np.float32(scale))
    builds.forbid = True
    got = second.plan("pull", "cpu", loop=loop)
    builds.forbid = False
    same_plan(first.plan("pull", "cpu", loop=loop), got, w_scale=None if weights == "same" else scale)
    fresh = pfs.build_spmv_plan(second.cols, second.rows, second.vals, n=400, loop_net=loop, total=loop, device="cpu")
    same_plan(fresh, got)
    assert list(second._plans) == [("pull", "cpu")] and not second._sharded_plans


def test_loop_plan_keeps_its_own_file_and_replaces_the_plain_plan(cache, builds):
    a = matrix()
    plain = a.plan("pull", "cpu")
    loop = a.plan("pull", "cpu", loop=True)
    assert plain.loop_idx is None and loop.total and loop.loop_idx is not None
    assert a.plan("pull", "cpu") is loop and len(builds.calls) == 2
    assert {f.split("_pull_")[0] for f in files(cache, "gbtorch_plan1_")} == {"gbtorch_plan1", "gbtorch_plan1_loopT"}


def test_a_plain_request_loads_the_loop_capable_file(cache, builds):
    """As in memory, a loop-capable plan on disk serves a plain request (the
    card's n-space compiled loops ask plain plans of what build_plan wrote)."""
    loop = matrix().plan("push", "cpu", loop=True)
    builds.forbid = True
    got = matrix().plan("push", "cpu")
    same_plan(loop, got)
    assert got.total and got.loop_idx is not None


def test_jax_and_port_files_leave_each_other_alone(R_sparse, cache, builds, monkeypatch):
    """Both packages' files in one directory: each package loads its own
    (neither builds a second time) and neither file changes."""
    import graphblas_tpu.ops.fastspmv as R_fs

    r, c, v, n = coo(7)
    R_sparse.SparseMatrixData.from_arrays(r, c, v, n, n, "plus").plan("pull")
    ps.SparseMatrixData.from_arrays(r, c, v, n, n, "plus").plan("pull", "cpu")
    names = files(cache, "gbtpu_plan3_") + files(cache, "gbtorch_plan1_")
    before = {f: (cache / f).read_bytes() for f in names}
    builds.forbid = True
    monkeypatch.setattr(R_fs, "build_spmv_plan", builds)
    R_sparse.SparseMatrixData.from_arrays(r, c, v, n, n, "plus").plan("pull")
    ps.SparseMatrixData.from_arrays(r, c, v, n, n, "plus").plan("pull", "cpu")
    assert {f: (cache / f).read_bytes() for f in names} == before and len(names) == 2


@pytest.mark.parametrize("content", ["reference plan", "other npz", "not a zip", "empty"])
def test_a_file_that_is_not_a_port_plan_is_rebuilt(R_sparse, cache, builds, content):
    """A file under the port's name that load_spmv_plan refuses, or that is
    no readable .npz, is a miss: the plan is built and the file overwritten."""
    a = matrix()
    a.plan("pull", "cpu")
    (name,) = files(cache, "gbtorch_plan1_")
    path = cache / name
    if content == "reference plan":
        R_sparse.SparseMatrixData(a.rows, a.cols, a.vals, a.nrows, a.ncols).plan("pull")
        (ref,) = files(cache, "gbtpu_plan3_")
        path.write_bytes((cache / ref).read_bytes())
    elif content == "other npz":
        with open(path, "wb") as fh:
            np.savez(fh, meta=np.arange(5))
    else:
        path.write_bytes(b"" if content == "empty" else b"plan")
    b = matrix()
    got = b.plan("pull", "cpu")
    assert len(builds.calls) == 2
    same_plan(a.plan("pull", "cpu"), got)
    same_plan(got, pfs.load_spmv_plan(str(path), w=b.vals, device="cpu"))


def test_any_other_cache_error_raises(cache):
    a = matrix()
    a.plan("pull", "cpu")
    (name,) = files(cache, "gbtorch_plan1_")
    os.remove(cache / name)
    os.mkdir(cache / name)  # exists, but np.load cannot open it
    with pytest.raises(IsADirectoryError):
        matrix().plan("pull", "cpu")


def wait_ready(sp, direction="pull", device="cpu", timeout=60):
    t_end = time.monotonic() + timeout
    while not sp.plan_ready(direction, device):
        assert time.monotonic() < t_end, "the background build did not finish"
        time.sleep(0.005)


def test_plan_background_is_idempotent_and_equals_the_blocking_build(builds):
    a = matrix()
    assert not a.plan_ready("pull", "cpu")
    a.plan_background("pull", "cpu")
    a.plan_background("pull", "cpu")
    assert len(a._bg_builds) == 1
    wait_ready(a)
    assert not a._bg_builds and builds.calls == ["graphblas-plan-pull"]
    a.plan_background("pull", "cpu")  # ready: nothing starts
    assert not a._bg_builds
    same_plan(matrix().plan("pull", "cpu"), a.plan("pull", "cpu"))
    assert len(builds.calls) == 2


def test_a_failed_background_build_raises_on_the_next_request(monkeypatch):
    def boom(*a, **k):
        raise ValueError("boom")

    monkeypatch.setattr(pfs, "build_spmv_plan", boom)
    a = matrix()
    a.plan_background("push", "cpu")
    done, _ = a._bg_builds["push"]
    assert done.wait(60)
    with pytest.raises(RuntimeError, match="background build of the push plan failed") as info:
        a.plan("push", "cpu")
    assert isinstance(info.value.__cause__, ValueError)
    monkeypatch.undo()
    # raised once: the next request builds
    same_plan(matrix().plan("push", "cpu"), a.plan("push", "cpu"))
    monkeypatch.setattr(pfs, "build_spmv_plan", boom)
    b = matrix()
    b.plan_background("pull", "cpu")
    assert b._bg_builds["pull"][0].wait(60)
    with pytest.raises(RuntimeError):
        b.plan_ready("pull", "cpu")


def test_a_blocking_plan_during_a_build_waits_for_it(builds, monkeypatch):
    """plan() finds the build in flight and waits for it (one build), then
    upgrades to the loop plan when asked."""
    gate = threading.Event()
    build = pfs.build_spmv_plan

    def slow(*a, **k):
        assert gate.wait(60)
        return build(*a, **k)

    monkeypatch.setattr(pfs, "build_spmv_plan", slow)
    a = matrix()
    a.plan_background("pull", "cpu")
    threading.Timer(0.2, gate.set).start()
    got = a.plan("pull", "cpu")
    assert builds.calls == ["graphblas-plan-pull"] and not a._bg_builds
    same_plan(matrix().plan("pull", "cpu"), got)
    a.plan_background("push", "cpu")
    loop = a.plan("push", "cpu", loop=True)
    assert loop.total and loop.loop_idx is not None and a.plan("push", "cpu") is loop
    assert builds.calls[-2:] == ["graphblas-plan-push", "MainThread"]


def test_concurrent_background_builds_of_one_pattern(cache, builds):
    """Many background builds at once, half of them of one pattern (one
    cache file written by several threads): every plan equals its blocking
    build with its own weights, and the file is a whole port plan."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        mats = [matrix(vals=lambda sp, k=k: sp.vals * np.float32(k + 1)) for k in range(6)]
        mats += [matrix(seed=10 + k) for k in range(6)]
        for m in mats:
            m.plan_background("pull", "cpu")
        got = [m.plan("pull", "cpu") for m in mats]
    finally:
        sys.setswitchinterval(old)
    assert not any(m._bg_builds for m in mats)
    assert not [t for t in threading.enumerate() if t.name.startswith("graphblas-plan-")]
    for m, p in zip(mats, got):
        same_plan(pfs.build_spmv_plan(m.cols, m.rows, m.vals, n=400, loop_net=False, device="cpu"), p)
    assert len(files(cache, "gbtorch_plan1_")) == 7 and not [f for f in os.listdir(cache) if ".tmp." in f]
    for f in files(cache, "gbtorch_plan1_"):
        pfs.load_spmv_plan(str(cache / f), device="cpu")


@pytest.mark.parametrize("setting", ["1", "0", ""])
@pytest.mark.parametrize("eager", [True, False])
@pytest.mark.parametrize("ready", [True, False])
@pytest.mark.parametrize("strategy", ["auto", "plan", "generic"])
def test_serve_generic_while_building_decision(strategy, ready, eager, setting):
    asked = []

    def is_ready():
        asked.append(1)
        return ready

    want = strategy == "auto" and not ready and eager and setting != "0"
    assert ps._serve_generic_while_building(strategy, eager, setting, is_ready) is want
    # readiness is asked only of an eager "auto" dispatch that may build in the background
    assert bool(asked) == (strategy == "auto" and eager and setting != "0")


def _dispatch(sp, x, xs, sr):
    return ps.sparse_mxv(sp, True, True, x, xs, sr, pdt.FP32)


@pytest.fixture
def auto_takes_cpu_plans(monkeypatch):
    """"auto" takes the plan for CPU tensors too (on the card it does from
    2^17 entries), so the dispatch runs here."""
    monkeypatch.setattr(ps, "_plan_allowed", lambda sp, strategy, xv: strategy != "generic")
    monkeypatch.delenv("GRAPHBLAS_TPU_PLAN_BACKGROUND", raising=False)


def plan_path_calls(fn):
    """fn()'s result and whether it ran on the plan engine (the route's
    plain version ran: the generic path routes nothing)."""
    P.kernels.reset_counts()
    out = fn()
    return out, P.kernels.plain_counts()["gather"] > 0


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus"])
def test_auto_dispatch_serves_generic_while_the_plan_builds(auto_takes_cpu_plans, builds, sr_name):
    sr = getattr(P.semiring, sr_name)["FP32"]
    a = matrix()
    rng = np.random.default_rng(9)
    x, xs = torch.from_numpy(rng.random(400).astype(np.float32)), torch.ones(400, dtype=torch.bool)
    (y0, s0), on_plan = plan_path_calls(lambda: _dispatch(a, x, xs, sr))
    assert not on_plan and "pull" in a._bg_builds
    wait_ready(a)
    (y1, s1), on_plan = plan_path_calls(lambda: _dispatch(a, x, xs, sr))
    assert on_plan and builds.calls == ["graphblas-plan-pull"]
    assert torch.equal(s0, s1)
    if sr_name == "plus_times":
        torch.testing.assert_close(y1, y0, rtol=1e-6, atol=0)
    else:
        assert torch.equal(y1.view(torch.int32), y0.view(torch.int32))


@pytest.mark.parametrize("case", ["plan strategy", "setting 0", "capture"])
def test_a_dispatch_that_is_not_eager_auto_blocks(auto_takes_cpu_plans, monkeypatch, builds, case):
    """Strategy "plan", GRAPHBLAS_TPU_PLAN_BACKGROUND=0 or a compiled loop's
    capture scope: the dispatch builds the plan and takes it."""
    from graphblas_tpu_torch.core import capture as pcap

    sr = P.semiring.plus_times["FP32"]
    a = matrix()
    x, xs = torch.ones(400), torch.ones(400, dtype=torch.bool)
    strategy = "plan" if case == "plan strategy" else "auto"
    if case == "setting 0":
        monkeypatch.setenv("GRAPHBLAS_TPU_PLAN_BACKGROUND", "0")
    scope = {"capture": lambda: pcap.Scope("warm")}.get(case)
    with P.tx.config.set(mxv_strategy=strategy):
        if scope is None:
            _, on_plan = plan_path_calls(lambda: _dispatch(a, x, xs, sr))
        else:
            with scope():
                _, on_plan = plan_path_calls(lambda: _dispatch(a, x, xs, sr))
    assert on_plan and not a._bg_builds and builds.calls == ["MainThread"]


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def big_matrix():
    """2^18 random edges on 2^14 vertices: past "auto"'s 2^17 entries."""
    r, c, v, n = coo(seed=4, n=1 << 14, e=1 << 18)
    return ps.SparseMatrixData.from_arrays(r, c, v, n, n, "plus")


@pytest.mark.cuda
@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus"])
def test_auto_dispatch_on_cuda_serves_generic_then_the_plan(sr_name, monkeypatch):
    dev = cuda_or_skip()
    monkeypatch.delenv("GRAPHBLAS_TPU_PLAN_BACKGROUND", raising=False)
    monkeypatch.delenv("GRAPHBLAS_TPU_PLAN_CACHE", raising=False)
    sr = getattr(P.semiring, sr_name)["FP32"]
    a = big_matrix()
    n = a.nrows
    x = torch.rand(n, device=dev, generator=torch.Generator(dev).manual_seed(1))
    xs = torch.ones(n, dtype=torch.bool, device=dev)
    P.kernels.reset_counts()
    y0, s0 = _dispatch(a, x, xs, sr)
    torch.cuda.synchronize()
    assert P.kernels.launch_counts()["gather"] == 0 and "pull" in a._bg_builds
    wait_ready(a, device=dev)
    y1, s1 = _dispatch(a, x, xs, sr)
    torch.cuda.synchronize()
    assert P.kernels.launch_counts()["gather"] > 0 and not any(P.kernels.plain_counts().values())
    assert a._plans[("pull", "cuda:0")].device.type == "cuda" and torch.equal(s0, s1)
    if sr_name == "plus_times":
        torch.testing.assert_close(y1, y0, rtol=1e-6, atol=0)
    else:
        assert torch.equal(y1.view(torch.int32), y0.view(torch.int32))


@pytest.mark.cuda
def test_background_build_makes_no_cuda_call_during_a_graph_capture(monkeypatch):
    """CUDA graphs captured on the main thread (capture_error_mode "global")
    while the plan builds: a CUDA call from the worker would break them."""
    dev = cuda_or_skip()
    monkeypatch.delenv("GRAPHBLAS_TPU_PLAN_CACHE", raising=False)
    a = big_matrix()
    a.plan_background("pull", dev)
    x = torch.ones(1 << 20, device=dev)
    torch.cuda.synchronize()
    captures = 0
    done, _ = a._bg_builds["pull"]
    while not done.is_set() or captures == 0:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            y = x * 2.0 + 1.0
        g.replay()
        captures += 1
    torch.cuda.synchronize()
    assert float(y[0]) == 3.0
    wait_ready(a, device=dev)
    plan = a.plan("pull", dev)
    same_plan(pfs.build_spmv_plan(a.cols, a.rows, a.vals, n=a.nrows, loop_net=False, device="cpu"), plan.to("cpu"))
