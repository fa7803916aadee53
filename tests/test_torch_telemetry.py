"""The port's registry of spans and counters (``graphblas_tpu_torch.core.telemetry``)
and the benchmark's per-layer metrics that read it.

Spans keep calls, total and self seconds (the total less the spans opened
inside them on the same thread); under a ``torch.profiler`` they land in the
trace as ``user_annotation`` events; the kernels' launch counts and the
mesh's gathers and reshards are counters of the registry.  Every test starts
from ``telemetry.reset()``.
"""

import json
import threading
import time
import types

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as gb
from graphblas_tpu_torch import kernels
from graphblas_tpu_torch.core import telemetry
from graphblas_tpu_torch.parallel import blocks

from gbbench import registry, run, trace

SCALE = 8
CELLS = ["kron21.pagerank", "urand21.sssp", "kron21.pagerank-eager", "kron21.sssp"]
READERS = [
    "sparse.plan_build_s",
    "sparse.col_order_s",
    "compiler.capture_s",
    "compiler.replay_host_us",
    "compiler.host_reads_per_iter",
    "collections.to_dense_ms",
    "collections.to_dense_ms.eager",
    "collections.front_ms_per_stmt",
    "ops.host_ms_per_stmt",
    "kernels.launch_host_us",
]


@pytest.fixture(autouse=True)
def fresh():
    telemetry.reset()
    yield
    telemetry.reset()


def _spans():
    return telemetry.snapshot()["spans"]


def test_self_seconds_are_the_total_less_the_children():
    with telemetry.span("t.outer"):
        time.sleep(0.01)
        with telemetry.span("t.inner"):
            time.sleep(0.02)
        with telemetry.span("t.inner"):
            with telemetry.span("t.leaf"):
                time.sleep(0.01)
    s = _spans()
    outer, inner, leaf = s["t.outer"], s["t.inner"], s["t.leaf"]
    assert (outer["count"], inner["count"], leaf["count"]) == (1, 2, 1)
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"], abs=1e-12)
    assert inner["self_s"] == pytest.approx(inner["total_s"] - leaf["total_s"], abs=1e-12)
    assert leaf["self_s"] == leaf["total_s"] >= 0.01
    assert outer["total_s"] >= 0.04 and 0.01 <= outer["self_s"] < outer["total_s"]


def test_a_threads_spans_nest_on_its_own_stack():
    def work():
        with telemetry.span("t.bg"):
            with telemetry.span("t.bg_child"):
                time.sleep(0.03)

    with telemetry.span("t.main"):
        worker = threading.Thread(target=work)
        worker.start()
        worker.join()
    s = _spans()
    # the background span ran inside t.main's interval but is not its child
    assert s["t.main"]["self_s"] == s["t.main"]["total_s"] >= 0.03
    assert s["t.bg"]["self_s"] == pytest.approx(s["t.bg"]["total_s"] - s["t.bg_child"]["total_s"], abs=1e-12)


def test_an_exception_closes_its_span():
    with pytest.raises(ValueError):
        with telemetry.span("t.outer"):
            with telemetry.span("t.raises"):
                raise ValueError("x")
    with telemetry.span("t.after"):
        pass
    s = _spans()
    assert s["t.raises"]["count"] == s["t.outer"]["count"] == s["t.after"]["count"] == 1
    assert s["t.after"]["self_s"] == s["t.after"]["total_s"]


def test_counters_snapshot_and_reset():
    telemetry.count("t.a")
    telemetry.count("t.a", 4)
    telemetry.count("u.b", 2)
    with telemetry.span("t.span"):
        pass
    snap = telemetry.snapshot()
    assert snap["counters"] == {"t.a": 5, "u.b": 2}
    assert set(snap["spans"]) == {"t.span"} and set(snap["spans"]["t.span"]) == {"count", "total_s", "self_s"}
    json.dumps(snap)
    assert telemetry.counter("t.a") == 5 and telemetry.counter("never") == 0
    telemetry.reset("t.")
    snap = telemetry.snapshot()
    assert snap == {"spans": {}, "counters": {"u.b": 2}}
    with telemetry.span("t.span"):
        pass
    assert _spans()["t.span"]["count"] == 1
    telemetry.reset()
    assert telemetry.snapshot() == {"spans": {}, "counters": {}}


def test_device_counters_fold_at_snapshot():
    """Counts a kernel adds on its device reach the counters at a snapshot,
    by what they gained since the last; a reset zeroes them."""
    t = telemetry.device_counters(("t.kept", "t.all"), "cpu")
    assert telemetry.device_counters(("t.kept", "t.all"), "cpu") is t and t.dtype == torch.int64
    t.add_(torch.tensor([3, 8]))
    assert telemetry.snapshot()["counters"] == {"t.kept": 3, "t.all": 8}
    t.add_(torch.tensor([1, 0]))
    assert telemetry.snapshot()["counters"] == {"t.kept": 4, "t.all": 8}
    t.add_(torch.tensor([5, 5]))
    telemetry.reset("t.")
    assert telemetry.snapshot()["counters"] == {} and t.tolist() == [0, 0]
    t.add_(torch.tensor([2, 2]))
    assert telemetry.snapshot()["counters"] == {"t.kept": 2, "t.all": 2}


def test_kept_share_reads_the_masked_products_counts(monkeypatch):
    """``ops.spmm_kept_share``: the kept slots over the masked products'
    plan slots, in percent, in a traced run that kept the card busy; nothing
    without a masked product, without such a trace, or without the registry
    (a parent library)."""
    import sys

    import graphblas_tpu_torch.core as core

    reader = registry.metric("ops.spmm_kept_share")
    busy = run.Readings({}, reduced=types.SimpleNamespace(busy_s=1.0))
    assert reader.read(busy) is None
    telemetry.count("ops.spmm_kept_slots", 25)
    telemetry.count("ops.spmm_masked_slots", 200)
    assert reader.read(busy) == pytest.approx(12.5)
    assert reader.read(run.Readings({})) is None
    assert reader.read(run.Readings({}, reduced=types.SimpleNamespace(busy_s=0.0))) is None
    monkeypatch.delattr(core, "telemetry")
    monkeypatch.setitem(sys.modules, "graphblas_tpu_torch.core.telemetry", None)
    assert reader.read(busy) is None


def test_timed_and_host_read():
    @telemetry.timed("t.fn")
    def fn(x, y=1):
        """doc"""
        with telemetry.host_read("t_site"):
            return x + y

    assert fn.__name__ == "fn" and fn.__doc__ == "doc" and fn(2, y=3) == 5
    s = _spans()
    assert s["t.fn"]["count"] == 1 and s["collections.read"]["count"] == 1
    assert telemetry.snapshot()["counters"] == {"host_reads": 1, "host_reads.t_site": 1}


def test_the_collections_count_their_reads():
    with gb.tx.config.set(platform="cpu"):
        v = gb.Vector.from_coo([0, 2], [1.0, 2.0], gb.dtypes.FP32, size=4)
        assert v.nvals == 2 and v.nvals == 2  # one read: the count is cached
        assert v.to_dense(fill_value=0.0).tolist() == [1.0, 0.0, 2.0, 0.0]
        s = v.reduce(gb.monoid.plus).new()
        assert s.value == 3.0
    counters = telemetry.snapshot()["counters"]
    # to_dense fills on the values' device: one read, of the filled values
    assert counters["host_reads.nvals"] == 1 and "host_reads.to_numpy" not in counters
    assert counters["host_reads.to_dense"] == 1 and counters["host_reads.scalar_value"] == 1
    assert counters["host_reads"] == 3
    spans = _spans()
    assert spans["collections.from_coo"]["count"] == 1 and spans["collections.stmt"]["count"] == 1
    dense = spans["collections.to_dense"]
    assert dense["count"] == 1 and dense["self_s"] < dense["total_s"]  # its reads are children
    assert spans["ops.reduce_all"]["count"] == 1


def test_a_statement_inside_another_is_part_of_it():
    """An aggregator's reduce runs statements of its own: the user's one
    statement is one call of ``collections.stmt``."""
    with gb.tx.config.set(platform="cpu", dense_limit=16):
        A = gb.Matrix.from_coo([0, 1, 3], [1, 1, 2], 1.0, gb.dtypes.FP32, nrows=8, ncols=8)
        assert A._sparse is not None
        telemetry.reset()
        deg = A.reduce_columnwise(gb.agg.count).new(gb.dtypes.FP32)
    assert deg.to_dense(fill_value=0.0).tolist() == [0.0, 2.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    spans = _spans()
    assert spans["collections.stmt"]["count"] == 1 and spans["sparse.col_order"]["count"] == 1
    assert spans["collections.stmt"]["total_s"] >= spans["sparse.col_order"]["total_s"]


def test_spans_land_in_the_profilers_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    path = str(tmp_path / "trace.json")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.SLICE):
            with record_function("gbbench.trial"):
                torch.ones(8).sum()
                with telemetry.span("collections.to_dense"):
                    with telemetry.span("collections.read"):
                        torch.ones(8).cumsum(0)
                    time.sleep(0.05)
    prof.export_chrome_trace(path)
    events = trace.load(path)
    marks = {
        e["name"]: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
    }
    trial, dense, read = marks["gbbench.trial"], marks["collections.to_dense"], marks["collections.read"]
    assert trial[0] <= dense[0] <= read[0] <= read[1] <= dense[1] <= trial[1]
    # the slice has no device work: one gap, its middle inside the span's sleep
    reduced = trace.reduce(events)
    assert reduced.idle_gaps[0][0] == "collections.to_dense"
    assert _spans()["collections.to_dense"]["count"] == 1


def test_the_profiler_check_is_an_attribute():
    assert not torch.autograd.profiler._is_profiler_enabled
    with telemetry.span("t.quiet"):
        pass
    assert _spans()["t.quiet"]["count"] == 1


def test_launch_counts_are_counters():
    names = ["gather", "gather_fill", "segscan_contrib", "segscan_state", "segscan", "segscan_contrib_gather",
             "segscan_spmm", "segscan_spmm_keep", "eqjoin", "compare_probe", "tropical_mxm", "imatmul"]
    kernels.reset_counts()
    assert list(kernels.launch_counts()) == names and set(kernels.launch_counts().values()) == {0}
    kernels.gather.gather(torch.arange(4.0), torch.tensor([3, 0], dtype=torch.int32))
    assert kernels.plain_counts()["gather"] == 1 and sum(kernels.launch_counts().values()) == 0
    kernels.add_launches({"gather": 2, "segscan_contrib": 1, "unknown": 5}, 3)
    kernels.add_launches({"gather": 2}, -1)
    assert kernels.launch_counts()["gather"] == 4 and kernels.launch_counts()["segscan_contrib"] == 3
    assert "unknown" not in kernels.launch_counts()
    counters = telemetry.snapshot()["counters"]
    assert counters["kernels.launches.gather"] == 4 and counters["kernels.plain.gather"] == 1
    telemetry.count("host_reads")
    kernels.reset_counts()
    assert set(kernels.launch_counts().values()) == set(kernels.plain_counts().values()) == {0}
    assert telemetry.snapshot()["counters"] == {"host_reads": 1}


def test_a_replay_adds_its_captures_launches():
    from graphblas_tpu_torch.core import compiler

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    kernels.reset_counts()
    loop = object.__new__(compiler.CompiledLoop)
    loop._graphs = {2: (Graph(), {"gather": 6, "segscan_contrib": 2}, "flag", [])}
    assert loop._replay(2) == "flag" and loop._replay(2) == "flag"
    assert Graph.replays == 2
    assert kernels.launch_counts()["gather"] == 12 and kernels.launch_counts()["segscan_contrib"] == 4
    assert telemetry.counter("compiler.replays") == 2 and _spans()["compiler.replay"]["count"] == 2
    assert compiler._read_stop_flag(torch.tensor(True)) is True
    assert telemetry.counter("host_reads") == 1 and telemetry.counter("host_reads.flag_read") == 1
    assert _spans()["compiler.flag_read"]["count"] == 1


def test_the_mesh_counts_are_counters():
    blocks.reset_counts()
    assert blocks.counts() == {"gathers": 0, "reshards": 0}
    telemetry.count("parallel.gathers", 2)
    telemetry.count("parallel.reshards")
    assert blocks.counts() == {"gathers": 2, "reshards": 1}
    blocks.reset_counts()
    assert blocks.counts() == {"gathers": 0, "reshards": 0}


def test_a_placed_read_counts_a_gather():
    mesh = gb.parallel.mesh.Mesh(np.array([torch.device("cpu")] * 2), ("i",))
    layout = blocks.Layout(mesh, ("i",), (4,))
    b = blocks.cut(torch.arange(4.0), layout)
    blocks.reset_counts()
    assert b.gather().tolist() == [0.0, 1.0, 2.0, 3.0]
    blocks.relayout(torch.arange(4.0), layout)
    assert blocks.counts() == {"gathers": 1, "reshards": 1}
    assert telemetry.counter("parallel.gathers") == 1 and telemetry.counter("parallel.reshards") == 1


@pytest.fixture
def library(monkeypatch):
    """The library on the CPU as the benchmark's tests set it up, the SpMV
    through the plan engine's plain versions."""
    monkeypatch.delenv("GRAPHBLAS_TPU_PLAN_CACHE", raising=False)
    monkeypatch.setenv("GRAPHBLAS_TPU_PLAN_BACKGROUND", "0")
    with gb.tx.config.set(platform="cpu", dense_limit=4096, mxv_strategy="plan"):
        yield


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cpu_run_reads_the_ports_spans(cell, library):
    result, checks = run.run_cell(cell, 2**31 + 7, 0.2, True, device="cpu", config_override={"scale": SCALE})
    assert result["correct"], checks
    metrics = result["metrics"]
    dense = "collections.to_dense_ms.eager" if cell.endswith("-eager") else "collections.to_dense_ms"
    assert metrics["sparse.plan_build_s"]["value"] > 0 and metrics[dense]["value"] > 0
    assert ("sparse.col_order_s" in metrics) and (metrics["sparse.col_order_s"]["value"] > 0) == ("pagerank" in cell)
    assert ("collections.front_ms_per_stmt" in metrics) == cell.endswith("-eager")
    for name in metrics:
        assert not name.startswith(("compiler.", "ops.", "kernels.")), name
    spans = _spans()
    assert spans["sparse.plan_build"]["count"] == 1 and telemetry.counter("sparse.plan_builds") == 1
    assert spans["collections.from_coo"]["count"] == 1


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_a_trace(name):
    assert registry.metric(name).read(run.Readings({})) is None


CARD = types.SimpleNamespace(busy_s=1.0, window_s=2.0)


def _snapshot():
    def sp(count, total, self_s):
        return {"count": count, "total_s": total, "self_s": self_s}

    return {
        "spans": {
            "sparse.plan_build": sp(1, 20.0, 19.0),
            "compiler.capture": sp(2, 25.0, 3.0),
            "compiler.replay": sp(10, 0.0002, 0.0001),
            "collections.to_dense": sp(4, 0.02, 0.01),
            "collections.stmt": sp(100, 0.08, 0.05),
            "ops.sparse_mxv": sp(10, 0.01, 0.006),
            "ops.ewise_add": sp(20, 0.004, 0.004),
            "kernels.gather": sp(30, 0.0006, 0.0006),
            "kernels.segscan_contrib": sp(10, 0.0004, 0.0004),
            "kernels.build": sp(1, 20.0, 20.0),
        },
        "counters": {"host_reads": 11, "compiler.iterations": 7},
    }


READ = {
    "sparse.plan_build_s": 20.0,
    "sparse.col_order_s": 0.0,
    "compiler.capture_s": 3.0,
    "compiler.replay_host_us": 10.0,
    "compiler.host_reads_per_iter": 11 / 7,
    "collections.to_dense_ms": 5.0,
    "collections.to_dense_ms.eager": 5.0,
    "collections.front_ms_per_stmt": 0.5,
    "ops.host_ms_per_stmt": 0.1,
    "kernels.launch_host_us": 25.0,
}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_registry(name, monkeypatch):
    monkeypatch.setattr(telemetry, "snapshot", _snapshot)
    assert registry.metric(name).read(run.Readings({}, reduced=CARD)) == pytest.approx(READ[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_of_a_library_without_the_registry(name, monkeypatch):
    """The parent commit's library has no registry: every reader finds
    nothing there and raises nothing."""
    import sys

    import graphblas_tpu_torch.core as core

    monkeypatch.delattr(core, "telemetry")
    monkeypatch.setitem(sys.modules, "graphblas_tpu_torch.core.telemetry", None)
    assert registry.metric(name).read(run.Readings({}, reduced=CARD)) is None


@pytest.mark.parametrize("name", ["compiler.capture_s", "compiler.replay_host_us", "compiler.host_reads_per_iter",
                                  "ops.host_ms_per_stmt", "kernels.launch_host_us"])
def test_device_readers_read_nothing_off_the_card(name, monkeypatch):
    """On the CPU the engine's and the kernels' spans hold the computation
    itself: their readers stay out of a run in which no device worked."""
    monkeypatch.setattr(telemetry, "snapshot", _snapshot)
    assert registry.metric(name).read(run.Readings({}, reduced=types.SimpleNamespace(busy_s=0.0, window_s=1.0))) is None

