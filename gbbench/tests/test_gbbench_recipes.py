"""Each cell's recipe through the library on the CPU, judged by the plain
reference as a run judges it; and with the timed path broken underneath,
the same run comes out not correct."""

import numpy as np
import pytest
import torch

from gbbench import registry, run

from .conftest import SCALE

CELLS = ["kron21.pagerank", "urand21.sssp", "kron21.pagerank-eager", "kron21.sssp"]


def _run(cell, seed=2**31 + 1):
    return run.run_cell(cell, seed, 0.2, False, device="cpu", config_override={"scale": SCALE})


@pytest.mark.parametrize("cell", CELLS)
def test_recipe_matches_reference(cell, library):
    result, checks = _run(cell)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    e2e = {m["name"] for m in registry.cell(cell)[4]}
    assert set(result["metrics"]) == e2e and e2e >= {"peak_mem_gib", "setup_s"} and len(e2e) == 4
    for value, limit in checks.values():
        assert value <= limit


def _mxv_fault(kind):
    """``core.sparse.sparse_mxv`` with its answer broken: "empty" (no entry: a
    step that changes no state), "half" (the rows of the upper half left
    out) or "one" (one produced value halved)."""
    from graphblas_tpu_torch.core import sparse

    real = sparse.sparse_mxv

    def broken(*args, **kwargs):
        yv, ys = real(*args, **kwargs)
        if kind == "empty":
            return yv, torch.zeros_like(ys)
        if kind == "half":
            ys = ys.clone()
            ys[ys.shape[0] // 2 :] = False
            return yv, ys
        # the first present, finite, non-zero value, found without a host read
        # (a compiled loop's body may not read the device)
        at = torch.argmax((ys & (yv != 0) & torch.isfinite(yv)).to(torch.int8))
        pos = torch.arange(yv.shape[0], device=yv.device)
        return torch.where(pos == at, yv * 0.5, yv), ys

    return sparse, "sparse_mxv", broken


def _loop_fault():
    """A compiled loop's step that returns its state unchanged."""
    from graphblas_tpu_torch.core import compiler

    return compiler.CompiledLoop, "_step", lambda self, leaves, structs=None: list(leaves)


FAULTS = {
    "step_unchanged": _loop_fault,
    "mxv_empty": lambda: _mxv_fault("empty"),
    "half_rows_left_out": lambda: _mxv_fault("half"),
    "one_answer_altered": lambda: _mxv_fault("one"),
}


# the eager recipe runs no compiled loop: mxv_empty is its step that changes nothing
BROKEN = [(c, f) for c in CELLS for f in sorted(FAULTS) if not (f == "step_unchanged" and c.endswith("-eager"))]


@pytest.mark.parametrize("cell,fault", BROKEN)
def test_broken_path_is_not_correct(cell, fault, library, monkeypatch):
    monkeypatch.setattr(*FAULTS[fault]())
    result, checks = _run(cell)
    assert not result["correct"], checks
    assert result["failed"] >= 1


def test_kept_sample_is_seeded():
    def picks(seed):
        kept = run.Kept(3, seed)
        for i in range(40):
            kept.offer(1.0 + (i == 17), i)
        return kept.results()

    assert picks(5) == picks(5) and 17 in picks(5) and len(picks(5)) == 4
    assert picks(5) != picks(6)


def test_p95():
    xs = [float(x) for x in range(1, 101)]
    assert run.p95(xs) == pytest.approx(np.percentile(xs, 95))
    assert run.p95([3.0]) == 3.0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_what_it_can(cell, library):
    """A traced run on the CPU: the per-layer metrics of the harness's spans
    come out; those of the device find nothing to read and are left out."""
    result, checks = run.run_cell(cell, 7, 0.2, True, device="cpu", config_override={"scale": SCALE})
    assert result["correct"], checks
    metrics = result["metrics"]
    assert metrics["collections.from_coo_s"]["value"] > 0 and metrics["sparse.first_trial_s"]["value"] > 0
    assert ("collections.host_ms_per_stmt" in metrics) == cell.endswith("-eager")
    for name in metrics:
        assert not name.startswith(("device.", "kernels", "compiler.", "ops.")), name
    assert result["device"]["window_s"] > 0 and result["device"]["busy_s"] == 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"} and len(result["breakdown"]["idle_gaps"]) <= 10
