"""The ``kron21.bc`` cell's masked products on the CPU: every product of a
trial is a masked statement, and where the plan engine runs it the product
takes its mask, and the counters hold the share of the plan's slots that
the kept rows hold."""

from types import SimpleNamespace

from gbbench import registry, run

from .conftest import SCALE

CELL = "kron21.bc"


def _run(scale=SCALE, seed=2**31 + 7, trace=False):
    return run.run_cell(CELL, seed, 0.2, trace, device="cpu", config_override={"scale": scale})


def test_products_take_their_masks(library):
    """Where the plan engine runs ("plan") every product takes its mask and
    the kept slots lie strictly between none and all of the plan's; on the
    generic path no product takes one.  On the CPU the metric is left out,
    as the product's other counters are (no kernel ran on a card); its
    reader, given a busy trace, reads the counters' share."""
    from graphblas_tpu_torch.core import telemetry

    telemetry.reset("ops.spmm")
    result, checks = _run(trace=True)
    assert result["correct"], checks
    counters = telemetry.snapshot()["counters"]
    assert "ops.spmm_kept_share" not in result["metrics"]
    share = registry.metric("ops.spmm_kept_share").read(run.Readings({}, reduced=SimpleNamespace(busy_s=1.0)))
    if library == "plan":
        assert counters["ops.spmm_masked_products"] == counters["ops.spmm_products"] > 0
        assert 0 < counters["ops.spmm_kept_slots"] < counters["ops.spmm_masked_slots"]
        assert share == 100.0 * counters["ops.spmm_kept_slots"] / counters["ops.spmm_masked_slots"]
    else:
        assert counters.get("ops.spmm_masked_products", 0) == 0 and share is None
