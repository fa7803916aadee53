"""The ``kron21.bc`` cell on the CPU: the batch Brandes recipe through the
library against the plain float64 reference, as a run judges it; planted
faults (a dropped level, a halved path count, a source's own dependency
added) each come out not correct; and the FP32-count control fails the
``bc_err`` limit."""

import pytest
import torch

from gbbench import control_bc, generate, registry, run
from gbbench.algorithms import bc as recipe
from gbbench.reference import bc as ref

from .conftest import SCALE

CELL = "kron21.bc"


def _run(scale=SCALE, seed=2**31 + 7, trace=False):
    return run.run_cell(CELL, seed, 0.2, trace, device="cpu", config_override={"scale": scale})


@pytest.mark.parametrize("scale", [SCALE, 10])
def test_recipe_matches_reference(library, scale, monkeypatch):
    import graphblas_tpu_torch as gb

    # n x 4 states stay dense at scale 10 (n = 1024), A sparse
    with gb.tx.config.set(dense_limit=4 << scale):
        result, checks = _run(scale)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert checks["levels_off"][0] == 0 and checks["bc_err"][0] < 1e-13
    assert set(result["metrics"]) == {"trial_ms", "trial_p95_ms", "peak_mem_gib", "setup_s"}


def test_products_take_one_pass(library):
    """Each product of a trial is one k-column product, never k SpMVs, where
    the plan engine runs ("plan"); its plain version counts one call."""
    from graphblas_tpu_torch.core import telemetry

    telemetry.reset("ops.spmm", "kernels.plain.segscan_spmm", "kernels.plain.segscan_contrib_gather")
    result, checks = _run()
    assert result["correct"], checks
    counters = telemetry.snapshot()["counters"]
    products = counters["ops.spmm_products"]
    assert products > 0 and counters["ops.spmm_columns"] == 4 * products
    if library == "plan":
        assert counters["kernels.plain.segscan_spmm"] == products
        assert counters.get("kernels.plain.segscan_contrib_gather", 0) == 0


def _forward_stops_early():
    """The forward sweep stops one step early: its deepest level is not
    swept back (a dropped level)."""
    from graphblas_tpu_torch.core import compiler

    real = compiler.CompiledLoop.__call__

    def early(self, *state, **kw):
        if self._body.__name__ != "forward":
            return real(self, *state, **kw)
        real(self, *state)
        saved, self._max_iters = self._max_iters, self.last_iters - 1
        try:
            return real(self, *state)
        finally:
            self._max_iters = saved

    return compiler.CompiledLoop, "__call__", early


def _sigma_halved():
    """The path counts of the deepest level come out of the forward sweep
    halved."""
    from graphblas_tpu_torch.core import compiler

    real = compiler.CompiledLoop.__call__

    def halved(self, *state, **kw):
        out = real(self, *state, **kw)
        if self._body.__name__ != "forward":
            return out
        F, P, D, d = out
        deepest = (D._values == self.last_iters - 1) & D._struct
        P._values = torch.where(deepest, P._values * 0.5, P._values)
        return F, P, D, d

    return compiler.CompiledLoop, "__call__", halved


def _source_dependency_added():
    """The backward sweep runs one level further, down to the sources, so
    each source's own dependency lands in its score."""
    from graphblas_tpu_torch.core import compiler

    real = compiler.CompiledLoop.__call__

    def further(self, *state, n_iters=None):
        if self._body.__name__ != "backward":
            return real(self, *state, n_iters=n_iters)
        return real(self, *state, n_iters=(self._n_iters if n_iters is None else n_iters) + 1)

    return compiler.CompiledLoop, "__call__", further


FAULTS = {
    "dropped_level": _forward_stops_early,
    "sigma_halved": _sigma_halved,
    "source_dependency_added": _source_dependency_added,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(library, fault, monkeypatch):
    monkeypatch.setattr(*FAULTS[fault]())
    result, checks = _run()
    assert not result["correct"], checks
    assert result["failed"] >= 1


def test_traced_run_reads_what_it_can(library):
    """On the CPU the device's metrics and the product's counters find
    nothing to read (no kernel ran on a card) and are left out."""
    result, checks = _run(trace=True)
    assert result["correct"], checks
    metrics = result["metrics"]
    assert "spmm_roofline" not in metrics and "ops.spmm_launches_per_product" not in metrics
    assert metrics["sparse.first_trial_s"]["value"] > 0
    per_layer = {m["name"] for m in registry.cell(CELL)[3]}
    assert {"spmm_roofline", "ops.spmm_launches_per_product", "kernels_roofline"} <= per_layer


@pytest.mark.parametrize("seed", [11, 2**33 + 5])
def test_fp32_counts_fail_the_limit(seed):
    """The control: the reference with its path counts and dependencies held
    in float32, the precision below the configuration's FP64, over the
    recipe's judged batches, judged as a run judges: not correct, by
    ``bc_err`` alone."""
    got = control_bc.fp32_control(seed, torch.device("cpu"), {"scale": 10})
    limits = registry.traffic("bc")["limits"]
    assert not got["control_correct"]
    assert got["levels_off"] <= limits["levels_off"] and got["bc_err"] > limits["bc_err"]


def test_batches_are_the_seeds_keys_in_turn():
    """Each seed's batches are its keys in the order the seed draws, four
    consecutive keys a batch: another seed, other batches."""
    cfg = dict(registry.config(registry.cell(CELL)[0]["config"]), scale=10)
    keys = {}
    for seed in (11, 2**33 + 5):
        roots = generate.graph(cfg, seed, torch.device("cpu"), 64)[4]
        got = recipe.batches(roots)
        assert len(got) == 16 and [k for b in got for k in b] == list(roots)
        keys[seed] = got
    assert keys[11] != keys[2**33 + 5]


@pytest.mark.parametrize("seed", [11, 2**33 + 5])
def test_configuration_is_the_kron_instance(seed):
    """The cell's own configuration, GAP's bc kernel, draws the graph
    instance and the search keys of ``g500-kron21``: the same edges, the same
    keys in the same order, for the same seed."""
    name = registry.cell(CELL)[0]["config"]
    assert name != "g500-kron21"
    got, kron = (generate.graph(dict(registry.config(c), scale=10), seed, torch.device("cpu"), 64)
                 for c in (name, "g500-kron21"))
    assert got[3] == kron[3] and got[4] == kron[4]
    assert torch.equal(got[0], kron[0]) and torch.equal(got[1], kron[1])


def test_reference_by_hand():
    """A path 0-1-2-3 and a vertex 4 beside 1 (symmetric): from source 0,
    vertex 1 lies on the paths to 2, 3 and 4, vertex 2 on the path to 3."""
    edges = [(0, 1), (1, 2), (2, 3), (1, 4)]
    rows = torch.tensor([a for a, b in edges] + [b for a, b in edges])
    cols = torch.tensor([b for a, b in edges] + [a for a, b in edges])
    scores, depth = ref.brandes(rows, cols, 5, (0,))
    assert depth == 3 and scores.tolist() == [0.0, 3.0, 1.0, 0.0, 0.0]
    both, _ = ref.brandes(rows, cols, 5, (0, 3))
    # from 3: 2 lies on the paths to 1, 0 and 4; 1 on those to 0 and 4
    assert both.tolist() == [0.0, 5.0, 4.0, 0.0, 0.0]


def test_spmm_roofline_prices_each_launch():
    """The reader's bytes of one launch (plus/first, x not full: the stream,
    x's structure, Y's values and structure) against a kernel time of twice
    the bound: 50%."""
    from graphblas_tpu_torch.core import telemetry

    from gbbench.trace import Reduced

    metric = registry.metric("spmm_roofline")
    e_pad, n, k = 1 << 10, 1 << 6, 4
    per_launch = 6 * e_pad + n * k + n * k * (8 + 1)
    telemetry.reset("kernels.spmm.")
    for _ in range(3):
        telemetry.count("kernels.spmm.calls")
        telemetry.count("kernels.spmm.slots", e_pad)
        telemetry.count("kernels.spmm.x_struct_cells", n * k)
        telemetry.count("kernels.spmm.y_cells.8", n * k)
    assert metric.launch_bytes(telemetry.snapshot()["counters"]) == per_launch
    bw, launches = 3.35e12, 5
    seconds = 2 * launches * per_launch / bw
    trace = Reduced(1.0, 1.0, seconds, 0, [["void (anonymous namespace)::spmm_onepass<double, 0, 4>(...)", seconds]], [])
    readings = run.Readings({}, trace, 1, 1, {"segscan_spmm": launches}, {"hbm_bytes_per_s": bw})
    assert metric.read(readings) == pytest.approx(50.0)
    telemetry.reset("kernels.spmm.")
    assert metric.read(readings) is None
