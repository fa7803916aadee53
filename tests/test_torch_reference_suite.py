"""The JAX package's own test files, run against the port.

Every ``tests/*.py`` that is not a port test is copied, with ``conftest.py``,
``oracle.py`` and ``fixtures/``, into a temporary directory, with the package
name ``graphblas_tpu`` changed to ``graphblas_tpu_torch`` (by word boundary, so
``graphblas_tpu_torch`` is never renamed twice) and the collections pinned to
the CPU in the copied conftest.  One pytest subprocess runs them with the
conftest's random axes pinned; each reference file is a case here, which
passes when the file's failed and errored tests are exactly its entries in
``EXPECTED_FAILURES``.  A new failure fails the case, and so does an expected
entry that now passes.

Alone: ``python -m pytest tests/test_torch_reference_suite.py -q`` (about half
a minute; the subprocess is one process).  It needs JAX on the machine (some
reference files import it), and skips only where JAX cannot be imported.
"""

import importlib.util
import os
import re
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
TIMEOUT_S = 600

REFERENCE_FILES = sorted(
    name
    for name in os.listdir(TESTS)
    if name.startswith("test_") and name.endswith(".py") and not name.startswith("test_torch_")
)

PINNED_AXES = {
    "GRAPHBLAS_TEST_SEED": "42",
    "GRAPHBLAS_TEST_MXM_STRATEGY": "auto",
    "GRAPHBLAS_TEST_BLOCKING": "0",
    "GRAPHBLAS_TEST_MAPNUMPY": "1",
    "GRAPHBLAS_TEST_RECORD": "0",
}


def _entries(reason, file, *tests):
    return {f"{file}::{t}" if t else file: reason for t in tests}


_JAX_DEVICES = "its mesh fixture hands jax.devices() to the port's Context, which takes torch devices"
_PALLAS = "imports the JAX package's Pallas modules, which the port has as CUDA kernels (csrc/)"
_NUMPY_FN = "calls a typed op's .fn on numpy values; the port's ops take tensors"
_CUDA_DEFAULT = "relies on the device default, which is the card in the port"
_PLAN_NAMES = "globs the reference's gbtpu_plan3_* file names; the port writes gbtorch_plan1_*"

# file -> {test id: reason}: the reference's tests the port fails by design or
# because they use JAX itself (ROADMAP section 3, F3).
EXPECTED_FAILURES = {
    "test_blocking_timing.py": _entries(
        "calls init('jax'); the port's backend is 'torch'", "test_blocking_timing.py", "test_init_mode_switch_refused"
    ),
    "test_compile.py": _entries(
        "checks that the hoisted constants are jax.Arrays (JAX-only)",
        "test_compile.py", "test_compiled_loop_consts_all_committed",
    ),
    "test_fixtures.py": _entries(
        "the pickled fixtures resolve to the reference's operators", "test_fixtures.py",
        "test_pickle_fixture_objects_and_operators",
    ),
    "test_formatting.py": _entries(
        "torch's FP64 sqrt(2) is one ulp off numpy's on this CPU; the golden repr prints it",
        "test_formatting.py", "test_golden_expr_apply",
    ),
    "test_int_channels.py": _entries(
        "hands jax arrays to the engine", "test_int_channels.py", "test_int64_plus_times_pagerank_style"
    ),
    "test_looplayout.py": _entries(
        "asserts the edge layout, a TPU lowering the port leaves out by design (ROADMAP §1)", "test_looplayout.py",
        "test_pagerank_edge_layout_matches_n_space", "test_sssp_edge_layout_bit_identical",
        "test_bfs_dense_edge_layout_bit_identical", "test_edge_layout_runner_with_new_state",
        "test_edge_layout_total_plan_indeg0_values_preserved",
    ),
    "test_matrix_full.py": _entries(
        _CUDA_DEFAULT, "test_matrix_full.py", "test_reduce_string_default_without_monoid_import"
    ),
    "test_op.py": {
        **_entries(_NUMPY_FN, "test_op.py", "test_binary_fn_semantics"),
        **_entries("writes its UDF in jnp; the port's UDFs are torch", "test_op.py", "test_register_new_binary_and_monoid"),
    },
    "test_operator_types.py": _entries(
        _NUMPY_FN, "test_operator_types.py", "test_all_binary_types_execute", "test_all_monoid_types_closed",
        "test_all_unary_types_execute", "test_indexunary_thunk_types",
    ),
    "test_pallas.py": _entries(
        _PALLAS, "test_pallas.py", "test_eqjoin_kernel_vs_numpy", "test_segmented_fill_static_vs_scan",
        "test_segmented_scan_state_fr_reduce", "test_segmented_scan_state_vs_composed",
        *(f"test_tropical_mxm_vs_oracle[{p}]" for p in ("max-min", "max-plus", "min-max", "min-plus")),
    ),
    "test_parallel.py": _entries(
        _JAX_DEVICES, "test_parallel.py",
        "test_dsl_masked_mxm_routes_through_mesh", "test_dsl_pagerank_on_mesh",
        "test_dsl_routes_through_summa_under_context", "test_dsl_sparse_mxv_inside_context",
        "test_shard_annotations_roundtrip", "test_shard_matrix_rejects_sparse", "test_sharded_apply_and_select",
        "test_sharded_bfs_and_sssp", "test_sharded_ewise_add_mult", "test_sharded_ewise_masked_accum_replace",
        "test_sharded_fastspmv_empty_partition", "test_sharded_fastspmv_masked_secondi",
        "test_sharded_fastspmv_vs_single_device", "test_sharded_masked_spgemm_min_plus_and_empty_blocks",
        "test_sharded_masked_spgemm_plus_pair_vs_single", "test_sharded_pagerank_vs_oracle",
        "test_sharded_reduce_rowwise_colwise_scalar", "test_sharded_spmv_step", "test_sharded_vector_ewise_and_reduce",
        "test_summa_masked_accum_replace_through_dsl", "test_summa_masked_complement_mask_through_dsl",
        "test_summa_mxm_min_plus_generic_monoid", "test_summa_mxm_nondivisible_shapes", "test_summa_mxm_plus_times",
        "test_summa_mxv_min_plus", "test_summa_mxv_plus_times",
    ),
    "test_permute.py": _entries(
        "imports the Euler-colouring router (native.euler_color), left out by design", "test_permute.py", ""
    ),
    "test_plan_cache.py": {
        **_entries(
            _PLAN_NAMES, "test_plan_cache.py", "test_bool_matrix_shares_pattern_plan", "test_same_pattern_shares_plan_file"
        ),
        **_entries(_CUDA_DEFAULT, "test_plan_cache.py", "test_loop_net_skipped_for_dsl_plans"),
        **_entries(
            "reads the reference's _bg_builds internals (a (thread, event) pair a build)", "test_plan_cache.py",
            "test_plan_background_build_serves_generic_then_switches",
        ),
    },
    "test_sparse.py": _entries(
        _CUDA_DEFAULT, "test_sparse.py", "test_masked_spgemm_brick_path", "test_masked_spgemm_brick_rejects_bad_semiring",
        "test_masked_spgemm_reduce_net", "test_masked_spgemm_reduce_net_with_bricks",
    ),
    "test_udt.py": _entries(
        "writes its UDF in jnp; the port's UDFs are torch", "test_udt.py", "test_udt_sparse_small_matches_dense"
    ),
    "test_vector.py": _entries(
        "hands jax arrays to Vector._set_arrays", "test_vector.py", "test_nvals_cache_invalidation"
    ),
}


def _port_copy(src, dst):
    with open(src) as f:
        text = f.read()
    with open(dst, "w") as f:
        f.write(re.sub(r"\bgraphblas_tpu\b", "graphblas_tpu_torch", text))


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """Run the renamed reference files once; {file: {test id: message}} of
    the failed and errored tests, by file."""
    if importlib.util.find_spec("jax") is None:
        pytest.skip("the reference test files need jax, which cannot be imported here")
    root = tmp_path_factory.mktemp("reference_suite")
    tests = root / "tests"
    tests.mkdir()
    for name in REFERENCE_FILES + ["conftest.py", "oracle.py"]:
        _port_copy(os.path.join(TESTS, name), tests / name)
    shutil.copytree(os.path.join(TESTS, "fixtures"), tests / "fixtures")
    with open(tests / "conftest.py", "a") as f:
        f.write(
            "\n\n# the port's collections default to the card; this run is on the CPU\n"
            "from graphblas_tpu_torch.tx import config as _port_txconfig\n\n"
            '_port_txconfig["platform"] = "cpu"\n'
        )
    (root / "pytest.ini").write_text(
        "[pytest]\ntestpaths = tests\nmarkers =\n    slow: long-running tests\n    cuda: needs an NVIDIA GPU\n"
    )
    xml = root / "report.xml"
    env = dict(os.environ, JAX_PLATFORMS="cpu", **PINNED_AXES)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    cmd = [
        sys.executable, "-m", "pytest", "-q", "-m", "not slow", "-p", "no:randomly", "-p", "no:cacheprovider",
        "-p", "no:xdist", "--continue-on-collection-errors", f"--junitxml={xml}", "tests",
    ]
    try:
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"the reference suite did not finish within its own {TIMEOUT_S} s limit")
    if not xml.exists():
        pytest.fail(f"the reference suite wrote no report (rc {proc.returncode}):\n{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    if proc.returncode not in (0, 1):  # 1: tests failed; anything else: the run did not reach its end
        pytest.fail(f"the reference suite stopped with rc {proc.returncode}:\n{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return _report_by_file(xml), proc.stdout[-2000:]


def _report_by_file(xml):
    """({file: {test id: message}} of the failed and errored tests, the files
    that reported a test)."""
    out, seen = {}, set()
    for case in ET.parse(xml).getroot().iter("testcase"):
        classname, name = case.get("classname", ""), case.get("name", "")
        seen.add((classname.split(".")[1] if classname else name.split(".")[-1]) + ".py")
        bad = [c for c in case if c.tag in ("failure", "error")]
        if not bad:
            continue
        if classname:
            parts = classname.split(".")
            module, inner = parts[1], parts[2:]
            test_id = "::".join([module + ".py"] + inner + [name])
        else:  # a collection error: the name is the module's dotted path
            module = name.split(".")[-1]
            test_id = module + ".py"
        out.setdefault(module + ".py", {})[test_id] = (bad[0].get("message") or "")[:300]
    return out, seen


@pytest.mark.parametrize("ref_file", REFERENCE_FILES)
def test_reference_file_on_the_port(reference_run, ref_file):
    (failures, seen), tail = reference_run
    assert ref_file in seen, f"{ref_file} reported no test"
    got = failures.get(ref_file, {})
    expected = EXPECTED_FAILURES.get(ref_file, {})
    new = sorted(set(got) - set(expected))
    fixed = sorted(set(expected) - set(got))
    assert not new, "new failures of the port on the reference's tests:\n" + "\n".join(
        f"  {t}: {got[t]}" for t in new
    ) + f"\n{tail}"
    assert not fixed, (
        "these expected failures now pass; remove their entries from EXPECTED_FAILURES: " + ", ".join(fixed)
    )
