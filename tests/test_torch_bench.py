"""The port's bench entry point (``graphblas_tpu_torch/bench.py``) and the
plan machinery under it (``tools/build_plan.py``, ``tools/bench_dsl.py``)
against the repository's ``bench.py`` and the JAX package's tools.

On the CPU at RMAT scale 9 (the SpGEMM workload on 2^10 vertices, the
tropical operands 64^2, through ``bench.run``'s parameters): the JSON keys
are the reference bench's; ``build_plan`` writes the reference tool's arrays
and plan files of the same patterns; every rate is finite and positive; the
counts (BFS levels, CC iterations, the symmetrization's edges, the SpGEMM
mask's entries) and the compiled recipes' modes equal the JAX package's on
the same graph; a second run builds no plan; ``bench_dsl`` runs one recipe;
a failure raises, exits non-zero and prints no JSON line.
"""

import ast
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from graphblas_tpu_torch import bench
from graphblas_tpu_torch.ops import fastspmv as pfs
from graphblas_tpu_torch.tools import bench_dsl, build_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE = 9
TC_LOG2 = 10  # the SpGEMM workload's vertices, 2^10 (the bench's: 2^16)
MT = 64  # the tropical operands (the bench's: 2048)
RATES = re.compile(r"(_gteps|_gteps_per_iter|_gflops|_tops|_ms|_ratio)$")


def reference_keys():
    """The keys of ``detail`` in the repository's bench.py: its literal
    entries and the ``out["..."]`` assignments of ``dsl_metrics``."""
    with open(os.path.join(REPO, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "detail" and isinstance(v, ast.Dict):
                    keys |= {kk.value for kk in v.keys if isinstance(kk, ast.Constant)}
        if isinstance(node, ast.FunctionDef) and node.name == "dsl_metrics":
            for sub in ast.walk(node):
                for t in getattr(sub, "targets", ()):
                    if isinstance(t, ast.Subscript) and getattr(t.value, "id", None) == "out":
                        keys.add(t.slice.value)
    return keys


@pytest.fixture(scope="module")
def ref_tool(tmp_path_factory):
    """The JAX package's build_plan at scale 9, run as the reference bench runs it."""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("ref_tool")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("GRAPHBLAS_TPU_PLAN_CACHE", None)
    subprocess.run(
        [
            sys.executable, "-m", "graphblas_tpu.tools.build_plan", "--scale", str(SCALE), "--ef", "16", "--seed", "5",
            "--out", str(d / "plan.npz"), "--graph-out", str(d / "graph.npz"), "--dsl-cache", str(d / "dsl"),
        ],
        check=True, cwd=REPO, env=env, capture_output=True,
    )
    return d


@pytest.fixture(scope="module")
def port_tool(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_tool")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("GRAPHBLAS_TPU_PLAN_CACHE", raising=False)
        build_plan.main([
            "--scale", str(SCALE), "--ef", "16", "--seed", "5", "--out", str(d / "plan.npz"),
            "--graph-out", str(d / "graph.npz"), "--dsl-cache", str(d / "dsl"), "--device", "cpu",
        ])
        assert "GRAPHBLAS_TPU_PLAN_CACHE" not in os.environ
    return d


@pytest.fixture(scope="module")
def bench_cache(tmp_path_factory):
    return tmp_path_factory.mktemp("bench_cache")


@pytest.fixture(scope="module")
def runs(bench_cache):
    """Two bench runs on the CPU against one cache, and the plans the second
    built."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GRAPHBLAS_BENCH_SCALE", str(SCALE))
        mp.setenv("GRAPHBLAS_BENCH_CACHE", str(bench_cache))
        mp.delenv("GRAPHBLAS_TPU_PLAN_CACHE", raising=False)
        first = bench.run("cpu", tc_log2=TC_LOG2, mt=MT)
        assert "GRAPHBLAS_TPU_PLAN_CACHE" not in os.environ
        builds = []
        build = pfs.build_spmv_plan

        def counting(*a, **k):
            builds.append(1)
            return build(*a, **k)

        mp.setattr(pfs, "build_spmv_plan", counting)
        second = bench.run("cpu", tc_log2=TC_LOG2, mt=MT)
    return first, second, len(builds)


def test_keys_are_the_reference_benchs(runs):
    assert set(bench.KEYS) == reference_keys() | {"device"} and len(set(bench.KEYS)) == len(bench.KEYS)
    for r in runs[:2]:
        assert set(r) == {"metric", "value", "unit", "vs_baseline", "detail"}
        assert set(r["detail"]) == set(bench.KEYS)
        assert r["detail"]["platform"] == r["detail"]["device"] == "cpu" and r["unit"] == "GTEPS"
        assert r["value"] == r["vs_baseline"] == r["detail"]["pagerank_gteps_per_iter"]


@pytest.mark.parametrize("which", ["graph", "dsl"])
def test_build_plan_writes_the_reference_tools_arrays(ref_tool, port_tool, which):
    name = {"graph": "graph.npz", "dsl": "graph_dsl.npz"}[which]
    with np.load(ref_tool / name) as r, np.load(port_tool / name) as p:
        assert sorted(r.files) == sorted(p.files)
        for k in r.files:
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)
            assert p[k].dtype.kind == r[k].dtype.kind, k


def test_build_plan_caches_the_reference_tools_patterns(ref_tool, port_tool):
    """The DSL plans of the same patterns: pull (PageRank's, which SSSP's
    shares) and push, loop-capable, under the port's name, beside its marker."""

    def digests(d, prefix):
        return sorted(f[len(prefix):] for f in os.listdir(d) if f.startswith(prefix))

    ref = digests(ref_tool / "dsl", "gbtpu_plan3_")
    assert len(ref) == 2 and all(f.startswith("loopT_") for f in ref)
    assert digests(port_tool / "dsl", "gbtorch_plan1_") == ref
    assert os.path.exists(port_tool / "dsl" / build_plan.PLANS_MARKER)
    plan = pfs.load_spmv_plan(str(port_tool / "plan.npz"), device="cpu")
    with np.load(port_tool / "graph.npz") as g:
        want = pfs.build_spmv_plan(g["src"], g["dst"], g["w"], n=int(g["n"][0]), device="cpu")
    for k, t in want.arrays().items():
        assert np.array_equal(plan.arrays()[k].numpy(), t.numpy()), k


@pytest.mark.parametrize("run", [0, 1])
def test_rates_are_finite_and_positive(runs, run):
    d = runs[run]["detail"]
    rates = {k: v for k, v in d.items() if RATES.search(k)}
    assert len(rates) == 17, sorted(rates)
    for k, v in rates.items():
        assert isinstance(v, float) and math.isfinite(v) and v > 0, (k, v)


def test_a_second_run_builds_no_plan(runs, bench_cache):
    assert runs[2] == 0
    dsl_dir = bench_cache / f"gbtorch_dslplans_s{SCALE}_e16_5"
    assert len([f for f in os.listdir(dsl_dir) if f.startswith("gbtorch_plan1_loopT_")]) == 2


def reference_tc_nnz(R, ns_log2, csize=64):
    """The reference bench's SpGEMM mask (bench.py:184-199) at 2^ns_log2 vertices."""
    rng_l = np.random.default_rng(7)
    ns = 1 << ns_log2
    base = np.arange(ns) - (np.arange(ns) % csize)
    rs_list, cs_list = [], []
    for d in range(1, csize):
        rs_list.append(np.arange(ns))
        cs_list.append(base + (np.arange(ns) + d) % csize)
    rs_ = np.concatenate(rs_list + [rng_l.integers(0, ns, ns * 2)])
    cs_ = np.concatenate(cs_list + [rng_l.integers(0, ns, ns * 2)])
    lo, hi = np.minimum(rs_, cs_), np.maximum(rs_, cs_)
    keep = lo != hi
    with R.tx.config.set(dense_limit=0):
        L = R.Matrix.from_coo(
            hi[keep], lo[keep], np.float32(1.0), R.dtypes.FP32, nrows=ns, ncols=ns, dup_op=R.binary.first
        )
    return int(L._sparse.nvals)


@pytest.fixture(scope="module")
def reference_values(ref_tool):
    """The counts and modes of the reference bench's definitions, computed by
    the JAX package's models.fast and models.dsl on its tool's files."""
    import graphblas_tpu as R
    from graphblas_tpu.core.matrix import Matrix
    from graphblas_tpu.core.sparse import SparseMatrixData
    from graphblas_tpu.models import dsl
    from graphblas_tpu.models import fast as rfast
    from graphblas_tpu.ops.fastspmv import load_spmv_plan

    with np.load(ref_tool / "graph.npz") as g:
        src, n = g["src"], int(g["n"][0])
    sources = np.argsort(np.bincount(src, minlength=n))[::-1][:4].tolist()
    plan = load_spmv_plan(str(ref_tool / "plan.npz"))
    out = {"bfs_levels": int(np.asarray(rfast.bfs_level(plan, sources[0], n)).max())}
    with np.load(ref_tool / "graph_dsl.npz") as dd:
        arrays = {k: dd[k] for k in dd.files}

    def mk(prefix):
        sp = SparseMatrixData(arrays[f"{prefix}_rows"], arrays[f"{prefix}_cols"], arrays[f"{prefix}_vals"], n, n)
        return Matrix._from_sparse(sp, R.dtypes.FP32)

    with pytest.MonkeyPatch.context() as mp, R.tx.config.set(mxv_strategy="plan"):
        mp.setenv("GRAPHBLAS_TPU_PLAN_CACHE", str(ref_tool / "dsl"))
        AT, ATw = mk("pr"), mk("ss")
        pr = dsl.pagerank_runner(AT, max_iters=bench.PR_ITERS)
        out["dsl_pagerank_mode"] = f"{pr.mode}/{pr.layout}"
        out["dsl_bfs_mode"] = dsl.bfs_level_runner(AT, sources[0]).mode
        bd = dsl.bfs_level_dense_runner(AT, sources[0])
        out["dsl_bfs_dense_mode"] = f"{bd.mode}/{bd.runner.layout}"
        ss = dsl.sssp_runner(ATw, sources[0])
        out["dsl_sssp_mode"] = f"{ss.mode}/{ss.runner.layout}"
        cc = dsl.connected_components_runner(AT)
        cc()
        out["cc_mode"] = f"{cc.mode}/{cc.runner.layout}"
        out["cc_iters"] = int(cc.runner.last_iters)
    out["cc_passes"] = 2 * out["cc_iters"]
    out["cc_edges_sym"] = int(arrays["cc_rows"].shape[0])
    out["masked_spgemm_mask_nnz"] = reference_tc_nnz(R, TC_LOG2)
    return out


@pytest.mark.parametrize(
    "key",
    [
        "bfs_levels", "cc_iters", "cc_passes", "cc_edges_sym", "masked_spgemm_mask_nnz", "dsl_pagerank_mode",
        "dsl_bfs_mode", "dsl_bfs_dense_mode", "dsl_sssp_mode", "cc_mode",
    ],
)
def test_counts_and_modes_equal_the_reference_packages(runs, reference_values, key):
    """A ``mode/layout`` key: the mode equals the reference's, and the layout
    is the port's one lowering, "n" (the reference's "edge" is a TPU
    lowering the port leaves out)."""
    want = reference_values[key]
    for r in runs[:2]:
        got = r["detail"][key]
        if isinstance(want, str) and "/" in want:
            assert got.split("/") == [want.split("/")[0], "n"], (got, want)
        else:
            assert got == want


def test_the_full_spgemm_mask_is_the_reference_benchs():
    """At the CLI's 2^16 vertices the mask holds bench.py's 2,195,327 entries."""
    from graphblas_tpu_torch.tools.profile_spgemm_roofline import bench_tc_workload

    assert bench_tc_workload(16)[0].nvals == 2195327


@pytest.mark.parametrize("recipe", bench.RECIPES)
def test_bench_dsl_runs_one_recipe(runs, bench_cache, recipe, monkeypatch, capsys):
    keys = {
        "pr": {"dsl_pagerank_gteps_per_iter", "dsl_pagerank_iter_ms", "dsl_pagerank_mode"},
        "bfs": {"dsl_bfs_gteps", "dsl_bfs_mode", "dsl_bfs_dense_gteps", "dsl_bfs_dense_mode"},
        "sssp": {"dsl_sssp_gteps", "dsl_sssp_mode"},
        "cc": {"cc_gteps", "cc_ms", "cc_iters", "cc_passes", "cc_edges_sym", "cc_mode"},
    }[recipe]
    monkeypatch.setenv("GRAPHBLAS_BENCH_SCALE", str(SCALE))
    monkeypatch.setenv("GRAPHBLAS_BENCH_CACHE", str(bench_cache))
    monkeypatch.setenv("GRAPHBLAS_BENCH_DSL_ONLY", recipe)
    out = bench_dsl.main(["--device", "cpu"])
    assert set(out) == {"scale", "edges", "floor_ms"} | keys
    assert json.loads(capsys.readouterr().out) == out
    for k in keys:
        if not RATES.search(k):  # the counts and modes
            assert out[k] == runs[0]["detail"][k], k


def test_a_failure_exits_nonzero_and_prints_no_json():
    """No CUDA device for the default --device cuda: the first device touch raises."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", GRAPHBLAS_BENCH_SCALE=str(SCALE))
    proc = subprocess.run(
        [sys.executable, "-m", "graphblas_tpu_torch.bench"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode != 0
    assert not [line for line in proc.stdout.splitlines() if line.lstrip().startswith("{")]


def test_a_failing_phase_raises_and_restores_the_plan_cache_setting(runs, bench_cache, monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("spgemm failed")

    monkeypatch.setenv("GRAPHBLAS_BENCH_SCALE", str(SCALE))
    monkeypatch.setenv("GRAPHBLAS_BENCH_CACHE", str(bench_cache))
    monkeypatch.setenv("GRAPHBLAS_TPU_PLAN_CACHE", "elsewhere")
    monkeypatch.setattr(bench, "spgemm_gflops", broken)
    with pytest.raises(RuntimeError, match="spgemm failed"):
        bench.main(["--device", "cpu"])
    assert capsys.readouterr().out == "" and os.environ["GRAPHBLAS_TPU_PLAN_CACHE"] == "elsewhere"
