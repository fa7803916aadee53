"""Benchmark driver of the port: GAP-style PageRank/BFS/SSSP GTEPS, the
masked SpGEMM, the tropical matmul and the DSL-expressed algorithms.

Counterpart of the repository's ``bench.py``, with its inputs, definitions
and JSON keys: RMAT scale 19 (``GRAPHBLAS_BENCH_SCALE``), edge factor 16
(``GRAPHBLAS_BENCH_EF``), seed 5, weighted; the 4 sources of highest
out-degree; the triangle workload (2^16 vertices in cliques of 64 plus 2^17
random edges, seed 7; C(L.S) = L plus_pair L^T with bricks and the reduce
net); min_plus on 2048^2 seed-3 operands.  Every time is host wall time
ending in a host read of the result, less the dispatch floor (the median of
5 trivial launches and host reads).  Prints ONE JSON line (``metric``,
``value``, ``unit``, ``vs_baseline``, ``detail``) on stdout and its progress
and raw timings on stderr.  Any failure raises: the process then exits
non-zero and prints no JSON line.

The graph, its SpmvPlan and the DSL matrices' plans are built once into
``GRAPHBLAS_BENCH_CACHE`` (default: the temporary directory) by
``tools.build_plan`` and loaded from there by later runs; the DSL matrices
find theirs through GRAPHBLAS_TPU_PLAN_CACHE, which the bench sets for its
own run only.

    python -m graphblas_tpu_torch.bench [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 5
PR_ITERS = 50
N_TRAVERSALS = 8  # BFS and SSSP: the 4 sources twice
SPGEMM_REPS = 5
TROPICAL_LAUNCHES = 8
DSL_RUNS = 4
RECIPES = ("pr", "bfs", "sssp", "cc")
# the keys of ``detail``: the reference bench's, and the device's name
KEYS = (
    "platform", "device", "nodes", "edges", "pagerank_gteps_per_iter", "bfs_gteps", "bfs_levels", "sssp_gteps",
    "pagerank_iter_ms", "bfs_ms", "sssp_ms", "dispatch_floor_ms", "masked_spgemm_gflops", "masked_spgemm_mask_nnz",
    "tropical_mxm_tops", "dsl_pagerank_gteps_per_iter", "dsl_pagerank_iter_ms", "dsl_pagerank_mode",
    "dsl_vs_model_iter_ratio", "dsl_bfs_gteps", "dsl_bfs_mode", "dsl_bfs_dense_gteps", "dsl_bfs_dense_mode",
    "dsl_sssp_gteps", "dsl_sssp_mode", "cc_gteps", "cc_ms", "cc_iters", "cc_passes", "cc_edges_sym", "cc_mode",
)


def say(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def force(x):
    """Wait for ``x`` by reading a value of it on the host."""
    return float(x.float().sum())


def dispatch_floor(device):
    """The median of 5 timings of one trivial launch and its host read."""
    probe = torch.ones(8, device=device)
    force(probe + 1.0)
    floors = []
    for _ in range(5):
        t0 = time.perf_counter()
        force(probe + 1.0)
        floors.append(time.perf_counter() - t0)
    return sorted(floors)[2]


def measure(fn, m, floor, label):
    """Median of (walltime - dispatch floor) / m work units, after an adaptive
    warm-up: repeat until two consecutive timings agree within 8% (at most
    6), then time 3.  The raw timings go to stderr."""
    t0 = time.perf_counter()
    force(fn())  # builds, captures and the first execution
    first = time.perf_counter() - t0
    warm = []
    for _ in range(6):
        t0 = time.perf_counter()
        force(fn())
        warm.append(time.perf_counter() - t0)
        if len(warm) > 1 and abs(warm[-1] - warm[-2]) <= 0.08 * max(warm[-1], warm[-2]):
            break
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        force(fn())
        ts.append(time.perf_counter() - t0)
    say(f"{label}: first {first!r} s, warm-up {warm!r} s, runs {ts!r} s, floor {floor!r} s, units {m}")
    return max(sorted(ts)[1] - floor, 1e-9) / m


def cache_paths(cache, scale, ef):
    """The bench's files in ``cache``: names the reference bench does not use."""
    stem = f"s{scale}_e{ef}_{SEED}"
    graph = os.path.join(cache, f"gbtorch_graph_{stem}.npz")
    return {
        "plan": os.path.join(cache, f"gbtorch_plan_{stem}.npz"),
        "graph": graph,
        "dsl_graph": graph.replace(".npz", "_dsl.npz"),
        "dsl_cache": os.path.join(cache, f"gbtorch_dslplans_{stem}"),
    }


def prepared_cache(device):
    """(scale, ef, paths) of the bench's graph in GRAPHBLAS_BENCH_CACHE: the
    graph, its plan and the DSL plans are built there (``tools.build_plan``)
    unless it holds a complete set."""
    from .tools import build_plan

    scale = int(os.environ.get("GRAPHBLAS_BENCH_SCALE", "19"))
    ef = int(os.environ.get("GRAPHBLAS_BENCH_EF", "16"))
    paths = cache_paths(os.environ.get("GRAPHBLAS_BENCH_CACHE", tempfile.gettempdir()), scale, ef)
    marker = os.path.join(paths["dsl_cache"], build_plan.PLANS_MARKER)
    if not all(os.path.exists(p) for p in (paths["plan"], paths["graph"], paths["dsl_graph"], marker)):
        os.makedirs(os.path.dirname(paths["plan"]), exist_ok=True)
        t0 = time.perf_counter()
        build_plan.main([
            "--scale", str(scale), "--ef", str(ef), "--seed", str(SEED), "--out", paths["plan"],
            "--graph-out", paths["graph"], "--dsl-cache", paths["dsl_cache"], "--device", device,
        ])
        say(f"graph and plans built: {time.perf_counter() - t0!r} s")
    return scale, ef, paths


def graph_sources(graph_path):
    """(src, n, the 4 sources of highest out-degree) of the saved graph."""
    with np.load(graph_path) as g:
        src, n = g["src"], int(g["n"][0])
    return src, n, np.argsort(np.bincount(src, minlength=n))[::-1][:4].tolist()


def spgemm_gflops(device, floor, tc_log2=16):
    """masked_spgemm_gflops: 2 x the matches over the seconds per execute of
    C(L.S) = L plus_pair L^T (5 after a warm-up, one host read), and L's
    entries."""
    from . import semiring
    from .core import dtypes
    from .core.sparse import sparse_spgemm_analyze, sparse_spgemm_execute
    from .tools.profile_spgemm_roofline import bench_tc_workload

    L, U = bench_tc_workload(tc_log2)
    t0 = time.perf_counter()
    plan = sparse_spgemm_analyze(L, U, L.rows, L.cols, bricks=True, reduce_net=True, device=device)
    say(f"spgemm analysis: {time.perf_counter() - t0!r} s")
    sr = semiring.plus_pair[dtypes.FP32]
    acc, _, flops = sparse_spgemm_execute(plan, sr, dtypes.FP32, keep_on_device=True)  # warm
    flops = int(flops)  # constant across runs: read outside the timing
    force(acc)
    t0 = time.perf_counter()
    for _ in range(SPGEMM_REPS):
        acc, _, _ = sparse_spgemm_execute(plan, sr, dtypes.FP32, keep_on_device=True)
    force(acc)  # the queue is in order: the last execute's read waits for all
    dt = (time.perf_counter() - t0 - floor) / SPGEMM_REPS
    say(f"spgemm: {SPGEMM_REPS} executes {dt!r} s each after the floor, {flops} flops")
    return flops / dt / 1e9, L.nvals


def tropical_tops(device, floor, mt=2048):
    """tropical_mxm_tops: 2 mt^3 over the seconds per min_plus launch (8 a
    host read)."""
    from .ops.mxm import tropical_mxm_filled

    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.random((mt, mt), np.float32)).to(device)
    b = torch.from_numpy(rng.random((mt, mt), np.float32)).to(device)

    def run8():
        for _ in range(TROPICAL_LAUNCHES - 1):
            tropical_mxm_filled(a, b, "min", "plus")
        return tropical_mxm_filled(a, b, "min", "plus")

    return 2 * mt**3 / measure(run8, TROPICAL_LAUNCHES, floor, "tropical") / 1e12


def dsl_metrics(dsl_graph_path, e, sources, floor, device, recipes=RECIPES):
    """The DSL-expressed algorithms (``models.dsl``'s compiled recipes) on the
    matrices ``tools.build_plan`` saved, their plans loaded from the plan
    cache, under mxv_strategy "plan": the dsl_* and cc_* keys but
    dsl_vs_model_iter_ratio, for the ``recipes`` of RECIPES."""
    from . import tx
    from .core import dtypes
    from .core.matrix import Matrix
    from .core.sparse import SparseMatrixData
    from .models import dsl

    with np.load(dsl_graph_path) as dd:
        arrays = {k: dd[k] for k in dd.files}
    nn = int(arrays["n"][0])

    def mk(prefix):
        sp = SparseMatrixData(arrays[f"{prefix}_rows"], arrays[f"{prefix}_cols"], arrays[f"{prefix}_vals"], nn, nn)
        return Matrix._from_sparse(sp, dtypes.FP32, device=device)

    def runs_of(build, mat):
        # 2 sources twice: 4 runs a host read, past the dispatch floor
        runs = [build(mat, s) for s in sources[:2]] * 2

        def run():
            for r in runs[:-1]:
                r()
            return runs[-1]()._values

        return runs, run

    out = {}
    with tx.config.set(mxv_strategy="plan"):
        # PageRank, BFS and CC: duplicate edges fold into the values (plus),
        # so the DSL PageRank equals the model's multigraph PageRank
        AT = mk("pr") if {"pr", "bfs", "cc"} & set(recipes) else None
        if "pr" in recipes:
            pr_run = dsl.pagerank_runner(AT, max_iters=PR_ITERS)
            t = measure(lambda: pr_run()._values, PR_ITERS, floor, "dsl pagerank")
            out["dsl_pagerank_gteps_per_iter"] = e / t / 1e9
            out["dsl_pagerank_iter_ms"] = t * 1e3
            out["dsl_pagerank_mode"] = f"{pr_run.mode}/{pr_run.layout}"
        if "bfs" in recipes:
            runs, run = runs_of(dsl.bfs_level_runner, AT)
            t = measure(run, DSL_RUNS, floor, "dsl bfs")
            out["dsl_bfs_gteps"] = e / t / 1e9
            out["dsl_bfs_mode"] = runs[0].mode
            # the dense-frontier recipe (hoisted mode)
            runs, run = runs_of(dsl.bfs_level_dense_runner, AT)
            t = measure(run, DSL_RUNS, floor, "dsl bfs dense")
            out["dsl_bfs_dense_gteps"] = e / t / 1e9
            out["dsl_bfs_dense_mode"] = f"{runs[0].mode}/{runs[0].runner.layout}"
        if "sssp" in recipes:
            # min-folded duplicate edges: the same relaxations
            runs, run = runs_of(dsl.sssp_runner, mk("ss"))
            t = measure(run, DSL_RUNS, floor, "dsl sssp")
            out["dsl_sssp_gteps"] = e / t / 1e9
            out["dsl_sssp_mode"] = f"{runs[0].mode}/{runs[0].runner.layout}"
        if "cc" in recipes:
            # alternating pull/push min-label passes on the DIRECTED adjacency
            # (weak components = the symmetrization's); the workload size is
            # the symmetrization's edge count, the whole run timed, 4 a read
            e_sym = int(arrays["cc_rows"].shape[0])
            cc_run = dsl.connected_components_runner(AT)

            def run_cc():
                for _ in range(DSL_RUNS - 1):
                    cc_run()
                return cc_run()._values

            t = measure(run_cc, DSL_RUNS, floor, "dsl cc")
            out["cc_gteps"] = e_sym / t / 1e9
            out["cc_ms"] = t * 1e3
            out["cc_iters"] = int(cc_run.runner.last_iters)
            out["cc_passes"] = 2 * out["cc_iters"]
            out["cc_edges_sym"] = e_sym
            out["cc_mode"] = f"{cc_run.mode}/{cc_run.runner.layout}"
    return out


def run(device, *, tc_log2=16, mt=2048):
    """The bench on ``device`` ("cuda" or "cpu"): the result dict of the JSON
    line.  ``tc_log2`` and ``mt`` size the SpGEMM and tropical operands."""
    from . import tx
    from .models import fast
    from .ops.fastspmv import load_spmv_plan
    from .tools.build_plan import env_set

    torch.ones(8, device=device)  # the first device touch: fails at once without the device
    name = torch.cuda.get_device_name(torch.device(device)) if torch.device(device).type == "cuda" else "cpu"
    scale, ef, paths = prepared_cache(device)
    with tx.config.set(platform=device), env_set("GRAPHBLAS_TPU_PLAN_CACHE", paths["dsl_cache"]):
        t0 = time.perf_counter()
        plan = load_spmv_plan(paths["plan"], device=device)
        src, n, sources = graph_sources(paths["graph"])
        e = len(src)
        outdeg = torch.from_numpy(np.bincount(src, minlength=n).astype(np.int32)).to(device)
        say(f"plan and graph loaded: {time.perf_counter() - t0!r} s; n={n} e={e} sources {sources}")
        floor = dispatch_floor(device)

        def traversals(algo):
            # the 4 sources twice: 8 traversals a host read
            order = sources[:4] * 2

            def go():
                for s in order[:-1]:
                    algo(plan, s, n)
                return algo(plan, order[-1], n)

            return go

        def pagerank():
            return fast.pagerank(plan, outdeg, n, max_iters=PR_ITERS, tol=0.0)

        pr_time = measure(pagerank, PR_ITERS, floor, "pagerank")
        bfs_time = measure(traversals(fast.bfs_level), N_TRAVERSALS, floor, "bfs")
        nlevels = int(fast.bfs_level(plan, sources[0], n).max())
        spgemm_gf, spgemm_nnz = spgemm_gflops(device, floor, tc_log2)
        trop_tops = tropical_tops(device, floor, mt)
        dsl_out = dsl_metrics(paths["dsl_graph"], e, sources, floor, device)
        sssp_time = measure(traversals(fast.sssp), N_TRAVERSALS, floor, "sssp")

    pr_gteps = e / pr_time / 1e9
    detail = {
        "platform": torch.device(device).type,
        "device": name,
        "nodes": n,
        "edges": e,
        "pagerank_gteps_per_iter": pr_gteps,
        "bfs_gteps": e / bfs_time / 1e9,
        "bfs_levels": nlevels,
        "sssp_gteps": e / sssp_time / 1e9,
        "pagerank_iter_ms": pr_time * 1e3,
        "bfs_ms": bfs_time * 1e3,
        "sssp_ms": sssp_time * 1e3,
        "dispatch_floor_ms": floor * 1e3,
        "masked_spgemm_gflops": spgemm_gf,
        "masked_spgemm_mask_nnz": spgemm_nnz,
        "tropical_mxm_tops": trop_tops,
        **dsl_out,
        "dsl_vs_model_iter_ratio": dsl_out["dsl_pagerank_iter_ms"] / (pr_time * 1e3),
    }
    return {
        "metric": f"PageRank GTEPS/iter/chip (RMAT scale={scale} ef={ef}, permutation-network SpMV)",
        "value": pr_gteps,
        "unit": "GTEPS",
        "vs_baseline": pr_gteps / 1.0,  # the north star: 1 GTEPS a chip
        "detail": detail,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    result = run(args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
