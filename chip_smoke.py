#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (graphblas_tpu_torch) on one GPU.

Drives the port's paths once each, on the card, at the sizes bench.py uses.
The SpMV path: RMAT scale 19, edge factor 16, seed 5 (8.4 M edges, e_pad =
2^23) is analyzed into an SpmvPlan (and a second one without endpoint
routes), then PageRank (50 iterations), level BFS and parent BFS from the 4
sources of highest out-degree, SSSP from the first of them, SpMV and three
masked SpMVs on both plans and a parent BFS on the second.  The masked-SpGEMM
path: bench.py's triangle-count workload (2^16 vertices in cliques of 64 plus
2^17 random edges; C(L.S) = L plus_pair U), with and without bricks, and an
RMAT scale-14 lower triangle (plus_times, min_plus), all under typed
semirings.  The typed operator path: the scale-19 graph as a SparseMatrixData
through sparse_mxv under six typed semirings on the plan engine and FP64 on
the generic path, and the typed SpGEMM (plus_pair[INT64], plus_times[FP32]
with bricks, min_plus[FP32], a user semiring).  The tropical path:
min_plus on 2048^2 operands, as bench.py.  The DSL path: the collections and
the dense-masked engine through the public DSL only, at the dense-masked limit
(4096^2 cells): APSP by min-plus squaring (gb_tropical at 4096^3 a round), the
level BFS and SSSP of examples 02 and 01, and one statement of each op
family.  The sparse DSL path: the statements of examples 07 (PageRank), 02
(level BFS), 01 (SSSP) and 05 (the triangle count) on sparse-format
collections (the scale-19 graph, 2^38 cells; the triangle workload, 2^32), and
the generic models.  The compiled loops: models.dsl's PageRank, level BFS
(both frontiers), SSSP and connected components at scale 19 as CUDA graph
replays.  The dense models (triangle count, k-truss, matching, betweenness,
Louvain) at n = 16384 and the UDT collections.  Interop: the scale-19 graph
through scipy, GBTX and pickle, Matrix Market, and the tx statements on
4096^2 operands.  The mesh layer: a 2 x 4 mesh of 8 shards on the card
(sharded SpMV, PageRank, BFS and SSSP on the scale-19 graph, the DSL inside
the Context, SUMMA at 4096^2, the masked SpGEMM in 8 row blocks).  The
port's bench entry point (graphblas_tpu_torch.bench), cold and warm, and the
background plan build.  The roofline tool's run, with the compare probe.  All through the hand-written CUDA kernels, but the
dense models' products, which are torch._int_mm's int8 counts and cuBLAS
matmuls.  One line per check:

  1. device: the card's name and power limit (nvidia-smi)
  2. build: the kernels built from graphblas_tpu_torch/csrc with nvcc
  3. kernels: G (routes, fill, a network with T and row-select stages, a
     route on unaligned views, the L2 probe: a route with x of 2^20 slots), C
     (add, min, max; with flags at 1/16 and with none, the longest
     look-back), C with x's gather fused (add, min, max over x of e_pad / 16
     slots, and at e_pad 2^26 over x of 2^21, the benchmark cells' size;
     bit for bit against C on x[idx] too), S (BFS, SSSP with fr_reduce, with per-slot changed flags,
     and without flags) and the generic scan (f32 fill, add, min, max;
     int32, int16 and int8 add, a uint8 fill, f32 add on a view one slot
     into its buffer) against their plain PyTorch versions at e_pad, with
     both times and, for the routes, one PyTorch indexing call's; one NaN
     case per scan kernel (C min, S SSSP, the generic scan's f32 min: NaN at
     a flagged slot, mid-segment, at a thread's and a tile's first slot,
     compared NaN for NaN and bit for bit);
     eqjoin on every bucket of the SpGEMM workload's plan (plus_pair, device
     ms by the profiler, summed per execute against the summed bounds) and
     four semirings on its largest bucket and on the RMAT plan's (256, 256)
     one, the tropical matmul's four semirings at 2048^3 and a ragged
     (2047, 2045) x (2045, 2049) min_plus, the compare probe against
     theirs, at the roofline tool's (2^14, 128) and at 16 times it, and the
     integer matmul gb_imatmul bit for bit on wrapping values: int32 at the
     tropical's size, int64 at half of it, a ragged int32
     (1000, 1030) x (1030, 999)
  4. graph and plans: host build times, plan sizes on the device
  5. algorithms: kernel path against the plain path on the same card; SpMV,
     masked SpMV and parent BFS without endpoint routes against the same with
     them
  6. oracle: scipy in float64 (PageRank, BFS levels, Dijkstra) and numpy
     parents from the scipy levels
  6s. masked SpGEMM: kernel path against the plain path; triangle counts
     against scipy; the RMAT run against scipy float64 and a numpy oracle
  6o. typed operators: sparse_mxv under plus_times[FP32], min_plus[INT32],
     plus_times[INT8], any_pair[BOOL], min_secondi[INT64] and
     plus_times[UINT32] against spmv_masked on the same plan with the names
     _plan_channel chooses (bit for bit, FP32 plus rtol 1e-6), and
     plus_times[FP64] on the generic path against scipy float64; the typed
     SpGEMM: the triangle count under plus_pair[INT64] and plus_times[FP32]
     with bricks against scipy, RMAT-14 min_plus[FP32] against the numpy
     oracle, a user semiring (a UDF multiply, a user integer monoid: the
     plain bucket path) against numpy; the typed layer's host cost, plan
     against generic, the first call's blocking plan build
  6t. tropical matmul: kernel path against the plain path and numpy
  6d. the DSL (graphblas_tpu_torch.Matrix/Vector, masks, accumulators,
     C(mask, accum, replace) << expr) on a 4096-vertex graph (8 random
     out-edges a vertex, f32 weights in [1, 10), numpy seed 11, a zero
     diagonal): APSP by D(accum=min) << D.mxm(D, min_plus) until it stops
     changing (one gb_tropical launch at 4096^3 a round) against the same
     statements on the plain versions (bit for bit) and scipy float64
     (rtol 1e-5); example 02's level BFS (any_pair, the int8 overlap counts)
     and example 01's SSSP (min_plus mxv, the generic contraction) against
     scipy; one statement of each op family at 4096^2 (mxm plus_times[FP32],
     ewise add/mult/union, apply, select, reduce with plus, min and a user
     monoid, extract, assign, C(~M.S, accum, replace)) against the same
     statement in the port on the CPU; INT32 plus_times at 2048^2 on
     gb_imatmul (one launch, counted as the DSL path's) and under
     mxm_strategy="generic" on the generic contraction, both against numpy
     mod 2^32; FP32 min_plus on the generic contraction against gb_tropical;
     times (CUDA events) and peak memory
  6s sparse dsl. Matrix.from_coo at scale 19 (sparse without a config
     change): (a) example 07's PageRank (20 iterations, as written and with
     the teleport term at every vertex) against its plain replay (rtol 1e-5)
     and a float64 scipy recurrence (rtol 1e-4), patterns exact; (b) example
     02's level BFS and (c) example 01's SSSP from the 4 sources, equal to
     models.fast bit for bit; (d) C(L.S) << L plus_pair U on the triangle
     workload = scipy's count; launches of G, fill, C, the generic scan and
     eqjoin, no plain version; (e) the generic models (bfs_level, sssp =
     models.fast; bfs_parent = the parent oracle; pagerank = models.fast rtol
     1e-4; connected_components = scipy); host times of from_coo and the
     first vxm, ms per DSL PageRank iteration and level BFS against
     models.fast, plan against generic on three statements, the models' ms
  6c compiled loops. models.dsl's recipes (gb.loop / gb.until) at scale 19,
     built as bench.py's dsl_metrics builds them, each captured in a CUDA
     graph: graph = the same runner run eagerly on the card, a second replay
     = the first; PageRank = models.fast rtol 1e-5, levels and distances =
     models.fast bit for bit, CC = scipy; capture "graph", the modes the CPU
     tests hold to the reference, layout "n" (the port's one lowering);
     bench.py's dsl_* and cc_* keys, eager against graph ms per step,
     launches per step; the kernels torch.profiler sees in a second run of
     the main path = the launches counted
  6m dense models. On rmat(14, 16, seed=5) on the card (n = 16384, the scale
     the reference's louvain docstring names): triangle_count (int8 counts,
     torch._int_mm) = scipy's int64 count = the f32 path's; k_truss at k = 4
     and 12 = a scipy peeling fixpoint and the f32 path, edge for edge, in as
     many rounds; betweenness_centrality over 256 numpy-seeded
     sources = a float64 scipy level-synchronous Brandes (rtol 1e-4);
     louvain = the port's CPU run at scale 11, and at scale 14 its f32
     modularity = a float64 numpy one; maximal_matching on the scale-19 graph
     is a maximal matching (numpy) and = its CPU run; the UDT recipes of
     tests/test_udt.py on the card = the CPU bit for bit; each model's ms
     beside its least time (and the triangle count's and the k-truss's
     beside their f32 paths'), torch._int_mm beside the f32 block product, the
     rounds, and the phase's peak device memory
  6i interop and tx. The scale-19 graph as a scipy CSR through
     io.from_scipy_sparse (sparse on the card; to_scipy_sparse gives its
     arrays back), GBTX (compression "none") and pickle round trips (on the
     card, isequal), A.mxv(ones, plus_times) on the three bit for bit and =
     scipy float64 (the interop path: G, fill, C); tx sort, selectk and scan
     on it against numpy; Matrix Market through a temporary file at RMAT
     scale 14; the tx statements (scan, sort, selectk, compactify,
     flatten/reshape, split/concat, diag, export/import_any in every format)
     on 4096^2 card operands (numpy seed 12, 30% present, INT64 and FP32) =
     the port's CPU run; host seconds of each load, serialize, deserialize
     and pickle, card ms of the tx statements
  6p mesh. parallel.Context(devices=[cuda:0] * 8, shape=(2, 4)): the sharded
     plan of the scale-19 graph (host s, edges a shard, pad_to, MiB); sharded
     SpMV (plus_times, max_first, min_plus) and masked SpMV (plus_times,
     min_secondi) = the single-device engine on the same plan (plus rtol
     1e-5, the rest bit for bit); sharded PageRank (50 it) = models.fast rtol
     1e-5, level BFS and SSSP = models.fast bit for bit, levels = scipy;
     examples 07 and 02 on the sparse collection inside the Context = outside;
     SUMMA at 4096^2 (min_plus bit for bit, each (2048 x 1024) . (1024 x 4096)
     block one gb_tropical launch; plus_times rtol 1e-5); the masked SpGEMM on
     the triangle workload in 8 row blocks = single device = scipy; the checks
     of __graft_entry__.dryrun_multichip; card ms of the sharded against the
     single-device SpMV and PageRank iteration, the combine, SUMMA min_plus
     against one gb_tropical 4096^3 launch
  6r. the roofline tool (graphblas_tpu_torch/tools/profile_spgemm_roofline)
  7. launch counts of each path (every kernel > 0, every plain version 0;
     the typed paths launch G, C, the generic scan and eqjoin; the DSL path
     gb_tropical once an APSP round; the sparse DSL path G, fill, C, the
     generic scan and eqjoin; the compiled loops G, fill, C and the generic
     scan, counted per graph replay; the interop path G, fill and C; the
     mesh path G, fill, C, the generic scan, eqjoin and gb_tropical)
  8. times in bench.py's definitions (GTEPS, GF/s, Top/s), parent BFS in the
     level-BFS one

then one JSON line of per-kernel numbers (time, bound, launches), and last
the status line {"ok": true, "device": {...}}.  Any failure raises: the exit code is then not
0 and the status line is not printed.  Without a CUDA device it fails at once.

    python3 chip_smoke.py [--scale 19] [--ef 16] [--seed 5] [--tc-log2 16] [--spgemm-scale 14] [--mt 2048]
        [--dsl-n 4096] [--dsl-generic-n 2048] [--models-scale 14]
"""

import argparse
import cProfile
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# kernel name -> (source, TPU kernel it replaces)
KERNELS = {
    # the routes, whose composed networks hold the shuffle, transpose and row-select stages
    "gather": ("graphblas_tpu_torch/csrc/gather.cu", "graphblas_tpu/ops/permute.py:399,461,496"),
    "gather_fill": ("graphblas_tpu_torch/csrc/gather.cu", "graphblas_tpu/ops/pallas_scan.py:387"),
    "segscan_contrib": ("graphblas_tpu_torch/csrc/segscan.cu", "graphblas_tpu/ops/pallas_scan.py:418"),
    # C with x's gather fused: the SpMV's expand (place route, fill, perm route) and C
    "segscan_contrib_gather": (
        "graphblas_tpu_torch/csrc/segscan.cu", "graphblas_tpu/ops/pallas_scan.py:418,387; graphblas_tpu/ops/permute.py:399",
    ),
    "segscan_state": ("graphblas_tpu_torch/csrc/segscan.cu", "graphblas_tpu/ops/pallas_scan.py:219"),
    "segscan": ("graphblas_tpu_torch/csrc/segscan.cu", "graphblas_tpu/ops/pallas_scan.py:291"),
    "eqjoin": ("graphblas_tpu_torch/csrc/eqjoin.cu", "graphblas_tpu/ops/pallas_eqjoin.py:126"),
    "tropical_mxm": ("graphblas_tpu_torch/csrc/tropical.cu", "graphblas_tpu/ops/pallas_mxm.py:74"),
    "compare_probe": ("graphblas_tpu_torch/csrc/eqjoin.cu", "graphblas_tpu/tools/profile_spgemm_roofline.py:161"),
    # no Pallas kernel: the integer matmul the JAX package leaves to XLA
    "imatmul": ("graphblas_tpu_torch/csrc/imatmul.cu", "graphblas_tpu/ops/densemasked.py:565"),
    # no Pallas kernel: the sparse x dense (n x k) product, which the JAX package densifies
    "segscan_spmm": ("graphblas_tpu_torch/csrc/spmm.cu", "graphblas_tpu/ops/densemasked.py:703"),
    # and the list of the rows a statement's mask lets it write, which the product then streams alone
    "segscan_spmm_keep": ("graphblas_tpu_torch/csrc/spmm.cu", "graphblas_tpu/ops/densemasked.py:703"),
}
# the paths whose runs count a kernel's launches
PATH_OF = {
    "gather": ("spmv", "sparse_dsl", "compiled", "interop", "mesh", "bench"),
    "gather_fill": ("spmv", "bench"),
    "segscan_contrib": ("spmv", "mesh", "bench"),
    "segscan_contrib_gather": ("spmv", "sparse_dsl", "compiled", "interop", "mesh", "bench"),
    "segscan_state": ("spmv", "bench"),
    "segscan": ("spmv", "sparse_dsl", "compiled", "mesh", "bench"),
    "eqjoin": ("spgemm", "sparse_dsl", "mesh", "bench"),
    "tropical_mxm": ("tropical", "dsl", "mesh", "bench"),
    "compare_probe": ("roofline",),
    "imatmul": ("dsl", "mesh"),
    "segscan_spmm": ("sparse_dsl",),
    "segscan_spmm_keep": ("sparse_dsl",),
}
# the least time of a kernel's work (H100 SXM data sheet): bytes over the
# memory rate, operations over the rate of their kind
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32, an FMA counted as two
# lane instructions a second at 132 SMs and 1.98 GHz: an SM dispatches 128 a
# clock (f32 add and compare, on the 128-lane FMA pipe) and runs f32 min and
# max (FMNMX, min.NaN / max.NaN included) at 64 a clock, the rates that
# tools/probe_kernels.py's rate probe settled on an NVIDIA H100 80GB
# HBM3 at 700 W (117.5 and 62.3 a clock measured; PERF.md section 6)
F32_LANE_OPS_PER_S = 132 * 128 * 1.98e9
FMNMX_OPS_PER_S = 132 * 64 * 1.98e9
INT32_OPS_PER_S = 132 * 64 * 1.98e9  # int32 instructions (the eqjoin key compares, gb_imatmul's IMADs)
# integer instructions per (i, j, k) of gb_imatmul: one IMAD for int32; for
# int64 the low product and sum (IMAD.WIDE.U32) and two cross products
IMATMUL_OPS = {"int32": 1, "int64": 3}


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def require(ok, msg):
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(torch, fn, reps):
    """Mean milliseconds of one call, by CUDA events over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(torch, fn, reps=3):
    """Median host seconds of ``fn`` between two synchronisations."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def abs_err(a, b):
    """Largest |a - b|, with equal values (infinities included) and NaN
    against NaN as 0."""
    d = (a.double() - b.double()).abs()
    return float(d.masked_fill((a == b) | (a.isnan() & b.isnan()), 0).max())


def same_bits(torch, a, b):
    """NaN where the other has NaN; every other value bit for bit (so -0.0
    is not +0.0)."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def tropical_ops_per_s(mul):
    """The instruction rate that bounds a semiring: an f32 add and an FMNMX
    per (i, j, k) dispatch at 128 lanes a clock in pairs (64 pairs); two FMNMX
    per (i, j, k) run at the FMNMX rate (32 pairs)."""
    return F32_LANE_OPS_PER_S if mul == "plus" else FMNMX_OPS_PER_S


def nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of the memory and the arithmetic time."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


def synthetic_network(np, e_pad, seed):
    """S -> T -> RSEL -> S with random tables over e_pad = m * 128^L * 128
    slots (at 2^23: m = 4, L = 2, T of level 1): the stages that
    _pallas_shuffle_then_t and _pallas_rsel run on the TPU.  The row select
    draws each (row, lane) of its m groups from a permutation of them."""
    rng = np.random.default_rng(seed)
    rows = e_pad // 128
    L = 0
    while 128 ** (L + 1) < rows:
        L += 1
    m = rows // 128**L

    def lanes():
        return np.argsort(rng.random((rows, 128)), axis=1).astype(np.int32)

    stages = [("S", lanes())]
    if L >= 1:
        stages.append(("T", L - 1))
    if m > 1:
        stages.append(("RSEL", np.argsort(rng.random((m, rows // m, 128)), axis=0).astype(np.int32), m))
    return stages + [("S", lanes())]


def check_kernels(torch, e_pad, dev, tc_plan, rm_plan, mt, dsl_n, roofline):
    """Phase 3: each kernel against its plain version on the card."""
    import numpy as np

    from graphblas_tpu_torch.core import telemetry
    from graphblas_tpu_torch.kernels import _build
    from graphblas_tpu_torch.kernels import eqjoin as ke
    from graphblas_tpu_torch.kernels import gather as kg
    from graphblas_tpu_torch.kernels import imatmul as ki
    from graphblas_tpu_torch.kernels import segscan as ks
    from graphblas_tpu_torch.kernels import tropical as kt
    from graphblas_tpu_torch.ops.permute import apply_network_plain, compose_reference_network
    from graphblas_tpu_torch.ops.scan import STATE_BIG, build_fill_tables

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    x = rand(e_pad)
    w = rand(e_pad) * 9 + 1
    valid = rand(e_pad) < 0.9
    flags = rand(e_pad) < 1 / 16  # mean segment 16 slots, as the mean in-degree
    is_last = torch.cat([flags[1:], torch.ones(1, dtype=torch.bool, device=dev)])
    perm = torch.randperm(e_pad, generator=gen, device=dev).to(torch.int32)
    fill_src = torch.from_numpy(build_fill_tables(flags.cpu().numpy())).to(dev)
    aux = (torch.randint(1, 30, (e_pad,), generator=gen, device=dev) * torch.where(rand(e_pad) < 0.8, 1, -1)).float()
    c = torch.tensor(0.37, device=dev)
    results = {}

    def record(
        name, label, kern, plain, inputs, ops_per_slot, rtol=None, library=None, reps=20, n_ops=None,
        ops_per_s=F32_OPS_PER_S, nan=False,
    ):
        """Check the kernel against its plain version and time both (and the
        PyTorch call ``library``); the bound counts ``inputs`` read once,
        the outputs written once and ``ops_per_slot`` float32 operations per
        output slot (or ``n_ops`` operations at ``ops_per_s``).  ``nan``:
        the outputs hold NaN, compared NaN for NaN and bit for bit."""
        got, want = kern(), plain()
        torch.cuda.synchronize()
        outs = got if isinstance(got, tuple) else (got,)
        pairs = list(zip(outs, want if isinstance(want, tuple) else (want,)))
        err = 0.0
        for g, p in pairs:
            if nan:
                require(same_bits(torch, g, p), f"{name} {label}: kernel differs from its plain version")
            elif rtol is None:
                require(torch.equal(g, p), f"{name} {label}: kernel differs from its plain version")
            else:
                torch.testing.assert_close(g, p, rtol=rtol, atol=0)
            err = max(err, abs_err(g, p))
        ms = cuda_ms(torch, kern, reps)
        plain_ms = cuda_ms(torch, plain, 3)
        library_ms = cuda_ms(torch, library, reps) if library is not None else None
        ops = outs[0].numel() * ops_per_slot if n_ops is None else n_ops
        bound_ms, bound_by = bound(nbytes(inputs) + nbytes(outs), ops, ops_per_s)
        tol = "bit-exact" if rtol is None else f"rtol {rtol}"
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        say(
            "3 kernels",
            f"{name} {label}: {tol}, max_abs_err={err!r}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib}, bound {bound_ms:.4f} ms ({bound_by})",
        )
        prev = results.get(name)
        if prev is None:  # the first variant listed is the one reported in the JSON line
            results[name] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms,
            }
        else:
            prev["max_abs_err"] = max(prev["max_abs_err"], err)

    record(
        "gather", "route (none)", lambda: kg.gather(x, perm), lambda: kg.gather_plain(x, perm), (x, perm), 0,
        library=lambda: x[perm],
    )
    record(
        "gather", "route + pagerank epilogue",
        lambda: kg.gather(x, perm, "pagerank", aux, c), lambda: kg.gather_plain(x, perm, "pagerank", aux, c),
        (x, perm, aux, c), 1,
    )
    record(
        "gather_fill", "fill", lambda: kg.gather(x, fill_src, "fill"), lambda: kg.gather_plain(x, fill_src, "fill"),
        (x, fill_src), 0,
    )
    # a permutation network with T and row-select stages, composed into one index
    t0 = time.perf_counter()
    stages = synthetic_network(np, e_pad, 4321)
    net_idx = torch.from_numpy(compose_reference_network(stages, e_pad)).to(dev)
    stages_dev = [(s[0], torch.from_numpy(s[1]).to(dev, torch.int64), *s[2:]) if s[0] != "T" else s for s in stages]
    kinds = "-".join({"T": f"T{s[-1]}", "RSEL": f"RSEL{s[-1]}"}.get(s[0], s[0]) for s in stages)
    say("3 kernels", f"network {kinds} composed into one index on the host in {time.perf_counter() - t0:.2f} s")
    record(
        "gather", f"network {kinds}", lambda: kg.gather(x, net_idx), lambda: apply_network_plain(x, stages_dev),
        (x, net_idx), 0, library=lambda: x[net_idx],
    )
    # G on unaligned views (x one slot, the index three slots into their
    # buffers), in the same launch as aligned ones
    x_buf = torch.empty(e_pad + 1, device=dev)
    x_buf[1:] = x
    perm_buf = torch.empty(e_pad + 3, dtype=torch.int32, device=dev)
    perm_buf[3:] = perm
    xv, pv = x_buf[1:], perm_buf[3:]
    record(
        "gather", "route on unaligned views", lambda: kg.gather(xv, pv), lambda: kg.gather_plain(xv, pv), (xv, pv), 0,
        library=lambda: xv[pv],
    )
    # the L2 probe: the same route with x of 2^20 slots (4 MB, surely resident)
    x_small = rand(1 << 20)
    idx_small = torch.randint(0, 1 << 20, (e_pad,), generator=gen, device=dev, dtype=torch.int32)
    record(
        "gather", "L2 probe: x of 2^20 slots", lambda: kg.gather(x_small, idx_small),
        lambda: kg.gather_plain(x_small, idx_small), (x_small, idx_small), 0, library=lambda: x_small[idx_small],
    )
    no_flags = torch.zeros(e_pad, dtype=torch.bool, device=dev)
    for fl, flabel in ((flags, ""), (no_flags, ", no flags (the longest look-back)")):
        for op, mul in (("add", "times"), ("min", "plus"), ("max", "first")):
            record(
                "segscan_contrib", f"{op}/{mul}{flabel}",
                lambda: ks.segscan_contrib(x, w, valid, fl, op, mul),
                lambda: ks.segscan_contrib_plain(x, w, valid, fl, op, mul),
                (x, w if mul != "first" else None, valid, fl), 2, rtol=1e-6 if op == "add" else None,
            )
    # C with x's gather fused: over the main path's n (e_pad / 16), then at
    # the benchmark cells' size (e_pad 2^26, n 2^21); against its plain
    # version, and bit for bit against C on x[idx] (its oracle on the card)
    for ep, nx in ((e_pad, max(e_pad >> 4, 1)), (1 << 26, 1 << 21)):
        if ep == e_pad:
            wg, vg, fg = w, valid, flags
        else:
            wg, vg, fg = rand(ep) * 9 + 1, rand(ep) < 0.9, rand(ep) < 1 / 16
        xg = rand(nx)
        idx = torch.randint(0, nx, (ep,), generator=gen, device=dev, dtype=torch.int32)
        size = f"{ep.bit_length() - 1}"
        for op, mul in (("add", "times"), ("min", "plus"), ("max", "first")):
            wv = None if mul == "first" else wg
            got = ks.segscan_contrib_gather(xg, idx, wv, vg, fg, op, mul)
            want = ks.segscan_contrib(xg[idx.long()], wv, vg, fg, op, mul)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"segscan_contrib_gather {op}/{mul} at 2^{size}: differs from C on x[idx]")
            record(
                "segscan_contrib_gather", f"{op}/{mul} at 2^{size} slots, x of 2^{nx.bit_length() - 1} (= C on x[idx] bit for bit)",
                lambda: ks.segscan_contrib_gather(xg, idx, wv, vg, fg, op, mul),
                lambda: ks.segscan_contrib_gather_plain(xg, idx, wv, vg, fg, op, mul),
                (xg, idx, wv, vg, fg), 2, rtol=1e-6 if op == "add" else None,
            )
        del xg, idx, wg, vg, fg, got, want
    # the k-column product: each instance's tile, shared memory, residency,
    # registers and spills; then at the bc cell's size, e_pad 2^26 slots in
    # segments of 32 on average, n 2^21 rows, k = 4 FP64 and FP32 columns
    # with 60%, 5% and all of x present (the bound counts x's structure, not
    # its present values, as the benchmark's spmm_roofline), every full tile
    # staged; then FP32 against four SpMVs (C with x's gather and the
    # collect over n slots) doing the same work a column at a time
    ep, nx, kc = 1 << 26, 1 << 21, 4
    fs_ = torch.zeros(ep, dtype=torch.bool, device=dev)
    fs_[torch.randperm(ep - 1, generator=gen, device=dev)[: nx - 1] + 1] = True
    fs_[0] = True
    rows_ = torch.arange(nx, dtype=torch.int32, device=dev)
    idx = torch.randint(0, nx, (ep,), generator=gen, device=dev, dtype=torch.int32)
    vs_ = rand(ep) < 0.95
    xs_ = rand(nx, kc) < 0.6
    base_ = ks.spmm_tile_base(fs_)
    for dt in (torch.float64, torch.float32):  # each instance's shape on this card
        for kp in (1, 2, 4, 8):
            geo = ks.spmm_geometry(kp, dt)
            require(geo["tile"] == ks.spmm_tile(kp, dt), f"segscan_spmm: the card's tile differs from the wrapper's: {geo}")
            say(
                "3 kernels",
                f"segscan_spmm {str(dt)[6:]} KP {kp}: tile {geo['tile']}, {geo['smem']} B dynamic shared memory, "
                f"{geo['blocks_per_sm']} blocks an SM, {geo['registers']} registers, {geo['local_bytes']} B local",
            )
    for dt, rt in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        xk = (rand(nx, kc) * 9 + 1).to(dt)
        for dens, xsd in ((0.6, xs_), (0.05, rand(nx, kc) < 0.05), (None, None)):
            present = "every x present" if dens is None else f"{int(dens * 100)}% present"
            staged = telemetry.counter("kernels.spmm.async_tiles"), telemetry.counter("kernels.spmm.tiles")
            record(
                "segscan_spmm", f"{str(dt)[6:]} plus/first, k {kc}, 2^26 slots, x of 2^21 rows, {present}",
                lambda: ks.segscan_spmm(xk, xsd, idx, None, vs_, fs_, rows_, nx, "add", "first", base_),
                lambda: ks.segscan_spmm_plain(xk, xsd, idx, None, vs_, fs_, rows_, nx, "add", "first"),
                (xsd if xsd is not None else xk, idx, vs_, fs_), 0, rtol=rt, reps=10,
            )
            share = (telemetry.counter("kernels.spmm.async_tiles") - staged[0]) / (
                telemetry.counter("kernels.spmm.tiles") - staged[1]
            )
            tiles = -(-ep // ks.spmm_tile(kc, dt))
            require(share == (tiles - (ep % ks.spmm_tile(kc, dt) != 0)) / tiles, f"segscan_spmm: staged share {share}")
    # the row-selected product at the same size, FP64, k 4, 60% of x present:
    # masks of one cell a row whose rows hold all (the whole plan streamed),
    # 17% and 0.1% of the slots, against the plain version and the unmasked
    # launch; then the mask's list (segscan_spmm_keep) against its plain version
    xm = (rand(nx, kc) * 9 + 1).to(torch.float64)
    sel_ = ks.SpmmRows.of(fs_, rows_, vs_, nx)
    tile_ = ks.spmm_tile(kc, torch.float64)
    lib_ = _build.library()
    unmasked_ms = cuda_ms(torch, lambda: ks.segscan_spmm(xm, xs_, idx, None, vs_, fs_, rows_, nx, "add", "first", base_), 10)
    for share in (1.0, 0.17, 0.001):
        keep_ = torch.zeros((nx, kc), dtype=torch.bool, device=dev)
        keep_[rand(nx) < share, 0] = True
        lists_ = ks.spmm_keep_plain(keep_, sel_, tile_)
        label = f"the mask's rows holding {lists_['kept_slots'] / ep:.2%} of the slots"
        record(
            "segscan_spmm", f"float64 plus/first, k {kc}, 2^26 slots, x of 2^21 rows, 60% present, {label}",
            lambda: ks.segscan_spmm(xm, xs_, idx, None, vs_, fs_, rows_, nx, "add", "first", base_, keep=keep_, rows=sel_),
            lambda: ks.segscan_spmm_plain(xm, xs_, idx, None, vs_, fs_, rows_, nx, "add", "first", keep=keep_),
            (xs_, idx, vs_, fs_), 0, rtol=1e-12, reps=10,
        )
        masked_ms = cuda_ms(
            torch, lambda: ks.segscan_spmm(xm, xs_, idx, None, vs_, fs_, rows_, nx, "add", "first", base_, keep=keep_, rows=sel_), 10
        )
        say("3 kernels", f"segscan_spmm masked / unmasked ({label}): {masked_ms:.4f} / {unmasked_ms:.4f} ms = {masked_ms / unmasked_ms:.3f}")
        sizes = {"kept_row": lists_["n_kept"], "kept_start": lists_["n_kept"], "kept_cum": lists_["n_kept"] + 1,
                 "masked_rows": nx, "tile_info": lists_["tile_info"].numel()}

        def keep_kernel():
            ks._launch_keep(lib_, keep_, sel_, tile_, torch.cuda.current_stream().cuda_stream)
            return tuple(sel_.scratch[name][:size] for name, size in sizes.items())

        record(
            "segscan_spmm_keep", f"2^21 segments, k {kc}, {label}", keep_kernel,
            lambda: tuple(lists_[name] for name in sizes), (keep_, rows_, sel_.row_first), 0, reps=10,
        )
    del xm, sel_, keep_, lists_
    ends_ = torch.cat([fs_[1:], torch.ones(1, dtype=torch.bool, device=dev)]).nonzero().flatten().int()
    cols_ = [xk[:, j].contiguous() for j in range(kc)]
    vcol_ = [vs_ & xs_[:, j][idx.long()] for j in range(kc)]

    def columns_():
        return [kg.gather(ks.segscan_contrib_gather(cols_[j], idx, None, vcol_[j], fs_, "add", "first"), ends_)
                for j in range(kc)]

    say("3 kernels", f"segscan_spmm A/B: {kc} x (C with x's gather + the collect), float32: {cuda_ms(torch, columns_, 10):.4f} ms")
    del fs_, rows_, idx, vs_, xs_, xsd, base_, xk, ends_, cols_, vcol_
    frontier = (rand(e_pad) < 0.05).float()
    levels = torch.where(rand(e_pad) < 0.7, -1, torch.randint(0, 4, (e_pad,), generator=gen, device=dev)).to(torch.int32)
    record(
        "segscan_state", "bfs",
        lambda: ks.segscan_state("bfs", frontier, None, valid, flags, is_last, levels, 3),
        lambda: ks.segscan_state_plain("bfs", frontier, None, valid, flags, is_last, levels, 3),
        (frontier, valid, flags, is_last, levels), 3,
    )
    big = torch.tensor(STATE_BIG, device=dev)
    xs = torch.where(rand(e_pad) < 0.3, big, rand(e_pad) * 20)
    dist = torch.where(rand(e_pad) < 0.5, big, rand(e_pad) * 25)
    only_last = torch.arange(e_pad, device=dev) == e_pad - 1  # no flag: one segment, the longest look-back
    for label, fl, il, fr in (
        ("sssp (fr_reduce)", flags, is_last, True), ("sssp (per-slot changed)", flags, is_last, False),
        ("sssp (fr_reduce), no flags", no_flags, only_last, True),
    ):
        record(
            "segscan_state", label,
            lambda: ks.segscan_state("sssp", xs, w, valid, fl, il, dist, 3, fr),
            lambda: ks.segscan_state_plain("sssp", xs, w, valid, fl, il, dist, 3, fr),
            (xs, w, valid, fl, il, dist), 3,
        )
    # the generic scan: f32 add first (the structure counts of the main path)
    for op in ("add", "fill", "min", "max"):
        record(
            "segscan", f"f32 {op}", lambda: ks.segscan(x, flags, op), lambda: ks.segscan_plain(x, flags, op),
            (x, flags), 1, rtol=1e-6 if op == "add" else None,
        )
    v32 = torch.randint(-(2**30), 2**30, (e_pad,), generator=gen, device=dev, dtype=torch.int32)
    v16 = torch.randint(-(2**15), 2**15, (e_pad,), generator=gen, device=dev, dtype=torch.int16)
    v8 = torch.randint(-128, 128, (e_pad,), generator=gen, device=dev, dtype=torch.int8)
    u8 = torch.randint(0, 256, (e_pad,), generator=gen, device=dev, dtype=torch.uint8)
    for label, v, op in (
        ("int32 add (wraps)", v32, "add"), ("int16 add (wraps)", v16, "add"), ("int8 add (wraps)", v8, "add"),
        ("uint8 fill", u8, "fill"),
    ):
        record("segscan", label, lambda: ks.segscan(v, flags, op), lambda: ks.segscan_plain(v, flags, op), (v, flags), 1)
    # f32 add on a view one slot into its buffer (off 16-byte alignment: the plain loads)
    x_buf = torch.empty(e_pad + 128, device=dev)
    x_buf[1 : e_pad + 1] = x
    xv1 = x_buf[1 : e_pad + 1]
    record(
        "segscan", "f32 add on a view one slot in", lambda: ks.segscan(xv1, flags, "add"),
        lambda: ks.segscan_plain(xv1, flags, "add"), (xv1, flags), 1, rtol=1e-6,
    )
    # NaN through each scan kernel: at a flagged slot, mid-segment, at a
    # thread's first slot and at a tile's first slot (NaN for NaN, bit for bit)
    nan_at = torch.tensor([int(flags.nonzero()[3]), 4096 + 37 * 8, 3 * 2048, 5 * 2048 + 5], device=dev)
    fl_nan = flags.clone()
    fl_nan[nan_at[1:]] = False
    x_nan = x.clone()
    x_nan[nan_at] = float("nan")
    xs_nan = xs.clone()
    xs_nan[nan_at] = float("nan")
    val_nan = valid.clone()
    val_nan[nan_at] = True
    il_nan = torch.cat([fl_nan[1:], torch.ones(1, dtype=torch.bool, device=dev)])
    record(
        "segscan_contrib", "min/plus with NaN", lambda: ks.segscan_contrib(x_nan, w, val_nan, fl_nan, "min", "plus"),
        lambda: ks.segscan_contrib_plain(x_nan, w, val_nan, fl_nan, "min", "plus"), (x_nan, w, val_nan, fl_nan), 2,
        nan=True,
    )
    record(
        "segscan_state", "sssp (per-slot changed) with NaN",
        lambda: ks.segscan_state("sssp", xs_nan, w, val_nan, fl_nan, il_nan, dist, 3),
        lambda: ks.segscan_state_plain("sssp", xs_nan, w, val_nan, fl_nan, il_nan, dist, 3),
        (xs_nan, w, val_nan, fl_nan, il_nan, dist), 3, nan=True,
    )
    record(
        "segscan", "f32 min with NaN", lambda: ks.segscan(x_nan, fl_nan, "min"),
        lambda: ks.segscan_plain(x_nan, fl_nan, "min"), (x_nan, fl_nan), 1, nan=True,
    )

    # eqjoin on every bucket of the bench SpGEMM plan (its keys, plus_pair
    # as the execute runs it): bit-exact against the plain version, device
    # ms by the profiler; the sums are eqjoin's figures for one execute
    t_eq = time.perf_counter()
    rows = roofline.bucket_table(tc_plan)
    plain_sum, err = 0.0, 0.0
    for b, r in zip(tc_plan.buckets, rows):
        ins = (b[3], None, b[5], None)
        got, want = ke.eqjoin(*ins, "plus", "pair"), ke.eqjoin_plain(*ins, "plus", "pair")
        torch.cuda.synchronize()
        for g, p in zip(got, want):
            require(torch.equal(g, p), f"eqjoin ({r['Wa']}, {r['Wb']}) bucket: kernel differs from its plain version")
            err = max(err, abs_err(g, p))
        plain_sum += cuda_ms(torch, lambda: ke.eqjoin_plain(*ins, "plus", "pair"), 2)
        say(
            "3 kernels",
            f"eqjoin plus_pair, ({r['Wa']}, {r['Wb']}) bucket, T={r['T']}, {r['lanes']} lanes a task: bit-exact, "
            f"kernel {r['ms']:.4f} ms (device), bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
        )
    eq_ms, eq_bound = sum(r["ms"] for r in rows), sum(r["bound_ms"] for r in rows)
    by_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "compares")
    results["eqjoin"] = {
        "max_abs_err": err, "ms": eq_ms, "plain_ms": plain_sum, "bound_ms": eq_bound,
        "bound_by": "operations" if by_ops >= eq_bound / 2 else "bytes", "library_ms": None,
    }
    say(
        "3 kernels",
        f"eqjoin per bench execute ({len(rows)} buckets, plus_pair): kernel {eq_ms:.4f} ms (device) against "
        f"{eq_bound:.4f} ms of bounds; plain {plain_sum:.4f} ms; {time.perf_counter() - t_eq:.1f} s",
    )
    # the four semirings on the bench plan's largest bucket and the RMAT
    # plan's widest, (256, 256) at scale 14 (their keys; the RMAT plan's own
    # values, random ones in [0.5, 1.5) on the bench plan, whose values are all 1)
    big = max(tc_plan.buckets, key=lambda b: b[0][0] * b[0][1] * b[3].shape[1])
    wide = max(rm_plan.buckets, key=lambda b: b[0][0] * b[0][1])
    for label, b, avT, bvT in (
        ("bench", big, rand(*big[3].shape) + 0.5, rand(*big[5].shape) + 0.5), ("rmat", wide, wide[4], wide[6]),
    ):
        (Wa, Wb), akT, bkT = b[0], b[3], b[5]
        T = akT.shape[1]
        shape = f"{label} ({Wa}, {Wb}) bucket, T={T}, {ke.lanes_per_task(Wa, Wb, T)} lanes a task"
        for add, mul in (("plus", "pair"), ("plus", "times"), ("min", "plus"), ("max", "first")):
            ins = (akT, avT if mul in ke.USES_AV else None, bkT, bvT if mul in ke.USES_BV else None)
            record(
                "eqjoin", f"{add}_{mul}, {shape}",
                lambda: ke.eqjoin(*ins, add, mul), lambda: ke.eqjoin_plain(*ins, add, mul), ins, 0,
                rtol=1e-5 if mul == "times" else None, n_ops=Wa * Wb * T, ops_per_s=INT32_OPS_PER_S,
            )
    # the tropical matmul at bench.py's size: one f32 multiply and one min or
    # max per (i, j, k), each semiring against its own instruction bound;
    # min_plus (bench.py's) first; then a ragged shape (the scalar loads; its
    # 2047 x 2049 output is just past a wave of 128-tiles: the 64-tile form)
    # the DSL path's APSP squaring at the dense-masked limit first: the row
    # the JSON line reports
    da = torch.where(rand(dsl_n, dsl_n) < 0.3, rand(dsl_n, dsl_n) * 9 + 1, float("inf"))
    record(
        "tropical_mxm", f"min_plus {dsl_n}^3 (the DSL path's APSP round)", lambda: kt.tropical_mxm(da, da, "min", "plus"),
        lambda: kt.tropical_mxm_plain(da, da, "min", "plus"), (da,), 0, reps=5, n_ops=2 * dsl_n**3,
        ops_per_s=tropical_ops_per_s("plus"),
    )
    del da
    ta, tb = rand(mt, mt), rand(mt, mt)
    for add, mul in kt.SEMIRINGS:
        record(
            "tropical_mxm", f"{add}_{mul} {mt}^3", lambda: kt.tropical_mxm(ta, tb, add, mul),
            lambda: kt.tropical_mxm_plain(ta, tb, add, mul), (ta, tb), 0, reps=10, n_ops=2 * mt**3,
            ops_per_s=tropical_ops_per_s(mul),
        )
    ra, rb = rand(mt - 1, mt - 3), rand(mt - 3, mt + 1)
    record(
        "tropical_mxm",
        f"min_plus ragged {tuple(ra.shape)} x {tuple(rb.shape)}, tile "
        f"{kt.tile_for(ra.shape[0], rb.shape[1], torch.cuda.get_device_properties(dev).multi_processor_count)}",
        lambda: kt.tropical_mxm(ra, rb, "min", "plus"), lambda: kt.tropical_mxm_plain(ra, rb, "min", "plus"),
        (ra, rb), 0, reps=10, n_ops=2 * ra.shape[0] * ra.shape[1] * rb.shape[1], ops_per_s=tropical_ops_per_s("plus"),
    )
    # the integer matmul (the DSL path's INT32 plus_times at mt^2) on values
    # over the whole range, so products and sums wrap; bit for bit.  No
    # PyTorch call computes it: torch.matmul raises on CUDA integer tensors
    for dt, (m, k, n) in ((torch.int32, (mt, mt, mt)), (torch.int64, (mt // 2,) * 3), (torch.int32, (1000, 1030, 999))):
        info = torch.iinfo(dt)
        ia = torch.randint(info.min, info.max, (m, k), generator=gen, device=dev, dtype=dt)
        ib = torch.randint(info.min, info.max, (k, n), generator=gen, device=dev, dtype=dt)
        kind = str(dt).split(".")[-1]
        tile = ki.tile_for(m, n, torch.cuda.get_device_properties(dev).multi_processor_count, ki.TILES[dt], ki.BLOCKS_PER_SM, ki.WAVE_COST)
        record(
            "imatmul", f"{kind} ({m}, {k}) x ({k}, {n}), tile {tile} (library: none, torch.matmul raises on CUDA integer tensors)",
            lambda: ki.imatmul(ia, ib), lambda: ki.imatmul_plain(ia, ib), (ia, ib), 0, reps=10,
            n_ops=IMATMUL_OPS[kind] * m * k * n, ops_per_s=INT32_OPS_PER_S,
        )
        del ia, ib
    # the compare probe: K compare-adds per element, 3 f32 instructions each
    pa = torch.randint(0, 100, (1 << 14, 128), generator=gen, device=dev).float()
    pb = torch.randint(0, 40, (1 << 14, 128), generator=gen, device=dev).float()
    record(
        "compare_probe", f"K={ke.PROBE_K} on (16384, 128)", lambda: ke.compare_probe(pa, pb),
        lambda: ke.compare_probe_plain(pa, pb), (pa, pb), 0, n_ops=3 * ke.PROBE_K * pa.numel(),
        ops_per_s=F32_LANE_OPS_PER_S,
    )
    # 16 times the tool's elements: does the probe reach half its bound once
    # its fixed launch and tail cost no longer dominate?
    qa = torch.randint(0, 100, (1 << 18, 128), generator=gen, device=dev).float()
    qb = torch.randint(0, 40, (1 << 18, 128), generator=gen, device=dev).float()
    record(
        "compare_probe", f"K={ke.PROBE_K} on (262144, 128), 16x", lambda: ke.compare_probe(qa, qb),
        lambda: ke.compare_probe_plain(qa, qb), (qa, qb), 0, n_ops=3 * ke.PROBE_K * qa.numel(),
        ops_per_s=F32_LANE_OPS_PER_S,
    )
    return results


def scipy_oracle(src, dst, w, n, sources, iters, damping=0.85):
    """Float64 references: PageRank by the recipe of
    graphblas_tpu/models/fast.py:_pagerank_loop, BFS levels and Dijkstra."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    a = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))  # duplicates sum
    outdeg = np.bincount(src, minlength=n)
    safe = np.where(outdeg > 0, outdeg, 1).astype(np.float64)
    dangling = outdeg == 0
    at = a.T.tocsr()
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        r = (1 - damping) / n + damping * (at @ (r / safe) + r[dangling].sum() / n)
    hops = csgraph.shortest_path(a, directed=True, unweighted=True, indices=sources)
    levels = np.where(np.isinf(hops), -1, hops).astype(np.int64)
    # parallel edges: keep the lightest (csr would sum their weights)
    key = src.astype(np.int64) * n + dst
    order = np.lexsort((w, key))
    first = np.r_[True, key[order][1:] != key[order][:-1]]
    keep = order[first]
    aw = sp.csr_matrix((w[keep].astype(np.float64), (src[keep], dst[keep])), shape=(n, n))
    dist = csgraph.dijkstra(aw, directed=True, indices=sources[0])
    return r, levels, dist


def parent_oracle(np, src, dst, n, levels, source):
    """Parents of an any_secondi BFS (any = max) from BFS levels: a reached
    v != source takes the largest u with an edge u -> v one level nearer;
    the source is its own parent, unreached vertices read -1."""
    nearer = (levels[dst] > 0) & (levels[src] == levels[dst] - 1)
    parents = np.full(n, -1, np.int64)
    np.maximum.at(parents, dst[nearer], src[nearer])
    parents[source] = source
    return parents


def wedge_oracle(np, L, mr, mc):
    """C(M) = L min_plus L^T and the match counts, by expanding for each
    mask entry (i, j) the shorter of the rows i and j of L and looking each
    k up in the other: min over k of L[i, k] + L[j, k] in float32 (rounded as
    the kernel rounds: once, and a + b = b + a), or +inf without a match."""
    n = L.ncols
    indptr = np.searchsorted(L.rows, np.arange(L.nrows + 1))
    di, dj = indptr[mr + 1] - indptr[mr], indptr[mc + 1] - indptr[mc]
    x, y = np.where(di <= dj, mr, mc), np.where(di <= dj, mc, mr)
    deg = np.minimum(di, dj)
    first = np.cumsum(deg) - deg
    e = np.repeat(np.arange(len(mr)), deg)
    pos = np.repeat(indptr[x], deg) + np.arange(len(e)) - np.repeat(first, deg)
    keys = L.rows * n + L.cols
    q = y[e] * n + L.cols[pos]
    p = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    found = keys[p] == q
    sums = np.where(found, L.vals[pos] + L.vals[p], np.float32(np.inf))
    mins = np.full(len(mr), np.inf, np.float32)
    nz = deg > 0
    if nz.any():
        mins[nz] = np.minimum.reduceat(sums, first[nz])
    return mins, np.bincount(e[found], minlength=len(mr))


def user_oracle(np, L, mr, mc):
    """C(M) = L (xor).(3a + b) L^T by numpy, in int32: for each mask entry
    (i, j), every k with L[i, k] and L[j, k] present contributes
    3 L[i, k] + L[j, k], XORed together; expands the shorter of rows i and j
    and looks each k up in the other.  Returns (values, match counts)."""
    n = L.ncols
    indptr = np.searchsorted(L.rows, np.arange(L.nrows + 1))
    di, dj = indptr[mr + 1] - indptr[mr], indptr[mc + 1] - indptr[mc]
    swap = di > dj
    x, y = np.where(swap, mc, mr), np.where(swap, mr, mc)
    deg = np.minimum(di, dj)
    first = np.cumsum(deg) - deg
    e = np.repeat(np.arange(len(mr)), deg)
    pos = np.repeat(indptr[x], deg) + np.arange(len(e)) - np.repeat(first, deg)
    keys = L.rows * n + L.cols
    q = y[e] * n + L.cols[pos]
    p = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    found = keys[p] == q
    e, pos, p, sw = e[found], pos[found], p[found], swap[e[found]]
    a = np.where(sw, L.vals[p], L.vals[pos]).astype(np.int32)
    b = np.where(sw, L.vals[pos], L.vals[p]).astype(np.int32)
    out = np.zeros(len(mr), np.int32)
    np.bitwise_xor.at(out, e, a * 3 + b)
    return out, np.bincount(e, minlength=len(mr))


def typed_phase(torch, np, dev, src, dst, w, n, xv, xs, tc_plan, tc_plan_b, tc_ref, L_rm, rm_plan):
    """Phase 6o: the typed front of the engine (graphblas_tpu_torch.core.sparse)
    under typed semirings, on the card.  Returns the typed paths' launch and
    plain-call counts."""
    from graphblas_tpu_torch import binary, kernels, monoid, semiring, tx
    from graphblas_tpu_torch.core import dtypes as D
    from graphblas_tpu_torch.core import sparse as sps
    from graphblas_tpu_torch.ops import fastspmv as fs

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    A = sps.SparseMatrixData.from_arrays(dst, src, w, n, n, dup_op="min")  # pull: y[dst] (+)= A[dst, src] (x) x[src]
    t_coo = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    xi = torch.randint(-50, 50, (n,), generator=gen, device=dev)
    cases = {  # name -> (typed semiring, x, x's type)
        "plus_times[FP32]": (semiring.plus_times[D.FP32], xv, D.FP32),
        "min_plus[INT32]": (semiring.min_plus[D.INT32], xi.to(torch.int32), D.INT32),
        "plus_times[INT8]": (semiring.plus_times[D.INT8], xi.to(torch.int8), D.INT8),
        "any_pair[BOOL]": (semiring.any_pair[D.BOOL], xi > 0, D.BOOL),
        "min_secondi[INT64]": (semiring.min_secondi[D.INT64], xi, D.INT64),
        "plus_times[UINT32]": (semiring.plus_times[D.UINT32], xi + 50, D.UINT32),
    }

    def mxv(key, strategy="plan"):
        sr, x, xt = cases[key]
        with tx.config.set(mxv_strategy=strategy):
            return sps.sparse_mxv(A, True, True, x, xs, sr, sr.return_type, x_type=xt)

    # the first call builds the pull plan, blocking (no background build)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mxv("plus_times[FP32]")
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    plan = A.plan("pull", dev)

    # user semiring at RMAT-14 size: a UDF multiply 3a + b and a user monoid
    # (xor of a UDF) over int32 values 1..7: the plain bucket path
    vals_i = (np.arange(L_rm.nvals) % 7 + 1).astype(np.int32)
    L_i = sps.SparseMatrixData(L_rm.rows, L_rm.cols, vals_i, L_rm.nrows, L_rm.ncols)
    t0 = time.perf_counter()
    plan_i = sps.sparse_spgemm_analyze(L_i, L_i.transposed(), L_i.rows, L_i.cols)
    t_plan_i = time.perf_counter() - t0
    xor = monoid.register_anonymous(binary.register_anonymous(lambda a, b: a ^ b, "xor_udf"), 0)
    user_sr = semiring.register_anonymous(xor, binary.register_anonymous(lambda a, b: a * 3 + b, "three_a_plus_b"))[D.INT32]
    spgemm = {
        "plus_pair[INT64] tc": (tc_plan_b, semiring.plus_pair[D.INT64], D.INT64),
        "plus_times[FP32] tc bricks": (tc_plan, semiring.plus_times[D.FP32], D.FP32),
        "min_plus[FP32] rmat": (rm_plan, semiring.min_plus[D.FP32], D.FP32),
        "user rmat": (plan_i, user_sr, D.INT32),
    }

    kernels.reset_counts()
    torch.cuda.synchronize()
    got = {k: mxv(k) for k in cases}
    sg = {k: sps.sparse_spgemm_execute(p, sr, dt, keep_on_device=True) for k, (p, sr, dt) in spgemm.items()}
    torch.cuda.synchronize()
    launches, plain = kernels.launch_counts(), kernels.plain_counts()

    # each typed call against spmv_masked on the same plan, with the channel,
    # names and wrap that _plan_channel and _plan_mxv choose
    direct = {
        "plus_times[FP32]": (fs.spmv_masked(plan, xv, xs, "plus", "times"), D.FP32),
        "min_plus[INT32]": (fs.spmv_masked(plan, xi.to(torch.int32), xs, "min", "plus"), D.INT32),
        "plus_times[INT8]": (fs.spmv_masked(plan, xi.to(torch.int8).to(torch.int32), xs, "plus", "times", wrap=(8, True)), D.INT32),
        "any_pair[BOOL]": (fs.spmv_masked(plan, torch.zeros(n, dtype=torch.int32, device=dev), xs, "any", "pair"), D.INT32),
        "min_secondi[INT64]": (fs.spmv_masked(plan, xi.float(), xs, "min", "secondi"), D.INT32),
        "plus_times[UINT32]": (fs.spmv_masked(plan, (xi + 50).to(torch.int32), xs, "plus", "times"), D.INT32),
    }
    notes = []
    for key, ((yv, ys), (dv, ds)) in zip(cases, ((got[k], direct[k]) for k in cases)):
        out = cases[key][0].return_type
        want = D.cast(dv[0], ds, out)
        require(yv.dtype == out.carrier and yv.shape == (n,), f"typed {key}: dtype or shape")
        require(torch.equal(ys, dv[1]), f"typed {key}: structure differs from spmv_masked")
        if key == "plus_times[FP32]":
            torch.testing.assert_close(yv, want, rtol=1e-6, atol=0)
        else:
            require(torch.equal(yv, want), f"typed {key}: values differ from spmv_masked")
        notes.append(f"{key} {int(ys.sum())} present")

    # FP64 on the generic path against scipy float64
    import scipy.sparse as scsp

    with tx.config.set(mxv_strategy="generic"):
        y64, s64 = sps.sparse_mxv(A, True, True, xv.double(), xs, semiring.plus_times[D.FP64], D.FP64)
    xs_np = xs.cpu().numpy()
    M = scsp.csr_matrix((A.vals.astype(np.float64), (A.rows, A.cols)), shape=(n, n))
    P = scsp.csr_matrix((np.ones(A.nvals), (A.rows, A.cols)), shape=(n, n))
    y_ref = M @ np.where(xs_np, xv.double().cpu().numpy(), 0.0)
    s_ref = (P @ xs_np.astype(np.float64)) > 0
    s64 = s64.cpu().numpy()
    np.testing.assert_array_equal(s64, s_ref, err_msg="typed plus_times[FP64] generic: structure")
    np.testing.assert_allclose(y64.cpu().numpy()[s_ref], y_ref[s_ref], rtol=1e-12, atol=0)

    # the typed SpGEMM: triangle counts, the numpy oracles
    tc64 = int(sg["plus_pair[INT64] tc"][0].sum())
    tcb = int(sg["plus_times[FP32] tc bricks"][0].double().sum())
    require(sg["plus_pair[INT64] tc"][0].dtype == torch.int64, "typed plus_pair[INT64]: int64 values")
    require(tc64 == tcb == tc_ref, f"typed triangle count: plus_pair[INT64] {tc64}, plus_times[FP32] {tcb}, scipy {tc_ref}")
    mins, counts = wedge_oracle(np, L_rm, L_rm.rows, L_rm.cols)
    acc, hit, fl = (t.cpu().numpy() for t in sg["min_plus[FP32] rmat"])
    np.testing.assert_array_equal(hit, counts > 0, err_msg="typed min_plus rmat: structure")
    np.testing.assert_array_equal(acc[hit], mins[hit], err_msg="typed min_plus rmat vs the numpy oracle")
    uv, ucount = user_oracle(np, L_i, L_i.rows, L_i.cols)
    acc, hit, fl = (t.cpu().numpy() for t in sg["user rmat"])
    np.testing.assert_array_equal(hit, ucount > 0, err_msg="user semiring rmat: structure")
    np.testing.assert_array_equal(acc[hit], uv[hit], err_msg="user semiring rmat vs the numpy oracle")
    require(int(fl) == 2 * int(ucount.sum()), "user semiring rmat: flops")

    # times: the typed layer's host cost, plan against generic, the range check
    t_typed = wall_s(torch, lambda: mxv("plus_times[FP32]"), reps=7)
    t_direct = wall_s(torch, lambda: fs.spmv_masked(plan, xv, xs, "plus", "times"), reps=7)
    t_generic = wall_s(torch, lambda: mxv("plus_times[FP32]", "generic"), reps=7)
    x64 = xi.to(torch.int64)
    t_range = wall_s(torch, lambda: sps._plan_channel(A, "plan", "plus", "times", np.dtype(np.int64), None, x64, D.INT64), reps=7)
    say(
        "6o typed",
        f"SparseMatrixData of the SpMV graph ({A.nvals} entries after dup min) host {t_coo:.2f} s; first typed "
        f"sparse_mxv (blocking plan build) {t_first * 1e3:.1f} ms; typed sparse_mxv = spmv_masked on the same plan "
        f"(FP32 plus rtol 1e-6, the rest bit-exact): {'; '.join(notes)}; plus_times[FP64] generic = scipy float64 "
        f"(rtol 1e-12); typed triangle count {tc64} (plus_pair[INT64]) = {tcb} (plus_times[FP32], bricks) = scipy; "
        f"min_plus[FP32] rmat = numpy oracle exactly; user semiring (UDF mul, user monoid) rmat = numpy oracle "
        f"exactly, {int(ucount.sum())} matches, its analysis {t_plan_i:.2f} s; plus_times[FP32] wall: typed "
        f"{t_typed * 1e3:.3f} ms, direct spmv_masked {t_direct * 1e3:.3f} ms (typed layer {(t_typed - t_direct) * 1e3:.3f} ms "
        f"a call), generic path {t_generic * 1e3:.3f} ms; INT64 range check {t_range * 1e3:.3f} ms; "
        f"phase {time.perf_counter() - t_phase:.1f} s",
    )
    return {
        "launches": launches, "plain": plain, "typed_ms": t_typed * 1e3, "direct_ms": t_direct * 1e3,
        "generic_ms": t_generic * 1e3, "plan_build_ms": t_first * 1e3, "range_check_ms": t_range * 1e3,
    }


def dsl_phase(torch, np, dev, n_dsl, n_gen, smi):
    """Phase 6d: the collections and the dense-masked engine through the public
    DSL only (graphblas_tpu_torch.Matrix/Vector/Scalar, masks, accumulators,
    ``C(mask, accum, replace) << expr``), on the card at the dense-masked
    limit, n_dsl^2 cells.  Returns the DSL path's launch and plain-call counts
    and its times."""
    import scipy.sparse as scsp
    from scipy.sparse import csgraph

    import graphblas_tpu_torch as gb
    from graphblas_tpu_torch import Matrix, Vector, binary, dtypes, indexunary, kernels, monoid, select, semiring, unary

    t_phase = time.perf_counter()
    require(gb.tx.config["platform"] == "cuda", "collections default to the card")
    # why integer values need gb_imatmul: torch has no int32 or int64 GEMM on CUDA
    probe = {}
    for dt in (torch.int32, torch.int64, torch.int8):
        x = torch.ones(64, 64, dtype=dt, device=dev)
        try:
            torch.matmul(x, x)
            probe[str(dt)] = "ok"
        except RuntimeError as exc:
            probe[str(dt)] = f"raises ({str(exc).splitlines()[0][:60]})"
    try:
        torch._int_mm(torch.ones(32, 32, dtype=torch.int8, device=dev), torch.ones(32, 32, dtype=torch.int8, device=dev))
        probe["_int_mm int8"] = "ok"
    except RuntimeError as exc:
        probe["_int_mm int8"] = f"raises ({str(exc).splitlines()[0][:60]})"
    say("6d dsl", f"torch.matmul on CUDA integer tensors: {probe}")
    n = n_dsl
    rng = np.random.default_rng(11)
    # the graph: 8 random out-edges a vertex, f32 weights in [1, 10), a zero diagonal
    src = np.repeat(np.arange(n), 8)
    dst = rng.integers(0, n, n * 8)
    wgt = rng.uniform(1, 10, n * 8).astype(np.float32)
    off = src != dst
    src, dst, wgt = src[off], dst[off], wgt[off]
    r = np.concatenate([src, np.arange(n)])
    c = np.concatenate([dst, np.arange(n)])
    v = np.concatenate([wgt, np.zeros(n, np.float32)])
    times, peaks = {}, {}

    def apsp():
        D = Matrix.from_coo(r, c, v, dtypes.FP32, nrows=n, ncols=n, dup_op=binary.min, name="D")
        rounds = 0
        while rounds < 12:
            prev = D.dup()
            D(accum=binary.min) << D.mxm(D, semiring.min_plus)
            rounds += 1
            if D.isequal(prev):
                break
        return D, rounds

    def bfs_sssp():
        A = Matrix.from_coo(src, dst, True, dtypes.BOOL, nrows=n, ncols=n, dup_op=binary.lor, name="A")
        levels = Vector(dtypes.INT64, n, name="levels")
        frontier = Vector(dtypes.BOOL, n, name="frontier")
        frontier[0] = True
        levels[0] = 0
        level = 0
        while frontier.nvals > 0:  # example 02
            level += 1
            frontier(~levels.S, replace=True) << A.T.mxv(frontier, semiring.any_pair)
            levels(frontier.S) << frontier.apply(lambda x: 0 * x + level).new(dtypes.INT64)
        W = Matrix.from_coo(src, dst, wgt, dtypes.FP32, nrows=n, ncols=n, dup_op=binary.min, name="W")
        dist = Vector(dtypes.FP32, n, name="dist")
        dist[0] = 0.0
        hops = 0
        for _ in range(n):  # example 01
            prev = dist.dup()
            dist(accum=binary.min) << W.T.mxv(dist, semiring.min_plus)
            hops += 1
            if dist.isequal(prev):
                break
        return levels, dist, hops

    # the op families' operands at n^2 (3. below), built on the card and on the CPU
    prng = np.random.default_rng(12)

    def coo(density):
        cells = np.flatnonzero(prng.random(n * n) < density)
        return cells // n, cells % n, prng.random(len(cells), np.float32)

    a_coo, b_coo, c_coo, m_coo = coo(0.3), coo(0.3), coo(0.2), coo(0.5)
    rows_ix = np.sort(prng.choice(n, n // 4, replace=False))
    cols_ix = prng.permutation(n)[: n // 5]
    plus_udf = monoid.register_anonymous(binary.register_anonymous(lambda x, y: x + y, "plus_udf"), 0.0)

    def operands():
        return tuple(Matrix.from_coo(*t, dtypes.FP32, nrows=n, ncols=n, name=nm) for t, nm in ((a_coo, "A"), (b_coo, "B"), (c_coo, "C"), (m_coo, "M")))

    def fresh(ops):
        """The operands with a fresh C (each statement writes into C; a dup
        shares C's tensors, and no update writes into them)."""
        A, B, C, M = ops
        return A, B, C.dup(name="C"), M

    statements = {
        "mxm plus_times[FP32]": lambda A, B, C, M: C << A.mxm(B, semiring.plus_times),
        "ewise_add": lambda A, B, C, M: C << A.ewise_add(B, binary.plus),
        "ewise_mult": lambda A, B, C, M: C << A.ewise_mult(B, binary.times),
        "ewise_union": lambda A, B, C, M: C << A.ewise_union(B, binary.minus, 0.5, 1.5),
        "apply unary": lambda A, B, C, M: C << A.apply(unary.ainv),
        "apply bound": lambda A, B, C, M: C << A.apply(binary.times, right=2.5),
        "apply indexunary": lambda A, B, C, M: C << A.apply(indexunary.rowindex, 0),
        "select tril": lambda A, B, C, M: C << A.select(select.tril),
        "select valuegt": lambda A, B, C, M: C << A.select(select.valuegt, 0.5),
        "reduce_rowwise plus": lambda A, B, C, M: A.reduce_rowwise(monoid.plus).new(),
        "reduce_columnwise min": lambda A, B, C, M: A.reduce_columnwise(monoid.min).new(),
        "reduce_scalar user": lambda A, B, C, M: A.reduce_scalar(plus_udf).new(),
        "reduce_scalar plus": lambda A, B, C, M: A.reduce_scalar(monoid.plus).new(),
        "extract": lambda A, B, C, M: A[rows_ix, cols_ix].new(),
        "assign": lambda A, B, C, M: C.__setitem__((rows_ix, cols_ix), B[rows_ix[::-1], cols_ix].new()),
        "C(~M.S, plus, replace)": lambda A, B, C, M: C(~M.S, accum=binary.plus, replace=True) << A.ewise_add(B, binary.plus),
    }
    # float plus sums up to 4096 float32 terms, in cuBLAS's or the CUDA reduction's
    # order against the CPU's: each rounds by ~sqrt(k) ulp (1.8e-6 seen), so rtol 1e-5
    float_plus = {"mxm plus_times[FP32]", "reduce_rowwise plus", "reduce_scalar plus"}

    def result(stmt, ops):
        ops = fresh(ops)
        out = stmt(*ops)
        return ops[2] if out is None or out is ops[2] else out

    # the DSL path: the APSP squaring, the level BFS and SSSP, one statement of
    # each op family; its launches are counted from here to the end of the drive
    kernels.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    D, rounds = apsp()
    torch.cuda.synchronize()
    t_apsp = time.perf_counter() - t0
    apsp_launches = kernels.launch_counts()["tropical_mxm"]
    peaks["APSP"] = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    levels, dist, hops = bfs_sssp()
    torch.cuda.synchronize()
    t_bfs = time.perf_counter() - t0
    t0 = time.perf_counter()
    gpu_ops = operands()
    gpu_results = {name: result(stmt, gpu_ops) for name, stmt in statements.items()}
    torch.cuda.synchronize()
    t_ops = time.perf_counter() - t0
    launches, plain = kernels.launch_counts(), kernels.plain_counts()

    # 1-2. against the same statements on the plain versions (the reference run
    # of gb_tropical on the card), scipy float64 and the examples' oracles
    t0 = time.perf_counter()
    with kernels.plain_versions():
        D_p, rounds_p = apsp()
    t_plain = time.perf_counter() - t0
    require(
        rounds_p == rounds and same_bits(torch, D._values, D_p._values) and torch.equal(D._struct, D_p._struct),
        "APSP: kernel path differs from the plain path",
    )
    require(apsp_launches == rounds, f"APSP: {apsp_launches} gb_tropical launches in {rounds} rounds")
    dr, dc, dv = D.to_coo()
    # parallel edges: keep the lightest (csr would sum their weights), as dup_op=binary.min does
    order = np.lexsort((wgt, src * n + dst))
    first = np.unique((src * n + dst)[order], return_index=True)[1]
    keep = order[first]
    gcsr = scsp.csr_matrix((wgt[keep].astype(np.float64), (src[keep], dst[keep])), shape=(n, n))
    t0 = time.perf_counter()
    d_ref = csgraph.shortest_path(gcsr, method="D")
    t_scipy = time.perf_counter() - t0
    reach = np.isfinite(d_ref)
    require(D.nvals == int(reach.sum()), f"APSP: {D.nvals} paths, scipy {int(reach.sum())}")
    np.testing.assert_allclose(dv.astype(np.float64), d_ref[dr.astype(np.int64), dc.astype(np.int64)], rtol=1e-5, atol=0)
    lv_ref = csgraph.shortest_path(gcsr, method="D", unweighted=True, indices=0)
    li, lvals = levels.to_coo()
    require(np.array_equal(li, np.flatnonzero(np.isfinite(lv_ref))), "BFS: reached set differs from scipy")
    require(np.array_equal(lvals, lv_ref[np.isfinite(lv_ref)].astype(np.int64)), "BFS: levels differ from scipy")
    si, sv = dist.to_coo()
    require(np.array_equal(si, np.flatnonzero(reach[0])), "SSSP: reached set differs from scipy")
    np.testing.assert_allclose(sv.astype(np.float64), d_ref[0, reach[0]], rtol=1e-5, atol=0)
    say(
        "6d dsl",
        f"APSP by min-plus squaring, {n} vertices, {len(src)} edges (+ the diagonal): {rounds} rounds "
        f"= {apsp_launches} gb_tropical launches at {n}^3, kernel path = plain path bit for bit, "
        f"{D.nvals} paths = scipy float64 Dijkstra (rtol 1e-5; scipy {t_scipy:.1f} s); host {t_apsp:.2f} s (plain "
        f"replay {t_plain:.1f} s); level BFS (example 02) = scipy ({int(lvals.max())} levels), SSSP (example 01, "
        f"{hops} rounds) = scipy rtol 1e-5, both {t_bfs:.2f} s; the op families' statements on the card {t_ops:.2f} s",
    )

    # 3. each op family's statement against the same statement in the port on the CPU
    t0 = time.perf_counter()
    with gb.tx.config.set(platform="cpu"):
        cpu_ops = operands()
        t_cpu_build = time.perf_counter() - t0
        cpu_results = {name: result(stmt, cpu_ops) for name, stmt in statements.items()}
    t_cpu = time.perf_counter() - t0
    for name, stmt in statements.items():
        got, want = gpu_results[name], cpu_results[name]
        require(got.ndim == 0 or got._struct.is_cuda, f"6d {name}: the result is not on the card")
        if got.ndim == 0:
            ok = got.isclose(want, rel_tol=1e-5) if name in float_plus else got.isequal(want)
            require(ok, f"6d {name}: card {got.value} != CPU {want.value}")
        else:
            gi, wi = got.to_coo(), want.to_coo()
            for a_, b_ in zip(gi[:-1], wi[:-1]):
                require(np.array_equal(a_, b_), f"6d {name}: structure differs from the CPU run")
            if name in float_plus:
                np.testing.assert_allclose(gi[-1], wi[-1], rtol=1e-5, atol=0, err_msg=name)
            else:
                require(np.array_equal(gi[-1], wi[-1]), f"6d {name}: values differ from the CPU run")
        if name == "mxm plus_times[FP32]":
            A_np = np.zeros((n, n)); A_np[a_coo[0], a_coo[1]] = a_coo[2]
            B_np = np.zeros((n, n)); B_np[b_coo[0], b_coo[1]] = b_coo[2]
            ref64 = A_np @ B_np
            gr, gc, gv = got.to_coo()
            np.testing.assert_allclose(gv.astype(np.float64), ref64[gr.astype(np.int64), gc.astype(np.int64)], rtol=1e-5, atol=0)
            require(got.nvals == int(np.count_nonzero((A_np != 0).astype(np.float32) @ (B_np != 0).astype(np.float32))), "mxm structure")
        ops = fresh(gpu_ops)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times[name] = cuda_ms(torch, lambda: stmt(*ops), 5)
        peaks[name] = torch.cuda.max_memory_allocated() - base

    # 4. the APSP statement and its kernel against the bound; INT32
    # plus_times at n_gen^2 on gb_imatmul (its launches counted as the DSL
    # path's) and on the generic contraction, both against numpy; FP32
    # min_plus on the generic contraction against the kernel
    Dw = D.dup()
    times["APSP round"] = cuda_ms(torch, lambda: Dw(accum=binary.min) << Dw.mxm(Dw, semiring.min_plus), 3)
    from graphblas_tpu_torch.ops import mxm as pmxm

    Df = torch.where(D._struct, D._values, float("inf"))
    times["gb_tropical"] = cuda_ms(torch, lambda: pmxm.tropical_mxm_filled(Df, Df, "min", "plus"), 5)
    bound_ms, bound_by = bound(2 * n * n * 4 + n * n * 4, 2 * n**3, tropical_ops_per_s("plus"))
    m = n_gen
    cells = np.flatnonzero(prng.random(m * m) < 0.25)
    gi_coo = (cells // m, cells % m, prng.integers(-(2**31), 2**31, len(cells)).astype(np.int32))
    Ai = Matrix.from_coo(*gi_coo, dtypes.INT32, nrows=m, ncols=m)
    int_key, gen_key = f"mxm plus_times[INT32] {m}^2 (gb_imatmul)", f"generic plus_times[INT32] {m}^2"
    kernels.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    Ci = Ai.mxm(Ai, semiring.plus_times).new()
    torch.cuda.synchronize()
    int_launches, int_plain = kernels.launch_counts(), kernels.plain_counts()
    peaks[int_key] = torch.cuda.max_memory_allocated() - base
    require(int_launches["imatmul"] == 1, f"INT32 plus_times: {int_launches['imatmul']} gb_imatmul launches, not 1")
    require(not any(int_plain.values()), f"INT32 plus_times: plain versions ran: {int_plain}")
    launches = {k: launches[k] + int_launches[k] for k in launches}
    times[int_key] = cuda_ms(torch, lambda: Ai.mxm(Ai, semiring.plus_times).new(), 5)
    with gb.tx.config.set(mxm_strategy="generic"):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        Cg = Ai.mxm(Ai, semiring.plus_times).new()
        torch.cuda.synchronize()
        peaks[gen_key] = torch.cuda.max_memory_allocated() - base
        times[gen_key] = cuda_ms(torch, lambda: Ai.mxm(Ai, semiring.plus_times).new(), 2)
    ai_np = np.zeros((m, m), np.int64)
    ai_np[gi_coo[0], gi_coo[1]] = gi_coo[2]
    t0 = time.perf_counter()
    # A @ A mod 2^32 from 16-bit halves (a = hi 2^16 + lo): lo lo + 2^16 (hi lo + lo hi),
    # three float64 matmuls whose sums stay below 2^44, so exact
    lo, hi = (ai_np & 0xFFFF).astype(np.float64), (ai_np >> 16).astype(np.float64)
    ll, hl, lh = ((x @ y).astype(np.int64) for x, y in ((lo, lo), (hi, lo), (lo, hi)))
    want_i = (ll + ((hl + lh) << 16)).astype(np.int32)
    t_np = time.perf_counter() - t0
    ov = (ai_np != 0).astype(np.float32) @ (ai_np != 0).astype(np.float32)
    for label, Cx in (("gb_imatmul", Ci), ("generic", Cg)):
        ci, cj, cv = Cx.to_coo()
        require(Cx.nvals == int(np.count_nonzero(ov)), f"INT32 plus_times ({label}): structure")
        require(
            np.array_equal(cv, want_i[ci.astype(np.int64), cj.astype(np.int64)]),
            f"INT32 plus_times ({label}) differs from numpy mod 2^32",
        )
    Af = Matrix.from_coo(a_coo[0] % m, a_coo[1] % m, a_coo[2], dtypes.FP32, nrows=m, ncols=m, dup_op=binary.min)
    kern = Af.mxm(Af, semiring.min_plus).new()
    with gb.tx.config.set(mxm_strategy="generic"):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        gen_ = Af.mxm(Af, semiring.min_plus).new()
        torch.cuda.synchronize()
        peaks[f"generic min_plus[FP32] {m}^2"] = torch.cuda.max_memory_allocated() - base
        times[f"generic min_plus[FP32] {m}^2"] = cuda_ms(torch, lambda: Af.mxm(Af, semiring.min_plus).new(), 2)
    require(kern.isequal(gen_, check_dtype=True), "min_plus: gb_tropical differs from the generic contraction")
    times[f"mxm min_plus[FP32] {m}^2 (gb_tropical)"] = cuda_ms(torch, lambda: Af.mxm(Af, semiring.min_plus).new(), 5)
    say(
        "6d dsl",
        f"{len(statements)} op-family statements at {n}^2 = the port on the CPU (float plus rtol 1e-5, the rest "
        f"exact; CPU {t_cpu:.1f} s, its operands {t_cpu_build:.1f} s); "
        f"mxm plus_times[FP32] (TF32 off) = numpy float64 rtol 1e-5; INT32 plus_times {m}^2 on gb_imatmul (1 "
        f"launch, no plain version) and on the generic contraction = numpy mod 2^32 exactly ({t_np:.1f} s): "
        f"{times[int_key]:.4f} ms, {peaks[int_key] / 2**20:.1f} MiB against {times[gen_key]:.4f} ms, "
        f"{peaks[gen_key] / 2**20:.1f} MiB; FP32 min_plus {m}^2 generic = gb_tropical bit for bit; on {smi}",
    )
    mib = {k: round(v / 2**20, 1) for k, v in peaks.items()}
    say(
        "6d dsl",
        f"ms (CUDA events, warm): {json.dumps({k: round(t, 4) for k, t in times.items()})}; APSP round's gb_tropical "
        f"{times['gb_tropical']:.4f} ms against its bound {bound_ms:.4f} ms ({bound_by}); peak MiB above the live "
        f"tensors: {json.dumps(mib)}; on {smi}; phase {time.perf_counter() - t_phase:.1f} s",
    )
    plain = {k: plain[k] + int_plain[k] for k in plain}
    return {"launches": launches, "plain": plain, "apsp_launches": apsp_launches, "rounds": rounds}


def sparse_dsl_phase(torch, np, dev, g, plan, src, dst, w, sources, L_tc, tc_ref, lv_ref, smi):
    """Phase 6s (sparse DSL): the python-graphblas statements of examples 07,
    02, 01 and 05 on sparse-format collections (2^38 cells at scale 19, past
    tx.config["dense_limit"] without any config change), through the public
    DSL only, and the generic models over the edge-wise ops.  Returns the
    sparse DSL path's launch and plain-call counts."""
    import importlib

    import scipy.sparse as scsp
    from scipy.sparse import csgraph

    import graphblas_tpu_torch as gb
    from graphblas_tpu_torch import Matrix, Vector, binary, dtypes, kernels, models, monoid, semiring, unary
    from graphblas_tpu_torch.models import fast
    from graphblas_tpu_torch.ops.scan import STATE_BIG

    t_phase = time.perf_counter()
    n = g.n
    FP32 = dtypes.FP32
    times = {}
    # the collections: A (example 07: 1.0 per edge, parallel edges merged by
    # first) and A_w (the weights, parallel edges by the lightest)
    t0 = time.perf_counter()
    A = Matrix.from_coo(src, dst, 1.0, FP32, nrows=n, ncols=n, dup_op=binary.first, name="A")
    times["from_coo s"] = time.perf_counter() - t0
    A_w = Matrix.from_coo(src, dst, w, FP32, nrows=n, ncols=n, dup_op=binary.min, name="A_w")
    require(A._sparse is not None and A_w._sparse is not None and A._device == dev, "A and A_w: sparse, on the card")
    tc_n = L_tc.nrows
    L = Matrix.from_coo(L_tc.rows, L_tc.cols, 1.0, FP32, nrows=tc_n, ncols=tc_n, name="L")
    U = L.T.new(name="U")
    require(L._sparse is not None and U._sparse is not None, "L and U (2^32 cells): sparse")
    damping, pr_iters = 0.85, 20

    def pagerank_dsl(first_call=None, complete=False):
        # example 07's statements, the ranks kept in FP32 (``new(FP32)``: a
        # Python float bound by apply gives FP64, which would send every vxm
        # after the first to the generic path); ``complete``: the new rank
        # starts from the teleport term at every vertex and accumulates the
        # pulled mass (the example's apply ranks only where pulled has an entry)
        outdeg = A.reduce_rowwise(binary.plus).new(FP32, name="outdeg")
        inv_deg = outdeg.apply(unary.minv).new(name="inv_deg")
        rank = Vector.from_dense(np.full(n, 1.0 / n, np.float32), name="rank")
        teleport = (1.0 - damping) / n
        for i in range(pr_iters):
            contrib = rank.ewise_mult(inv_deg, binary.times).new(name="contrib")
            t0 = time.perf_counter()
            pulled = contrib.vxm(A, semiring.plus_first).new(name="pulled")
            if first_call is not None and i == 0:
                torch.cuda.synchronize()
                first_call.append(time.perf_counter() - t0)
            dangling = float(rank.reduce(binary.plus).new().value) - float(
                contrib.ewise_mult(outdeg, binary.times).reduce(binary.plus).new().value
            )
            if complete:
                rank = Vector.from_scalar(teleport + damping * dangling / n, n, FP32, name="rank")
                rank(accum=binary.plus) << pulled.apply(binary.times, right=damping)
            else:
                rank = pulled.apply(binary.times, right=damping).apply(
                    binary.plus, right=teleport + damping * dangling / n
                ).new(FP32, name="rank")
        return rank

    def bfs_dsl(s):
        # example 02's statements
        levels = Vector(dtypes.INT64, n, name="levels")
        frontier = Vector(dtypes.BOOL, n, name="frontier")
        frontier[s] = True
        levels[s] = 0
        level = 0
        while frontier.nvals > 0:
            level += 1
            frontier(~levels.S, replace=True) << A.T.mxv(frontier, semiring.any_pair)
            levels(frontier.S) << frontier.apply(lambda x: 0 * x + level).new(dtypes.INT64)
        return levels

    def sssp_dsl(s):
        # example 01's statements
        dist = Vector(FP32, n, name="dist")
        dist[s] = 0.0
        for _ in range(n):
            prev = dist.dup()
            dist(accum=binary.min) << A_w.T.mxv(dist, semiring.min_plus)
            if dist.isequal(prev):
                break
        return dist

    def triangles_dsl():
        # example 05's statement: C(L.S) << L plus_pair U, then the count
        C = Matrix(FP32, tc_n, tc_n, name="C")
        C(L.S) << L.mxm(U, semiring.plus_pair)
        return C, int(C.reduce_scalar(monoid.plus[dtypes.INT64]).new().value)

    # the benchmark's bc recipe, eagerly: batch Brandes from the 4 sources
    # over the symmetrised pattern, the products A.mxm(F) of n x 4 FP64
    sym = Matrix.from_coo(
        np.concatenate([src, dst]), np.concatenate([dst, src]), 1.0, FP32, nrows=n, ncols=n, dup_op=binary.first,
        name="sym",
    )

    def brandes_dsl(batch):
        FP64, k = dtypes.FP64, len(batch)
        cols = np.arange(k)
        F = Matrix.from_coo(batch, cols, 1.0, FP64, nrows=n, ncols=k)
        P = F.dup()
        D = Matrix.from_coo(batch, cols, 0, dtypes.INT32, nrows=n, ncols=k)
        depth = 0
        while F.nvals:
            Fn = Matrix(FP64, n, k)
            Fn(~P.S, replace=True) << sym.mxm(F, semiring.plus_second)
            P(accum=binary.plus) << Fn
            if Fn.nvals:
                depth += 1
                D(Fn.S)[:, :] = depth
            F = Fn
        B = P.apply(unary.one).new(FP64)
        for d in range(depth, 1, -1):
            W = Matrix(FP64, n, k)
            W((D == d).new().V) << B.ewise_mult(P, binary.truediv)
            Y = Matrix(FP64, n, k)
            Y((D == d - 1).new().V) << sym.mxm(W, semiring.plus_second)
            B(accum=binary.plus) << Y.ewise_mult(P, binary.times)
        return B.apply(binary.minus, right=1.0).reduce_rowwise(monoid.plus).new(FP64).to_dense(fill_value=0.0), depth

    def drive(with_triangles=True):
        first = []
        out = {"pagerank": pagerank_dsl(first), "pagerank complete": pagerank_dsl(complete=True)}
        out["bfs"] = [bfs_dsl(s) for s in sources]
        out["sssp"] = [sssp_dsl(s) for s in sources]
        out["brandes"] = brandes_dsl(sources[:4])
        if with_triangles:
            out["triangles"] = triangles_dsl()
        return out, first

    # (a)-(d) through the kernels: the launches counted from here
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, first = drive()
    torch.cuda.synchronize()
    times["drive s"] = time.perf_counter() - t0
    times["first vxm s (the blocking push-plan build)"] = first[0]
    launches, plain = kernels.launch_counts(), kernels.plain_counts()
    # the plain replay (the triangles' host analysis, ~18 s, runs once: their
    # check is scipy's count)
    t0 = time.perf_counter()
    with kernels.plain_versions():
        want, _ = drive(with_triangles=False)
    torch.cuda.synchronize()
    times["plain replay s"] = time.perf_counter() - t0

    # (a) PageRank: the plain replay (rtol 1e-5: the float adds are reordered),
    # a float64 scipy oracle of the same recurrence (rtol 1e-4), the sums
    ar, ac, _ = A.to_coo()
    ar, ac = ar.astype(np.int64), ac.astype(np.int64)
    a01 = scsp.csr_matrix((np.ones(len(ar)), (ar, ac)), shape=(n, n))
    deg = np.asarray(a01.sum(axis=1)).ravel()
    inv = 1.0 / np.where(deg > 0, deg, 1)
    at = a01.T.tocsr()
    pr_sums = {}
    for key in ("pagerank", "pagerank complete"):
        pr, pr_p = got[key], want[key]
        pi, pv = pr.to_coo()
        qi, qv = pr_p.to_coo()
        require(pr.dtype == FP32, f"DSL {key}: {pr.dtype} ranks")
        require(np.array_equal(pi, qi), f"DSL {key}: the kernel path's pattern differs from the plain path's")
        require(bool(np.isfinite(pv).all()), f"DSL {key}: non-finite ranks")
        np.testing.assert_allclose(pv, qv, rtol=1e-5, atol=0)
        # the recurrence in float64, with the example's patterns
        present, r = np.ones(n, bool), np.full(n, 1.0 / n)
        for _ in range(pr_iters):
            cp = present & (deg > 0)
            contrib = np.where(cp, r * inv, 0.0)
            dangling = r[present].sum() - (contrib * deg).sum()
            pp = (at @ cp.astype(np.float64)) > 0
            new = damping * (at @ contrib) + (1 - damping) / n + damping * dangling / n
            present = np.ones(n, bool) if key == "pagerank complete" else pp
            r = np.where(present, new, 0.0)
        require(np.array_equal(pi.astype(np.int64), np.flatnonzero(present)), f"DSL {key}: pattern != the oracle's")
        np.testing.assert_allclose(pv, r[present], rtol=1e-4, atol=0)
        pr_sums[key] = (float(pv.astype(np.float64).sum()), float(r.sum()), int(present.sum()))
    pr_sum = pr_sums["pagerank complete"][0]
    require(abs(pr_sum - 1.0) < 1e-3, f"DSL pagerank (complete): the ranks sum to {pr_sum}")
    # (b) level BFS = models.fast.bfs_level bit for bit
    for s, lv, lv_p in zip(sources, got["bfs"], want["bfs"]):
        ref = fast.bfs_level(plan, s, n).cpu().numpy()
        require(np.array_equal(lv.to_dense(-1), ref), f"DSL BFS from {s}: levels differ from models.fast")
        require(lv.isequal(lv_p), f"DSL BFS from {s}: kernel path differs from the plain path")
    # (c) SSSP = models.fast.sssp bit for bit
    for s, d, d_p in zip(sources, got["sssp"], want["sssp"]):
        ref = fast.sssp(plan, s, n).cpu().numpy()
        di, dv = d.to_coo()
        require(np.array_equal(di.astype(np.int64), np.flatnonzero(ref != STATE_BIG)), f"DSL SSSP from {s}: reached set")
        require(np.array_equal(dv.view(np.int32), ref[ref != STATE_BIG].view(np.int32)), f"DSL SSSP from {s}: distances")
        require(d.isequal(d_p), f"DSL SSSP from {s}: kernel path differs from the plain path")
    # (d) triangles = scipy and phase 6s
    C, tc = got["triangles"]
    require(C._sparse is not None and tc == tc_ref, f"DSL triangles {tc}, scipy {tc_ref}")
    # (d2) batch Brandes = the plain replay (rtol 1e-12: float64 sums
    # reordered) = Brandes in float64 on scipy's CSR, source by source
    (bc, depth), (bc_p, depth_p) = got["brandes"], want["brandes"]
    np.testing.assert_allclose(bc, bc_p, rtol=1e-12, atol=1e-12 * float(np.abs(bc_p).max()))
    sr_, sc_, _ = sym.to_coo()
    s01 = scsp.csr_matrix((np.ones(len(sr_)), (sr_.astype(np.int64), sc_.astype(np.int64))), shape=(n, n))
    oracle, deepest = np.zeros(n), 0
    for s0 in sources[:4]:
        lvl, sig = np.full(n, -1), np.zeros(n)
        lvl[s0], sig[s0], fr, d = 0, 1.0, np.zeros(n), 0
        fr[s0] = 1.0
        while True:
            nxt = np.where(lvl < 0, s01 @ fr, 0.0)
            if not (nxt > 0).any():
                break
            d += 1
            lvl[nxt > 0], sig = d, np.where(nxt > 0, nxt, sig)
            fr = np.where(lvl == d, sig, 0.0)
        dep = np.zeros(n)
        for lv_ in range(d, 1, -1):
            coef = np.where(lvl == lv_, (1.0 + dep) / np.where(lvl == lv_, sig, 1.0), 0.0)
            dep = np.where(lvl == lv_ - 1, sig * (s01 @ coef), dep)
        oracle += np.where(lvl > 0, dep, 0.0)
        deepest = max(deepest, d)
    require(depth == depth_p == deepest, f"DSL Brandes: deepest level {depth} (plain {depth_p}, oracle {deepest})")
    np.testing.assert_allclose(bc, oracle, rtol=1e-9, atol=1e-9 * float(oracle.max()))
    # launches on (a)-(d2)
    for name in ("gather", "segscan_contrib_gather", "segscan", "eqjoin", "segscan_spmm"):
        require(launches[name] > 0, f"sparse DSL path: {name} was not launched")
    require(not any(plain.values()), f"sparse DSL path: plain versions ran: {plain}")
    say(
        "6s sparse dsl",
        f"A: {A.nvals} entries of {n}^2 cells (sparse; host from_coo {times['from_coo s']:.2f} s), A_w {A_w.nvals}; "
        f"(a) PageRank, example 07 ({pr_iters} it) as written and completed: kernel path = plain path rtol 1e-5, "
        f"= the scipy float64 recurrence rtol 1e-4, patterns exact; (sum, oracle's sum, ranked vertices) "
        f"{pr_sums} (as written, a vertex without in-edges loses its rank and its teleport term); (b) level BFS (example 02) from {sources} = models.fast.bfs_level exactly; (c) SSSP "
        f"(example 01) = models.fast.sssp bit for bit; (d) C(L.S) << L plus_pair U: {tc} triangles = scipy; "
        f"(d2) batch Brandes from {sources[:4]} over A.mxm(F) of n x 4 FP64 (deepest level {depth}) = the plain path "
        f"rtol 1e-12 = scipy float64 Brandes rtol 1e-9; "
        f"launches {launches}, plain calls {plain}; drive {times['drive s']:.2f} s",
    )

    # (e) the generic models on the edge-wise ops at scale 19
    t0 = time.perf_counter()
    gen = {}
    for s in sources:
        a = models.bfs_level(g, s)
        require(torch.equal(a, fast.bfs_level(plan, s, n)), f"models.bfs_level from {s} != models.fast")
    par = models.bfs_parent(g, sources[0]).cpu().numpy()
    np.testing.assert_array_equal(par, parent_oracle(np, src, dst, n, lv_ref[0], sources[0]))
    d = models.sssp(g, sources[0])
    d_fast = fast.sssp(plan, sources[0], n)
    reach = d_fast != STATE_BIG
    big = importlib.import_module("graphblas_tpu_torch.models.sssp")._BIG
    require(torch.equal(reach, d < big), "models.sssp: reached set != models.fast")
    require(torch.equal(d[reach], d_fast[reach]), "models.sssp != models.fast bit for bit")
    # the same recurrence at a fixed 50 iterations; rtol 1e-4: index_add_'s
    # atomics and Kernel C's scan sum the float32 contributions in other orders
    pr_g = models.pagerank(g, tol=0.0, max_iters=50)
    outdeg_g = torch.from_numpy(np.bincount(src, minlength=n)).to(dev)
    torch.testing.assert_close(pr_g, fast.pagerank(plan, outdeg_g, n, tol=0.0, max_iters=50), rtol=1e-4, atol=0)
    cc = models.connected_components(g).cpu().numpy()
    ncomp, lab = csgraph.connected_components(scsp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n)), directed=True, connection="weak")
    least = np.full(ncomp, n, np.int64)
    np.minimum.at(least, lab, np.arange(n))
    np.testing.assert_array_equal(cc, least[lab])
    torch.cuda.synchronize()
    gen["check s"] = time.perf_counter() - t0
    say(
        "6s sparse dsl",
        f"(e) generic models at scale {n.bit_length() - 1}: bfs_level x{len(sources)} = models.fast exactly, bfs_parent = the parent "
        f"oracle, sssp = models.fast bit for bit, pagerank (50 it) = models.fast rtol 1e-4, connected_components = "
        f"scipy ({ncomp} components, least vertex labels); {gen['check s']:.2f} s",
    )

    # (f) times on the card
    times["DSL pagerank ms/iter"] = wall_s(torch, pagerank_dsl, 1) * 1e3 / pr_iters
    times["models.fast.pagerank ms/iter"] = wall_s(torch, lambda: fast.pagerank(plan, outdeg_g, n, tol=0.0, max_iters=pr_iters)) * 1e3 / pr_iters
    times["DSL level BFS ms"] = wall_s(torch, lambda: bfs_dsl(sources[0])) * 1e3
    times["models.fast.bfs_level ms"] = wall_s(torch, lambda: fast.bfs_level(plan, sources[0], n)) * 1e3
    contrib = Vector.from_dense(np.random.default_rng(7).random(n).astype(np.float32))
    frontier = Vector.from_coo(sources, True, dtypes.BOOL, size=n)
    dist = Vector.from_coo(sources, 0.0, FP32, size=n)
    stmts = {
        "vxm plus_first[FP32]": lambda: contrib.vxm(A, semiring.plus_first).new(),
        "mxv any_pair[BOOL]": lambda: A.T.mxv(frontier, semiring.any_pair[dtypes.BOOL]).new(),
        "mxv min_plus[FP32]": lambda: A_w.T.mxv(dist, semiring.min_plus).new(),
    }
    for name, stmt in stmts.items():
        for strategy in ("plan", "generic"):
            with gb.tx.config.set(mxv_strategy=strategy):
                stmt()
                times[f"{name} {strategy} ms"] = statistics.median(wall_s(torch, stmt, 1) * 1e3 for _ in range(5))
        with gb.tx.config.set(mxv_strategy="generic"):
            gen_out = stmt()
        out = stmt()
        if "plus" in name.split()[1][:4]:
            require(out.isclose(gen_out, rel_tol=1e-5), f"{name}: plan != generic")
        else:
            require(out.isequal(gen_out), f"{name}: plan != generic")
    times["models.bfs_level ms"] = wall_s(torch, lambda: models.bfs_level(g, sources[0])) * 1e3
    times["models.bfs_parent ms"] = wall_s(torch, lambda: models.bfs_parent(g, sources[0])) * 1e3
    times["models.sssp ms"] = wall_s(torch, lambda: models.sssp(g, sources[0])) * 1e3
    times["models.pagerank ms (tol 1e-6)"] = wall_s(torch, lambda: models.pagerank(g)) * 1e3
    times["models.connected_components ms"] = wall_s(torch, lambda: models.connected_components(g)) * 1e3
    say(
        "6s sparse dsl",
        f"times (host s and ms, synchronised, median): {json.dumps({k: round(v, 4) for k, v in times.items()})} on {smi}; "
        f"phase {time.perf_counter() - t_phase:.1f} s",
    )
    return {"launches": launches, "plain": plain, "A": A}


# the mode/layout each compiled recipe takes on the plan engine: the modes
# the CPU tests hold to the reference (tests/test_torch_compile.py,
# tests/test_torch_sparse_loops.py), in the port's one lowering, the n space
DSL_MODES = {
    "pagerank": "hoisted/n",
    "bfs_level": "carried/n",
    "bfs_level_dense": "hoisted/n",
    "sssp": "hoisted/n",
    "connected_components": "hoisted/n",
}


def profiled_launches(prof):
    """Executions of the port's kernels that a torch.profiler trace saw, by
    launch counter.  G's routes and its fill are one CUDA function
    (gather_kernel) and count together; the single-pass scans are told
    apart by their tile type."""
    out = {"gather+gather_fill": 0, "segscan_contrib": 0, "segscan_state": 0, "segscan": 0, "segscan_contrib_gather": 0}
    # GatherContribTile before ContribTile, whose name it holds
    tiles = {
        "GatherContribTile": "segscan_contrib_gather", "ContribTile": "segscan_contrib",
        "StateTile": "segscan_state", "ValueTile": "segscan",
    }
    for ev in prof.key_averages():
        if "gather_kernel<" in ev.key:
            out["gather+gather_fill"] += ev.count
        elif "scan_onepass<" in ev.key:
            out[next(c for t, c in tiles.items() if t in ev.key)] += ev.count
    return out


def compiled_phase(torch, np, dev, src, dst, w, n, plan, sources, outdeg, smi):
    """Phase 6c (compiled loops): the recipes of models.dsl at RMAT scale 19,
    built as bench.py's dsl_metrics builds them (AT = from_coo(dst, src, 1.0,
    dup_op=plus), ATw with dup_op=min, connected components on AT pull and
    push; mxv_strategy "plan"), each a CUDA graph replayed, in the n space.
    Checks, before any timing: each recipe's
    graph result = the same runner run eagerly on the card (PageRank rtol
    1e-6: C's look-back may add floats in another order; the rest bit for
    bit); PageRank = models.fast.pagerank rtol 1e-5; levels and distances =
    models.fast bit for bit; CC = scipy's weak components (least vertex
    labels); capture "graph" for every recipe; mode/layout as DSL_MODES.
    Then bench.py's dsl_* and cc_* keys, the eager ms per step beside the
    graph's, one PageRank run's device time by kernel (torch.profiler),
    launches per step, and fastsv (host-driven, eager) = scipy on a
    symmetrized RMAT scale-14 graph.  Last, the main path's run again under
    torch.profiler: its counters = the main path's, and the kernels the
    profiler saw = the launches counted (so the counts a replay adds are
    measured).  Returns the compiled path's launch and plain-call counts
    (its graph runs)."""
    import scipy.sparse as scsp
    from scipy.sparse import csgraph

    import graphblas_tpu_torch as gb
    from graphblas_tpu_torch import Matrix, binary, dtypes, kernels
    from graphblas_tpu_torch.models import dsl, fast, rmat
    from graphblas_tpu_torch.ops.scan import STATE_BIG

    t_phase = time.perf_counter()
    FP32 = dtypes.FP32
    iters = 50
    e = len(src)
    out, info = {}, {}
    with gb.tx.config.set(mxv_strategy="plan"):
        t0 = time.perf_counter()
        AT = Matrix.from_coo(dst, src, np.ones(e, np.float32), FP32, nrows=n, ncols=n, dup_op=binary.plus)
        ATw = Matrix.from_coo(dst, src, w.astype(np.float32), FP32, nrows=n, ncols=n, dup_op=binary.min)
        require(AT._sparse is not None and ATw._sparse is not None, "6c: AT and ATw are sparse")
        info["from_coo s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        runners = {
            "pagerank": (dsl.pagerank_runner(AT, max_iters=iters), None),
            "bfs_level": (dsl.bfs_level_runner(AT, sources[0]).runner, 0),
            "bfs_level_dense": (dsl.bfs_level_dense_runner(AT, sources[0]).runner, 0),
            "sssp": (dsl.sssp_runner(ATw, sources[0]).runner, 0),
            "connected_components": (dsl.connected_components_runner(AT).runner, 0),
        }
        torch.cuda.synchronize()
        info["build s (plans, warm steps)"] = time.perf_counter() - t0
        for name, (r, _) in runners.items():
            require(r.capture == "graph", f"6c {name}: capture {r.capture} ({r.capture_reason})")
            require(f"{r.mode}/{r.layout}" == DSL_MODES[name], f"6c {name}: {r.mode}/{r.layout} != {DSL_MODES[name]}")

        def pick(res, k):
            return res if k is None else res[k]

        # the main path of this phase: every recipe once from its graph
        kernels.reset_counts()
        torch.cuda.synchronize()
        got = {name: pick(r(), k) for name, (r, k) in runners.items()}
        torch.cuda.synchronize()
        launches, plain = kernels.launch_counts(), kernels.plain_counts()
        steps = {name: (iters if name == "pagerank" else int(r.last_iters)) for name, (r, _) in runners.items()}
        # (a) graph = eager on the card, a second replay = the first
        t0 = time.perf_counter()
        for name, (r, k) in runners.items():
            eager = pick(r.eager(), k)
            again = pick(r(), k)
            fill = -1 if name.startswith("bfs") else 0.0
            a, b, c = (np.asarray(x.to_dense(fill_value=fill)) for x in (got[name], eager, again))
            if name == "pagerank":
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg="6c pagerank: graph != eager")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"6c {name}: graph != eager")
            np.testing.assert_array_equal(c, a, err_msg=f"6c {name}: the second replay != the first")
        # (b) against the hand-written models and scipy
        pr = np.asarray(got["pagerank"].to_dense(fill_value=0.0))
        outdeg_t = torch.from_numpy(np.bincount(src, minlength=n)).to(dev)
        pr_model = fast.pagerank(plan, outdeg_t, n, tol=0.0, max_iters=iters).cpu().numpy()
        np.testing.assert_allclose(pr, pr_model, rtol=1e-5, atol=0, err_msg="6c pagerank != models.fast")
        lv_model = fast.bfs_level(plan, sources[0], n).cpu().numpy()
        for name in ("bfs_level", "bfs_level_dense"):
            lv = np.asarray(got[name].to_dense(fill_value=-1))
            np.testing.assert_array_equal(lv, lv_model, err_msg=f"6c {name} != models.fast.bfs_level")
        d_model = fast.sssp(plan, sources[0], n).cpu().numpy()
        d = np.asarray(got["sssp"].to_dense(fill_value=np.float32(np.inf)))
        reach = d_model != STATE_BIG
        require(np.array_equal(reach, d < float(dsl._BIG)), "6c sssp: reached set != models.fast")
        require(np.array_equal(d[reach].view(np.int32), d_model[reach].view(np.int32)), "6c sssp != models.fast bit for bit")
        cc = np.asarray(got["connected_components"].to_dense(fill_value=-1)).astype(np.int64)
        ncomp, lab = csgraph.connected_components(scsp.csr_matrix((np.ones(e), (src, dst)), shape=(n, n)), directed=True, connection="weak")
        least = np.full(ncomp, n, np.int64)
        np.minimum.at(least, lab, np.arange(n))
        np.testing.assert_array_equal(cc, least[lab], err_msg="6c connected components != scipy")
        info["check s"] = time.perf_counter() - t0
        for name in ("gather", "segscan_contrib_gather", "segscan"):
            require(launches[name] > 0, f"6c compiled loops: {name} was not launched")
        require(not any(plain.values()), f"6c compiled loops: plain versions ran: {plain}")
        say(
            "6c compiled loops",
            f"scale {n.bit_length() - 1}: from_coo {info['from_coo s']:.2f} s, runners built (plans, warm "
            f"steps, no capture yet) {info['build s (plans, warm steps)']:.2f} s; modes {DSL_MODES} with layout n, "
            f"every recipe capture=graph; graph = eager on the card (pagerank rtol 1e-6, the rest exact) and a second replay = "
            f"the first; pagerank ({iters} it) = models.fast rtol 1e-5; levels (both recipes) and sssp = models.fast "
            f"bit for bit from {sources[0]}; CC = scipy ({ncomp} weak components); steps {steps}; launches "
            f"{launches}, plain calls {plain}; checks {info['check s']:.2f} s",
        )

        # (c) times in bench.py's definitions (synchronised host time, median)
        t_model = wall_s(torch, lambda: fast.pagerank(plan, outdeg_t, n, tol=0.0, max_iters=iters)) / iters
        pr_run = runners["pagerank"][0]
        t = wall_s(torch, pr_run) / iters
        out["dsl_pagerank_gteps_per_iter"] = e / t / 1e9
        out["dsl_pagerank_iter_ms"] = t * 1e3
        out["dsl_pagerank_mode"] = f"{pr_run.mode}/{pr_run.layout}"
        out["dsl_vs_model_iter_ratio"] = t / t_model
        per = {"pagerank": {"graph ms/step": t * 1e3, "eager ms/step": wall_s(torch, pr_run.eager, 1) * 1e3 / iters}}
        for key, name, mat in (("dsl_bfs", "bfs_level", AT), ("dsl_bfs_dense", "bfs_level_dense", AT), ("dsl_sssp", "sssp", ATw)):
            build = {"bfs_level": dsl.bfs_level_runner, "bfs_level_dense": dsl.bfs_level_dense_runner, "sssp": dsl.sssp_runner}[name]
            runs = [build(mat, s).runner for s in sources[:2]] * 2
            t = wall_s(torch, lambda: [r() for r in runs]) / len(runs)
            out[f"{key}_gteps"] = e / t / 1e9
            out[f"{key}_mode"] = f"{runs[0].mode}/{runs[0].layout}"
            r0, k0 = runners[name]
            st = int(r0.last_iters)
            per[name] = {
                "graph ms/run": t * 1e3, "graph ms/step": wall_s(torch, r0) * 1e3 / st,
                "eager ms/step": wall_s(torch, r0.eager, 1) * 1e3 / st, "steps": st,
            }
        cc_run = runners["connected_components"][0]
        us, vs = np.concatenate([src, dst]), np.concatenate([dst, src])
        e_sym = int(np.unique(us.astype(np.int64) * n + vs).size)
        t = wall_s(torch, lambda: [cc_run() for _ in range(4)]) / 4
        out["cc_gteps"] = e_sym / t / 1e9
        out["cc_ms"] = t * 1e3
        out["cc_iters"] = int(cc_run.last_iters)
        out["cc_mode"] = f"{cc_run.mode}/{cc_run.layout}"
        per["connected_components"] = {
            "graph ms/step": t * 1e3 / out["cc_iters"],
            "eager ms/step": wall_s(torch, cc_run.eager, 1) * 1e3 / out["cc_iters"], "steps": out["cc_iters"],
        }
        # the capture scope's share of an eager step's host time: the own
        # time of core/capture.py's frames (the TorchFunctionMode's tagging
        # and watching) over the run's, under cProfile (which slows both)
        pf = cProfile.Profile()
        pf.enable()
        pr_run.eager()
        torch.cuda.synchronize()
        pf.disable()
        st = pstats.Stats(pf)
        own = sum(v[2] for k, v in st.stats.items() if k[0].endswith(os.path.join("core", "capture.py")))
        per["pagerank"]["eager step: capture scope's share of host time (cProfile)"] = own / st.total_tt
        for name, (r, _) in runners.items():
            # one recipe's run alone: its launches per body step
            kernels.reset_counts()
            r()
            torch.cuda.synchronize()
            per[name]["launches/step"] = {k: v / steps[name] for k, v in kernels.launch_counts().items() if v}
        # fastsv: the notebook's host-driven recipe (a Python loop with host
        # reads a round: no compiled loop, so no graph), on the symmetrization
        # of an RMAT scale-14 graph (a scale-19 run takes ~9 s of host time)
        g14 = rmat(14, 16, seed=5, device=dev)
        ok14 = g14.valid.cpu().numpy()
        s14, d14 = (a.cpu().numpy()[ok14] for a in (g14.src, g14.dst))
        n14 = g14.n
        ATs = Matrix.from_coo(
            np.concatenate([d14, s14]), np.concatenate([s14, d14]), np.float32(1.0), FP32, nrows=n14, ncols=n14,
            dup_op=binary.first,
        )
        t0 = time.perf_counter()
        fv = np.asarray(dsl.fastsv(ATs).to_dense(fill_value=-1)).astype(np.int64)
        torch.cuda.synchronize()
        per["fastsv (scale 14)"] = {"eager ms/run": (time.perf_counter() - t0) * 1e3}
        nc14, lab14 = csgraph.connected_components(
            scsp.csr_matrix((np.ones(len(s14)), (s14, d14)), shape=(n14, n14)), directed=True, connection="weak"
        )
        least14 = np.full(nc14, n14, np.int64)
        np.minimum.at(least14, lab14, np.arange(n14))
        np.testing.assert_array_equal(fv, least14[lab14], err_msg="6c fastsv != scipy")
        # last, as the profiler may slow the host after it: the main path's
        # run again under torch.profiler, which sees each kernel a replay
        # executes; its counters must equal the main path's, and the
        # kernels the profiler saw the launches counted
        kernels.reset_counts()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for r, _ in runners.values():
                r()
            torch.cuda.synchronize()
        again = kernels.launch_counts()
        require(again == launches, f"6c: a second run's launches {again} != the main path's {launches}")
        seen = profiled_launches(prof)
        counted = {
            "gather+gather_fill": again["gather"] + again["gather_fill"],
            **{c: again[c] for c in ("segscan_contrib", "segscan_state", "segscan", "segscan_contrib_gather")},
        }
        require(seen == counted, f"6c: the kernels the profiler saw {seen} != the launches counted {counted}")
        # where a PageRank replay's device time goes
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            pr_run()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages() if getattr(ev, "device_time_total", 0) > 0]
        dev_ms = sum(ev.device_time_total for ev in evs) / 1e3
        top = sorted(evs, key=lambda ev: -ev.device_time_total)[:8]
        per["pagerank"]["device ms/step (profiler)"] = dev_ms / iters
        per["pagerank"]["top kernels ms/step"] = {ev.key[:60]: ev.device_time_total / 1e3 / iters for ev in top}
        t_model_after = wall_s(torch, lambda: fast.pagerank(plan, outdeg_t, n, tol=0.0, max_iters=iters)) / iters
    say(
        "6c compiled loops",
        f"bench.py keys {json.dumps(out)}; per recipe {json.dumps(per)} (cc_gteps over the {e_sym} edges of the "
        f"symmetrization, as bench.py); models.fast.pagerank {t_model * 1e3:.4f} ms/iter ({t_model_after * 1e3:.4f} "
        f"after the profiler); the kernels the profiler saw in a second run of the main path = the launches "
        f"counted {seen}; on {smi}; phase {time.perf_counter() - t_phase:.1f} s",
    )
    return {"launches": launches, "plain": plain, "dsl": out}


# float32 FMA rate without tensor cores (132 SMs x 128 lanes x 1.98 GHz, an
# FMA counted as two): the least time of the dense models' f32 products
F32_FMA_FLOP_S = 132 * 128 * 1.98e9 * 2
# int8 tensor-core rate (H100 SXM data sheet, dense): the least time of the
# models' int8 overlap counts (torch._int_mm)
INT8_TC_OPS_S = 1979e12


def f32_triangle_count(torch, graph):
    """The triangle count as the port computed it before its integer
    products: L's blocks in f32 against L^T with TF32 off, the masked sums in
    int64 (phase 6m's check and yardstick for models.triangle_count)."""
    from graphblas_tpu_torch.models.graph import edge_index
    from graphblas_tpu_torch.ops.mxm import full_f32_matmul

    es, ed = edge_index(graph)
    npad = -(-graph.n // 1024) * 1024
    lf = torch.zeros((npad, npad), dtype=torch.float32, device=es.device)
    lf[torch.maximum(es, ed), torch.minimum(es, ed)] = 1.0
    lf.diagonal().zero_()
    total = torch.zeros((), dtype=torch.int64, device=es.device)
    with full_f32_matmul():
        for i in range(0, npad, 1024):
            block = lf[i : i + 1024]
            total += torch.sum((block @ lf.T) * block, dtype=torch.int64)
    return int(total)


def f32_k_truss(torch, graph, k):
    """The k-truss fixpoint as the port computed it before its integer
    products: an f32 0/1 adjacency, support (A @ A) * A with TF32 off.
    Returns the surviving (row, col) pairs in row-major order and the rounds."""
    from graphblas_tpu_torch.models.graph import edge_index
    from graphblas_tpu_torch.ops.mxm import full_f32_matmul

    es, ed = edge_index(graph)
    a = torch.zeros((graph.n, graph.n), dtype=torch.float32, device=es.device)
    a[es, ed] = 1.0
    a = torch.maximum(a, a.T)
    a.fill_diagonal_(0.0)
    rounds = 0
    with full_f32_matmul():
        while True:
            a2 = torch.where((a @ a) * a >= k - 2, a, 0.0)
            rounds += 1
            if not bool((a2 != a).any()):
                return torch.nonzero(a2, as_tuple=True), rounds
            a = a2


def udt_recipes(gb, np):
    """The statements of tests/test_udt.py at a small size (48 x 48, 30%
    present, numpy seed 21) on tx.config["platform"]: ewise add/mult and
    apply with user operators, reduce with a user monoid, extract and assign
    by fields, mxm/mxv with a user semiring, a masked mxm with a user accum.
    Returns (to_coo outputs, the devices of the collections)."""
    from graphblas_tpu_torch import Matrix, Vector, binary, dtypes, monoid, semiring, unary

    try:
        point = dtypes.register_new("SmokePoint", [("x", np.float64), ("y", np.int64)])
    except ValueError:
        point = dtypes.SmokePoint
    rng = np.random.default_rng(21)
    n = 48

    def vals(k):
        out = np.zeros(k, point.np_type)
        out["x"] = rng.integers(-8, 9, k) / 4.0
        out["y"] = rng.integers(-50, 50, k)
        return out

    def pattern():
        flat = np.flatnonzero(rng.random(n * n) < 0.3)
        return flat // n, flat % n, vals(len(flat))

    def padd(a, b):
        return {"x": a["x"] + b["x"], "y": a["y"] + b["y"]}

    add = binary.register_anonymous(padd, "smoke_padd")
    mon = monoid.register_anonymous(padd, {"x": 0.0, "y": 0}, "smoke_padd_mon")
    sr = semiring.register_anonymous(mon, add, "smoke_padd_padd")
    flip = unary.register_anonymous(lambda p: {"x": p["x"] * 2, "y": -p["y"]}, "smoke_flip")
    A = Matrix.from_coo(*pattern(), point, nrows=n, ncols=n)
    B = Matrix.from_coo(*pattern(), point, nrows=n, ncols=n)
    C = Matrix.from_coo(*pattern(), point, nrows=n, ncols=n)
    v = Vector.from_coo(np.arange(0, n, 3), vals(n // 3), point, size=n)
    M = Matrix.from_coo(*np.nonzero(rng.random((n, n)) < 0.5), True, dtypes.BOOL, nrows=n, ncols=n)
    out = [A.ewise_add(B, add).new(), A.ewise_mult(B, add).new(), A.apply(flip).new()]
    out.append(A.reduce_rowwise(mon).new())
    out.append(A.reduce_scalar(mon).new())
    w = v.dup()
    w[[1, 4]] = (9.5, 7)
    w[5] = {"x": -1.25, "y": 3}
    del w[0]
    out += [w, v[[0, 3, 7]].new(), A[2, :].new()]
    out += [A.mxm(B, sr).new(), A.mxv(v, sr).new()]
    C(M.S, accum=add) << A.mxm(B, sr)
    out.append(C)
    coo = [np.asarray(x.value) if x.ndim == 0 else x.to_coo() for x in out]
    return coo, {x._device.type for x in out if x.ndim}


BC_SOURCES = 256  # betweenness centrality's sources in phase 6m
LOUVAIN_CHECK_SCALE = 11  # louvain's card-against-CPU check: rmat(11, 16, seed=5)


def dense_models_phase(torch, np, dev, g19, scale, smi):
    """Phase 6m (the dense models): triangle_count, k_truss (k = 4 and 12),
    betweenness_centrality (BC_SOURCES numpy-seeded sources), louvain and
    maximal_matching through models, on rmat(scale, 16, seed=5) on the card
    (n = 16384 at scale 14, the n the reference's louvain docstring names),
    and maximal_matching on bench.py's scale-19 graph.  Checks: the triangle
    count = scipy's int64 (L @ L.T).multiply(L).sum() and the f32 path's
    (``f32_triangle_count``); each k-truss edge set = a scipy peeling fixpoint
    ((A @ A).multiply(A), drop support < k - 2, repeat) and the f32 path's
    (``f32_k_truss``), in as many rounds; betweenness = a float64 scipy level-synchronous Brandes over the
    same sources, rtol 1e-4, with max_levels = their largest BFS level + 1;
    louvain's labels at rmat(LOUVAIN_CHECK_SCALE, 16, seed=5) = the port's CPU run,
    and at scale its modularity (the port's f32 ``modularity`` on the card)
    = a float64 numpy one within 1e-4; the matching is a matching and maximal
    (numpy) and = the port's CPU run of the same graph exactly; every result
    on the card; the UDT recipes (``udt_recipes``) on the card = the same
    statements on the CPU, bit for bit.  Then each model's ms (CUDA events,
    a warm call) beside its least time (the f32 products at the FMA rate, the
    int8 counts at the int8 tensor-core rate; the matching's bytes), the
    triangle count's and the k-truss's f32 paths' ms, torch._int_mm's int8
    block product beside the f32 one, the rounds, and the phase's peak device
    memory.  The products are torch._int_mm and torch.matmul (cuBLAS), not
    hand kernels: no kernel launch is counted."""
    import importlib

    import scipy.sparse as scsp

    import graphblas_tpu_torch as gb
    from graphblas_tpu_torch import models as M
    from graphblas_tpu_torch.models.graph import edge_index

    n_bc, lv_check_scale = BC_SOURCES, LOUVAIN_CHECK_SCALE
    from graphblas_tpu_torch.ops.mxm import full_f32_matmul

    kt_mod, mt_mod, lv_mod = (
        importlib.import_module(f"graphblas_tpu_torch.models.{m}") for m in ("ktruss", "matching", "louvain")
    )
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {}

    def timed(fn):
        """fn's result (the check's call, which also warms up) and the ms of
        a second call (CUDA events)."""
        res = fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return res, start.elapsed_time(end)

    def flop_ms(flop):
        return flop / F32_FMA_FLOP_S * 1e3

    gm = M.rmat(scale, 16, seed=5)
    require(gm.src.is_cuda, "6m: rmat defaults to the card")
    n = gm.n
    valid = gm.valid.cpu().numpy()
    hs, hd = (a.cpu().numpy()[valid].astype(np.int64) for a in (gm.src, gm.dst))
    lo, hi = np.minimum(hs, hd), np.maximum(hs, hd)
    off = lo != hi

    def ones_csr(r, c):
        m = scsp.csr_matrix((np.ones(len(r)), (r, c)), shape=(n, n))
        m.sum_duplicates()
        m.data[:] = 1.0
        return m

    L = ones_csr(hi[off], lo[off])

    # triangle_count = scipy
    t0 = time.perf_counter()
    tc_ref = int((L @ L.T).multiply(L).sum())
    t_oracle = {"triangle": time.perf_counter() - t0}
    tc, tc_ms = timed(lambda: M.triangle_count(gm))
    tc32, tc32_ms = timed(lambda: f32_triangle_count(torch, gm))
    require(tc == tc32 == tc_ref, f"6m triangle_count {tc}, the f32 path {tc32}, scipy {tc_ref}")
    npad = -(-n // 1024) * 1024
    out["triangle_count"] = {
        "value": tc, "ms": tc_ms, "int8 bound_ms": 2.0 * npad**3 / INT8_TC_OPS_S * 1e3,
        "f32 path ms": tc32_ms, "bound_ms": flop_ms(2.0 * npad**3),
    }
    # torch._int_mm (int8 in, int32 out) against the f32 block product
    es, ed = edge_index(gm)
    ls = torch.zeros((npad, npad), dtype=torch.int8, device=dev)
    ls[torch.maximum(es, ed), torch.minimum(es, ed)] = 1
    ls.diagonal().zero_()
    lf = ls.to(torch.float32)
    with full_f32_matmul():
        blk_f32, f32_ms = timed(lambda: lf[:1024] @ lf.T)
    blk_i32, int_ms = timed(lambda: torch._int_mm(ls[:1024], ls.T))
    int_mm = {"ms": int_ms, "exact": bool(torch.equal(blk_i32, blk_f32.to(torch.int32)))}
    require(int_mm["exact"], "6m: torch._int_mm's block differs from the f32 block")
    out["block product 1024 x n x n"] = {"f32 ms": f32_ms, "torch._int_mm": int_mm, "bound_ms": flop_ms(2.0 * 1024 * npad**2)}
    del ls, lf, blk_f32
    torch.cuda.empty_cache()

    # k_truss = a scipy peeling fixpoint
    A = ones_csr(np.concatenate([hi[off], lo[off]]), np.concatenate([lo[off], hi[off]]))

    def truss_oracle(k):
        a, rounds = A.copy(), 0
        while True:
            rounds += 1
            keep = a.multiply(a @ a).tocsr()
            keep.data = (keep.data >= k - 2).astype(np.float64)
            keep.eliminate_zeros()
            if keep.nnz == a.nnz:
                keep.sort_indices()
                return keep.tocoo(), rounds
            a = keep

    for kk in (4, 12):
        t0 = time.perf_counter()
        ref, ref_rounds = truss_oracle(kk)
        t_oracle[f"k_truss {kk}"] = time.perf_counter() - t0
        kt, kt_ms = timed(lambda: M.k_truss(gm, kk))
        rounds = kt_mod.last_rounds
        (r32, c32), rounds32 = f32_k_truss(torch, gm, kk)
        _, kt32_ms = timed(lambda: f32_k_truss(torch, gm, kk))
        require(kt.src.is_cuda and kt.valid.is_cuda, "6m k_truss: the result is on the card")
        v = kt.valid.cpu().numpy()
        got = np.stack([kt.src.cpu().numpy()[v], kt.dst.cpu().numpy()[v]]).astype(np.int64)
        require(np.array_equal(got, np.stack([ref.row, ref.col])), f"6m k_truss {kk}: edge set != scipy's")
        require(
            np.array_equal(got, torch.stack([r32, c32]).cpu().numpy()) and rounds32 == rounds,
            f"6m k_truss {kk}: edge set or rounds != the f32 path's",
        )
        require(rounds == ref_rounds, f"6m k_truss {kk}: {rounds} rounds, scipy's peeling {ref_rounds}")
        out[f"k_truss k={kk}"] = {
            "edges": int(v.sum()), "rounds": rounds, "ms": kt_ms,
            "int8 bound_ms": rounds * 2.0 * n**3 / INT8_TC_OPS_S * 1e3, "f32 path ms": kt32_ms,
            "bound_ms": flop_ms(rounds * 2.0 * n**3),
        }

    # betweenness_centrality = a float64 Brandes over the same sources
    D = ones_csr(hs[hs != hd], hd[hs != hd])
    DT = D.T.tocsr()
    srcs = np.random.default_rng(5).choice(n, n_bc, replace=False)
    t0 = time.perf_counter()
    sigma = np.zeros((n_bc, n))
    sigma[np.arange(n_bc), srcs] = 1.0
    onehot = sigma.copy()
    front, fronts = onehot, []
    while True:
        nxt = (DT @ front.T).T * (sigma == 0)
        if not nxt.any():
            break
        sigma += nxt
        front = nxt
        fronts.append(nxt)
    depth = len(fronts)
    safe = np.where(sigma > 0, sigma, 1.0)
    delta = np.zeros_like(sigma)
    for fr, fp in zip(reversed(fronts), reversed([onehot, *fronts[:-1]])):
        t2 = np.where(fr > 0, (1.0 + delta) / safe, 0.0)
        delta += np.where(fp > 0, (D @ t2.T).T * sigma, 0.0)
    delta[np.arange(n_bc), srcs] = 0.0
    bc_ref = delta.sum(axis=0)
    t_oracle["betweenness"] = time.perf_counter() - t0
    levels = depth + 1
    bc, bc_ms = timed(lambda: M.betweenness_centrality(gm, srcs, max_levels=levels))
    require(bc.is_cuda, "6m betweenness: the result is on the card")
    np.testing.assert_allclose(bc.cpu().numpy(), bc_ref, rtol=1e-4, err_msg="6m betweenness != scipy Brandes")
    out["betweenness_centrality"] = {
        "sources": n_bc, "max_levels": levels, "largest path count": float(sigma.max()),
        "max rel err": float(np.max(np.abs(bc.cpu().numpy() - bc_ref) / np.maximum(np.abs(bc_ref), 1e-30))),
        "ms": bc_ms, "bound_ms": flop_ms(levels * 2 * 2.0 * n_bc * n * n),
    }

    # louvain: the card = the CPU at the check scale; modularity at scale
    gc = M.rmat(lv_check_scale, 16, seed=5)
    lab_c = M.louvain(gc)
    it_c = lv_mod.last_iters
    require(lab_c.is_cuda, "6m louvain: the result is on the card")
    require(torch.equal(lab_c.cpu(), M.louvain(gc.to("cpu"))), f"6m louvain: card labels != CPU labels at scale {lv_check_scale}")
    lab, lv_ms = timed(lambda: M.louvain(gm))
    iters = lv_mod.last_iters
    labels = lab.cpu().numpy().astype(np.int64)
    sym = scsp.coo_matrix((np.ones(2 * len(hs)), (np.concatenate([hs, hd]), np.concatenate([hd, hs]))), shape=(n, n)).tocsr()
    sym.setdiag(0)
    sym.eliminate_zeros()
    kdeg = np.asarray(sym.sum(axis=1)).ravel()
    two_m = max(kdeg.sum(), 1.0)
    c = sym.tocoo()
    inside = c.data[labels[c.row] == labels[c.col]].sum()
    q64 = inside / two_m - np.sum(np.bincount(labels, weights=kdeg, minlength=n) ** 2) / two_m**2
    q_single = -np.sum(kdeg**2) / two_m**2
    adj = torch.zeros((n, n), dtype=torch.float32, device=dev)
    s_t, d_t = edge_index(gm)
    w_t = gm.valid.to(torch.float32)
    adj.index_put_((s_t, d_t), w_t, accumulate=True)
    adj.index_put_((d_t, s_t), w_t, accumulate=True)
    adj.fill_diagonal_(0.0)
    q32 = float(lv_mod.modularity(adj, lab, torch.clamp(adj.sum(), min=1.0)))
    del adj
    require(abs(q32 - q64) <= 1e-4, f"6m louvain: modularity on the card {q32} != numpy float64 {q64}")
    out["louvain"] = {
        "iterations": iters, "communities": int(len(np.unique(labels))), "Q (numpy float64)": float(q64),
        "Q (port, f32, card)": q32, "Q of the singleton partition": float(q_single),
        f"check scale {lv_check_scale}: iterations": it_c,
        "ms": lv_ms, "bound_ms": flop_ms(iters * 2.0 * n**3),
    }

    # maximal_matching on bench.py's scale-19 graph
    mm, mm_ms = timed(lambda: M.maximal_matching(g19, seed=0))
    rounds = mt_mod.last_rounds
    require(mm.is_cuda, "6m matching: the result is on the card")
    mm_h = mm.cpu().numpy()
    require(np.array_equal(mm_h, M.maximal_matching(g19.to("cpu"), seed=0).numpy()), "6m matching: card != CPU")
    s19, d19, v19 = (a.cpu().numpy() for a in (g19.src, g19.dst, g19.valid))
    touched = np.concatenate([s19[mm_h], d19[mm_h]])
    require(len(touched) == len(np.unique(touched)), "6m matching: a vertex in two matched edges")
    used = np.zeros(g19.n, bool)
    used[touched] = True
    live = v19 & (s19 != d19)
    require(bool((used[s19[live]] | used[d19[live]]).all()), "6m matching: not maximal")
    e_pad = len(s19)
    # where a call's time goes: the host's priorities, and the device's kernels
    t0 = time.perf_counter()
    np.random.default_rng(0).permutation(e_pad).astype(np.float32)
    host_prio_ms = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        M.maximal_matching(g19, seed=0)
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if getattr(ev, "device_time_total", 0) > 0]
    top = sorted(evs, key=lambda ev: -ev.device_time_total)[:4]
    out["maximal_matching (scale 19)"] = {
        "e_pad": e_pad, "matched": int(mm_h.sum()), "rounds": rounds, "ms": mm_ms,
        # a round reads src and dst (int64), the priorities and the live mask and writes two masks
        "bound_ms": rounds * e_pad * (8 + 8 + 4 + 1 + 1 + 1) / HBM_BYTES_PER_S * 1e3,
        "host priorities ms": host_prio_ms,
        "device ms (profiler)": sum(ev.device_time_total for ev in evs) / 1e3,
        "top kernels ms": {ev.key[:60]: ev.device_time_total / 1e3 for ev in top},
    }
    peak = torch.cuda.max_memory_allocated() / 2**30

    # the UDT recipes on the card = on the CPU
    with gb.tx.config.set(platform=dev.type):
        card, devs = udt_recipes(gb, np)
    require(devs == {"cuda"}, f"6m UDT: collections on {devs}")
    with gb.tx.config.set(platform="cpu"):
        host, _ = udt_recipes(gb, np)
    for i, (a, b) in enumerate(zip(card, host)):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            require(x.dtype == y.dtype and x.shape == y.shape, f"6m UDT recipe {i}: {x.dtype}{x.shape} != {y.dtype}{y.shape}")
            for f in x.dtype.names or (None,):
                require(np.array_equal(x[f] if f else x, y[f] if f else y), f"6m UDT recipe {i}: field {f} differs")
    say(
        "6m dense models",
        f"{json.dumps(out)}; UDT recipes on the card = the CPU bit for bit ({len(card)} results); "
        f"host oracles s {json.dumps(t_oracle)}; peak device memory {peak:.2f} GiB; on {smi}; "
        f"phase {time.perf_counter() - t_phase:.1f} s",
    )
    return out


TX_FORMATS = ("coo", "coor", "cooc", "csr", "csc", "hypercsr", "hypercsc", "bitmapr", "bitmapc", "fullr", "fullc", "densemasked")
TX_N = 4096  # the n of phase 6i's dense tx operands (n^2 cells, phase 6d's size)
TX_EXPORT_N = 256  # the top-left block of them that the export/import_any round trips take


def tx_statements(gb, A, E):
    """Phase 6i's tx statements on a dense-masked operand A (n x n), and the
    export/import_any round trip in every format on E (a small operand: the
    formats are host numpy): the results by name (collections, or tuples and
    lists of them)."""
    n = A.nrows
    flat = A.tx.flatten()
    out = {
        "scan plus rows": A.tx.scan("plus"),
        "scan plus columns": A.tx.scan("plus", "columnwise"),
        "scan max rows": A.tx.scan("max"),
        "sort lt": A.tx.sort("lt"),
        "sort gt columns": A.tx.sort("gt", "columnwise"),
        "selectk largest 8": A.tx.selectk("largest", 8),
        "selectk first 8": A.tx.selectk("first", 8),
        "compactify smallest": A.tx.compactify("smallest", n // 2),
        "flatten": flat,
        "reshape": flat.tx.reshape(n // 2, 2 * n),
        "reshape columns": A.tx.reshape(n // 4, 4 * n, "columnwise"),
        "split/concat": gb.tx.concat(A.tx.split(n // 4)),
        "diag": gb.tx.diag(gb.tx.diag(A, 3), -2),
    }
    for fmt in TX_FORMATS:
        blob = E.tx.export(fmt)
        out[f"export/import_any {fmt}"] = gb.tx.import_any(**dict(blob))
    return out


def interop_phase(torch, np, dev, src, dst, w, n, smi, tx_n=TX_N):
    """Phase 6i (interop and tx): bench.py's scale-19 graph as a scipy CSR
    (duplicates summed) through io.from_scipy_sparse, sparse on the card;
    to_scipy_sparse gives back its indptr, indices and data; GBTX
    (compression "none") and pickle round trips are on the card and isequal
    to it; A.mxv(ones, plus_times) on the three = bit for bit, = scipy
    float64 within 1e-4 (the "interop" path's launches: G, fill, C); Matrix
    Market through a temporary file at rmat(14, 16, seed=5); the tx
    statements (``tx_statements``) on a phase-6d-style tx_n^2 card operand
    (numpy seed 12, 30% present, INT64 and FP32; the export/import_any round
    trips on its TX_EXPORT_N^2 top-left block) = the port's CPU run of the
    same statements; sort, selectk and scan on the scale-19 sparse matrix
    against numpy (scan plus = the reference's float32 formula bit for bit).  Host seconds of each load, serialize, deserialize and
    pickle; card ms (CUDA events) of the tx statements."""
    import importlib.util
    import pickle
    import tempfile

    import scipy.sparse as scsp

    import graphblas_tpu_torch as gb
    from graphblas_tpu_torch import Matrix, Vector, binary, dtypes, kernels, semiring
    from graphblas_tpu_torch.models import rmat

    t_phase = time.perf_counter()
    absent = [m for m in ("zstandard", "networkx", "matplotlib") if importlib.util.find_spec(m) is None]
    say(
        "6i interop",
        f"not installed on this machine: {', '.join(absent) or 'none of them'} (of zstandard, networkx, "
        "matplotlib): GBTX is written with compression='none', and to/from_networkx and viz are not called here "
        "(the CPU tests hold them against the reference)",
    )
    require(gb.tx.config["platform"] == "cuda", "6i: collections default to the card")
    csr = scsp.csr_matrix((w, (src, dst)), shape=(n, n))
    csr.sum_duplicates()
    csr.sort_indices()
    secs = {}

    def host(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    def on_card(M):
        return M._device.type == "cuda"

    # the drive: load, round trips, mxv, tx statements; launches counted from here
    kernels.reset_counts()
    A = host("from_scipy_sparse", lambda: gb.io.from_scipy_sparse(csr, name="A"))
    require(A._sparse is not None and on_card(A), "6i: from_scipy_sparse is not sparse on the card")
    back = host("to_scipy_sparse", lambda: gb.io.to_scipy_sparse(A, "csr"))
    for key in ("indptr", "indices", "data"):
        require(np.array_equal(getattr(back, key), getattr(csr, key)), f"6i: to_scipy_sparse {key} differs")
    require(back.data.dtype == csr.data.dtype == np.float32, "6i: to_scipy_sparse dtype")
    blob = host("serialize none", lambda: A.tx.serialize(compression="none"))
    B = host("deserialize", lambda: gb.tx.deserialize(blob))
    pk = host("pickle.dumps", lambda: pickle.dumps(A, protocol=pickle.HIGHEST_PROTOCOL))
    C = host("pickle.loads", lambda: pickle.loads(pk))
    for name, M in (("GBTX", B), ("pickle", C)):
        require(M._sparse is not None and on_card(M), f"6i {name}: not sparse on the card")
        require(M.isequal(A, check_dtype=True) and M.name == ("A" if name == "pickle" else None), f"6i {name}: round trip differs")
    ones = Vector.from_scalar(1.0, n, dtypes.FP32)
    ys = [host(f"mxv {k} (plan build)", lambda M=M: M.mxv(ones, semiring.plus_times).new()) for k, M in (("A", A), ("GBTX", B), ("pickle", C))]
    for y in ys[1:]:
        require(torch.equal(y._struct, ys[0]._struct) and same_bits(torch, y._values, ys[0]._values), "6i: mxv differs after a round trip")
    want = np.asarray(csr.astype(np.float64) @ np.ones(n))
    yv = ys[0].to_dense(fill_value=0.0)
    np.testing.assert_allclose(yv, want, rtol=1e-4, atol=0)
    mxv_err = float(np.max(np.abs(yv - want) / np.maximum(np.abs(want), 1e-30)))

    # tx on the scale-19 sparse matrix (host numpy, as the reference; results on the card)
    sp_sort = host("tx.sort scale 19", lambda: A.tx.sort("lt"))
    sp_top = host("tx.selectk scale 19", lambda: A.tx.selectk("largest", 1))
    sp_max = host("tx.scan max scale 19", lambda: A.tx.scan("max"))
    sp_plus = host("tx.scan plus scale 19", lambda: A.tx.scan("plus"))

    # tx on the tx_n^2 dense operands, INT64 and FP32
    prng = np.random.default_rng(12)
    cells = np.flatnonzero(prng.random(tx_n * tx_n) < 0.3)
    tx_coo = {
        "INT64": (cells // tx_n, cells % tx_n, prng.integers(-1000, 1000, len(cells))),
        "FP32": (cells // tx_n, cells % tx_n, prng.random(len(cells), np.float32)),
    }
    e_n = min(TX_EXPORT_N, tx_n)
    ex_coo = {k: tuple(a[(r < e_n) & (c < e_n)] for a in (r, c, v)) for k, (r, c, v) in tx_coo.items()}

    def operands():
        return {
            k: (
                Matrix.from_coo(*tx_coo[k], getattr(dtypes, k), nrows=tx_n, ncols=tx_n),
                Matrix.from_coo(*ex_coo[k], getattr(dtypes, k), nrows=e_n, ncols=e_n),
            )
            for k in tx_coo
        }

    dense_ops = operands()
    card = {k: host(f"tx statements {k}", lambda ops=ops: tx_statements(gb, *ops)) for k, ops in dense_ops.items()}
    torch.cuda.synchronize()
    launches, plain = kernels.launch_counts(), kernels.plain_counts()

    # checks of the scale-19 tx results (numpy)
    r0, c0, v0 = (a.astype(np.int64) if a.dtype == np.uint64 else a for a in A.to_coo())
    for M in (*sp_sort, sp_top, sp_max, sp_plus):
        require(M._sparse is not None and on_card(M), "6i: a sparse tx result is not sparse on the card")
    starts = np.flatnonzero(np.concatenate([[True], r0[1:] != r0[:-1]]))
    ends = np.concatenate([starts[1:], [len(r0)]]) - 1
    sv_r, sv_c, sv_v = sp_sort[0].to_coo()
    _, _, perm = sp_sort[1].to_coo()
    in_row = np.arange(len(r0)) - np.repeat(starts, ends - starts + 1)
    require(np.array_equal(sv_r, r0) and np.array_equal(sv_c, in_row), "6i sort: pattern")
    require(np.array_equal(sv_v, v0[np.searchsorted(r0 * n + c0, r0 * n + perm.astype(np.int64))]), "6i sort: values != A[r, permutation]")
    require(bool(np.all((np.diff(sv_v) >= 0) | (np.diff(r0) != 0))), "6i sort: a row is not ascending")
    rowmax = np.maximum.reduceat(v0, starts)
    tr, _, tv = sp_top.to_coo()
    require(np.array_equal(tr, r0[starts]) and np.array_equal(tv, rowmax), "6i selectk largest 1 != the row maxima")
    _, _, mv = sp_max.to_coo()
    require(np.array_equal(mv[ends], rowmax) and bool(np.all((np.diff(mv) >= 0) | (np.diff(r0) != 0))), "6i scan max")
    _, _, pv = sp_plus.to_coo()
    rowsum = np.add.reduceat(v0.astype(np.float64), starts)
    plus_err = float(np.max(np.abs(pv[ends] - rowsum) / rowsum))
    # the reference's formula (one running float32 sum less its value at each row's start), in numpy
    acc = np.add.accumulate(v0)
    ref_pv = acc - np.repeat(acc[starts] - v0[starts], ends - starts + 1)
    ref_err = float(np.max(np.abs(ref_pv[ends] - rowsum) / rowsum))
    require(np.array_equal(pv, ref_pv) and plus_err <= ref_err, f"6i scan plus: off the reference's formula ({plus_err:.3e} > {ref_err:.3e})")

    # the tx statements on the card = the same statements in the port on the CPU
    t0 = time.perf_counter()
    with gb.tx.config.set(platform="cpu"):
        host_res = {k: tx_statements(gb, *ops) for k, ops in operands().items()}
    t_cpu = time.perf_counter() - t0

    def flat(x):
        return [y for z in x for y in flat(z)] if isinstance(x, (list, tuple)) else [x]

    for k in card:
        for name, got in card[k].items():
            for g_, w_ in zip(flat(got), flat(host_res[k][name]), strict=True):
                require(on_card(g_) and g_._sparse is None, f"6i {k} {name}: not dense-masked on the card")
                require((g_.dtype, g_.shape) == (w_.dtype, w_.shape), f"6i {k} {name}: dtype or shape")
                gc, wc = g_.to_coo(), w_.to_coo()
                require(all(np.array_equal(a, b) for a, b in zip(gc, wc)), f"6i {k} {name}: card != CPU")

    # Matrix Market through a temporary file
    g14 = rmat(14, 16, seed=5, weighted=True)
    v14 = g14.valid.cpu().numpy()
    M14 = Matrix.from_coo(*(a.cpu().numpy()[v14] for a in (g14.src, g14.dst, g14.weights)), dtypes.FP32, nrows=g14.n, ncols=g14.n, dup_op=binary.plus)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rmat14.mtx")
        host("mmwrite rmat 14", lambda: gb.io.mmwrite(path, M14))
        mtx_mib = os.path.getsize(path) / 2**20
        M14b = host("mmread rmat 14", lambda: gb.io.mmread(path))
    require(M14b._sparse is not None and on_card(M14b), "6i mmread: not sparse on the card")
    (ar, ac, av), (br, bc, bv) = M14.to_coo(), M14b.to_coo()
    require(np.array_equal(ar, br) and np.array_equal(ac, bc) and np.array_equal(av, bv.astype(np.float32)), "6i mmread != the matrix written")

    # card ms of the tx statements (a warm call each; CUDA events)
    A32 = dense_ops["FP32"][0]
    ms = {
        "scan plus rows": cuda_ms(torch, lambda: A32.tx.scan("plus"), 3),
        "scan plus columns": cuda_ms(torch, lambda: A32.tx.scan("plus", "columnwise"), 3),
        "sort lt": cuda_ms(torch, lambda: A32.tx.sort("lt"), 3),
        "selectk largest 8": cuda_ms(torch, lambda: A32.tx.selectk("largest", 8), 3),
        "compactify smallest": cuda_ms(torch, lambda: A32.tx.compactify("smallest", tx_n // 2), 3),
        "flatten+reshape": cuda_ms(torch, lambda: A32.tx.flatten().tx.reshape(tx_n // 2, 2 * tx_n), 3),
        "split+concat": cuda_ms(torch, lambda: gb.tx.concat(A32.tx.split(tx_n // 4)), 3),
    }
    say(
        "6i interop",
        f"scale 19 as scipy CSR ({A.nvals} entries, duplicates summed): sparse on the card, to_scipy_sparse = its "
        f"indptr/indices/data; GBTX ({len(blob) / 2**20:.1f} MiB, none) and pickle ({len(pk) / 2**20:.1f} MiB) round "
        f"trips sparse on the card, isequal; mxv plus_times on the three bit for bit, = scipy float64 (max rel err "
        f"{mxv_err:.3e} < 1e-4); launches {launches}; tx on the scale-19 matrix: sort = A[r, permutation] ascending, "
        f"selectk largest 1 and scan max = the row maxima; scan plus's row totals off the float64 sums by up to "
        f"{plus_err:.3e} relative, = the reference's float32 running-sum formula bit for bit (ported as it is); "
        f"Matrix Market rmat 14 ({M14.nvals} entries, {mtx_mib:.1f} MiB) read back equal; "
        f"{sum(len(v) for v in card.values())} tx statements at {tx_n}^2 (INT64, FP32; export/import_any at "
        f"{e_n}^2) on the card = the CPU run ({t_cpu:.1f} s); host s "
        f"{json.dumps(secs)}; card ms (FP32) {json.dumps(ms)}; on {smi}; phase {time.perf_counter() - t_phase:.1f} s",
    )
    return {"launches": launches, "plain": plain, "secs": secs, "ms": ms}


MESH_SHAPE = (2, 4)  # phase 6p's mesh: 8 shards on one card, the tests' and example 08's
MESH_N = 4096  # SUMMA's operands in phase 6p (n^2 cells, the dense-masked limit)
MESH_PR_ITERS = 50
MESH_DSL_PR_ITERS = 5  # example 07's iterations inside and outside the Context
MESH_RES_DENSITY = 0.7  # phase 6p (i): the FP64 operands' structure (seed 61)
MESH_LOOP_ITERS = 10  # phase 6p (i): the compiled DSL PageRank's iterations inside and outside the Context
MESH_INT_N = 2048  # phase 6p (i): SUMMA's INT32 plus_times operands (gb_imatmul a shard)


def mesh_dryrun(gb, np, torch, ctx):
    """The checks of ``__graft_entry__.dryrun_multichip`` on the port's mesh,
    at the dryrun's sizes (m = 8 pi, k = 8 pj; numpy seed 0 in its order):
    each against its numpy comparison (rtol 1e-4, as there); check 6 holds
    the mask/accum/replace statement to the one outside the Context within
    rel 1e-6 (the f32 partial sums fold in another order)."""
    from graphblas_tpu_torch import Matrix, Vector, binary, dtypes, parallel, semiring
    from graphblas_tpu_torch.models import rmat

    mesh = ctx.mesh
    pi, pj = (mesh.shape[a] for a in mesh.axis_names)
    m, k = 8 * pi, 8 * pj
    rng = np.random.default_rng(0)
    F = dtypes.FP32
    A = Matrix.from_dense(rng.random((m, k)), missing_value=None, dtype=F)
    B = Matrix.from_dense(rng.random((k, m)), dtype=F)
    x = Vector.from_dense(rng.random(k).astype(np.float32))
    with ctx:
        parallel.shard_matrix(A)
        parallel.shard_vector(x)
    a_np, b_np, x_np = (t._values.cpu().numpy() for t in (A, B, x))
    with ctx:
        C = A.mxm(B, semiring.plus_times).new()
    np.testing.assert_allclose(C._values.cpu().numpy(), a_np @ b_np, rtol=1e-4)
    cv, _ = parallel.summa_mxm(A, B, semiring.plus_times[F], F, mesh)
    np.testing.assert_allclose(np.asarray(cv), a_np @ b_np, rtol=1e-4)
    yv, _ = parallel.summa_mxv(A, x, semiring.min_plus[F], F, mesh)
    np.testing.assert_allclose(np.asarray(yv), (a_np + x_np[None, :]).min(axis=1), rtol=1e-4)
    g = rmat(6, 4, seed=1, weighted=True)
    src, dst, w, valid = (t.cpu().numpy() for t in (g.src, g.dst, g.weights, g.valid))
    total = max(mesh.size, -(-len(src) // mesh.size) * mesh.size)
    src, dst, w, valid = (np.pad(a, (0, total - len(src))) for a in (src, dst, w, valid))
    want = np.zeros(g.n, np.float32)
    np.add.at(want, dst[valid], w[valid])
    dev = mesh.device_list()[0]
    ones = torch.ones(g.n, device=dev)
    step = parallel.sharded_spmv_step(mesh, g.n)
    y = step(*(torch.from_numpy(a).to(dev) for a in (src, dst, w, valid)), ones)
    np.testing.assert_allclose(y.cpu().numpy(), want, rtol=1e-4)
    splan = parallel.build_sharded_spmv_plan(src[valid].astype(np.int64), dst[valid].astype(np.int64), w[valid], n=g.n, mesh=mesh)
    np.testing.assert_allclose(parallel.sharded_spmv(splan, ones).cpu().numpy(), want, rtol=1e-4)
    r, iters = parallel.sharded_pagerank(splan)
    require(abs(float(r.sum()) - 1.0) < 1e-3 and iters > 1, "dryrun: sharded pagerank")
    ns = 96
    rs, cs = rng.integers(0, ns, 600), rng.integers(0, ns, 600)
    lo, hi = np.minimum(rs, cs), np.maximum(rs, cs)
    keep = lo != hi
    with gb.tx.config.set(dense_limit=0):
        L = Matrix.from_coo(hi[keep], lo[keep], np.float32(1.0), F, nrows=ns, ncols=ns, dup_op=binary.first)
        U = L.T.new()
    single = L.mxm(U, semiring.plus_pair).new(mask=L.S)
    with ctx:
        meshed = L.mxm(U, semiring.plus_pair).new(mask=L.S)
    require(single.isequal(meshed, check_dtype=True), "dryrun: masked SpGEMM inside the Context != outside")
    Ms = rng.random((m, m)) < 0.5
    M = Matrix.from_dense(np.where(Ms, rng.random((m, m)).astype(np.float32), 0.0), dtype=F)
    M._struct = torch.from_numpy(Ms).to(dev)
    C0 = Matrix.from_dense(rng.random((m, m)), dtype=F)
    C1 = C0.dup()
    C0(M.S, accum=binary.plus, replace=True) << A.mxm(B, semiring.plus_times)
    with ctx:
        C1(M.S, accum=binary.plus, replace=True) << A.mxm(B, semiring.plus_times)
    require(C0.isclose(C1, rel_tol=1e-6, check_dtype=True), "dryrun: mask/accum/replace inside the Context != outside")
    return float(meshed.reduce_scalar("plus").new().value)


def mesh_phase(torch, np, dev, g, plan, src, dst, w, outdeg, sources, lv_ref, L_tc, U_tc, tc_ref, sg_tc, A07, smi):
    """Phase 6p (the mesh layer): a 2 x 4 mesh of 8 shards on one card,
    ``parallel.Context(devices=[cuda:0] * 8, shape=(2, 4))``, at full size:
    (a) the sharded plan of the scale-19 graph; (b) sharded SpMV and masked
    SpMV against the single-device engine on bench.py's plan; (c) the
    sharded PageRank, level BFS and SSSP against models.fast (and the scipy
    levels); (d) example 07's and 02's statements on the sparse collection
    inside and outside the Context; (e) SUMMA at 4096^2; (f) the sharded
    masked SpGEMM on bench.py's triangle workload in 8 row blocks; the
    dryrun's checks; (g) the launches of everything run inside the mesh
    (every kernel reached > 0, no plain version); (h) card times.  Returns
    the mesh path's launch and plain-call counts."""
    import graphblas_tpu_torch as gb
    from graphblas_tpu_torch import Vector, binary, dtypes, kernels, parallel, semiring, unary
    from graphblas_tpu_torch.kernels import tropical as kt
    from graphblas_tpu_torch.models import fast
    from graphblas_tpu_torch.ops import densemasked as dm
    from graphblas_tpu_torch.ops import fastspmv as fs
    from graphblas_tpu_torch.parallel import _collectives, blocks
    from graphblas_tpu_torch.parallel.spgemm import sharded_masked_mxm_arrays

    t_phase = time.perf_counter()
    n = g.n
    FP32 = dtypes.FP32
    ctx = parallel.Context(devices=[dev] * (MESH_SHAPE[0] * MESH_SHAPE[1]), shape=MESH_SHAPE)
    mesh = ctx.mesh
    require(mesh.size == 8 and all(d == dev for d in mesh.device_list()), "the mesh: 8 shards on the card")
    gen = torch.Generator(device=dev)
    gen.manual_seed(61)
    xv = torch.rand(n, generator=gen, device=dev) + 0.5
    xs = torch.rand(n, generator=gen, device=dev) < 0.3
    sa = torch.rand(MESH_N, MESH_N, generator=gen, device=dev)
    sb = torch.rand(MESH_N, MESH_N, generator=gen, device=dev)
    ss_a = torch.rand(MESH_N, MESH_N, generator=gen, device=dev) < 0.5
    ss_b = torch.rand(MESH_N, MESH_N, generator=gen, device=dev) < 0.5
    spmvs = (("plus", "times"), ("max", "first"), ("min", "plus"))
    masked = (("plus", "times"), ("min", "secondi"))
    srs = {"plus_times": semiring.plus_times[FP32], "min_plus": semiring.min_plus[FP32]}
    damping = 0.85

    def pagerank07(iters):
        # example 07's statements (as phase 6s writes them, ranks in FP32)
        outd = A07.reduce_rowwise(binary.plus).new(FP32)
        inv_deg = outd.apply(unary.minv).new()
        rank = Vector.from_dense(np.full(n, 1.0 / n, np.float32))
        for _ in range(iters):
            contrib = rank.ewise_mult(inv_deg, binary.times).new()
            pulled = contrib.vxm(A07, semiring.plus_first).new()
            dangling = float(rank.reduce(binary.plus).new().value) - float(
                contrib.ewise_mult(outd, binary.times).reduce(binary.plus).new().value
            )
            rank = pulled.apply(binary.times, right=damping).apply(
                binary.plus, right=(1.0 - damping) / n + damping * dangling / n
            ).new(FP32)
        return rank

    def bfs02(s):
        # example 02's statements
        levels = Vector(dtypes.INT64, n)
        frontier = Vector(dtypes.BOOL, n)
        frontier[s] = True
        levels[s] = 0
        level = 0
        while frontier.nvals > 0:
            level += 1
            frontier(~levels.S, replace=True) << A07.T.mxv(frontier, semiring.any_pair)
            levels(frontier.S) << frontier.apply(lambda x: 0 * x + level).new(dtypes.INT64)
        return levels

    # (a)-(f) inside the mesh: the launches counted from here
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    splan = parallel.build_sharded_spmv_plan(src, dst, w, n=n, mesh=mesh)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    per_shard = [int(p.valid_dst_order.sum()) for p in splan.plans]
    got = {}
    for add, mul in spmvs:
        got[f"spmv {add}/{mul}"] = parallel.sharded_spmv(splan, xv, add, mul)
    for add, mul in masked:
        got[f"spmv_masked {add}/{mul}"] = parallel.sharded_spmv_masked(splan, xv, xs, add, mul)
    got["pagerank"], pr_it = parallel.sharded_pagerank(splan, tol=0.0, max_iters=MESH_PR_ITERS, outdeg=torch.from_numpy(outdeg).to(dev))
    got["bfs"] = parallel.sharded_bfs_level(splan, sources[0])
    got["sssp"] = parallel.sharded_sssp(splan, sources[0])
    t0 = time.perf_counter()
    with ctx:
        got["pagerank07"] = pagerank07(MESH_DSL_PR_ITERS)
        got["bfs02"] = bfs02(sources[0])
    torch.cuda.synchronize()
    t_dsl = time.perf_counter() - t0
    tr0 = kernels.launch_counts()["tropical_mxm"]
    got["summa min_plus"] = parallel.summa_mxm_arrays(sa, ss_a, sb, ss_b, srs["min_plus"], FP32, mesh)
    torch.cuda.synchronize()
    summa_trop = kernels.launch_counts()["tropical_mxm"] - tr0
    got["summa plus_times"] = parallel.summa_mxm_arrays(sa, ss_a, sb, ss_b, srs["plus_times"], FP32, mesh)
    t0 = time.perf_counter()
    tc_rows, tc_cols, tc_vals, tc_flops = sharded_masked_mxm_arrays(
        L_tc, U_tc, L_tc.rows, L_tc.cols, semiring.plus_pair[FP32], FP32, ctx
    )
    torch.cuda.synchronize()
    t_spgemm = time.perf_counter() - t0
    tri_dry = mesh_dryrun(gb, np, torch, ctx)
    torch.cuda.synchronize()
    launches, plain = kernels.launch_counts(), kernels.plain_counts()

    # the references, outside the mesh and outside the counts
    for add, mul in spmvs:
        a, b = got[f"spmv {add}/{mul}"], fs.spmv(plan, xv, add, mul)
        if add == "plus":
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
        else:
            require(same_bits(torch, a, b), f"sharded spmv {add}/{mul} != single device")
    for add, mul in masked:
        (av, as_), (bv, bs) = got[f"spmv_masked {add}/{mul}"], fs.spmv_masked(plan, xv, xs, add, mul)
        require(torch.equal(as_, bs), f"sharded spmv_masked {add}/{mul}: structure != single device")
        if add == "plus":
            torch.testing.assert_close(av, bv, rtol=1e-5, atol=0)
        else:
            require(torch.equal(av, bv), f"sharded spmv_masked {add}/{mul} != single device")
    pr_ref = fast.pagerank(plan, outdeg, n, tol=0.0, max_iters=MESH_PR_ITERS)
    # tol 0 stops early only at a float32 fixpoint (no rank changed)
    require(1 < pr_it <= MESH_PR_ITERS and bool(torch.isfinite(got["pagerank"]).all()), "sharded pagerank: iterations or non-finite")
    torch.testing.assert_close(got["pagerank"], pr_ref, rtol=1e-5, atol=0)
    pr_err = abs_err(got["pagerank"], pr_ref)
    require(torch.equal(got["bfs"], fast.bfs_level(plan, sources[0], n)), "sharded bfs_level != models.fast")
    np.testing.assert_array_equal(got["bfs"].cpu().numpy(), lv_ref[0], err_msg="sharded bfs_level != scipy")
    require(same_bits(torch, got["sssp"], fast.sssp(plan, sources[0], n)), "sharded sssp != models.fast bit for bit")
    pr_out = pagerank07(MESH_DSL_PR_ITERS)
    pi, pv = got["pagerank07"].to_coo()
    qi, qv = pr_out.to_coo()
    require(np.array_equal(pi, qi), "example 07 inside the Context: pattern != outside")
    np.testing.assert_allclose(pv, qv, rtol=1e-5, atol=0)
    require(got["bfs02"].isequal(bfs02(sources[0])), "example 02 inside the Context != outside")
    require(len(A07._sparse._sharded_plans) == 1, "example 07 inside the Context: no sharded plan was built")
    for name, sr in srs.items():
        cv, cs = (blocks.whole(t) for t in got[f"summa {name}"])
        require(got[f"summa {name}"][0].spec == ("i",), f"SUMMA {name}: the product is not placed P(i,)")
        dv, ds = dm.mxm(sa, ss_a, sb, ss_b, sr, FP32)
        require(torch.equal(cs, ds), f"SUMMA {name}: structure != single device")
        if name == "plus_times":
            torch.testing.assert_close(cv, dv, rtol=1e-5, atol=0)
            summa_pt_err = abs_err(cv, dv)
        else:
            require(same_bits(torch, cv, dv), "SUMMA min_plus != single device bit for bit")
    require(summa_trop == 8, f"SUMMA min_plus: {summa_trop} gb_tropical launches, not one a shard")
    acc, hit, fl = sg_tc
    keep = hit.cpu().numpy()
    require(np.array_equal(tc_rows, L_tc.rows[keep]) and np.array_equal(tc_cols, L_tc.cols[keep]), "sharded SpGEMM: entries != single device")
    require(np.array_equal(tc_vals.view(np.int32), acc.cpu().numpy()[keep].view(np.int32)), "sharded SpGEMM: values != single device")
    tri = int(tc_vals.astype(np.float64).sum())
    require(tri == tc_ref and tc_flops == int(fl), f"sharded SpGEMM: {tri} triangles, scipy {tc_ref}")
    for name in ("gather", "segscan_contrib_gather", "segscan_contrib", "segscan", "eqjoin", "tropical_mxm"):
        require(launches[name] > 0, f"mesh path: {name} was not launched")
    require(not any(plain.values()), f"mesh path: plain versions ran: {plain}")
    say(
        "6p mesh",
        f"mesh {mesh.shape} on {dev} x8; (a) build_sharded_spmv_plan host {t_build:.2f} s, edges a shard {per_shard}, "
        f"pad_to {splan.plans[0].e_pad} (x8 = {8 * splan.plans[0].e_pad} slots against the single plan's {plan.e_pad}), "
        f"{splan.nbytes() / 2**20:.1f} MiB on the card; (b) sharded spmv {[f'{a}/{m}' for a, m in spmvs]} and spmv_masked "
        f"{[f'{a}/{m}' for a, m in masked]} = single device (plus rtol 1e-5, the rest bit for bit); (c) pagerank "
        f"({pr_it} of {MESH_PR_ITERS} it) = models.fast ({MESH_PR_ITERS} it) rtol 1e-5 (max_abs_err={pr_err!r}), bfs_level and sssp from {sources[0]} = "
        f"models.fast bit for bit, levels = scipy; (d) example 07 ({MESH_DSL_PR_ITERS} it, rtol 1e-5) and example 02 inside "
        f"the Context = outside ({t_dsl:.2f} s inside); (e) SUMMA {MESH_N}^2: min_plus bit for bit on {summa_trop} gb_tropical "
        f"launches, plus_times rtol 1e-5 (max_abs_err={summa_pt_err!r}); (f) sharded SpGEMM, 8 row blocks: {tri} "
        f"triangles = single device = scipy ({t_spgemm:.2f} s with the host analyses); dryrun checks passed "
        f"(tc {tri_dry}); (g) launches {launches}, plain {plain}",
    )

    # (h) card times (CUDA events, warm)
    ms = {}
    ms["sharded spmv plus_times"] = cuda_ms(torch, lambda: parallel.sharded_spmv(splan, xv, "plus", "times"), 20)
    ms["single spmv plus_times"] = cuda_ms(torch, lambda: fs.spmv(plan, xv, "plus", "times"), 20)
    parts = [fs.spmv(p, xv, "plus", "times") for p in splan.plans]
    ms["combine (psum of 8 n-vectors)"] = cuda_ms(torch, lambda: _collectives.psum(parts, dev), 20)
    od = torch.from_numpy(outdeg).to(dev)
    # tol -1: exactly 10 iterations, each still reading its change to the host
    ms["sharded pagerank iteration"] = cuda_ms(torch, lambda: parallel.sharded_pagerank(splan, tol=-1.0, max_iters=10, outdeg=od), 2) / 10
    ms["models.fast pagerank iteration"] = cuda_ms(torch, lambda: fast.pagerank(plan, outdeg, n, tol=0.0, max_iters=10), 2) / 10
    ms[f"summa min_plus {MESH_N}^2"] = cuda_ms(torch, lambda: parallel.summa_mxm_arrays(sa, ss_a, sb, ss_b, srs["min_plus"], FP32, mesh), 3)
    ms[f"gb_tropical {MESH_N}^3 (one launch)"] = cuda_ms(torch, lambda: kt.tropical_mxm(sa, sb, "min", "plus"), 3)
    say("6p mesh", f"times (CUDA events, ms): {json.dumps({k: round(v, 4) for k, v in ms.items()})} on {smi}; phase {time.perf_counter() - t_phase:.1f} s")

    # (i) the resident shards: placed collections stay on their shards
    res = resident_shards(torch, np, dev, ctx, sa, ss_a, sb, ss_b, A07, smi)
    launches = {k: launches.get(k, 0) + res["launches"].get(k, 0) for k in set(launches) | set(res["launches"])}
    plain = {k: plain.get(k, 0) + res["plain"].get(k, 0) for k in set(plain) | set(res["plain"])}
    return {"launches": launches, "plain": plain, "ms": ms, "resident": res}


def resident_shards(torch, np, dev, ctx, sa, ss_a, sb, ss_b, A07, smi):
    """Phase 6p (i): placed collections keep their blocks on the shards
    (``parallel.blocks``).  On the phase's 2 x 4 mesh of 8 shards on the
    card, at MESH_N^2 FP64 (structure density MESH_RES_DENSITY, seed 61):
    each family on placed operands against the same statement on unplaced
    ones on one device (bit for bit; FP64 plus reductions rtol 1e-12), its
    output placed with the reference's spec, no gather inside the statement,
    both timed by CUDA events; SUMMA min_plus (FP32, gb_tropical a shard)
    and INT32 plus_times (gb_imatmul a shard) leaving P(i,) products that a
    following ewise_add reads block by block; a compiled DSL PageRank of
    MESH_LOOP_ITERS iterations inside the Context on a dense graph (SUMMA)
    and on the scale-19 sparse collection (the sharded SpMV), its capture
    decision and step ms against the loop outside.  Returns the launches
    and plain calls of everything run placed."""
    import graphblas_tpu_torch as gb
    from graphblas_tpu_torch import Matrix, Vector, binary, dtypes, kernels, monoid, parallel, select, semiring, unary
    from graphblas_tpu_torch.core.base import stored
    from graphblas_tpu_torch.models import dsl, rmat
    from graphblas_tpu_torch.ops import densemasked as dm
    from graphblas_tpu_torch.parallel import blocks
    from graphblas_tpu_torch.parallel.mesh import placement

    t_phase = time.perf_counter()
    N, F64, F32, I32 = MESH_N, dtypes.FP64, dtypes.FP32, dtypes.INT32
    gen = torch.Generator(device=dev)
    gen.manual_seed(61)

    def dense(shape, density=MESH_RES_DENSITY):
        v = torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)
        st = torch.rand(shape, generator=gen, device=dev) < density
        return (Matrix if len(shape) == 2 else Vector)._from_arrays(torch.where(st, v, 0.0), st, F64)

    single = {"A": dense((N, N)), "B": dense((N, N)), "M": dense((N, N), 0.5), "C": dense((N, N)), "u": dense((N,)), "w": dense((N,))}
    placed = {}
    with ctx:
        for k, x in single.items():
            placed[k] = (parallel.shard_matrix if x.ndim == 2 else parallel.shard_vector)(x.dup())

    def merge(A, B, M, C, u, w):
        D = C.dup()
        D(M.V, accum=binary.plus, replace=True) << A.ewise_add(B, binary.max)
        return D

    ij, i_, j_ = ("i", "j"), ("i",), ("j",)
    statements = [  # name, statement, the reference's spec (None: a host scalar), rtol (None: bit for bit)
        ("ewise_add(plus)", lambda A, B, M, C, u, w: A.ewise_add(B, binary.plus).new(), ij, None),
        ("ewise_mult(times)", lambda A, B, M, C, u, w: A.ewise_mult(B, binary.times).new(), ij, None),
        ("ewise_union(minus, 1.5, -2.0)", lambda A, B, M, C, u, w: A.ewise_union(B, binary.minus, 1.5, -2.0).new(), ij, None),
        ("apply(ainv)", lambda A, B, M, C, u, w: A.apply(unary.ainv).new(), ij, None),
        ("select(valuegt, 0.5)", lambda A, B, M, C, u, w: A.select(select.valuegt, 0.5).new(), ij, None),
        ("C(M.V, accum=plus, replace) << A.ewise_add(B, max)", merge, ij, None),
        ("reduce_rowwise(plus)", lambda A, B, M, C, u, w: A.reduce_rowwise("plus").new(), i_, 1e-12),
        ("reduce_columnwise(max)", lambda A, B, M, C, u, w: A.reduce_columnwise("max").new(), j_, None),
        ("reduce_scalar(plus)", lambda A, B, M, C, u, w: A.reduce_scalar("plus").new(), None, 1e-12),
        ("Vector ewise_add(plus)", lambda A, B, M, C, u, w: u.ewise_add(w, binary.plus).new(), j_, None),
        ("Vector reduce(plus)", lambda A, B, M, C, u, w: u.reduce("plus").new(), None, 1e-12),
        ("Vector reduce(min)", lambda A, B, M, C, u, w: u.reduce(monoid.min).new(), None, None),
    ]
    args_p = [placed[k] for k in "ABMCuw"]
    args_1 = [single[k] for k in "ABMCuw"]

    def agree(name, got, want, rtol):
        if got.ndim == 0:
            a, b = np.asarray(got.value), np.asarray(want.value)
            ok = np.array_equal(a, b) if rtol is None else bool(np.allclose(a, b, rtol=rtol, atol=0))
            require(ok, f"6p (i) {name}: placed {a!r} != one device {b!r}")
            return 0.0 if rtol is None else float(abs(a - b))
        gv, gs = (blocks.whole(t) for t in stored(got))
        wv, ws = want._values, want._struct
        require(torch.equal(gs, ws), f"6p (i) {name}: structure != one device")
        if rtol is None:
            require(same_bits(torch, gv, wv), f"6p (i) {name}: values != one device bit for bit")
            return 0.0
        torch.testing.assert_close(gv, wv, rtol=rtol, atol=0)
        return abs_err(gv, wv)

    rows = {}
    for name, fn, spec, rtol in statements:
        g0 = blocks.counts()["gathers"]
        with ctx:
            got = fn(*args_p)
        torch.cuda.synchronize()
        moved = blocks.counts()["gathers"] - g0
        require(moved == 0, f"6p (i) {name}: {moved} gathers inside the statement")
        if spec is None:
            require(got.ndim == 0, f"6p (i) {name}: not a scalar")
        else:
            pl = placement(got)
            require(pl is not None and pl[1] == spec and pl[0] is ctx.mesh, f"6p (i) {name}: placed as {pl}, the reference's spec is {spec}")
        err = agree(name, got, fn(*args_1), rtol)

        def run_placed(fn=fn):
            with ctx:
                fn(*args_p)

        t_p = cuda_ms(torch, run_placed, 5)
        t_1 = cuda_ms(torch, lambda fn=fn: fn(*args_1), 5)
        rows[name] = {"spec": spec, "placed_ms": t_p, "single_ms": t_1, "ratio": t_p / t_1, "max_abs_err": err}
    # SUMMA's products stay placed, and the next statement reads their blocks
    SA, SB = (Matrix._from_arrays(v, st, F32) for v, st in ((sa, ss_a), (sb, ss_b)))
    ia = (torch.rand(MESH_INT_N, MESH_INT_N, generator=gen, device=dev) * 100).to(torch.int32)
    ib = (torch.rand(MESH_INT_N, MESH_INT_N, generator=gen, device=dev) * 100).to(torch.int32)
    ist = torch.rand(MESH_INT_N, MESH_INT_N, generator=gen, device=dev) < MESH_RES_DENSITY
    IA, IB = (Matrix._from_arrays(torch.where(ist, v, 0), ist, I32) for v in (ia, ib))
    with ctx:
        SA_p, SB_p, IA_p, IB_p = (parallel.shard_matrix(x.dup()) for x in (SA, SB, IA, IB))
    kernels.reset_counts()
    g0 = blocks.counts()["gathers"]
    with ctx:
        P_min = SA_p.mxm(SB_p, semiring.min_plus).new()
        P_min2 = P_min.ewise_add(P_min, binary.plus).new()
        P_int = IA_p.mxm(IB_p, semiring.plus_times).new()
        P_int2 = P_int.ewise_add(P_int, binary.plus).new()
    torch.cuda.synchronize()
    launches, plain = kernels.launch_counts(), kernels.plain_counts()
    summa_trop, summa_int = launches["tropical_mxm"], launches["imatmul"]
    require(blocks.counts()["gathers"] == g0, "6p (i) SUMMA: a gather inside the products or the statements after them")
    for x, what in ((P_min, "min_plus"), (P_min2, "min_plus + ewise_add"), (P_int, "INT32 plus_times"), (P_int2, "INT32 + ewise_add")):
        require(placement(x)[1] == ("i",), f"6p (i) SUMMA {what}: placed as {placement(x)}, not P(i,)")
    require(summa_trop == 8 and summa_int == 8, f"6p (i) SUMMA: {summa_trop} gb_tropical and {summa_int} gb_imatmul launches, not one a shard")
    for x, (a, b, st_a, st_b, sr, T) in ((P_min, (sa, sb, ss_a, ss_b, semiring.min_plus[F32], F32)), (P_int, (torch.where(ist, ia, 0), torch.where(ist, ib, 0), ist, ist, semiring.plus_times[I32], I32))):
        dv, ds = dm.mxm(a, st_a, b, st_b, sr, T)
        gv, gs = (blocks.whole(t) for t in stored(x))
        require(torch.equal(gs, ds) and same_bits(torch, gv, dv), f"6p (i) SUMMA {sr.name}: != one device bit for bit")

    # compiled DSL PageRank inside the Context: dense (SUMMA) and sparse (sharded SpMV)
    g12 = rmat(12, 16, seed=61, device=dev)
    keep = g12.valid.cpu().numpy()
    AT_d = Matrix.from_coo(g12.dst.cpu().numpy()[keep], g12.src.cpu().numpy()[keep], 1.0, F32, nrows=g12.n, ncols=g12.n, dup_op=binary.first)
    require(AT_d._sparse is None, "6p (i) the dense graph is not in the dense format")
    AT_s = A07.T.new()
    loops = {}
    for tag, AT, cfg in (("dense, SUMMA", AT_d, {}), ("scale-19 sparse, sharded SpMV", AT_s, {"mxv_strategy": "plan"})):
        with gb.tx.config.set(**cfg):
            outside = dsl.pagerank_runner(AT, max_iters=MESH_LOOP_ITERS)
            want = outside()
            with ctx:
                ATp = AT
                if AT._sparse is None:
                    ATp = parallel.shard_matrix(AT.dup())
                kernels.reset_counts()
                inside = dsl.pagerank_runner(ATp, max_iters=MESH_LOOP_ITERS)
                before = blocks.counts()
                got = inside()
                torch.cuda.synchronize()
                run_counts = {k: v - before[k] for k, v in blocks.counts().items()}
                loop_launches = kernels.launch_counts()
                loop_plain = kernels.plain_counts()
                t_in = cuda_ms(torch, inside, 3) / MESH_LOOP_ITERS
            t_out = cuda_ms(torch, outside, 3) / MESH_LOOP_ITERS
        require(run_counts["gathers"] == 0, f"6p (i) compiled PageRank ({tag}): {run_counts['gathers']} gathers in a run")
        gv = got._values
        torch.testing.assert_close(gv, want._values, rtol=1e-5, atol=0)
        launches = {k: launches.get(k, 0) + loop_launches.get(k, 0) for k in set(launches) | set(loop_launches)}
        plain = {k: plain.get(k, 0) + loop_plain.get(k, 0) for k in set(plain) | set(loop_plain)}
        loops[tag] = {
            "mode": inside.mode, "capture": inside.capture, "capture_reason": inside.capture_reason,
            "placed": placement(got)[1] if placement(got) else None, "run_counts": run_counts,
            "step_ms_inside": t_in, "step_ms_outside": t_out, "ratio": t_in / t_out,
            "max_abs_err": abs_err(gv, want._values), "launches": {k: v for k, v in loop_launches.items() if v},
        }
    for tag, loop in loops.items():
        require(loop["capture"] == "graph", f"6p (i) compiled PageRank ({tag}) on 8 shards of one card: capture {loop}")
    require(loops["dense, SUMMA"]["placed"] == ("i",), "6p (i) compiled PageRank: the rank vector is not P(i,)")
    for name in ("gather", "segscan_contrib_gather"):
        require(loops["scale-19 sparse, sharded SpMV"]["launches"].get(name, 0) > 0, f"6p (i) compiled sparse PageRank: {name} was not launched")
    require(not any(plain.values()), f"6p (i): plain versions ran: {plain}")
    say(
        "6p mesh",
        f"(i) resident shards on {smi}, {N}^2 FP64 seed 61: "
        + "; ".join(
            f"{k}: {r['spec']} placed {r['placed_ms']:.4f} ms, one device {r['single_ms']:.4f} ms, ratio {r['ratio']:.2f}, "
            f"max_abs_err={r['max_abs_err']!r}"
            for k, r in rows.items()
        )
        + f"; SUMMA min_plus {N}^2 FP32 and INT32 plus_times {MESH_INT_N}^2 left P(i,) products ({summa_trop} gb_tropical, "
        f"{summa_int} gb_imatmul launches) and ewise_add read them block by block, bit for bit with one device, no gather; "
        f"compiled DSL PageRank, {MESH_LOOP_ITERS} it: {json.dumps(loops)}; launches {launches}; phase {time.perf_counter() - t_phase:.1f} s",
    )
    return {"launches": launches, "plain": plain, "rows": rows, "loops": loops}


BENCH_KEYS_SHARED = (
    "pagerank_gteps_per_iter", "bfs_gteps", "sssp_gteps", "pagerank_iter_ms", "bfs_ms", "sssp_ms",
    "masked_spgemm_gflops", "tropical_mxm_tops",
)
BENCH_MODES = ("dsl_pagerank_mode", "dsl_bfs_mode", "dsl_bfs_dense_mode", "dsl_sssp_mode", "cc_mode")


def bench_phase(torch, np, dev, scale, ef, seed, src, dst, w, n, lv_ref, dsl_6c, smi):
    """Phase 6b (the bench entry point): ``graphblas_tpu_torch.bench.main
    (["--device", "cuda"])`` in this process, (a) cold against a fresh cache
    under chiprun_out/ (the graph, its plan and the DSL plans built by
    tools.build_plan), (b) warm against the same cache: no SpmvPlan built
    (build_spmv_plan counted), one JSON line each, every key of the
    reference bench's set, every rate finite and > 0, the SpGEMM mask's
    2,195,327 entries, bfs_levels = the scipy oracle's from the first
    source, the *_mode strings and cc_iters = phase 6c's; (c) the background
    plan build: on a fresh sparse collection of the scale-19 graph under
    "auto", eager A.mxv(x) statements (plus_times and min_plus in turn, a
    CUDA graph captured between two: a CUDA call from the build's thread
    would break it) until the plan is ready, then on the plan: the generic
    results = the plan's (plus_times rtol 1e-5, min_plus bit for bit); the
    time to the first result with the background build and with
    GRAPHBLAS_TPU_PLAN_BACKGROUND=0, the statements served on the generic
    path, the ms of a statement during the build and after it; (d) the
    warm run's launches: G, fill, C, S, the generic scan, eqjoin and
    gb_tropical each > 0, no plain version.  Returns the warm run's launch
    and plain-call counts and its detail."""
    import contextlib
    import io
    import shutil

    import graphblas_tpu_torch as gb
    from graphblas_tpu_torch import Matrix, Vector, bench, binary, dtypes, kernels, semiring
    from graphblas_tpu_torch.ops import fastspmv as fs
    from graphblas_tpu_torch.tools.build_plan import env_set

    t_phase = time.perf_counter()
    cache = os.path.join(REPO, "chiprun_out", "bench_cache")
    shutil.rmtree(cache, ignore_errors=True)
    plan_cache_before = os.environ.get("GRAPHBLAS_TPU_PLAN_CACHE")
    build = fs.build_spmv_plan
    builds = []

    def counting(*a, **k):
        builds.append(1)
        return build(*a, **k)

    def run_bench():
        buf = io.StringIO()
        env = (("GRAPHBLAS_BENCH_CACHE", cache), ("GRAPHBLAS_BENCH_SCALE", str(scale)), ("GRAPHBLAS_BENCH_EF", str(ef)))
        with contextlib.ExitStack() as stack:
            for k, v in env:
                stack.enter_context(env_set(k, v))
            stack.enter_context(contextlib.redirect_stdout(buf))
            t0 = time.perf_counter()
            res = bench.main(["--device", "cuda"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        require(len(lines) == 1 and json.loads(lines[0]) == res, f"6b: the bench printed {len(lines)} lines, not its JSON line")
        return res, secs, lines[0]

    fs.build_spmv_plan = counting
    try:
        cold, t_cold, line_cold = run_bench()
        n_cold = len(builds)
        builds.clear()
        kernels.reset_counts()
        torch.cuda.synchronize()
        warm, t_warm, line_warm = run_bench()
        torch.cuda.synchronize()
        launches, plain = kernels.launch_counts(), kernels.plain_counts()
    finally:
        fs.build_spmv_plan = build
        shutil.rmtree(cache, ignore_errors=True)  # ~1 GiB of plans: not brought back
    require(os.environ.get("GRAPHBLAS_TPU_PLAN_CACHE") == plan_cache_before, "6b: the bench left GRAPHBLAS_TPU_PLAN_CACHE set")
    # the cold run builds the model plan and the DSL matrices' pull and push
    # plans (tools.build_plan); the DSL runs load those
    require(n_cold == 3, f"6b: the cold run built {n_cold} SpmvPlans, not 3")
    require(not builds, f"6b: the warm run built {len(builds)} SpmvPlans")
    want_modes = {k: dsl_6c[k] for k in BENCH_MODES}
    want_modes["dsl_bfs_mode"] = want_modes["dsl_bfs_mode"].split("/")[0]  # the reference's key has no layout
    for res in (cold, warm):
        d = res["detail"]
        require(set(d) == set(bench.KEYS), f"6b: detail keys {sorted(set(d) ^ set(bench.KEYS))} differ")
        require(d["platform"] == "cuda" and d["device"] == torch.cuda.get_device_name(0), f"6b: platform {d['platform']}, device {d['device']}")
        for k, v in d.items():
            if k.endswith(("_gteps", "_gteps_per_iter", "_gflops", "_tops", "_ms", "_ratio")):
                require(isinstance(v, float) and np.isfinite(v) and v > 0, f"6b: {k} = {v!r}")
        require(d["masked_spgemm_mask_nnz"] == 2195327, f"6b: masked_spgemm_mask_nnz {d['masked_spgemm_mask_nnz']}")
        if seed == bench.SEED:
            require(d["bfs_levels"] == int(lv_ref[0].max()), f"6b: bfs_levels {d['bfs_levels']} != scipy's {int(lv_ref[0].max())}")
        for k, v in want_modes.items():
            require(d[k] == v, f"6b: {k} {d[k]} != phase 6c's {v}")
        require(d["cc_iters"] == dsl_6c["cc_iters"], f"6b: cc_iters {d['cc_iters']} != phase 6c's {dsl_6c['cc_iters']}")
    for name in ("gather", "gather_fill", "segscan_contrib", "segscan_state", "segscan", "segscan_contrib_gather", "eqjoin", "tropical_mxm"):
        require(launches[name] > 0, f"6b: {name} was not launched on the bench path")
    require(not any(plain.values()), f"6b: plain versions ran on the bench path: {plain}")
    say(
        "6b bench",
        f"(a) cold run {t_cold:.2f} s of host time (3 SpmvPlans built: the model plan and the DSL's pull and "
        f"push); (b) warm run {t_warm:.2f} s, no SpmvPlan built; keys = the reference's and device, rates finite "
        f"and > 0, mask {warm['detail']['masked_spgemm_mask_nnz']} entries, bfs_levels {warm['detail']['bfs_levels']} "
        f"= scipy's, modes and cc_iters = 6c's; (d) launches {launches}, no plain version; on {smi}",
    )
    print(f"[6b bench] cold: {line_cold}", flush=True)
    print(f"[6b bench] warm: {line_warm}", flush=True)

    # (c) the background plan build on a fresh sparse collection
    FP32 = dtypes.FP32
    t0 = time.perf_counter()
    A = Matrix.from_coo(src, dst, w.astype(np.float32), FP32, nrows=n, ncols=n, dup_op=binary.plus)
    t_from_coo = time.perf_counter() - t0
    require(A._sparse is not None and A._sparse.nvals >= (1 << 17), "6b (c): A is a sparse collection past auto's 2^17")
    x = Vector.from_dense(np.random.default_rng(13).random(n).astype(np.float32))
    srs = (semiring.plus_times, semiring.min_plus)
    xt = torch.ones(1 << 20, device=dev)
    served = []  # (semiring index, ms, on the plan, values, structure)
    captures = 0
    with env_set("GRAPHBLAS_TPU_PLAN_CACHE", ""), env_set("GRAPHBLAS_TPU_PLAN_BACKGROUND", "1"), gb.tx.config.set(mxv_strategy="auto"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_first = t_ready = None
        k = 0
        while len([s for s in served if s[2]]) < 4:
            require(time.perf_counter() - t0 < 120, "6b (c): the plan was not ready after 120 s")
            g0 = kernels.launch_counts()["gather"]
            ts = time.perf_counter()
            y = A.mxv(x, srs[k % 2]).new()
            yv, ys = y._values, y._struct
            torch.cuda.synchronize()
            te = time.perf_counter()
            on_plan = kernels.launch_counts()["gather"] > g0
            t_first = te - t0 if t_first is None else t_first
            if on_plan and t_ready is None:
                t_ready = ts - t0
            served.append((k % 2, (te - ts) * 1e3, on_plan, yv, ys))
            if not on_plan:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    zt = xt * 2.0 + 1.0
                graph.replay()
                captures += 1
            k += 1
        torch.cuda.synchronize()
        n_generic = sum(1 for s in served if not s[2])
        require(n_generic >= 1 and not served[0][2], "6b (c): the first statement did not answer on the generic path")
        require(float(zt[0]) == 3.0, "6b (c): a CUDA graph captured during the build is wrong")
        require(all(s[2] for s in served[n_generic:]), "6b (c): a statement went back to the generic path")
        plan_res = {s[0]: s for s in served[n_generic:]}
        rel = 0.0
        for i, _, _, yv, ys in served[:n_generic]:
            pv, ps_ = plan_res[i][3], plan_res[i][4]
            require(torch.equal(ys, ps_), "6b (c): the generic path's structure differs from the plan's")
            if i == 0:
                # float32 sums in two orders (index_add_ against C's scan) over
                # in-degrees of thousands: the plan-against-generic tolerance of
                # tests/test_torch_sparse.py
                torch.testing.assert_close(yv, pv, rtol=1e-5, atol=0)
                rel = max(rel, float(((yv - pv).abs() / pv.abs().clamp_min(1e-30)).max()))
            else:
                require(torch.equal(yv.view(torch.int32), pv.view(torch.int32)), "6b (c): min_plus on the generic path != the plan's bit for bit")
        # the blocking build: another collection of the same pattern, no background
        B = Matrix._from_sparse(A._sparse.copy(), FP32)
        with env_set("GRAPHBLAS_TPU_PLAN_BACKGROUND", "0"):
            g0 = kernels.launch_counts()["gather"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yb = B.mxv(x, srs[0]).new()
            yb_v = yb._values
            torch.cuda.synchronize()
            t_first_blocking = time.perf_counter() - t0
        require(kernels.launch_counts()["gather"] > g0, "6b (c): GRAPHBLAS_TPU_PLAN_BACKGROUND=0 did not block on the plan")
        torch.testing.assert_close(yb_v, plan_res[0][3], rtol=1e-6, atol=0)
    during = [s[1] for s in served[:n_generic]]
    after = [s[1] for s in served[n_generic:]]
    say(
        "6b bench",
        f"(c) background plan build, scale {n.bit_length() - 1} (from_coo {t_from_coo:.2f} s): first result "
        f"{t_first * 1e3:.2f} ms with the background build against {t_first_blocking * 1e3:.2f} ms with "
        f"GRAPHBLAS_TPU_PLAN_BACKGROUND=0; {n_generic} statements on the generic path until the plan was ready at "
        f"{t_ready:.3f} s, {captures} CUDA graphs captured meanwhile; ms a statement during the build: median "
        f"{statistics.median(during):.3f} (min {min(during):.3f}, max {max(during):.3f}), after: median "
        f"{statistics.median(after):.3f} ({after}); generic = plan (plus_times rtol 1e-5, max relative error "
        f"{rel!r}; min_plus bit for bit); "
        f"phase {time.perf_counter() - t_phase:.1f} s",
    )
    return {"launches": launches, "plain": plain, "detail": warm["detail"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=19)
    ap.add_argument("--ef", type=int, default=16)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--tc-log2", type=int, default=16, help="log2 of the SpGEMM workload's vertices")
    ap.add_argument("--spgemm-scale", type=int, default=14, help="RMAT scale of the SpGEMM run (c)")
    ap.add_argument("--mt", type=int, default=2048, help="the tropical matmul's size")
    ap.add_argument("--dsl-n", type=int, default=4096, help="the DSL phase's n (n^2 cells: the dense-masked limit)")
    ap.add_argument("--dsl-generic-n", type=int, default=2048, help="the generic contraction's n in the DSL phase")
    ap.add_argument("--models-scale", type=int, default=14, help="RMAT scale of the dense models (n = 2^scale)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, REPO)
    import numpy as np

    from graphblas_tpu_torch import kernels, semiring
    from graphblas_tpu_torch.core import dtypes
    from graphblas_tpu_torch.core import sparse as sps
    from graphblas_tpu_torch.kernels import _build
    from graphblas_tpu_torch.models import fast, rmat
    from graphblas_tpu_torch.ops import fastspmv as fs
    from graphblas_tpu_torch.ops import mxm
    from graphblas_tpu_torch.ops.permute import padded_size
    from graphblas_tpu_torch.ops.scan import STATE_BIG
    from graphblas_tpu_torch.tools import profile_spgemm_roofline as roofline

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)
    say("1 device", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    say("2 build", f"nvcc {' '.join(_build.NVCC_FLAGS)}: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(_build.library_path(), REPO)}")

    # 3. kernels against their plain versions at the main path's shapes
    # (eqjoin's: the SpGEMM plans', analyzed first)
    t0 = time.perf_counter()
    L_tc, U_tc = roofline.bench_tc_workload(args.tc_log2)
    t_tc_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    tc_plan = sps.sparse_spgemm_analyze(L_tc, U_tc, L_tc.rows, L_tc.cols, bricks=True, reduce_net=True)
    t_tc_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    L_rm, U_rm = roofline.rmat_lower(args.spgemm_scale)
    rm_plan = sps.sparse_spgemm_analyze(L_rm, U_rm, L_rm.rows, L_rm.cols, reduce_net=True)
    t_plan_rm = time.perf_counter() - t0
    n_nodes = 1 << args.scale
    e_pad = padded_size(max(n_nodes * args.ef, n_nodes))
    t0 = time.perf_counter()
    kres = check_kernels(torch, e_pad, dev, tc_plan, rm_plan, args.mt, args.dsl_n, roofline)
    say("3 kernels", f"phase took {time.perf_counter() - t0:.1f} s")

    # 4. graph and plans
    t0 = time.perf_counter()
    g = rmat(args.scale, args.ef, seed=args.seed, weighted=True)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = fast.analyze(g)
    t_plan = time.perf_counter() - t0
    n = g.n
    valid = g.valid.cpu().numpy()
    src, dst, w = (a.cpu().numpy()[valid] for a in (g.src, g.dst, g.weights))
    t0 = time.perf_counter()
    plan_ne = fs.build_spmv_plan(src, dst, w, n=n, endpoints=False)
    t_plan_ne = time.perf_counter() - t0
    torch.cuda.synchronize()
    e = len(src)
    outdeg = np.bincount(src, minlength=n)
    sources = np.argsort(outdeg)[::-1][:4].tolist()  # bench.py's pick

    def gib(p):
        return sum(t.numel() * t.element_size() for t in p.arrays().values()) / 2**30

    say(
        "4 graph+plan",
        f"rmat scale {args.scale} ef {args.ef} seed {args.seed}: n={n} e={e} e_pad={plan.e_pad}; "
        f"host rmat {t_graph:.2f} s, host analyze {t_plan:.2f} s; plan on device {gib(plan):.3f} GiB; "
        f"plan without endpoint routes: host build {t_plan_ne:.2f} s, {gib(plan_ne):.3f} GiB",
    )
    require(plan.device.type == "cuda" and plan_ne.device.type == "cuda", "the builders default to the card")
    require(plan.e_pad == e_pad == plan_ne.e_pad, "plan.e_pad == e_pad")
    require(plan_ne.place_idx is None, "the second plan has no endpoint routes")

    # 5. the main path through the kernels, then the plain path on the same card
    iters = 50
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    xv = torch.rand(n, generator=gen, device=dev) + 0.5
    xs = torch.rand(n, generator=gen, device=dev) < 0.3
    spmvs = (("plus", "times"), ("min", "plus"))
    masked = (("plus", "times"), ("plus", "pair"), ("any", "secondi"))

    def main_path():
        out = {"pagerank": fast.pagerank(plan, outdeg, n, tol=0.0, max_iters=iters)}
        out["bfs"] = [fast.bfs_level(plan, s, n) for s in sources]
        out["sssp"] = fast.sssp(plan, sources[0], n)
        out["bfs_parent"] = [fast.bfs_parent(plan, s, n) for s in sources]
        for add, mul in spmvs:
            out[f"spmv {add}/{mul}"] = (fs.spmv(plan, xv, add, mul), fs.spmv(plan_ne, xv, add, mul))
        for add, mul in masked:
            out[f"spmv_masked {add}/{mul}"] = tuple(fs.spmv_masked(p, xv, xs, add, mul) for p in (plan, plan_ne))
        out["bfs_parent_ne"] = fast.bfs_parent(plan_ne, sources[0], n)
        return out

    kernels.reset_counts()
    torch.cuda.synchronize()
    got = main_path()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    plain_calls = kernels.plain_counts()
    with kernels.plain_versions():
        want = main_path()
    torch.cuda.synchronize()
    pr, pr_p = got["pagerank"], want["pagerank"]
    require(pr.shape == (n,) and bool(torch.isfinite(pr).all()), "pagerank: wrong shape or non-finite")
    torch.testing.assert_close(pr, pr_p, rtol=1e-5, atol=0)
    pr_err = abs_err(pr, pr_p)
    for s, a, b in zip(sources, got["bfs"], want["bfs"]):
        require(torch.equal(a, b), f"bfs from {s}: kernel path differs from the plain path")
    require(torch.equal(got["sssp"], want["sssp"]), "sssp: kernel path differs from the plain path")
    for s, a, b in zip(sources, got["bfs_parent"], want["bfs_parent"]):
        require(a.dtype == torch.int32 and a.shape == (n,), "bfs_parent: int32 (n,)")
        require(torch.equal(a, b), f"bfs_parent from {s}: kernel path differs from the plain path")
    par_ne = got["bfs_parent_ne"]
    require(torch.equal(par_ne, want["bfs_parent_ne"]), "bfs_parent without endpoint routes: kernel path != plain path")
    require(torch.equal(par_ne, got["bfs_parent"][0]), "bfs_parent: the non-endpoint plan differs from the v2 plan")
    notes = []
    for add, mul in spmvs:
        (v2, ne), (v2_p, ne_p) = got[f"spmv {add}/{mul}"], want[f"spmv {add}/{mul}"]
        if add == "plus":
            torch.testing.assert_close(ne, v2, rtol=1e-6, atol=0)
            torch.testing.assert_close(ne, ne_p, rtol=1e-6, atol=0)
        else:
            require(torch.equal(ne, v2), f"spmv {add}/{mul}: the non-endpoint plan differs from the v2 plan")
            require(torch.equal(ne, ne_p), f"spmv {add}/{mul}: kernel path differs from the plain path")
        notes.append(f"spmv {add}/{mul} non-v2 vs v2 max_abs_err={abs_err(ne, v2)!r}")
    for add, mul in masked:
        key = f"spmv_masked {add}/{mul}"
        ((yv, ys), (nv, ns)), ((yv_p, ys_p), (nv_p, ns_p)) = got[key], want[key]
        # each plan kind, kernel path against plain path; then the two plan kinds
        for label, (a, b) in (("", (yv, yv_p)), (" (no endpoint routes)", (nv, nv_p)), (" non-v2 vs v2", (nv, yv))):
            if mul == "times":
                torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
            else:
                require(torch.equal(a, b), f"{key}{label}: values differ")
        for label, (a, b) in (("", (ys, ys_p)), (" (no endpoint routes)", (ns, ns_p)), (" non-v2 vs v2", (ns, ys))):
            require(torch.equal(a, b), f"{key}{label}: structure differs")
        notes.append(f"{key} present {int(ys.sum())}/{n}, non-v2 vs v2 max_abs_err={abs_err(nv, yv)!r}")
    say(
        "5 algorithms",
        f"kernel path = plain path on the card: pagerank ({iters} it) rtol 1e-5 (max_abs_err={pr_err!r}), "
        f"bfs x{len(sources)} exact, sssp exact, bfs_parent x{len(sources)} exact and from {sources[0]} on "
        f"the non-endpoint plan exact (= v2); sources {sources}; spmv and spmv_masked on both plan kinds, "
        f"each against the plain path and non-v2 against v2: min/plus, pair and any/secondi exact, "
        f"plus/times rtol 1e-6; {'; '.join(notes)}",
    )

    # 6. scipy float64 oracle; parents from the scipy levels
    t0 = time.perf_counter()
    r_ref, lv_ref, d_ref = scipy_oracle(src, dst, w, n, sources, iters)
    lv = got["bfs"]
    np.testing.assert_allclose(pr.cpu().numpy(), r_ref, rtol=1e-4, atol=0)
    for k, s in enumerate(sources):
        np.testing.assert_array_equal(lv[k].cpu().numpy(), lv_ref[k], err_msg=f"bfs levels from {s}")
        np.testing.assert_array_equal(
            got["bfs_parent"][k].cpu().numpy(), parent_oracle(np, src, dst, n, lv_ref[k], s),
            err_msg=f"bfs parents from {s}",
        )
    np.testing.assert_array_equal(
        got["bfs_parent_ne"].cpu().numpy(), parent_oracle(np, src, dst, n, lv_ref[0], sources[0]),
        err_msg=f"bfs parents from {sources[0]} on the non-endpoint plan",
    )
    d = got["sssp"].cpu().numpy()
    reach = np.isfinite(d_ref)
    np.testing.assert_allclose(d[reach], d_ref[reach], rtol=1e-5, atol=0)
    require((d[~reach] == STATE_BIG).all(), "sssp: unreachable vertices must read STATE_BIG")
    pr_rel = float(np.max(np.abs(pr.cpu().numpy() - r_ref) / r_ref))
    say(
        "6 oracle",
        f"scipy float64 ({time.perf_counter() - t0:.1f} s): pagerank max rel err {pr_rel:.3e} (< 1e-4); "
        f"levels exact (max level {int(lv[0].max())}, reached {int((lv[0] >= 0).sum())}); "
        f"parents exact on both plan kinds (the largest in-neighbour one level nearer); "
        f"dijkstra rtol 1e-5 on {int(reach.sum())} reachable, rest STATE_BIG",
    )

    # 6s. masked SpGEMM: bench.py's workload with bricks and the reduce net
    # (a), without bricks into int32 (b: eqjoin carries every entry, the
    # scatter combine), and an RMAT lower triangle with hub splitting (c)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tc_plan_b = sps.sparse_spgemm_analyze(L_tc, U_tc, L_tc.rows, L_tc.cols)
    t_plan_b = time.perf_counter() - t0
    require(any(b[0][0] == 256 for b in rm_plan.buckets), "rmat SpGEMM: no (256, .) bucket")
    tasks_per_entry = int(np.bincount(np.concatenate([b[1] for b in rm_plan.buckets])).max())
    require(tasks_per_entry > 1, "rmat SpGEMM: no entry spans several tasks (hub splitting)")
    FP32, INT32 = dtypes.FP32, dtypes.INT32
    runs = {
        "a": (tc_plan, semiring.plus_pair[FP32], FP32),
        "b": (tc_plan_b, semiring.plus_pair[FP32], INT32),
        "c plus_times": (rm_plan, semiring.plus_times[FP32], FP32),
        "c min_plus": (rm_plan, semiring.min_plus[FP32], FP32),
    }

    def spgemm_path():
        return {k: sps.sparse_spgemm_execute(p, sr, dt, keep_on_device=True) for k, (p, sr, dt) in runs.items()}

    kernels.reset_counts()
    torch.cuda.synchronize()
    sg = spgemm_path()
    torch.cuda.synchronize()
    sg_launches, sg_plain = kernels.launch_counts(), kernels.plain_counts()
    with kernels.plain_versions():
        sg_p = spgemm_path()
    torch.cuda.synchronize()
    for key, (acc, hit, fl) in sg.items():
        acc_p, hit_p, fl_p = sg_p[key]
        require(acc.shape == (runs[key][0].n_entries,) and bool(torch.isfinite(acc).all()), f"spgemm {key}: shape or non-finite")
        require(torch.equal(hit, hit_p) and int(fl) == int(fl_p), f"spgemm {key}: hit or flops differ from the plain path")
        if key == "c plus_times":
            torch.testing.assert_close(acc, acc_p, rtol=1e-5, atol=0)
        else:
            require(torch.equal(acc, acc_p), f"spgemm {key}: values differ from the plain path")
    import scipy.sparse as scsp

    lc = scsp.csr_matrix((np.ones(L_tc.nvals), (L_tc.rows, L_tc.cols)), shape=(L_tc.nrows, L_tc.ncols))
    tc_ref = int((lc @ lc.T.tocsr()).multiply(lc).sum())
    tc_a, tc_b = (int(sg[k][0].double().sum()) for k in ("a", "b"))
    require(tc_a == tc_b == tc_ref, f"triangle count: bricks {tc_a}, no bricks {tc_b}, scipy {tc_ref}")
    require(int(sg["a"][2]) == int(sg["b"][2]) == 2 * tc_ref, "spgemm flops != 2 x the triangle count")
    mins, counts = wedge_oracle(np, L_rm, L_rm.rows, L_rm.cols)
    lr = scsp.csr_matrix((L_rm.vals.astype(np.float64), (L_rm.rows, L_rm.cols)), shape=(L_rm.nrows, L_rm.ncols))
    pt_ref = np.asarray((lr @ lr.T.tocsr())[L_rm.rows, L_rm.cols]).ravel()
    for key in ("c plus_times", "c min_plus"):
        acc, hit, fl = (t.cpu().numpy() for t in sg[key])
        np.testing.assert_array_equal(hit, counts > 0, err_msg=f"spgemm {key}: structure")
        require(int(fl) == 2 * int(counts.sum()), f"spgemm {key}: flops")
        if key == "c plus_times":
            np.testing.assert_allclose(acc[hit], pt_ref[hit], rtol=1e-4, atol=0)
        else:
            np.testing.assert_array_equal(acc[hit], mins[hit], err_msg="spgemm min_plus vs the numpy oracle")

    def shapes(p):
        return [(b[0][0], b[0][1], int(b[3].shape[1])) for b in p.buckets]

    say(
        "6s spgemm",
        f"tc workload 2^{args.tc_log2} vertices, L nnz {L_tc.nvals} (host build {t_tc_build:.2f} s); host analysis: "
        f"bricks+net {t_tc_plan:.2f} s, {tc_plan.nbytes() / 2**30:.3f} GiB on the card, "
        f"{0 if tc_plan.brick is None else tc_plan.brick.a_idx.shape[0]} C bricks, buckets (Wa, Wb, T) {shapes(tc_plan)}; "
        f"no bricks {t_plan_b:.2f} s, {tc_plan_b.nbytes() / 2**30:.3f} GiB, buckets {shapes(tc_plan_b)}; "
        f"rmat {args.spgemm_scale} L nnz {L_rm.nvals}: {t_plan_rm:.2f} s, {rm_plan.nbytes() / 2**30:.3f} GiB, "
        f"buckets {shapes(rm_plan)}, up to {tasks_per_entry} tasks per entry. Kernel path = plain path "
        f"(plus_times rtol 1e-5, the rest exact); triangles {tc_a} with bricks = {tc_b} without = scipy; rmat "
        f"plus_times = scipy float64 (rtol 1e-4), min_plus = the numpy oracle exactly, {int(counts.sum())} matches; "
        f"phase {time.perf_counter() - t_phase:.1f} s",
    )

    # 6o. typed operators: the typed front of the engine on the same graphs
    typed = typed_phase(torch, np, dev, src, dst, w, n, xv, xs, tc_plan, tc_plan_b, tc_ref, L_rm, rm_plan)

    # 6t. the tropical matmul, bench.py's inputs (numpy seed 3), and the
    # values-and-structure entry point on 40% structure
    t_phase = time.perf_counter()
    rng_t = np.random.default_rng(3)
    ta_np, tb_np = rng_t.random((args.mt, args.mt), np.float32), rng_t.random((args.mt, args.mt), np.float32)
    ta, tb = torch.from_numpy(ta_np).to(dev), torch.from_numpy(tb_np).to(dev)
    sa, sb = (torch.from_numpy(rng_t.random((args.mt, args.mt)) < 0.4).to(dev) for _ in range(2))

    def tropical_path():
        return (
            mxm.tropical_mxm_filled(ta, tb, "min", "plus"), *mxm.tropical_mxm(ta, sa, tb, sb, "max", "plus", torch.float32)
        )

    kernels.reset_counts()
    torch.cuda.synchronize()
    tr = tropical_path()
    torch.cuda.synchronize()
    tr_launches, tr_plain = kernels.launch_counts(), kernels.plain_counts()
    with kernels.plain_versions():
        tr_p = tropical_path()
    for g_, p_ in zip(tr, tr_p):
        require(torch.equal(g_, p_), "tropical: kernel path differs from the plain path")
    rows_chk = np.random.default_rng(4).choice(args.mt, 8, replace=False)
    want = np.stack([np.min(ta_np[i][:, None] + tb_np, axis=0) for i in rows_chk])
    np.testing.assert_array_equal(tr[0][torch.from_numpy(rows_chk).to(dev)].cpu().numpy(), want)
    say(
        "6t tropical",
        f"min_plus {args.mt}^3 (filled) and max_plus with structure: kernel path = plain path exactly; "
        f"8 rows of min_plus = numpy float32 exactly; phase {time.perf_counter() - t_phase:.1f} s",
    )

    # 6d. the collections and the dense-masked engine, through the DSL only
    dsl = dsl_phase(torch, np, dev, args.dsl_n, args.dsl_generic_n, smi)
    dsl_launches, dsl_plain = dsl["launches"], dsl["plain"]

    # 6s. the sparse DSL: examples 07, 02, 01 and 05 on sparse collections at
    # scale 19, and the generic models.  6s and 6i time the first eager
    # statement's blocking plan build and count the plan path's launches from
    # it on: no background build there (phase 6b times that one)
    from graphblas_tpu_torch.tools.build_plan import env_set

    with env_set("GRAPHBLAS_TPU_PLAN_BACKGROUND", "0"):
        sparse = sparse_dsl_phase(torch, np, dev, g, plan, src, dst, w, sources, L_tc, tc_ref, lv_ref, smi)
    sp_launches, sp_plain = sparse["launches"], sparse["plain"]

    # 6c. compiled loops: models.dsl's recipes as CUDA graph replays at scale 19
    comp = compiled_phase(torch, np, dev, src, dst, w, n, plan, sources, outdeg, smi)
    cp_launches, cp_plain = comp["launches"], comp["plain"]

    # 6m. the dense models (and the UDT collections) at the reference's scale
    dense_models_phase(torch, np, dev, g, args.models_scale, smi)

    # 6i. interop and tx: io, GBTX, pickle and the tx statements on the card
    with env_set("GRAPHBLAS_TPU_PLAN_BACKGROUND", "0"):
        interop = interop_phase(torch, np, dev, src, dst, w, n, smi)
    io_launches, io_plain = interop["launches"], interop["plain"]

    # 6p. the mesh layer: 8 shards on the card, every mesh path at full size
    mesh = mesh_phase(
        torch, np, dev, g, plan, src, dst, w, outdeg, sources, lv_ref, L_tc, U_tc, tc_ref, sg["a"], sparse["A"], smi
    )
    ms_launches, ms_plain = mesh["launches"], mesh["plain"]

    # 6b. the bench entry point, cold and warm, and the background plan build
    bench = bench_phase(torch, np, dev, args.scale, args.ef, args.seed, src, dst, w, n, lv_ref, comp["dsl"], smi)
    bn_launches, bn_plain = bench["launches"], bench["plain"]

    # 6r. the roofline tool's run: its own path, the compare probe's
    t_phase = time.perf_counter()
    kernels.reset_counts()
    roof = roofline.run(tc_plan)
    torch.cuda.synchronize()
    roof_launches, roof_plain = kernels.launch_counts(), kernels.plain_counts()
    say("6r roofline", f"{json.dumps(roof)}; phase {time.perf_counter() - t_phase:.1f} s")

    # 7. launch counts of each path
    path_launches = {
        "spmv": launches, "spgemm": sg_launches, "tropical": tr_launches, "dsl": dsl_launches, "roofline": roof_launches,
        "sparse_dsl": sp_launches, "compiled": cp_launches, "interop": io_launches, "mesh": ms_launches,
        "bench": bn_launches,
    }
    ty_launches, ty_plain = typed["launches"], typed["plain"]
    say(
        "7 counts",
        f"launches: SpMV path {launches}; SpGEMM path {sg_launches}; typed operator paths {ty_launches}; "
        f"tropical path {tr_launches}; DSL path {dsl_launches} (APSP {dsl['rounds']} rounds); sparse DSL path "
        f"{sp_launches}; compiled loops {cp_launches}; interop {io_launches}; mesh {ms_launches}; bench {bn_launches}; "
        f"roofline tool {roof_launches}; plain calls {plain_calls}, {sg_plain}, {ty_plain}, {tr_plain}, {dsl_plain}, "
        f"{sp_plain}, {cp_plain}, {io_plain}, {ms_plain}, {bn_plain}, {roof_plain}",
    )
    for name in KERNELS:
        for path in PATH_OF[name]:
            require(path_launches[path][name] > 0, f"{name} was not launched on the {path} path")
    for name in ("gather", "segscan"):
        require(sg_launches[name] > 0, f"{name} was not launched on the SpGEMM path (the reduce net)")
    for name in ("gather", "segscan_contrib_gather", "segscan_contrib", "segscan", "eqjoin"):
        require(ty_launches[name] > 0, f"{name} was not launched on the typed operator paths")
    require(dsl_launches["tropical_mxm"] == dsl["apsp_launches"] == dsl["rounds"], "DSL path: gb_tropical launches != APSP rounds")
    for calls in (plain_calls, sg_plain, ty_plain, tr_plain, dsl_plain, sp_plain, cp_plain, io_plain, ms_plain, bn_plain, roof_plain):
        require(not any(calls.values()), f"plain versions ran on a path: {calls}")

    # 8. times, bench.py's definitions, after the warm-up runs above
    t_pr = wall_s(torch, lambda: fast.pagerank(plan, outdeg, n, tol=0.0, max_iters=iters)) / iters
    bfs_sources = sources[:4] * 2
    t_bfs = wall_s(torch, lambda: [fast.bfs_level(plan, s, n) for s in bfs_sources]) / len(bfs_sources)
    t_sssp = wall_s(torch, lambda: [fast.sssp(plan, s, n) for s in bfs_sources]) / len(bfs_sources)
    t_par = wall_s(torch, lambda: [fast.bfs_parent(plan, s, n) for s in bfs_sources]) / len(bfs_sources)
    times = {
        "pagerank_gteps_per_iter": e / t_pr / 1e9,
        "bfs_gteps": e / t_bfs / 1e9,
        "sssp_gteps": e / t_sssp / 1e9,
        "bfs_parent_gteps": e / t_par / 1e9,
        "pagerank_iter_ms": t_pr * 1e3,
        "bfs_ms": t_bfs * 1e3,
        "sssp_ms": t_sssp * 1e3,
        "bfs_parent_ms": t_par * 1e3,
    }
    t_sg, sg_flops = roofline.execute_seconds(tc_plan)
    t_trop = wall_s(torch, lambda: [mxm.tropical_mxm_filled(ta, tb, "min", "plus") for _ in range(8)]) / 8
    times.update(
        masked_spgemm_gflops=sg_flops / t_sg / 1e9, masked_spgemm_ms=t_sg * 1e3,
        tropical_mxm_tops=2 * args.mt**3 / t_trop / 1e12, tropical_mxm_ms=t_trop * 1e3,
    )
    bench_keys = {k: bench["detail"][k] for k in BENCH_KEYS_SHARED}
    say(
        "8 times",
        f"{json.dumps(times)}; the bench's (6b, warm run, less its dispatch floor of "
        f"{bench['detail']['dispatch_floor_ms']!r} ms) {json.dumps(bench_keys)} on {smi}; total run "
        f"{time.perf_counter() - t_start:.1f} s",
    )

    rows = []
    for name, (source, replaces) in KERNELS.items():
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(path_launches[path][name] for path in PATH_OF[name]), **kres[name],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
