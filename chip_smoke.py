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
min_plus on 2048^2 operands, as bench.py.  The roofline tool's run, with the
compare probe.  All through the hand-written CUDA kernels.  One line per
check:

  1. device: the card's name and power limit (nvidia-smi)
  2. build: the kernels built from graphblas_tpu_torch/csrc with nvcc
  3. kernels: G (routes, fill, a network with T and row-select stages, a
     route on unaligned views, the L2 probe: a route with x of 2^20 slots), C
     (add, min, max; with flags at 1/16 and with none, the longest
     look-back), S (BFS, SSSP with fr_reduce, with per-slot changed flags,
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
     (2047, 2045) x (2045, 2049) min_plus, and the compare probe against
     theirs
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
  6r. the roofline tool (graphblas_tpu_torch/tools/profile_spgemm_roofline)
  7. launch counts of each path (every kernel > 0, every plain version 0;
     the typed paths launch G, C, the generic scan and eqjoin)
  8. times in bench.py's definitions (GTEPS, GF/s, Top/s), parent BFS in the
     level-BFS one

then one JSON line of per-kernel numbers (time, bound, launches), and last
the status line {"ok": true, "device": {...}}.  Any failure raises: the exit code is then not
0 and the status line is not printed.  Without a CUDA device it fails at once.

    python3 chip_smoke.py [--scale 19] [--ef 16] [--seed 5] [--tc-log2 16] [--spgemm-scale 14] [--mt 2048]
"""

import argparse
import json
import os
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
    "segscan_state": ("graphblas_tpu_torch/csrc/segscan.cu", "graphblas_tpu/ops/pallas_scan.py:219"),
    "segscan": ("graphblas_tpu_torch/csrc/segscan.cu", "graphblas_tpu/ops/pallas_scan.py:291"),
    "eqjoin": ("graphblas_tpu_torch/csrc/eqjoin.cu", "graphblas_tpu/ops/pallas_eqjoin.py:126"),
    "tropical_mxm": ("graphblas_tpu_torch/csrc/tropical.cu", "graphblas_tpu/ops/pallas_mxm.py:74"),
    "compare_probe": ("graphblas_tpu_torch/csrc/eqjoin.cu", "graphblas_tpu/tools/profile_spgemm_roofline.py:161"),
}
# the path whose run counts a kernel's launches (the rest: the SpMV path)
PATH_OF = {"eqjoin": "spgemm", "tropical_mxm": "tropical", "compare_probe": "roofline"}
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
INT32_OPS_PER_S = 132 * 64 * 1.98e9  # int32 instructions (the eqjoin key compares)


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


def check_kernels(torch, e_pad, dev, tc_plan, rm_plan, mt, roofline):
    """Phase 3: each kernel against its plain version on the card."""
    import numpy as np

    from graphblas_tpu_torch.kernels import eqjoin as ke
    from graphblas_tpu_torch.kernels import gather as kg
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
    # the compare probe: K compare-adds per element, 3 f32 instructions each
    pa = torch.randint(0, 100, (1 << 14, 128), generator=gen, device=dev).float()
    pb = torch.randint(0, 40, (1 << 14, 128), generator=gen, device=dev).float()
    record(
        "compare_probe", f"K={ke.PROBE_K} on (16384, 128)", lambda: ke.compare_probe(pa, pb),
        lambda: ke.compare_probe_plain(pa, pb), (pa, pb), 0, n_ops=3 * ke.PROBE_K * pa.numel(),
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=19)
    ap.add_argument("--ef", type=int, default=16)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--tc-log2", type=int, default=16, help="log2 of the SpGEMM workload's vertices")
    ap.add_argument("--spgemm-scale", type=int, default=14, help="RMAT scale of the SpGEMM run (c)")
    ap.add_argument("--mt", type=int, default=2048, help="the tropical matmul's size")
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
    kres = check_kernels(torch, e_pad, dev, tc_plan, rm_plan, args.mt, roofline)
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

    # 6r. the roofline tool's run: its own path, the compare probe's
    t_phase = time.perf_counter()
    kernels.reset_counts()
    roof = roofline.run(tc_plan)
    torch.cuda.synchronize()
    roof_launches, roof_plain = kernels.launch_counts(), kernels.plain_counts()
    say("6r roofline", f"{json.dumps(roof)}; phase {time.perf_counter() - t_phase:.1f} s")

    # 7. launch counts of each path
    path_launches = {"spmv": launches, "spgemm": sg_launches, "tropical": tr_launches, "roofline": roof_launches}
    ty_launches, ty_plain = typed["launches"], typed["plain"]
    say(
        "7 counts",
        f"launches: SpMV path {launches}; SpGEMM path {sg_launches}; typed operator paths {ty_launches}; "
        f"tropical path {tr_launches}; roofline tool {roof_launches}; plain calls {plain_calls}, {sg_plain}, "
        f"{ty_plain}, {tr_plain}, {roof_plain}",
    )
    for name in KERNELS:
        path = PATH_OF.get(name, "spmv")
        require(path_launches[path][name] > 0, f"{name} was not launched on the {path} path")
    for name in ("gather", "segscan"):
        require(sg_launches[name] > 0, f"{name} was not launched on the SpGEMM path (the reduce net)")
    for name in ("gather", "gather_fill", "segscan_contrib", "segscan", "eqjoin"):
        require(ty_launches[name] > 0, f"{name} was not launched on the typed operator paths")
    for calls in (plain_calls, sg_plain, ty_plain, tr_plain, roof_plain):
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
    say("8 times", f"{json.dumps(times)} on {smi}; total run {time.perf_counter() - t_start:.1f} s")

    rows = []
    for name, (source, replaces) in KERNELS.items():
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[PATH_OF.get(name, "spmv")][name], **kres[name],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
