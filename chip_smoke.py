#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (graphblas_tpu_torch) on one GPU.

Drives the port's main path once, on the card, at the size bench.py uses:
RMAT scale 19, edge factor 16, seed 5 (8.4 M edges, e_pad = 2^23).  The graph
is analyzed into an SpmvPlan (and a second one without endpoint routes), then
PageRank (50 iterations), level BFS and parent BFS from the 4 sources of
highest out-degree, SSSP from the first of them, SpMV and three masked SpMVs
on both plans and a parent BFS on the second run through the hand-written
CUDA kernels.  One line per
check:

  1. device: the card's name and power limit (nvidia-smi)
  2. build: the kernels built from graphblas_tpu_torch/csrc with nvcc
  3. kernels: G (routes, fill, a network with T and row-select stages), C
     (add, min, max), S (BFS, SSSP) and the generic scan (fill, add, min,
     max; int32 and int8 add) against their plain PyTorch versions at e_pad,
     with both times and, for the routes, one PyTorch indexing call's
  4. graph and plans: host build times, plan sizes on the device
  5. algorithms: kernel path against the plain path on the same card; SpMV,
     masked SpMV and parent BFS without endpoint routes against the same with
     them
  6. oracle: scipy in float64 (PageRank, BFS levels, Dijkstra) and numpy
     parents from the scipy levels
  7. launch counts of the main path (every kernel > 0, every plain version 0)
  8. times in bench.py's definitions (GTEPS), parent BFS in the level-BFS one

then one JSON line of per-kernel numbers (time, bound, launches), and last
the status line {"ok": true, "device": {...}}.  Any failure raises: the exit code is then not
0 and the status line is not printed.  Without a CUDA device it fails at once.

    python3 chip_smoke.py [--scale 19] [--ef 16] [--seed 5]
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
}
# the least time of a kernel's work (H100 SXM data sheet): bytes over the
# memory rate, operations over the float32 rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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
    """Largest |a - b|, with equal values (infinities included) as 0."""
    d = (a.double() - b.double()).abs()
    return float(d.masked_fill(a == b, 0).max())


def nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of the memory and the arithmetic time."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
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


def check_kernels(torch, e_pad, dev):
    """Phase 3: each kernel against its plain version on the card."""
    import numpy as np

    from graphblas_tpu_torch.kernels import gather as kg
    from graphblas_tpu_torch.kernels import segscan as ks
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

    def record(name, label, kern, plain, inputs, ops_per_slot, rtol=None, library=None, reps=20):
        """Check the kernel against its plain version and time both (and the
        PyTorch call ``library``); the bound counts ``inputs`` read once,
        the outputs written once and ``ops_per_slot`` float32 operations."""
        got, want = kern(), plain()
        torch.cuda.synchronize()
        outs = got if isinstance(got, tuple) else (got,)
        pairs = list(zip(outs, want if isinstance(want, tuple) else (want,)))
        err = 0.0
        for g, p in pairs:
            if rtol is None:
                require(torch.equal(g, p), f"{name} {label}: kernel differs from its plain version")
            else:
                torch.testing.assert_close(g, p, rtol=rtol, atol=0)
            err = max(err, abs_err(g, p))
        ms = cuda_ms(torch, kern, reps)
        plain_ms = cuda_ms(torch, plain, 3)
        library_ms = cuda_ms(torch, library, reps) if library is not None else None
        bound_ms, bound_by = bound(nbytes(inputs) + nbytes(outs), outs[0].numel() * ops_per_slot)
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
    for op, mul in (("add", "times"), ("min", "plus"), ("max", "first")):
        record(
            "segscan_contrib", f"{op}/{mul}",
            lambda: ks.segscan_contrib(x, w, valid, flags, op, mul),
            lambda: ks.segscan_contrib_plain(x, w, valid, flags, op, mul),
            (x, w if mul != "first" else None, valid, flags), 2, rtol=1e-6 if op == "add" else None,
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
    record(
        "segscan_state", "sssp (fr_reduce)",
        lambda: ks.segscan_state("sssp", xs, w, valid, flags, is_last, dist, 3, True),
        lambda: ks.segscan_state_plain("sssp", xs, w, valid, flags, is_last, dist, 3, True),
        (xs, w, valid, flags, is_last, dist), 3,
    )
    # the generic scan: f32 add first (the structure counts of the main path)
    for op in ("add", "fill", "min", "max"):
        record(
            "segscan", f"f32 {op}", lambda: ks.segscan(x, flags, op), lambda: ks.segscan_plain(x, flags, op),
            (x, flags), 1, rtol=1e-6 if op == "add" else None,
        )
    v32 = torch.randint(-(2**30), 2**30, (e_pad,), generator=gen, device=dev, dtype=torch.int32)
    v8 = torch.randint(-128, 128, (e_pad,), generator=gen, device=dev, dtype=torch.int8)
    for label, v in (("int32 add (wraps)", v32), ("int8 add (wraps)", v8)):
        record("segscan", label, lambda: ks.segscan(v, flags, "add"), lambda: ks.segscan_plain(v, flags, "add"), (v, flags), 1)
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=19)
    ap.add_argument("--ef", type=int, default=16)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, REPO)
    import numpy as np

    from graphblas_tpu_torch import kernels
    from graphblas_tpu_torch.kernels import _build
    from graphblas_tpu_torch.models import fast, rmat
    from graphblas_tpu_torch.ops import fastspmv as fs
    from graphblas_tpu_torch.ops.permute import padded_size
    from graphblas_tpu_torch.ops.scan import STATE_BIG

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
    n_nodes = 1 << args.scale
    e_pad = padded_size(max(n_nodes * args.ef, n_nodes))
    kres = check_kernels(torch, e_pad, dev)

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

    # 7. launch counts of the main path
    say("7 counts", f"main path launches {launches}; plain calls {plain_calls}")
    for name in KERNELS:
        require(launches[name] > 0, f"{name} was not launched on the main path")
    require(not any(plain_calls.values()), f"plain versions ran on the main path: {plain_calls}")

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
    say("8 times", f"{json.dumps(times)} on {smi}; total run {time.perf_counter() - t_start:.1f} s")

    rows = []
    for name, (source, replaces) in KERNELS.items():
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches[name],
            **kres[name],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
