#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (graphblas_tpu_torch) on one GPU.

Drives the port's main path once, on the card, at the size bench.py uses:
RMAT scale 19, edge factor 16, seed 5 (8.4 M edges, e_pad = 2^23).  The graph
is analyzed into an SpmvPlan, then PageRank (50 iterations), level BFS from
the 4 sources of highest out-degree and SSSP from the first of them run
through the hand-written CUDA kernels.  One line per phase:

  1. device: the card's name and power limit (nvidia-smi)
  2. build: the kernels built from graphblas_tpu_torch/csrc with nvcc
  3. kernels: G, C (add, min, max) and S (BFS, SSSP) against their plain
     PyTorch versions at e_pad, with both times
  4. graph and plan: host build time, plan size on the device
  5. algorithms: kernel path against the plain path on the same card
  6. oracle: scipy in float64 (PageRank, BFS levels, Dijkstra)
  7. launch counts of the main path (every kernel > 0, every plain version 0)
  8. times in bench.py's definitions (GTEPS)

then one JSON line of per-kernel numbers, and last the status line
{"ok": true, "device": {...}}.  Any failure raises: the exit code is then not
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
    "gather": ("graphblas_tpu_torch/csrc/gather.cu", "graphblas_tpu/ops/permute.py:399"),
    "gather_fill": ("graphblas_tpu_torch/csrc/gather.cu", "graphblas_tpu/ops/pallas_scan.py:387"),
    "segscan_contrib": ("graphblas_tpu_torch/csrc/segscan.cu", "graphblas_tpu/ops/pallas_scan.py:418"),
    "segscan_state": ("graphblas_tpu_torch/csrc/segscan.cu", "graphblas_tpu/ops/pallas_scan.py:219"),
}


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


def check_kernels(torch, e_pad, dev):
    """Phase 3: each kernel against its plain version on the card."""
    from graphblas_tpu_torch.kernels import gather as kg
    from graphblas_tpu_torch.kernels import segscan as ks
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

    def record(name, label, kern, plain, rtol=None, reps=20):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        err = 0.0
        for g, p in pairs:
            if rtol is None:
                require(torch.equal(g, p), f"{name} {label}: kernel differs from its plain version")
            else:
                torch.testing.assert_close(g, p, rtol=rtol, atol=0)
            err = max(err, float((g.double() - p.double()).abs().max()))
        ms = cuda_ms(torch, kern, reps)
        plain_ms = cuda_ms(torch, plain, 3)
        tol = "bit-exact" if rtol is None else f"rtol {rtol}"
        say("3 kernels", f"{name} {label}: {tol}, max_abs_err={err!r}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        prev = results.get(name)
        if prev is None:  # the first variant listed is the one reported in the JSON line
            results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        else:
            prev["max_abs_err"] = max(prev["max_abs_err"], err)

    record("gather", "route (none)", lambda: kg.gather(x, perm), lambda: kg.gather_plain(x, perm))
    record(
        "gather", "route + pagerank epilogue",
        lambda: kg.gather(x, perm, "pagerank", aux, c), lambda: kg.gather_plain(x, perm, "pagerank", aux, c),
    )
    record("gather_fill", "fill", lambda: kg.gather(x, fill_src, "fill"), lambda: kg.gather_plain(x, fill_src, "fill"))
    for op, mul in (("add", "times"), ("min", "plus"), ("max", "first")):
        record(
            "segscan_contrib", f"{op}/{mul}",
            lambda: ks.segscan_contrib(x, w, valid, flags, op, mul),
            lambda: ks.segscan_contrib_plain(x, w, valid, flags, op, mul),
            rtol=1e-6 if op == "add" else None,
        )
    frontier = (rand(e_pad) < 0.05).float()
    levels = torch.where(rand(e_pad) < 0.7, -1, torch.randint(0, 4, (e_pad,), generator=gen, device=dev)).to(torch.int32)
    record(
        "segscan_state", "bfs",
        lambda: ks.segscan_state("bfs", frontier, None, valid, flags, is_last, levels, 3),
        lambda: ks.segscan_state_plain("bfs", frontier, None, valid, flags, is_last, levels, 3),
    )
    big = torch.tensor(STATE_BIG, device=dev)
    xs = torch.where(rand(e_pad) < 0.3, big, rand(e_pad) * 20)
    dist = torch.where(rand(e_pad) < 0.5, big, rand(e_pad) * 25)
    record(
        "segscan_state", "sssp (fr_reduce)",
        lambda: ks.segscan_state("sssp", xs, w, valid, flags, is_last, dist, 3, True),
        lambda: ks.segscan_state_plain("sssp", xs, w, valid, flags, is_last, dist, 3, True),
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

    # 4. graph and plan
    t0 = time.perf_counter()
    g = rmat(args.scale, args.ef, seed=args.seed, weighted=True)
    t_graph = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = fast.analyze(g)
    t_plan = time.perf_counter() - t0
    plan = plan.to(dev)
    torch.cuda.synchronize()
    n = g.n
    valid = g.valid.numpy()
    src, dst, w = g.src.numpy()[valid], g.dst.numpy()[valid], g.weights.numpy()[valid]
    e = len(src)
    outdeg = np.bincount(src, minlength=n)
    sources = np.argsort(outdeg)[::-1][:4].tolist()  # bench.py's pick
    plan_bytes = sum(t.numel() * t.element_size() for t in plan.arrays().values())
    say(
        "4 graph+plan",
        f"rmat scale {args.scale} ef {args.ef} seed {args.seed}: n={n} e={e} e_pad={plan.e_pad}; "
        f"host rmat {t_graph:.2f} s, host analyze {t_plan:.2f} s; plan on device {plan_bytes / 2**30:.3f} GiB",
    )
    require(plan.e_pad == e_pad, "plan.e_pad == e_pad")

    # 5. the main path through the kernels, then the plain path on the same card
    iters = 50

    def main_path():
        pr = fast.pagerank(plan, outdeg, n, tol=0.0, max_iters=iters)
        lv = [fast.bfs_level(plan, s, n) for s in sources]
        dist = fast.sssp(plan, sources[0], n)
        return pr, lv, dist

    kernels.reset_counts()
    torch.cuda.synchronize()
    pr, lv, dist = main_path()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    plain_calls = kernels.plain_counts()
    with kernels.plain_versions():
        pr_p, lv_p, dist_p = main_path()
    torch.cuda.synchronize()
    require(pr.shape == (n,) and bool(torch.isfinite(pr).all()), "pagerank: wrong shape or non-finite")
    torch.testing.assert_close(pr, pr_p, rtol=1e-5, atol=0)
    pr_err = float((pr.double() - pr_p.double()).abs().max())
    for s, a, b in zip(sources, lv, lv_p):
        require(torch.equal(a, b), f"bfs from {s}: kernel path differs from the plain path")
    require(torch.equal(dist, dist_p), "sssp: kernel path differs from the plain path")
    say(
        "5 algorithms",
        f"kernel path = plain path on the card: pagerank ({iters} it) rtol 1e-5 (max_abs_err={pr_err!r}), "
        f"bfs x{len(sources)} exact, sssp exact; sources {sources}",
    )

    # 6. scipy float64 oracle
    t0 = time.perf_counter()
    r_ref, lv_ref, d_ref = scipy_oracle(src, dst, w, n, sources, iters)
    np.testing.assert_allclose(pr.cpu().numpy(), r_ref, rtol=1e-4, atol=0)
    for k, s in enumerate(sources):
        np.testing.assert_array_equal(lv[k].cpu().numpy(), lv_ref[k], err_msg=f"bfs levels from {s}")
    d = dist.cpu().numpy()
    reach = np.isfinite(d_ref)
    np.testing.assert_allclose(d[reach], d_ref[reach], rtol=1e-5, atol=0)
    require((d[~reach] == STATE_BIG).all(), "sssp: unreachable vertices must read STATE_BIG")
    pr_rel = float(np.max(np.abs(pr.cpu().numpy() - r_ref) / r_ref))
    say(
        "6 oracle",
        f"scipy float64 ({time.perf_counter() - t0:.1f} s): pagerank max rel err {pr_rel:.3e} (< 1e-4); "
        f"levels exact (max level {int(lv[0].max())}, reached {int((lv[0] >= 0).sum())}); "
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
    times = {
        "pagerank_gteps_per_iter": e / t_pr / 1e9,
        "bfs_gteps": e / t_bfs / 1e9,
        "sssp_gteps": e / t_sssp / 1e9,
        "pagerank_iter_ms": t_pr * 1e3,
        "bfs_ms": t_bfs * 1e3,
        "sssp_ms": t_sssp * 1e3,
    }
    say("8 times", f"{json.dumps(times)} on {smi}; total run {time.perf_counter() - t_start:.1f} s")

    rows = []
    for name, (source, replaces) in KERNELS.items():
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], **kres[name],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
