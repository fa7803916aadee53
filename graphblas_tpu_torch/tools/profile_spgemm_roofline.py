"""Masked-SpGEMM roofline probe on the card: is the triangle-count SpGEMM
compare-bound?

Counterpart of ``graphblas_tpu/tools/profile_spgemm_roofline.py``.  Builds
bench.py's ``masked_spgemm_gflops`` workload (1,024 cliques of 64 on 2^16
vertices plus 2^17 random edges, rng seed 7; C(L.S) = L plus_pair U with
U = L^T, bricks and the reduce net), then measures on the card:

  1. the full ``sparse_spgemm_execute`` (bench.py's definition: host seconds
     per execute over 5 after a warm-up) -> GF/s and achieved compares/s
  2. eqjoin alone per width bucket (CUDA events) -> key compares/s
  3. the compare-rate ceiling: the ``compare_probe`` kernel, K = 64 fused
     compare-adds per element on (2^14, 128) float32 -> compares/s
  4. the combine alone (two routes of Kernel G, two generic scans) and the
     brick matmuls alone
  5. one execute under torch.profiler: its device kernel time by kernel (the
     full table goes to ``--out``); the card's busy share is that device time
     over the unprofiled ``full_ms`` (the profiler slows the host)
  6. the per-bucket table: each bucket's (Wa, Wb, T), eqjoin's layout and
     device ms (torch.profiler, mean of the last 19 of 20 launches), its key
     compares, bytes and bound, for the bench plan under plus_pair and, with
     ``--rmat-scale``, for an RMAT lower triangle L.L^T (chip_smoke.py's run
     (c)) under plus_pair and min_plus; with ``--sweep``, every bucket in
     every layout the kernel takes (the data behind
     ``kernels/eqjoin.lanes_per_task``)

Compares are counted on the host, Wa * Wb * T per bucket; the useful flops
are bench.py's, 2 x the matches:

  GF_useful/s = (compares/s achieved) * (useful flops / compare)

Per-bucket eqjoin times by CUDA events bottom out at the wrapper's host time
for a small bucket; the profile's device times are the kernels'.  A bucket's
bound is the larger of its bytes (keys and the values the multiply reads,
once each, and 8 bytes a task out) over 3.35 TB/s and its compares, one
int32 instruction each, over 132 SMs x 64 lanes x 1.98 GHz.

    python -m graphblas_tpu_torch.tools.profile_spgemm_roofline [--ns-log2 16] [--rmat-scale 14]
        [--sweep] [--out build/spgemm_profile.txt]
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ..core import sparse as _sp
from ..kernels import eqjoin as _ke
from ..ops import eqjoin as _ej

PROBE_ROWS = 1 << 14  # the probe's (rows, 128) float32 arrays
# H100 SXM data sheet: memory rate; int32 instruction rate (64 lanes an SM)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bench_tc_workload(ns_log2=16, csize=64, seed=7):
    """bench.py's masked-SpGEMM input: the lower triangle L of ``ns``
    vertices in cliques of ``csize`` plus 2 * ns random edges (numpy rng
    ``seed``), all values 1.0 float32, and U = L^T (host containers)."""
    rng = np.random.default_rng(seed)
    ns = 1 << ns_log2
    base = np.arange(ns) - (np.arange(ns) % csize)
    rs, cs = [], []
    for d in range(1, csize):
        rs.append(np.arange(ns))
        cs.append(base + (np.arange(ns) + d) % csize)
    r = np.concatenate(rs + [rng.integers(0, ns, ns * 2)])
    c = np.concatenate(cs + [rng.integers(0, ns, ns * 2)])
    lo, hi = np.minimum(r, c), np.maximum(r, c)
    keep = lo != hi
    L = _sp.SparseMatrixData.from_arrays(
        hi[keep], lo[keep], np.ones(int(keep.sum()), np.float32), ns, ns, dup_op="first"
    )
    return L, L.transposed()


def rmat_lower(scale, seed=5, value_seed=11):
    """rmat(scale, 16, seed) symmetrised: its strict lower triangle L, with
    values in [0.5, 1.5) drawn by numpy from ``value_seed``, and U = L^T
    (host containers)."""
    from ..models import rmat

    g = rmat(scale, 16, seed=seed, device="cpu")
    v = g.valid.numpy()
    s, d = (t.numpy()[v].astype(np.int64) for t in (g.src, g.dst))
    r, c = np.concatenate([s, d]), np.concatenate([d, s])
    keep = r > c
    pat = _sp.SparseMatrixData.from_arrays(r[keep], c[keep], np.ones(int(keep.sum()), np.float32), g.n, g.n, "first")
    vals = (np.random.default_rng(value_seed).random(pat.nvals) + 0.5).astype(np.float32)
    L = _sp.SparseMatrixData(pat.rows, pat.cols, vals, g.n, g.n)
    return L, L.transposed()


def bucket_bound(Wa, Wb, T, n_bytes):
    """(bound_ms, bound_by) of one bucket: its bytes or its key compares."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, Wa * Wb * T / INT32_OPS_PER_S
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "compares")


def bucket_table(plan, add="plus", mul="pair", reps=20, lanes=None):
    """One row per bucket: Wa, Wb, T, the layout, eqjoin's device ms
    (torch.profiler, mean of the last reps - 1 of ``reps`` launches in a
    row), its compares, bytes and bound.  ``lanes`` None: the layout
    ``eqjoin`` picks; else that layout, on the buckets that take it (the
    rest are left out).  On a tree whose kernel has one layout only (before
    the lanes layout: an A/B's parent) every bucket runs one thread a task."""
    from torch.profiler import ProfilerActivity, profile

    one_layout = not hasattr(_ke, "eqjoin_in_layout")
    ins, buckets = [], []
    for b in plan.buckets:
        (Wa, Wb), T = b[0], int(b[3].shape[1])
        if one_layout:
            g = 1
        else:
            g = _ke.lanes_per_task(Wa, Wb, T) if lanes is None else lanes
            if g not in _ke.layouts(Wa):
                continue
        av = b[4].to(torch.float32) if mul in _ke.USES_AV else None
        bv = b[6].to(torch.float32) if mul in _ke.USES_BV else None
        ins.append((b[3], av, b[5], bv, add, mul, g))
        buckets.append(b)

    def launch(i):
        return _ke.eqjoin(*i[:6]) if one_layout else _ke.eqjoin_in_layout(*i)

    def device_ms(i):
        """Mean device ms of the last reps - 1 of reps launches (a trace may
        miss the launch that starts it, and now and then every kernel of the
        trace: up to three traces)."""
        launch(i)
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    launch(i)
                torch.cuda.synchronize()
            kern = sorted(
                (e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "eqjoin" in e.name),
                key=lambda e: e.time_range.start,
            )[-(reps - 1) :]
            if len(kern) == reps - 1:
                return sum(e.time_range.elapsed_us() for e in kern) / len(kern) / 1e3
        raise RuntimeError(f"bucket_table: {len(kern)} eqjoin kernels traced of {reps} launched, three times")

    rows = []
    for b, i in zip(buckets, ins):
        (Wa, Wb), T = b[0], int(b[3].shape[1])
        ms = device_ms(i)
        n_bytes = sum(t.numel() * t.element_size() for t in i[:4] if t is not None) + 8 * T
        bound_ms, bound_by = bucket_bound(Wa, Wb, T, n_bytes)
        rows.append({
            "Wa": Wa, "Wb": Wb, "T": T, "lanes": i[-1], "ms": ms, "compares": Wa * Wb * T, "bytes": n_bytes,
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
    return rows


def layout_sweep(plan, add="plus", mul="pair", reps=20):
    """Each bucket's device ms in every layout it takes: {(Wa, Wb, T): {g: ms}}."""
    out = {}
    for g in (1, 2, 4, 8, 16, 32):
        for r in bucket_table(plan, add, mul, reps, lanes=g):
            out.setdefault((r["Wa"], r["Wb"], r["T"]), {})[g] = r["ms"]
    return out


def format_table(label, rows):
    """The table as text lines, and its sums."""
    lines = [f"== {label}: Wa Wb T | lanes a task | device ms | compares | bound ms (by) | ms / bound"]
    for r in rows:
        lines.append(
            f"  {r['Wa']:4d} {r['Wb']:4d} {r['T']:8d} | {r['lanes']:2d} | {r['ms']:.4f} | {r['compares']:.4g} | "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) | {r['ms'] / r['bound_ms']:.1f}"
        )
    ms, bnd = sum(r["ms"] for r in rows), sum(r["bound_ms"] for r in rows)
    lines.append(f"  sum: {ms:.4f} ms against {bnd:.4f} ms of bounds ({len(rows)} buckets)")
    return lines


def bucket_compares(plan):
    """[((Wa, Wb), T, Wa * Wb * T)] of the plan's buckets (T padded)."""
    return [(b[0], int(b[3].shape[1]), b[0][0] * b[0][1] * int(b[3].shape[1])) for b in plan.buckets]


def _cuda_ms(fn, reps):
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


def plus_pair():
    """bench.py's semiring, plus_pair[FP32] into FP32: (semiring, out type)."""
    from .. import semiring
    from ..core import dtypes

    return semiring.plus_pair[dtypes.FP32], dtypes.FP32


def execute_seconds(plan, reps=5):
    """bench.py's timing of one plus_pair execute: a warm-up, then host
    seconds over ``reps`` executes ending in one synchronisation.  Returns
    (seconds, flops)."""
    sr, out = plus_pair()
    _, _, flops = _sp.sparse_spgemm_execute(plan, sr, out, keep_on_device=True)
    flops = int(flops)  # constant across runs: read outside the timing
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        acc, _, _ = _sp.sparse_spgemm_execute(plan, sr, out, keep_on_device=True)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps, flops


def compare_ceiling(device, reps=20):
    """The probe's compares per second: (rows * 128 * K) / kernel time."""
    a = torch.ones((PROBE_ROWS, 128), dtype=torch.float32, device=device)
    b = torch.zeros_like(a)
    out = _ke.compare_probe(a, b)
    torch.cuda.synchronize()
    if not bool((out == 1).all()):  # a == b + 1 exactly once per element
        raise RuntimeError("compare_probe: wrong result")
    ms = _cuda_ms(lambda: _ke.compare_probe(a, b), reps)
    return a.numel() * _ke.PROBE_K / (ms * 1e-3), ms


def run(plan, reps=5):
    """Measurements 1-4 on a plan whose tensors are on the card; the
    plan must be plus_pair-compatible (its combine is timed where it has a
    reduce net)."""
    out = {"n_entries": plan.n_entries}
    buckets = bucket_compares(plan)
    total_cmp = sum(c for _, _, c in buckets)
    out["total_key_compares"] = total_cmp
    t_full, useful = execute_seconds(plan, reps=reps)
    out.update(
        useful_flops=useful, full_ms=t_full * 1e3, gflops=useful / t_full / 1e9,
        achieved_Gcmp_per_s=total_cmp / t_full / 1e9, useful_per_compare=useful / max(total_cmp, 1),
    )
    per_bucket, t_eq, vs, nms = {}, 0.0, [], []
    for b, (w, T, cmp_b) in zip(plan.buckets, buckets):
        akT, bkT = b[3], b[5]
        ms = _cuda_ms(lambda akT=akT, bkT=bkT: _ej.eqjoin(akT, None, bkT, None, "plus", "pair"), reps)
        v, nm = _ej.eqjoin(akT, None, bkT, None, "plus", "pair")
        vs.append(v)
        nms.append(nm)
        t_eq += ms
        per_bucket[f"{w[0]}x{w[1]}"] = {"T": T, "ms": ms, "Gcmp_per_s": cmp_b / (ms * 1e-3) / 1e9}
    out.update(eqjoin=per_bucket, eqjoin_total_ms=t_eq, eqjoin_Gcmp_per_s=total_cmp / (t_eq * 1e-3) / 1e9)
    ceiling, probe_ms = compare_ceiling(plan.device)
    out.update(
        probe_ms=probe_ms, compare_ceiling_Gcmp_per_s=ceiling / 1e9,
        gflops_at_compare_ceiling=out["useful_per_compare"] * ceiling / 1e9,
    )
    if plan.reduce_net is not None:
        out["combine_ms"] = _cuda_ms(lambda: _sp._combine_net(vs, nms, plan.reduce_net, "add", plan.n_entries), reps)
    if plan.brick is not None:
        acc = torch.zeros(plan.n_entries, dtype=torch.float32, device=plan.device)
        hit = torch.zeros(plan.n_entries, dtype=torch.bool, device=plan.device)
        out["brick_ms"] = _cuda_ms(lambda: _sp._brick_body(plan.brick, "pair", acc, hit), reps)
    return out


def profile_execute(plan, out_path):
    """Trace one plus_pair execute (after a warm-up) under torch.profiler:
    (wall ms, summed device kernel ms, [(kernel, device ms)] largest first);
    the full ``key_averages`` table goes to ``out_path``."""
    from torch.profiler import ProfilerActivity, profile

    sr, out = plus_pair()

    def once():
        return _sp.sparse_spgemm_execute(plan, sr, out, keep_on_device=True)

    once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        once()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sorted(((e.key, e.self_device_time_total / 1e3) for e in events), key=lambda kv: -kv[1])
    with open(out_path, "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    return wall_ms, sum(ms for _, ms in dev_ms), dev_ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ns-log2", type=int, default=16)
    ap.add_argument("--rmat-scale", type=int, default=14, help="the RMAT plan's scale for the bucket table (0: none)")
    ap.add_argument("--sweep", action="store_true", help="time every bucket in every layout eqjoin takes")
    ap.add_argument("--out", default="build/spgemm_profile.txt", help="the traced execute's table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_spgemm_roofline: no CUDA device")
    t0 = time.perf_counter()
    L, U = bench_tc_workload(args.ns_log2)
    plan = _sp.sparse_spgemm_analyze(L, U, L.rows, L.cols, bricks=True, reduce_net=True, device="cuda")
    out = {"mask_nnz": L.nvals, "host_build_and_analysis_s": time.perf_counter() - t0, **run(plan)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    wall_ms, dev_ms, top = profile_execute(plan, args.out)
    out["profile"] = {
        "wall_ms": wall_ms, "device_kernel_ms": dev_ms, "busy_share_profiled": dev_ms / wall_ms,
        "top_kernels_ms": [[k[:100], ms] for k, ms in top[:10]],
    }
    runs = {"bench plus_pair": (plan, "plus", "pair")}
    if args.rmat_scale:
        Lr, Ur = rmat_lower(args.rmat_scale)
        rplan = _sp.sparse_spgemm_analyze(Lr, Ur, Lr.rows, Lr.cols, reduce_net=True, device="cuda")
        for add, mul in (("plus", "pair"), ("min", "plus")):
            runs[f"rmat {args.rmat_scale} {add}_{mul}"] = (rplan, add, mul)
    tables = {label: bucket_table(*r) for label, r in runs.items()}
    for label, rows in tables.items():
        print("\n".join(format_table(label, rows)), flush=True)
    out["bucket_tables"] = tables
    if args.sweep:
        for label, r in runs.items():
            print(f"== layouts, {label}: Wa Wb T | device ms by lanes a task | the pick", flush=True)
            for (Wa, Wb, T), by_g in layout_sweep(*r).items():
                cells = ", ".join(f"{g}: {ms:.4f}" for g, ms in by_g.items())
                print(f"  {Wa:4d} {Wb:4d} {T:8d} | {cells} | {_ke.lanes_per_task(Wa, Wb, T)}", flush=True)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out, indent=1), flush=True)


if __name__ == "__main__":
    main()
