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

Compares are counted on the host, Wa * Wb * T per bucket; the useful flops
are bench.py's, 2 x the matches:

  GF_useful/s = (compares/s achieved) * (useful flops / compare)

Per-bucket eqjoin times by CUDA events bottom out at the wrapper's host time
for a small bucket; the profile's device times are the kernels'.

    python -m graphblas_tpu_torch.tools.profile_spgemm_roofline [--ns-log2 16] [--out build/spgemm_profile.txt]
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


def execute_seconds(plan, add="plus", mul="pair", reps=5):
    """bench.py's timing of one execute: a warm-up, then host seconds over
    ``reps`` executes ending in one synchronisation.  Returns (seconds,
    flops)."""
    _, _, flops = _sp.sparse_spgemm_execute(plan, add, mul, torch.float32, keep_on_device=True)
    flops = int(flops)  # constant across runs: read outside the timing
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        acc, _, _ = _sp.sparse_spgemm_execute(plan, add, mul, torch.float32, keep_on_device=True)
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

    def once():
        return _sp.sparse_spgemm_execute(plan, "plus", "pair", torch.float32, keep_on_device=True)

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
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out, indent=1), flush=True)


if __name__ == "__main__":
    main()
