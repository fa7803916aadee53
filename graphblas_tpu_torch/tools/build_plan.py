"""Build an RMAT graph's SpmvPlan file, its COO arrays and the DSL matrices'
plan cache.

Counterpart of ``graphblas_tpu/tools/build_plan.py``, with its arguments and
the arrays it writes.  ``graphblas_tpu_torch.bench`` calls ``main(argv)`` in
its own process; the plan files are the port's format
(``ops.fastspmv.PLAN_FORMAT``) under names the JAX package never reads.

    python -m graphblas_tpu_torch.tools.build_plan --scale 19 --ef 16 --seed 5 --out plan.npz \\
        [--graph-out graph.npz] [--dsl-cache DIR] [--device cuda|cpu]
"""

import argparse
import contextlib
import os
import sys
import time

import numpy as np

# marker of a complete DSL plan set in a --dsl-cache directory
PLANS_MARKER = "gbtorch_plans1.done"


@contextlib.contextmanager
def env_set(name, value):
    """``os.environ[name] = value`` for the block; the previous value (or
    its absence) comes back after it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def _say(msg):
    print(f"[build_plan] {msg}", file=sys.stderr, flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scale", type=int, required=True)
    parser.add_argument("--ef", type=int, default=16)
    parser.add_argument("--seed", type=int, default=5)
    parser.add_argument("--out", required=True)
    parser.add_argument("--graph-out", default=None, help="also save the COO arrays")
    parser.add_argument(
        "--dsl-cache",
        default=None,
        help="also build the DSL Matrix plans (pagerank/sssp/cc) into this "
        "plan-cache dir + save their canonical COOs next to --graph-out",
    )
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="where the graph and the plans go")
    args = parser.parse_args(argv)

    from ..models.graph import rmat
    from ..ops.fastspmv import build_spmv_plan, save_spmv_plan

    g = rmat(args.scale, args.ef, seed=args.seed, weighted=True, device=args.device)
    valid = g.valid.cpu().numpy()
    src, dst, w = (t.cpu().numpy()[valid] for t in (g.src, g.dst, g.weights))
    if os.path.exists(args.out):
        _say(f"model plan exists, skipping: {args.out}")
    else:
        plan = build_spmv_plan(src, dst, w, n=g.n, device="cpu")
        save_spmv_plan(plan, args.out)
        _say(f"plan saved: n={plan.n} e_pad={plan.e_pad}")
    if args.graph_out:
        np.savez(args.graph_out, src=src, dst=dst, w=w, n=np.asarray([g.n]))
    if args.dsl_cache:
        _build_dsl_plans(src, dst, w, g.n, args.dsl_cache, args.graph_out, args.device)


def _build_dsl_plans(src, dst, w, n, cache_dir, graph_out, device):
    """Build the DSL matrices' loop-capable plans into the on-disk plan cache
    and save their canonical COO arrays (the bench rebuilds the same
    matrices from them, and each plan() hits its file by pattern)."""
    from .. import binary
    from ..core import dtypes as dtm
    from ..core.matrix import Matrix
    from ..tx import config as txconfig

    os.makedirs(cache_dir, exist_ok=True)
    arrays = {}
    with env_set("GRAPHBLAS_TPU_PLAN_CACHE", cache_dir), txconfig.set(dense_limit=0, platform=device):
        t0 = time.perf_counter()
        # pagerank/bfs matrix: AT[dst, src]; duplicate edges fold into the
        # value (plus), so plus_times pagerank matches the raw multigraph
        AT = Matrix.from_coo(dst, src, np.ones(len(src), np.float32), dtm.FP32, nrows=n, ncols=n, dup_op=binary.plus)
        AT._sparse.plan("pull", device, loop=True)
        arrays.update(pr_rows=AT._sparse.rows, pr_cols=AT._sparse.cols, pr_vals=AT._sparse.vals)
        _say(f"dsl pagerank plan: {time.perf_counter() - t0:.1f}s nvals={AT._sparse.nvals}")

        t0 = time.perf_counter()
        # sssp matrix: weighted, duplicates fold with min (the same relaxations);
        # its pattern is AT's, so its pull plan is AT's file with its own weights
        ATw = Matrix.from_coo(dst, src, w.astype(np.float32), dtm.FP32, nrows=n, ncols=n, dup_op=binary.min)
        ATw._sparse.plan("pull", device, loop=True)
        arrays.update(ss_rows=ATw._sparse.rows, ss_cols=ATw._sparse.cols, ss_vals=ATw._sparse.vals)
        _say(f"dsl sssp plan: {time.perf_counter() - t0:.1f}s nvals={ATw._sparse.nvals}")

        t0 = time.perf_counter()
        # connected components run alternating pull/push min-label passes on
        # the directed pagerank matrix: its push plan; the symmetrized COO is
        # saved for the bench's workload size only
        AT._sparse.plan("push", device, loop=True)
        _say(f"dsl cc (pagerank push) plan: {time.perf_counter() - t0:.1f}s")
        us = np.concatenate([src, dst])
        vs = np.concatenate([dst, src])
        ATs = Matrix.from_coo(vs, us, np.ones(len(us), np.float32), dtm.FP32, nrows=n, ncols=n, dup_op=binary.first)
        arrays.update(cc_rows=ATs._sparse.rows, cc_cols=ATs._sparse.cols, cc_vals=ATs._sparse.vals)

    out = (graph_out or "graph.npz").replace(".npz", "_dsl.npz")
    np.savez(out, n=np.asarray([n]), **arrays)
    _say(f"dsl COOs saved: {out}")
    with open(os.path.join(cache_dir, PLANS_MARKER), "w") as fh:
        fh.write("loopT pull:pr,ss + loopT push:pr\n")


if __name__ == "__main__":
    main()
