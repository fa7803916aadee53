"""The bench's DSL metrics alone (an iteration tool; ``bench`` stays
canonical).

Counterpart of ``graphblas_tpu/tools/bench_dsl.py``: measures the
DSL-expressed PageRank/BFS/SSSP/CC by ``bench.dsl_metrics`` against the
bench's cache (built first where it is missing).  ``GRAPHBLAS_BENCH_DSL_ONLY``
(pr|bfs|sssp|cc) picks one recipe; ``GRAPHBLAS_BENCH_SCALE``, ``_EF`` and
``_CACHE`` as for the bench.

    python -m graphblas_tpu_torch.tools.bench_dsl [--device cuda|cpu]
"""

import argparse
import json
import os


def main(argv=None):
    from .. import bench, tx
    from .build_plan import env_set

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    only = os.environ.get("GRAPHBLAS_BENCH_DSL_ONLY", "")
    scale, _, paths = bench.prepared_cache(args.device)
    src, _, sources = bench.graph_sources(paths["graph"])
    floor = bench.dispatch_floor(args.device)
    with tx.config.set(platform=args.device), env_set("GRAPHBLAS_TPU_PLAN_CACHE", paths["dsl_cache"]):
        out = bench.dsl_metrics(
            paths["dsl_graph"], len(src), sources, floor, args.device, recipes=(only,) if only else bench.RECIPES
        )
    out = {"scale": scale, "edges": len(src), "floor_ms": floor * 1e3, **out}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
