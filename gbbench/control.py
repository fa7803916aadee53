"""Readings behind the limits of ``correct``: the library's compared numbers
over many seeds (the lower reading) and the control's (the upper).

    python3 gbbench/control.py --config g500-kron21 --traffic pagerank,pagerank-eager,sssp \
        --seeds 11,12,13 --control-seeds 11,12,13 [--device cuda]

For each seed the configuration's graph is generated as a run generates it,
loaded once with ``Matrix.from_coo``, and each traffic mix's recipe is built
on it and run for as many trials as a run judges; the plain reference judges
them as a run does.  For the control seeds the reference itself, with its
vectors and weights held in bfloat16 (the nearest precision below the
configuration's float32), takes the library's place and is judged the same
way.  One JSON line a seed and mix on standard output.  The benchmark's runs
do not run this; it is how the limits in ``traffic/*.json`` were read.
"""

import argparse
import gc
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gbbench import registry  # noqa: E402
from gbbench.run import Hooks, environment  # noqa: E402


def control_results(ref, graph, traffic, roots, store):
    """The control's answers, shaped as a recipe's trials."""
    params = traffic["params"]
    rows, cols, n = graph["rows"], graph["cols"], graph["n"]
    if traffic["algorithm"] == "pagerank":
        ranks, iters = ref.answer(rows, cols, n, params, store)
        return [(ranks, iters, None)]
    return [(ref.answer(rows, cols, graph["w"], n, r, store), 0, r) for r in roots[: int(traffic["judged"])]]


def readings(config_name, traffic_names, seed, with_control, device, config_override=None):
    """One JSON-able dict a mix: the library's numbers (the largest over the
    judged trials) and, with ``with_control``, the control's."""
    import torch

    import graphblas_tpu_torch as gb
    from graphblas_tpu_torch import Matrix

    from gbbench import generate

    cfg = dict(registry.config(config_name), **(config_override or {}))
    gb.tx.config["platform"] = device.type
    keys = max(int(registry.traffic(name).get("roots", 0)) for name in traffic_names)
    rows, cols, w, n, roots = generate.graph(cfg, seed, device, keys)
    host = {"rows": rows.cpu().numpy(), "cols": cols.cpu().numpy(), "w": w.cpu().numpy()}
    del rows, cols, w
    A = Matrix.from_coo(host["rows"], host["cols"], host["w"], gb.dtypes.FP32, nrows=n, ncols=n)
    answers = {}
    for name in traffic_names:
        traffic = registry.traffic(name)
        alg = registry.algorithm(traffic["algorithm"])
        t0 = time.perf_counter()
        wl = alg.build(A, traffic["params"], roots if traffic.get("roots") else [], Hooks())
        answers[name + ".build_s"] = time.perf_counter() - t0
        # a whole cycle of the roots (one trial where there are none): the
        # iterations of each, and the first ``judged`` for the reference
        trials = []
        for i in range(max(len(roots) if traffic.get("roots") else 1, int(traffic["judged"]))):
            t1 = time.perf_counter()
            trials.append(wl.trial(i) + (time.perf_counter() - t1,))
        answers[name] = [t[:3] for t in trials[: int(traffic["judged"])]]
        answers[name + ".trials"] = [(int(t[1]), round(t[3], 6)) for t in trials]
        del wl
    del A
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    graph = {
        "rows": torch.from_numpy(host["rows"]).to(device, torch.int64),
        "cols": torch.from_numpy(host["cols"]).to(device, torch.int64),
        "w": torch.from_numpy(host["w"]).to(device),
        "n": n,
    }
    out = []
    for name in traffic_names:
        traffic = registry.traffic(name)
        ref = registry.reference(traffic["algorithm"])
        lib = ref.check(graph, traffic["params"], answers[name])
        line = {
            "config": config_name, "traffic": name, "seed": seed, "n": n, "entries": int(host["rows"].size),
            "build_s": answers[name + ".build_s"], "trials": answers[name + ".trials"],
            "library": {k: max(x[k] for x in lib) for k in traffic["limits"]},
        }
        if with_control:
            got = ref.check(graph, traffic["params"], control_results(ref, graph, traffic, roots, torch.bfloat16))
            line["control"] = {k: max(x[k] for x in got) for k in traffic["limits"]}
        out.append(line)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True, help="comma-separated traffic mixes")
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control-seeds", default="", help="the seeds on which the control runs too")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=None, help="another scale (a rehearsal on the CPU)")
    args = ap.parse_args(argv)
    environment()
    import torch

    device = torch.device(args.device)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        override = {"scale": args.scale} if args.scale else None
        for line in readings(args.config, args.traffic.split(","), seed, seed in controls, device, override):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
