"""Readings behind the ``bc_err`` limit of the ``bc`` traffic: the library's
compared numbers over many seeds (the lower reading) and the FP32-count
control's (the upper).

    python3 gbbench/control_bc.py --seeds 11,12,13 [--device cuda] [--scale N]

For each seed the library's numbers come as ``control.py`` reads them (the
recipe over a cycle of the keys, the first ``judged`` trials judged by the
float64 reference).  The control is the reference with its path counts and
dependencies held in float32, the precision below the configuration's FP64,
over the recipe's first ``judged`` batches, judged as a run judges (each
number against its limit: ``control_correct``).  One JSON line a seed on
standard output.  The benchmark's runs do not run this.
"""

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gbbench import control, generate, registry  # noqa: E402
from gbbench.algorithms import bc as recipe  # noqa: E402
from gbbench.reference import bc as ref  # noqa: E402
from gbbench.run import environment  # noqa: E402

CONFIG, TRAFFIC = "gap-bc-kron21", "bc"


def fp32_control(seed, device, config_override=None):
    """The control's largest ``bc_err`` and ``levels_off`` over the recipe's
    judged batches, and whether a run would call them correct."""
    import torch

    cfg = dict(registry.config(CONFIG), **(config_override or {}))
    traffic = registry.traffic(TRAFFIC)
    rows, cols, _, n, roots = generate.graph(cfg, seed, device, int(traffic["roots"]))
    graph = {"rows": rows, "cols": cols, "n": n}
    results = [
        (ref.brandes(rows, cols, n, batch, torch.float32), 0, batch)
        for batch in recipe.batches(roots)[: int(traffic["judged"])]
    ]
    return judge(ref.check(graph, traffic["params"], results), traffic["limits"])


def judge(got, limits):
    """The largest of each compared number, and ``control_correct`` as
    ``run.py`` decides ``correct``: every number at or under its limit."""
    out = {name: max(x[name] for x in got) for name in limits}
    out["control_correct"] = all(out[name] <= limits[name] for name in limits)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=None, help="another scale (a rehearsal on the CPU)")
    args = ap.parse_args(argv)
    environment()
    import torch

    device = torch.device(args.device)
    override = {"scale": args.scale} if args.scale else None
    for seed in (int(s) for s in args.seeds.split(",")):
        (line,) = control.readings(CONFIG, [TRAFFIC], seed, False, device, override)
        line["control"] = fp32_control(seed, device, override)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
