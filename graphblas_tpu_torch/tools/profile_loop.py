"""Where the time of the loop algorithms goes on the card.

Builds the bench graph (RMAT, default scale 19, edge factor 16, seed 5),
warms each algorithm up, then traces PageRank (10 iterations), one level BFS,
one parent BFS and one SSSP from the vertex of highest out-degree under
``torch.profiler``.
Prints, per algorithm, the wall time, the summed device time of each kernel
and the device's busy share (device kernel time / wall time); the full
``key_averages`` tables go to ``--out``.

    python -m graphblas_tpu_torch.tools.profile_loop [--scale 19] [--out chiprun_out/profile.txt]
"""

import argparse
import os
import subprocess
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=19)
    ap.add_argument("--ef", type=int, default=16)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/profile.txt")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from graphblas_tpu_torch.models import fast, rmat

    if not torch.cuda.is_available():
        raise SystemExit("profile_loop: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    g = rmat(args.scale, args.ef, seed=args.seed, weighted=True, device=dev)
    plan = fast.analyze(g)
    src = g.src.cpu().numpy()[g.valid.cpu().numpy()]
    n = g.n
    source = int(np.argmax(np.bincount(src, minlength=n)))
    runs = {
        "pagerank x10": lambda: fast.pagerank(plan, None, n, tol=0.0, max_iters=10),
        "bfs_level": lambda: fast.bfs_level(plan, source, n),
        "bfs_parent": lambda: fast.bfs_parent(plan, source, n),
        "sssp": lambda: fast.sssp(plan, source, n),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    lines = [f"card: {card}; rmat scale {args.scale} ef {args.ef} seed {args.seed}; e={len(src)} e_pad={plan.e_pad}"]
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = {e.key: e.self_device_time_total for e in events}
        total = sum(dev_us.values())
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
        lines.append(
            f"{name}: wall {wall * 1e3:.3f} ms, device kernels {total / 1e3:.3f} ms, "
            f"busy share {total / 1e3 / (wall * 1e3):.3f}"
        )
        for key, us in top:
            lines.append(f"    {us / 1e3:9.3f} ms  {key[:110]}")
        with open(args.out, "a") as f:
            f.write(f"==== {name} ====\n")
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=30))
            f.write("\n")
    print("\n".join(lines), flush=True)


if __name__ == "__main__":
    main()
